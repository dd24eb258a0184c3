"""Block-packed dense-tile LD: the NumPy packers and the torch operator.

The same format as viprs_tpu.ops.block_ld (whose packers these are copies of,
so both packages compute on the same bytes):

- ``diag[b]`` = R[bB:(b+1)B, bB:(b+1)B] — (NB, B, B) diagonal tiles;
- ``off_data[o]`` = R[src_o B:(src_o+1)B, dst_o B:(dst_o+1)B] — the compact
  list of non-zero coupling tiles (upper triangle, src < dst), which only LD
  blocks wider than B produce.

int8 storage carries the global dequantization ``scale`` = 1/127.

For the CUDA coupling kernels the operator also carries, per block, the
fixed ascending-order list of the coupling tiles incident to it
(``inc_ptr``/``inc_tile``, CSR): one CTA per block walks that list, so the
coupling pass needs no atomics and its sums are deterministic. It also
flags the 32 x 32 blocks of each coupling tile that hold a nonzero
(``off_nz``) and lists the slabs of 128 coordinates that some tile's
product can change (``cpl_slabs``), so the S-lane coupling kernel launches
only for those and skips the parts of a tile that are exactly zero (int8
LD that decays with distance is mostly zero away from the tiles' near
corner). The same flags of the diagonal tiles (``diag_nz``) let the S-lane
block sweep skip the zero blocks of its rank-T updates.

The CUDA kernels take int8 or float32 tiles, each kernel with an instance
for each: ``from_numpy`` refuses any other dtype for a CUDA device before
anything is uploaded. On the CPU the plain versions take either.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

INT8_SCALE = 1.0 / 127.0
#: Side of the blocks of a tile that ``off_nz`` / ``diag_nz`` flag, and the
#: coordinates of a slab of the S-lane coupling kernel (four blocks).
NZ_BLOCK = 32
SLAB = 128


def incident_tiles(off_src, off_dst, nb):
    """Per-block CSR list of incident coupling tiles, ascending tile order.

    :returns: (inc_ptr (nb+1,) int32, inc_tile (2*n_off,) int32).
    """
    off_src = np.asarray(off_src, np.int64)
    off_dst = np.asarray(off_dst, np.int64)
    tiles = np.arange(len(off_src), dtype=np.int64)
    blocks = np.concatenate([off_src, off_dst])
    tiles2 = np.concatenate([tiles, tiles])
    order = np.lexsort((tiles2, blocks))          # by block, then tile
    counts = np.bincount(blocks, minlength=nb)
    inc_ptr = np.zeros(nb + 1, np.int32)
    np.cumsum(counts, out=inc_ptr[1:])
    return inc_ptr, tiles2[order].astype(np.int32)


def nonzero_blocks(tiles, chunk=64):
    """(n, ceil(B/32), ceil(B/32)) uint8 on the device of ``tiles``: 1 where
    a 32 x 32 block of one of the n (B, B) tiles (coupling or diagonal)
    holds a nonzero. Works ``chunk`` tiles at a time, so it never holds a
    full boolean copy of the tiles."""
    n, B = tiles.shape[0], tiles.shape[1]
    m = -(-B // NZ_BLOCK)
    pad = m * NZ_BLOCK - B
    out = torch.empty((n, m, m), dtype=torch.uint8, device=tiles.device)
    for i in range(0, n, chunk):
        nz = tiles[i:i + chunk].ne(0).to(torch.uint8)
        if pad:
            nz = torch.nn.functional.pad(nz, (0, pad, 0, pad))
        out[i:i + chunk] = nz.view(-1, m, NZ_BLOCK, m, NZ_BLOCK).amax(
            dim=(2, 4))
    return out


def coupling_slabs(off_nz, off_src, off_dst, nb):
    """The (block, slab of 128 coordinates) pairs that some coupling tile
    can change, as b * ceil(B/128) + slab: a tile changes the slabs of its
    src block that its rows hold a nonzero in, and those of its dst block
    that its columns do. Most such tiles first, ties ascending.

    :param off_nz: ``nonzero_blocks`` of the tiles.
    :returns: (k,) int32.
    """
    n, m = off_nz.shape[0], off_nz.shape[1]
    per = SLAB // NZ_BLOCK
    k = -(-m // per)
    f = np.zeros((n, k * per, k * per), bool)
    f[:, :m, :m] = off_nz != 0
    rows = f.reshape(n, k, per * k * per).any(axis=2)
    cols = f.reshape(n, k * per, k, per).any(axis=(1, 3))
    count = np.zeros((nb, k), np.int64)
    np.add.at(count, np.asarray(off_src, np.int64), rows)
    np.add.at(count, np.asarray(off_dst, np.int64), cols)
    count = count.reshape(-1)
    order = np.argsort(-count, kind='stable')
    return order[count[order] > 0].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BlockLD:
    """Device-side blocked LD operator.

    :ivar diag: (NB, B, B) diagonal tiles (int8 or float32).
    :ivar off_data: (n_off, B, B) coupling tiles ((0, B, B) when none).
    :ivar off_src: (n_off,) int32 row-tile index of each coupling tile.
    :ivar off_dst: (n_off,) int32 column-tile index (src < dst).
    :ivar mask: (NB, B) float32, 1.0 on real variant lanes, 0.0 on padding.
    :ivar inc_ptr: (NB+1,) int32 CSR offsets into ``inc_tile``.
    :ivar inc_tile: (2*n_off,) int32 incident tiles of each block, ascending.
    :ivar off_nz: (n_off, B/32, B/32) uint8 ``nonzero_blocks``.
    :ivar cpl_slabs: (k,) int32 ``coupling_slabs``.
    :ivar diag_nz: (NB, B/32, B/32) uint8 ``nonzero_blocks`` of ``diag``.
    :ivar scale: dequantization multiplier (1.0 for float storage).
    """
    diag: torch.Tensor
    off_data: torch.Tensor
    off_src: torch.Tensor
    off_dst: torch.Tensor
    mask: torch.Tensor
    inc_ptr: torch.Tensor
    inc_tile: torch.Tensor
    off_nz: torch.Tensor
    cpl_slabs: torch.Tensor
    diag_nz: torch.Tensor
    scale: float

    @property
    def nb(self) -> int:
        return self.diag.shape[0]

    @property
    def block_size(self) -> int:
        return self.diag.shape[1]

    @property
    def n_off(self) -> int:
        return self.off_data.shape[0]

    @property
    def m_padded(self) -> int:
        return self.nb * self.block_size

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def astype_storage(self, dtype):
        """The same LD stored as ``dtype`` (a float dtype, torch's or
        numpy's) with scale 1: each tile becomes ``(tile.to(dtype) * scale)
        .to(dtype)``. Its nonzero blocks are the same, so the flags carry
        over.

        :raises ValueError: for an integer dtype (re-quantization is the
            packers' work), and for a dtype other than float32 on a CUDA
            device (the kernels take int8 or float32 tiles).
        """
        dtype = _torch_dtype(dtype)
        if dtype == self.diag.dtype:
            return self
        if not dtype.is_floating_point:
            raise ValueError("Re-quantization not supported here; build "
                             "from source data.")
        if self.device.type == 'cuda' and dtype != torch.float32:
            raise ValueError(f"the CUDA kernels take int8 or float32 LD "
                             f"tiles, not {dtype}")
        return dataclasses.replace(
            self, diag=(self.diag.to(dtype) * self.scale).to(dtype),
            off_data=(self.off_data.to(dtype) * self.scale).to(dtype),
            scale=1.0)

    @classmethod
    def from_numpy(cls, diag, off_data, off_src, off_dst, mask, scale, *,
                   device):
        """Upload packed LD arrays (e.g. ``np.asarray`` of the JAX package's
        ``BlockLD`` fields) to ``device`` without changing a byte.

        :raises ValueError: for tiles neither int8 nor float32 on a CUDA
            device (the kernels take those two), before anything is
            uploaded.
        """
        diag = np.ascontiguousarray(diag)
        nb, B = diag.shape[0], diag.shape[1]
        off_data = np.ascontiguousarray(off_data).reshape(-1, B, B)
        bad = {str(x.dtype) for x in (diag, off_data)
               if x.dtype not in (np.int8, np.float32)}
        if bad and torch.device(device).type == 'cuda':
            raise ValueError(
                f"the CUDA kernels take int8 or float32 LD tiles, not "
                f"{', '.join(sorted(bad))}: pack the LD with quantize=True "
                f"(int8) or quantize=False (float32) to fit on {device}; "
                f"other tiles run only on the CPU")
        off_src = np.asarray(off_src, np.int32).reshape(-1)
        off_dst = np.asarray(off_dst, np.int32).reshape(-1)
        inc_ptr, inc_tile = incident_tiles(off_src, off_dst, nb)

        def host(x):
            return torch.from_numpy(np.require(x, requirements=['C', 'W']))

        def put(x):
            return host(x).to(device)
        # the coupling tiles' flags on the host (the launch plan is built
        # there); the diagonal tiles' on the device, from the uploaded tiles
        off_nz = nonzero_blocks(host(off_data))
        diag_d = put(diag)
        return cls(diag=diag_d, off_data=put(off_data),
                   off_src=put(off_src), off_dst=put(off_dst),
                   mask=put(np.asarray(mask, np.float32)),
                   inc_ptr=put(inc_ptr), inc_tile=put(inc_tile),
                   off_nz=off_nz.to(device),
                   cpl_slabs=put(coupling_slabs(off_nz.numpy(), off_src,
                                                off_dst, nb)),
                   diag_nz=nonzero_blocks(diag_d),
                   scale=float(scale))


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class PackedLD(NamedTuple):
    """Host (NumPy) result of a packer; ``to(device)`` uploads it."""
    diag: np.ndarray
    off_data: np.ndarray
    off_src: np.ndarray
    off_dst: np.ndarray
    mask: np.ndarray
    scale: float

    def to(self, device) -> BlockLD:
        return BlockLD.from_numpy(*self, device=device)


def make_packed(diag, off_tiles, mask, scale) -> PackedLD:
    """Assemble a PackedLD from a {(src, dst): (B, B) array} coupling dict."""
    items = sorted(off_tiles.items())
    if items:
        off_data = np.stack([v for _, v in items])
        off_src = np.asarray([k[0] for k, _ in items], np.int32)
        off_dst = np.asarray([k[1] for k, _ in items], np.int32)
    else:
        B = diag.shape[1]
        off_data = np.zeros((0, B, B), dtype=diag.dtype)
        off_src = np.zeros(0, np.int32)
        off_dst = np.zeros(0, np.int32)
    return PackedLD(diag=diag, off_data=off_data, off_src=off_src,
                    off_dst=off_dst, mask=mask, scale=scale)


def make_block_ld(diag, off_tiles, mask, scale, *, device) -> BlockLD:
    """Assemble a BlockLD on ``device`` from host tiles and a {(src, dst):
    (B, B) array} coupling dict."""
    return make_packed(diag, off_tiles, mask, scale).to(device)


@dataclasses.dataclass
class BlockLayout:
    """Host-side map between the original (per-chromosome) variant order and
    the padded flat block order.

    :ivar chromosomes: ordered chromosome labels.
    :ivar chrom_sizes: number of real variants per chromosome.
    :ivar chrom_block_range: per chromosome, (first_block, last_block_exclusive).
    :ivar flat_index: (M,) int — for each real variant (in chromosome-sorted
        order), its index in the padded flat space of size NB*B.
    """
    chromosomes: list
    chrom_sizes: list
    chrom_block_range: list
    flat_index: np.ndarray
    block_size: int
    nb: int

    @property
    def m(self) -> int:
        return int(sum(self.chrom_sizes))

    @property
    def m_padded(self) -> int:
        return self.nb * self.block_size

    def to_flat(self, per_chrom: dict):
        """Scatter chromosome-keyed arrays into one padded flat float32
        array (zero on padding lanes)."""
        out = np.zeros(self.m_padded, dtype=np.float32)
        vals = np.concatenate([np.asarray(per_chrom[c])
                               for c in self.chromosomes], axis=0)
        out[self.flat_index] = vals
        return out

    def from_flat(self, flat: np.ndarray) -> dict:
        """Gather a padded flat array back into chromosome-keyed arrays."""
        vals = np.asarray(flat)[self.flat_index]
        out = {}
        start = 0
        for c, sz in zip(self.chromosomes, self.chrom_sizes):
            out[c] = vals[start:start + sz]
            start += sz
        return out

    def mask(self) -> np.ndarray:
        m = np.zeros(self.m_padded, dtype=np.float32)
        m[self.flat_index] = 1.0
        return m.reshape(self.nb, self.block_size)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_int8(x: np.ndarray) -> np.ndarray:
    """Symmetric int8 quantization of correlations in [-1, 1] (scale 1/127).

    Round-half-even then clip: the same bytes as the native quantizer of the
    JAX package (clip-then-nearbyint; the clip bounds are integers)."""
    return np.clip(np.rint(x * 127.0), -127, 127).astype(np.int8)


def plan_layout(chrom_block_sizes: dict, block_size: int = 1024):
    """Compute the packed layout from LD-block SIZES alone (no data needed).

    Best-fit-decreasing bin packing of LD blocks into B-tiles within each
    chromosome (BlockLayout.flat_index keeps the variant-order mapping
    exact). LD blocks wider than B start a fresh tile and span ceil(m_i/B)
    tiles; their last tile stays open to smaller blocks.

    :param chrom_block_sizes: {chrom: [m_i, ...]} per-chromosome LD block sizes.
    :returns: (layout, placements) with placements a list of
        (tile, offset, chrom, block_idx, m_i).
    """
    B = block_size
    chroms = sorted(chrom_block_sizes.keys())

    chrom_sizes, chrom_block_range = [], []
    placements = []         # (tile, offset, chrom, block_idx, m_i)
    flat_idx_by_block = {}  # (chrom, block_idx) -> flat index array
    tile_cursor = 0
    for c in chroms:
        c_first_tile = tile_cursor
        sizes = chrom_block_sizes[c]
        c_size = int(sum(sizes))

        order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
        open_tiles = []  # list of [tile, used]

        for bi in order:
            m_i = int(sizes[bi])
            ntiles = _round_up(max(m_i, 1), B) // B
            if ntiles > 1:
                # multi-tile block: contiguous fresh tiles; tail stays open
                t0 = tile_cursor
                placements.append((t0, 0, c, bi, m_i))
                base = t0 * B
                tile_cursor += ntiles
                if m_i % B:
                    open_tiles.append([t0 + ntiles - 1, m_i % B])
            else:
                # best-fit: the open tile with the least remaining space that fits
                best = None
                for slot in open_tiles:
                    rem = B - slot[1]
                    if m_i <= rem and (best is None or rem < B - best[1]):
                        best = slot
                if best is None:
                    best = [tile_cursor, 0]
                    open_tiles.append(best)
                    tile_cursor += 1
                placements.append((best[0], best[1], c, bi, m_i))
                base = best[0] * B + best[1]
                best[1] += m_i
            flat_idx_by_block[(c, bi)] = np.arange(base, base + m_i,
                                                   dtype=np.int64)

        chrom_sizes.append(c_size)
        chrom_block_range.append((c_first_tile, tile_cursor))

    flat_idx_parts = [flat_idx_by_block[(c, bi)]
                      for c in chroms for bi in range(len(chrom_block_sizes[c]))]
    layout = BlockLayout(chromosomes=chroms,
                         chrom_sizes=chrom_sizes,
                         chrom_block_range=chrom_block_range,
                         flat_index=np.concatenate(flat_idx_parts) if flat_idx_parts
                         else np.zeros(0, np.int64),
                         block_size=B, nb=tile_cursor)
    return layout, placements


def estimate_packed_bytes(chrom_block_sizes: dict, block_size: int = 1024,
                          quantize: bool = True):
    """Bytes of the tiles ``pack_dense_blocks`` would make from LD-block
    sizes alone: the diagonal tiles of the packing plan and the coupling
    tiles of the blocks wider than B, at one byte an element (int8) or four
    (float32). The streaming planner's input."""
    B = block_size
    layout, placements = plan_layout(chrom_block_sizes, block_size=B)
    n_off = 0
    for _, o, _, _, m_i in placements:
        if o == 0 and m_i > B:
            ntiles = _round_up(m_i, B) // B
            n_off += ntiles * (ntiles - 1) // 2
    return (layout.nb + n_off) * B * B * (1 if quantize else 4)


def pack_dense_blocks(chrom_blocks: dict, block_size: int = 1024,
                      quantize: bool = False):
    """Pack per-chromosome lists of dense LD blocks (LDetect-style
    block-diagonal LD) into host arrays + a :class:`BlockLayout`: int8 with
    scale 1/127 when ``quantize``, float32 otherwise.

    Several small LD blocks share one B-tile when they fit; LD blocks larger
    than B span ``ceil(m_i/B)`` tiles plus their coupling tiles.

    :param chrom_blocks: {chrom: [dense (m_i, m_i) float numpy arrays, or
        int8 at scale 1/127]}
    :returns: (PackedLD, BlockLayout)
    """
    B = block_size
    for c, blocks in chrom_blocks.items():
        for blk in blocks:
            if blk.ndim != 2 or blk.shape[0] != blk.shape[1]:
                raise ValueError(f"LD block of chromosome {c} is not square: "
                                 f"{blk.shape}")
    layout, placements = plan_layout(
        {c: [blk.shape[0] for blk in blocks]
         for c, blocks in chrom_blocks.items()}, block_size=B)
    nb = layout.nb

    store_dtype = np.int8 if quantize else np.float32
    diag = np.zeros((nb, B, B), dtype=store_dtype)
    off_tiles = {}

    for tile_start, o, c, bi, m_i in placements:
        blk = chrom_blocks[c][bi]
        # int8 blocks (a quantized store, scale 1/127) pass through when
        # quantizing and become int8 * float32(1/127) otherwise, as in the
        # JAX package
        if blk.dtype == np.int8:
            vals = blk if quantize else \
                blk.astype(np.float32) * np.float32(INT8_SCALE)
        else:
            vals = quantize_int8(blk) if quantize else blk.astype(np.float32)
        if o > 0 or m_i <= B - o:
            diag[tile_start, o:o + m_i, o:o + m_i] = vals
            continue
        ntiles = _round_up(m_i, B) // B
        for ti in range(ntiles):
            r0, r1 = ti * B, min((ti + 1) * B, m_i)
            diag[tile_start + ti, :r1 - r0, :r1 - r0] = vals[r0:r1, r0:r1]
            for k in range(ti + 1, ntiles):
                c0, c1 = k * B, min((k + 1) * B, m_i)
                key = (tile_start + ti, tile_start + k)
                tileblk = off_tiles.setdefault(
                    key, np.zeros((B, B), dtype=store_dtype))
                tileblk[:r1 - r0, :c1 - c0] = vals[r0:r1, c0:c1]

    scale = INT8_SCALE if quantize else 1.0
    return make_packed(diag, off_tiles, layout.mask(), scale), layout


def _banded_values(vals, quantize):
    """The stored values of banded entries: int8 passes through when
    quantizing and becomes int8 * float32(1/127) otherwise; floats are
    quantized from float64, or cast to float32."""
    if vals.dtype == np.int8:
        return vals if quantize else \
            vals.astype(np.float32) * np.float32(INT8_SCALE)
    return quantize_int8(vals.astype(np.float64)) if quantize else \
        vals.astype(np.float32)


#: Entries of banded rows ``pack_banded`` places at a time (bounds its
#: index arrays).
BANDED_CHUNK = 1 << 22


def pack_banded(chrom_banded: dict, block_size: int = 1024,
                quantize: bool = False):
    """Pack per-chromosome *banded* LD (the reference's on-disk layout,
    ``{data, indptr, left_bound}`` with symmetric rows) into diagonal tiles
    and compact coupling tiles, exact for any bandwidth: the windowed
    stores whose band never pinches off into blocks. Each chromosome
    starts a fresh tile; its variants fill tiles in order.

    Only the upper triangle of each row (its diagonal included) is read:
    an entry (j, k), k >= j, goes to (j, k) and (k, j) when both lie in one
    tile, else to the coupling tile of (j's tile, k's tile). Every cell has
    one writer, so the entries are placed about BANDED_CHUNK at a time:
    the same bytes as the JAX package's row-by-row packer.

    :param chrom_banded: {chrom: (data, indptr, left_bound)} where row j of
        R holds ``data[indptr[j]:indptr[j+1]]`` starting at column
        ``left_bound[j]``; ``data`` int8 (scale 1/127) or float.
    :returns: (PackedLD, BlockLayout), int8 with scale 1/127 when
        ``quantize``, float32 otherwise.
    """
    B = block_size
    chroms = sorted(chrom_banded.keys())

    chrom_sizes, chrom_block_range, flat_idx_parts = [], [], []
    tile_cursor = 0
    for c in chroms:
        m_c = len(chrom_banded[c][1]) - 1
        ntiles = _round_up(max(m_c, 1), B) // B
        base = tile_cursor * B
        flat_idx_parts.append(np.arange(base, base + m_c, dtype=np.int64))
        chrom_sizes.append(m_c)
        chrom_block_range.append((tile_cursor, tile_cursor + ntiles))
        tile_cursor += ntiles

    nb = tile_cursor
    layout = BlockLayout(chromosomes=chroms, chrom_sizes=chrom_sizes,
                         chrom_block_range=chrom_block_range,
                         flat_index=np.concatenate(flat_idx_parts)
                         if flat_idx_parts else np.zeros(0, np.int64),
                         block_size=B, nb=nb)

    store_dtype = np.int8 if quantize else np.float32
    diag = np.zeros((nb, B, B), dtype=store_dtype)
    off_tiles = {}

    for c, (t0, _) in zip(chroms, chrom_block_range):
        data, indptr, left = chrom_banded[c]
        data = np.asarray(data)
        indptr = np.asarray(indptr, np.int64)
        left = np.asarray(left, np.int64)
        m_c = len(indptr) - 1
        j0 = 0
        while j0 < m_c:
            # rows [j0, j1): about BANDED_CHUNK entries, at least one row
            j1 = int(np.searchsorted(indptr, indptr[j0] + BANDED_CHUNK,
                                     side='right')) - 1
            j1 = min(max(j1, j0 + 1), m_c)
            e0, e1 = int(indptr[j0]), int(indptr[j1])
            rows = np.repeat(np.arange(j0, j1, dtype=np.int64),
                             np.diff(indptr[j0:j1 + 1]))
            cols = left[rows] + (np.arange(e0, e1, dtype=np.int64)
                                 - indptr[rows])
            sel = cols >= rows
            rows, cols = rows[sel], cols[sel]
            vals = _banded_values(data[e0:e1][sel], quantize)
            bj, oj = np.divmod(t0 * B + rows, B)
            bc, oc = np.divmod(t0 * B + cols, B)
            same = bc == bj
            diag[bj[same], oj[same], oc[same]] = vals[same]
            diag[bj[same], oc[same], oj[same]] = vals[same]
            for a, b2 in np.unique(np.stack([bj, bc])[:, ~same], axis=1).T:
                sel = (bj == a) & (bc == b2)
                tileblk = off_tiles.setdefault(
                    (int(a), int(b2)), np.zeros((B, B), dtype=store_dtype))
                tileblk[oj[sel], oc[sel]] = vals[sel]
            j0 = j1

    scale = INT8_SCALE if quantize else 1.0
    return make_packed(diag, off_tiles, layout.mask(), scale), layout


def blockld_to_dense(ld) -> np.ndarray:
    """The full dense (padded, (NB B, NB B) float64) LD matrix of a
    BlockLD or PackedLD, on the host: for tests and small problems."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    diag = host(ld.diag).astype(np.float64) * ld.scale
    off = host(ld.off_data).astype(np.float64) * ld.scale
    nb, B = diag.shape[0], diag.shape[1]
    R = np.zeros((nb * B, nb * B), dtype=np.float64)
    for b in range(nb):
        R[b * B:(b + 1) * B, b * B:(b + 1) * B] = diag[b]
    for o, (b, b2) in enumerate(zip(host(ld.off_src), host(ld.off_dst))):
        b, b2 = int(b), int(b2)
        R[b * B:(b + 1) * B, b2 * B:(b2 + 1) * B] = off[o]
        R[b2 * B:(b2 + 1) * B, b * B:(b + 1) * B] = off[o].T
    return R
