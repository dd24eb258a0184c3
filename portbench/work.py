"""The E-step work that the benchmark's inputs need, and its least time.

Counted on the benchmark's own tiling (``layout.plan_layout``) of its own
panel, stored as the configuration says (int8 at 1/127 or float32): which
32 x 32 blocks of each B x B tile hold a nonzero, and how many nonzeros each
coupling tile holds. An AR(1) block stores rho^|i - j|, which is nonzero
exactly within a band |i - j| <= D, so the counts follow from each block's
D without building a tile.

The arithmetic is a frozen copy of the repository's kernel bounds
(``chip_smoke.sweep_work_nz`` / ``coupling_work``, held against them by
``tests/test_work.py``): a block sweep reads the nonzero blocks of the
diagonal tiles once with their flags, beta, n and the mask, ``planes_in``
state planes per lane and writes ``planes_out``; per lane each nonzero
block costs 32 x 32 FMA in the rank-T update and, inside a (T, T) tile, in
each inner step's two products. A coupling pass reads the nonzero blocks
of the coupling tiles once, the 32-coordinate eta chunks they multiply, and
reads and writes q of the 128-coordinate slabs they change; one FMA per
nonzero element per lane, each tile applied both ways.
"""

import json
import os

import numpy as np

from .panel import stored_column

NZ = 32          # side of a flagged block
TILE = 128       # coordinates updated jointly
INNER_STEPS = 8  # tile-local passes per tile
SLAB = 128

HERE = os.path.dirname(os.path.abspath(__file__))


def band(rho, m, quantize):
    """The largest |i - j| at which the stored block is nonzero."""
    nz = np.nonzero(stored_column(rho, m, quantize))[0]
    return int(nz[-1]) if len(nz) else -1


def _interval_gap(a0, a1, b0, b1):
    """Least |r - c| for r in [a0, a1), c in [b0, b1) (arrays)."""
    return np.maximum(0, np.maximum(b0 - (a1 - 1), a0 - (b1 - 1)))


def _pairs_within(r0, r1, c0, c1, D):
    """#{(r, c): r in [r0, r1), c in [c0, c1), |r - c| <= D}."""
    r = np.arange(r0, r1)
    lo = np.maximum(c0, r - D)
    hi = np.minimum(c1 - 1, r + D)
    return int(np.maximum(0, hi - lo + 1).sum())


class Counts:
    """The nonzero structure of the packed panel.

    :ivar nb: number of diagonal tiles; :ivar B: tile side.
    :ivar elem: bytes of a stored element (1 int8, 4 float32).
    :ivar diag_nz: (nb, B/32, B/32) bool.
    :ivar off_src, off_dst: (n_off,) coupling tiles (src < dst).
    :ivar off_nz: (n_off, B/32, B/32) bool; :ivar off_nnz: (n_off,) int.
    """

    def __init__(self, panel, quantize, block_size):
        B = self.B = int(block_size)
        m32 = B // NZ
        self.elem = 1 if quantize else 4
        from .layout import plan_layout
        sizes = panel.sizes_by_chrom()
        self.nb, placements, _ = plan_layout(sizes, B)
        order = {}
        k = 0
        for c, chrom_sizes in sizes.items():
            for bi in range(len(chrom_sizes)):
                order[(c, bi)] = k
                k += 1
        diag = np.zeros((self.nb, m32, m32), bool)
        off = {}
        for t, o, c, bi, m_b in placements:
            j = order[(c, bi)]
            D = band(panel.rho[j], m_b, quantize)
            base = t * B + o
            g = np.arange(base // NZ, (base + m_b - 1) // NZ + 1)
            lo = np.maximum(g * NZ, base)
            hi = np.minimum(g * NZ + NZ, base + m_b)
            nzp = _interval_gap(lo[:, None], hi[:, None], lo[None, :],
                                hi[None, :]) <= D
            ti, tl = g // m32, g % m32
            for a in np.unique(ti):
                ra = ti == a
                for b in np.unique(ti):
                    if b < a:
                        continue
                    cb = ti == b
                    blk = nzp[np.ix_(ra, cb)]
                    if a == b:
                        diag[a][np.ix_(tl[ra], tl[cb])] |= blk
                        continue
                    key = (int(a), int(b))
                    if key not in off:
                        off[key] = [np.zeros((m32, m32), bool), 0]
                    off[key][0][np.ix_(tl[ra], tl[cb])] |= blk
                    r0, r1 = (a - t) * B - o, min((a - t + 1) * B - o, m_b)
                    c0, c1 = (b - t) * B - o, min((b - t + 1) * B - o, m_b)
                    off[key][1] += _pairs_within(r0, r1, c0, c1, D)
        self.diag_nz = diag
        keys = sorted(off)
        self.off_src = np.array([k[0] for k in keys], np.int64)
        self.off_dst = np.array([k[1] for k in keys], np.int64)
        self.off_nz = np.stack([off[k][0] for k in keys]) if keys else \
            np.zeros((0, m32, m32), bool)
        self.off_nnz = np.array([off[k][1] for k in keys], np.int64)
        self._cache = {}

    @property
    def n_off(self):
        return len(self.off_src)

    def sweep_terms(self):
        """(fixed bytes, bytes per lane and plane, FMA per lane) of a block
        sweep over every block."""
        if 'sweep' not in self._cache:
            nz = self.diag_nz
            m32 = nz.shape[1]
            tiles = np.arange(m32) // (TILE // NZ)
            in_tile = tiles[:, None] == tiles[None, :]
            n_inner = int((nz & in_tile[None]).sum())
            n_nz = int(nz.sum())
            fixed = NZ * NZ * self.elem * n_nz + nz.size \
                + 4 * self.nb * self.B * 3
            per_plane = 4 * self.nb * self.B
            fma = NZ * NZ * (INNER_STEPS * 2 * n_inner + n_nz)
            self._cache['sweep'] = (fixed, per_plane, fma)
        return self._cache['sweep']

    def sweep_work(self, S, planes_in, planes_out):
        """(bytes, FP32 operations) of one block sweep for S lanes."""
        fixed, per_plane, fma = self.sweep_terms()
        S = np.asarray(S, np.float64)
        return fixed + per_plane * S * (planes_in + planes_out), 2.0 * fma * S

    def coupling_terms(self):
        """(fixed bytes, bytes per lane, operations per lane) of a coupling
        pass over every coupling tile."""
        if 'coupling' not in self._cache:
            if self.n_off == 0:
                self._cache['coupling'] = (0, 0, 0)
                return self._cache['coupling']
            nz = self.off_nz
            m32 = nz.shape[1]
            reads = np.zeros((self.nb, m32), np.int64)
            np.add.at(reads, self.off_dst, nz.any(axis=1))
            np.add.at(reads, self.off_src, nz.any(axis=2))
            ns = m32 // (SLAB // NZ)
            writes = np.zeros((self.nb, ns), np.int64)
            np.add.at(writes, self.off_src,
                      nz.reshape(-1, ns, (SLAB // NZ) * m32).any(axis=2))
            np.add.at(writes, self.off_dst,
                      nz.reshape(-1, m32, ns, SLAB // NZ).any(axis=(1, 3)))
            fixed = int(nz.sum()) * NZ * NZ * self.elem
            per_lane = 4 * NZ * int((reads > 0).sum()) \
                + 2 * 4 * SLAB * int((writes > 0).sum())
            ops = 2 * 2 * int(self.off_nnz.sum())
            self._cache['coupling'] = (fixed, per_lane, ops)
        return self._cache['coupling']

    def coupling_work(self, S):
        fixed, per_lane, ops = self.coupling_terms()
        S = np.asarray(S, np.float64)
        if fixed == 0:
            return np.zeros_like(S), np.zeros_like(S)
        return fixed + per_lane * S, ops * S


def peaks(kind):
    """The published peaks of a device kind from ``peaks.json``, or None."""
    with open(os.path.join(HERE, 'peaks.json')) as f:
        table = json.load(f)
    return table.get(kind)


def bound_s(nbytes, flops, peak):
    """The least seconds the card could take: the larger of bytes at the
    memory's peak and FP32 operations at the FP32 peak (elementwise)."""
    return np.maximum(np.asarray(nbytes, np.float64) / peak['hbm_bytes_per_s'],
                      np.asarray(flops, np.float64) / peak['fp32_flops_per_s'])


def live_lanes(nits):
    """(n_iter,) lanes live at each iteration 1..max(nit): a lane is live
    at iteration i while i <= its nit."""
    nits = np.asarray(nits, np.int64)
    n = int(nits.max()) if len(nits) else 0
    it = np.arange(1, n + 1)
    return (nits[None, :] >= it[:, None]).sum(axis=1)


def estep_bound_s(counts, nits, planes_in, planes_out, peak):
    """The least seconds of one fit's E-steps: every iteration's block
    sweep and coupling pass over the lanes still live (``nits``, each
    lane's iterations), each at its own bound."""
    L = live_lanes(nits).astype(np.float64)
    sb, sf = counts.sweep_work(L, planes_in, planes_out)
    cb, cf = counts.coupling_work(L)
    total = bound_s(sb, sf, peak).sum()
    if counts.n_off:
        total += bound_s(cb, cf, peak).sum()
    return float(total)
