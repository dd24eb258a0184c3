"""The port's LD packer and dataset against the JAX package's.

Both packages pack the same numpy LD blocks; the port's output must be
byte-identical (tiles, coupling tiles, indices, mask, layout). One LD block
has 300 variants, so the JAX side quantizes it with its native (C++)
quantizer, and it spans three B = 128 tiles, so coupling tiles exist.
"""

import numpy as np
import pytest
import torch

from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.ops import block_ld as jax_block_ld

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.ops import block_ld


@pytest.fixture(scope='module')
def sim():
    return simulate_sumstats_blocks(n=1500, block_sizes=(300, 150, 100, 60),
                                    h2=0.3, prop_causal=0.05, seed=3)


@pytest.mark.parametrize('quantize', [True, False])
@pytest.mark.parametrize('block_size', [128, 256])
def test_pack_dense_blocks_byte_identical(sim, quantize, block_size):
    jld, jlay = jax_block_ld.pack_dense_blocks(
        sim['ld_blocks'], block_size=block_size, quantize=quantize)
    packed, lay = block_ld.pack_dense_blocks(
        sim['ld_blocks'], block_size=block_size, quantize=quantize)
    if block_size == 128:
        assert jld.n_off > 0
    for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'):
        want = np.asarray(getattr(jld, f))
        got = getattr(packed, f)
        assert got.dtype == want.dtype, f
        assert got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    assert packed.scale == jld.scale
    np.testing.assert_array_equal(lay.flat_index, jlay.flat_index)
    assert (lay.nb, lay.block_size) == (jlay.nb, jlay.block_size)
    assert lay.chrom_block_range == jlay.chrom_block_range
    assert lay.chrom_sizes == jlay.chrom_sizes
    np.testing.assert_array_equal(lay.mask(), jlay.mask())


def test_quantizer_matches_native(sim):
    """The port's np.rint quantizer gives the bytes of the JAX package's
    quantizer, which takes its native (C++) kernel for a block this large
    whenever the native library builds."""
    blk = sim['ld_blocks'][22][0]
    assert blk.size >= 1 << 16
    assert block_ld.quantize_int8(blk).tobytes() == \
        jax_block_ld.quantize_int8(blk).tobytes()
    edges = np.array([-1.0, -0.5 / 127, 0.5 / 127, 1.5 / 127, 1.0, 2.0, -2.0])
    assert block_ld.quantize_int8(edges).tolist() == \
        jax_block_ld.quantize_int8(edges).tolist()


def test_from_numpy_carries_jax_fields(sim):
    """BlockLD.from_numpy keeps every byte of the JAX package's fields, and
    its incidence lists name each coupling tile once per end, ascending."""
    jld, _ = jax_block_ld.pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                            quantize=True)
    ld = block_ld.BlockLD.from_numpy(
        *(np.asarray(getattr(jld, f)) for f in
          ('diag', 'off_data', 'off_src', 'off_dst', 'mask')),
        jld.scale, device='cpu')
    for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'):
        assert getattr(ld, f).numpy().tobytes() == \
            np.asarray(getattr(jld, f)).tobytes()
    assert ld.off_src.dtype == torch.int32 and ld.diag.dtype == torch.int8
    ptr, tiles = ld.inc_ptr.numpy(), ld.inc_tile.numpy()
    src, dst = np.asarray(jld.off_src), np.asarray(jld.off_dst)
    for b in range(ld.nb):
        lst = tiles[ptr[b]:ptr[b + 1]]
        assert list(lst) == sorted(lst)
        want = [o for o in range(jld.n_off) if src[o] == b or dst[o] == b]
        assert list(lst) == want
    assert ptr[-1] == 2 * jld.n_off


@pytest.mark.parametrize('B', [128, 256])
def test_from_numpy_flags_the_nonzero_blocks(B):
    """off_nz flags exactly the 32 x 32 blocks of each coupling tile that
    hold a nonzero, on tiles that are zero but for scattered entries."""
    rng = np.random.default_rng(B)
    nb, pairs = 6, [(0, 1), (0, 2), (3, 4), (4, 5)]
    off = np.zeros((len(pairs), B, B), np.int8)
    for o in range(len(pairs)):
        r, c = rng.integers(0, B, 5), rng.integers(0, B, 5)
        off[o, r, c] = rng.integers(1, 127, 5)
    off[2] = 0
    ld = block_ld.BlockLD.from_numpy(
        np.zeros((nb, B, B), np.int8), off, [p[0] for p in pairs],
        [p[1] for p in pairs], np.ones((nb, B), np.float32), 1 / 127,
        device='cpu')
    m = B // 32
    assert ld.off_nz.dtype == torch.uint8 and ld.off_nz.shape == (4, m, m)
    for o in range(len(pairs)):
        for i in range(m):
            for j in range(m):
                want = off[o, 32 * i:32 * i + 32, 32 * j:32 * j + 32].any()
                assert ld.off_nz[o, i, j] == want
    assert not ld.off_nz[2].any()


def test_dataset_inputs_and_ld_scores(sim):
    """device_inputs and compute_ld_scores against the JAX dataset."""
    args = (sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'])
    jds = JaxDataset.from_dense_blocks(*args, block_size=128, quantize=True)
    ds = SummaryStatsDataset.from_dense_blocks(*args, block_size=128,
                                               quantize=True, device='cpu')
    sb, nf = ds.device_inputs()
    assert sb.dtype == torch.float32 and sb.shape == (ds.layout.nb, 128)
    assert sb.numpy().tobytes() == np.asarray(jds.std_beta_flat()).tobytes()
    assert nf.numpy().tobytes() == np.asarray(jds.n_per_snp_flat()).tobytes()
    got = ds.compute_ld_scores()
    want = jds.compute_ld_scores()
    # squared int8 values sum exactly in float32 (< 2^24): equal bits
    for c in want:
        np.testing.assert_array_equal(got[c], np.asarray(want[c]))
    assert ds.m == jds.m and ds.n == jds.n


def test_dataset_rejects_malformed_input(sim):
    bad = {c: v[:-1] for c, v in sim['std_beta'].items()}
    with pytest.raises(ValueError, match='do not match'):
        SummaryStatsDataset.from_dense_blocks(
            sim['ld_blocks'], bad, sim['n_per_snp'], block_size=128,
            device='cpu')
    with pytest.raises(ValueError, match='not square'):
        block_ld.pack_dense_blocks({1: [np.zeros((4, 3))]}, block_size=128)


@pytest.mark.parametrize('dtype', [np.float64, np.float16])
def test_other_float_tiles_on_a_cuda_device_are_refused_up_front(sim, dtype):
    """The CUDA kernels take int8 or float32 LD: float64 or float16 tiles
    bound for a CUDA device raise a ValueError that names quantize=True
    before anything is uploaded (so not torch's error for a build without
    CUDA)."""
    packed, _ = block_ld.pack_dense_blocks(sim['ld_blocks'], block_size=128)
    with pytest.raises(ValueError, match='quantize=True') as err:
        block_ld.BlockLD.from_numpy(
            packed.diag.astype(dtype), packed.off_data.astype(dtype),
            packed.off_src, packed.off_dst, packed.mask, packed.scale,
            device=torch.device('cuda', 0))
    assert np.dtype(dtype).name in str(err.value)
    assert 'compiled' not in str(err.value)


@pytest.mark.parametrize('quantize', [True, False])
def test_int8_and_float32_tiles_pass_the_check_for_a_cuda_device(
        sim, quantize, monkeypatch):
    """int8 and float32 tiles (the packers' two storage types) pass
    from_numpy's check for a CUDA device: the upload itself is reached (a
    stand-in records each tensor's move to the card's device)."""
    moved = []

    def to(self, *args, **kwargs):
        moved.append((self.dtype, args))
        return self

    monkeypatch.setattr(torch.Tensor, 'to', to)
    packed, _ = block_ld.pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                           quantize=quantize)
    dev = torch.device('cuda', 0)
    ld = packed.to(dev)
    dtype = torch.int8 if quantize else torch.float32
    assert ld.diag.dtype == ld.off_data.dtype == dtype
    assert (dtype, (dev,)) in moved


@pytest.mark.parametrize('model', ['VIPRSGrid', 'VIPRSMixGrid', 'GridSearch'])
def test_grid_models_build_on_float32_ld_off_the_cpu(sim, model):
    """The grid models fit their lanes with the S-lane kernels, which have
    float32 instances: on a device that is not the CPU (meta, the card's
    stand-in) float32 LD builds the model, as on the CPU, with the grid's
    points as its lanes."""
    from viprs_tpu_torch.gridsearch import GridSearch, HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid, VIPRSMixGrid
    cls = {'VIPRSGrid': VIPRSGrid, 'VIPRSMixGrid': VIPRSMixGrid,
           'GridSearch': GridSearch}[model]
    for device in ('meta', 'cpu'):
        ds = SummaryStatsDataset.from_dense_blocks(
            sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'],
            block_size=128, device=device)
        assert ds.ld.diag.dtype == torch.float32
        assert ds.ld.diag.device.type == device
        m = cls(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3), device)
        grid = m.model if model == 'GridSearch' else m
        assert grid.n_models == 3 and grid.device.type == device


@pytest.mark.parametrize('quantize', [True, False])
def test_int8_and_float32_tiles_build_on_the_cpu(sim, quantize):
    ds = SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128,
        quantize=quantize, device='cpu')
    assert ds.ld.diag.dtype == (torch.int8 if quantize else torch.float32)
    assert ds.ld.off_data.dtype == ds.ld.diag.dtype
    assert ds.ld.diag_nz.shape == (ds.ld.nb, 4, 4)


def _recount_nonzero_blocks(diag):
    """numpy recount: 1 where a 32 x 32 block of a tile holds a nonzero."""
    n, B = diag.shape[0], diag.shape[1]
    m = B // 32
    out = np.zeros((n, m, m), np.uint8)
    for t in range(n):
        for i in range(m):
            for j in range(m):
                out[t, i, j] = (diag[t, 32 * i:32 * i + 32,
                                     32 * j:32 * j + 32] != 0).any()
    return out


@pytest.mark.parametrize('block_size', [128, 256])
def test_diag_nz_flags_the_nonzero_blocks_of_the_diagonal_tiles(sim,
                                                                 block_size):
    """diag_nz equals a numpy recount of diag != 0 per 32 x 32 block, on the
    packed LD (blocks of several LD blocks, so with zero blocks between
    them) and on banded tiles whose far blocks are all zero."""
    packed, _ = block_ld.pack_dense_blocks(sim['ld_blocks'],
                                           block_size=block_size,
                                           quantize=True)
    ld = packed.to('cpu')
    assert ld.diag_nz.dtype == torch.uint8
    want = _recount_nonzero_blocks(packed.diag)
    np.testing.assert_array_equal(ld.diag_nz.numpy(), want)
    assert 0 < want.sum() < want.size
    x = np.arange(block_size)
    band = np.rint(127 * 0.8 ** np.abs(x[:, None] - x[None])).astype(np.int8)
    banded = block_ld.BlockLD.from_numpy(
        np.stack([band, np.zeros_like(band)]), np.zeros((0, block_size,
                                                         block_size), np.int8),
        [], [], np.ones((2, block_size), np.float32), 1 / 127, device='cpu')
    np.testing.assert_array_equal(banded.diag_nz.numpy(),
                                  _recount_nonzero_blocks(
                                      np.stack([band, np.zeros_like(band)])))
    m = block_size // 32
    assert banded.diag_nz[0].numpy().tolist() == \
        (np.abs(np.subtract.outer(np.arange(m), np.arange(m))) <= 1).tolist()
    assert not banded.diag_nz[1].any()


@pytest.mark.parametrize('B,chunk', [(128, 3), (100, 2), (256, 64)])
def test_nonzero_blocks_in_chunks_matches_a_recount(B, chunk):
    """nonzero_blocks works a few tiles at a time on the tiles' own device:
    across chunk boundaries, and for a width that is not a multiple of 32
    (the last block row and column padded with zeros), it is the recount of
    tiles != 0 per 32 x 32 block."""
    rng = np.random.default_rng(B)
    tiles = np.zeros((7, B, B), np.int8)
    for t in range(7):
        r, c = rng.integers(0, B, 4), rng.integers(0, B, 4)
        tiles[t, r, c] = rng.integers(1, 127, 4)
    tiles[4] = 0
    tiles[5, B - 1, B - 1] = 9
    got = block_ld.nonzero_blocks(torch.from_numpy(tiles), chunk=chunk)
    m = -(-B // 32)
    pad = np.zeros((7, 32 * m, 32 * m), np.int8)
    pad[:, :B, :B] = tiles
    assert got.dtype == torch.uint8 and got.shape == (7, m, m)
    np.testing.assert_array_equal(got.numpy(), _recount_nonzero_blocks(pad))
    assert got[5, m - 1, m - 1] == 1 and not got[4].any()


def test_diag_nz_is_built_alike_for_int8_and_float32_tiles(sim):
    """One builder for both storage types: each packing's flags are the
    recount of its own tiles' zeros, and the int8 flags lie within the
    float32 ones (quantizing only turns correlations under 0.5/127 into
    zeros)."""
    flags = {}
    for quantize in (True, False):
        packed, _ = block_ld.pack_dense_blocks(sim['ld_blocks'],
                                               block_size=128,
                                               quantize=quantize)
        flags[quantize] = packed.to('cpu').diag_nz.numpy()
        np.testing.assert_array_equal(flags[quantize],
                                      _recount_nonzero_blocks(packed.diag))
    assert (flags[True] <= flags[False]).all()
    assert flags[True].sum() > 0


def test_diag_nz_survives_repacking_a_cut(sim):
    """Re-packing some of the blocks (as chip_smoke.py cuts the genome:
    index the tiles, keep the coupling tiles between kept blocks, renumber)
    carries each kept block's flags unchanged."""
    packed, _ = block_ld.pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                           quantize=True)
    ld = packed.to('cpu')
    sel = np.arange(1, ld.nb, 2)
    pos = {int(b): i for i, b in enumerate(sel)}
    src, dst = ld.off_src.numpy(), ld.off_dst.numpy()
    keep = [o for o in range(ld.n_off) if src[o] in pos and dst[o] in pos]
    idx = torch.as_tensor(sel)
    cut = block_ld.BlockLD.from_numpy(
        ld.diag.index_select(0, idx).numpy(),
        ld.off_data.index_select(0, torch.as_tensor(keep, dtype=torch.long))
        .numpy(), [pos[src[o]] for o in keep], [pos[dst[o]] for o in keep],
        ld.mask.index_select(0, idx).numpy(), ld.scale, device='cpu')
    assert torch.equal(cut.diag_nz, ld.diag_nz.index_select(0, idx))
