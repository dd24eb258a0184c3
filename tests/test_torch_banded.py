"""The port's banded LD packing (``pack_banded``, ``from_banded``) and the
rest of ``ops/block_ld``'s surface against the JAX package's.

The banded inputs are the three the JAX package's tests pack: a windowed
matrix of bandwidth 40 whose band never pinches off (tests/test_ops.py,
B = 128: the window crosses the tile boundary), a magenpy-style store of
three LD blocks (tests/test_zarr.py, B = 64) and a quantized store of two
blocks (tests/test_golden_kernel.py, int8 rows, B = 128); each packed as
int8 and as float32, from float and from int8 rows. The packed LD must be
the JAX package's byte for byte: tiles, coupling tiles, indices, mask,
scale and layout. The fit on banded LD is held to the JAX package's as
tests/test_torch_viprs.py holds fits (behind its guard).
"""

import numpy as np
import pytest
import torch

from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.model import VIPRS as JaxVIPRS
from viprs_tpu.ops import block_ld as jbl

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.model import VIPRS
from viprs_tpu_torch.ops import block_ld

from golden_kernel import dense_to_banded
from test_golden_kernel import _problem
from test_torch_viprs import (assert_clear_of_thresholds,  # noqa: F401
                              assert_fits_match, ladder_trace)
from test_zarr import _banded_from_blocks, _sim_blocks


def windowed(m=200, w=40, seed=42):
    """tests/test_ops.py's banded matrix: sample correlations of 200
    variants kept within 40 of the diagonal, as symmetric float rows."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((800, m))
    X = (X - X.mean(0)) / X.std(0)
    R = X.T @ X / 800
    data, indptr, left = [], [0], []
    for j in range(m):
        lo, hi = max(0, j - w), min(m, j + w + 1)
        data.extend(R[j, lo:hi])
        indptr.append(len(data))
        left.append(lo)
    return np.array(data), np.array(indptr), np.array(left)


#: name -> ({chrom: (data, indptr, left)}, block size)
BANDED = {
    'windowed': lambda: ({1: windowed()}, 128),
    'blocks': lambda: ({22: _banded_from_blocks(_sim_blocks(),
                                                quantize=False)}, 64),
    'blocks_int8': lambda: ({22: _banded_from_blocks(_sim_blocks())}, 64),
    'golden_int8': lambda: ({22: dense_to_banded(
        _problem(m=256, seed=19, n_blocks=2)[0], dtype=np.int8)}, 128),
    'two_chroms': lambda: ({1: windowed(m=150, w=30, seed=1),
                            2: windowed(m=90, w=70, seed=2)}, 64),
}


def assert_packed_equal(packed, lay, jld, jlay):
    for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'):
        want = np.asarray(getattr(jld, f))
        got = np.asarray(getattr(packed, f))
        assert got.dtype == want.dtype, f
        assert got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    assert packed.scale == jld.scale
    np.testing.assert_array_equal(lay.flat_index, jlay.flat_index)
    assert (lay.nb, lay.block_size) == (jlay.nb, jlay.block_size)
    assert lay.chromosomes == jlay.chromosomes
    assert lay.chrom_block_range == jlay.chrom_block_range
    assert lay.chrom_sizes == jlay.chrom_sizes


@pytest.mark.parametrize('quantize', [True, False])
@pytest.mark.parametrize('case', sorted(BANDED))
def test_pack_banded_byte_identical(case, quantize):
    banded, B = BANDED[case]()
    jld, jlay = jbl.pack_banded(banded, block_size=B, quantize=quantize)
    packed, lay = block_ld.pack_banded(banded, block_size=B,
                                       quantize=quantize)
    # the golden store's two blocks of 128 fill their tiles exactly
    assert (jld.n_off > 0) == (case != 'golden_int8')
    assert packed.diag.dtype == (np.int8 if quantize else np.float32)
    assert_packed_equal(packed, lay, jld, jlay)


@pytest.mark.parametrize('chunk', [1, 333, 5000])
def test_pack_banded_in_chunks(chunk, monkeypatch):
    """Any chunk of entries gives the same bytes (one row at a time with
    a chunk of 1)."""
    monkeypatch.setattr(block_ld, 'BANDED_CHUNK', chunk)
    banded, B = BANDED['two_chroms']()
    jld, jlay = jbl.pack_banded(banded, block_size=B, quantize=True)
    packed, lay = block_ld.pack_banded(banded, block_size=B, quantize=True)
    assert_packed_equal(packed, lay, jld, jlay)


@pytest.mark.parametrize('case', ['windowed', 'golden_int8'])
def test_blockld_to_dense_matches_jax(case):
    banded, B = BANDED[case]()
    jld, _ = jbl.pack_banded(banded, block_size=B, quantize=True)
    packed, _ = block_ld.pack_banded(banded, block_size=B, quantize=True)
    want = jbl.blockld_to_dense(jld)
    assert block_ld.blockld_to_dense(packed).tobytes() == want.tobytes()
    ld = packed.to('cpu')
    assert block_ld.blockld_to_dense(ld).tobytes() == want.tobytes()
    assert ld.m_padded == jld.m_padded == want.shape[0]


@pytest.mark.parametrize('dtype', [np.float32, torch.float32, 'float64'])
def test_astype_storage_matches_jax(dtype):
    banded, B = BANDED['windowed']()
    jld, _ = jbl.pack_banded(banded, block_size=B, quantize=True)
    ld = block_ld.pack_banded(banded, block_size=B, quantize=True)[0].to(
        'cpu')
    jdt = {np.float32: np.float32, torch.float32: np.float32,
           'float64': np.float64}[dtype]
    want = jld.astype_storage(jdt)
    got = ld.astype_storage(dtype)
    assert got.scale == want.scale == 1.0
    for f in ('diag', 'off_data'):
        assert getattr(got, f).numpy().tobytes() == \
            np.asarray(getattr(want, f)).tobytes(), f
    for f in ('diag_nz', 'off_nz', 'cpl_slabs', 'inc_ptr', 'inc_tile'):
        assert torch.equal(getattr(got, f), getattr(ld, f)), f
    assert got.astype_storage(got.diag.dtype) is got
    assert ld.astype_storage(np.int8) is ld
    with pytest.raises(ValueError, match='Re-quantization'):
        jld.astype_storage(np.int32)
    with pytest.raises(ValueError, match='Re-quantization'):
        ld.astype_storage(np.int32)


def test_make_block_ld_matches_jax():
    rng = np.random.default_rng(0)
    diag = rng.standard_normal((3, 64, 64)).astype(np.float32)
    off = {(0, 2): rng.standard_normal((64, 64)).astype(np.float32),
           (0, 1): rng.standard_normal((64, 64)).astype(np.float32)}
    mask = np.ones((3, 64), np.float32)
    jld = jbl.make_block_ld(diag, off, mask, 1.0)
    ld = block_ld.make_block_ld(diag, off, mask, 1.0, device='cpu')
    for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'):
        assert getattr(ld, f).numpy().tobytes() == \
            np.asarray(getattr(jld, f)).tobytes(), f
    assert ld.inc_ptr.tolist() == [0, 2, 3, 4]


def banded_of_sim(sim):
    """The simulation's LD blocks as one chromosome's symmetric float rows
    (tests/test_zarr.py's conversion)."""
    (c, blocks), = sim['ld_blocks'].items()
    return {c: _banded_from_blocks(blocks, quantize=False)}


@pytest.mark.parametrize('quantize', [True, False])
def test_from_banded_fit_matches_jax(quantize, ladder_trace):
    """VIPRS on from_banded LD (the LD blocks of 150 and 90 variants laid
    out in chromosome order over two tiles of 128: the first block's rows
    cross into the second tile, a coupling tile) against the JAX package's
    fit on its own from_banded dataset, with test_torch_viprs.py's
    tolerances; min_iter 12 and f_abs_tol 2e-3 stop both on the ELBO clear
    of every threshold."""
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(150, 90), h2=0.3,
                                   prop_causal=0.05, seed=4)
    banded = banded_of_sim(sim)
    args = (banded, sim['std_beta'], sim['n_per_snp'])
    jds = JaxDataset.from_banded(*args, block_size=128, quantize=quantize)
    ds = SummaryStatsDataset.from_banded(*args, block_size=128,
                                         quantize=quantize, device='cpu')
    assert ds.ld.n_off > 0
    assert ds.chromosomes == jds.chromosomes
    assert ds.n_snps == jds.n_snps
    assert ds.phenotype_likelihood == jds.phenotype_likelihood
    np.testing.assert_array_equal(ds.std_beta_flat().numpy(),
                                  np.asarray(jds.std_beta_flat()))
    np.testing.assert_array_equal(ds.n_per_snp_flat().numpy(),
                                  np.asarray(jds.n_per_snp_flat()))
    fit_kw = dict(max_iter=200, min_iter=12, f_abs_tol=2e-3)
    np.random.seed(3)
    jm = JaxVIPRS(jds, mesh='off').fit(**fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(3)
    tm = VIPRS(ds, 'cpu').fit(sweep_impl='xla', **fit_kw)
    assert jm.optim_result.success
    assert_fits_match(jm, tm)
