"""The frozen panel generator, the traits and the nonzero-block counts."""

import numpy as np
import pytest
import torch

from portbench import panel as pb_panel
from portbench import work


@pytest.mark.parametrize('seed', [0, 3])
def test_generator_is_bench_byte_for_byte(seed):
    import bench
    a = bench.synthesize_genome(m_target=20_000, seed=seed)
    b = pb_panel.synthesize_genome(m_target=20_000, seed=seed)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for c in x:
            xs = x[c] if isinstance(x[c], list) else [x[c]]
            ys = y[c] if isinstance(y[c], list) else [y[c]]
            assert len(xs) == len(ys)
            for u, v in zip(xs, ys):
                assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_trait_is_r_beta_plus_ar1_noise():
    cfg = {'m_target': 8000, 'n_gwas': 350000, 'panel_seed': 1}
    p = pb_panel.make_panel(cfg)
    sb, nn = pb_panel.draw_trait(p, np.random.default_rng(7), 0.25, 0.01,
                                 350000.0)
    rng = np.random.default_rng(7)
    m = p.m
    causal = rng.random(m) < 0.01
    beta = np.where(causal, rng.standard_normal(m)
                    * np.sqrt(0.25 / (0.01 * m)), 0.0)
    z = rng.standard_normal(m)
    got = np.concatenate([sb[c] for c in sorted(sb)])
    for s, m_b, blk in zip(p.starts, p.sizes, p.flat_blocks()):
        rho = blk[0, 1]
        zz = z[s:s + m_b].copy()
        a = np.sqrt(1 - rho ** 2)
        zz[0] /= a
        from scipy.signal import lfilter
        eps = lfilter([1.0], [1.0, -rho], a * zz)
        want = blk @ beta[s:s + m_b] + eps / np.sqrt(350000.0)
        np.testing.assert_allclose(got[s:s + m_b], want, rtol=1e-10,
                                   atol=1e-14)
    assert all(np.all(v == 350000.0) for v in nn.values())


@pytest.mark.parametrize('quantize', [True, False])
@pytest.mark.parametrize('S', [1, 7])
def test_counts_match_the_kernel_bounds(quantize, S):
    import chip_smoke
    from viprs_tpu_torch.ops.block_ld import pack_dense_blocks
    p = pb_panel.make_panel({'m_target': 30_000, 'n_gwas': 350000,
                             'panel_seed': 2})
    packed, layout = pack_dense_blocks(p.blocks, block_size=256,
                                       quantize=quantize)
    ld = packed.to('cpu')
    c = work.Counts(p, quantize, 256)
    assert c.nb == ld.nb and c.n_off == ld.n_off > 0
    assert np.array_equal(c.diag_nz, ld.diag_nz.bool().numpy())
    assert np.array_equal(c.off_src, ld.off_src.long().numpy())
    assert np.array_equal(c.off_dst, ld.off_dst.long().numpy())
    assert np.array_equal(c.off_nz, ld.off_nz.bool().numpy())
    assert np.array_equal(c.off_nnz,
                          (ld.off_data != 0).sum(dim=(1, 2)).numpy())
    for planes in ((4, 5), (8, 9)):
        want = chip_smoke.sweep_work_nz(ld, S, *planes)[:2]
        got = c.sweep_work(S, *planes)
        assert [float(x) for x in got] == [float(x) for x in want]
    want = chip_smoke.coupling_work(ld, S)
    got = c.coupling_work(S)
    assert [float(x) for x in got] == [float(x) for x in want]


def test_estep_bound_counts_live_lanes():
    assert list(work.live_lanes([3, 1, 2])) == [3, 2, 1]
    p = pb_panel.make_panel({'m_target': 6000, 'n_gwas': 350000,
                             'panel_seed': 0})
    c = work.Counts(p, True, 256)
    peak = work.peaks('NVIDIA H100 80GB HBM3')
    one = work.estep_bound_s(c, [1], 4, 5, peak)
    two = work.estep_bound_s(c, [2], 4, 5, peak)
    assert two == pytest.approx(2 * one)
    assert work.peaks('no such card') is None
    torch.manual_seed(0)
