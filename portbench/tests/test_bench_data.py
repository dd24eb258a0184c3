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


def _dense_blocks(cfg):
    """The frozen generator's float64 blocks of ``cfg``'s panel, in order."""
    g, _, _ = pb_panel.synthesize_genome(m_target=cfg['m_target'],
                                         seed=cfg['panel_seed'])
    return [b for c in sorted(g) for b in g[c]]


def test_trait_is_r_beta_plus_ar1_noise():
    cfg = {'m_target': 8000, 'n_gwas': 350000, 'panel_seed': 1,
           'quantize': True}
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
    for s, m_b, blk in zip(p.starts, p.sizes, _dense_blocks(cfg)):
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
                             'panel_seed': 2, 'quantize': quantize})
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
                             'panel_seed': 0, 'quantize': True})
    c = work.Counts(p, True, 256)
    peak = work.peaks('NVIDIA H100 80GB HBM3')
    one = work.estep_bound_s(c, [1], 4, 5, peak)
    two = work.estep_bound_s(c, [2], 4, 5, peak)
    assert two == pytest.approx(2 * one)
    assert work.peaks('no such card') is None
    torch.manual_seed(0)


def _panel(cfg, quantize):
    return pb_panel.make_panel(dict(cfg, quantize=quantize))


@pytest.mark.parametrize('seed', [0, 3])
def test_panel_blocks_are_the_generators_stored_blocks(seed):
    from viprs_tpu_torch.ops.block_ld import quantize_int8
    cfg = {'m_target': 30_000, 'n_gwas': 350000, 'panel_seed': seed}
    dense = _dense_blocks(cfg)
    sizes = [b.shape[0] for b in dense]
    for quantize in (True, False):
        p = _panel(cfg, quantize)
        assert list(p.sizes) == sizes
        assert list(p.rho) == [b[0, 1] for b in dense]
        assert list(p.starts) == list(np.cumsum([0] + sizes[:-1]))
        assert p.m == sum(sizes) and len(p.chrom_of_block) == len(sizes)
        n = 0
        for got, blk in zip(p.flat_blocks(), dense):
            want = quantize_int8(blk) if quantize else blk.astype(np.float32)
            assert got.dtype == want.dtype and not got.flags.writeable
            assert np.array_equal(got, want)
            n += 1
        assert n == len(dense)


@pytest.mark.parametrize('block_size', [256, 1024])
@pytest.mark.parametrize('quantize', [True, False])
def test_panel_packs_as_the_generators_dense_blocks(quantize, block_size):
    from viprs_tpu_torch.ops.block_ld import pack_dense_blocks
    cfg = {'m_target': 30_000, 'n_gwas': 350000, 'panel_seed': 0}
    g, _, _ = pb_panel.synthesize_genome(m_target=30_000, seed=0)
    a, la = pack_dense_blocks(g, block_size=block_size, quantize=quantize)
    b, lb = pack_dense_blocks(_panel(cfg, quantize).blocks,
                              block_size=block_size, quantize=quantize)
    for k in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    assert a.scale == b.scale and len(a.off_src) > 0
    assert np.array_equal(la.flat_index, lb.flat_index)


@pytest.mark.parametrize('quantize', [True, False])
def test_reference_ld_is_the_generators_stored_blocks(quantize):
    from portbench.reference import RefLD
    cfg = {'m_target': 30_000, 'n_gwas': 350000, 'panel_seed': 0}
    p = _panel(cfg, quantize)
    ref = RefLD(p, quantize, 'cpu')
    for i, blk in enumerate(_dense_blocks(cfg)):
        want = torch.from_numpy(blk)
        want = torch.round(want * 127.0).clamp(-127, 127) * \
            float(np.float32(1 / 127)) if quantize else \
            want.to(torch.float32).to(torch.float64)
        assert torch.equal(ref.dense(i), want)
    with pytest.raises(ValueError):
        RefLD(p, not quantize, 'cpu')


def _config(name):
    import json
    import os
    with open(os.path.join(os.path.dirname(pb_panel.__file__), 'configs',
                           f'{name}.json')) as f:
        return json.load(f)


def test_the_18m_panel_is_made_without_a_block():
    import tracemalloc
    cfg = _config('eur18m_int8')
    assert cfg['quantize'] and cfg['density'] > 16
    tracemalloc.start()
    try:
        p = pb_panel.make_panel(cfg)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert p.m == 17_999_523 and len(p.sizes) == 1_639
    assert peak < 2 ** 30
    blk = p.blocks[1][0]
    assert blk.dtype == np.int8 and blk.shape == (p.sizes[0],) * 2


def test_packing_a_panel_holds_no_dense_copy():
    """Made and packed, a panel (int8, B = 256) takes at most the packed
    tiles, a second copy of the coupling tiles (the packer stacks its dict
    of them) and two of the largest block; its dense float64 blocks would
    take 8 sum(m_b^2) bytes more."""
    import tracemalloc
    from viprs_tpu_torch.ops.block_ld import pack_dense_blocks
    cfg = {'m_target': 200_000, 'n_gwas': 350000, 'panel_seed': 0}
    tracemalloc.start()
    try:
        p = _panel(cfg, True)
        packed, _ = pack_dense_blocks(p.blocks, block_size=256,
                                      quantize=True)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    largest = int(p.sizes.max())
    bound = packed.diag.nbytes + 2 * packed.off_data.nbytes \
        + 2 * largest ** 2
    assert peak < bound < 8 * int((p.sizes ** 2).sum())


@pytest.mark.parametrize('name', ['hm3_int8', 'hm3_f32'])
def test_the_benchmarked_configs_store_their_type(name):
    cfg = _config(name)
    assert 'density' not in cfg
    p = pb_panel.make_panel(dict(cfg, m_target=6000))
    want = np.int8 if cfg['quantize'] else np.float32
    assert all(b.dtype == want and not b.flags.writeable
               for b in p.flat_blocks())


def test_density_scales_the_regions_and_their_ld():
    """At density d the panel has about as many blocks at d times the
    variants, d times as wide, and rho ** (1 / d) for each block's rho, so
    that the stored band reaches about d times as far."""
    cfg = {'m_target': 100_000, 'n_gwas': 350000, 'panel_seed': 0,
           'quantize': True}
    one = pb_panel.make_panel(cfg)
    same = pb_panel.make_panel(dict(cfg, density=1.0))
    assert np.array_equal(one.sizes, same.sizes)
    assert np.array_equal(one.rho, same.rho)
    d = 8.0
    p = pb_panel.make_panel(dict(cfg, m_target=800_000, density=d))
    assert 0.8 < len(p.sizes) / len(one.sizes) < 1.25
    assert 0.7 * d < np.median(p.sizes) / np.median(one.sizes) < 1.4 * d
    assert p.sizes.min() >= 40 * d and p.sizes.max() <= 3500 * d
    assert np.all((p.rho >= 0.2 ** (1 / d)) & (p.rho <= 0.95 ** (1 / d)))
    reach = [work.band(r, int(m), True) for r, m in zip(p.rho, p.sizes)]
    reach1 = [work.band(r, int(m), True) for r, m in zip(one.rho, one.sizes)]
    assert 0.5 * d < np.median(reach) / np.median(reach1) < 2 * d
