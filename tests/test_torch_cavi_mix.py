"""The port's mixture sweeps (the plain versions of TPU kernels K5-K8)
against the JAX package's Pallas kernels, on the same bytes.

The problem is the one of tests/test_torch_cavi.py: five LD tiles of
B = 128 with four coupling tiles, packed as int8 and as float32 (every test
that takes it runs on both). The mixture state (K components), the
per-lane hyperparameters and q = (R - I) eta are made with numpy and handed
to both packages; the Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them. Each plain version is held to its own Pallas
kernel: K5/K7 take |R_jj| from the tile in the relaxation, K6/K8 the unit
diagonal of the variant mask, and only K7/K8 have a step scale.

Tolerances: atol 1e-5 on gamma, mu, eta and eta_diff and 1e-4 on q (as in
tests/test_torch_cavi_s.py). Frozen lanes and unflagged blocks must pass
through bit-exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.ops import cavi_jax, cavi_mix as jmix, cavi_pallas

from viprs_tpu_torch.model import _dispatch
from viprs_tpu_torch.ops import cavi_cuda, cavi_mix
from viprs_tpu_torch.ops.block_ld import BlockLD
from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.ops.block_ld import pack_dense_blocks

from test_torch_cavi import QUANTIZE, interpret, problem  # noqa: F401

ATOL = {'gamma': 1e-5, 'mu': 1e-5, 'eta': 1e-5, 'q': 1e-4, 'eta_diff': 1e-5}


def make_mix_state(p, S, K, seed=0):
    """A non-trivial numpy mixture state with q = (R - I) eta (from the JAX
    package): S lanes ((S, K, NB, B) / (S, NB, B), hyperparameters (S,) /
    (S, K)), or one model with ``S=None``."""
    rng = np.random.default_rng(seed)
    L = 1 if S is None else S
    shape = (L, K, p['nb'], p['mask'].shape[1])
    pis = np.geomspace(0.01, 0.05, L)[:, None] * np.linspace(1.0, 0.5, K)
    gamma = (pis[:, :, None, None]
             * np.exp(0.3 * rng.standard_normal(shape))).astype(np.float32)
    mu = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    eta = ((gamma * mu).sum(axis=1) * p['mask']).astype(np.float32)
    q = np.array(cavi_jax.compute_q(p['jld'], jnp.asarray(eta)))
    d = 2.0 ** np.linspace(-min(K - 1, 7), 0, K)
    hyper = dict(sigma_eps=np.linspace(0.6, 0.8, L).astype(np.float32),
                 tau_beta=(np.linspace(300., 900., L)[:, None] / d)
                 .astype(np.float32),
                 pi=pis.astype(np.float32),
                 lambda_min=np.zeros(L, np.float32))
    state = (gamma, mu, eta, q)
    if S is None:
        state = tuple(x[0] for x in state)
        hyper = {k: v[0] for k, v in hyper.items()}
    return state, hyper


def jax_args(p, st, hy):
    return (jmix.MixState(*(jnp.asarray(x) for x in st)),
            jnp.asarray(p['sb']), jnp.asarray(p['nf']),
            jmix.MixHyper(**{k: jnp.asarray(v) for k, v in hy.items()}))


def torch_args(p, st, hy):
    return (MixState.from_numpy(*st, device='cpu'),
            torch.from_numpy(p['sb']), torch.from_numpy(p['nf']),
            MixHyper.from_numpy(**hy, device='cpu'))


def assert_close(got, want):
    (gs, gd), (ws, wd) = got, want
    for k in MixState._fields:
        np.testing.assert_allclose(getattr(gs, k).numpy(),
                                   np.asarray(getattr(ws, k)), atol=ATOL[k],
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd),
                               atol=ATOL['eta_diff'], rtol=0,
                               err_msg='eta_diff')


def _half_mask(masks):
    """Of (mask at eps) for a range of gate epsilons, the one that flags
    closest to half of the blocks."""
    best = None
    for eps in np.geomspace(1e-8, 1.0, 49):
        blk = masks(float(eps))
        n = blk.size
        if best is None or abs(blk.sum() - n / 2) < abs(best.sum() - n / 2):
            best = blk
    assert 0 < best.sum() < best.size
    return best


@pytest.mark.parametrize('K', [1, 3])
def test_plain_k5_matches_pallas(problem, interpret, K):
    """cavi_sweep_mix_s1 on CPU tensors (the plain K5) against
    cavi_sweep_mixture_pallas and its coupling tiles."""
    st, hy = make_mix_state(problem, None, K, seed=K)
    got = cavi_cuda.cavi_sweep_mix_s1(problem['ld'],
                                      *torch_args(problem, st, hy))
    want = cavi_pallas.cavi_sweep_mixture_pallas.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy))
    assert_close(got, want)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


@pytest.fixture(scope='module', **QUANTIZE)
def zero_block_problem(request):
    """LD tiles of B = 256 (two (T, T) tiles a block), int8 or float32, in
    which a third of the 32 x 32 blocks off the diagonal are set to exact
    zeros, symmetrically: zero blocks inside the (T, T) tiles and outside
    them, the blocks that the kernels' rank-T updates skip
    (BlockLD.diag_nz)."""
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(300, 150, 100, 60),
                                   h2=0.3, prop_causal=0.05, seed=5)
    jld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=256,
                                 quantize=request.param)
    diag = np.array(jld.diag)
    nb, B, m = diag.shape[0], diag.shape[1], diag.shape[1] // 32
    for b in range(nb):
        for r in range(m):
            for c in range(m):
                if r != c and (r + c + b) % 3 == 0:
                    diag[b, 32 * r:32 * r + 32, 32 * c:32 * c + 32] = 0
    jld = dataclasses.replace(jld, diag=jnp.asarray(diag))
    sb = lay.to_flat(sim['std_beta']).reshape(lay.nb, B)
    nf = lay.to_flat(sim['n_per_snp']).reshape(lay.nb, B)
    ld = BlockLD.from_numpy(
        *(np.asarray(getattr(jld, f)) for f in
          ('diag', 'off_data', 'off_src', 'off_dst', 'mask')),
        jld.scale, device='cpu')
    return dict(jld=jld, ld=ld, nb=lay.nb, sb=sb, nf=nf,
                mask=np.asarray(jld.mask))


@pytest.mark.parametrize('kernel', ['K5', 'K6'])
def test_plain_k5_k6_match_pallas_with_zero_blocks(zero_block_problem,
                                                   interpret, kernel):
    """The plain K5 and K6 (cavi_mix.mix_block_sweep through
    cavi_sweep_mix_s1 / _skip) against the Pallas kernels in interpret mode
    on diagonal tiles whose zero 32 x 32 blocks lie inside and outside the
    (T, T) tiles, at test_plain_k5_matches_pallas's tolerances."""
    p = zero_block_problem
    nz = p['ld'].diag_nz.bool()
    m = nz.shape[1]
    in_tile = (np.arange(m)[:, None] // 4) == (np.arange(m)[None] // 4)
    in_tile = torch.from_numpy(in_tile)
    assert (~nz & in_tile).any() and (~nz & ~in_tile).any()
    assert (nz & ~in_tile).any()
    st, hy = make_mix_state(p, None, 3, seed=33)
    state, sb, nf, hyper = torch_args(p, st, hy)
    if kernel == 'K5':
        got = cavi_cuda.cavi_sweep_mix_s1(p['ld'], state, sb, nf, hyper)
        want = cavi_pallas.cavi_sweep_mixture_pallas.__wrapped__(
            p['jld'], *jax_args(p, st, hy))
    else:
        blk = np.ones(p['nb'], bool)
        blk[1::3] = False
        got = cavi_cuda.cavi_sweep_mix_s1_skip(p['ld'], state, sb, nf, hyper,
                                               torch.from_numpy(blk))
        want = cavi_pallas.cavi_sweep_mixture_pallas_skip.__wrapped__(
            p['jld'], *jax_args(p, st, hy), jnp.asarray(blk))
    assert_close(got, want)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize('K', [1, 3])
@pytest.mark.parametrize('which', ['half', 'none'])
def test_plain_k6_matches_pallas_skip(problem, interpret, K, which):
    """cavi_sweep_mix_s1_skip (the plain K6) against
    cavi_sweep_mixture_pallas_skip with about half of the blocks flagged by
    the proposal mask, and with none flagged: unflagged blocks pass through
    bit-exactly."""
    st, hy = make_mix_state(problem, None, K, seed=10 + K)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    if which == 'none':
        blk = np.zeros(problem['nb'], bool)
    else:
        blk = _half_mask(lambda eps: cavi_mix.mix_block_proposal_mask(
            problem['ld'], state, sb, nf, hyper, eps=eps).numpy())
    got = cavi_cuda.cavi_sweep_mix_s1_skip(problem['ld'], state, sb, nf,
                                           hyper, torch.from_numpy(blk))
    want = cavi_pallas.cavi_sweep_mixture_pallas_skip.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.asarray(blk))
    assert_close(got, want)
    off = ~blk
    for k, x in zip(('gamma', 'mu'), st[:2]):
        np.testing.assert_array_equal(getattr(got[0], k).numpy()[:, off],
                                      x[:, off], err_msg=k)
    np.testing.assert_array_equal(got[0].eta.numpy()[off], st[2][off])
    np.testing.assert_array_equal(got[1].numpy()[off], 0.0)
    if which == 'none':
        for a, x in zip(got[0], st):
            np.testing.assert_array_equal(a.numpy(), x)


def _active(S):
    act = np.ones(S, np.float32)
    act[1::2] = 0.0               # every other lane frozen
    if S > 2:
        act[2] = 0.5              # a damped lane
    return act


@pytest.mark.parametrize('K', [1, 3])
@pytest.mark.parametrize('S', [2, 9])
def test_plain_k7_matches_pallas_batch(problem, interpret, K, S):
    """cavi_sweep_mix_s (the plain K7) against
    cavi_sweep_mixture_pallas_batch with every other lane frozen: frozen
    lanes pass through bit-exactly."""
    st, hy = make_mix_state(problem, S, K, seed=20 + S + K)
    act = _active(S)
    got = cavi_cuda.cavi_sweep_mix_s(problem['ld'],
                                     *torch_args(problem, st, hy),
                                     torch.from_numpy(act))
    want = cavi_pallas.cavi_sweep_mixture_pallas_batch.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.asarray(act))
    assert_close(got, want)
    off = act == 0
    for k, x in zip(MixState._fields, st):
        np.testing.assert_array_equal(getattr(got[0], k).numpy()[off],
                                      x[off], err_msg=k)
    np.testing.assert_array_equal(got[1].numpy()[off], 0.0)


@pytest.mark.parametrize('K', [1, 3])
def test_plain_k8_matches_pallas_skip_batch(problem, interpret, K):
    """cavi_sweep_mix_s_skip (the plain K8) against
    cavi_sweep_mixture_pallas_skip_batch at S = 9 with the union over the
    live lanes of the proposal masks at about half of the blocks."""
    S = 9
    st, hy = make_mix_state(problem, S, K, seed=40 + K)
    act = _active(S)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    live = torch.from_numpy(act) > 0
    blk = _half_mask(lambda eps: (cavi_mix.mix_block_proposal_mask_batch(
        problem['ld'], state, sb, nf, hyper, eps=eps) & live[:, None])
        .any(dim=0).numpy())
    got = cavi_cuda.cavi_sweep_mix_s_skip(problem['ld'], state, sb, nf,
                                          hyper, torch.from_numpy(act),
                                          torch.from_numpy(blk))
    want = cavi_pallas.cavi_sweep_mixture_pallas_skip_batch.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.asarray(act),
        jnp.asarray(blk))
    assert_close(got, want)
    off = act == 0
    for k, x in zip(MixState._fields, st):
        np.testing.assert_array_equal(getattr(got[0], k).numpy()[off],
                                      x[off], err_msg=k)
    for k, x in zip(('gamma', 'mu'), st[:2]):
        np.testing.assert_array_equal(getattr(got[0], k).numpy()[:, :, ~blk],
                                      x[:, :, ~blk], err_msg=k)
    np.testing.assert_array_equal(got[0].eta.numpy()[:, ~blk],
                                  st[2][:, ~blk])
    np.testing.assert_array_equal(got[1].numpy()[:, ~blk], 0.0)


@pytest.mark.parametrize('K', [1, 3])
def test_proposal_masks_match_jax(problem, K):
    """mix_block_proposal_mask and its lane-batched version against the JAX
    package's (cavi_pallas.py:1439-1459, :1567-1590), on a swept state
    where the blocks' proposals differ."""
    S = 4
    st, hy = make_mix_state(problem, S, K, seed=50 + K)
    jst, jsb, jnf, jhy = jax_args(problem, st, hy)
    for _ in range(4):
        jst, _ = jmix.cavi_sweep_mixture_batch(problem['jld'], jst, jsb, jnf,
                                               jhy, jnp.ones(S))
    state = MixState.from_numpy(*(np.asarray(x) for x in jst), device='cpu')
    _, sb, nf, hyper = torch_args(problem, st, hy)
    seen = set()
    for eps in np.geomspace(1e-8, 1e-1, 15):
        got = cavi_mix.mix_block_proposal_mask_batch(problem['ld'], state, sb,
                                                     nf, hyper, eps=eps)
        want = cavi_pallas.mix_block_proposal_mask_batch(
            problem['jld'], jst, jsb, jnf, jhy, eps=eps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seen.add(tuple(got.numpy().ravel()))
        one = cavi_mix.mix_block_proposal_mask(
            problem['ld'], MixState(*(x[1] for x in state)), sb, nf,
            MixHyper(*(x[1] for x in hyper)), eps=eps)
        jone = cavi_pallas.mix_block_proposal_mask(
            problem['jld'], jmix.MixState(*(x[1] for x in jst)), jsb, jnf,
            jmix.MixHyper(*(x[1] for x in jhy)), eps=eps)
        np.testing.assert_array_equal(one.numpy(), np.asarray(jone))
    assert len(seen) > 2


@pytest.mark.parametrize('K', [1, 3])
def test_mix_stats_and_var_tau_match_jax(problem, K):
    """mix_var_tau and mix_stats (float32 terms and sums over B, float64
    across blocks) against the JAX package's, for one model and for S
    lanes (the JAX batch loop vmaps mix_stats over the lanes)."""
    S = 3
    st, hy = make_mix_state(problem, S, K, seed=60 + K)
    jst, jsb, _, jhy = jax_args(problem, st, hy)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    jn = jnp.asarray(problem['nf'])
    mask = problem['ld'].mask
    jvt = jax.vmap(lambda h: jmix.mix_var_tau(jn, h))(jhy)
    vt = cavi_mix.mix_var_tau(nf, hyper)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=1e-6)
    want = jax.vmap(lambda g, m, e, q, v: jmix.mix_stats(
        jmix.MixState(g, m, e, q), v, jsb, problem['jld'].mask))(*jst, jvt)
    got = cavi_mix.mix_stats(state, vt, sb, mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert got[k].dtype == torch.float64
    one = cavi_mix.mix_stats(MixState(*(x[0] for x in state)), vt[0], sb,
                             mask)
    jone = jmix.mix_stats(jmix.MixState(*(x[0] for x in jst)), jvt[0], jsb,
                          problem['jld'].mask)
    for k in jone:
        np.testing.assert_allclose(one[k].numpy(), np.asarray(jone[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the initial residual q = (R - I) eta of one model
    np.testing.assert_allclose(
        cavi_mix.compute_q_mix(problem['ld'], state.eta[0]).numpy(),
        np.asarray(jmix.compute_q_mix(problem['jld'], jst[2][0])),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize('grid,impl,expect', [
    (False, None, True), (False, 'skip', True), (False, 'xla', False),
    (False, 'pallas', False), (True, None, False), (True, 'xla', False),
    (True, 'pallas', False), (True, 'skip', True),
    (False, 'hybrid', ValueError), (True, 'hybrid', ValueError),
    (False, 'triton', ValueError)])
def test_select_mix_sweep_impl_decision_table(grid, impl, expect):
    """VIPRSMix: the skip sweep K6 by default, K5 for 'xla'/'pallas';
    VIPRSMixGrid: the lane sweep K7 by default, K8 for 'skip'; 'hybrid'
    raises for both."""
    if expect is ValueError:
        with pytest.raises(ValueError):
            _dispatch.select_mix_sweep_impl(impl, grid=grid)
    else:
        assert _dispatch.select_mix_sweep_impl(impl, grid=grid) is expect


def test_mix_wrappers_never_take_the_plain_version_off_cpu(monkeypatch,
                                                         tmp_path):
    """A tensor that is not on the CPU goes to the mixture kernels or
    raises: with the CUDA toolkit made unavailable, the build raises."""
    from viprs_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found (made unavailable by the test)")

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    _build.build.cache_clear()
    ld = BlockLD.from_numpy(np.zeros((2, 128, 128), np.int8),
                            np.zeros((1, 128, 128), np.int8), [0], [1],
                            np.ones((2, 128), np.float32), 1 / 127,
                            device='meta')
    K, S = 3, 4
    z = torch.zeros(2, 128, device='meta')
    one = MixState(torch.zeros(K, 2, 128, device='meta'),
                   torch.zeros(K, 2, 128, device='meta'), z, z)
    lanes = MixState(*(x.expand(S, *x.shape) for x in one))
    s = torch.ones((), device='meta')
    v = torch.ones(K, device='meta')
    h1 = MixHyper(s, v, v, s)
    hs = MixHyper(*(x.expand(S, *x.shape) for x in h1))
    act = torch.ones(S, device='meta')
    blk = torch.ones(2, dtype=torch.int32, device='meta')
    try:
        for call in (
                lambda: cavi_cuda.cavi_sweep_mix_s1(ld, one, z, z, h1),
                lambda: cavi_cuda.cavi_sweep_mix_s1_skip(ld, one, z, z, h1,
                                                         blk),
                lambda: cavi_cuda.cavi_sweep_mix_s(ld, lanes, z, z, hs, act),
                lambda: cavi_cuda.cavi_sweep_mix_s_skip(ld, lanes, z, z, hs,
                                                        act, blk)):
            with pytest.raises(RuntimeError, match='nvcc'):
                call()
    finally:
        _build.build.cache_clear()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_mix_sweep_lane_tile_matches_enumeration():
    """The lane tile of cavi_block_sweep_mix_s by S and K: of the instances
    that hold K (4 lanes every K, 8 and 20 lanes K <= 3), the smallest that
    holds S, else the largest with ceil(S / L) lane tiles; every lane is
    covered exactly once."""
    assert cavi_cuda.MIX_SWEEP_LANE_TILES == {4: 8, 8: 3, 20: 3}
    for K in range(1, 9):
        tiles = (4, 8, 20) if K <= 3 else (4,)
        for S in range(1, 260):
            want = min([L for L in tiles if L >= S] or [max(tiles)])
            L = cavi_cuda.mix_sweep_lane_tile(S, K)
            assert L == want, (S, K)
            n_tiles = -(-S // L)
            assert (n_tiles - 1) * L < S <= n_tiles * L
    assert [cavi_cuda.mix_sweep_lane_tile(S, 3) for S in (4, 5, 8, 9, 20, 21)] \
        == [4, 8, 8, 20, 20, 20]
    assert cavi_cuda.mix_sweep_lane_tile(20, 8) == 4


@pytest.mark.parametrize('bad', [None, 'shape', 'dtype', 'layout'])
def test_block_sweep_mix_checks_diag_nz_before_launching(monkeypatch, bad):
    """Off the CPU, both branches of block_sweep_mix, the lanes (K7/K8) and
    the single model (K5/K6), check BlockLD.diag_nz (dtype, shape,
    contiguity) before they launch, and hand the kernel the flags, the
    inner steps, the unit diagonal and (lanes) the lane tile picked by S and
    K (a stand-in library records the launches; meta tensors take the place
    of the card's)."""
    from viprs_tpu_torch.ops import _build
    calls = {'s': [], 's1': []}

    class Lib:
        def cavi_block_sweep_mix_s_launch(self, *args):
            calls['s'].append(args)
            return 0

        def cavi_block_sweep_mix_s1_launch(self, *args):
            calls['s1'].append(args)
            return 0

    monkeypatch.setattr(_build, 'build', lambda: (Lib(), {}))
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: type('Stream', (), {'cuda_stream': 0}))
    for name in ('cavi_sweep_mix_s', 'cavi_sweep_mix_s1'):
        monkeypatch.setitem(cavi_cuda.LAUNCHES, name, 0)
    nb, B = 2, 256
    ld = BlockLD.from_numpy(np.zeros((nb, B, B), np.int8),
                            np.zeros((0, B, B), np.int8), [], [],
                            np.ones((nb, B), np.float32), 1 / 127,
                            device='meta')
    assert ld.diag_nz.shape == (nb, 8, 8) and ld.diag_nz.dtype == torch.uint8
    nz = {'shape': torch.ones(nb, 4, 4, dtype=torch.uint8, device='meta'),
          'dtype': torch.ones(nb, 8, 8, dtype=torch.int32, device='meta'),
          'layout': torch.ones(nb, 8, 8, dtype=torch.uint8,
                               device='meta').transpose(1, 2)}
    if bad is not None:
        ld = dataclasses.replace(ld, diag_nz=nz[bad])
    z = torch.zeros(nb, B, device='meta')
    blk = torch.ones(nb, dtype=torch.int32, device='meta')

    def args(S, K):
        zk = torch.zeros(S, K, nb, B, device='meta')
        zs = torch.zeros(S, nb, B, device='meta')
        s = torch.ones(S, device='meta')
        sk = torch.ones(S, K, device='meta')
        return ld, MixState(zk, zk, zs, zs), z, z, MixHyper(s, sk, sk, s)

    for S, K, steps in ((9, 3, 3), (20, 5, cavi_cuda.INNER_STEPS)):
        act = torch.ones(S, device='meta')
        if bad is None:
            out, eta_diff = cavi_cuda.block_sweep_mix(
                *args(S, K), act, blk, True, 'cavi_sweep_mix_s',
                inner_steps=steps)
            assert eta_diff.shape == (S, nb, B)
            L = calls['s'][-1][-2]
            assert L == cavi_cuda.mix_sweep_lane_tile(S, K) == \
                (20 if K == 3 else 4)
            assert calls['s'][-1][-4] == steps
        else:
            with pytest.raises(ValueError, match='diag_nz'):
                cavi_cuda.block_sweep_mix(*args(S, K), act, blk, True,
                                          'cavi_sweep_mix_s')
    assert len(calls['s']) == cavi_cuda.LAUNCHES['cavi_sweep_mix_s'] == \
        (2 if bad is None else 0)
    # the single model: diag, diag_nz and 14 more pointers, then K, nb, B,
    # scale, inner steps, unit diagonal and the stream
    for K, steps, unit_diag in ((3, 0, False), (8, cavi_cuda.INNER_STEPS,
                                                True)):
        if bad is None:
            out, eta_diff = cavi_cuda.block_sweep_mix(
                *args(1, K), None, blk, unit_diag, 'cavi_sweep_mix_s1',
                inner_steps=steps)
            assert eta_diff.shape == (1, nb, B)
            assert len(calls['s1'][-1]) == 16 + 7
            assert calls['s1'][-1][16:-1] == (
                K, nb, B, float(np.float32(1 / 127)), steps, int(unit_diag))
        else:
            with pytest.raises(ValueError, match='diag_nz'):
                cavi_cuda.block_sweep_mix(*args(1, K), None, blk, unit_diag,
                                          'cavi_sweep_mix_s1',
                                          inner_steps=steps)
    assert len(calls['s1']) == cavi_cuda.LAUNCHES['cavi_sweep_mix_s1'] == \
        (2 if bad is None else 0)


@pytest.mark.parametrize('lanes', [False, True])
def test_block_sweep_mix_takes_the_inner_steps_probe_on_the_card_only(
        problem, lanes):
    """Fewer inner steps are a timing probe of the kernels; the plain
    version on the CPU runs INNER_STEPS and refuses any other count."""
    S, K = (3, 3) if lanes else (1, 2)
    st, hy = make_mix_state(problem, S, K, seed=70 + S)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    blk = torch.ones(problem['nb'], dtype=torch.int32)
    act = torch.ones(S) if lanes else None
    with pytest.raises(ValueError, match='inner steps'):
        cavi_cuda.block_sweep_mix(problem['ld'], state, sb, nf, hyper, act,
                                  blk, False, 'cavi_sweep_mix_s',
                                  inner_steps=0)
    got = cavi_cuda.block_sweep_mix(problem['ld'], state, sb, nf, hyper, act,
                                    blk, False, 'cavi_sweep_mix_s',
                                    inner_steps=cavi_mix.INNER_STEPS)
    want = cavi_mix.mix_block_sweep(problem['ld'], state, sb, nf, hyper, act,
                                    blk_mask=blk)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_single_model_mix_sweeps_launch_their_float32_instance(monkeypatch):
    """Float32 LD tiles take the float32 instance of the single-model
    mixture sweep (cavi_block_sweep_mix_s1_f32_launch) with scale 1.0 and
    the float32 coupling pass, through K5 and K6, each counted under its
    name with _f32 appended (a stand-in library records the launches; meta
    tensors take the place of the card's)."""
    from viprs_tpu_torch.ops import _build
    calls = {}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.setdefault(name, []).append(args)
                return 0
            return launch

    monkeypatch.setattr(_build, 'build', lambda: (Lib(), {}))
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: type('Stream', (), {'cuda_stream': 0}))
    for name in cavi_cuda.LAUNCHES:
        monkeypatch.setitem(cavi_cuda.LAUNCHES, name, 0)
    nb, B, K = 2, 256, 3
    ld = BlockLD.from_numpy(np.zeros((nb, B, B), np.float32),
                            np.ones((1, B, B), np.float32), [0], [1],
                            np.ones((nb, B), np.float32), 1.0, device='meta')
    zk = torch.zeros(K, nb, B, device='meta')
    z = torch.zeros(nb, B, device='meta')
    one = MixState(zk, zk, z, z)
    h1 = MixHyper(torch.ones((), device='meta'), torch.ones(K, device='meta'),
                  torch.ones(K, device='meta'), torch.zeros((), device='meta'))
    blk = torch.ones(nb, dtype=torch.int32, device='meta')
    cavi_cuda.cavi_sweep_mix_s1(ld, one, z, z, h1)
    cavi_cuda.cavi_sweep_mix_s1_skip(ld, one, z, z, h1, blk)
    assert set(calls) == {'cavi_block_sweep_mix_s1_f32_launch',
                          'coupling_pass_s1_f32_launch'}
    # K, nb, B, scale, inner steps, unit diagonal
    assert [a[16:-1] for a in calls['cavi_block_sweep_mix_s1_f32_launch']] \
        == [(K, nb, B, 1.0, cavi_cuda.INNER_STEPS, 0),
            (K, nb, B, 1.0, cavi_cuda.INNER_STEPS, 1)]
    assert {k: v for k, v in cavi_cuda.LAUNCHES.items() if v} == {
        'cavi_sweep_mix_s1_f32': 1, 'cavi_sweep_mix_s1_skip_f32': 1,
        'coupling_pass_s1_f32': 2}
