"""The port's CAVI sweeps against the JAX package's, on the same bytes.

The problem has five LD tiles of B = 128 with four coupling tiles (one LD
block of 300 variants spans three tiles); its LD, state and
hyperparameters are made once with numpy and handed to both packages. Each
problem is packed twice, int8 (quantize=True) and float32 (quantize=False,
the JAX package's default), and every test that takes it runs on both.

Tolerances: atol 1e-5 on eta, mu and gamma and 1e-4 on q, because exp,
log and the order of float32 sums differ between XLA and PyTorch (the same
bounds the JAX package holds its Pallas kernels to, tests/test_pallas.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.ops import cavi_jax, cavi_pallas
from viprs_tpu.ops.block_ld import pack_dense_blocks

from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
from viprs_tpu_torch.ops.block_ld import BlockLD
from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

ATOL = {'eta': 1e-5, 'mu': 1e-5, 'gamma': 1e-5, 'q': 1e-4, 'eta_diff': 1e-5}


#: The problems' two packings: int8 and float32 LD tiles.
QUANTIZE = dict(params=[True, False], ids=['int8', 'float32'])


@pytest.fixture(scope='module', **QUANTIZE)
def problem(request):
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(300, 150, 100, 60),
                                   h2=0.3, prop_causal=0.05, seed=5)
    jld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                 quantize=request.param)
    assert jld.n_off > 0
    assert jld.diag.dtype == (jnp.int8 if request.param else jnp.float32)
    sb = lay.to_flat(sim['std_beta']).reshape(lay.nb, 128)
    nf = lay.to_flat(sim['n_per_snp']).reshape(lay.nb, 128)
    ld = BlockLD.from_numpy(
        *(np.asarray(getattr(jld, f)) for f in
          ('diag', 'off_data', 'off_src', 'off_dst', 'mask')),
        jld.scale, device='cpu')
    return dict(jld=jld, ld=ld, nb=lay.nb, sb=sb, nf=nf,
                mask=np.asarray(jld.mask))


def make_state(p, S, seed=0):
    """A non-trivial numpy state (S, NB, B) with q = (R - I) eta (from the
    JAX package) and per-lane hyperparameters."""
    rng = np.random.default_rng(seed)
    shape = (S, p['nb'], 128)
    pis = np.geomspace(0.02, 0.1, S)
    logits = (np.log(pis / (1 - pis))[:, None, None]
              + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    mu = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    eta = (1 / (1 + np.exp(-logits)) * mu * p['mask']).astype(np.float32)
    q = np.array(cavi_jax.compute_q(p['jld'], jnp.asarray(eta)))
    hyper = dict(sigma_eps=np.linspace(0.6, 0.8, S).astype(np.float32),
                 tau_beta=np.linspace(500., 900., S).astype(np.float32),
                 pi=pis.astype(np.float32),
                 lambda_min=np.zeros(S, np.float32))
    return (logits, mu, eta, q), hyper


def jax_args(p, st, hy):
    return (cavi_jax.CaviState(*(jnp.asarray(x) for x in st)),
            jnp.asarray(p['sb']), jnp.asarray(p['nf']),
            cavi_jax.Hyper(**{k: jnp.asarray(v) for k, v in hy.items()}))


def torch_args(p, st, hy):
    return (CaviState.from_numpy(*st, device='cpu'),
            torch.from_numpy(p['sb']), torch.from_numpy(p['nf']),
            Hyper.from_numpy(**hy, device='cpu'))


def assert_close(got, want, names=('eta', 'mu', 'gamma', 'q')):
    (gs, gd), (ws, wd) = got, want
    for k in names:
        if k == 'gamma':
            a, b = torch.sigmoid(gs.logits).numpy(), jax.nn.sigmoid(ws.logits)
        else:
            a, b = getattr(gs, k).numpy(), getattr(ws, k)
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL[k], rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=ATOL['eta'],
                               rtol=0, err_msg='eta_diff')


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU
    (as tests/test_pallas.py does)."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)
    monkeypatch.setattr(pl, 'pallas_call', interp_call)


def test_compute_q_and_refresh_q(problem):
    st, _ = make_state(problem, 2)
    eta = torch.from_numpy(st[2])
    q = cavi_torch.compute_q(problem['ld'], eta)
    np.testing.assert_allclose(q.numpy(), st[3], atol=1e-5, rtol=0)

    rng = np.random.default_rng(1)
    diff = (1e-2 * rng.standard_normal(st[2].shape) * problem['mask']
            ).astype(np.float32)
    got = cavi_torch.refresh_q(problem['ld'], torch.from_numpy(st[3]),
                               torch.from_numpy(diff))
    want = cavi_jax.refresh_q(problem['jld'], jnp.asarray(st[3]),
                              jnp.asarray(diff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('S', [1, 4])
@pytest.mark.parametrize('relax', [True, False])
def test_cavi_sweep_matches_jax(problem, S, relax):
    st, hy = make_state(problem, S, seed=S)
    active = np.ones(S, np.float32)
    if S == 4:
        active[1], active[2] = 0.0, 0.5      # a frozen and a damped lane
    state, sb, nf, hyper = torch_args(problem, st, hy)
    got = cavi_torch.cavi_sweep(problem['ld'], state, sb, nf, hyper,
                                torch.from_numpy(active), relax=relax)
    want = cavi_jax.cavi_sweep(problem['jld'], *jax_args(problem, st, hy),
                               jnp.asarray(active), relax=relax)
    assert_close(got, want)
    if S == 4:
        for k in ('logits', 'mu', 'eta'):
            assert torch.equal(getattr(got[0], k)[1], getattr(state, k)[1])


def test_plain_k1_matches_pallas_s1(problem, interpret):
    """The CPU path of cavi_sweep_s1 (the plain version of kernel K1)
    against cavi_sweep_pallas_s1 in interpret mode."""
    st, hy = make_state(problem, 1, seed=11)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    got = cavi_cuda.cavi_sweep_s1(problem['ld'], state, sb, nf, hyper,
                                  torch.ones(1))
    want = cavi_pallas.cavi_sweep_pallas_s1.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.ones(1), chunk=2)
    assert_close(got, want)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize('which', ['all', 'half', 'none'])
def test_plain_k2_matches_pallas_skip(problem, interpret, which):
    """The CPU path of cavi_sweep_s1_skip (plain K2) against
    cavi_sweep_pallas_s1_skip in interpret mode; unflagged blocks pass
    through bit-exactly."""
    nb = problem['nb']
    blk = {'all': np.ones(nb, bool), 'none': np.zeros(nb, bool),
           'half': np.arange(nb) % 2 == 0}[which]
    st, hy = make_state(problem, 1, seed=12)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    got = cavi_cuda.cavi_sweep_s1_skip(problem['ld'], state, sb, nf, hyper,
                                       torch.ones(1), torch.from_numpy(blk))
    want = cavi_pallas.cavi_sweep_pallas_s1_skip.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.ones(1),
        jnp.asarray(blk), chunk=2)
    assert_close(got, want)
    for k in ('logits', 'mu', 'eta'):
        np.testing.assert_array_equal(getattr(got[0], k).numpy()[0][~blk],
                                      st[CaviState._fields.index(k)][0][~blk])
    np.testing.assert_array_equal(got[1].numpy()[0][~blk], 0.0)
    if which == 'none':
        np.testing.assert_array_equal(got[0].q.numpy(), st[3])
    if which == 'all':
        full = cavi_torch.cavi_sweep(problem['ld'], state, sb, nf, hyper,
                                     torch.ones(1))
        for a, b in zip(got[0], full[0]):
            assert torch.equal(a, b)


def test_block_proposal_mask_matches_jax(problem):
    """Equal to the JAX mask at both gate epsilons, on a state where some
    blocks have quiesced and some have not."""
    st, hy = make_state(problem, 1, seed=3)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    jstate, jsb, jnf, jhyper = jax_args(problem, st, hy)
    for _ in range(40):
        jstate, _ = cavi_jax.cavi_sweep(problem['jld'], jstate, jsb, jnf,
                                        jhyper, jnp.ones(1))
    state = CaviState.from_numpy(*(np.asarray(x) for x in jstate),
                                 device='cpu')
    seen = set()
    for eps in (cavi_torch.ETA_DIFF_EPS, 1e-6, 1e-4):
        got = cavi_cuda.block_proposal_mask(problem['ld'], state, sb, nf,
                                            hyper, eps=eps)
        want = cavi_pallas.block_proposal_mask(problem['jld'], jstate, jsb,
                                               jnf, jhyper, eps=eps)
        assert got.shape == (1, problem['nb']) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seen.add(int(got.sum()))
    assert len(seen) > 1        # the gate separates blocks at some eps


@pytest.mark.parametrize('mask', ['all', 'one', 'none'])
def test_coupling_pass_s1_leaves_its_input_untouched_on_cpu(problem, mask):
    """coupling_pass_s1 returns a new q and never writes its input (the CPU
    takes the plain version; the card runs the kernel in place on a clone),
    and equals the plain coupling restriction and, with every block
    flagged, the JAX package's refresh_q."""
    nb = problem['nb']
    st, _ = make_state(problem, 1, seed=21)
    rng = np.random.default_rng(22)
    diff = (1e-2 * rng.standard_normal(st[2].shape) * problem['mask']
            ).astype(np.float32)
    blk = {'all': np.ones(nb, np.int32), 'none': np.zeros(nb, np.int32),
           'one': np.eye(nb, dtype=np.int32)[int(problem['ld'].off_src[0])]
           }[mask]
    q = torch.from_numpy(st[3].copy())
    got = cavi_cuda.coupling_pass_s1(problem['ld'], q, torch.from_numpy(diff),
                                     torch.from_numpy(blk))
    np.testing.assert_array_equal(q.numpy(), st[3])
    want = cavi_torch.coupling_pass(problem['ld'], torch.from_numpy(st[3]),
                                    torch.from_numpy(diff),
                                    torch.from_numpy(blk))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if mask == 'all':
        assert got is not q
        np.testing.assert_allclose(
            got.numpy(), np.asarray(cavi_jax.refresh_q(
                problem['jld'], jnp.asarray(st[3]), jnp.asarray(diff))),
            atol=1e-5, rtol=0)
    if mask == 'none':
        np.testing.assert_array_equal(got.numpy(), st[3])
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_coupling_pass_s1_inplace_refuses_cpu_tensors(problem):
    """The in-place launcher is the kernel's alone: CPU tensors raise (the
    plain version is coupling_pass_s1's), and q is left as it was."""
    st, _ = make_state(problem, 1, seed=23)
    q = torch.from_numpy(st[3].copy())
    with pytest.raises(ValueError, match='card'):
        cavi_cuda.coupling_pass_s1_inplace(
            problem['ld'], q, torch.zeros_like(q),
            torch.ones(problem['nb'], dtype=torch.int32))
    np.testing.assert_array_equal(q.numpy(), st[3])
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def _stand_in_lib(monkeypatch, calls):
    """A stand-in for the kernel library that records each launch's
    arguments (per launcher name) and reports success; the current stream
    of a meta device is a dummy."""
    from viprs_tpu_torch.ops import _build

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


def _meta_ld(nb, B, n_off, dtype=np.int8):
    """An LD of int8 (or ``dtype``) tiles on the meta device (the card's
    stand-in) with n_off coupling tiles between consecutive blocks; the
    scale is 1/127 for int8 and 1.0 for float tiles, as the packers make
    it."""
    return BlockLD.from_numpy(
        np.zeros((nb, B, B), dtype), np.ones((n_off, B, B), dtype),
        np.arange(n_off), np.arange(n_off) + 1, np.ones((nb, B), np.float32),
        1 / 127 if dtype == np.int8 else 1.0, device='meta')


@pytest.mark.parametrize('bad', [None, 'off_nz shape', 'off_nz dtype',
                                 'off_nz layout', 'cpl_slabs dtype',
                                 'cpl_slabs layout'])
def test_coupling_pass_s1_checks_off_nz_and_slabs_before_launching(
        monkeypatch, bad):
    """Off the CPU, coupling_pass_s1 checks BlockLD.off_nz (dtype, shape,
    contiguity) and BlockLD.cpl_slabs (dtype, contiguity) before it
    launches, and hands the kernel the flags, the slab list and its length;
    the in-place form returns q itself, the public form a clone (a stand-in
    library records the launches; meta tensors take the place of the
    card's)."""
    calls = {}
    _stand_in_lib(monkeypatch, calls)
    nb, B, n_off = 3, 256, 2
    ld = _meta_ld(nb, B, n_off)
    assert ld.off_nz.shape == (n_off, 8, 8)
    assert ld.off_nz.dtype == torch.uint8
    assert ld.cpl_slabs.dtype == torch.int32
    n_slabs = ld.cpl_slabs.numel()
    assert n_slabs == nb * B // 128        # every slab: the tiles are dense
    wrong = {
        'off_nz shape': dict(off_nz=torch.ones(n_off, 4, 4, dtype=torch.uint8,
                                               device='meta')),
        'off_nz dtype': dict(off_nz=torch.ones(n_off, 8, 8, dtype=torch.int32,
                                               device='meta')),
        'off_nz layout': dict(off_nz=torch.ones(
            n_off, 8, 8, dtype=torch.uint8, device='meta').transpose(1, 2)),
        'cpl_slabs dtype': dict(cpl_slabs=ld.cpl_slabs.long()),
        'cpl_slabs layout': dict(cpl_slabs=torch.zeros(
            2 * n_slabs, dtype=torch.int32, device='meta')[::2]),
    }
    if bad is not None:
        ld = dataclasses.replace(ld, **wrong[bad])
    q = torch.zeros(1, nb, B, device='meta')
    blk = torch.ones(nb, dtype=torch.int32, device='meta')
    if bad is None:
        assert cavi_cuda.coupling_pass_s1_inplace(ld, q, q, blk) is q
        out = cavi_cuda.coupling_pass_s1(ld, q, q, blk)
        assert out is not q and out.shape == q.shape
        args = calls['coupling_pass_s1_launch']
        assert len(args) == cavi_cuda.LAUNCHES['coupling_pass_s1'] == 2
        # off, src, dst, inc_ptr, inc_tile, blk_mask, off_nz, slabs,
        # eta_diff, q, then n_slabs, nb, B, scale and the stream
        assert len(args[0]) == 10 + 5
        assert args[0][10:-1] == (n_slabs, nb, B, float(np.float32(1 / 127)))
    else:
        name = bad.split()[0]
        with pytest.raises(ValueError, match=name):
            cavi_cuda.coupling_pass_s1_inplace(ld, q, q, blk)
        with pytest.raises(ValueError, match=name):
            cavi_cuda.coupling_pass_s1(ld, q, q, blk)
        assert not calls
        assert cavi_cuda.LAUNCHES['coupling_pass_s1'] == 0


@pytest.fixture(scope='module', **QUANTIZE)
def zero_block_problem(request):
    """LD tiles of B = 256 (two (T, T) tiles a block), int8 or float32, in
    which a third of the 32 x 32 blocks off the diagonal of the diagonal
    tiles, and a third of the coupling tiles' blocks, are set to exact
    zeros (the diagonal tiles symmetrically): zero blocks inside the (T, T)
    tiles, outside them and in the coupling tiles, the blocks that the
    kernels skip (BlockLD.diag_nz, BlockLD.off_nz)."""
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(300, 150, 100, 60),
                                   h2=0.3, prop_causal=0.05, seed=5)
    jld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=256,
                                 quantize=request.param)
    assert jld.n_off > 0
    diag, off = np.array(jld.diag), np.array(jld.off_data)
    nb, B, m = diag.shape[0], diag.shape[1], diag.shape[1] // 32
    for b in range(nb):
        for r in range(m):
            for c in range(m):
                if r != c and (r + c + b) % 3 == 0:
                    diag[b, 32 * r:32 * r + 32, 32 * c:32 * c + 32] = 0
    for o in range(off.shape[0]):
        for r in range(m):
            for c in range(m):
                if (r + 2 * c + o) % 3 == 0:
                    off[o, 32 * r:32 * r + 32, 32 * c:32 * c + 32] = 0
    jld = dataclasses.replace(jld, diag=jnp.asarray(diag),
                              off_data=jnp.asarray(off))
    sb = lay.to_flat(sim['std_beta']).reshape(lay.nb, B)
    nf = lay.to_flat(sim['n_per_snp']).reshape(lay.nb, B)
    ld = BlockLD.from_numpy(
        *(np.asarray(getattr(jld, f)) for f in
          ('diag', 'off_data', 'off_src', 'off_dst', 'mask')),
        jld.scale, device='cpu')
    return dict(jld=jld, ld=ld, nb=lay.nb, sb=sb, nf=nf,
                mask=np.asarray(jld.mask))


def make_state_b(p, seed):
    """make_state at S = 1 for a problem of any block size."""
    rng = np.random.default_rng(seed)
    shape = (1, p['nb'], p['mask'].shape[1])
    logits = (np.log(0.05 / 0.95)
              + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    mu = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    eta = (1 / (1 + np.exp(-logits)) * mu * p['mask']).astype(np.float32)
    q = np.array(cavi_jax.compute_q(p['jld'], jnp.asarray(eta)))
    hyper = dict(sigma_eps=np.float32([0.7]), tau_beta=np.float32([700.]),
                 pi=np.float32([0.05]), lambda_min=np.zeros(1, np.float32))
    return (logits, mu, eta, q), hyper


@pytest.mark.parametrize('kernel', ['K1', 'K2'])
def test_plain_k1_k2_match_pallas_with_zero_blocks(zero_block_problem,
                                                   interpret, kernel):
    """The plain K1 and K2 (cavi_torch.block_sweep and coupling_pass
    through cavi_sweep_s1 / _skip) against the Pallas kernels in interpret
    mode on diagonal tiles whose zero 32 x 32 blocks lie inside and outside
    the (T, T) tiles and on coupling tiles with zero blocks, at
    test_plain_k1_matches_pallas_s1's tolerances."""
    p = zero_block_problem
    nz = p['ld'].diag_nz.bool()
    m = nz.shape[1]
    in_tile = torch.from_numpy(
        (np.arange(m)[:, None] // 4) == (np.arange(m)[None] // 4))
    assert (~nz & in_tile).any() and (~nz & ~in_tile).any()
    assert (nz & ~in_tile).any()
    off_nz = p['ld'].off_nz.bool()
    assert off_nz.any() and not off_nz.all()
    st, hy = make_state_b(p, seed=31)
    state, sb, nf, hyper = torch_args(p, st, hy)
    if kernel == 'K1':
        got = cavi_cuda.cavi_sweep_s1(p['ld'], state, sb, nf, hyper,
                                      torch.ones(1))
        want = cavi_pallas.cavi_sweep_pallas_s1.__wrapped__(
            p['jld'], *jax_args(p, st, hy), jnp.ones(1), chunk=2)
    else:
        blk = np.ones(p['nb'], bool)
        blk[1::3] = False
        got = cavi_cuda.cavi_sweep_s1_skip(p['ld'], state, sb, nf, hyper,
                                           torch.ones(1),
                                           torch.from_numpy(blk))
        want = cavi_pallas.cavi_sweep_pallas_s1_skip.__wrapped__(
            p['jld'], *jax_args(p, st, hy), jnp.ones(1), jnp.asarray(blk),
            chunk=2)
    assert_close(got, want)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize('bad', [None, 'shape', 'dtype', 'layout'])
def test_block_sweep_s1_checks_diag_nz_before_launching(monkeypatch, bad):
    """Off the CPU, block_sweep_s1 checks BlockLD.diag_nz (dtype, shape,
    contiguity) before it launches, and hands the kernel the flags and the
    inner steps (a stand-in library records the launches; meta tensors take
    the place of the card's)."""
    calls = {}
    _stand_in_lib(monkeypatch, calls)
    nb, B = 2, 256
    ld = _meta_ld(nb, B, 0)
    assert ld.diag_nz.shape == (nb, 8, 8) and ld.diag_nz.dtype == torch.uint8
    nz = {'shape': torch.ones(nb, 4, 4, dtype=torch.uint8, device='meta'),
          'dtype': torch.ones(nb, 8, 8, dtype=torch.int32, device='meta'),
          'layout': torch.ones(nb, 8, 8, dtype=torch.uint8,
                               device='meta').transpose(1, 2)}
    if bad is not None:
        ld = dataclasses.replace(ld, diag_nz=nz[bad])
    z = torch.zeros(1, nb, B, device='meta')
    args = (ld, CaviState(z, z, z, z), z[0], z[0],
            Hyper(*(torch.ones(1, device='meta'),) * 4),
            torch.ones(1, device='meta'),
            torch.ones(nb, dtype=torch.int32, device='meta'))
    if bad is None:
        for steps in (0, 1, cavi_torch.INNER_STEPS):
            out, eta_diff = cavi_cuda.block_sweep_s1(*args,
                                                     inner_steps=steps)
            assert eta_diff.shape == (1, nb, B)
        got = calls['cavi_block_sweep_s1_launch']
        assert len(got) == cavi_cuda.LAUNCHES['cavi_block_sweep_s1'] == 3
        # diag, diag_nz and 14 more pointers, then nb, B, scale, inner
        # steps and the stream
        assert all(len(a) == 16 + 5 for a in got)
        assert [a[16:-1] for a in got] == [
            (nb, B, float(np.float32(1 / 127)), s)
            for s in (0, 1, cavi_torch.INNER_STEPS)]
        # K1 / K2: the sweep, then the coupling pass in place (none here)
        out, _ = cavi_cuda.cavi_sweep_s1(*args[:-1])
        assert cavi_cuda.LAUNCHES['cavi_block_sweep_s1'] == 4
        assert got[-1][-2] == cavi_torch.INNER_STEPS
    else:
        with pytest.raises(ValueError, match='diag_nz'):
            cavi_cuda.block_sweep_s1(*args)
        assert not calls
        assert cavi_cuda.LAUNCHES['cavi_block_sweep_s1'] == 0


def test_block_sweep_s1_takes_the_inner_steps_probe_on_the_card_only(problem):
    """Fewer inner steps are a timing probe of the kernel; the plain version
    on the CPU runs INNER_STEPS and refuses any other count."""
    st, hy = make_state(problem, 1, seed=24)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    blk = torch.ones(problem['nb'], dtype=torch.int32)
    act = torch.ones(1)
    for steps in (0, 1):
        with pytest.raises(ValueError, match='inner steps'):
            cavi_cuda.block_sweep_s1(problem['ld'], state, sb, nf, hyper,
                                     act, blk, inner_steps=steps)
    got = cavi_cuda.block_sweep_s1(problem['ld'], state, sb, nf, hyper, act,
                                   blk, inner_steps=cavi_torch.INNER_STEPS)
    want = cavi_torch.block_sweep(problem['ld'], state, sb, nf, hyper, act,
                                  blk_mask=blk)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_s1_wrappers_never_take_the_plain_version_off_cpu(monkeypatch,
                                                        tmp_path):
    """A tensor that is not on the CPU goes to the S = 1 kernels or raises:
    with the CUDA toolkit made unavailable, the build raises, for the block
    sweep, both coupling wrappers and both compositions."""
    from viprs_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found (made unavailable by the test)")

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    _build.build.cache_clear()
    ld = _meta_ld(2, 128, 1)
    z = torch.zeros(1, 2, 128, device='meta')
    state = CaviState(z, z, z, z)
    hyper = Hyper(*(torch.ones(1, device='meta'),) * 4)
    act = torch.ones(1, device='meta')
    blk = torch.ones(2, dtype=torch.int32, device='meta')
    try:
        for call in (
                lambda: cavi_cuda.block_sweep_s1(ld, state, z[0], z[0], hyper,
                                                 act, blk),
                lambda: cavi_cuda.coupling_pass_s1(ld, z, z, blk),
                lambda: cavi_cuda.coupling_pass_s1_inplace(ld, z, z, blk),
                lambda: cavi_cuda.cavi_sweep_s1(ld, state, z[0], z[0], hyper,
                                                act),
                lambda: cavi_cuda.cavi_sweep_s1_skip(ld, state, z[0], z[0],
                                                     hyper, act, blk)):
            with pytest.raises(RuntimeError, match='nvcc'):
                call()
    finally:
        _build.build.cache_clear()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def _meta_s1_args(nb, B):
    """State, inputs, hyperparameters, step scale and an all-blocks mask of
    one model on the meta device."""
    z = torch.zeros(1, nb, B, device='meta')
    return (CaviState(z, z, z, z), z[0], z[0],
            Hyper(*(torch.ones(1, device='meta'),) * 4),
            torch.ones(1, device='meta'),
            torch.ones(nb, dtype=torch.int32, device='meta'))


def test_s1_wrappers_launch_the_float32_instances(monkeypatch):
    """Float32 LD tiles go to the float32 instances of the S = 1 kernels
    (cavi_block_sweep_s1_f32_launch, coupling_pass_s1_f32_launch) with
    scale 1.0, counted under their own LAUNCHES names, through K1, K2 and
    both coupling wrappers; no int8 instance is launched (a stand-in library
    records the launches; meta tensors take the place of the card's)."""
    calls = {}
    _stand_in_lib(monkeypatch, calls)
    nb, B, n_off = 3, 256, 2
    ld = _meta_ld(nb, B, n_off, np.float32)
    assert ld.diag.dtype == ld.off_data.dtype == torch.float32
    assert ld.scale == 1.0
    state, sb, nf, hyper, act, blk = _meta_s1_args(nb, B)
    cavi_cuda.cavi_sweep_s1(ld, state, sb, nf, hyper, act)
    cavi_cuda.cavi_sweep_s1_skip(ld, state, sb, nf, hyper, act, blk)
    cavi_cuda.block_sweep_s1(ld, state, sb, nf, hyper, act, blk,
                             inner_steps=1)
    q = state.q
    assert cavi_cuda.coupling_pass_s1_inplace(ld, q, q, blk) is q
    assert cavi_cuda.coupling_pass_s1(ld, q, q, blk) is not q
    assert set(calls) == {'cavi_block_sweep_s1_f32_launch',
                          'coupling_pass_s1_f32_launch'}
    sweeps = calls['cavi_block_sweep_s1_f32_launch']
    passes = calls['coupling_pass_s1_f32_launch']
    assert [a[16:-1] for a in sweeps] == [
        (nb, B, 1.0, cavi_torch.INNER_STEPS)] * 2 + [(nb, B, 1.0, 1)]
    assert [a[10:-1] for a in passes] == [
        (ld.cpl_slabs.numel(), nb, B, 1.0)] * 4
    assert {k: v for k, v in cavi_cuda.LAUNCHES.items() if v} == {
        'cavi_block_sweep_s1_f32': 3, 'coupling_pass_s1_f32': 4}


def _retyped(ld, diag, off):
    """``ld`` with its tiles recast (the meta device's stand-in for LD the
    packers do not make)."""
    return dataclasses.replace(ld, diag=ld.diag.to(diag),
                               off_data=ld.off_data.to(off))


@pytest.mark.parametrize('diag,off,msg', [
    (torch.int8, torch.float32, 'share one dtype'),
    (torch.float32, torch.int8, 'share one dtype'),
    (torch.float64, torch.float64, 'int8 or float32'),
    (torch.float16, torch.float16, 'int8 or float32')])
def test_s1_wrappers_refuse_other_and_mixed_tile_dtypes(monkeypatch, diag,
                                                        off, msg):
    """Off the CPU, the S = 1 wrappers take int8 or float32 tiles, diag and
    off_data alike: mixed int8/float32 tiles and float64 or float16 tiles
    raise before anything is launched, through each wrapper and the
    single-model mixture sweep."""
    calls = {}
    _stand_in_lib(monkeypatch, calls)
    nb, B = 2, 128
    ld = _retyped(_meta_ld(nb, B, 1), diag, off)
    state, sb, nf, hyper, act, blk = _meta_s1_args(nb, B)
    q = state.q
    K = 2
    zk = torch.zeros(1, K, nb, B, device='meta')
    mix = MixState(zk, zk, q, q)
    h = MixHyper(torch.ones(1, device='meta'),
                 torch.ones(1, K, device='meta'),
                 torch.ones(1, K, device='meta'),
                 torch.zeros(1, device='meta'))
    for call in (
            lambda: cavi_cuda.block_sweep_s1(ld, state, sb, nf, hyper, act,
                                             blk),
            lambda: cavi_cuda.cavi_sweep_s1(ld, state, sb, nf, hyper, act),
            lambda: cavi_cuda.coupling_pass_s1_inplace(ld, q, q, blk),
            lambda: cavi_cuda.coupling_pass_s1(ld, q, q, blk),
            lambda: cavi_cuda.block_sweep_mix(ld, mix, sb, nf, h, None, blk,
                                              True, 'cavi_sweep_mix_s1')):
        with pytest.raises(ValueError, match=msg):
            call()
    assert not calls
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_s1_float32_wrappers_never_take_the_plain_version_off_cpu(
        monkeypatch, tmp_path):
    """Float32 tiles that are not on the CPU go to the S = 1 kernels or
    raise, as int8 tiles do: with the CUDA toolkit made unavailable, the
    build raises for the block sweep, both coupling wrappers, K1, K2, and
    the single-model mixture sweeps K5 and K6."""
    from viprs_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found (made unavailable by the test)")

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    _build.build.cache_clear()
    nb, B = 2, 128
    ld = _meta_ld(nb, B, 1, np.float32)
    state, sb, nf, hyper, act, blk = _meta_s1_args(nb, B)
    q = state.q
    K = 3
    zk = torch.zeros(K, nb, B, device='meta')
    one = MixState(zk, zk, q[0], q[0])
    h1 = MixHyper(torch.ones((), device='meta'), torch.ones(K, device='meta'),
                  torch.ones(K, device='meta'), torch.zeros((), device='meta'))
    try:
        for call in (
                lambda: cavi_cuda.block_sweep_s1(ld, state, sb, nf, hyper,
                                                 act, blk),
                lambda: cavi_cuda.coupling_pass_s1(ld, q, q, blk),
                lambda: cavi_cuda.coupling_pass_s1_inplace(ld, q, q, blk),
                lambda: cavi_cuda.cavi_sweep_s1(ld, state, sb, nf, hyper,
                                                act),
                lambda: cavi_cuda.cavi_sweep_s1_skip(ld, state, sb, nf, hyper,
                                                     act, blk),
                lambda: cavi_cuda.cavi_sweep_mix_s1(ld, one, sb, nf, h1),
                lambda: cavi_cuda.cavi_sweep_mix_s1_skip(ld, one, sb, nf, h1,
                                                         blk)):
            with pytest.raises(RuntimeError, match='nvcc'):
                call()
    finally:
        _build.build.cache_clear()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0
