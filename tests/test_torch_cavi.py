"""The port's CAVI sweeps against the JAX package's, on the same bytes.

The problem has five LD tiles of B = 128 with four coupling tiles (one LD
block of 300 variants spans three tiles); its LD, state and
hyperparameters are made once with numpy and handed to both packages.

Tolerances: atol 1e-5 on eta, mu and gamma and 1e-4 on q, because exp,
log and the order of float32 sums differ between XLA and PyTorch (the same
bounds the JAX package holds its Pallas kernels to, tests/test_pallas.py).
"""

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
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

ATOL = {'eta': 1e-5, 'mu': 1e-5, 'gamma': 1e-5, 'q': 1e-4, 'eta_diff': 1e-5}


@pytest.fixture(scope='module')
def problem():
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(300, 150, 100, 60),
                                   h2=0.3, prop_causal=0.05, seed=5)
    jld, lay = pack_dense_blocks(sim['ld_blocks'], block_size=128,
                                 quantize=True)
    assert jld.n_off > 0
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
