"""The port's posterior-check samplers against the JAX package's, on the
CPU (tests/test_sampler.py's problem: LD blocks of 150 and 120 variants at
B = 128, so the first block spans two tiles and a coupling tile).

Replay parity. The port draws from torch generators by default; here its
draw source is swapped for one that replays the JAX package's own
``jax.random`` stream in the reference's key order (a Gibbs sweep: split,
uniform, split, normal; an HMC step: split, then three keys for the
momentum, the acceptance uniforms and L), so whole runs compare draw for
draw, on float32 and on int8 LD.

Tolerances, from the measured deviations (the two packages' float32 logs,
sigmoids, tile products and sums round differently; about 1 ulp):

- one sweep from a nonzero state: gamma equal; beta within 2e-7 and q
  within 1e-7 absolute (measured 3.0e-8 and 1.5e-8; |beta| <= 0.4);
- a 20-sweep run: pip equal; the posterior mean and variance within 3e-7
  (measured 3.0e-8);
- SMC, 3 particles x 2 stages x 2 sweeps: the best particle and its pip
  equal, the posterior mean within 5e-7 (measured 6.0e-8); the weights
  within 5e-5 (measured 8.5e-6 and 6.2e-6: the tempered log-likelihood
  increments are float32 sums of about -1740, whose ulp is 1.2e-4, summed
  in another order), and exactly 1/3 each where all three particles are
  one resampled particle's duplicates (they draw alike);
- HMC, 10 samples x 4 leapfrog steps: the accept rates within 1e-5
  (measured 1.2e-6), the step size within rtol 1e-6 (measured equal), the
  posterior mean within 5e-7 (measured 4.8e-8).

The guard. A draw that lands within rounding of its threshold could go
either way in the two packages, so every comparison that needs equal
decisions first checks, on the port's run, that each decision is clear:
each Gibbs sweep is replayed in float64 numpy from its input state with
its draws, and every coordinate's log-odds u_j must lie at least
GIBBS_CLEAR * (1 + |u_j|) from logit(u): float32 log-odds along the port's
trajectory differ from float64 ones by at most 8.0e-7 (1 + |u_j|)
(measured over 30 sweeps on both packings), so two float32 packages by
at most twice that, and the guard asks for 2.5 x that gap. Every HMC
acceptance must have |log u - log alpha| >= HMC_CLEAR (the packages'
accept rates differ by 1.2e-6).

Statistical checks on the port's own generator, with tests/test_sampler.py's
criteria against the port's VIPRS.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.model import sampler as jsm

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.gridsearch import HyperparameterGrid
from viprs_tpu_torch.model import VIPRS
from viprs_tpu_torch.model import sampler as tsm
from viprs_tpu_torch.utils.table import Table

SIM = dict(n=4000, block_sizes=(150, 120), h2=0.4, prop_causal=0.03,
           seed=33)
HYPER = dict(pi=0.05, tau_beta=500.0, sigma_eps=0.7)
GIBBS_CLEAR = 4e-6
HMC_CLEAR = 1e-4


@pytest.fixture(scope='module')
def sim():
    return simulate_sumstats_blocks(**SIM)


@pytest.fixture(scope='module', params=['float32', 'int8'])
def both(request, sim):
    quantize = request.param == 'int8'
    args = (sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'])
    jds = JaxDataset.from_dense_blocks(*args, block_size=128,
                                       quantize=quantize)
    ds = SummaryStatsDataset.from_dense_blocks(*args, block_size=128,
                                               quantize=quantize,
                                               device='cpu')
    assert ds.ld.n_off > 0
    return jds, ds


def flat(d, chroms):
    return np.concatenate([np.asarray(d[c]) for c in chroms])


class Replay:
    """A draw source replaying the JAX package's random stream from
    ``key``, in its order of splits."""

    def __init__(self, key):
        self.key = key

    def gibbs(self, shape):
        self.key, sub = jax.random.split(self.key)
        u = jax.random.uniform(sub, shape, dtype=jnp.float32)
        self.key, sub = jax.random.split(self.key)
        z = jax.random.normal(sub, shape, dtype=jnp.float32)
        return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(z))

    def hmc(self, shape, n_lo, n_hi):
        self.key, sub = jax.random.split(self.key)
        k1, k2, k3 = jax.random.split(sub, 3)
        z = jax.random.normal(k1, shape, jnp.float32)
        L = int(jax.random.randint(k3, (), n_lo, n_hi + 1))
        u = jax.random.uniform(k2, (shape[0],))
        return (torch.from_numpy(np.array(z)), L,
                torch.from_numpy(np.array(u)))

    def clone(self):
        return Replay(self.key)


@pytest.fixture
def replay(monkeypatch):
    """Every draw source the port makes from a seed replays
    ``jax.random.PRNGKey(seed)``."""
    monkeypatch.setattr(tsm, '_draw_source',
                        lambda key, device: Replay(jax.random.PRNGKey(key)))


# ------------------------------------------------------------------ guards
def gibbs_margin(ld, state, draws, std_beta, n_per_snp, sigma_eps, tau_beta,
                 pi, lambda_min, temper):
    """The smallest |logit(u) - u_j| / (1 + |u_j|) of one sweep, replayed
    in float64 from ``state`` with the sweep's draws (masked lanes
    excluded)."""
    u, z = (x.numpy().astype(np.float64) for x in draws)
    D = ld.diag.numpy().astype(np.float64) * ld.scale
    beta, q = (x.numpy().astype(np.float64) for x in (state.beta, state.q))
    n = n_per_snp.numpy().astype(np.float64) * temper
    sb = std_beta.numpy().astype(np.float64)
    keep = ld.mask.numpy() != 0
    v = n * (1.0 + lambda_min) / sigma_eps + tau_beta
    a = np.log(pi) - np.log1p(-pi) + 0.5 * (np.log(tau_beta) - np.log(v))
    with np.errstate(divide='ignore'):
        logit_u = np.log(u) - np.log1p(-u)
    worst = np.inf
    for j in range(beta.shape[2]):
        m = n[:, j] / (v[:, j] * sigma_eps) * (sb[:, j] - q[:, :, j])
        uj = a[:, j] + 0.5 * v[:, j] * m * m
        gap = np.abs(logit_u[:, :, j] - uj) / (1.0 + np.abs(uj))
        worst = min(worst, float(np.min(gap[:, keep[:, j]], initial=np.inf)))
        g = (u[:, :, j] < 1.0 / (1.0 + np.exp(-uj))) & keep[:, j]
        b = g * (m + z[:, :, j] / np.sqrt(v[:, j]))
        d = b - beta[:, :, j]
        q = q + d[:, :, None] * D[None, :, j]
        q[:, :, j] -= d
        beta[:, :, j] = b
    return worst


class Recorder:
    """Forwards a draw source, keeping its last draws."""

    def __init__(self, src):
        self.src = src

    def gibbs(self, shape):
        self.last = self.src.gibbs(shape)
        return self.last

    def hmc(self, shape, n_lo, n_hi):
        self.last = self.src.hmc(shape, n_lo, n_hi)
        return self.last


@pytest.fixture
def guard(monkeypatch):
    """Records, for every Gibbs sweep and HMC step the port makes, how far
    its decisions lie from their thresholds; ``guard.check()`` asserts
    that they are all clear."""
    rec = dict(gibbs=[], hmc=[])
    sweep, step = tsm._gibbs_sweep, tsm._hmc_step

    def spy_sweep(ld, state, *args):
        r = Recorder(state.key)
        out = sweep(ld, state._replace(key=r), *args)
        rec['gibbs'].append(gibbs_margin(ld, state, r.last, *args))
        return out._replace(key=state.key)

    def spy_step(tgt, beta, e_pot, eps, draws, n_lo, n_hi):
        r = Recorder(draws)
        out = step(tgt, beta, e_pot, eps, r, n_lo, n_hi)
        u = r.last[2].numpy()
        with np.errstate(divide='ignore'):
            rec['hmc'].append(np.abs(np.log(u) - np.log(out[2].numpy())))
        return out

    monkeypatch.setattr(tsm, '_gibbs_sweep', spy_sweep)
    monkeypatch.setattr(tsm, '_hmc_step', spy_step)

    def check():
        assert rec['gibbs'] or rec['hmc']
        g = min(rec['gibbs'], default=np.inf)
        assert g >= GIBBS_CLEAR, f"knife-edge Gibbs draw: margin {g:.3g}"
        h = min((float(x.min()) for x in rec['hmc']), default=np.inf)
        assert h >= HMC_CLEAR, f"knife-edge HMC acceptance: margin {h:.3g}"
    rec['check'] = check
    return type('Guard', (), {'check': staticmethod(check), 'rec': rec})


def jax_args(g, temper=1.0):
    return (g._sb, g._nf, jnp.float32(g.sigma_eps), jnp.float32(g.tau_beta),
            jnp.float32(g.pi), jnp.float32(g.lambda_min), jnp.float32(temper))


# ------------------------------------------------------------ replay parity
def test_gibbs_sweep_matches_jax(both, guard):
    """One sweep from a nonzero state (three JAX sweeps in), on float32 and
    on int8 LD with coupling tiles (which the sweep does not read, in
    either package)."""
    jds, ds = both
    jg = jsm.GibbsSampler(jds, n_chains=4, seed=1, **HYPER)
    tg = tsm.GibbsSampler(ds, n_chains=4, seed=1, **HYPER)
    st = jg.init_state(jax.random.PRNGKey(5))
    for _ in range(3):
        st = jsm._gibbs_sweep(jds.ld, st, *jax_args(jg))
    start = tsm.GibbsState(*(torch.from_numpy(np.array(x)) for x in st[:3]),
                           key=Replay(st.key))
    want = jsm._gibbs_sweep(jds.ld, st, *jax_args(jg))
    got = tsm._gibbs_sweep(ds.ld, start, *tg._args(1.0))
    guard.check()
    assert float(np.asarray(want.gamma).sum()) > 0
    np.testing.assert_array_equal(got.gamma.numpy(), np.asarray(want.gamma))
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               atol=2e-7, rtol=0)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=1e-7,
                               rtol=0)
    # the input state is not changed
    np.testing.assert_array_equal(start.beta.numpy(), np.asarray(st.beta))


def test_gibbs_run_matches_jax(both, replay, guard):
    jds, ds = both
    want = jsm.GibbsSampler(jds, n_chains=4, seed=1, **HYPER).run(
        n_iter=20, burn_in=5)
    got = tsm.GibbsSampler(ds, n_chains=4, seed=1, **HYPER).run(
        n_iter=20, burn_in=5)
    guard.check()
    ch = ds.chromosomes
    np.testing.assert_array_equal(flat(got['pip'], ch), flat(want['pip'], ch))
    for k in ('post_mean_beta', 'post_var_beta'):
        np.testing.assert_allclose(flat(got[k], ch), flat(want[k], ch),
                                   atol=3e-7, rtol=0, err_msg=k)
    assert isinstance(got['state'], tsm.GibbsState)


#: (grid, chains per particle, resampled): the JAX test's grid collapses
#: at the first stage and is resampled into one particle's duplicates; the
#: narrower grid with 4 chains a particle keeps its three particles.
SMC_CASES = {
    'resampled': ({'pi': [0.001, 0.03, 0.3], 'sigma_epsilon': [0.7] * 3,
                   'tau_beta': [500.0] * 3}, 1, True),
    'kept': ({'pi': [0.02, 0.03, 0.04], 'sigma_epsilon': [0.7] * 3,
              'tau_beta': [500.0] * 3}, 4, False),
}


@pytest.mark.parametrize('case', sorted(SMC_CASES))
def test_smc_matches_jax(both, case, replay, guard, monkeypatch):
    import pandas as pd
    jds, ds = both
    grid, chains, resampled = SMC_CASES[case]
    clones = []
    clone = tsm.GibbsState.clone
    monkeypatch.setattr(tsm.GibbsState, 'clone',
                        lambda s: clones.append(1) or clone(s))
    kw = dict(n_chains_per_particle=chains, n_stages=2, sweeps_per_stage=2,
              seed=2)
    want = jsm.smc_over_grid(jds, pd.DataFrame(grid), **kw)
    got = tsm.smc_over_grid(ds, pd.DataFrame(grid), **kw)
    guard.check()
    assert len(clones) == (3 if resampled else 0)
    assert got['best_particle'] == want['best_particle']
    assert got['best_hyper'] == pytest.approx(want['best_hyper'], rel=1e-15)
    if resampled:
        np.testing.assert_array_equal(got['weights'], np.full(3, 1.0 / 3))
    np.testing.assert_allclose(got['weights'], want['weights'], atol=5e-5,
                               rtol=0)
    ch = ds.chromosomes
    post, wpost = got['posterior'], want['posterior']
    np.testing.assert_array_equal(flat(post['pip'], ch),
                                  flat(wpost['pip'], ch))
    np.testing.assert_allclose(flat(post['post_mean_beta'], ch),
                               flat(wpost['post_mean_beta'], ch), atol=5e-7,
                               rtol=0)


def top_decile_mask(ds):
    return {c: (np.abs(ds.std_beta[c]) > np.quantile(
        np.abs(ds.std_beta[c]), 0.9)).astype(float) for c in ds.chromosomes}


def test_hmc_matches_jax(both, replay, guard):
    jds, ds = both
    mask = top_decile_mask(ds)
    kw = dict(tau_beta=500.0, sigma_eps=0.7, n_samples=10, n_leapfrog=4,
              seed=3)
    want = jsm.hmc_refine(jds, mask, **kw)
    got = tsm.hmc_refine(ds, mask, **kw)
    guard.check()
    assert len(guard.rec['hmc']) == 10
    for k in ('accept_rate', 'warmup_accept_rate'):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    assert got['step_size'] == pytest.approx(want['step_size'], rel=1e-6)
    ch = ds.chromosomes
    np.testing.assert_allclose(flat(got['post_mean_beta'], ch),
                               flat(want['post_mean_beta'], ch), atol=5e-7,
                               rtol=0)


def test_smc_duplicates_share_no_tensor(both, replay):
    """A resampled particle's duplicates are copies: equal values, separate
    tensors and draw sources."""
    _, ds = both
    g = tsm.GibbsSampler(ds, n_chains=2, seed=0, **HYPER)
    st = tsm._gibbs_sweep(ds.ld, g.init_state(4), *g._args(1.0))
    dup = st.clone()
    assert dup.key is not st.key and dup.key.key is st.key.key
    for a, b in zip(st[:3], dup[:3]):
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    a = tsm._gibbs_sweep(ds.ld, st, *g._args(0.5))
    b = tsm._gibbs_sweep(ds.ld, dup, *g._args(0.5))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------- the port's own generator: statistics
@pytest.fixture(scope='module')
def dataset(sim):
    return SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128,
        device='cpu')


def test_gibbs_matches_vi_posterior_mean(dataset):
    np.random.seed(0)
    vi = VIPRS(dataset, device='cpu',
               fix_params={'pi': 0.05, 'sigma_epsilon': 0.7,
                           'tau_beta': 500.0})
    vi.fit(max_iter=300)
    out = tsm.GibbsSampler(dataset, n_chains=4, seed=1, **HYPER).run(
        n_iter=400, burn_in=150)
    ch = vi.chromosomes
    r = np.corrcoef(flat(vi.post_mean_beta, ch),
                    flat(out['post_mean_beta'], ch))[0, 1]
    assert r > 0.95, f"VI/MCMC posterior-mean correlation too low: {r}"
    pip_vi, pip_mc = flat(vi.pip, ch), flat(out['pip'], ch)
    strong = pip_vi > 0.9
    assert strong.any()
    assert np.all(pip_mc[strong] > 0.5)


@pytest.mark.parametrize('form', ['table', 'dict', 'grid'])
def test_smc_weights(dataset, form):
    cols = {'pi': [0.001, 0.03, 0.3], 'sigma_epsilon': [0.7] * 3,
            'tau_beta': [500.0] * 3}
    grid = {'table': lambda: Table(cols), 'dict': lambda: cols,
            'grid': lambda: HyperparameterGrid(
                pi_grid=[0.001, 0.03, 0.3], sigma_epsilon_grid=[0.7],
                tau_beta_grid=[500.0]).to_table()}[form]()
    out = tsm.smc_over_grid(dataset, grid, n_stages=4, sweeps_per_stage=3,
                            seed=2)
    assert out['weights'].shape == (3,)
    np.testing.assert_allclose(out['weights'].sum(), 1.0, atol=1e-8)
    assert np.isfinite(out['weights']).all()
    assert 'post_mean_beta' in out['posterior']


def test_hmc_gaussian_refinement(dataset):
    mask = top_decile_mask(dataset)
    out = tsm.hmc_refine(dataset, mask, tau_beta=500.0, sigma_eps=0.7,
                         n_samples=60, seed=3)
    assert 0.2 < out['accept_rate'] <= 1.0
    ch = dataset.chromosomes
    eta, m = flat(out['post_mean_beta'], ch), flat(mask, ch)
    assert np.all(eta[m == 0] == 0)
    sb = flat(dataset.std_beta, ch)
    assert np.corrcoef(eta[m == 1], sb[m == 1])[0, 1] > 0.5


def test_samplers_start_from_a_generator(dataset):
    """``init_state`` takes a seed or a torch generator: the same seed
    gives the same chains."""
    g = tsm.GibbsSampler(dataset, n_chains=2, seed=7, **HYPER)
    gen = torch.Generator().manual_seed(7)
    a = g.run(n_iter=3, burn_in=0)
    b = g.run(n_iter=3, burn_in=0, state=g.init_state(gen))
    ch = dataset.chromosomes
    np.testing.assert_array_equal(flat(a['post_mean_beta'], ch),
                                  flat(b['post_mean_beta'], ch))
