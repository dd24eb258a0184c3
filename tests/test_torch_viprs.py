"""The port's single-model fit against the JAX package's, on the CPU.

``VIPRS(ds, device='cpu')`` runs the plain versions of the kernels; the JAX
package's ``VIPRS(ds, mesh='off')`` on the CPU runs its all-active XLA
sweep, so the port is held to it with ``sweep_impl='xla'``. The hybrid
branch rule is held to the JAX package's ``em_fit(use_hybrid=True)``, whose
skip branch (a Pallas kernel) runs in interpret mode.

Tolerances: the number of iterations, the status and the restart outcome
must be equal; h2 within 1e-6 (absolute); the ELBO history within rtol 1e-6
plus atol 1e-3 (its terms are around 1e3-1e4 and computed from float32
state, so a small ELBO after a restart carries their absolute error); PIP
within 1e-5 and the posterior mean within 1e-6 (absolute).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.model import VIPRS as JaxVIPRS
from viprs_tpu.ops import cavi_jax, em_loop as jax_em_loop, updates as jax_updates

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.model import VIPRS
from viprs_tpu_torch.ops import cavi_cuda, em_loop
from viprs_tpu_torch.ops.block_ld import BlockLD
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both_datasets(sim, scale=1.0, block_size=128):
    sb = {c: scale * v for c, v in sim['std_beta'].items()}
    args = (sim['ld_blocks'], sb, sim['n_per_snp'])
    return (JaxDataset.from_dense_blocks(*args, block_size=block_size,
                                         quantize=True),
            SummaryStatsDataset.from_dense_blocks(
                *args, block_size=block_size, quantize=True, device='cpu'))


def flat(d, chroms):
    return np.concatenate([np.asarray(d[c]) for c in chroms])


def assert_fits_match(jm, tm):
    assert tm.optim_result.nit == jm.optim_result.nit
    assert tm.optim_result.message == jm.optim_result.message
    assert tm.optim_result.success == jm.optim_result.success
    assert tm.fix_params == jm.fix_params
    assert abs(tm.get_heritability() - jm.get_heritability()) <= 1e-6
    hj = np.array([float(np.atleast_1d(v)[0]) for v in jm.history['ELBO']])
    ht = np.array(tm.history['ELBO'])
    assert ht.shape == hj.shape
    np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-3, equal_nan=True)
    ch = tm.chromosomes
    np.testing.assert_allclose(flat(tm.pip, ch), flat(jm.pip, ch), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(flat(tm.post_mean_beta, ch),
                               flat(jm.post_mean_beta, ch), atol=1e-6, rtol=0)


@pytest.mark.parametrize('scale,expect_restart', [(1.0, False), (3.0, True)])
def test_fit_matches_jax(scale, expect_restart):
    """Nominal fit and the in-loop restart on negative MSE (the cases of
    tests/test_models.py::TestInGraphRestart), same np.random stream."""
    sim = simulate_sumstats_blocks(n=1500, block_sizes=(96, 80), h2=0.3,
                                   prop_causal=0.05, seed=0)
    jds, ds = both_datasets(sim, scale)
    np.random.seed(7)
    jm = JaxVIPRS(jds, mesh='off').fit(max_iter=60)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(7)
    tm = VIPRS(ds, 'cpu').fit(max_iter=60, sweep_impl='xla')
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert (tm.fix_params.get('sigma_epsilon') == 0.95) == expect_restart
    assert_fits_match(jm, tm)


def test_fit_with_coupling_tiles_matches_jax():
    """A problem whose widest LD block spans three tiles (coupling tiles on
    every sweep)."""
    sim = simulate_sumstats_blocks(n=3000, block_sizes=(300, 150, 100, 60),
                                   h2=0.4, prop_causal=0.05, seed=9)
    jds, ds = both_datasets(sim)
    assert ds.ld.n_off > 0
    np.random.seed(3)
    jm = JaxVIPRS(jds, mesh='off').fit(max_iter=200)
    np.random.seed(3)
    tm = VIPRS(ds, 'cpu').fit(max_iter=200, sweep_impl='xla')
    assert jm.optim_result.success
    assert_fits_match(jm, tm)


@pytest.mark.parametrize('fix_params,lambda_min', [
    ({'pi': 0.02}, None),
    ({'tau_beta': 600.0, 'sigma_epsilon': 0.8}, 0.05)])
def test_fixed_params_and_table_match_jax(fix_params, lambda_min):
    """Pinned hyperparameters and lambda_min through the whole fit, and the
    posterior table (SNP, BETA, PIP, VAR_BETA) against the JAX package's."""
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(150, 90), h2=0.3,
                                   prop_causal=0.05, seed=4)
    jds, ds = both_datasets(sim)
    np.random.seed(11)
    jm = JaxVIPRS(jds, mesh='off', fix_params=dict(fix_params),
                  lambda_min=lambda_min).fit(max_iter=100)
    np.random.seed(11)
    tm = VIPRS(ds, 'cpu', fix_params=dict(fix_params),
               lambda_min=lambda_min).fit(max_iter=100, sweep_impl='xla')
    assert_fits_match(jm, tm)
    for name, v in fix_params.items():
        got = {'pi': tm.pi, 'tau_beta': tm.tau_beta,
               'sigma_epsilon': tm.sigma_epsilon}[name]
        assert got == pytest.approx(v, rel=1e-7)
    jt, tt = jm.to_table(), tm.to_table()
    assert list(tt['SNP']) == list(jt['SNP'])
    for col in ('BETA', 'PIP', 'VAR_BETA'):
        np.testing.assert_allclose(tt[col].values, jt[col].values,
                                   atol=1e-5, rtol=0, err_msg=col)


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)
    monkeypatch.setattr(pl, 'pallas_call', interp_call)


@pytest.mark.parametrize('hybrid_eps', [1e-5, 3e-5])
def test_hybrid_rule_matches_jax_em_fit(interpret, hybrid_eps):
    """The hybrid branch rule against the JAX package's em_fit(use_hybrid=
    True), traced on the CPU with the skip kernel in interpret mode: the same
    per-iteration active-block counts, iterations, status and ELBO history.

    The gate compares float32 proposals with ``hybrid_eps``. At the default
    eps (x_abs_tol = 1e-6) one block of this problem ends within rounding of
    the gate, so the two packages may pick different branches there; the
    epsilons here keep every decision of the run clear of it."""
    sim = simulate_sumstats_blocks(
        n=3000, block_sizes=(300, 120, 110, 100, 90, 80, 120, 70, 100, 60),
        h2=0.4, prop_causal=0.03, seed=2)
    jds, ds = both_datasets(sim)
    jld = jds.ld
    nb = jld.nb
    sb, nf = ds.device_inputs()
    pi = 0.01
    hyper0 = (0.8, pi * ds.m / 0.2, pi, 0.0)
    logit = np.float32(np.log(pi) - np.log1p(-pi))
    shape = (1, nb, 128)
    jstate = cavi_jax.CaviState(jnp.full(shape, logit, jnp.float32),
                                *(jnp.zeros(shape, jnp.float32),) * 3)
    kw = dict(max_iter=150, min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6,
              patience=10, hybrid_eps=hybrid_eps)
    fix = jax_updates.FixMask(*(jnp.zeros(1, bool),) * 3)
    jres = jax_em_loop.em_fit.__wrapped__(
        jld, jstate, jnp.asarray(sb.numpy()), jnp.asarray(nf.numpy()),
        cavi_jax.Hyper(*(jnp.asarray([v], jnp.float32) for v in hyper0)),
        fix, n_sample=float(ds.n), m_total=float(ds.m), init_elbo=None,
        active0=jnp.ones(1, bool), use_hybrid=True,
        hybrid_frac=em_loop.HYBRID_FRAC, **kw)
    state0 = CaviState(torch.full(shape, float(logit)),
                       *(torch.zeros(shape),) * 3)
    res = em_loop.em_fit(ds.ld, state0, sb, nf, hyper0, (False,) * 3,
                         n_sample=float(ds.n), m_total=float(ds.m),
                         use_hybrid=True, **kw)
    n = int(jres.n_iter_total)
    assert res.nit[0] == int(jres.nit[0]) and res.n_iter_total == n
    assert res.status[0] == int(jres.status[0])
    act_j = np.asarray(jres.act_hist)[:n + 1].tolist()
    assert res.act_hist == act_j
    thresh = int(em_loop.HYBRID_FRAC * nb)
    assert 0 < res.n_skip == sum(1 for a in act_j[1:] if a <= thresh)
    np.testing.assert_allclose(np.asarray(res.elbo_hist)[:, 0],
                               np.asarray(jres.elbo_hist)[:n + 1, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(res.state.eta.numpy(),
                               np.asarray(jres.state.eta), atol=1e-6, rtol=0)


def test_import_without_jax_and_cpu_never_launches(tmp_path):
    """In a fresh interpreter: importing the port (model, kernels) loads
    neither jax nor triton, and a CPU fit launches no kernel."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import viprs_tpu_torch
        import viprs_tpu_torch.model.viprs
        from viprs_tpu_torch.ops import cavi_cuda
        from viprs_tpu_torch.data.dataset import SummaryStatsDataset
        from viprs_tpu_torch.model import VIPRS
        assert 'jax' not in sys.modules and 'triton' not in sys.modules
        rng = np.random.default_rng(0)
        m = 200
        R = 0.5 ** np.abs(np.subtract.outer(np.arange(m), np.arange(m)))
        beta = np.where(rng.random(m) < 0.05, 0.05, 0.0)
        sb = R @ beta + rng.standard_normal(m) / np.sqrt(5000)
        ds = SummaryStatsDataset.from_dense_blocks(
            {1: [R]}, {1: sb}, {1: np.full(m, 5000.0)}, block_size=128,
            quantize=True, device='cpu')
        np.random.seed(0)
        model = VIPRS(ds, 'cpu').fit(max_iter=50)
        assert model.optim_result.nit > 3 and ds.ld.n_off == 1
        assert set(cavi_cuda.LAUNCHES) == {
            'cavi_block_sweep_s1', 'coupling_pass_s1', 'cavi_block_sweep_s',
            'coupling_pass_s'}, cavi_cuda.LAUNCHES
        assert not any(cavi_cuda.LAUNCHES.values()), cavi_cuda.LAUNCHES
        assert 'jax' not in sys.modules and 'triton' not in sys.modules
        print('ok')
    """)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, tmp_path):
    """A tensor that is not on the CPU goes to the kernel or raises: with
    the CUDA toolkit made unavailable (and no earlier build to load), the
    build raises instead of falling back."""
    from viprs_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found (made unavailable by the test)")

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    _build.build.cache_clear()
    ld = BlockLD.from_numpy(np.zeros((2, 128, 128), np.int8),
                            np.zeros((0, 128, 128), np.int8), [], [],
                            np.ones((2, 128), np.float32), 1 / 127,
                            device='meta')
    z = torch.zeros(1, 2, 128, device='meta')
    state = CaviState(z, z, z, z)
    hyper = Hyper(*(torch.ones(1, device='meta'),) * 4)
    try:
        with pytest.raises(RuntimeError, match='nvcc'):
            cavi_cuda.cavi_sweep_s1(ld, state, z[0], z[0], hyper,
                                    torch.ones(1, device='meta'))
        with pytest.raises(RuntimeError, match='nvcc'):
            _build.build()
    finally:
        _build.build.cache_clear()


def test_model_arguments_are_checked():
    sim = simulate_sumstats_blocks(n=500, block_sizes=(60,), seed=1)
    _, ds = both_datasets(sim)
    with pytest.raises(ValueError, match='sweep_impl'):
        VIPRS(ds, 'cpu').fit(sweep_impl='triton')
    with pytest.raises(ValueError, match='max_restarts'):
        VIPRS(ds, 'cpu').fit(max_restarts=2)
    with pytest.raises(ValueError, match='LD is on'):
        VIPRS(ds, 'meta')
