"""The port's mixture-prior fits (VIPRSMix, VIPRSMixGrid) against the JAX
package's, on the CPU.

``VIPRSMix(ds, 'cpu', K=...)`` runs the plain versions of the mixture
kernels; the JAX package's ``VIPRSMix(ds, K=..., mesh='off')`` on the CPU
runs its all-active XLA sweep, so the port is held to it with
``sweep_impl='xla'`` (kernel K5's rule; the grid's default is K7's). Both
start from the same np.random stream.

Tolerances: iterations, statuses and messages equal, on problems whose JAX
run the guard of tests/test_torch_viprs.py finds clear of every stopping
threshold; the ELBO history within rtol 1e-6 plus atol 1e-3; h2 within
1e-6; PIP within 1e-5 (absolute); the np.random streams equal afterwards;
pi and tau_beta within rtol 1e-6 at K = 1; at K = 3 tau_beta within rtol
1e-5 and pi within rtol 2e-5 plus 1e-5 of the lane's total pi (a component
with the mass of a fraction of one variant moves by 1e-4 of itself). The
looser bound is measured, not chosen: the two packages' ELBOs
differ by ~1e-4 absolute from float32 statistics summed in another order,
and a slab component holding the mass of a few variants takes that
rounding into its M-step update (pi of such a component moves by 7e-7
relative after one iteration and by 1e-6 to 7e-5 after ten on the
problems tried, while h2 agrees to 1e-8). The same ELBO rounding sets the
stopping settings: a clear stop needs ELBO changes far above 1e-4. A grid
whose lanes stop far apart (needed for compaction) is not clear of every
threshold; its end points are held instead
(``assert_grid_end_points_match``).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.gridsearch import HyperparameterGrid as JaxGrid
from viprs_tpu.model import VIPRSMix as JaxVIPRSMix
from viprs_tpu.model.mix_grid import VIPRSMixGrid as JaxVIPRSMixGrid
from viprs_tpu.ops import mix_em_loop as jax_mel

from viprs_tpu_torch.gridsearch import HyperparameterGrid
from viprs_tpu_torch.model import VIPRSMix, VIPRSMixGrid
from viprs_tpu_torch.ops import cavi_cuda, mix_em_loop
from viprs_tpu_torch.utils import optimize as opt

from test_torch_grid import assert_fit_counters
from test_torch_viprs import (REPO, assert_clear_of_thresholds,  # noqa: F401
                              both_datasets, flat, interpret, ladder_trace)

SIM = dict(n=2000, block_sizes=(150, 90), h2=0.3, prop_causal=0.05, seed=4)


@pytest.fixture(scope='module')
def datasets():
    return both_datasets(simulate_sumstats_blocks(**SIM))


def assert_mix_fits_match(jm, tm):
    assert tm.optim_result.nit == jm.optim_result.nit
    assert tm.optim_result.message == jm.optim_result.message
    assert tm.optim_result.success == jm.optim_result.success
    assert tm.fix_params == jm.fix_params
    assert abs(tm.get_heritability() - jm.get_heritability()) <= 1e-6
    np.testing.assert_allclose(tm.history['ELBO'], jm.history['ELBO'],
                               rtol=1e-6, atol=1e-3)
    assert_hyper_close(tm._hyper, jm._hyper, tm.K)
    ch = tm.chromosomes
    np.testing.assert_allclose(flat(tm.pip, ch), flat(jm.pip, ch), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(flat(tm.post_mean_beta, ch),
                               flat(jm.post_mean_beta, ch), atol=1e-6, rtol=0)


def assert_hyper_close(got, want, K, lanes=slice(None)):
    """sigma_eps, tau_beta and pi of one model or of grid lanes at the
    module's tolerances (pi at K > 1 against the lane's total as well)."""
    g, w = (tuple(np.asarray(x, np.float64)[lanes] if np.ndim(x) else x
                  for x in h) for h in (got, want))
    np.testing.assert_allclose(g[0], w[0], rtol=1e-6, err_msg='sigma_eps')
    np.testing.assert_allclose(g[1], w[1], rtol=1e-6 if K == 1 else 1e-5,
                               err_msg='tau_beta')
    if K == 1:
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6, err_msg='pi')
    else:
        total = w[2].sum(axis=-1, keepdims=True)
        assert np.all(np.abs(g[2] - w[2]) <= 2e-5 * np.abs(w[2]) + 1e-5 * total
                      ), ('pi', g[2], w[2])


def fit_mix_both(jds, ds, seed=5, model_kw=None, **fit_kw):
    model_kw = dict(model_kw or {})
    np.random.seed(seed)
    jm = JaxVIPRSMix(jds, mesh='off', **model_kw).fit(sweep_impl='xla',
                                                      **fit_kw)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(seed)
    tm = VIPRSMix(ds, 'cpu', **model_kw).fit(sweep_impl='xla', **fit_kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    return jm, tm


# the settings that stop each fit clear of every threshold, with ELBO
# changes far above the packages' ~1e-4 rounding (at the defaults the K = 3
# fit's ELBO creeps up by ~8e-4 an iteration and never stops)
@pytest.mark.parametrize('K,fit_kw', [
    (1, dict(min_iter=16, f_abs_tol=2e-3)),
    (3, dict(min_iter=6, f_abs_tol=4e-3))])
def test_mix_fit_matches_jax(datasets, ladder_trace, K, fit_kw):
    jm, tm = fit_mix_both(*datasets, model_kw=dict(K=K), max_iter=100,
                          **fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    assert jm.optim_result.success and tm.K == K
    assert tm.optim_result.nit > (fit_kw.get('min_iter', 3) + 1) // 2
    assert_mix_fits_match(jm, tm)
    assert tm.elbo() == pytest.approx(jm.elbo(), rel=1e-6)
    assert tm.mse() == pytest.approx(jm.mse(), rel=1e-5)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_mix_fit_on_float32_ld_matches_jax(ladder_trace):
    """VIPRSMix(K=3) on float32 LD (the JAX package's default packing,
    which VIPRSMix fits on the card with the single-model kernels' float32
    instances) against the JAX package's fit, at
    test_mix_fit_matches_jax's K = 3 settings."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), quantize=False)
    assert ds.ld.diag.dtype == torch.float32
    jm, tm = fit_mix_both(jds, ds, model_kw=dict(K=3), max_iter=100,
                          min_iter=6, f_abs_tol=4e-3)
    assert_clear_of_thresholds(ladder_trace)
    assert jm.optim_result.success and tm.K == 3
    assert_mix_fits_match(jm, tm)
    assert tm.elbo() == pytest.approx(jm.elbo(), rel=1e-6)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_mix_restart_on_negative_mse_matches_jax(ladder_trace):
    """Marginal betas scaled 3x drive the MSE negative: the fit restarts
    once with sigma_epsilon fixed at 0.95 and a fresh initial draw, and the
    history is the second run's only (viprs_tpu model/mix.py:511-556)."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), scale=3.0)
    jm, tm = fit_mix_both(jds, ds, model_kw=dict(K=3), max_iter=60)
    assert_clear_of_thresholds(ladder_trace)
    assert len(ladder_trace.calls) == 2
    assert tm.fix_params == {'sigma_epsilon': 0.95}
    assert tm.sigma_epsilon == pytest.approx(0.95, rel=1e-7)
    assert_mix_fits_match(jm, tm)
    assert len(tm.history['ELBO']) == tm.optim_result.nit + 1


@pytest.mark.parametrize('fix_params,fit_kw', [
    ({'pis': [0.01, 0.005, 0.002]}, dict(min_iter=4, f_abs_tol=3e-3)),
    ({'tau_betas': [4000.0, 2000.0, 1000.0], 'sigma_epsilon': 0.7},
     dict(min_iter=14, f_abs_tol=3e-3)),
    ({'pi': 0.02}, dict(min_iter=13, f_abs_tol=8e-3))])
def test_pinned_params_match_jax(datasets, ladder_trace, fix_params, fit_kw):
    """Pinned pi (per component, or the total renormalised in the M-step),
    tau_beta and sigma_epsilon through the whole fit (each with settings
    that stop it clear of every threshold)."""
    jm, tm = fit_mix_both(*datasets, model_kw=dict(
        K=3, fix_params=dict(fix_params)), max_iter=100, **fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    assert_mix_fits_match(jm, tm)
    for k, v in fix_params.items():
        got = {'pis': tm.pi, 'tau_betas': tm.tau_beta,
               'sigma_epsilon': tm.sigma_epsilon,
               'pi': tm.get_proportion_causal()}[k]
        np.testing.assert_allclose(got, v, rtol=1e-6)
    jt, tt = jm.to_theta_table(), tm.to_table()
    assert len(tt) == tm.m and list(jt['Parameter'])[0] == 'ELBO'


def test_skip_em_fit_matches_jax(datasets, interpret, ladder_trace):
    """mix_em_fit with the activity-gated sweep (K6's rule, the VIPRSMix
    default) against the JAX package's mix_em_fit(use_skip=True), whose
    Pallas skip kernel runs in interpret mode, from the same initial state."""
    jds, ds = datasets
    np.random.seed(5)
    jm = JaxVIPRSMix(jds, K=3, mesh='off')
    jm.initialize()
    np.random.seed(5)
    tm = VIPRSMix(ds, 'cpu', K=3)
    tm.initialize()
    kw = dict(n_sample=float(ds.n), m_total=float(ds.m), max_iter=30,
              min_iter=6, f_abs_tol=4e-3)
    want = jax_mel.mix_em_fit(
        jm._ld, jm._state, jm._std_beta_flat, jm._n_flat, jm._hyper_f32(),
        jm._mix_fix(), jnp.asarray(jm.d, jnp.float32), init_elbo=None,
        use_skip=True, **kw)
    assert_clear_of_thresholds(ladder_trace)
    got = mix_em_loop.mix_em_fit(ds.ld, tm._state, *ds.device_inputs(),
                                 tm._hyper, tm._mix_fix(), tm.d,
                                 use_skip=True, **kw)
    n = int(want.nit)
    assert got.nit == n and got.status == int(want.status)
    np.testing.assert_allclose(got.elbo_hist,
                               np.asarray(want.elbo_hist)[:n + 1], rtol=1e-6)
    assert_hyper_close(got.hyper, want.hyper, 3)
    np.testing.assert_allclose(got.state.eta.numpy(),
                               np.asarray(want.state.eta), atol=1e-6, rtol=0)
    assert 0 < min(got.act_hist[1:]) <= ds.ld.nb


def test_continued_fit_from_jax_state_matches_jax(datasets, ladder_trace):
    """The JAX package's state and hyperparameters after 5 iterations,
    carried into the port (``set_state``); both then continue the fit."""
    jds, ds = datasets
    np.random.seed(5)
    jm = JaxVIPRSMix(jds, K=3, mesh='off').fit(max_iter=5, sweep_impl='xla',
                                               f_abs_tol=1e-12)
    assert jm.optim_result.nit == 5
    tm = VIPRSMix(ds, 'cpu', K=3)
    tm.set_state([np.asarray(x) for x in jm._state],
                 [np.asarray(x) for x in jm._hyper], jm._sigma_g)
    assert tm.elbo() == pytest.approx(jm.elbo(), rel=1e-6)
    kw = dict(max_iter=50, min_iter=1, f_abs_tol=4e-3, continued=True,
              sweep_impl='xla')
    jm.fit(**kw)
    tm.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    assert_mix_fits_match(jm, tm)


def fit_grid_both(jds, ds, spec, K, seed=5, **fit_kw):
    """The same mixture grid fitted by both packages from one np.random
    seed; returns (jax model, port model)."""
    np.random.seed(seed)
    jm = JaxVIPRSMixGrid(jds, JaxGrid(n_snps=jds.m, **spec), K=K, mesh='off')
    jm.fit(**fit_kw)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(seed)
    tm = VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m, **spec), 'cpu',
                      K=K)
    tm.fit(**fit_kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    return jm, tm


def jax_widths(trace):
    """The lane width of each mix_em_fit_batch call the trace recorded."""
    return [np.asarray(c['res'].elbo_hist).shape[1] for c in trace.calls
            if c['kind'] == 'mix_batch']


def chunk_widths(model):
    """The lane width of each loop call of the port's fit."""
    return [c.width for c in model.fit_counters.chunks]


def assert_grid_end_points_match(jm, tm, nit_window=3):
    """Per-lane end points of grid fits whose stops may land on either side
    of a threshold: the final ELBO within rtol 1e-6, h2 within 1e-5, PIP
    within 1e-4 (absolute), the iterations within ``nit_window`` and each
    status the JAX run's or, for both, one of CONVERGED_F and CONVERGED_X."""
    j_nit = np.array([r.nit for r in jm.optim_results])
    t_nit = np.array([r.nit for r in tm.optim_results])
    assert np.abs(t_nit - j_nit).max() <= nit_window, (t_nit, j_nit)
    pair = {opt.STATUS_MESSAGES[opt.CONVERGED_F],
            opt.STATUS_MESSAGES[opt.CONVERGED_X]}
    for a, b in zip(tm.optim_results, jm.optim_results):
        assert a.message == b.message or {a.message, b.message} <= pair
    np.testing.assert_allclose(tm.elbo(), np.asarray(jm.elbo()), rtol=1e-6)
    np.testing.assert_allclose(tm.get_heritability(), jm.get_heritability(),
                               rtol=0, atol=1e-5)
    for c in tm.chromosomes:
        np.testing.assert_allclose(tm.pip[c], jm.pip[c], atol=1e-4, rtol=0)


def assert_mix_grids_match(jm, tm, lanes=slice(None)):
    """Per-lane iterations, messages and final ELBO exactly or at their
    tolerances; hyperparameters, h2 and PIP on ``lanes``."""
    assert [r.nit for r in tm.optim_results] == \
        [r.nit for r in jm.optim_results]
    assert [r.message for r in tm.optim_results] == \
        [r.message for r in jm.optim_results]
    np.testing.assert_allclose(tm.elbo(), np.asarray(jm.elbo()), rtol=1e-6)
    assert tm.fix_params == jm.fix_params
    assert_hyper_close(tm._hyper, jm._hyper, tm.K, lanes)
    np.testing.assert_allclose(tm.get_heritability()[lanes],
                               jm.get_heritability()[lanes], rtol=1e-6)
    for c in tm.chromosomes:
        assert tm.pip[c].shape == (tm.shapes[c], tm.n_models)
        np.testing.assert_allclose(tm.pip[c][:, lanes], jm.pip[c][:, lanes],
                                   atol=1e-5, rtol=0)
    assert list(tm.validation_result['Converged']) == \
        list(jm.validation_result['Converged'])


def capture(monkeypatch, mod, name):
    """The results of every call the port makes to ``mod.name``."""
    calls = []
    orig = getattr(mod, name)

    def record(*a, **kw):
        calls.append(orig(*a, **kw))
        return calls[-1]
    monkeypatch.setattr(mod, name, record)
    return calls


@pytest.mark.parametrize('grid', [False, True])
def test_mix_final_mse_matches_jax(datasets, ladder_trace, monkeypatch,
                                   grid):
    """MixEMResult.final_mse (the MSE of the last call's final state with
    its final hyperparameters) against the JAX package's single and batch
    loops, on test_mix_fit_matches_jax's and test_mix_grid_matches_jax's
    fits, within the ELBO's rtol 1e-6."""
    got = capture(monkeypatch, mix_em_loop,
                  'mix_em_fit_batch' if grid else 'mix_em_fit')
    if grid:
        fit_grid_both(*datasets, dict(pi_steps=8), 3, max_iter=60,
                      min_iter=5, f_abs_tol=0.2)
    else:
        fit_mix_both(*datasets, model_kw=dict(K=3), max_iter=100, min_iter=6,
                     f_abs_tol=4e-3)
    assert_clear_of_thresholds(ladder_trace)
    want = np.asarray(ladder_trace.calls[-1]['res'].final_mse)
    assert np.shape(got[-1].final_mse) == want.shape == ((8,) if grid else ())
    assert np.all(want > 0)
    np.testing.assert_allclose(got[-1].final_mse, want, rtol=1e-6)


@pytest.mark.parametrize('K,S,chunk_iters', [(3, 8, None), (1, 10, 4)])
def test_mix_grid_matches_jax(datasets, ladder_trace, K, S, chunk_iters):
    """A pi grid of S >= 8 points (the grid's pi is each lane's total). In
    one call (K = 3), min_iter 5 and f_abs_tol 0.2 stop every lane clear of
    every threshold and the fits are held exactly. In chunks of 4 (K = 1,
    the default tolerances) the lanes stop from iteration 6 to 9, the last
    one alone, and the live lanes are compacted 10 -> 1 (the rule of any
    halving) as in the JAX package; some lane then stops within a factor 2
    of a threshold, so the end points are held and the widths compared."""
    spec = dict(pi_steps=S)
    if chunk_iters is None:
        jm, tm = fit_grid_both(*datasets, spec, K, max_iter=60, min_iter=5,
                               f_abs_tol=0.2)
        assert_clear_of_thresholds(ladder_trace)
        assert_mix_grids_match(jm, tm)
        assert chunk_widths(tm) == jax_widths(ladder_trace) == [S]
        assert_fit_counters(tm, [S])
    else:
        jm, tm = fit_grid_both(*datasets, spec, K, max_iter=60,
                               chunk_iters=chunk_iters)
        assert_grid_end_points_match(jm, tm)
        assert_hyper_close(tm._hyper, jm._hyper, K)
        widths = jax_widths(ladder_trace)
        assert widths[0] == S and min(widths) == 1
        assert chunk_widths(tm) == widths
        assert_fit_counters(tm, widths)
    assert tm.n_models == S and len(tm.history['ELBO'][0]) == S
    assert tm.valid_terminated_models.all()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_mix_grid_on_float32_ld_matches_jax(ladder_trace):
    """test_mix_grid_matches_jax's one-call case (K = 3, S = 8) on float32
    LD (the JAX package's default packing, quantize=False): min_iter 5 and
    f_abs_tol 0.2 stop every lane clear of every threshold on float32 LD
    as well (ELBO changes far above the packages' ~1e-4 rounding), and the
    fits are held exactly."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), quantize=False)
    assert ds.ld.diag.dtype == torch.float32 and ds.ld.nb <= 12
    S, K = 8, 3
    jm, tm = fit_grid_both(jds, ds, dict(pi_steps=S), K, max_iter=60,
                           min_iter=5, f_abs_tol=0.2)
    assert_clear_of_thresholds(ladder_trace)
    assert_mix_grids_match(jm, tm)
    assert chunk_widths(tm) == jax_widths(ladder_trace) == [S]
    assert tm.n_models == S and tm.valid_terminated_models.all()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_mix_grid_restart_on_negative_mse_matches_jax(ladder_trace):
    """A 4-point pi grid on betas scaled 1.7x: the MSE goes negative, the
    lanes it hit restart once with sigma_epsilon fixed at 0.95 (which then
    pins it for every lane, as in the JAX package) and their pi and tau_beta
    kept; one lane then converges, the others end on a negative MSE
    again."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), scale=1.7)
    jm, tm = fit_grid_both(jds, ds, dict(pi_steps=4), 3, max_iter=60,
                           min_iter=6, f_abs_tol=4e-3)
    assert_clear_of_thresholds(ladder_trace)
    assert len(jax_widths(ladder_trace)) >= 2
    assert tm.fix_params == {'sigma_epsilon': 0.95}
    ok = tm.converged_models
    assert ok.any() and not ok.all()
    # the lanes that end on a negative MSE again stop in a diverged state
    # (tau_beta ~ 10), which takes rounding far beyond the K = 3 bounds
    assert_mix_grids_match(jm, tm, lanes=ok)
    np.testing.assert_allclose(tm._hyper.sigma_eps, 0.95, rtol=1e-7)


def test_mix_paths_not_ported_raise(datasets):
    _, ds = datasets
    with pytest.raises(ValueError, match='hybrid'):
        VIPRSMix(ds, 'cpu', K=2).fit(sweep_impl='hybrid')
    g = VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3), 'cpu',
                     K=2)
    with pytest.raises(ValueError, match='hybrid'):
        g.fit(sweep_impl='hybrid')
    with pytest.raises(ValueError, match='prior_multipliers'):
        VIPRSMix(ds, 'cpu', K=2, prior_multipliers=[1.0])


def test_mix_imports_without_jax(tmp_path):
    """In a fresh interpreter: importing the mixture models loads neither
    jax nor anything of viprs_tpu, and a CPU fit of each (the skip rule,
    the lane rule) launches no kernel."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import viprs_tpu_torch.model.mix, viprs_tpu_torch.model.mix_grid
        def loaded():
            return 'jax' in sys.modules or any(
                m == 'viprs_tpu' or m.startswith('viprs_tpu.')
                for m in sys.modules)
        assert not loaded()
        from viprs_tpu_torch.data.dataset import SummaryStatsDataset
        from viprs_tpu_torch.gridsearch import HyperparameterGrid
        from viprs_tpu_torch.model import VIPRSMix, VIPRSMixGrid
        from viprs_tpu_torch.ops import cavi_cuda
        rng = np.random.default_rng(0)
        m = 200
        R = 0.5 ** np.abs(np.subtract.outer(np.arange(m), np.arange(m)))
        beta = np.where(rng.random(m) < 0.05, 0.05, 0.0)
        sb = R @ beta + rng.standard_normal(m) / np.sqrt(5000)
        ds = SummaryStatsDataset.from_dense_blocks(
            {1: [R]}, {1: sb}, {1: np.full(m, 5000.0)}, block_size=128,
            quantize=True, device='cpu')
        np.random.seed(0)
        model = VIPRSMix(ds, 'cpu', K=3).fit(max_iter=30)
        assert model.optim_result.nit > 3 and 0 < model.get_heritability() < 1
        grid = HyperparameterGrid(pi_steps=3, n_snps=m)
        g = VIPRSMixGrid(ds, grid, 'cpu', K=2).fit(max_iter=30)
        assert g.get_heritability().shape == (3,)
        assert not any(cavi_cuda.LAUNCHES.values()), cavi_cuda.LAUNCHES
        assert not loaded() and 'pandas' not in sys.modules
        print('ok')
    """)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
