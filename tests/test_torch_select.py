"""The port's model-selection layer against the JAX package's, on the CPU.

The PUMAS split, pseudo-validation (VIPRS, VIPRSGrid, VIPRSMixGrid and
LDPredInf), selection by pseudo-R^2 followed by the restore-and-refit of
``viprs_fit``'s flow, the pathwise grid, the host-stepped VIPRSMix loop,
GridSearch's routing (VIPRSMix grids to VIPRSMixGrid, other classes one fit
per row), LDPredInf, infer_lambda_min, the numpy pieces the port copies,
and the refusals that remain. The same numpy inputs go to both packages;
the port runs the plain versions of the kernels (no launch).

Every problem runs with its LD packed as int8 and as float32 (B = 128: 4
tiles and 2 coupling tiles; B = 256 without coupling tiles where
infer_lambda_min needs them absent). JAX VIPRS fits on the CPU run the
all-active XLA sweep, so the port's S = 1 fits here take
``sweep_impl='xla'`` (the pathwise grid and the host-stepped mixture loop
have that rule of their own).

Tolerances: the split within 1e-12 (the same float64 arithmetic, the
factorizations by torch on the LD's device);
iterations, statuses and messages equal, only on fits whose JAX run the
guard of tests/test_torch_viprs.py finds clear of every stopping threshold
(``host_stepped_trace`` replays the host-stepped mixture loop the same
way); pseudo-R^2 within rtol 1e-5 (float32 state, sums in another order);
final ELBOs and ELBO histories within rtol 1e-6; h2 within 1e-6 (absolute);
posterior means within 1e-6 (absolute; LDPredInf: 1e-6 of the largest);
infer_lambda_min within 1e-9.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.data.split import _block_chol as jax_block_chol
from viprs_tpu.data.split import sumstats_train_test_split as jax_split
from viprs_tpu.eval import pseudo as jax_pseudo
from viprs_tpu.gridsearch import GridSearch as JaxGridSearch
from viprs_tpu.gridsearch import HyperparameterGrid as JaxGrid
from viprs_tpu.gridsearch import select_best_model as jax_select
from viprs_tpu.model import VIPRS as JaxVIPRS
from viprs_tpu.model import VIPRSGrid as JaxVIPRSGrid
from viprs_tpu.model import VIPRSMix as JaxVIPRSMix
from viprs_tpu.model.ldpred_inf import LDPredInf as JaxLDPredInf
from viprs_tpu.model.mix_grid import VIPRSMixGrid as JaxVIPRSMixGrid
from viprs_tpu.utils import optimize as jax_opt

from viprs_tpu_torch.data.split import sumstats_train_test_split
from viprs_tpu_torch.eval import pseudo
from viprs_tpu_torch.gridsearch import (GridSearch, HyperparameterGrid,
                                        select_best_model)
from viprs_tpu_torch.model import (LDPredInf, VIPRS, VIPRSGrid, VIPRSMix,
                                   VIPRSMixGrid)
from viprs_tpu_torch.model import viprs as viprs_mod
from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
from viprs_tpu_torch.utils import optimize as opt

from test_torch_viprs import (REPO, _replay, assert_clear_of_thresholds,
                              both_datasets, flat,
                              ladder_trace)  # noqa: F401

SIM = dict(n=3000, block_sizes=(250, 200), h2=0.35, prop_causal=0.04,
           seed=21)
GRID_8 = dict(pi_steps=4, sigma_epsilon_steps=2, h2_est=0.3, h2_se=0.05)


@pytest.fixture(scope='module', params=['int8', 'float32'])
def pair(request):
    """(JAX dataset, port dataset) of SIM at B = 128 (NB = 4, two coupling
    tiles), the LD packed as int8 or float32."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), block_size=128,
                            quantize=request.param == 'int8')
    assert ds.ld.nb <= 12 and ds.ld.n_off > 0
    return jds, ds


@pytest.fixture(autouse=True)
def no_launches():
    cavi_cuda.reset_launches()
    yield
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def lanes_of(d, chroms):
    return np.concatenate([np.asarray(d[c]) for c in chroms])


def message_code(message):
    codes = {v: k for k, v in opt.STATUS_MESSAGES.items()}
    return opt.MSE_NEGATIVE if message.startswith('The MSE is negative') \
        else codes[message]


# ------------------------------------------------------------------ split
@pytest.mark.parametrize('seed,ld_aware', [(0, True), (3, True), (1, False)])
def test_split_matches_jax(pair, seed, ld_aware):
    """The port's split against viprs_tpu.data.split, same seed, within
    1e-12; and PUMAS's identity n b = n_t b_train + (n - n_t) b_test."""
    jds, ds = pair
    want = jax_split(jds, prop_train=0.8, seed=seed, ld_aware=ld_aware)
    got = sumstats_train_test_split(ds, prop_train=0.8, seed=seed,
                                    ld_aware=ld_aware)
    assert sorted(got) == sorted(want)
    for c in want:
        for k in ('train_beta', 'test_beta'):
            assert got[c][k].dtype == np.float64
            np.testing.assert_allclose(got[c][k], want[c][k], rtol=0,
                                       atol=1e-12)
        n = ds.n_per_snp[c]
        np.testing.assert_allclose(
            0.8 * n * got[c]['train_beta'] + 0.2 * n * got[c]['test_beta'],
            n * ds.std_beta[c], rtol=1e-9)


def test_split_on_a_device_matches_the_host(pair):
    """The factorizations on the LD's device (batched cholesky_ex, padding
    lanes as the identity) against the JAX package's host numpy, within
    1e-12, with one tile that no jitter makes positive definite
    (independent noise) and, on float32 tiles, one that the ladder's second
    step factorizes."""
    jds, ds = pair
    diag = ds.ld.diag.clone()
    diag[1, 0, 1] = diag[1, 1, 0] = diag[1, 0, 0]
    diag[1, 0, 0] = 0
    if diag.dtype == torch.float32:
        real = ds.ld.mask[2] > 0
        sub = diag[2][real][:, real].double()
        low = float(torch.linalg.eigvalsh(sub)[0])
        idx = torch.nonzero(real)[:, 0]
        diag[2, idx, idx] -= np.float32(low + 5e-4)
    bent = dataclasses.replace(ds, ld=dataclasses.replace(ds.ld, diag=diag))
    jbent = dataclasses.replace(jds, ld=dataclasses.replace(
        jds.ld, diag=diag.numpy()))

    def real_block(b):
        real = (ds.ld.mask[b] > 0).numpy()
        return diag[b].double().numpy()[np.ix_(real, real)] * ds.ld.scale
    assert not jax_block_chol(real_block(1))[1]
    if diag.dtype == torch.float32:
        with pytest.raises(np.linalg.LinAlgError):
            np.linalg.cholesky(real_block(2))
        assert jax_block_chol(real_block(2))[1]
    want = jax_split(jbent, prop_train=0.7, seed=5)
    got = sumstats_train_test_split(bent, prop_train=0.7, seed=5)
    for c in want:
        for k in ('train_beta', 'test_beta'):
            np.testing.assert_allclose(got[c][k], want[c][k], rtol=0,
                                       atol=1e-12)


def test_split_refreshes_the_device_inputs(pair):
    """A fresh model takes the dataset's cached input tensors; a split
    model's fit takes its training half (rebuilt from its dicts), and
    ``restore_full_sumstats`` returns to the cached tensors."""
    jds, ds = pair
    m = VIPRS(ds, 'cpu')
    cached = ds.device_inputs()
    assert m._std_beta_flat is cached[0] and m._n_flat is cached[1]
    m.split_gwas_sumstats(prop_train=0.8, seed=2)
    jm = JaxVIPRS(jds, mesh='off')
    jm.split_gwas_sumstats(prop_train=0.8, seed=2)
    for c in m.chromosomes:
        np.testing.assert_allclose(m.std_beta[c], jm.std_beta[c], rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(m.n_per_snp[c], jm.n_per_snp[c])
        np.testing.assert_allclose(m.validation_std_beta[c],
                                   jm.validation_std_beta[c], rtol=0,
                                   atol=1e-12)
    np.random.seed(1)
    m.fit(max_iter=2, sweep_impl='xla')
    lay = ds.layout
    assert m._std_beta_flat is not cached[0]
    np.testing.assert_array_equal(
        m._std_beta_flat.numpy().reshape(-1)[lay.flat_index],
        lay.to_flat(m.std_beta)[lay.flat_index])
    np.testing.assert_array_equal(
        m._n_flat.numpy().reshape(-1)[lay.flat_index],
        np.float32(0.8 * lanes_of(ds.n_per_snp, m.chromosomes)))
    m.restore_full_sumstats()
    assert m.validation_std_beta is None
    m.fit(max_iter=2, sweep_impl='xla')
    assert m._std_beta_flat is cached[0] and m._n_flat is cached[1]


# ---------------------------------------------------------- pseudo-validation
def test_viprs_pseudo_validate_matches_jax(pair, ladder_trace):
    """tests/test_models.py::test_pseudo_validate_internal in both packages:
    the split model's fit, then pseudo-R^2 from the cached q."""
    jds, ds = pair
    kw = dict(max_iter=100, min_iter=15, f_abs_tol=0.05)
    np.random.seed(6)
    jm = JaxVIPRS(jds, mesh='off')
    jm.split_gwas_sumstats(prop_train=0.8, seed=1)
    jm.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(6)
    tm = VIPRS(ds, 'cpu')
    tm.split_gwas_sumstats(prop_train=0.8, seed=1)
    tm.fit(sweep_impl='xla', **kw)
    assert tm.optim_result.nit == jm.optim_result.nit
    assert tm.optim_result.message == jm.optim_result.message
    r2 = tm.pseudo_validate()
    assert isinstance(r2, float) and 0.0 <= r2 <= 1.0
    assert r2 == pytest.approx(jm.pseudo_validate(), rel=1e-5)


def test_grid_selection_flow_matches_jax(pair, ladder_trace):
    """viprs_fit's selection flow (viprs_tpu/cli/fit.py:337-400) in both
    packages: split, grid fit, per-lane pseudo-R^2, select_best_model by
    pseudo-validation, restore the full statistics and refit the selected
    point."""
    jds, ds = pair
    kw = dict(max_iter=200, min_iter=5, f_abs_tol=0.05)
    np.random.seed(12)
    jg = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **GRID_8), mesh='off')
    jg.split_gwas_sumstats(prop_train=0.8, seed=2)
    jg.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(12)
    tg = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_8), 'cpu')
    tg.split_gwas_sumstats(prop_train=0.8, seed=2)
    tg.fit(**kw)
    np.testing.assert_array_equal(tg._last_result.nit,
                                  np.asarray(jg._last_result.nit))
    np.testing.assert_array_equal(tg._last_result.status,
                                  np.asarray(jg._last_result.status))
    scores = tg.pseudo_validate()
    assert scores.shape == (8,)
    np.testing.assert_allclose(scores, np.asarray(jg.pseudo_validate()),
                               rtol=1e-5)

    jax_select(jg, criterion='pseudo_validation')
    select_best_model(tg, criterion='pseudo_validation')
    assert tg.n_models == 1 and tg.fix_params == jg.fix_params
    np.testing.assert_allclose(
        tg.validation_result['Pseudo_Validation_R2'],
        jg.validation_result['Pseudo_Validation_R2'].values, rtol=1e-5)
    assert int(np.argmax(tg.validation_result['Pseudo_Validation_R2'])) == \
        int(np.argmax(jg.validation_result['Pseudo_Validation_R2'].values))

    ladder_trace.calls.clear()
    jg.restore_full_sumstats()
    jg.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    tg.restore_full_sumstats()
    assert tg.validation_std_beta is None
    tg.fit(sweep_impl='xla', **kw)
    assert tg._std_beta_flat is ds.device_inputs()[0]
    assert tg.optim_result.nit == jg.optim_result.nit
    assert tg.optim_result.message == jg.optim_result.message
    assert [r.message for r in tg.optim_results] == \
        [r.message for r in jg.optim_results]
    assert abs(tg.get_heritability() - jg.get_heritability()) <= 1e-6
    np.testing.assert_allclose(flat(tg.post_mean_beta, tg.chromosomes),
                               flat(jg.post_mean_beta, tg.chromosomes),
                               atol=1e-6, rtol=0)


def test_select_pseudo_validation_scores_nonfinite_as_zero(pair):
    """The pseudo-validation argmax takes NaN and infinite scores as 0 (the
    ELBO criterion's argmax does not); invalid lanes score -inf."""
    _, ds = pair
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3), 'cpu')
    g.split_gwas_sumstats(prop_train=0.8, seed=0)
    np.random.seed(0)
    g.fit(max_iter=3)
    g.pseudo_validate = lambda test_gdl=None: np.array([np.nan, -0.5, np.inf])
    select_best_model(g, criterion='pseudo_validation')
    np.testing.assert_array_equal(g.validation_result['Pseudo_Validation_R2'],
                                  [np.nan, -0.5, np.inf])
    assert g.fix_params['pi'] == HyperparameterGrid(
        n_snps=ds.m, pi_steps=3).combine_grids()[0]['pi']


# ------------------------------------------------------------------ pathwise
def test_pathwise_grid_matches_jax(pair, ladder_trace):
    """fit(pathwise=True) (tests/test_models.py::test_pathwise_fit): each
    grid point an S = 1 em_fit warm-started from the previous one."""
    jds, ds = pair
    kw = dict(max_iter=200, min_iter=5, f_abs_tol=0.05)
    np.random.seed(10)
    jg = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **GRID_8), mesh='off')
    jg.fit(pathwise=True, **kw)
    assert_clear_of_thresholds(ladder_trace)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(10)
    tg = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_8), 'cpu')
    tg.fit(pathwise=True, **kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert len(tg.optim_results) == 8
    assert [r.nit for r in tg.optim_results] == \
        [r.nit for r in jg.optim_results]
    assert [r.message for r in tg.optim_results] == \
        [r.message for r in jg.optim_results]
    assert tg.optim_result.nit == jg.optim_result.nit == \
        sum(r.nit for r in jg.optim_results)
    assert tg.optim_result.success == jg.optim_result.success
    np.testing.assert_allclose(tg.validation_result['ELBO'],
                               jg.to_validation_table()['ELBO'].values,
                               rtol=1e-6)
    assert tg.optim_result.fun == pytest.approx(jg.optim_result.fun,
                                                rel=1e-6)
    np.testing.assert_allclose(tg.get_heritability(), jg.get_heritability(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.elbo(), np.asarray(jg.elbo()), rtol=1e-6)
    for c in tg.chromosomes:
        np.testing.assert_allclose(tg.post_mean_beta[c], jg.post_mean_beta[c],
                                   atol=1e-6, rtol=0)


# --------------------------------------------------- host-stepped mixture
@pytest.fixture
def host_stepped_trace(monkeypatch):
    """Record the JAX package's host-stepped VIPRSMix loop iteration by
    iteration (max |d eta| of each sweep, sigma_g after each M-step, the
    MSE) for the guard."""
    import viprs_tpu.model.mix as jmix
    its = []
    orig_sweep, orig_m, orig_mse = (jmix.cavi_sweep_mixture,
                                    JaxVIPRSMix._m_step, JaxVIPRSMix.mse)

    def sweep(*a, **kw):
        state, eta_diff = orig_sweep(*a, **kw)
        its.append({'med': float(np.max(np.abs(np.asarray(eta_diff))))})
        return state, eta_diff

    def m_step(self, stats):
        orig_m(self, stats)
        its[-1]['sg'] = float(self._sigma_g)

    def mse(self, stats=None):
        v = orig_mse(self, stats)
        its[-1]['mse'] = v
        return v
    monkeypatch.setattr(jmix, 'cavi_sweep_mixture', sweep)
    monkeypatch.setattr(JaxVIPRSMix, '_m_step', m_step)
    monkeypatch.setattr(JaxVIPRSMix, 'mse', mse)
    return its


def assert_host_stepped_clear(its, model, f_abs_tol, x_abs_tol, min_iter,
                              patience, restarted=False):
    """The guard of tests/test_torch_viprs.py on one host-stepped mixture
    fit: its ladder has no damping, and its stop must replay clear of every
    threshold to the JAX run's status and iteration. A restart (a negative
    MSE, clear of 0, within min_iter) starts the replay anew after it, from
    the objective and sigma_g before the restarted iteration, as the loop
    does; the loop does not count that iteration."""
    from test_torch_viprs import MSE_CLEAR
    hist = model.history['ELBO']
    assert len(hist) == len(its) + 1
    restarts = [i for i, it in enumerate(its, start=1)
                if it['mse'] <= -MSE_CLEAR][:int(restarted)]
    assert len(restarts) == int(restarted)
    assert all(r <= min_iter for r in restarts)
    first = restarts[0] + 1 if restarts else 1
    seg = dict(f=f_abs_tol, x=x_abs_tol, min_iter=min_iter,
               patience=patience, damping=False, its=[])
    prev = hist[first - 2] if restarts else hist[0]
    sg_prev = its[first - 3]['sg'] if first > 2 else 0.0
    for i in range(first, len(its) + 1):
        it = its[i - 1]
        seg['its'].append(dict(gi=i, prev=prev, curr=hist[i], med=it['med'],
                               d_sg=it['sg'] - sg_prev, mse=it['mse']))
        prev, sg_prev = hist[i], it['sg']
    res = model.optim_result
    want = (message_code(res.message), res.nit + len(restarts))
    assert _replay(seg, 'host-stepped VIPRSMix') == \
        (want if want[0] != opt.MAX_ITER else None)


@pytest.mark.parametrize('K,f_abs_tol', [(1, 2e-3), (2, 2e-2)])
def test_mix_host_stepped_matches_jax(pair, host_stepped_trace, K,
                                      f_abs_tol):
    """VIPRSMix.fit(fused=False) against the JAX package's host-stepped
    loop: iterations, message, the ELBO history, h2 and the posterior."""
    jds, ds = pair
    kw = dict(max_iter=200, min_iter=15, f_abs_tol=f_abs_tol, x_abs_tol=1e-6,
              patience=10)
    np.random.seed(4)
    jm = JaxVIPRSMix(jds, K=K, mesh='off').fit(fused=False, **kw)
    assert_host_stepped_clear(host_stepped_trace, jm, kw['f_abs_tol'],
                              kw['x_abs_tol'], kw['min_iter'],
                              kw['patience'])
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(4)
    tm = VIPRSMix(ds, 'cpu', K=K).fit(fused=False, **kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert tm.optim_result.nit == jm.optim_result.nit
    assert tm.optim_result.message == jm.optim_result.message
    assert tm.optim_result.success == jm.optim_result.success
    assert len(tm.history['ELBO']) == len(jm.history['ELBO'])
    np.testing.assert_allclose(tm.history['ELBO'], jm.history['ELBO'],
                               rtol=1e-6)
    assert abs(tm.get_heritability() - jm.get_heritability()) <= 1e-6
    np.testing.assert_allclose(flat(tm.post_mean_beta, tm.chromosomes),
                               flat(jm.post_mean_beta, tm.chromosomes),
                               atol=1e-6, rtol=0)


def test_mix_host_stepped_restart_matches_jax(host_stepped_trace):
    """A negative MSE re-initializes the host-stepped fit once with
    sigma_epsilon fixed at 0.95 (the betas scaled up three-fold, as the
    restart cases of tests/test_torch_viprs.py); here the MSE goes negative
    again at the next iteration, which stops the fit."""
    jds, ds = both_datasets(simulate_sumstats_blocks(**SIM), scale=3.0,
                            block_size=128)
    kw = dict(max_iter=60, min_iter=5, f_abs_tol=5e-3)
    np.random.seed(4)
    jm = JaxVIPRSMix(jds, K=2, mesh='off').fit(fused=False, **kw)
    assert_host_stepped_clear(host_stepped_trace, jm, 5e-3, 1e-6, 5, 10,
                              restarted=True)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(4)
    tm = VIPRSMix(ds, 'cpu', K=2).fit(fused=False, **kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert jm.fix_params.get('sigma_epsilon') == 0.95
    assert tm.fix_params == jm.fix_params and tm.sigma_epsilon == 0.95
    assert len(tm.history['ELBO']) == len(jm.history['ELBO'])
    np.testing.assert_allclose(tm.history['ELBO'], jm.history['ELBO'],
                               rtol=1e-6)
    assert tm.optim_result.nit == jm.optim_result.nit
    assert tm.optim_result.success is jm.optim_result.success is False
    assert tm.optim_result.error_on_termination
    head = 'The MSE is negative ('
    assert tm.optim_result.message.startswith(head)
    assert jm.optim_result.message.startswith(head)
    assert float(tm.optim_result.message[len(head):-2]) == pytest.approx(
        float(jm.optim_result.message[len(head):-2]), abs=2e-6)


# ---------------------------------------------------------- mixture grids
def test_mix_grid_selection_matches_jax(pair, ladder_trace):
    """tests/test_models.py::test_pumas_pseudo_validation_selection in both
    packages, then the collapsed model as a fitted VIPRSMix: its objective,
    h2, posterior, pseudo-R^2 (from its cached q) and a refit on the full
    statistics."""
    jds, ds = pair
    spec = dict(pi_steps=3, n_snps=ds.m, h2_est=0.3, h2_se=0.05)
    kw = dict(max_iter=300, min_iter=5, f_abs_tol=0.2)
    np.random.seed(7)
    jg = JaxVIPRSMixGrid(jds, JaxGrid(**spec), K=2, mesh='off')
    jg.split_gwas_sumstats(prop_train=0.8, seed=5)
    jg.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(7)
    tg = VIPRSMixGrid(ds, HyperparameterGrid(**spec), 'cpu', K=2)
    tg.split_gwas_sumstats(prop_train=0.8, seed=5)
    tg.fit(**kw)
    assert [r.nit for r in tg.optim_results] == \
        [r.nit for r in jg.optim_results]
    scores = tg.pseudo_validate()
    assert scores.shape == (3,)
    np.testing.assert_allclose(scores, np.asarray(jg.pseudo_validate()),
                               rtol=1e-5)
    best = select_best_model(tg, criterion='pseudo_validation')
    jax_select(jg, criterion='pseudo_validation')
    assert best is tg and tg.n_models == 1 and isinstance(tg, VIPRSMix)
    assert tg.fix_params == jg.fix_params
    assert tg.optim_result.nit == jg.optim_result.nit
    assert tg.objective() == pytest.approx(jg.objective(), rel=1e-6)
    assert abs(tg.get_heritability() - jg.get_heritability()) <= 1e-6
    ch = tg.chromosomes
    assert tg.post_mean_beta[ch[0]].shape == (ds.shapes[ch[0]],)
    np.testing.assert_allclose(flat(tg.post_mean_beta, ch),
                               flat(jg.post_mean_beta, ch), atol=1e-6, rtol=0)
    np.testing.assert_allclose(flat(tg.pip, ch), flat(jg.pip, ch), atol=1e-5,
                               rtol=0)
    assert tg.pseudo_validate() == pytest.approx(jg.pseudo_validate(),
                                                 rel=1e-5)

    ladder_trace.calls.clear()
    jg.restore_full_sumstats()
    np.random.seed(3)
    jg.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    tg.restore_full_sumstats()
    np.random.seed(3)
    tg.fit(sweep_impl='xla', **kw)
    assert tg.optim_result.nit == jg.optim_result.nit
    assert tg.optim_result.message == jg.optim_result.message
    assert abs(tg.get_heritability() - jg.get_heritability()) <= 1e-6


def test_grid_search_routes_mixtures_to_mix_grid(pair, ladder_trace):
    """tests/test_eval_flows.py::test_mixture_model_grid_is_simultaneous in
    both packages: GridSearch over VIPRSMix fits one VIPRSMixGrid and
    returns the best lane as a VIPRSMix."""
    jds, ds = pair
    kw = dict(max_iter=150, min_iter=5, f_abs_tol=0.2)
    np.random.seed(0)
    jgs = JaxGridSearch(jds, JaxGrid(pi_steps=3, n_snps=jds.m),
                        criterion='ELBO', model_class=JaxVIPRSMix, K=2,
                        mesh='off')
    jbest = jgs.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(0)
    gs = GridSearch(ds, HyperparameterGrid(pi_steps=3, n_snps=ds.m), 'cpu',
                    criterion='training_objective', model_class=VIPRSMix, K=2)
    assert gs._simultaneous and isinstance(gs.model, VIPRSMixGrid)
    best = gs.fit(**kw)
    assert isinstance(best, VIPRSMix) and best.n_models == 1
    assert best.post_mean_beta is not None
    elbo = gs.validation_result['ELBO']
    assert len(elbo) == 3 and np.isfinite(elbo).all()
    np.testing.assert_allclose(elbo, jgs.validation_result['ELBO'].values,
                               rtol=1e-6)
    assert best.objective() == pytest.approx(elbo[int(np.argmax(elbo))],
                                             rel=1e-6)
    assert best.fix_params == jbest.fix_params


def test_grid_search_fits_other_classes_per_row(pair, ladder_trace):
    """tests/test_eval_flows.py::test_pathwise_fallback_any_model_class in
    both packages: a model class that is no grid is fitted once per grid
    row with the row pinned in fix_params, each scored by its ELBO."""
    jds, ds = pair
    kw = dict(max_iter=150, min_iter=5, f_abs_tol=0.05)
    np.random.seed(0)
    jgs = JaxGridSearch(jds, JaxGrid(pi_steps=3, n_snps=jds.m),
                        criterion='ELBO', model_class=JaxVIPRS, mesh='off')
    jbest = jgs.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(0)
    gs = GridSearch(ds, HyperparameterGrid(pi_steps=3, n_snps=ds.m), 'cpu',
                    criterion='ELBO', model_class=VIPRS)
    assert not gs._simultaneous
    best = gs.fit(sweep_impl='xla', **kw)
    assert type(best) is VIPRS and best.device == torch.device('cpu')
    assert best.fix_params == jbest.fix_params
    assert best.optim_result.nit == jbest.optim_result.nit
    np.testing.assert_allclose(gs.validation_result['pi'],
                               jgs.validation_result['pi'].values)
    np.testing.assert_allclose(gs.validation_result['ELBO'],
                               jgs.validation_result['ELBO'].values,
                               rtol=1e-6)


@pytest.mark.parametrize('device,error,raised', [
    ('cuda', RuntimeError('CUDA error: an illegal memory access'), True),
    ('cuda', FloatingPointError('overflow in a row'), False),
    ('cpu', RuntimeError('a row that failed'), False)],
    ids=['card-runtime', 'card-other', 'cpu-runtime'])
def test_grid_search_per_row_raises_device_errors(device, error, raised):
    """A row whose fit raises scores -inf and the search goes on, except a
    RuntimeError on the card (a CUDA error, or a kernel that could not be
    built or launched), which the search raises. No model runs: the class
    fails its first row and scores the others by -pi."""

    class FirstRowFails:
        made = 0

        def __init__(self, dataset, dev, fix_params):
            self.fix_params = fix_params
            self.fails = FirstRowFails.made == 0
            FirstRowFails.made += 1

        def fit(self, **kw):
            if self.fails:
                raise error
            return self

        def objective(self):
            return -float(self.fix_params['pi'])

    gs = GridSearch(None, HyperparameterGrid(pi_steps=3, n_snps=1000),
                    device, criterion='ELBO', model_class=FirstRowFails)
    if raised:
        with pytest.raises(RuntimeError, match='CUDA error'):
            gs.fit()
        return
    best = gs.fit()
    scores = gs.validation_result['ELBO']
    pis = gs.validation_result['pi']
    assert scores[0] == -np.inf and np.isfinite(scores[1:]).all()
    np.testing.assert_array_equal(scores[1:], -pis[1:])
    assert best.fix_params['pi'] == pis[1:].min()


# ---------------------------------------------------------------- LDPredInf
@pytest.mark.parametrize('h2', [None, 0.2])
def test_ldpred_inf_matches_jax(pair, h2):
    """The CG solve against the JAX package's jax.scipy cg, then its
    pseudo-R^2 on a split (no cached q: compute_q of the posterior means)."""
    jds, ds = pair
    jm = JaxLDPredInf(jds, h2=h2).fit()
    tm = LDPredInf(ds, 'cpu', h2=h2).fit()
    assert tm.get_heritability() == jm.get_heritability()
    want = flat(jm.post_mean_beta, tm.chromosomes)
    got = flat(tm.post_mean_beta, tm.chromosomes)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert 0 < tm.cg_iterations < 500 and tm.cg_relative_residual <= 1e-6
    jm.split_gwas_sumstats(prop_train=0.8, seed=4)
    tm.split_gwas_sumstats(prop_train=0.8, seed=4)
    jm.fit()
    tm.fit()
    assert tm.pseudo_validate() == pytest.approx(jm.pseudo_validate(),
                                                 rel=1e-5)


def test_compute_q_of_float64_matches_jax(pair):
    """compute_q of a float64 vector, the product LDPredInf's CG runs, as
    the JAX package computes it under x64: float32 tile products, float64
    unit diagonal and coupling sums."""
    import jax.numpy as jnp
    from viprs_tpu.ops.cavi_jax import compute_q as jax_compute_q
    jds, ds = pair
    lay = ds.layout
    x = np.random.default_rng(0).standard_normal((1, lay.nb, lay.block_size))
    x *= lay.mask()[None]
    want = np.asarray(jax_compute_q(jds.ld, jnp.asarray(x, jnp.float64)))
    got = cavi_torch.compute_q(ds.ld, torch.from_numpy(x))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # the float32 path is unchanged: float32 in, float32 out
    got32 = cavi_torch.compute_q(ds.ld, torch.from_numpy(x.astype(np.float32)))
    assert got32.dtype == torch.float32


# --------------------------------------------------------- infer_lambda_min
@pytest.mark.parametrize('quantize', [True, False], ids=['int8', 'float32'])
@pytest.mark.parametrize('block_size', [128, 256],
                         ids=['coupled', 'block-diagonal'])
def test_infer_lambda_min_matches_jax(quantize, block_size, monkeypatch):
    """Gershgorin row bound with coupling tiles (B = 128), each tile's
    eigenvalues without (B = 256: every LD block fits one tile); three tiles
    at a time, so that the chunks cross tile boundaries."""
    monkeypatch.setattr(viprs_mod, 'LAMBDA_CHUNK', 3)
    sim = simulate_sumstats_blocks(**SIM)
    jds, ds = both_datasets(sim, block_size=block_size, quantize=quantize)
    assert (ds.ld.n_off > 0) == (block_size == 128)
    want = JaxVIPRS(jds, mesh='off').infer_lambda_min()
    got = VIPRS(ds, 'cpu').infer_lambda_min()
    assert abs(got - want) <= 1e-9
    if block_size == 256:
        # an indefinite tile: its smallest eigenvalue sets lambda_min
        diag = ds.ld.diag.clone()
        diag[1, 0, 1] = diag[1, 1, 0] = diag[1, 0, 0]
        diag[1, 0, 0] = 0
        bent = dataclasses.replace(ds, ld=dataclasses.replace(ds.ld,
                                                              diag=diag))
        w = np.linalg.eigvalsh(diag[1].double().numpy() * ds.ld.scale)[0]
        assert w < 0
        assert VIPRS(bent, 'cpu').infer_lambda_min() == \
            pytest.approx(-w, abs=1e-9)


# ---------------------------------------------------------- copied pieces
def test_copied_numpy_pieces_match_the_originals():
    """_streamlined_pseudo_r2, IterationConditionCounter and
    OptimizeResult.update are copies of the JAX package's numpy code."""
    rng = np.random.default_rng(3)
    v, b, w = rng.standard_normal(50), rng.standard_normal(50), \
        rng.standard_normal(50)
    assert pseudo._streamlined_pseudo_r2(v, b, w) == \
        jax_pseudo._streamlined_pseudo_r2(v, b, w)
    B, W = rng.standard_normal((50, 4)), rng.standard_normal((50, 4))
    np.testing.assert_array_equal(pseudo._streamlined_pseudo_r2(v, B, W),
                                  jax_pseudo._streamlined_pseudo_r2(v, B, W))
    mine, theirs = opt.IterationConditionCounter(), \
        jax_opt.IterationConditionCounter()
    for cond, it in [(True, 1), (True, 2), (False, 3), (True, 4), (True, 6),
                     (True, 7), (True, 8)]:
        mine.update(cond, it)
        theirs.update(cond, it)
        assert mine.counter == theirs.counter
    a, z = opt.OptimizeResult(), jax_opt.OptimizeResult()
    for r in (a, z):
        r.reset()
    for fun, kw in [(1.0, {}), (0.5, {}), (0.2, {}), (0.3, {}), (0.1, {}),
                    (0.05, dict(stop_iteration=True, success=False,
                                message='The MSE is negative (-0.1).')),
                    (0.05, dict(stop_iteration=True, success=False,
                                message=opt.STATUS_MESSAGES[opt.MAX_ITER],
                                increment=False))]:
        a.update(fun, **kw)
        z.update(fun, **kw)
        assert (a.nit, a.fun, a.success, a.stop_iteration, a.message,
                a.error_on_termination, a.oscillation_counter,
                a.valid_optim_result) == \
            (z.nit, z.fun, z.success, z.stop_iteration, z.message,
             z.error_on_termination, z.oscillation_counter,
             z.valid_optim_result)


# ----------------------------------------------------------------- refusals
def test_refusals_that_remain(pair):
    """What this port refuses: the 'validation' criterion without
    validation data (ported since scoring and evaluation are); and the
    arguments that are wrong. The table form of the
    validation statistics and a test dataset are ported: a test dataset
    gives the JAX package's pseudo-R^2 of the same table."""
    _, ds = pair
    m = VIPRS(ds, 'cpu')
    with pytest.raises(TypeError, match='SumstatsTable'):
        m.set_validation_sumstats(object())
    with pytest.raises(ValueError, match='wrong length'):
        m.set_validation_sumstats({c: np.zeros(3) for c in m.chromosomes})
    with pytest.raises(ValueError, match='split_gwas_sumstats'):
        m.pseudo_validate()
    m.set_validation_sumstats(dict(ds.std_beta))
    np.random.seed(0)
    m.fit(max_iter=3, sweep_impl='xla')
    assert np.isfinite(m.pseudo_validate())
    jds, _ = pair
    table = m.to_table()
    want = jax_pseudo.pseudo_r2(jds, table.to_pandas())
    np.testing.assert_allclose(m.pseudo_validate(test_gdl=ds), want,
                               rtol=1e-6)
    for fn, jfn in ((pseudo.pseudo_r2, jax_pseudo.pseudo_r2),
                    (pseudo.pseudo_pearson_r, jax_pseudo.pseudo_pearson_r)):
        np.testing.assert_allclose(fn(ds, table),
                                   jfn(jds, table.to_pandas()), rtol=1e-6)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=2), 'cpu')
    with pytest.raises(ValueError, match='validation dataset must be'):
        select_best_model(g, criterion='validation')
    # the validation criterion is ported (tests/test_torch_score.py): a
    # GridSearch takes it, and one without validation data fails at the
    # selection, as the JAX package's does
    gs = GridSearch(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=2), 'cpu',
                    criterion='validation')
    assert gs.criterion == 'validation'
    np.random.seed(0)
    with pytest.raises(ValueError, match='validation dataset must be'):
        gs.fit(max_iter=3)
    with pytest.raises(ValueError, match='criterion'):
        select_best_model(g, criterion='R2')
    with pytest.raises(ValueError, match='pseudo_validation'):
        select_best_model(g, criterion='pseudo_validation')
    with pytest.raises(ValueError, match="'cg'"):
        LDPredInf(ds, 'cpu', h2=0.3).fit(solver='minres')
    with pytest.raises(TypeError):
        g.fit(pathwise=True, sweep_impl='skip')


def test_selection_modules_import_without_jax():
    """In a fresh interpreter the new modules load neither jax nor anything
    of viprs_tpu."""
    code = textwrap.dedent("""
        import sys
        import viprs_tpu_torch.data.split, viprs_tpu_torch.eval.pseudo
        import viprs_tpu_torch.model.ldpred_inf, viprs_tpu_torch.model.grid
        import viprs_tpu_torch.model.mix_grid
        import viprs_tpu_torch.gridsearch.search
        from viprs_tpu_torch.model import LDPredInf
        from viprs_tpu_torch.eval import pseudo_r2
        bad = [k for k in sys.modules
               if k == 'jax' or k.startswith(('jax.', 'viprs_tpu.'))
               or k == 'viprs_tpu']
        assert not bad, bad
    """)
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)
