"""The port's model grid (VIPRSGrid, selection, BMA) against the JAX
package's, on the CPU.

``VIPRSGrid(ds, grid, device='cpu')`` runs the plain versions of the lane
kernels; the JAX package's ``VIPRSGrid(ds, grid, mesh='off')`` on the CPU
runs its all-active XLA sweep. Both start from the same np.random stream.

Tolerances: per-lane iterations and status codes, the chunk widths and the
np.random stream must be equal; the final ELBO within rtol 1e-6 (terms of
~1e3-1e4 summed from float32 statistics), hyperparameters within rtol 1e-6,
PIP within 1e-5 (absolute). Iterations and statuses are compared exactly
only where the guard of tests/test_torch_viprs.py finds every lane of the
JAX run clear of every stopping threshold. The fits whose purpose needs
lanes that stop at different iterations (the chunked and the compacted
grids) cannot be made clear: there the end points are held instead
(``assert_grid_end_points_match``).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.gridsearch import HyperparameterGrid as JaxGrid
from viprs_tpu.gridsearch import (bayesian_model_average as jax_bma,
                                  select_best_model as jax_select)
from viprs_tpu.model import VIPRSGrid as JaxVIPRSGrid

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.gridsearch import (GridSearch, HyperparameterGrid,
                                        bayesian_model_average,
                                        select_best_model)
from viprs_tpu_torch.model import VIPRSGrid
from viprs_tpu_torch.ops import cavi_cuda
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
from viprs_tpu_torch.ops.updates import FixMask
from viprs_tpu_torch.utils import optimize as opt
from viprs_tpu_torch.utils.optimize import summarize_statuses

from test_torch_viprs import (assert_clear_of_thresholds,  # noqa: F401
                              ladder_trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_GRID = dict(pi_steps=20, sigma_epsilon_steps=5, n_snps=1_099_965,
                  h2_est=0.25, h2_se=0.05)


def both_datasets(seed, n, block_sizes, h2, block_size, scale=1.0,
                  null_tail=0, quantize=True):
    """One simulated problem in both packages, its LD packed as int8 (or
    float32 with ``quantize=False``); ``null_tail`` zeroes the marginal
    betas of that many trailing variants."""
    sim = simulate_sumstats_blocks(n=n, block_sizes=block_sizes, h2=h2,
                                   prop_causal=0.04, seed=seed)
    sb = {c: scale * v for c, v in sim['std_beta'].items()}
    for v in sb.values():
        v[len(v) - null_tail:] = 0.0
    args = (sim['ld_blocks'], sb, sim['n_per_snp'])
    return (JaxDataset.from_dense_blocks(*args, block_size=block_size,
                                         quantize=quantize),
            SummaryStatsDataset.from_dense_blocks(
                *args, block_size=block_size, quantize=quantize,
                device='cpu'))


def fit_both(jds, ds, spec, seed=9, **fit_kw):
    """The same grid fitted by both packages from one np.random seed;
    returns (jax model, port model); asserts the streams end equal."""
    np.random.seed(seed)
    jm = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **spec), mesh='off')
    jm.fit(**fit_kw)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(seed)
    tm = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **spec), 'cpu')
    tm.fit(**fit_kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    return jm, tm


def assert_grids_match(jm, tm, pip=True):
    jr, tr = jm._last_result, tm._last_result
    np.testing.assert_array_equal(tr.nit, np.asarray(jr.nit))
    np.testing.assert_array_equal(tr.status, np.asarray(jr.status))
    np.testing.assert_allclose(tr.final_elbo, np.asarray(jr.final_elbo),
                               rtol=1e-6)
    assert tm.fit_counters.outer_widths == [w for w, *_ in jm._chunk_trace]
    assert tm.fix_params == jm.fix_params
    for f in ('sigma_eps', 'tau_beta', 'pi', 'lambda_min'):
        np.testing.assert_allclose(getattr(tm._hyper, f),
                                   np.asarray(getattr(jm._hyper, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(tm.get_heritability(), jm.get_heritability(),
                               rtol=1e-6)
    assert [r.message for r in tm.optim_results] == \
        [r.message for r in jm.optim_results]
    if pip:
        for c in tm.chromosomes:
            assert tm.pip[c].shape == (tm.shapes[c], tm.n_models)
            np.testing.assert_allclose(tm.pip[c], jm.pip[c], atol=1e-5,
                                       rtol=0)


def assert_fit_counters(tm, widths=None, sub_chunks=False):
    """The port's ``fit_counters`` of a fit with no restart: the widths
    the chunk rule chose (the JAX package's chunk trace where given), each
    loop call's width (``assert_loop_call_widths``), every running lane
    counted once an iteration (its nit) and padding never, each call's
    width swept every iteration, a compaction for each call narrower than
    the grid, and one host read an iteration and one for the first call's
    objective."""
    fc = tm.fit_counters
    if widths is not None:
        assert fc.outer_widths == list(widths)
    assert_loop_call_widths(tm, sub_chunks)
    assert fc.live_lane_sweeps == sum(r.nit for r in tm.optim_results) == \
        sum(c.live_lane_iterations for c in fc.chunks)
    assert fc.lane_sweeps == sum(c.width * c.iterations for c in fc.chunks)
    assert fc.compactions == sum(c.width < tm.n_models for c in fc.chunks)
    assert fc.host_reads == sum(c.iterations for c in fc.chunks) + 1
    assert fc.lane_sweeps >= fc.live_lane_sweeps


def assert_call_widths(calls, outer, nit, grid_axis=1):
    """The loop calls ([width, iterations, chunk index]) of a default
    grid fit: each call's width is the lanes running at its start (a lane
    runs after iteration t while its nit exceeds t), never under two in a
    chunk of two or more, rounded up to a multiple of the mesh's grid
    axis, and at most its chunk's width."""
    nit = np.array(nit)
    t0 = 0
    for width, iters, k in calls:
        want = max(int((nit > t0).sum()), min(2, outer[k]))
        want = min(len(nit), -(-want // grid_axis) * grid_axis)
        assert width == want <= outer[k], (calls, outer, t0)
        t0 += iters
    assert t0 == nit.max()


def assert_loop_call_widths(tm, sub_chunks):
    """Each chunk's loop calls, in order and back to back: one call at the
    chunk's width, or with ``sub_chunks`` calls at their running lanes'
    width (``assert_call_widths``)."""
    fc = tm.fit_counters
    assert [c.outer for c in fc.chunks] == sorted(c.outer for c in fc.chunks)
    assert {c.outer for c in fc.chunks} == set(range(len(fc.outer_widths)))
    if sub_chunks:
        assert_call_widths([[c.width, c.iterations, c.outer]
                            for c in fc.chunks], fc.outer_widths,
                           [r.nit for r in tm.optim_results])
    else:
        assert [c.width for c in fc.chunks] == fc.outer_widths


def assert_grid_end_points_match(jm, tm, nit_window=3):
    """Per-lane end points of two grid fits whose stops may land on either
    side of a threshold: the final ELBO within rtol 1e-6, h2 within 1e-5,
    PIP within 1e-4 (absolute), the iterations within ``nit_window`` and
    each status the JAX run's or, for both, one of CONVERGED_F and
    CONVERGED_X."""
    jr, tr = jm._last_result, tm._last_result
    j_nit, j_st = np.asarray(jr.nit), np.asarray(jr.status)
    assert np.abs(tr.nit - j_nit).max() <= nit_window, (tr.nit, j_nit)
    either = {opt.CONVERGED_F, opt.CONVERGED_X}
    for a, b in zip(tr.status, j_st):
        assert a == b or {int(a), int(b)} <= either, (tr.status, j_st)
    np.testing.assert_allclose(tr.final_elbo, np.asarray(jr.final_elbo),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.get_heritability(), jm.get_heritability(),
                               rtol=0, atol=1e-5)
    for c in tm.chromosomes:
        np.testing.assert_allclose(tm.pip[c], jm.pip[c], atol=1e-4, rtol=0)


@pytest.fixture(scope='module')
def datasets():
    return both_datasets(21, 3000, (250, 200), 0.35, 128)


GRID_12 = dict(pi_steps=4, sigma_epsilon_steps=3, h2_est=0.3, h2_se=0.05)


@pytest.mark.parametrize('spec', [
    BENCH_GRID, GRID_12, dict(pi_steps=16, n_snps=5000),
    dict(tau_beta_steps=3, lambda_min_steps=2, h2_est=0.2, n_snps=10_000),
    dict(pi_grid=[0.01, 0.1], sigma_epsilon_grid=[0.6, 0.8])])
def test_combine_grids_matches_jax(spec):
    rows, jrows = (HyperparameterGrid(**spec).combine_grids(),
                   JaxGrid(**spec).combine_grids())
    assert rows == jrows
    if spec is BENCH_GRID:
        assert len(rows) == 100


@pytest.mark.parametrize('chunk_iters', [None, 7])
def test_grid_fit_matches_jax(datasets, chunk_iters, ladder_trace,
                              monkeypatch):
    """The 12-point pi x sigma_epsilon grid, in one call and in chunks of
    7 iterations (the ladder's counters carried across).

    In one call, min_iter 7 and f_abs_tol 3e-3 stop every lane on the ELBO
    clear of every threshold, and the fits are held exactly. In chunks of 7
    at the default tolerances, lanes stop from iteration ~10 to ~40 and
    some lane ends within rounding of a
    threshold: the end points are held, and the ladder's counters carried
    into the second chunk must be the JAX package's."""
    from viprs_tpu_torch.ops import em_loop
    chunks = []
    orig = em_loop.em_fit
    monkeypatch.setattr(em_loop, 'em_fit',
                        lambda *a, **kw: chunks.append(orig(*a, **kw))
                        or chunks[-1])
    if chunk_iters is None:
        jm, tm = fit_both(*datasets, GRID_12, max_iter=200, min_iter=7,
                          f_abs_tol=3e-3)
        assert_clear_of_thresholds(ladder_trace)
        assert_grids_match(jm, tm)
        assert_fit_counters(tm, [w for w, *_ in jm._chunk_trace],
                            sub_chunks=True)
    else:
        jm, tm = fit_both(*datasets, GRID_12, max_iter=200,
                          chunk_iters=chunk_iters)
        assert_grid_end_points_match(jm, tm)
        assert_fit_counters(tm)
        # the counters after the first chunk: those of the ladder's
        # thresholds exactly, the best ELBO at the ELBO's tolerance, and the
        # ELBO-drop flag on the lanes whose last ELBO change is clear of the
        # two packages' ~1e-4 rounding (the oscillation and stall counters
        # count such signs; the damping they drive is compared)
        jres = ladder_trace.calls[0]['res']
        jc, tc = jres.counters, chunks[0].counters
        for f in ('sigma_g_counter', 'div_counter', 'damping'):
            np.testing.assert_array_equal(getattr(tc, f),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tc.best_elbo, np.asarray(jc.best_elbo),
                                   rtol=1e-6)
        hist = np.asarray(jres.elbo_hist)
        clear = np.abs(hist[chunk_iters] - hist[chunk_iters - 1]) >= 1e-3
        np.testing.assert_array_equal(tc.prev_dropped[clear],
                                      np.asarray(jc.prev_dropped)[clear])
        assert len(tm.fit_counters.chunks) > 1
    assert tm.n_models == 12 and len(tm.fit_counters.chunks) >= 1
    assert tm.converged_models.all()
    vt = tm.validation_result
    np.testing.assert_array_equal(vt['ELBO'], tm._last_result.final_elbo)
    assert list(vt['Converged']) == list(jm.validation_result['Converged'])
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_compacted_grid_matches_jax():
    """A 16-point pi grid in chunks of 2 iterations: the live lanes are
    compacted to widths 4 and 1 (frozen duplicates fill a width), as in the
    JAX package. ``sweep_impl='xla'`` keeps a width-1 chunk on the
    all-active sweep in both packages. Compaction needs lanes that stop
    far apart, which no setting finds clear of every threshold, so the end
    points are held."""
    jds, ds = both_datasets(7, 3000, (250, 200), 0.4, 128)
    jm, tm = fit_both(jds, ds, dict(pi_steps=16), max_iter=150,
                      chunk_iters=2, sweep_impl='xla')
    for widths in ([c.width for c in tm.fit_counters.chunks],
                   [w for w, *_ in jm._chunk_trace]):
        assert widths[0] == 16 and min(widths) == 1
    assert 'sigma_epsilon' not in tm.fix_params     # no lane restarted
    assert_fit_counters(tm)
    assert_grid_end_points_match(jm, tm)
    for f in ('sigma_eps', 'tau_beta', 'pi', 'lambda_min'):
        np.testing.assert_allclose(getattr(tm._hyper, f),
                                   np.asarray(getattr(jm._hyper, f)),
                                   rtol=1e-5, err_msg=f)


def high_ld_dataset(seed, n, h2, prop, rho):
    """A problem of the port alone whose lanes stop far apart: strong LD
    (AR(1) ``rho``) in blocks of at most B = 128 variants, so no coupling
    tile (the plain coupling pass's products round by the lane count under
    8 lanes on the CPU; the card's kernel does not)."""
    from viprs_tpu_torch.data.simulate import simulate_sumstats_blocks as sim
    s = sim(n=n, block_sizes=(120, 100, 90, 128, 60, 110, 128, 80), h2=h2,
            prop_causal=prop, rho=rho, seed=seed)
    return SummaryStatsDataset.from_dense_blocks(
        s['ld_blocks'], s['std_beta'], s['n_per_snp'], block_size=128,
        device='cpu')


SUB_PROBLEMS = [
    # a restart after 4 iterations, chunks at 16 then 4
    dict(seed=1, n=800, h2=0.6, prop=0.2, rho=0.95),
    # chunks at 16, 4 and 1 (the S = 1 rule)
    dict(seed=3, n=5000, h2=0.5, prop=0.1, rho=0.97)]


@pytest.mark.parametrize('problem, callback', [
    (SUB_PROBLEMS[0], False), (SUB_PROBLEMS[1], False),
    (SUB_PROBLEMS[0], True), (SUB_PROBLEMS[1], True)])
def test_sub_chunks_match_one_chunk(problem, callback):
    """A default fit at S = 16, whose chunks (of 50 iterations, or of 25
    with a progress callback) run as loop calls of ``SUB_CHUNK``
    iterations at the width of their running lanes, against the same fit
    in one loop call at full width (``chunk_iters=max_iter``): per-lane
    state, nit, status, ELBO history, hyperparameters and sigma_g bit for
    bit; lanes stop from iteration ~30 to 200. The callback sees every
    chunk's end, after the state is back in lane order."""
    ds = high_ld_dataset(**problem)
    kw = dict(max_iter=200, min_iter=1, f_abs_tol=1e-9, x_abs_tol=1e-9)
    seen = []

    def record(model, it, statuses):
        seen.append((it, model._state.eta.clone(), statuses))

    fits = []
    for chunk_iters in (None, kw['max_iter']):
        np.random.seed(9)
        g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=16),
                      'cpu')
        cb = record if callback and chunk_iters is None else None
        fits.append(g.fit(chunk_iters=chunk_iters, progress_callback=cb,
                          **kw))
    sub, one = fits
    fc = sub.fit_counters
    if callback:
        # a call each chunk of 25 (restarts aside), as 10, 10 and 5
        assert len(seen) == len(fc.outer_widths)
        ends = np.cumsum([c.iterations for c in fc.chunks])
        outer = np.array([c.outer for c in fc.chunks])
        assert [it for it, *_ in seen] == \
            [int(ends[outer == k][-1]) for k in range(len(seen))]
        assert all(c.iterations <= 10 for c in fc.chunks)
        full = [[c.iterations for c in fc.chunks if c.outer == k]
                for k in range(len(seen))]
        assert [10, 10, 5] in full
        # each callback saw the state in lane order: a lane stopped for
        # good by then has its final row
        final = sub._last_result
        mixed = 0
        for it, eta, statuses in seen:
            done = (statuses == final.status) & (final.nit <= it)
            assert torch.equal(eta[done], sub._state.eta[done]), it
            mixed += int(done.any() and not done.all())
        assert mixed >= 2
        assert torch.equal(seen[-1][1], sub._state.eta)
    else:
        assert not seen
    assert len(fc.chunks) > 10 and fc.compactions > 5
    assert len(fc.outer_widths) >= 3 and min(fc.outer_widths) < 16
    assert len({c.width for c in fc.chunks}) >= 5
    assert np.ptp(sub._last_result.nit) > 100
    assert_loop_call_widths(sub, sub_chunks=True)
    assert one.fit_counters.outer_widths == [16] * len(
        one.fit_counters.chunks)
    assert sub.fix_params == one.fix_params
    for f, x, y in zip(CaviState._fields, sub._state, one._state):
        assert torch.equal(x, y), f
    for f, x, y in zip(Hyper._fields, sub._hyper, one._hyper):
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(sub._sigma_g, one._sigma_g)
    for f in ('nit', 'status', 'final_elbo', 'max_eta_diff'):
        np.testing.assert_array_equal(getattr(sub._last_result, f),
                                      getattr(one._last_result, f),
                                      err_msg=f)
    np.testing.assert_array_equal(np.stack(sub.history['ELBO']),
                                  np.stack(one.history['ELBO']))
    assert fc.lane_sweeps < one.fit_counters.lane_sweeps
    assert fc.live_lane_sweeps == one.fit_counters.live_lane_sweeps


def test_host_restart_on_negative_mse_matches_jax(ladder_trace):
    """A pi-only grid whose MSE goes negative: the host restart fires
    between chunks in both packages (sigma_epsilon fixed at 0.95, a fresh
    pi draw), and the np.random streams end equal."""
    jds, ds = both_datasets(0, 1500, (96, 80), 0.3, 128, scale=2.0)
    for chunk_iters in (None, 7):
        ladder_trace.calls.clear()
        jm, tm = fit_both(jds, ds, dict(pi_steps=4), max_iter=100,
                          chunk_iters=chunk_iters)
        assert_clear_of_thresholds(ladder_trace)
        assert tm.fix_params == {'sigma_epsilon': 0.95}
        np.testing.assert_allclose(tm._hyper.sigma_eps, 0.95, rtol=1e-7)
        assert_grids_match(jm, tm, pip=False)
        assert tm.optim_result.error_on_termination


def test_select_best_model_matches_jax(datasets):
    jm, tm = fit_both(*datasets, GRID_12, max_iter=200)
    elbos = np.asarray(tm.elbo())
    np.testing.assert_allclose(elbos, np.asarray(jm.elbo()), rtol=1e-6)
    best = int(np.argmax(elbos))
    row = tm.grid_row(best)
    jax_select(jm, criterion='ELBO')
    assert select_best_model(tm, criterion='ELBO') is tm
    assert tm.n_models == 1 and tm._S == 1
    assert tm.fix_params == pytest.approx(jm.fix_params, rel=1e-12)
    assert tm.fix_params == pytest.approx(row, rel=1e-12)
    assert tm.pi == pytest.approx(jm.pi, rel=1e-6)
    assert tm.objective() == pytest.approx(jm.objective(), rel=1e-6)
    for c in tm.chromosomes:
        np.testing.assert_allclose(tm.pip[c], jm.pip[c], atol=1e-5, rtol=0)


def test_bma_on_the_jax_fit_matches_jax(datasets):
    """BMA on the JAX grid fit's state and hyperparameters, carried across
    on the same bytes (state, hyperparameters, sigma_g, fix mask, per-lane
    statuses)."""
    jds, ds = datasets
    np.random.seed(3)
    jm = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **GRID_12), mesh='off')
    jm.fit(max_iter=200)
    tm = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_12), 'cpu')
    assert_bma_on_carried_state_matches(jm, tm)


def assert_bma_on_carried_state_matches(jm, tm):
    """BMA of the port's grid ``tm`` on the state, hyperparameters, sigma_g,
    fix mask, per-lane statuses and ELBOs of the JAX grid fit ``jm``,
    carried across on the same bytes, against the JAX package's BMA of
    ``jm``: hyperparameters, sigma_g, state and h2 within rtol 1e-6."""
    tm._state = CaviState.from_numpy(*(np.asarray(x) for x in jm._state),
                                     device='cpu')
    tm._hyper = Hyper(*(np.asarray(x, np.float64) for x in jm._hyper))
    tm._sigma_g = np.asarray(jm._sigma_g, np.float64)
    tm._fix_mask = FixMask(*(np.asarray(x) for x in jm._fix_mask))
    r = jm._last_result
    tm.optim_results = summarize_statuses(np.asarray(r.status),
                                          np.asarray(r.final_elbo),
                                          np.asarray(r.nit))
    # the weights are a softmax of the lanes' ELBOs, which turns their
    # 4e-8 relative difference (float32 statistics summed in another
    # order; ~1e-4 absolute) into ~1e-4 relative in the weights: the
    # ELBOs are carried across as well
    j_elbo = np.asarray(jm.elbo())
    np.testing.assert_allclose(tm.elbo(), j_elbo, rtol=1e-6)
    tm.elbo = lambda: j_elbo
    jax_bma(jm)
    assert bayesian_model_average(tm) is tm
    assert tm.n_models == 1 and tm._S == 1
    for f in ('sigma_eps', 'tau_beta', 'pi', 'lambda_min'):
        np.testing.assert_allclose(getattr(tm._hyper, f),
                                   np.asarray(getattr(jm._hyper, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(tm._sigma_g, np.asarray(jm._sigma_g),
                               rtol=1e-6)
    for k in ('mu', 'eta', 'q'):
        got = getattr(tm._state, k).numpy()
        want = np.asarray(getattr(jm._state, k))
        # rtol 1e-6, and the same relative bound against the largest value
        # where a weighted sum of lanes cancels
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(tm._state.gamma.numpy(),
                               np.asarray(jm._state.gamma), rtol=1e-6)
    assert 0.0 < tm.get_heritability() < 1.0
    assert tm.get_heritability() == pytest.approx(jm.get_heritability(),
                                                  rel=1e-6)


def test_grid_fit_on_float32_ld_matches_jax(ladder_trace):
    """test_grid_fit_matches_jax's 12-point grid in one call on float32 LD
    (the JAX package's default packing, quantize=False), both packages from
    one np.random seed, then BMA on the JAX fit's carried state. The int8
    test's min_iter 7 and f_abs_tol 3e-3 stop every lane on the ELBO clear
    of every threshold on float32 LD as well (the guard replays the JAX
    run's ladder); the fits are held exactly."""
    jds, ds = both_datasets(21, 3000, (250, 200), 0.35, 128, quantize=False)
    assert ds.ld.diag.dtype == torch.float32 and ds.ld.nb <= 12
    jm, tm = fit_both(jds, ds, GRID_12, max_iter=200, min_iter=7,
                      f_abs_tol=3e-3)
    assert_clear_of_thresholds(ladder_trace)
    assert_grids_match(jm, tm)
    assert tm.converged_models.all()
    assert_bma_on_carried_state_matches(jm, VIPRSGrid(ds, HyperparameterGrid(
        n_snps=ds.m, **GRID_12), 'cpu'))
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_grid_search_and_unported_paths(datasets):
    jds, ds = datasets
    np.random.seed(9)
    gs = GridSearch(ds, HyperparameterGrid(n_snps=ds.m, **GRID_12), 'cpu')
    best = gs.fit(max_iter=200)
    assert best.n_models == 1 and len(gs.validation_result['ELBO']) == 12
    assert np.argmax(gs.validation_result['ELBO']) is not None
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=2), 'cpu')
    need = 'validation dataset must be provided'
    with pytest.raises(AssertionError, match=need):
        jax_select(JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, pi_steps=2),
                                mesh='off'), criterion='validation')
    with pytest.raises(ValueError, match=need):
        select_best_model(g, criterion='validation')
    with pytest.raises(ValueError, match='hybrid'):
        g.fit(sweep_impl='hybrid')
    with pytest.raises(ValueError, match='to_table'):
        np.random.seed(1)
        g.fit(max_iter=5).to_table()


def test_grid_imports_without_jax_or_pandas(tmp_path):
    """In a fresh interpreter: the grid model and gridsearch load neither
    jax nor pandas (the card's machine has no pandas), and a CPU grid fit
    with BMA launches no kernel."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import viprs_tpu_torch.model.grid, viprs_tpu_torch.gridsearch
        assert 'jax' not in sys.modules and 'pandas' not in sys.modules
        from viprs_tpu_torch.data.dataset import SummaryStatsDataset
        from viprs_tpu_torch.gridsearch import (HyperparameterGrid,
                                                bayesian_model_average)
        from viprs_tpu_torch.model import VIPRSGrid
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
        grid = HyperparameterGrid(pi_steps=3, sigma_epsilon_steps=3,
                                  n_snps=m, h2_est=0.3, h2_se=0.05)
        g = VIPRSGrid(ds, grid, 'cpu').fit(max_iter=50)
        bayesian_model_average(g)
        assert g.n_models == 1 and 0 < g.get_heritability() < 1
        assert not any(cavi_cuda.LAUNCHES.values()), cavi_cuda.LAUNCHES
        assert 'jax' not in sys.modules and 'pandas' not in sys.modules
        print('ok')
    """)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_em_fit_continues_a_jax_chunk(datasets, ladder_trace):
    """A JAX em_fit chunk's carry (state, hyperparameters, counters,
    sigma_g, objective, live lanes) goes into the port's em_fit on the same
    bytes, and the next chunk ends as the JAX package's does."""
    import jax.numpy as jnp
    from viprs_tpu.ops import cavi_jax, em_loop as jax_em, updates as jax_up
    from viprs_tpu_torch.ops import em_loop
    jds, ds = datasets
    S = 4
    pis = np.geomspace(0.005, 0.05, S)
    hyper = dict(sigma_eps=np.linspace(0.65, 0.8, S), tau_beta=pis * ds.m / 0.3,
                 pi=pis, lambda_min=np.zeros(S))
    shape = (S, ds.ld.nb, ds.ld.block_size)
    logits = np.broadcast_to(np.log(pis / (1 - pis))[:, None, None],
                             shape).astype(np.float32)
    zeros = np.zeros(shape, np.float32)
    fix = (np.zeros(S, bool), np.zeros(S, bool), np.array([1, 0, 1, 0], bool))
    sb, nf = (x.numpy() for x in ds.device_inputs())
    common = dict(n_sample=float(ds.n), m_total=float(ds.m))

    def jax_fit(state, hyp, **kw):
        return jax_em.em_fit(
            jds.ld, cavi_jax.CaviState(*(jnp.asarray(x) for x in state)),
            jnp.asarray(sb), jnp.asarray(nf),
            cavi_jax.Hyper(**{k: jnp.asarray(v, jnp.float32)
                              for k, v in hyp.items()}),
            jax_up.FixMask(*(jnp.asarray(x) for x in fix)), **common, **kw)

    # min_iter 6 and f_abs_tol 3e-2: every lane stops on the ELBO at the
    # third iteration of the continued chunk, clear of every threshold
    tol = dict(min_iter=6, f_abs_tol=3e-2)
    first = jax_fit((logits, zeros, zeros, zeros), hyper, init_elbo=None,
                    active0=jnp.ones(S, bool), max_iter=4, **tol)
    carry = dict(
        init_elbo=np.asarray(first.final_elbo),
        active0=np.asarray(first.status) == 9, i0=4,
        sigma_g0=np.asarray(first.sigma_g), max_iter=60, **tol)
    hyp1 = {k: np.asarray(getattr(first.hyper, k)) for k in hyper}
    state1 = [np.asarray(x) for x in first.state]
    want = jax_fit(state1, hyp1, counters0=first.counters,
                   **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                      for k, v in carry.items()})
    assert_clear_of_thresholds(ladder_trace)
    got = em_loop.em_fit(
        ds.ld, CaviState.from_numpy(*state1, device='cpu'),
        *ds.device_inputs(), Hyper(**hyp1), fix, **common,
        counters0=em_loop.EMCounters.from_numpy(
            *(np.asarray(x) for x in first.counters)), **carry)
    assert carry['active0'].all()
    np.testing.assert_array_equal(got.nit, np.asarray(want.nit))
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    assert got.n_iter_total == int(want.n_iter_total)
    np.testing.assert_allclose(got.final_elbo, np.asarray(want.final_elbo),
                               rtol=1e-6)
    for k in hyper:
        np.testing.assert_allclose(getattr(got.hyper, k),
                                   np.asarray(getattr(want.hyper, k)),
                                   rtol=1e-6, err_msg=k)
    # (the stall and oscillation counters compare ELBO changes of ~1e-6
    # with each other, below the two packages' 1e-4 ELBO rounding, so only
    # the damping they drive is compared)
    np.testing.assert_array_equal(got.counters.damping,
                                  np.asarray(want.counters.damping))
    np.testing.assert_allclose(got.state.eta.numpy(),
                               np.asarray(want.state.eta), atol=1e-6, rtol=0)


def test_union_gated_em_fit_matches_jax(monkeypatch, ladder_trace):
    """em_fit with the union-gated skip sweep (K4's rule) at S = 4 against
    the JAX package's em_fit(use_skip=True), whose Pallas skip kernel runs
    in interpret mode: the same iterations, statuses and objectives. The
    last LD block (one tile, no coupling) has zero marginal betas, so no
    lane proposes a step on it and the gate leaves it out."""
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from viprs_tpu.ops import cavi_jax, em_loop as jax_em, updates as jax_up
    from viprs_tpu_torch.ops import em_loop
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)
    monkeypatch.setattr(pl, 'pallas_call', interp_call)
    jds, ds = both_datasets(21, 3000, (250, 200, 128), 0.35, 128,
                            null_tail=128)
    S = 4
    pis = np.geomspace(0.005, 0.05, S)
    hyper = dict(sigma_eps=np.linspace(0.7, 0.8, S), tau_beta=pis * ds.m / 0.3,
                 pi=pis, lambda_min=np.zeros(S))
    shape = (S, ds.ld.nb, ds.ld.block_size)
    logits = np.broadcast_to(np.log(pis / (1 - pis))[:, None, None],
                             shape).astype(np.float32)
    zeros = np.zeros(shape, np.float32)
    fix = (np.zeros(S, bool),) * 3
    sb, nf = ds.device_inputs()
    # min_iter 8 and f_abs_tol 1e-3 stop every lane on the ELBO clear of
    # every threshold (at the defaults lane 0 ends with max|d eta| within a
    # factor 1.05 of x_abs_tol)
    kw = dict(n_sample=float(ds.n), m_total=float(ds.m), max_iter=40,
              min_iter=8, f_abs_tol=1e-3)
    want = jax_em.em_fit.__wrapped__(
        jds.ld, cavi_jax.CaviState(*(jnp.asarray(x)
                                     for x in (logits, zeros, zeros, zeros))),
        jnp.asarray(sb.numpy()), jnp.asarray(nf.numpy()),
        cavi_jax.Hyper(**{k: jnp.asarray(v, jnp.float32)
                          for k, v in hyper.items()}),
        jax_up.FixMask(*(jnp.asarray(x) for x in fix)), init_elbo=None,
        active0=jnp.ones(S, bool), use_skip=True, **kw)
    assert_clear_of_thresholds(ladder_trace)
    got = em_loop.em_fit(
        ds.ld, CaviState.from_numpy(logits, zeros, zeros, zeros, device='cpu'),
        sb, nf, Hyper(**hyper), fix, use_skip=True, **kw)
    n = int(want.n_iter_total)
    assert got.n_iter_total == n
    np.testing.assert_array_equal(got.nit, np.asarray(want.nit))
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    np.testing.assert_allclose(np.asarray(got.elbo_hist),
                               np.asarray(want.elbo_hist)[:n + 1], rtol=1e-6)
    np.testing.assert_allclose(got.state.eta.numpy(),
                               np.asarray(want.state.eta), atol=1e-6, rtol=0)
    # every iteration swept all blocks but the null one, which stayed zero
    assert list(got.act_hist[1:n + 1]) == [ds.ld.nb - 1] * n
    assert not got.state.eta[:, -1].any()
    assert sum(cavi_cuda.LAUNCHES.values()) == 0
