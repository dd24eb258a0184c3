"""The port's single-model fit against the JAX package's, on the CPU.

``VIPRS(ds, device='cpu')`` runs the plain versions of the kernels; the JAX
package's ``VIPRS(ds, mesh='off')`` on the CPU runs its all-active XLA
sweep, so the port is held to it with ``sweep_impl='xla'``. The hybrid
branch rule is held to the JAX package's ``em_fit(use_hybrid=True)``, whose
skip branch (a Pallas kernel) runs in interpret mode.

Tolerances: the number of iterations, the status and the restart outcome
must be equal, on problems whose JAX run the guard below finds clear of
every stopping threshold; h2 within 1e-6 (absolute); the ELBO history within rtol 1e-6
plus atol 1e-3 (its terms are around 1e3-1e4 and computed from float32
state, so a small ELBO after a restart carries their absolute error); PIP
within 1e-5 and the posterior mean within 1e-6 (absolute).
"""

import functools
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


def both_datasets(sim, scale=1.0, block_size=128, quantize=True):
    """Both packages' datasets of a simulation, int8 LD (float32 LD with
    ``quantize=False``)."""
    sb = {c: scale * v for c, v in sim['std_beta'].items()}
    args = (sim['ld_blocks'], sb, sim['n_per_snp'])
    return (JaxDataset.from_dense_blocks(*args, block_size=block_size,
                                         quantize=quantize),
            SummaryStatsDataset.from_dense_blocks(
                *args, block_size=block_size, quantize=quantize,
                device='cpu'))


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


# ------------------------------------------------------------------ the guard
# Exact iteration counts and status codes are compared only on problems that
# are clear of every stopping threshold, checked on the JAX run's own
# trajectory: the two packages sum float32 statistics in another order (and
# so may two hosts), so a comparison that lands within rounding of its
# threshold can go either way. The guard replays the convergence ladder of
# the JAX package's EM loops with three-valued comparisons; a comparison is
# decided only when it is clear of its threshold by a factor of 2 on the
# right side:
#
# - CONVERGED_F, |dELBO| <= f_abs_tol: true at <= f_abs_tol / 2, false at
#   >= 2 f_abs_tol (from min_iter on);
# - CONVERGED_X, max|d eta| < x_abs_tol: true at <= x_abs_tol / 2, false at
#   >= 2 x_abs_tol;
# - the sigma_g counter's |d sigma_g| <= x_abs_tol and max|d eta| <
#   10 x_abs_tol, the divergence counter's |dELBO| > 1e3 f_abs_tol +
#   1e-4 |ELBO| (same factor 2), and the sign comparisons of the
#   oscillation ladder (an ELBO drop: decided beyond f_abs_tol / 2) and its
#   stall test (an improvement over the best ELBO by more than f_abs_tol,
#   factor 2); each counter is carried as the interval of values the
#   undecided comparisons allow, and its test against patience (5 for the
#   oscillation counter, 2 * patience for the stall counter) must be decided;
# - MSE_NEGATIVE: decided beyond |MSE| >= 1e-6.
#
# At every iteration the first decided-true test of the ladder sets the
# status and every test before it must be decided false; an undecided test
# fails the guard with a message that names the problem knife-edge. The
# replayed stopping iterations and statuses must be the JAX run's.

LADDER_MARGIN = 2.0
MSE_CLEAR = 1e-6


class LadderTrace:
    """The JAX package's EM loops recorded iteration by iteration: each
    loop function call made through the trace (``calls``) with the events
    its body emits through ordered debug callbacks (max |d eta| from the
    sweep, the sweep statistics, the objectives)."""

    def __init__(self):
        self.calls = []
        self._events = None

    def cb(self, tag):
        def emit(*xs):
            if self._events is not None:
                self._events.append((tag, [np.array(x, np.float64)
                                           for x in xs]))
        return emit

    def call(self, kind, fn, *args, **kw):
        """Run one loop function (the JAX package's em_fit, mix_em_fit or
        mix_em_fit_batch, jitted or not) and record it."""
        import jax
        self._events = []
        try:
            res = fn(*args, **kw)
            jax.block_until_ready(res)
            jax.effects_barrier()
        finally:
            events, self._events = self._events, None
        self.calls.append(dict(kind=kind, args=args, kw=kw, res=res,
                               events=events))
        return res


@pytest.fixture
def ladder_trace(monkeypatch):
    """Patch the JAX package's loop bodies to report to a LadderTrace (the
    jit caches are cleared around it, so the bodies are traced anew)."""
    import jax
    import jax.numpy as jnp
    from viprs_tpu.ops import (cavi_mix as jmix, cavi_pallas, em_loop as jem,
                               mix_em_loop as jmel, updates as jup)
    tr = LadderTrace()

    def sweep(orig):
        def f(ld, *a, **kw):
            state, eta_diff = orig(ld, *a, **kw)
            ed = jnp.abs(eta_diff) * ld.mask
            med = jnp.max(ed.reshape(-1, ed.shape[-2] * ed.shape[-1]), axis=1)
            jax.debug.callback(tr.cb('X'), med, ordered=True)
            return state, eta_diff
        return f

    for mod, name in ((jem, 'cavi_sweep'), (jmel, 'cavi_sweep_mixture'),
                      (jmix, 'cavi_sweep_mixture_batch'),
                      *((cavi_pallas, n) for n in (
                          'cavi_sweep_pallas', 'cavi_sweep_pallas_s1_skip',
                          'cavi_sweep_pallas_skip_s',
                          'cavi_sweep_mixture_pallas',
                          'cavi_sweep_mixture_pallas_skip',
                          'cavi_sweep_mixture_pallas_batch',
                          'cavi_sweep_mixture_pallas_skip_batch'))):
        monkeypatch.setattr(mod, name, sweep(getattr(mod, name)))

    orig_elbo, orig_mse = jup.elbo, jup.mse

    def elbo(*a, **kw):
        e = orig_elbo(*a, **kw)
        jax.debug.callback(tr.cb('E'), e, ordered=True)
        return e

    def mse(stats, sigma_g):
        v = orig_mse(stats, sigma_g)
        jax.debug.callback(tr.cb('M'), sigma_g, v, ordered=True)
        return v
    monkeypatch.setattr(jup, 'elbo', elbo)
    monkeypatch.setattr(jup, 'mse', mse)

    def stats_cb(st):
        jax.debug.callback(tr.cb('S'), *(jnp.atleast_1d(x) for x in (
            st['sum_zeta_k'].sum(axis=-1), st['sum_q_eta'],
            st['sum_beta_eta'], st['sum_eta_sq'])), ordered=True)
        return st

    orig_stats = jmix.mix_stats
    monkeypatch.setattr(jmix, 'mix_stats',
                        lambda *a: stats_cb(orig_stats(*a)))
    monkeypatch.setattr(jmel, '_mix_stats_batch', lambda st, vt, sb, m: (
        stats_cb(jax.vmap(lambda g, mu, e, q, v: orig_stats(
            jmix.MixState(g, mu, e, q), v, sb, m))(*st, vt))))

    for mod, name, kind in ((jem, 'em_fit', 'em'),
                            (jmel, 'mix_em_fit', 'mix'),
                            (jmel, 'mix_em_fit_batch', 'mix_batch')):
        orig = getattr(mod, name)
        traced = functools.partial(tr.call, kind, orig)
        traced.__wrapped__ = functools.partial(tr.call, kind, orig.__wrapped__)
        monkeypatch.setattr(mod, name, traced)
    jax.clear_caches()
    yield tr
    jax.clear_caches()


def _tri(true_if, false_if):
    """A three-valued comparison: True, False or None (undecided)."""
    return True if true_if else (False if false_if else None)


def _and(*xs):
    if any(x is False for x in xs):
        return False
    return None if any(x is None for x in xs) else True


def _segments(trace):
    """Per lane, the runs of iterations from a fresh start of the ladder to
    a stop (or the end of the budget): lists of dicts with the iteration's
    global number, objectives, max |d eta|, sigma_g and MSE, plus the
    ladder settings and the JAX run's end status of the segment.

    A call narrower than the first one is a compacted chunk: its live lanes
    are the lanes still running, in ascending order (the JAX chunk loops'
    ``np.nonzero(active)``), and its padding lanes are frozen."""
    from viprs_tpu.utils import optimize as jopt
    lanes, width = {}, None
    for c in trace.calls:
        kw, res, ev = c['kw'], c['res'], c['events']
        kind = c['kind']
        i0 = int(kw.get('i0', 0))
        hist = np.asarray(res.elbo_hist, np.float64)
        hist = hist.reshape(hist.shape[0], -1)
        S = hist.shape[1]
        width = S if width is None else width
        n = int(res.n_iter_total if kind != 'mix' else res.nit)
        status = np.atleast_1d(np.asarray(res.status))
        nit = np.atleast_1d(np.asarray(res.nit))
        act0 = kw.get('active0')
        act0 = np.ones(S, bool) if act0 is None else \
            np.asarray(act0, bool).reshape(S)
        sg0 = kw.get('sigma_g0')
        sg0 = np.zeros(S) if sg0 is None else \
            np.asarray(sg0, np.float64).reshape(S)
        c0 = kw.get('counters0')
        fresh = np.ones(S, bool) if c0 is None else \
            np.isneginf(np.asarray(c0.best_elbo))
        lam = None if kind == 'em' else \
            np.asarray(c['args'][4].lambda_min, np.float64).reshape(S)
        lane = list(range(S))
        if S < width:
            live = sorted(g for g, ss in lanes.items() if ss[-1]['end'] is None)
            assert len(live) == act0.sum() and act0[:len(live)].all(), \
                "a compacted call after a restart: the guard cannot map it"
            lane[:len(live)] = live
        # the events, iteration by iteration
        k = 0
        if kind == 'em' and kw.get('init_elbo') is None:
            k += 1                                   # the initial objective
        if kind != 'em' and kw.get('init_elbo', None) is None:
            k += 1                                   # its statistics
        its = []
        for _ in range(n):
            tag, (med,) = ev[k]
            assert tag == 'X', ev[k][0]
            if kind == 'em':
                (_, (e,)), (_, (sg, mse)) = ev[k + 1], ev[k + 2]
                assert ev[k + 1][0] == 'E' and ev[k + 2][0] == 'M'
                k += 3
                restart = None
                if k < len(ev) and ev[k][0] == 'E':
                    restart = ev[k][1][0]
                    k += 1
            else:
                tag, (szk, sqe, sbe, ses) = ev[k + 1]
                assert tag == 'S'
                k += 2
                sg = (1.0 + lam) * szk + sqe
                mse = 1.0 - 2.0 * sbe + sg - szk + ses
                restart = None
            its.append((med, sg, mse, restart))
        ladder = dict(f=kw.get('f_abs_tol', 1e-6), x=kw.get('x_abs_tol', 1e-6),
                      min_iter=kw.get('min_iter', 3),
                      patience=kw.get('patience', 10),
                      damping=kind != 'mix')
        for l in range(S):
            if not act0[l]:
                continue
            segs = lanes.setdefault(lane[l], [])
            if fresh[l] or not segs or segs[-1]['end'] is not None:
                segs.append(dict(ladder, its=[], end=None))
            seg = segs[-1]
            prev, sg_prev = hist[0, l], sg0[l]
            last = n if status[l] == jopt.MAX_ITER else int(nit[l]) - i0
            for i in range(1, last + 1):
                med, sg, mse, restart = its[i - 1]
                seg['its'].append(dict(gi=i0 + i, prev=prev,
                                       curr=hist[i, l], med=med[l],
                                       d_sg=sg[l] - sg_prev, mse=mse[l]))
                prev, sg_prev = hist[i, l], sg[l]
                if restart is not None:              # in-loop restart
                    seg['end'] = (jopt.MSE_NEGATIVE, i0 + i)
                    seg = dict(ladder, its=[], end=None)
                    segs.append(seg)
                    prev, sg_prev = restart[l], 0.0
            if status[l] != jopt.MAX_ITER:
                seg['end'] = (int(status[l]), int(nit[l]))
    return lanes


def _replay(seg, where):
    """Replay one segment's ladder; returns (status, nit) where it stops
    (None while running) and raises on an undecided comparison."""
    from viprs_tpu.utils import optimize as jopt
    f, x, p, m = seg['f'], seg['x'], seg['patience'], LADDER_MARGIN
    sgc = divc = osc = stall = (0, 0)
    prev_drop, best = False, -np.inf

    def bump(ctr, cond):          # counter interval after a tri-state test
        lo, hi = ctr
        return (lo + 1 if cond is True else 0, hi + 1 if cond is not False else 0)

    def over(ctr, limit, what, it):
        lo, hi = ctr
        if lo <= limit < hi:
            raise AssertionError(
                f"knife-edge problem: {where}, iteration {it['gi']}: the "
                f"{what} counter may or may not exceed {limit}")
        return lo > limit

    for it in seg['its']:
        late = it['gi'] > seg['min_iter']
        d = it['curr'] - it['prev']
        ad = abs(d)
        dropped = _tri(d <= -f / 2, d >= f / 2)
        thr = 1e3 * f + 1e-4 * abs(it['prev'])
        sgc = bump(sgc, _and(late, _tri(abs(it['d_sg']) <= x / m,
                                        abs(it['d_sg']) >= m * x),
                             _tri(it['med'] <= 10 * x / m,
                                  it['med'] >= 10 * m * x)))
        divc = bump(divc, _and(dropped, _tri(ad >= m * thr, ad <= thr / m)))
        if seg['damping']:
            lo, hi = osc
            osc = ((lo + 1 if dropped is True and prev_drop is True else
                    lo if dropped is True else 0),
                   (hi + 1 if dropped is not False and prev_drop is not False
                    else hi if dropped is not False else 0))
            if over(osc, 5, 'oscillation', it):
                osc = (0, 0)
            gain = it['curr'] - best
            improved = _tri(gain >= m * f, gain <= f / m)
            best = max(best, it['curr'])
            stall = bump(stall, None if improved is None else not improved)
            if over(stall, 2 * p, 'stall', it):
                stall = (0, 0)
        prev_drop = dropped
        ladder = (
            (jopt.MSE_NEGATIVE, 'MSE', lambda: _tri(it['mse'] <= -MSE_CLEAR,
                                                   it['mse'] >= MSE_CLEAR)),
            (jopt.CONVERGED_F, '|dELBO| <= f_abs_tol',
             lambda: _and(late, _tri(ad <= f / m, ad >= m * f))),
            (jopt.CONVERGED_X, 'max|d eta| < x_abs_tol',
             lambda: _and(late, _tri(it['med'] <= x / m, it['med'] >= m * x))),
            (jopt.CONVERGED_SIGMA_G, 'sigma_g counter',
             lambda: over(sgc, p, 'sigma_g', it)),
            (jopt.DIVERGED_ELBO, 'divergence counter',
             lambda: over(divc, p, 'divergence', it)))
        for code, what, test in ladder:
            dec = test()
            if dec is None:
                raise AssertionError(
                    f"knife-edge problem: {where}, iteration {it['gi']}: "
                    f"{what} is within a factor {m} of its threshold "
                    f"(|dELBO| {ad:.3e}, max|d eta| {it['med']:.3e}, "
                    f"|d sigma_g| {abs(it['d_sg']):.3e}, MSE "
                    f"{it['mse']:.3e}; f_abs_tol {f}, x_abs_tol {x})")
            if dec:
                return code, it['gi']
    return None


def assert_clear_of_thresholds(trace):
    """The guard: every lane of every JAX loop call recorded in ``trace``
    stops, or runs on, by comparisons clear of their thresholds, and the
    replayed stops are the JAX run's."""
    lanes = _segments(trace)
    assert lanes, "the trace recorded no EM loop"
    for l, segs in lanes.items():
        for j, seg in enumerate(segs):
            where = f"lane {l}, segment {j}"
            got = _replay(seg, where)
            assert got == seg['end'], (
                f"{where}: the replayed ladder stops at {got}, the JAX run "
                f"at {seg['end']}")
    return lanes


@pytest.mark.parametrize('scale,expect_restart', [(1.0, False), (3.0, True)])
def test_fit_matches_jax(scale, expect_restart, ladder_trace):
    """Nominal fit and the in-loop restart on negative MSE (the cases of
    tests/test_models.py::TestInGraphRestart), same np.random stream. At the
    default tolerances the nominal fit stops on max|d eta| within a factor
    1.6 of x_abs_tol; with min_iter 5 and f_abs_tol 5e-4 it stops on the
    ELBO, whose change there is 8x below the tolerance."""
    sim = simulate_sumstats_blocks(n=1500, block_sizes=(96, 80), h2=0.3,
                                   prop_causal=0.05, seed=0)
    jds, ds = both_datasets(sim, scale)
    fit_kw = dict(max_iter=60, min_iter=5, f_abs_tol=5e-4)
    np.random.seed(7)
    jm = JaxVIPRS(jds, mesh='off').fit(**fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(7)
    tm = VIPRS(ds, 'cpu').fit(sweep_impl='xla', **fit_kw)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert (tm.fix_params.get('sigma_epsilon') == 0.95) == expect_restart
    assert_fits_match(jm, tm)


def test_fit_with_coupling_tiles_matches_jax(ladder_trace):
    """A problem whose widest LD block spans three tiles (coupling tiles on
    every sweep); min_iter 29 and f_abs_tol 6e-5 stop it on the ELBO
    clear of every threshold (its max|d eta| shrinks by ~1.3x an
    iteration, too slowly for a clear stop on it)."""
    _coupled_fit_matches_jax(ladder_trace, True,
                             dict(max_iter=200, min_iter=29, f_abs_tol=6e-5))


def test_fit_on_float32_ld_matches_jax(ladder_trace):
    """test_fit_with_coupling_tiles_matches_jax on float32 LD (the JAX
    package's default packing; quantize=False). From iteration ~12 on the
    two packages' ELBO changes differ by up to ~2e-4 (float32 statistics
    summed in another order), which straddles the int8 fit's f_abs_tol;
    f_abs_tol 2e-3 from min_iter 11 stops both on the ELBO, clear of every
    threshold on both sides."""
    _coupled_fit_matches_jax(ladder_trace, False,
                             dict(max_iter=200, min_iter=11, f_abs_tol=2e-3))


def _coupled_fit_matches_jax(ladder_trace, quantize, fit_kw):
    sim = simulate_sumstats_blocks(n=3000, block_sizes=(300, 150, 100, 60),
                                   h2=0.4, prop_causal=0.05, seed=9)
    jds, ds = both_datasets(sim, quantize=quantize)
    assert ds.ld.n_off > 0
    assert ds.ld.diag.dtype == (torch.int8 if quantize else torch.float32)
    np.random.seed(3)
    jm = JaxVIPRS(jds, mesh='off').fit(**fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(3)
    tm = VIPRS(ds, 'cpu').fit(sweep_impl='xla', **fit_kw)
    assert jm.optim_result.success
    assert_fits_match(jm, tm)


@pytest.mark.parametrize('fix_params,lambda_min', [
    ({'pi': 0.02}, None),
    ({'tau_beta': 600.0, 'sigma_epsilon': 0.8}, 0.05)])
def test_fixed_params_and_table_match_jax(fix_params, lambda_min,
                                         ladder_trace):
    """Pinned hyperparameters and lambda_min through the whole fit, and the
    posterior table (SNP, BETA, PIP, VAR_BETA) against the JAX package's.
    The stopping settings put each fit's stop clear of every threshold (at
    the defaults the second one ends with |dELBO| = 0.998 f_abs_tol)."""
    sim = simulate_sumstats_blocks(n=2000, block_sizes=(150, 90), h2=0.3,
                                   prop_causal=0.05, seed=4)
    jds, ds = both_datasets(sim)
    fit_kw = dict(max_iter=100, min_iter=5, f_abs_tol=1e-4) \
        if lambda_min is None else dict(max_iter=100, min_iter=16,
                                        f_abs_tol=1e-3)
    np.random.seed(11)
    jm = JaxVIPRS(jds, mesh='off', fix_params=dict(fix_params),
                  lambda_min=lambda_min).fit(**fit_kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(11)
    tm = VIPRS(ds, 'cpu', fix_params=dict(fix_params),
               lambda_min=lambda_min).fit(sweep_impl='xla', **fit_kw)
    assert_fits_match(jm, tm)
    for name, v in fix_params.items():
        got = {'pi': tm.pi, 'tau_beta': tm.tau_beta,
               'sigma_epsilon': tm.sigma_epsilon}[name]
        assert got == pytest.approx(v, rel=1e-7)
    jt, tt = jm.to_table(), tm.to_table().to_pandas()
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
def test_hybrid_rule_matches_jax_em_fit(interpret, hybrid_eps, ladder_trace):
    """The hybrid branch rule against the JAX package's em_fit(use_hybrid=
    True), traced on the CPU with the skip kernel in interpret mode: the same
    per-iteration active-block counts, iterations, status and ELBO history.

    The gate compares float32 proposals with ``hybrid_eps``. At the default
    eps (x_abs_tol = 1e-6) one block of this problem ends within rounding of
    the gate, so the two packages may pick different branches there; the
    epsilons here keep every decision of the run clear of it."""
    _hybrid_fit_matches_jax(hybrid_eps, ladder_trace, quantize=True)


def test_hybrid_rule_on_float32_ld_matches_jax_em_fit(interpret,
                                                      ladder_trace):
    """test_hybrid_rule_matches_jax_em_fit on float32 LD (the JAX package's
    default packing, which VIPRS fits on the card with the kernels'
    float32 instances): the same active-block counts, iterations, status
    and ELBO history as em_fit(use_hybrid=True), both branches taken. At
    eps 1e-5 a block of the float32 run ends within rounding of the gate
    (as at the default eps on int8 LD); 2e-5, 3e-5 and 5e-5 keep every
    decision clear of it."""
    _hybrid_fit_matches_jax(3e-5, ladder_trace, quantize=False)


def _hybrid_fit_matches_jax(hybrid_eps, ladder_trace, quantize):
    sim = simulate_sumstats_blocks(
        n=3000, block_sizes=(300, 120, 110, 100, 90, 80, 120, 70, 100, 60),
        h2=0.4, prop_causal=0.03, seed=2)
    jds, ds = both_datasets(sim, quantize=quantize)
    assert ds.ld.diag.dtype == (torch.int8 if quantize else torch.float32)
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
    assert_clear_of_thresholds(ladder_trace)
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
    """In a fresh interpreter: importing the port (model, kernels,
    ``plot``, ``cli.warmup``) loads neither jax nor triton (nor seaborn or
    pandas), and a CPU fit launches no kernel."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import viprs_tpu_torch
        import viprs_tpu_torch.model.viprs
        import viprs_tpu_torch.plot, viprs_tpu_torch.cli.warmup
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
            'coupling_pass_s', 'cavi_sweep_mix_s1', 'cavi_sweep_mix_s1_skip',
            'cavi_sweep_mix_s', 'cavi_sweep_mix_s_skip',
            'cavi_block_sweep_s1_f32', 'coupling_pass_s1_f32',
            'cavi_sweep_mix_s1_f32', 'cavi_sweep_mix_s1_skip_f32',
            'cavi_block_sweep_s_f32', 'coupling_pass_s_f32',
            'cavi_sweep_mix_s_f32', 'cavi_sweep_mix_s_skip_f32'
            }, cavi_cuda.LAUNCHES
        assert not any(cavi_cuda.LAUNCHES.values()), cavi_cuda.LAUNCHES
        assert 'jax' not in sys.modules and 'triton' not in sys.modules
        assert 'seaborn' not in sys.modules and 'pandas' not in sys.modules
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
