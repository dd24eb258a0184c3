"""VIPRSMixGrid — fit a grid of VIPRSMix models simultaneously.

Counterpart of viprs_tpu.model.mix_grid.VIPRSMixGrid: the grid points are
the S lanes of one fit through ops/mix_em_loop.mix_em_fit_batch (the lane
kernel K7 on the card, or K8 with ``sweep_impl='skip'``), finished lanes are
masked out, and the fit runs in chunks with its own compaction rule (not
VIPRSGrid's): ``chunk_iters = min(100, max_iter)`` at S >= 8, and the live
lanes are compacted to the next power-of-2 width on ANY halving, padded with
frozen duplicates of the first live lane. A negative MSE restarts the lanes
it hit once, with sigma_epsilon fixed at 0.95. The chunks' widths,
iterations and live lane-iterations are the public ``fit_counters``.

Per lane a gridded ``pi`` is the TOTAL proportion causal (renormalised in
the M-step), a gridded ``tau_beta`` scales the multipliers ``d``, and
``sigma_epsilon``/``lambda_min`` pin the scalars. With one grid point the
model is a VIPRSMix. The grid is held as numpy columns (no pandas).
``pseudo_validate`` scores every lane on the held-out half of a PUMAS split
from the cached q, and ``collapse_to_model`` (what ``select_best_model``
calls) leaves a fitted VIPRSMix of one grid point.
"""

import logging

import numpy as np
import torch

from . import _dispatch
from .grid import grid_columns
from .mix import VIPRSMix
from ..data.ldsc import simple_ldsc
from ..ops import cavi_cuda, mix_em_loop as mel
from ..ops.cavi_mix import MixHyper, MixState
from ..ops.cavi_torch import INNER_STEPS
from ..utils import optimize as opt, trace
from ..utils.optimize import OptimizeResult, summarize_statuses

logger = logging.getLogger(__name__)

F32 = torch.float32
_GRID_KEYS = ('sigma_epsilon', 'tau_beta', 'pi', 'lambda_min')


class VIPRSMixGrid(VIPRSMix):
    """
    :ivar grid_columns: {hyperparameter: (n_models,) values}.
    :ivar validation_result: {column: (n_models,) values} of per-model fit
        outcomes after a fit.
    :ivar optim_results: list of OptimizeResult, one per model.
    :ivar n_models: number of grid points.
    """

    def __init__(self, dataset, grid, device, K=1, **kwargs):
        self.grid_columns = grid_columns(grid)
        self.n_models = len(next(iter(self.grid_columns.values())))
        self.validation_result = None
        self.optim_results = []
        super().__init__(dataset, device, K=K, **kwargs)
        self._S = self.n_models

    # --------------------------------------------------------------- statuses
    @property
    def models_to_keep(self):
        """Lanes still running or converged (not stopped on an error)."""
        return np.logical_or(~self.terminated_models, self.converged_models)

    @property
    def terminated_models(self):
        return np.array([r.stop_iteration for r in self.optim_results])

    @property
    def converged_models(self):
        return np.array([r.success for r in self.optim_results])

    @property
    def valid_terminated_models(self):
        return np.array([r.valid_optim_result for r in self.optim_results])

    # ----------------------------------------------------------- initialization
    def initialize_theta(self, theta_0=None, rng=None):
        """Per-lane initialization with the grid rows as overrides
        (viprs_tpu model/mix_grid.py:73-129)."""
        if self.n_models == 1:
            return super().initialize_theta(theta_0, rng)
        rng = np.random if rng is None else rng
        S, K, m = self.n_models, self.K, self.n_snps
        theta_0 = dict(theta_0 or {})
        theta_0.update(self.fix_params)
        cols = self.grid_columns
        if 'pi' in cols:
            total_pi = cols['pi'].copy()
        elif 'pi' in theta_0:
            total_pi = np.full(S, float(theta_0['pi']))
        else:
            total_pi = rng.uniform(max(0.005, 1.0 / m), 0.1, size=S)
        pi = total_pi[:, None] * rng.dirichlet(np.ones(K), size=S)
        if 'sigma_epsilon' in cols:
            sigma_eps = cols['sigma_epsilon'].copy()
        elif 'sigma_epsilon' in theta_0:
            sigma_eps = np.full(S, float(theta_0['sigma_epsilon']))
        else:
            naive_h2g = float(np.clip(simple_ldsc(self.dataset), 1e-3,
                                      1.0 - 1e-3))
            sigma_eps = np.full(S, 1.0 - naive_h2g)
        h2_lane = np.clip(1.0 - sigma_eps, 1e-3, 1.0 - 1e-3)
        if 'tau_beta' in cols:
            tau_beta = cols['tau_beta'][:, None] * self.d[None]
        elif 'tau_betas' in theta_0:
            tau_beta = np.tile(np.asarray(theta_0['tau_betas'], np.float64),
                               (S, 1))
        else:
            tau_beta = self.d[None] * (m * (pi @ (1.0 / self.d))
                                       / h2_lane)[:, None]
        lam = cols['lambda_min'].copy() if 'lambda_min' in cols else \
            np.full(S, float(self.fix_params.get('lambda_min',
                                                 self.lambda_min)))
        self._hyper = MixHyper(sigma_eps, tau_beta, pi, lam)
        self._sigma_g = np.zeros(S)

    def initialize_variational_parameters(self, param_0=None):
        if self.n_models == 1:
            return super().initialize_variational_parameters(param_0)
        lay = self.dataset.layout
        shape = (self.n_models, self.K, self._ld.nb, lay.block_size)
        pi = torch.from_numpy(np.asarray(self._hyper.pi, np.float32))
        zeros = lambda s: torch.zeros(s, dtype=F32, device=self.device)
        self._state = MixState(
            gamma=pi.to(self.device)[:, :, None, None].expand(shape)
            .contiguous(),
            mu=zeros(shape), eta=zeros(shape[:1] + shape[2:]),
            q=zeros(shape[:1] + shape[2:]))

    def _batch_fix(self):
        S, cols = self.n_models, self.grid_columns
        se_fixed = 'sigma_epsilon' in cols or 'sigma_epsilon' in self.fix_params
        tb_fixed = 'tau_beta' in cols or 'tau_betas' in self.fix_params
        total_pi = cols['pi'] if 'pi' in cols else \
            np.full(S, float(self.fix_params.get('pi', 0.0)))
        return mel.MixFixBatch.from_numpy(
            np.full(S, se_fixed), np.full(S, tb_fixed),
            np.full(S, 'pis' in self.fix_params), total_pi)

    # --------------------------------------------------------------------- fit
    @trace.entry('viprs.fit', fit=True)
    def fit(self, max_iter=1000, theta_0=None, param_0=None, continued=False,
            min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
            max_restarts=1, chunk_iters=None, sweep_impl=None,
            inner_steps=INNER_STEPS, compile_only=False, rng=None, **kwargs):
        """Fit every grid point as a lane of one mixture fit (VIPRSMix.fit's
        arguments, ``param_0`` accepted and ignored as there, and
        ``chunk_iters``: iterations per loop call, default
        ``min(100, max_iter)`` at S >= 8, all at S < 8)."""
        if self.n_models == 1:
            return super().fit(max_iter=max_iter, theta_0=theta_0,
                               param_0=param_0,
                               continued=continued, min_iter=min_iter,
                               f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol,
                               patience=patience, max_restarts=max_restarts,
                               sweep_impl=sweep_impl, inner_steps=inner_steps,
                               compile_only=compile_only, rng=rng, **kwargs)
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
        use_skip = _dispatch.select_mix_sweep_impl(sweep_impl, grid=True)
        cavi_cuda.check_inner_steps(self.device, inner_steps)
        if compile_only:
            cavi_cuda.build_for(self._sweep_args()[0])
            return self
        rng = np.random if rng is None else rng
        self._refresh_inputs()
        if not continued:
            self.initialize(theta_0, param_0, rng)
        hist = self.history.setdefault('ELBO', [])
        S = self.n_models
        if chunk_iters is None:
            chunk_iters = min(100, max_iter) if S >= 8 else max_iter
        chunk_iters = max(1, min(chunk_iters, max_iter))

        ld, dev = self._ld, self.device
        restarts = it_done = 0
        active = np.ones(S, bool)
        statuses = np.full(S, opt.MAX_ITER, np.int32)
        nit_acc = np.zeros(S, np.int32)
        counters = mel.init_mix_counters(S)
        init_elbo = last_elbo = None
        self._sigma_g = np.array(np.broadcast_to(self._sigma_g, S),
                                 np.float64)
        S_run = S
        fc = self.fit_counters = trace.FitCounters()
        while it_done < max_iter:
            this_chunk = min(chunk_iters, max_iter - it_done)
            n_act = int(active.sum())
            bucket = min(S, 1 << max(0, int(np.ceil(np.log2(max(n_act, 1))))))
            if last_elbo is None:
                bucket = S      # nothing to back-fill the history from yet
            if bucket > S_run:
                S_run = bucket
            elif S >= 8 and bucket <= S_run // 2:
                S_run = bucket  # compact on any power-of-2 shrink
            compact = S_run < S
            fix_full = self._batch_fix()
            if compact:
                with trace.span('viprs.compact'):
                    sel = np.nonzero(active)[0]
                    sel_pad = np.concatenate(
                        [sel, np.full(S_run - n_act, sel[0])]).astype(
                            np.int64)
                    sel_dev = torch.from_numpy(sel_pad).to(dev)
                    state_in = MixState(*(x.index_select(0, sel_dev)
                                          for x in self._state))
                    hyper_in = MixHyper(*(np.asarray(x)[sel_pad]
                                          for x in self._hyper))
                    fix_in = mel.MixFixBatch(*(x[sel_pad] for x in fix_full))
                    counters_in = mel.MixCounters(*(x[sel_pad]
                                                    for x in counters))
                    init_elbo_in = None if init_elbo is None else \
                        init_elbo[sel_pad]
                    active_in = np.arange(S_run) < n_act
                    sigma_g_in = self._sigma_g[sel_pad]
            else:
                state_in, hyper_in = self._state, self._hyper
                fix_in, counters_in = fix_full, counters
                init_elbo_in, active_in = init_elbo, active
                sigma_g_in = self._sigma_g

            with trace.span('viprs.chunk'):
                res = mel.mix_em_fit_batch(
                    ld, state_in, self._std_beta_flat, self._n_flat,
                    hyper_in, fix_in, self.d, n_sample=float(self.n),
                    m_total=float(self.m), max_iter=this_chunk,
                    min_iter=min_iter, f_abs_tol=f_abs_tol,
                    x_abs_tol=x_abs_tol, patience=patience,
                    active0=active_in, sigma_g0=sigma_g_in, i0=it_done,
                    counters0=counters_in, init_elbo=init_elbo_in,
                    use_skip=use_skip, inner_steps=inner_steps)
            fc.add_chunk(S_run, trace.sweep_rule(use_skip), res)
            fc.compactions += int(compact)
            n_in_chunk = res.n_iter_total
            it_done += n_in_chunk

            if compact:
                with trace.span('viprs.compact'):
                    sel_dev = torch.from_numpy(sel).to(dev)
                    for full, part in zip(self._state, res.state):
                        full.index_copy_(0, sel_dev, part[:n_act])
                    hyper = [np.array(x, np.float64) for x in self._hyper]
                    for full, part in zip(hyper, res.hyper):
                        full[sel] = part[:n_act]
                    self._hyper = MixHyper(*hyper)
                    self._sigma_g = self._sigma_g.copy()
                    self._sigma_g[sel] = res.sigma_g[:n_act]
                    counters = mel.MixCounters(*(c.copy() for c in counters))
                    for c, p in zip(counters, res.counters):
                        c[sel] = p[:n_act]
                    statuses[sel] = res.status[:n_act]
                    nit_acc[sel] = res.nit[:n_act]
                    fill = init_elbo if init_elbo is not None else last_elbo
                    for row in res.elbo_hist[1:]:
                        full_row = fill.copy()
                        full_row[sel] = row[:n_act]
                        hist.append(full_row)
                    init_elbo = fill.copy()
                    init_elbo[sel] = res.final_elbo[:n_act]
            else:
                self._state, self._hyper = res.state, res.hyper
                self._sigma_g = res.sigma_g
                counters = res.counters
                statuses[active] = res.status[active]
                nit_acc[active] = res.nit[active]
                if init_elbo is None and not hist:
                    hist.append(res.elbo_hist[0].copy())
                hist.extend(res.elbo_hist[1:])
                init_elbo = res.final_elbo
            last_elbo = init_elbo

            restart_mask = ((statuses == opt.MSE_NEGATIVE)
                            & ~fix_full.sigma_eps & (restarts < max_restarts))
            if restart_mask.any():
                restarts += 1
                logger.info("MSE negative on %d grid lanes; restarting them "
                            "with sigma_epsilon fixed at 0.95 (reference "
                            "behavior).", int(restart_mask.sum()))
                self._restart_lanes(restart_mask)
                fresh = mel.init_mix_counters(S)
                counters = mel.MixCounters(*(
                    np.where(restart_mask, f, c)
                    for f, c in zip(fresh, counters)))
                active = restart_mask | (statuses == opt.MAX_ITER)
                init_elbo = None   # the restarted lanes' objective anew
                continue
            active = statuses == opt.MAX_ITER
            if not active.any():
                break

        self._final_elbo = last_elbo
        self.optim_results = summarize_statuses(statuses, last_elbo, nit_acc)
        agg = OptimizeResult()
        agg.nit = int(nit_acc.max())
        agg.fun = float(np.max(last_elbo))
        agg.stop_iteration = True
        agg.success = bool(self.converged_models.any())
        agg.error_on_termination = not bool(
            self.valid_terminated_models.any())
        agg.message = (
            'Grid fit complete.' if not agg.error_on_termination
            else 'All grid points terminated with errors: '
                 + '; '.join(sorted({r.message for r in self.optim_results})))
        self.optim_result = agg
        self._statuses = statuses
        self.validation_result = {
            **{k: v.copy() for k, v in self.grid_columns.items()},
            'ELBO': np.asarray(last_elbo).copy(),
            'Converged': self.converged_models,
            'Optimization_message': [r.message for r in self.optim_results]}
        self._pip = self._post_mean_beta = self._post_var_beta = None
        return self

    def _restart_lanes(self, mask):
        """Reset the masked lanes with sigma_epsilon pinned at 0.95 (their
        pi and tau_beta stay; VIPRS.py:1025-1038 applied per grid lane)."""
        h = [np.array(x, np.float64) for x in self._hyper]
        h[0][mask] = 0.95
        self.fix_params['sigma_epsilon'] = 0.95
        self._hyper = MixHyper(*h)
        self._sigma_g = np.where(mask, 0.0, self._sigma_g)
        dev = self.device
        m = torch.from_numpy(mask).to(dev)
        fresh = torch.from_numpy(h[2].astype(np.float32)).to(dev)
        st = self._state
        zero = torch.zeros((), dtype=F32, device=dev)
        self._state = MixState(
            gamma=torch.where(m[:, None, None, None],
                              fresh[:, :, None, None], st.gamma),
            mu=torch.where(m[:, None, None, None], zero, st.mu),
            eta=torch.where(m[:, None, None], zero, st.eta),
            q=torch.where(m[:, None, None], zero, st.q))

    # ------------------------------------------------- validation, selection
    def pseudo_validate(self, test_gdl=None):
        """Per-lane pseudo-R^2 from the cached q (viprs_tpu model/
        mix_grid.py:457-474; ``_lane_pseudo_r2``)."""
        if self.n_models == 1 or test_gdl is not None \
                or self.validation_std_beta is None or self._state is None:
            return super().pseudo_validate(test_gdl)
        return self._lane_pseudo_r2(self._state.eta, self._state.q)

    def collapse_to_model(self, idx):
        """Slice every per-lane quantity down to grid point ``idx`` and pin
        its grid row (viprs_tpu model/mix_grid.py:477-494): the model is
        then a fitted VIPRSMix (its objective, heritability, posterior
        moments, and ``fit()`` as one model)."""
        idx = int(idx)
        self._state = MixState(*(x[idx].clone() for x in self._state))
        h = self._hyper
        self._hyper = MixHyper(
            sigma_eps=np.float64(np.asarray(h.sigma_eps)[idx]),
            tau_beta=np.asarray(h.tau_beta)[idx].copy(),
            pi=np.asarray(h.pi)[idx].copy(),
            lambda_min=np.float64(np.asarray(h.lambda_min)[idx]))
        self._sigma_g = float(np.atleast_1d(self._sigma_g)[idx])
        self.fix_params.update({k: float(v[idx])
                                for k, v in self.grid_columns.items()
                                if k in _GRID_KEYS})
        self.optim_result = self.optim_results[idx]
        self.n_models = self._S = 1
        self._pip = self._post_mean_beta = self._post_var_beta = None

    # -------------------------------------------------------------- accessors
    def elbo(self):
        if self.n_models == 1:
            return super().elbo()
        return np.asarray(self._final_elbo)

    def get_heritability(self):
        if self.n_models == 1:
            return super().get_heritability()
        sg = np.asarray(self._sigma_g)
        return sg / (sg + np.asarray(self._hyper.sigma_eps))
