"""VIPRSGrid — fit a grid of VIPRS models over hyperparameter settings.

Counterpart of viprs_tpu.model.grid.VIPRSGrid. In the simultaneous mode (the
default) the grid points are the S lanes of one fit (the lane kernels K3/K4
on the card), finished lanes are masked out, and the survivors are
compacted between chunks (model/viprs.py). With ``pathwise=True`` the grid
points are fitted one after another at S = 1, each warm-started from the
previous one's finished state, under the JAX call's sweep rule: every block
every iteration (K1 on the card), neither the hybrid nor the skip sweep. On
the card the kernels take int8 (``quantize=True``) or float32
(``quantize=False``) LD, each through its own instances.

The grid rows are held as numpy columns; ``to_validation_table`` (in
model/base.py) gives them with the fit outcomes as a Table.
"""

import numpy as np
import torch

from .viprs import VIPRS
from ..ops import em_loop
from ..ops.cavi_torch import CaviState, Hyper
from ..ops.updates import FixMask
from ..utils.optimize import OptimizeResult, summarize_statuses

_HYPER_FIELD = {'sigma_epsilon': 'sigma_eps', 'tau_beta': 'tau_beta',
                'pi': 'pi', 'lambda_min': 'lambda_min'}


def grid_columns(grid):
    """{name: (n,) float64} columns of a grid: a HyperparameterGrid (of
    either package) or a list of row dicts (its ``combine_grids()``)."""
    rows = grid.combine_grids() if hasattr(grid, 'combine_grids') else grid
    if not rows:
        raise ValueError("the grid has no points")
    return {k: np.asarray([r[k] for r in rows], np.float64) for k in rows[0]}


class VIPRSGrid(VIPRS):
    """
    :ivar grid_columns: {hyperparameter: (n_models,) values}, one entry per
        grid point.
    :ivar validation_result: {column: (n_models,) values} of per-model fit
        outcomes after a fit.
    :ivar optim_results: list of OptimizeResult, one per model.
    :ivar n_models: number of grid points.
    """

    def __init__(self, dataset, grid, device, **kwargs):
        self.grid_columns = grid_columns(grid)
        self.n_models = self._n_grid = len(next(iter(
            self.grid_columns.values())))
        self.validation_result = None
        self.optim_results = []
        super().__init__(dataset, device, **kwargs)
        self._S = self.n_models

    def grid_row(self, idx):
        return {k: float(v[idx]) for k, v in self.grid_columns.items()}

    # ------------------------------------------------------------- grid status
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

    # ---------------------------------------------------------- initialization
    def initialize_theta(self, theta_0=None, rng=None):
        """Base initialization, then per-model overrides from the grid rows.
        The base draw of pi and the LDSC estimate happen even where the grid
        then overrides them, so the numpy stream advances as in the JAX
        package."""
        if self._S != self._n_grid:
            # collapsed to one model: the winner's values are in fix_params
            return super().initialize_theta(theta_0, rng)
        rng = np.random if rng is None else rng
        pi, sigma_eps, tau_beta = self._resolve_theta0(theta_0, rng)
        lam = float(self.fix_params.get('lambda_min', self.lambda_min))
        S = self._S
        h = {'sigma_eps': np.full(S, sigma_eps), 'tau_beta': np.full(S, tau_beta),
             'pi': np.full(S, pi), 'lambda_min': np.full(S, lam)}
        for key, col in self.grid_columns.items():
            h[_HYPER_FIELD[key]] = col.copy()
        self._hyper = Hyper(**h)
        self._sigma_g = np.zeros(S)
        self._update_fix_mask()

    def _update_fix_mask(self):
        if self._S != self._n_grid:
            return super()._update_fix_mask()
        fixed = set(self.grid_columns) | set(self.fix_params)
        self._fix_mask = FixMask(*(np.full(self._S, k in fixed, bool)
                                   for k in ('sigma_epsilon', 'tau_beta',
                                             'pi')))

    # -------------------------------------------------------------------- fit
    def fit(self, pathwise=False, **fit_kwargs):
        """Fit the grid: all grid points simultaneously, finished lanes
        masked out (``VIPRS.fit``'s arguments), or with ``pathwise=True``
        one after another (``_fit_pathwise``). A grid collapsed to one model
        takes a plain VIPRS fit (reference VIPRSGrid.py:145-146)."""
        if self.n_models == 1 or fit_kwargs.get('compile_only'):
            return VIPRS.fit(self, **fit_kwargs)
        if pathwise:
            return self._fit_pathwise(**fit_kwargs)
        if not fit_kwargs.get('continued'):
            self._lanes_whole = False
        super().fit(**fit_kwargs)
        self._set_validation_result(self._last_result.final_elbo)
        return self

    def _set_validation_result(self, elbos):
        self.validation_result = {
            **{k: v.copy() for k, v in self.grid_columns.items()},
            'ELBO': np.asarray(elbos).copy(),
            'Converged': self.converged_models,
            'Optimization_message': [r.message for r in self.optim_results]}

    def _fit_pathwise(self, max_iter=1000, theta_0=None, param_0=None,
                      min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
                      rng=None):
        """Serial warm-started schedule (viprs_tpu model/grid.py:153-231,
        the reference's default, VIPRSGrid.py:194-226): grid point s is one
        em_fit at S = 1 from grid point s - 1's finished state (logits, mu,
        eta and its q as the fit left them), with its own initial
        hyperparameters, fresh counters, an initial objective of 0 and no
        restart; the first starts from ``param_0``'s warm start where given.
        ``optim_result.nit`` is the sum over the grid points. Under a
        mesh every rank holds every lane (the blocks are split)."""
        rng = np.random if rng is None else rng
        S = self._S
        self._lanes_whole = True
        self._refresh_inputs()
        self.initialize(theta_0, param_0, rng)
        hyper = {f: np.array(x, np.float64)
                 for f, x in zip(Hyper._fields, self._hyper)}
        fix = [np.asarray(x) for x in self._fix_mask]
        sigma_g, elbos = np.zeros(S), np.zeros(S)
        nits, statuses = np.zeros(S, np.int32), np.zeros(S, np.int32)
        state = self._state
        warm = None
        for s in range(S):
            res = em_loop.em_fit(
                self._ld,
                warm if warm is not None else CaviState(
                    *(x[s:s + 1] for x in state)),
                self._std_beta_flat, self._n_flat,
                Hyper(*(hyper[f][s:s + 1] for f in Hyper._fields)),
                FixMask(*(x[s:s + 1] for x in fix)), n_sample=float(self.n),
                m_total=float(self.m), init_elbo=np.zeros(1),
                active0=np.ones(1, bool), max_iter=max_iter,
                min_iter=min_iter, f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol,
                patience=patience)
            warm = res.state
            for full, part in zip(state, warm):
                full[s:s + 1].copy_(part)
            for f, x in zip(Hyper._fields, res.hyper):
                hyper[f][s] = float(x[0])
            sigma_g[s] = res.sigma_g[0]
            elbos[s] = res.final_elbo[0]
            nits[s], statuses[s] = res.nit[0], res.status[0]
        self._hyper = Hyper(**hyper)
        self._sigma_g = sigma_g
        self._pip = self._post_mean_beta = self._post_var_beta = None
        self._last_result = em_loop.EMResult(
            state=None, hyper=None, sigma_g=None, status=statuses, nit=nits,
            elbo_hist=None, n_iter_total=int(nits.sum()), final_elbo=elbos,
            mse_of=None, counters=None, max_eta_diff=None,
            restarts_used=None, act_hist=None, n_skip=0)
        self._populate_optim_result(self._last_result)
        self.optim_result.nit = int(nits.sum())
        self._set_validation_result(elbos)
        return self

    def _populate_optim_result(self, res):
        # a collapsed grid's refit is summarized as a grid of one, as the
        # JAX package does ('Grid fit complete.'; optim_results[0] is the
        # fit's own record)
        self.optim_results = summarize_statuses(res.status, res.final_elbo,
                                                res.nit)
        agg = OptimizeResult()
        agg.nit = int(np.max(res.nit))
        agg.fun = float(np.max(res.final_elbo))
        agg.stop_iteration = True
        agg.success = bool(self.converged_models.any())
        # grid-level error: every grid point terminated with a hard error
        agg.error_on_termination = not bool(self.valid_terminated_models.any())
        agg.message = (
            'Grid fit complete.' if not agg.error_on_termination
            else 'All grid points terminated with errors: '
                 + '; '.join(sorted({r.message for r in self.optim_results})))
        self.optim_result = agg

    # ------------------------------------------------------------- collapsing
    def _lane(self, x, idx):
        """Lane ``idx`` of a state tensor, (1, NB, B), on every rank:
        under a mesh that splits the lanes, the rank holding it sends it
        to the others of its grid group."""
        if not self._lanes_split():
            return x[idx:idx + 1].clone()
        l0, l1 = self._lane_range()
        mine = x[idx - l0:idx - l0 + 1] if l0 <= idx < l1 else \
            torch.zeros_like(x[:1])
        owner = int(self.mesh.lane_home(self._S)[idx])
        return self.mesh.gather(mine.cpu(), 'grid')[owner].to(x.device)

    def _collapse(self):
        self._S = 1
        self.n_models = 1
        self._pip = self._post_mean_beta = self._post_var_beta = None

    def collapse_to_model(self, idx):
        """Slice every per-model quantity down to grid point ``idx`` (used by
        select_best_model, reference grid_utils.py:68-114)."""
        idx = int(idx)
        row = self.grid_row(idx)
        self._state = CaviState(*(self._lane(x, idx) for x in self._state))
        self._hyper = Hyper(*(np.asarray(x)[idx:idx + 1] for x in self._hyper))
        self._sigma_g = np.asarray(self._sigma_g)[idx:idx + 1]
        self._collapse()
        self.set_fixed_params(row)
