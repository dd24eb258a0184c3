"""VIPRS — the spike-and-slab variational PRS model, with S model lanes.

Counterpart of viprs_tpu.model.viprs.VIPRS: initialization from LDSC, the
CAVI e-step (CUDA kernels on the card, plain PyTorch on the CPU), the
closed-form M-step, the ELBO, the convergence ladder and the restart on
negative MSE, all through ops/em_loop.em_fit. ``_S`` is 1 here; the grid
subclass (model/grid.py) sets it to the number of grid points.

The fit runs in chunks of ``chunk_iters`` iterations (one chunk at S < 8,
50 at S >= 8): between chunks the ladder's counters carry over, and once the
live lanes have shrunk four-fold they are compacted to the next power-of-2
width (padded with frozen duplicates of a live lane) and the sweep rule is
decided again for that width, as in the JAX package.

Randomness is the JAX package's: the initial pi draw and the restart draws
are numpy draws from ``rng`` (default: numpy's global stream), so
``np.random.seed(s)`` gives both packages the same theta_0.
"""

import logging

import numpy as np
import torch

from . import _dispatch
from .base import BayesPRSModel
from ..data.ldsc import simple_ldsc
from ..ops import em_loop, updates
from ..ops.cavi_torch import CaviState, Hyper
from ..ops.updates import FixMask
from ..utils import optimize as opt
from ..utils.optimize import OptimizeResult

logger = logging.getLogger(__name__)

F32 = torch.float32
#: LD tiles infer_lambda_min converts to float64 at a time (8 MB each at
#: B = 1024).
LAMBDA_CHUNK = 16


def _logit(p):
    return np.log(p) - np.log1p(-p)


class VIPRS(BayesPRSModel):

    def __init__(self, dataset, device, lambda_min=None, fix_params=None):
        """
        :param dataset: a viprs_tpu_torch SummaryStatsDataset.
        :param device: the device the fit runs on; it must hold the
            dataset's LD ('cuda' runs the CUDA kernels, 'cpu' their plain
            versions).
        :param lambda_min: None (0) or a number.
        :param fix_params: dict pinning hyperparameters out of the M-step
            (keys 'pi', 'tau_beta', 'sigma_epsilon', 'lambda_min').
        """
        super().__init__(dataset, device)
        self.fix_params = dict(fix_params or {})
        self.lambda_min = 0.0 if lambda_min is None else float(lambda_min)
        self._S = 1
        self._state = None             # CaviState, (S, NB, B) float32
        self._hyper = None             # Hyper of (S,) float64 numpy
        self._sigma_g = np.zeros(1)
        self._fix_mask = None          # FixMask of (S,) bool numpy
        self.optim_result = OptimizeResult()
        self.history = {}
        self._act_trace = []
        self._chunk_trace = []
        self._n_skip = 0
        self._last_result = None
        self._std_beta_flat = self._n_flat = None
        self._refresh_inputs()

    # ------------------------------------------------------------ init
    def _resolve_theta0(self, theta_0, rng):
        """The reference initialization: returns (pi, sigma_eps, tau_beta)."""
        theta_0 = dict(theta_0 or {})
        theta_0.update(self.fix_params)
        m = self.n_snps
        if 'pi' in theta_0:
            pi = float(theta_0['pi'])
        else:
            pi = float(rng.uniform(low=max(10.0 / m, 1e-5),
                                   high=min(0.2, 1e4 / m)))
        if 'sigma_epsilon' not in theta_0:
            if 'tau_beta' not in theta_0:
                naive_h2g = float(np.clip(simple_ldsc(self.dataset), 0.01, 0.99))
                sigma_eps = 1.0 - naive_h2g
                tau_beta = pi * m / max(naive_h2g, 0.01)
            else:
                tau_beta = float(theta_0['tau_beta'])
                sigma_eps = float(np.clip(1.0 - (pi * m / tau_beta),
                                          1e-4, 1.0 - 1e-4))
        else:
            sigma_eps = float(theta_0['sigma_epsilon'])
            if 'tau_beta' in theta_0:
                tau_beta = float(theta_0['tau_beta'])
            else:
                tau_beta = (pi * m) / max(0.01, 1.0 - sigma_eps)
        return pi, sigma_eps, tau_beta

    def initialize_theta(self, theta_0=None, rng=None):
        rng = np.random if rng is None else rng
        pi, sigma_eps, tau_beta = self._resolve_theta0(theta_0, rng)
        lam = float(self.fix_params.get('lambda_min', self.lambda_min))
        S = self._S
        self._hyper = Hyper(sigma_eps=np.full(S, sigma_eps),
                            tau_beta=np.full(S, tau_beta),
                            pi=np.full(S, pi), lambda_min=np.full(S, lam))
        self._sigma_g = np.zeros(S)
        self._update_fix_mask()

    def set_fixed_params(self, fix_params):
        """Pin hyperparameters (reference VIPRS.py:361-379)."""
        self.fix_params.update(fix_params)
        if self._hyper is not None:
            h = {f: np.array(getattr(self._hyper, f), np.float64).reshape(-1)
                 for f in Hyper._fields}
            key_map = {'sigma_epsilon': 'sigma_eps', 'tau_beta': 'tau_beta',
                       'pi': 'pi', 'lambda_min': 'lambda_min'}
            for key, val in fix_params.items():
                if key in key_map:
                    h[key_map[key]][:] = val
            self._hyper = Hyper(**h)
            if 'lambda_min' in fix_params:
                self.lambda_min = float(fix_params['lambda_min'])
            self._update_fix_mask()

    def _update_fix_mask(self):
        S = self._S
        self._fix_mask = FixMask(*(np.full(S, k in self.fix_params, bool)
                                   for k in ('sigma_epsilon', 'tau_beta',
                                             'pi')))

    def initialize_variational_parameters(self):
        lay = self.dataset.layout
        shape = (self._S, lay.nb, lay.block_size)
        logits = torch.from_numpy(
            _logit(np.asarray(self._hyper.pi, np.float64)).astype(np.float32))
        self._state = CaviState(
            logits=logits.to(self.device)[:, None, None].expand(shape)
            .contiguous(),
            mu=torch.zeros(shape, dtype=F32, device=self.device),
            eta=torch.zeros(shape, dtype=F32, device=self.device),
            q=torch.zeros(shape, dtype=F32, device=self.device))

    # ------------------------------------------------------------ fit
    def fit(self, max_iter=1000, theta_0=None, min_iter=3, f_abs_tol=1e-6,
            x_abs_tol=1e-6, patience=10, max_restarts=1, chunk_iters=None,
            sweep_impl=None, hybrid_eps=None, rng=None):
        """Variational EM fit to convergence (the reference's VIPRS.fit).

        :param max_restarts: 0 or 1 — restart once, with sigma_epsilon fixed
            at 0.95, when the MSE goes negative (inside the loop for a
            one-chunk S = 1 fit, between chunks otherwise).
        :param chunk_iters: iterations per em_fit call (default: all at
            S < 8, 50 at S >= 8, where lanes are compacted between chunks).
        :param sweep_impl: None, 'hybrid' (S = 1), 'xla'/'pallas' or 'skip';
            see model/_dispatch.py.
        :param hybrid_eps: gate epsilon of the hybrid's proposal mask
            (default ``x_abs_tol``).
        :param rng: numpy ``RandomState`` (or the ``np.random`` module, the
            default) for the pi draws.
        """
        if max_restarts not in (0, 1):
            raise ValueError("max_restarts must be 0 or 1")
        rng = np.random if rng is None else rng
        S = self._S
        use_skip, use_hybrid = _dispatch.select_sweep_impl(S, sweep_impl)
        self._refresh_inputs()
        self.initialize_theta(theta_0, rng)
        self.initialize_variational_parameters()
        self.optim_result.reset()
        if chunk_iters is None:
            chunk_iters = 50 if S >= 8 else max_iter
        chunk_iters = max(1, min(chunk_iters, max_iter))

        # A one-chunk S = 1 fit restarts inside the loop: the restart theta
        # is drawn now (the one rng.uniform the reference makes at restart
        # time) without advancing the stream, and consumed after the fit
        # only if the restart fired. Chunked and grid fits restart on the
        # host between chunks (_restart_models).
        ingraph_restart = (S == 1 and chunk_iters >= max_iter
                           and max_restarts == 1
                           and 'sigma_epsilon' not in self.fix_params)
        r_hyper = r_logit = rng_after = None
        restarts = 0
        if ingraph_restart:
            before = rng.get_state()
            r_pi, r_se, r_tau = self._resolve_theta0(
                {**dict(theta_0 or {}), 'sigma_epsilon': 0.95}, rng)
            rng_after = rng.get_state()
            rng.set_state(before)
            r_hyper = (r_se, r_tau, r_pi)
            r_logit = np.float32(_logit(r_pi))
            restarts = max_restarts    # the host restart must not re-fire

        ld, dev = self.dataset.ld, self.device
        init_elbo = last_elbo = None
        elbo_hist = []
        counters = em_loop.init_counters(S)
        active = np.ones(S, bool)
        statuses = np.full(S, opt.MAX_ITER, np.int32)
        nit_acc = np.zeros(S, np.int32)
        med_acc = np.zeros(S)
        S_run = S
        it_done = n_skip = 0
        self._chunk_trace = []     # (width, use_skip, use_hybrid) per chunk
        self._act_trace = []       # active blocks per iteration (skip rules)

        while it_done < max_iter:
            this_chunk = min(chunk_iters, max_iter - it_done)
            n_act = int(active.sum())
            # compact the live lanes to the next power-of-2 width once they
            # shrink four-fold (never on the first chunk, which fills the
            # full-width objectives the history is back-filled from)
            bucket = min(S, 1 << max(0, int(np.ceil(np.log2(max(n_act, 1))))))
            if last_elbo is None:
                bucket = S
            if bucket > S_run:          # restarts can re-activate lanes
                S_run = bucket
            elif S >= 8 and bucket <= S_run // 4:
                S_run = bucket
            compact = S_run < S
            if compact:
                sel = np.nonzero(active)[0]
                sel_pad = np.concatenate(
                    [sel, np.full(S_run - n_act, sel[0])]).astype(np.int64)
                sel_dev = torch.from_numpy(sel_pad).to(dev)
                state_in = CaviState(*(x.index_select(0, sel_dev)
                                       for x in self._state))
                hyper_in = Hyper(*(np.asarray(x)[sel_pad] for x in self._hyper))
                fix_in = FixMask(*(np.asarray(x)[sel_pad]
                                   for x in self._fix_mask))
                counters_in = em_loop.EMCounters(*(x[sel_pad] for x in counters))
                init_elbo_in = None if init_elbo is None else init_elbo[sel_pad]
                active_in = np.arange(S_run) < n_act
                sigma_g_in = self._sigma_g[sel_pad]
                if sweep_impl is None:
                    run_skip, run_hybrid = _dispatch.select_sweep_impl(S_run)
                else:
                    run_skip, run_hybrid = use_skip, use_hybrid
            else:
                state_in, hyper_in = self._state, self._hyper
                fix_in, counters_in = self._fix_mask, counters
                init_elbo_in, active_in = init_elbo, active
                sigma_g_in = self._sigma_g
                run_skip, run_hybrid = use_skip, use_hybrid
            self._chunk_trace.append((S_run, run_skip, run_hybrid))

            res = em_loop.em_fit(
                ld, state_in, self._std_beta_flat, self._n_flat, hyper_in,
                fix_in, n_sample=float(self.n), m_total=float(self.m),
                init_elbo=init_elbo_in, active0=active_in,
                max_iter=this_chunk, min_iter=min_iter, f_abs_tol=f_abs_tol,
                x_abs_tol=x_abs_tol, patience=patience, use_skip=run_skip,
                use_hybrid=run_hybrid, hybrid_eps=hybrid_eps, i0=it_done,
                counters0=counters_in, sigma_g0=sigma_g_in,
                max_restarts=1 if ingraph_restart else 0,
                restart_hyper=r_hyper, restart_logit=r_logit)
            n_in_chunk = res.n_iter_total
            it_done += n_in_chunk
            n_skip += res.n_skip
            if run_skip or run_hybrid:
                self._act_trace.extend(res.act_hist[1:])

            if compact:
                sel_dev = torch.from_numpy(sel).to(dev)
                for full, part in zip(self._state, res.state):
                    full.index_copy_(0, sel_dev, part[:n_act])
                hyper = {f: np.array(x, np.float64)
                         for f, x in zip(Hyper._fields, self._hyper)}
                for f, x in zip(Hyper._fields, res.hyper):
                    hyper[f][sel] = x[:n_act]
                self._hyper = Hyper(**hyper)
                self._sigma_g = self._sigma_g.copy()
                self._sigma_g[sel] = res.sigma_g[:n_act]
                counters = em_loop.EMCounters(*(c.copy() for c in counters))
                for c, p in zip(counters, res.counters):
                    c[sel] = p[:n_act]
                statuses[sel] = res.status[:n_act]
                nit_acc[sel] = res.nit[:n_act]
                med_acc[sel] = res.max_eta_diff[:n_act]
                fill = init_elbo if init_elbo is not None else last_elbo
                for row in res.elbo_hist[1:]:
                    full_row = fill.copy()
                    full_row[sel] = row[:n_act]
                    elbo_hist.append(full_row)
                init_elbo = fill.copy()
                init_elbo[sel] = res.final_elbo[:n_act]
            else:
                counters = res.counters
                if ingraph_restart and res.restarts_used.max() > 0:
                    logger.info("MSE was negative; the fit restarted with "
                                "sigma_epsilon fixed at 0.95 (reference "
                                "behavior).")
                    self.fix_params['sigma_epsilon'] = 0.95
                    self._update_fix_mask()
                    rng.set_state(rng_after)
                self._state = res.state
                self._hyper = res.hyper
                self._sigma_g = res.sigma_g
                statuses[active] = res.status[active]
                nit_acc[active] = res.nit[active]
                med_acc[active] = res.max_eta_diff[active]
                elbo_hist.extend(res.elbo_hist[0 if not elbo_hist else 1:])
                init_elbo = res.final_elbo
            last_elbo = init_elbo
            self._last_result = em_loop.EMResult(
                state=None, hyper=None, sigma_g=None, status=statuses.copy(),
                nit=nit_acc.copy(), elbo_hist=None, n_iter_total=it_done,
                final_elbo=init_elbo.copy(), counters=None,
                max_eta_diff=med_acc.copy(), restarts_used=None,
                act_hist=None, n_skip=n_skip)

            # restart on negative MSE (VIPRS.py:1025-1038), between chunks
            restart_mask = ((statuses == opt.MSE_NEGATIVE)
                            & ~self._fix_mask.sigma_eps
                            & (restarts < max_restarts))
            if restart_mask.any():
                restarts += 1
                logger.info("MSE is negative; restarting optimization with "
                            "sigma_epsilon fixed at 0.95 (reference "
                            "behavior).")
                self._restart_models(restart_mask, theta_0, rng)
                init_elbo = None       # the next chunk computes it
                fresh = em_loop.init_counters(S)
                counters = em_loop.EMCounters(*(
                    np.where(restart_mask, f, c) for f, c in zip(fresh, counters)))
                active = restart_mask | (statuses == opt.MAX_ITER)
                continue
            # lanes with status MAX_ITER only exhausted this chunk's budget
            active = statuses == opt.MAX_ITER
            if not active.any():
                break

        self.history = {'ELBO': [float(r[0]) for r in elbo_hist] if S == 1
                        else elbo_hist}
        self._n_skip = n_skip
        self._pip = self._post_mean_beta = self._post_var_beta = None
        self._populate_optim_result(self._last_result)
        if not self.optim_result.success:
            logger.warning("\t%s", self.optim_result.message)
        return self

    def _restart_models(self, restart_mask, theta_0, rng):
        """Re-initialize the masked lanes with sigma_epsilon fixed at 0.95;
        fixed or gridded hyperparameters keep their values (the reference's
        restart re-runs initialize_theta, VIPRS.py:1032-1036)."""
        self.fix_params['sigma_epsilon'] = 0.95
        pi, _, tau_beta = self._resolve_theta0(theta_0, rng)
        h = {f: np.array(x, np.float64) for f, x in zip(Hyper._fields,
                                                         self._hyper)}
        h['sigma_eps'][restart_mask] = 0.95
        h['pi'][restart_mask & ~self._fix_mask.pi] = pi
        h['tau_beta'][restart_mask & ~self._fix_mask.tau_beta] = tau_beta
        self._hyper = Hyper(**h)
        self._update_fix_mask()
        dev = self.device
        m3 = torch.from_numpy(restart_mask).to(dev)[:, None, None]
        fresh = torch.from_numpy(_logit(h['pi']).astype(np.float32)).to(dev)
        zero = torch.zeros((), dtype=F32, device=dev)
        st = self._state
        self._state = CaviState(
            logits=torch.where(m3, fresh[:, None, None], st.logits),
            mu=torch.where(m3, zero, st.mu), eta=torch.where(m3, zero, st.eta),
            q=torch.where(m3, zero, st.q))
        self._sigma_g = np.where(restart_mask, 0.0, self._sigma_g)

    def _populate_optim_result(self, res):
        self.optim_result = OptimizeResult.from_status(
            res.status[0], res.final_elbo[0], res.nit[0])

    # ------------------------------------------------------- LD spectrum
    def infer_lambda_min(self):
        """Spectral regularizer: |min(0, smallest eigenvalue over the LD
        blocks)| (the analog of LDMatrix.get_lambda_min, use-site
        VIPRS.py:191), in float64 on the LD's device, ``LAMBDA_CHUNK``
        tiles at a time: each diagonal tile's eigenvalues where the LD has no
        coupling tiles, else a Gershgorin lower bound per row, the coupling
        tiles' absolute row and column sums added to their rows."""
        ld = self.dataset.ld
        f64 = torch.float64

        def tiles(x, i):
            return x[i:i + LAMBDA_CHUNK].to(f64) * ld.scale
        if ld.n_off == 0:
            low = torch.zeros((), dtype=f64, device=ld.device)
            for i in range(0, ld.nb, LAMBDA_CHUNK):
                w = torch.linalg.eigvalsh(tiles(ld.diag, i))
                low = torch.minimum(low, w[:, 0].min())
            return abs(min(0.0, float(low)))
        row_abs = torch.empty(ld.nb, ld.block_size, dtype=f64,
                              device=ld.device)
        for i in range(0, ld.nb, LAMBDA_CHUNK):
            d = tiles(ld.diag, i).abs()
            row_abs[i:i + LAMBDA_CHUNK] = d.sum(dim=2) \
                - torch.diagonal(d, dim1=1, dim2=2)
        for i in range(0, ld.n_off, LAMBDA_CHUNK):
            o = tiles(ld.off_data, i).abs()
            row_abs.index_add_(0, ld.off_src[i:i + LAMBDA_CHUNK].long(),
                               o.sum(dim=2))
            row_abs.index_add_(0, ld.off_dst[i:i + LAMBDA_CHUNK].long(),
                               o.sum(dim=1))
        return abs(min(0.0, float((1.0 - row_abs).min())))

    # ------------------------------------------------------ validation
    def pseudo_validate(self, test_gdl=None):
        """Pseudo-R^2 per lane on the held-out half of a PUMAS split, from
        the cached q (``_lane_pseudo_r2``). A float at S = 1."""
        if test_gdl is not None or self.validation_std_beta is None \
                or self._state is None:
            return super().pseudo_validate(test_gdl)
        out = self._lane_pseudo_r2(self._state.eta, self._state.q)
        return float(out[0]) if self._S == 1 else out

    # ------------------------------------------------------------ objective
    def _hyper_dev(self):
        return Hyper(*(torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
                       for x in self._hyper))

    def elbo(self):
        """The ELBO of the current state, per lane (a float at S = 1)."""
        h = self._hyper_dev()
        var_tau = updates.compute_var_tau(self._n_flat, h)
        st = updates.collect_stats(self._state, var_tau, self._std_beta_flat,
                                   self.dataset.ld.mask)
        st = updates.SweepStats(*(x.cpu() for x in st))
        e = updates.elbo(st, Hyper(*(x.cpu() for x in h)),
                         torch.from_numpy(np.array(self._fix_mask.sigma_eps)),
                         torch.from_numpy(np.array(self._sigma_g, np.float64)),
                         float(self.n), float(self.m))
        return self._scalar(e.numpy())

    def objective(self):
        return self.elbo()

    # ------------------------------------------------------------ posterior
    def _materialize_posterior_moments(self):
        if self._state is None:
            return
        var_tau = updates.compute_var_tau(self._n_flat, self._hyper_dev())
        zeta = updates.compute_zeta(self._state, var_tau)
        eta = self._state.eta
        self._pip = self._dict_view(self._state.gamma)
        self._post_mean_beta = self._dict_view(eta)
        self._post_var_beta = self._dict_view(zeta - eta * eta)

    # ------------------------------------------------------------ getters
    def _scalar(self, arr):
        a = np.atleast_1d(np.asarray(arr))
        return float(a[0]) if (self._S == 1 and a.size == 1) else a

    @property
    def sigma_epsilon(self):
        return self._scalar(self._hyper.sigma_eps)

    @property
    def tau_beta(self):
        return self._scalar(self._hyper.tau_beta)

    @property
    def pi(self):
        return self._scalar(self._hyper.pi)

    @property
    def sigma_g(self):
        return self._scalar(self._sigma_g)

    def get_sigma_epsilon(self):
        return self.sigma_epsilon

    def get_tau_beta(self):
        return self.tau_beta

    def get_pi(self):
        return self.pi

    def get_proportion_causal(self):
        return self.pi

    def get_average_effect_size_variance(self):
        return self._scalar(np.asarray(self._hyper.pi)
                            / np.asarray(self._hyper.tau_beta))

    def get_heritability(self):
        sg = np.asarray(self._sigma_g)
        return self._scalar(sg / (sg + np.asarray(self._hyper.sigma_eps)))
