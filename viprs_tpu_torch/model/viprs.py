"""VIPRS — the spike-and-slab variational PRS model, with S model lanes.

Counterpart of viprs_tpu.model.viprs.VIPRS: initialization from LDSC (or a
warm start from given posterior parameters), the CAVI e-step (CUDA kernels
on the card, plain PyTorch on the CPU), the closed-form M-step, the ELBO and
its terms, the convergence ladder and the restart on negative MSE, all
through ops/em_loop.em_fit; the reference's manual EM API (``e_step``,
``m_step``, ``update_*``), tracked per-iteration history, progress
reporting, continued fits and checkpoints. ``_S`` is 1 here; the grid
subclass (model/grid.py) sets it to the number of grid points.

The fit runs in chunks of ``chunk_iters`` iterations: one chunk by default
at S < 8 and 50 at S >= 8, chunks of 25 with a progress bar or callback and
of 1 with tracked parameters. Between chunks the ladder's counters carry
over, so chunking changes no number; once the live lanes have shrunk
four-fold they are compacted to the next power-of-2 width (padded with
frozen duplicates of a live lane) and the sweep rule is decided again for
that width, as in the JAX package.

Randomness is the JAX package's: the initial pi draw and the restart draws
are numpy draws from ``rng`` (default: numpy's global stream), so
``np.random.seed(s)`` gives both packages the same theta_0.
"""

import logging

import numpy as np
import torch

from . import _dispatch
from .base import BayesPRSModel, history_table
from ..data.ldsc import simple_ldsc
from ..ops import cavi_cuda, em_loop, updates
from ..ops.cavi_torch import INNER_STEPS, TILE, CaviState, Hyper, compute_q
from ..ops.updates import FixMask
from ..utils import optimize as opt
from ..utils.optimize import OptimizeResult

logger = logging.getLogger(__name__)

F32 = torch.float32
#: LD tiles infer_lambda_min converts to float64 at a time (8 MB each at
#: B = 1024).
LAMBDA_CHUNK = 16
#: Chunk widths of a fit with a progress bar or callback (live ELBO between
#: chunks) and with tracked parameters (history every iteration).
PROGRESS_CHUNK = 25
TRACKED_CHUNK = 1


def _logit(p):
    return np.log(p) - np.log1p(-p)


class VIPRS(BayesPRSModel):

    def __init__(self, dataset, device, lambda_min=None, fix_params=None,
                 tracked_params=None, float_precision='float32', order='F',
                 low_memory=True, dequantize_on_the_fly=False, threads=1,
                 tile=TILE, mesh='auto'):
        """
        :param dataset: a viprs_tpu_torch SummaryStatsDataset.
        :param device: the device the fit runs on; it must hold the
            dataset's LD ('cuda' runs the CUDA kernels, 'cpu' their plain
            versions).
        :param lambda_min: None (0), a number, or 'infer' (the spectral
            regularizer of the LD, ``infer_lambda_min``).
        :param fix_params: dict pinning hyperparameters out of the M-step
            (keys 'pi', 'tau_beta', 'sigma_epsilon', 'lambda_min').
        :param tracked_params: quantities recorded in ``history`` at every
            iteration: 'pi', 'pis', 'heritability', 'sigma_epsilon',
            'tau_beta', 'sigma_g', 'entropy', 'loglikelihood', 'log_prior',
            'mse', 'max_eta_diff', or callables taking the model (recorded
            under their ``__name__``).
        :param float_precision: sets ``float_eps`` only; the state is
            float32 whatever is passed, as in the JAX package.
        :param order, low_memory, dequantize_on_the_fly, threads: accepted
            for reference-API compatibility: the sweep is the blocked update
            schedule itself, and the LD's storage is the dataset's choice
            (pack it with ``quantize=True`` for int8).
        :param tile: the sweeps' tile width; the port's is T = 128 and
            another value raises.
        :param mesh: ``'auto'`` (every process on the ``blocks`` axis when
            there are several, else one device), ``'off'``/None (one
            device), ``'<NB>x<NG>'`` or a ``parallel.mesh.Mesh``: the fit
            runs over the processes of ``torch.distributed``'s default
            group (``parallel.init_distributed``), each rank on its range
            of the LD blocks and, where the grid axis divides S, of the
            lanes (parallel/mesh.py).
        """
        super().__init__(dataset, device, float_precision=float_precision,
                         mesh=_dispatch.resolve_mesh(mesh))
        self.fix_params = dict(fix_params or {})
        self.tracked_params = list(tracked_params or [])
        self.tile = _dispatch.check_tile(tile)
        self.threads = threads
        # the pathwise grid holds every lane on every rank (lanes whole)
        self._lanes_whole = False
        self._layouts = {}
        if isinstance(lambda_min, str) and lambda_min == 'infer':
            self.lambda_min = self.infer_lambda_min()
        else:
            self.lambda_min = 0.0 if lambda_min is None else float(lambda_min)
        self._S = 1
        self._state = None             # CaviState, (S, NB, B) float32
        self._hyper = None             # Hyper of (S,) float64 numpy
        self._sigma_g = np.zeros(1)
        self._fix_mask = None          # FixMask of (S,) bool numpy
        self._last_eta_diff = None
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

    def initialize(self, theta_0=None, param_0=None, rng=None):
        """Initial hyperparameters (``initialize_theta``), variational
        parameters (``initialize_variational_parameters``) and an empty
        history (``init_optim_meta``)."""
        self.initialize_theta(theta_0, rng)
        self.initialize_variational_parameters(param_0)
        self.init_optim_meta()

    def init_optim_meta(self):
        """An empty history (ELBO and each tracked quantity) and a reset
        optimization record."""
        self.history = {'ELBO': []}
        for tt in self.tracked_params:
            self.history[tt if isinstance(tt, str) else tt.__name__] = []
        self.optim_result.reset()

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

    def initialize_variational_parameters(self, param_0=None):
        """The initial state: gamma = pi and mu = 0, or a warm start from
        ``param_0`` ({'gamma': {chrom: array}, 'mu': {chrom: array}}, either
        or both; gamma clipped to [1e-8, 1 - 1e-8]; every lane starts from
        the same values), whose q = (R - I) eta is computed on the LD's
        device (``compute_q``)."""
        param_0 = param_0 or {}
        lay = self.dataset.layout
        l0, l1 = self._lane_range()
        shape = (l1 - l0, self._ld.nb, lay.block_size)
        dev = self.device

        def lanes(flat):
            return self._local(np.asarray(flat, np.float32).reshape(
                1, lay.nb, lay.block_size)).expand(shape).contiguous()
        if 'gamma' in param_0:
            g = np.clip(lay.to_flat(param_0['gamma']), 1e-8, 1 - 1e-8)
            logits = lanes(_logit(g))
        else:
            pi = torch.from_numpy(
                _logit(np.asarray(self._hyper.pi, np.float64))
                .astype(np.float32)[l0:l1]).to(dev)
            logits = pi[:, None, None].expand(shape).contiguous()
        if 'mu' in param_0:
            mu = lanes(lay.to_flat(param_0['mu']))
        else:
            mu = torch.zeros(shape, dtype=F32, device=dev)
        if 'mu' in param_0 or 'gamma' in param_0:
            eta = torch.sigmoid(logits) * mu * self._ld.mask[None]
            q = compute_q(self._ld, eta) if self.mesh is None else \
                self._ld.compute_q(eta)
        else:
            eta = torch.zeros(shape, dtype=F32, device=dev)
            q = torch.zeros(shape, dtype=F32, device=dev)
        self._state = CaviState(logits=logits, mu=mu, eta=eta, q=q)
        self._clear_posterior()

    def _clear_posterior(self):
        self._pip = self._post_mean_beta = self._post_var_beta = None

    # ------------------------------------------------------- the mesh
    def _lanes_split(self):
        return (self.mesh is not None and not self._lanes_whole
                and self.mesh.splits_lanes(self._S))

    def _lane_range(self):
        """The lanes [l0, l1) of ``_S`` this rank holds (all of them off a
        mesh or where the grid axis does not split them)."""
        if not self._lanes_split():
            return 0, self._S
        return self.mesh.lane_range(self._S)

    def _lane_layout(self):
        """``Mesh.lane_layout`` of this rank's lanes where they are split
        (a collective the first time for each S), else None."""
        if not self._lanes_split():
            return None
        if self._S not in self._layouts:
            self._layouts[self._S] = self.mesh.lane_layout(
                np.arange(*self._lane_range()))
        return self._layouts[self._S]

    def _sweep_args(self):
        """(the BlockLD the sweeps take, their ``halo``): this rank's
        blocks and its halo exchange under a mesh."""
        if self.mesh is None:
            return self._ld, None
        return self._ld.ld, self._ld.couple

    # ------------------------------------------------- manual EM stepping
    # (the reference API: VIPRS.e_step / m_step / update_* drive EM by
    # hand, VIPRS.py:381-495; fit() runs ops/em_loop instead, with the
    # same arithmetic)
    def e_step(self):
        """One CAVI sweep over every variant of every lane, at full step
        (K1 with ``coupling_pass_s1`` at S = 1, K3 with ``coupling_pass_s``
        at S > 1 on the card; their plain versions on the CPU). Keeps the
        sweep's eta change as ``_last_eta_diff``."""
        act = torch.ones(self._state.eta.shape[0], dtype=F32,
                         device=self.device)
        sweep = cavi_cuda.cavi_sweep_s1 if self._S == 1 \
            else cavi_cuda.cavi_sweep_s
        ld, halo = self._sweep_args()
        self._state, self._last_eta_diff = sweep(
            ld, self._state, self._std_beta_flat, self._n_flat,
            self._hyper_dev(), act, halo=halo)
        self._clear_posterior()
        return self

    def m_step(self):
        """The closed-form hyperparameter updates (VIPRS.py:473-484), fixed
        parameters kept."""
        stats = self._host_stats()
        hyper = Hyper(*(torch.from_numpy(np.array(x, np.float64).reshape(-1))
                        for x in self._hyper))
        new, sigma_g = updates.m_step(stats, hyper,
                                      FixMask.from_numpy(*self._fix_mask),
                                      float(self.m),
                                      torch.ones(self._S, dtype=torch.bool))
        self._hyper = Hyper(*(x.numpy() for x in new))
        self._sigma_g = sigma_g.numpy()
        self._clear_posterior()
        return self

    def _set_unfixed(self, name, value):
        if name not in self.fix_params:
            h = {f: np.array(x, np.float64).reshape(-1)
                 for f, x in zip(Hyper._fields, self._hyper)}
            h[{'pi': 'pi', 'tau_beta': 'tau_beta',
               'sigma_epsilon': 'sigma_eps'}[name]][:] = np.asarray(value)
            self._hyper = Hyper(**h)
            self._clear_posterior()

    def update_pi(self):
        """pi = mean(gamma) (VIPRS.py:426-434)."""
        stats = self._host_stats()
        self._set_unfixed('pi', stats.sum_gamma.numpy() / float(self.m))
        return self

    def update_tau_beta(self):
        """tau_beta = pi * M / sum(zeta) (VIPRS.py:436-444)."""
        stats = self._host_stats()
        pi = np.array(self._hyper.pi, np.float64).reshape(-1)
        self._set_unfixed('tau_beta',
                          pi * float(self.m) / stats.sum_zeta.numpy())
        return self

    def _sigma_g_of(self, stats):
        lam = np.array(self._hyper.lambda_min, np.float64).reshape(-1)
        return (1.0 + lam) * stats.sum_zeta.numpy() + stats.sum_q_eta.numpy()

    def _update_sigma_g(self):
        """sigma_g = sum((1 + lambda_min) zeta + q eta) (VIPRS.py:446-457)."""
        self._sigma_g = self._sigma_g_of(self._host_stats())
        return self._sigma_g

    def update_sigma_epsilon(self):
        """sigma_eps = 1 - 2 beta'eta + sigma_g (VIPRS.py:459-471); sets
        sigma_g too."""
        stats = self._host_stats()
        self._sigma_g = self._sigma_g_of(stats)
        self._set_unfixed('sigma_epsilon',
                          1.0 - 2.0 * stats.sum_beta_eta.numpy()
                          + self._sigma_g)
        return self

    def update_theta_history(self):
        """Record the tracked quantities of the current state
        (VIPRS.py:839-873)."""
        self._track_iteration()
        return self

    # ------------------------------------------------------------ fit
    def fit(self, max_iter=1000, theta_0=None, param_0=None, continued=False,
            disable_pbar=True, min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6,
            patience=10, max_restarts=1, chunk_iters=None,
            progress_callback=None, sweep_impl=None, hybrid_eps=None,
            inner_steps=INNER_STEPS, compile_only=False, rng=None):
        """Variational EM fit to convergence (the reference's VIPRS.fit).

        :param param_0: a warm start ({'gamma': ..., 'mu': ...}, see
            ``initialize_variational_parameters``).
        :param continued: go on from the current state, hyperparameters and
            history (an earlier fit, ``initialize`` or
            ``load_checkpoint``), without initializing; the history's first
            entry is written only when it is empty.
        :param disable_pbar: False shows a progress bar (tqdm, else a log
            line a chunk) and runs chunks of 25 iterations.
        :param max_restarts: 0 or 1 — restart once, with sigma_epsilon fixed
            at 0.95, when the MSE goes negative (inside the loop for a
            one-chunk S = 1 fit that does not continue, between chunks
            otherwise; the same trajectory and numpy stream either way).
        :param chunk_iters: iterations per em_fit call (default: 1 with
            tracked parameters, 25 with a progress bar or callback, all at
            S < 8, 50 at S >= 8, where lanes are compacted between chunks).
        :param progress_callback: called as ``callback(model, iterations
            done, per-lane statuses)`` after every chunk (of 25 unless
            tracking).
        :param sweep_impl: None, 'hybrid' (S = 1), 'xla'/'pallas' or 'skip';
            see model/_dispatch.py.
        :param hybrid_eps: gate epsilon of the hybrid's proposal mask
            (default ``x_abs_tol``).
        :param inner_steps: the sweeps' inner steps per tile (the kernels
            take any count; the plain versions only INNER_STEPS, and refuse
            another before anything runs).
        :param compile_only: build (or find) the kernel library the fit
            would launch, and return without changing the state, the
            history or the numpy stream (``viprs_warmup_torch``); on the
            CPU there is nothing to build.
        :param rng: numpy ``RandomState`` (or the ``np.random`` module, the
            default) for the pi draws.
        """
        if max_restarts not in (0, 1):
            raise ValueError("max_restarts must be 0 or 1")
        rng = np.random if rng is None else rng
        S = self._S
        use_skip, use_hybrid = _dispatch.select_sweep_impl(S, sweep_impl)
        cavi_cuda.check_inner_steps(self.device, inner_steps)
        if compile_only:
            cavi_cuda.build_for(self._sweep_args()[0])
            return self
        if continued and self._state is None:
            raise ValueError("continued=True needs a state: fit, initialize "
                             "or load_checkpoint first")
        self._refresh_inputs()
        if not continued:
            self.initialize(theta_0, param_0, rng)
        if chunk_iters is None:
            if self.tracked_params:
                chunk_iters = TRACKED_CHUNK
            elif not disable_pbar or progress_callback is not None:
                chunk_iters = PROGRESS_CHUNK
            else:
                chunk_iters = 50 if S >= 8 else max_iter
        chunk_iters = max(1, min(chunk_iters, max_iter))

        # history slot 0 (the initial objective) is written only when the
        # history is empty: a continued fit appends to the one it has
        hist0_needed = not continued or not self.history.get('ELBO')
        if hist0_needed:
            self.history['ELBO'] = []
        hist = self.history['ELBO']
        self._track_iteration()

        # A one-chunk S = 1 fit restarts inside the loop: the restart theta
        # is drawn now (the one rng.uniform the reference makes at restart
        # time) without advancing the stream, and consumed after the fit
        # only if the restart fired. Chunked, continued and grid fits
        # restart on the host between chunks (_restart_models).
        ingraph_restart = (S == 1 and chunk_iters >= max_iter
                           and max_restarts == 1 and not continued
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
        pbar = None if disable_pbar else self._make_pbar(max_iter)

        ld, dev = self._ld, self.device
        split = self._lanes_split()
        l0, l1 = self._lane_range()
        init_elbo = last_elbo = None
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
            if self.mesh is not None:
                # compacted widths stay multiples of the mesh's grid axis
                g_ax = self.mesh.shape['grid']
                bucket = min(S, -(-bucket // g_ax) * g_ax)
            if bucket > S_run:          # restarts can re-activate lanes
                S_run = bucket
            elif S >= 8 and bucket <= S_run // 4:
                S_run = bucket
            compact = S_run < S
            if compact:
                sel = np.nonzero(active)[0]
                sel_pad = np.concatenate(
                    [sel, np.full(S_run - n_act, sel[0])]).astype(np.int64)
                # split lanes stay on their rank: it runs the chunk's slots
                # whose lane it holds (maybe none)
                mine = np.nonzero((sel_pad >= l0) & (sel_pad < l1))[0] \
                    if split else None
                rows = sel_pad if mine is None else sel_pad[mine] - l0
                sel_dev = torch.from_numpy(rows).to(dev)
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
                mine = np.arange(l0, l1) if split else None
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
                restart_hyper=r_hyper, restart_logit=r_logit,
                inner_steps=inner_steps, lanes=mine)
            n_in_chunk = res.n_iter_total
            it_done += n_in_chunk
            n_skip += res.n_skip
            if run_skip or run_hybrid:
                self._act_trace.extend(res.act_hist[1:])

            if compact:
                if mine is None:
                    dst = torch.from_numpy(sel).to(dev)
                    src = torch.arange(n_act, device=dev)
                else:
                    live = mine < n_act     # not a padding duplicate
                    dst = torch.from_numpy(sel_pad[mine[live]] - l0).to(dev)
                    src = torch.from_numpy(np.nonzero(live)[0]).to(dev)
                for full, part in zip(self._state, res.state):
                    full.index_copy_(0, dst, part.index_select(0, src))
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
                    hist.append(full_row)
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
                rows = res.elbo_hist[1:]
                if hist0_needed:
                    rows = res.elbo_hist
                    hist0_needed = False
                hist.extend(float(r[0]) if S == 1 else r.copy()
                            for r in rows)
                init_elbo = res.final_elbo
            last_elbo = init_elbo
            self._last_result = em_loop.EMResult(
                state=None, hyper=None, sigma_g=None, status=statuses.copy(),
                nit=nit_acc.copy(), elbo_hist=None, n_iter_total=it_done,
                final_elbo=init_elbo.copy(), mse_of=None, counters=None,
                max_eta_diff=med_acc.copy(), restarts_used=None,
                act_hist=None, n_skip=n_skip)
            if self.tracked_params:
                self._track_iteration(max_eta_diff=float(np.max(med_acc)))
            if pbar is not None:
                pbar.update(n_in_chunk)
                pbar.set_postfix({'ELBO': float(np.max(init_elbo))})
            if progress_callback is not None:
                progress_callback(self, it_done, statuses.copy())

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

        if pbar is not None:
            pbar.close()
        self._n_skip = n_skip
        self._clear_posterior()
        self._populate_optim_result(self._last_result)
        if not self.optim_result.success:
            logger.warning("\t%s", self.optim_result.message)
        return self

    @staticmethod
    def _make_pbar(total):
        """A tqdm progress bar, or where tqdm is not installed a stand-in
        that logs the iteration and the ELBO after every chunk."""
        try:
            from tqdm import tqdm
            return tqdm(total=total, desc='EM iterations', unit='it')
        except ImportError:
            class _LogBar:
                def __init__(self, total):
                    self.n, self.total, self._postfix = 0, total, {}

                def update(self, k):
                    self.n += k

                def set_postfix(self, d):
                    self._postfix = d
                    logger.info("iteration %d/%d | %s", self.n, self.total,
                                ', '.join(f'{k}={v:.4f}'
                                          for k, v in d.items()))

                def close(self):
                    pass
            return _LogBar(total)

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
        own = slice(*self._lane_range())
        m3 = torch.from_numpy(restart_mask[own]).to(dev)[:, None, None]
        fresh = torch.from_numpy(_logit(h['pi']).astype(np.float32)[
            own]).to(dev)
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

    def _track_iteration(self, max_eta_diff=None):
        """Append the tracked quantities of the current state to
        ``history`` (each a device reduction and one host read where it
        needs the state)."""
        for tt in self.tracked_params:
            if callable(tt):
                self.history.setdefault(tt.__name__, []).append(tt(self))
                continue
            if tt == 'max_eta_diff':
                if max_eta_diff is not None:
                    self.history.setdefault(tt, []).append(max_eta_diff)
                continue
            get = {'pi': self.get_proportion_causal,
                   'pis': lambda: self.pi,
                   'heritability': self.get_heritability,
                   'sigma_epsilon': lambda: self.sigma_epsilon,
                   'tau_beta': lambda: self.tau_beta,
                   'sigma_g': lambda: self.sigma_g,
                   'entropy': self.entropy,
                   'loglikelihood': self.loglikelihood,
                   'log_prior': self.log_prior,
                   'mse': self.mse}.get(tt)
            if get is not None:
                self.history.setdefault(tt, []).append(get())

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
        """The hyperparameters of this rank's lanes as float32 device
        tensors."""
        own = slice(*self._lane_range())
        return Hyper(*(torch.from_numpy(np.atleast_1d(np.asarray(
            x, np.float32))[own]).to(self.device) for x in self._hyper))

    def _hyper32(self):
        """The hyperparameters rounded through float32 (the values the
        device computes with), as (S,) float64 CPU tensors."""
        return Hyper(*(torch.from_numpy(np.asarray(x, np.float32).astype(
            np.float64).reshape(-1)) for x in self._hyper))

    def _host_stats(self):
        """The sweep statistics of the current state ((S,) float64 CPU
        tensors): one device reduction, one host read (under a mesh, then
        added over every rank)."""
        st = em_loop.read_stats(self._state, self._n_flat,
                                self._std_beta_flat, self._ld.mask,
                                self._hyper_dev())[0]
        if self.mesh is None:
            return st
        return updates.SweepStats(*(torch.from_numpy(r) for r in self._reduce(
            np.stack([x.numpy() for x in st]))))

    def _sigma_g_t(self):
        return torch.from_numpy(np.array(self._sigma_g, np.float64)
                                .reshape(-1))

    def elbo(self, sum_axis=None):
        """The ELBO of the current state, per lane (a float at S = 1)."""
        e = updates.elbo(self._host_stats(), self._hyper32(),
                         torch.from_numpy(np.array(self._fix_mask.sigma_eps)),
                         self._sigma_g_t(), float(self.n), float(self.m))
        return self._scalar(e.numpy())

    def objective(self):
        return self.elbo()

    def entropy(self, sum_axis=None):
        """Entropy of the variational distribution (VIPRS.py:583-612)."""
        return self._scalar(updates.entropy(self._host_stats(),
                                            float(self.m)).numpy())

    def log_prior(self, sum_axis=None):
        """Expected log prior (VIPRS.py:630-677)."""
        return self._scalar(updates.log_prior(
            self._host_stats(), self._hyper32(), float(self.m)).numpy())

    def loglikelihood(self):
        """Expected log-likelihood of the data (VIPRS.py:614-628)."""
        return self._scalar(updates.loglikelihood(
            self._host_stats(), self._hyper32(), self._sigma_g_t(),
            float(self.n)).numpy())

    def complete_loglikelihood(self):
        return self.loglikelihood() + self.log_prior()

    def mse(self, sum_axis=None):
        """The summary-statistics training MSE (VIPRS.py:689-704)."""
        return self._scalar(updates.mse(self._host_stats(),
                                        self._sigma_g_t()).numpy())

    # ------------------------------------------------------------ posterior
    @property
    def var_gamma(self):
        return self._dict_view(self._state.gamma)

    @property
    def var_mu(self):
        return self._dict_view(self._state.mu)

    def _var_tau_dev(self):
        return updates.compute_var_tau(self._n_flat, self._hyper_dev())

    @property
    def var_tau(self):
        return self._dict_view(self._var_tau_dev())

    @property
    def eta(self):
        return self._dict_view(self._state.eta)

    @property
    def zeta(self):
        return self._dict_view(updates.compute_zeta(self._state,
                                                    self._var_tau_dev()))

    @property
    def q(self):
        return self._dict_view(self._state.q)

    def q_dict(self):
        """{chrom: q}, the cached (R - I) eta of the state."""
        return self.q

    def compute_pip(self):
        return self.var_gamma

    def compute_eta(self):
        return self.eta

    def compute_zeta(self):
        return self.zeta

    def update_posterior_moments(self):
        """PIP, posterior mean and posterior variance (VIPRS.py:899-907),
        computed on the device and read to the host in one transfer."""
        zeta = updates.compute_zeta(self._state, self._var_tau_dev())
        eta = self._state.eta
        g, mean, var = torch.stack([self._state.gamma, eta,
                                    zeta - eta * eta]).cpu()
        self.pip = self._dict_view(g)
        self.post_mean_beta = self._dict_view(mean)
        self.post_var_beta = self._dict_view(var)

    def _materialize_posterior_moments(self):
        if self._state is not None:
            self.update_posterior_moments()

    # ------------------------------------------------------------ reporting
    def to_theta_table(self):
        """The fitted hyperparameters as a (Parameter, Value) Table, the JAX
        package's rows (viprs_tpu/model/viprs.py:614-627)."""
        return self._theta_table([
            ('ELBO', self.elbo()),
            ('Residual_variance', self.sigma_epsilon),
            ('Heritability', self.get_heritability()),
            ('Proportion_causal', self.get_proportion_causal()),
            ('Average_effect_variance',
             self.get_average_effect_size_variance()),
            ('Lambda_min', self.lambda_min),
            ('tau_beta', self.tau_beta)])

    def to_history_table(self):
        """``history`` as a Table (see ``base.history_table``)."""
        return history_table(self.history)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, f_name):
        """Write the variational state, the hyperparameters, sigma_g and the
        ELBO history to an .npz file with the JAX package's keys, shapes and
        dtypes (state (S, NB, B) float32, hyperparameters and sigma_g (S,)
        float64), so either package loads the other's file; resume with
        ``load_checkpoint`` and ``fit(continued=True)``. Under a mesh the
        state is gathered from every rank and rank 0 writes the file."""
        st = [self._global(x).cpu().numpy() for x in self._state]
        if self.mesh is not None and self.mesh.rank != 0:
            return
        np.savez_compressed(
            f_name, logits=st[0], mu=st[1], eta=st[2], q=st[3],
            sigma_eps=np.atleast_1d(np.asarray(self._hyper.sigma_eps)),
            tau_beta=np.atleast_1d(np.asarray(self._hyper.tau_beta)),
            pi=np.atleast_1d(np.asarray(self._hyper.pi)),
            lambda_min=np.atleast_1d(np.asarray(self._hyper.lambda_min)),
            sigma_g=np.atleast_1d(self._sigma_g),
            elbo_history=np.asarray(self.history.get('ELBO', [])))

    def load_checkpoint(self, f_name):
        """Restore a checkpoint written by ``save_checkpoint`` of either
        package (the lane count ``_S`` is the file's): the state goes to
        this model's device. It is how a JAX ``VIPRS`` or ``VIPRSGrid`` fit
        is carried over to the port (as ``VIPRSMix.set_state`` carries a
        mixture's). Under a mesh each rank takes its part of the state."""
        path = f_name if str(f_name).endswith('.npz') else f_name + '.npz'
        with np.load(path) as f:
            z = {k: f[k] for k in f.files}
        self._S = int(z['logits'].shape[0])
        self._lanes_whole = False
        self._state = CaviState(*(self._local(
            np.ascontiguousarray(z[k], np.float32), lanes=True)
            for k in ('logits', 'mu', 'eta', 'q')))
        self._hyper = Hyper(sigma_eps=z['sigma_eps'], tau_beta=z['tau_beta'],
                            pi=z['pi'], lambda_min=z['lambda_min'])
        self._sigma_g = z['sigma_g']
        hist = z['elbo_history']
        self.history['ELBO'] = [float(v) for v in hist] if hist.ndim == 1 \
            else list(hist)
        self._update_fix_mask()
        self._clear_posterior()
        return self

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

    def get_tau_beta(self, chrom=None):
        return self.tau_beta

    def get_pi(self, chrom=None):
        return self.pi

    def get_null_pi(self, chrom=None):
        return 1.0 - self.get_pi(chrom)

    def get_proportion_causal(self):
        return self.pi

    def get_average_effect_size_variance(self):
        return self._scalar(np.asarray(self._hyper.pi)
                            / np.asarray(self._hyper.tau_beta))

    def get_heritability(self):
        sg = np.asarray(self._sigma_g)
        return self._scalar(sg / (sg + np.asarray(self._hyper.sigma_eps)))
