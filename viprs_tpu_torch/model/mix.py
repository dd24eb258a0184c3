"""VIPRSMix — the sparse Gaussian-mixture prior (K slab components and the
null spike).

Counterpart of viprs_tpu.model.mix.VIPRSMix: (K, NB, B) variational
parameters, softmax responsibilities over K+1 components, prior-variance
multipliers ``d``, renormalised pi updates and clipped tau_beta updates.
The fit runs ops/mix_em_loop.mix_em_fit, whose sweep is the CUDA kernel K6
(every iteration activity-gated, the default) or K5 (all blocks, with
``sweep_impl='xla'`` or ``'pallas'``) on the card and their plain PyTorch
versions on the CPU; a negative MSE restarts the fit once with
sigma_epsilon fixed at 0.95. ``fit(fused=False)`` runs the JAX package's
host-stepped loop instead (``_fit_host_stepped``): one all-active sweep (K5)
an iteration, the M-step, ELBO and MSE from its statistics, and the
reference's stopping ladder with its own counters and messages.

Randomness is the JAX package's: ``initialize_theta`` draws the total pi
(``uniform``), then its split over the components (``dirichlet``), then
runs the LDSC estimate, all from ``rng`` (default numpy's global stream),
so ``np.random.seed(s)`` gives both packages the same theta_0.
"""

import logging

import numpy as np
import torch

from . import _dispatch
from .base import BayesPRSModel, history_table
from ..data.ldsc import simple_ldsc
from ..ops import mix_em_loop
from ..ops import cavi_cuda
from ..ops.cavi_cuda import cavi_sweep_mix_s1
from ..ops.cavi_mix import MixHyper, MixState, mix_var_tau
from ..ops.cavi_torch import INNER_STEPS, TILE
from ..ops.mix_em_loop import MixFix
from ..utils import optimize as opt
from ..utils.optimize import IterationConditionCounter, OptimizeResult

logger = logging.getLogger(__name__)

F32 = torch.float32


class VIPRSMix(BayesPRSModel):
    """
    :ivar K: number of non-null mixture components.
    :ivar d: prior-variance multipliers, (K,).
    """

    def __init__(self, dataset, device, K=1, prior_multipliers=None,
                 fix_params=None, lambda_min=None, float_precision='float32',
                 tile=TILE, mesh='auto', **kwargs):
        """
        :param dataset: a viprs_tpu_torch SummaryStatsDataset.
        :param device: the device the fit runs on; it must hold the
            dataset's LD ('cuda' runs the CUDA kernels, 'cpu' their plain
            versions).
        :param K: number of slab components (1..8 on the card).
        :param prior_multipliers: (K,) prior-variance multipliers (default
            ``2 ** linspace(-min(K - 1, 7), 0, K)``).
        :param fix_params: dict pinning hyperparameters out of the M-step:
            'sigma_epsilon', 'tau_betas' ((K,)), 'pis' ((K,)), 'pi' (the
            total, renormalised in the M-step), 'tau_beta' and 'lambda_min'
            (initial values only).
        :param lambda_min: None (0) or a number.
        :param float_precision: sets ``float_eps`` only (the state is
            float32), as in the JAX package.
        :param tile: the sweeps' tile width; the port's is T = 128 and
            another value raises.
        :param mesh: as for VIPRS, with a grid axis of size 1: the mixture
            splits the LD blocks over the processes only.
        :param kwargs: other arguments of the reference's constructor,
            accepted and not used, as in the JAX package.
        """
        mesh = _dispatch.resolve_mesh(mesh)
        if mesh is not None and mesh.shape['grid'] != 1:
            raise ValueError("VIPRSMix shards LD blocks only; use a mesh "
                             "with grid-axis size 1 (all processes on "
                             "'blocks').")
        super().__init__(dataset, device, float_precision=float_precision,
                         mesh=mesh)
        self.tile = _dispatch.check_tile(tile)
        if K < 1:
            raise ValueError(f"K must be positive; got {K}")
        self.K = int(K)
        if prior_multipliers is not None:
            if len(prior_multipliers) != K:
                raise ValueError("prior_multipliers needs one value per "
                                 "component")
            self.d = np.asarray(prior_multipliers, dtype=np.float64)
        else:
            self.d = 2.0 ** np.linspace(-min(K - 1, 7), 0, K)
        self.fix_params = dict(fix_params or {})
        self.lambda_min = float(lambda_min or 0.0)
        self._state = None        # MixState on the device
        self._hyper = None        # MixHyper of float64 numpy
        self._sigma_g = 0.0
        self.optim_result = OptimizeResult()
        self.history = {}
        self._std_beta_flat = self._n_flat = None
        self._refresh_inputs()

    # ------------------------------------------------------------ init
    def initialize(self, theta_0=None, param_0=None, rng=None):
        """Initial hyperparameters and state and an empty history;
        ``param_0`` is accepted and not read, as in the JAX package."""
        self.initialize_theta(theta_0, rng)
        self.initialize_variational_parameters(param_0)
        self.history = {'ELBO': []}
        self.optim_result.reset()

    def initialize_theta(self, theta_0=None, rng=None):
        """The reference initialization (viprs_tpu model/mix.py:98-147)."""
        rng = np.random if rng is None else rng
        theta_0 = dict(theta_0 or {})
        theta_0.update(self.fix_params)
        m = self.n_snps
        if 'pis' in theta_0:
            pi = np.asarray(theta_0['pis'], dtype=np.float64)
        else:
            overall_pi = float(theta_0['pi']) if 'pi' in theta_0 else \
                float(rng.uniform(max(0.005, 1.0 / m), 0.1))
            pi = overall_pi * rng.dirichlet(np.ones(self.K))
        if 'sigma_epsilon' not in theta_0:
            if 'tau_betas' in theta_0:
                tau_beta = np.asarray(theta_0['tau_betas'], dtype=np.float64)
                sigma_eps = float(np.clip(1.0 - np.dot(1.0 / tau_beta, pi),
                                          1e-4, 1.0 - 1e-4))
            elif 'tau_beta' in theta_0:
                tau_beta = float(theta_0['tau_beta']) * self.d
                sigma_eps = float(np.clip(1.0 - (m * pi / tau_beta).sum(),
                                          1e-4, 1.0 - 1e-4))
            else:
                naive_h2g = float(np.clip(simple_ldsc(self.dataset), 1e-3,
                                          1.0 - 1e-3))
                sigma_eps = 1.0 - naive_h2g
                tau_beta = self.d * (m * np.dot(1.0 / self.d, pi) / naive_h2g)
        else:
            sigma_eps = float(theta_0['sigma_epsilon'])
            if 'tau_betas' in theta_0:
                tau_beta = np.asarray(theta_0['tau_betas'], dtype=np.float64)
            elif 'tau_beta' in theta_0:
                tau_beta = np.repeat(float(theta_0['tau_beta']), self.K)
            else:
                tau_beta = self.d * (m * np.dot(1.0 / self.d, pi)
                                     / (1.0 - sigma_eps))
        self._hyper = MixHyper(
            sigma_eps=np.float64(sigma_eps),
            tau_beta=np.asarray(tau_beta, dtype=np.float64),
            pi=np.asarray(pi, dtype=np.float64),
            lambda_min=np.float64(self.fix_params.get('lambda_min',
                                                      self.lambda_min)))
        self._sigma_g = 0.0

    def initialize_variational_parameters(self, param_0=None):
        """gamma = pi per component, mu, eta and q zero (``param_0`` is not
        read: the JAX package's mixture takes no warm start)."""
        lay = self.dataset.layout
        shape = (self.K, self._ld.nb, lay.block_size)
        pi = torch.from_numpy(np.asarray(self._hyper.pi, np.float32))
        zeros = lambda s: torch.zeros(s, dtype=F32, device=self.device)
        self._state = MixState(
            gamma=pi.to(self.device)[:, None, None].expand(shape).contiguous(),
            mu=zeros(shape), eta=zeros(shape[1:]), q=zeros(shape[1:]))

    def set_state(self, state, hyper, sigma_g=0.0):
        """Load variational state and hyperparameters, e.g. those of a JAX
        package's fit (``np.asarray`` of its ``_state`` and ``_hyper``
        fields), to continue from them with ``fit(continued=True)``.

        :param state: (gamma, mu, eta, q) array-likes in this model's layout.
        :param hyper: (sigma_eps, tau_beta, pi, lambda_min) array-likes.
        :param sigma_g: the sigma_g carry (a float, or (S,) for a grid).
        Under a mesh each rank takes its blocks of the state.
        """
        self._state = MixState(*(self._local(np.asarray(x, np.float32))
                                 for x in state))
        self._hyper = MixHyper(*(np.array(x, np.float64) for x in hyper))
        self._sigma_g = np.array(sigma_g, np.float64) \
            if np.ndim(sigma_g) else float(sigma_g)
        self._pip = self._post_mean_beta = self._post_var_beta = None

    # ------------------------------------------------------------ fit
    def _mix_fix(self):
        return MixFix('sigma_epsilon' in self.fix_params,
                      'tau_betas' in self.fix_params,
                      'pis' in self.fix_params,
                      float(self.fix_params.get('pi', 0.0)))

    def fit(self, max_iter=1000, theta_0=None, param_0=None, continued=False,
            min_iter=3, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10,
            max_restarts=1, fused=True, sweep_impl=None,
            inner_steps=INNER_STEPS, compile_only=False, rng=None):
        """Mixture EM fit to convergence (the reference's VIPRSMix.fit).

        :param param_0: accepted and ignored, as the JAX package ignores it
            (its mixture initializes no warm start).
        :param continued: start from the current state and hyperparameters
            (``set_state`` or an earlier fit) instead of initializing.
        :param max_restarts: restarts with sigma_epsilon fixed at 0.95 when
            the MSE goes negative (the whole fit is re-run).
        :param fused: ``False`` runs the host-stepped reference loop
            (``_fit_host_stepped``; its sweep is always the all-active K5).
        :param sweep_impl: None/'skip' (K6), 'xla'/'pallas' (K5); see
            model/_dispatch.py.
        :param inner_steps: the sweeps' inner steps per tile (the plain
            versions take INNER_STEPS only and refuse another up front).
        :param compile_only: build (or find) the kernel library the fit
            would launch and return, the state and the numpy stream as they
            were (nothing to build on the CPU).
        :param rng: numpy ``RandomState`` (or the ``np.random`` module, the
            default) for the initial and restart draws.
        """
        use_skip = _dispatch.select_mix_sweep_impl(sweep_impl)
        cavi_cuda.check_inner_steps(self.device, inner_steps)
        if compile_only:
            cavi_cuda.build_for(self._sweep_args()[0])
            return self
        rng = np.random if rng is None else rng
        self._refresh_inputs()
        if not fused:
            return self._fit_host_stepped(max_iter, theta_0, continued,
                                          min_iter, f_abs_tol, x_abs_tol,
                                          patience, max_restarts, rng,
                                          inner_steps)
        if not continued:
            self.initialize(theta_0, rng=rng)
        self.history.setdefault('ELBO', [])
        restarts = 0
        while True:
            res = mix_em_loop.mix_em_fit(
                self._ld, self._state, self._std_beta_flat,
                self._n_flat, self._hyper, self._mix_fix(), self.d,
                n_sample=float(self.n), m_total=float(self.m),
                max_iter=max_iter, min_iter=min_iter, f_abs_tol=f_abs_tol,
                x_abs_tol=x_abs_tol, patience=patience, use_skip=use_skip,
                sigma_g0=float(self._sigma_g), inner_steps=inner_steps)
            self._state, self._hyper = res.state, res.hyper
            self._sigma_g = float(res.sigma_g)
            code = int(res.status)
            if (code == opt.MSE_NEGATIVE
                    and 'sigma_epsilon' not in self.fix_params
                    and restarts < max_restarts):
                restarts += 1
                logger.info("MSE negative; restarting the mixture fit with "
                            "sigma_epsilon fixed at 0.95 (reference "
                            "behavior).")
                self.initialize_theta(theta_0, rng)
                self.fix_params['sigma_epsilon'] = 0.95
                self._hyper = self._hyper._replace(sigma_eps=np.float64(0.95))
                self.initialize_variational_parameters()
                continue
            break
        self._last_result = res
        self.history['ELBO'] = [float(e) for e in res.elbo_hist]
        self.optim_result = OptimizeResult.from_status(code, res.final_elbo,
                                                       res.nit)
        if not self.optim_result.success:
            logger.warning("\t%s", self.optim_result.message)
        self._pip = self._post_mean_beta = self._post_var_beta = None
        return self

    def _m_step(self, st):
        """The closed-form M-step from one model's sweep statistics
        (viprs_tpu model/mix.py:332-361, VIPRSMix.py:227-260)."""
        h = self._hyper
        m = float(self.m)
        pi = np.asarray(h.pi).copy()
        tau_beta = np.asarray(h.tau_beta).copy()
        if 'pis' not in self.fix_params:
            pi = st['sum_gamma_k'].copy()
            if 'pi' in self.fix_params:
                pi = self.fix_params['pi'] * pi / pi.sum()
            else:
                pi = pi / m
        if 'tau_betas' not in self.fix_params:
            tau_est = np.sum(pi) * m / np.dot(self.d, st['sum_zeta_k'])
            tau_beta = np.clip(self.d * tau_est, 1.0, None)
        sigma_g = float((1.0 + float(h.lambda_min)) * st['sum_zeta_k'].sum()
                        + st['sum_q_eta'])
        if 'sigma_epsilon' in self.fix_params:
            sigma_eps = float(h.sigma_eps)
        else:
            sigma_eps = float(1.0 - 2.0 * st['sum_beta_eta'] + sigma_g)
        self._hyper = MixHyper(sigma_eps=np.float64(sigma_eps),
                               tau_beta=tau_beta, pi=pi,
                               lambda_min=h.lambda_min)
        self._sigma_g = sigma_g

    def _fit_host_stepped(self, max_iter, theta_0, continued, min_iter,
                          f_abs_tol, x_abs_tol, patience, max_restarts, rng,
                          inner_steps=INNER_STEPS):
        """The JAX package's host-stepped loop (viprs_tpu model/mix.py:
        392-479): each iteration one all-active sweep (K5, coupling tiles
        included; the plain version on the CPU), its statistics and
        max |d eta| over every variant in one device->host read, then
        ``_m_step``, the ELBO and the MSE on the host. A negative MSE
        re-initializes the model once with sigma_epsilon fixed at 0.95 and
        goes on from the next iteration."""
        if not continued:
            self.initialize(theta_0, rng=rng)
        hist = self.history.setdefault('ELBO', [])
        hist.append(self.elbo())
        prev_elbo, prev_sigma_g = hist[-1], self._sigma_g
        sig_icc, div_icc = IterationConditionCounter(), \
            IterationConditionCounter()
        res = self.optim_result
        restarts = 0
        ld, halo = self._sweep_args()
        for i in range(1, max_iter + 1):
            hy = self._hyper_dev()
            self._state, eta_diff = cavi_sweep_mix_s1(
                ld, self._state, self._std_beta_flat, self._n_flat, hy,
                inner_steps, halo)
            st, extra = self._read_stats(1, eta_diff.abs().amax())
            st = {k: v[0] for k, v in st.items()}
            max_ed = float(extra[0])
            self._m_step(st)
            curr_elbo, curr_mse = self._elbo_from(st), self._mse_from(st)
            hist.append(curr_elbo)
            sig_icc.update((i > min_iter)
                           and abs(self._sigma_g - prev_sigma_g) <= x_abs_tol
                           and max_ed < 10 * x_abs_tol, i)
            div_icc.update((curr_elbo < prev_elbo)
                           and not np.isclose(curr_elbo, prev_elbo,
                                              atol=1e3 * f_abs_tol,
                                              rtol=1e-4), i)
            h2 = self.get_heritability()
            if curr_mse < 0:
                if 'sigma_epsilon' not in self.fix_params \
                        and restarts < max_restarts:
                    restarts += 1
                    logger.info("Iteration %d | MSE negative; restarting "
                                "with fixed sigma_epsilon.", i)
                    self.initialize_theta(theta_0, rng)
                    self.fix_params['sigma_epsilon'] = 0.95
                    self._hyper = self._hyper._replace(
                        sigma_eps=np.float64(0.95))
                    self.initialize_variational_parameters()
                    continue
                res.update(curr_elbo, stop_iteration=True, success=False,
                           message=f'The MSE is negative ({curr_mse:.6f}).')
            elif not np.isfinite(curr_elbo):
                res.update(curr_elbo, stop_iteration=True, success=False,
                           message=opt.STATUS_MESSAGES[opt.ELBO_NONFINITE])
            elif self.sigma_epsilon < 0:
                res.update(curr_elbo, stop_iteration=True, success=False,
                           message=opt.STATUS_MESSAGES[
                               opt.SIGMA_EPS_NEGATIVE])
            elif h2 > 1 or h2 < 0:
                res.update(curr_elbo, stop_iteration=True, success=False,
                           message=opt.STATUS_MESSAGES[opt.H2_OUT_OF_BOUNDS])
            elif i > min_iter and np.isclose(prev_elbo, curr_elbo,
                                             atol=f_abs_tol, rtol=0.):
                res.update(curr_elbo, stop_iteration=True, success=True,
                           message=opt.STATUS_MESSAGES[opt.CONVERGED_F])
            elif i > min_iter and max_ed < x_abs_tol:
                res.update(curr_elbo, stop_iteration=True, success=True,
                           message=opt.STATUS_MESSAGES[opt.CONVERGED_X])
            elif sig_icc.counter > patience:
                res.update(curr_elbo, stop_iteration=True, success=True,
                           message=opt.STATUS_MESSAGES[
                               opt.CONVERGED_SIGMA_G])
            elif div_icc.counter > patience:
                res.update(curr_elbo, stop_iteration=True, success=False,
                           message=opt.STATUS_MESSAGES[opt.DIVERGED_ELBO])
            else:
                res.update(curr_elbo)
            prev_elbo, prev_sigma_g = curr_elbo, self._sigma_g
            if res.stop_iteration:
                break
        if not res.stop_iteration:
            res.update(hist[-1], stop_iteration=True, success=False,
                       message=opt.STATUS_MESSAGES[opt.MAX_ITER],
                       increment=False)
        if not res.success:
            logger.warning("\t%s", res.message)
        self._pip = self._post_mean_beta = self._post_var_beta = None
        return self

    # ------------------------------------------------------------ objective
    def _hyper_dev(self):
        return MixHyper(*(torch.from_numpy(np.asarray(x, np.float32))
                          .to(self.device) for x in self._hyper))

    def _sweep_args(self):
        """(the BlockLD the sweeps take, their ``halo``): this rank's
        blocks and its halo exchange under a mesh."""
        if self.mesh is None:
            return self._ld, None
        return self._ld.ld, self._ld.couple

    def _read_stats(self, S, *extra):
        """``mix_em_loop.read_stats`` of the current state (and one
        per-lane maximum in ``extra``), over every rank under a mesh."""
        st, ex = mix_em_loop.read_stats(
            self._state, self._hyper_dev(), self._std_beta_flat,
            self._n_flat, self._ld.mask, S, self.K, *extra)
        if self.mesh is None:
            return st, ex
        return mix_em_loop.reduce_stats(self._ld, st, S, self.K,
                                        ex[:S] if extra else None)

    def _lane_stats(self):
        """The single model's statistics as one lane ((1,) / (1, K))."""
        return self._read_stats(1)[0]

    def _elbo_from(self, st):
        """The ELBO of one model's statistics ({name: scalar or (K,)}) with
        the current hyperparameters and sigma_g."""
        h = MixHyper(*(np.reshape(x, s) for x, s in zip(
            self._hyper, (1, (1, self.K), (1, self.K), 1))))
        st = {k: np.reshape(v, (1, -1) if np.ndim(v) else 1)
              for k, v in st.items()}
        return float(mix_em_loop._mix_elbo(
            st, h, 'sigma_epsilon' in self.fix_params,
            np.reshape(self._sigma_g, 1), float(self.n))[0])

    def elbo(self):
        """The ELBO of the current state and hyperparameters."""
        return self._elbo_from({k: v[0] for k, v in
                                self._lane_stats().items()})

    def objective(self):
        return self.elbo()

    def _mse_from(self, st):
        """The MSE of one model's statistics with the current sigma_g."""
        return float(1.0 - 2.0 * st['sum_beta_eta'] + self._sigma_g
                     - st['sum_zeta_k'].sum() + st['sum_eta_sq'])

    # The ELBO's terms on the mixture posterior (the reference inherits them
    # from VIPRS, VIPRS.py:583-678), from one read of the statistics each
    # (viprs_tpu model/mix.py:255-330), per lane for a grid's S lanes.
    def _lanes(self):
        """Lane count of the state: 1 for one model."""
        return self._state.eta.shape[0] if self._state.eta.dim() == 3 else 1

    def _terms(self):
        """(statistics, float64 hyperparameters, sigma_g), lane-shaped
        ((S,) / (S, K); S = 1 for one model)."""
        S, K = self._lanes(), self.K
        st = self._read_stats(S)[0]
        h = MixHyper(*(np.reshape(np.asarray(x, np.float64), s) for x, s in
                       zip(self._hyper, (S, (S, K), (S, K), S))))
        return st, h, np.reshape(np.asarray(self._sigma_g, np.float64), S)

    def _per_model(self, x):
        """A float for one model, the (S,) lanes of a grid."""
        return float(x[0]) if self._state.eta.dim() == 2 else x

    def mse(self):
        st, _, sg = self._terms()
        return self._per_model(1.0 - 2.0 * st['sum_beta_eta'] + sg
                               - st['sum_zeta_k'].sum(-1) + st['sum_eta_sq'])

    def loglikelihood(self):
        """E_q[log p(data | beta)] (reference VIPRS.py:615-628)."""
        st, h, sg = self._terms()
        sig_e = h.sigma_eps
        return self._per_model(-0.5 * self.n * (
            np.log(2.0 * np.pi * sig_e)
            + (1.0 / sig_e) * (1.0 - 2.0 * st['sum_beta_eta'] + sg)))

    def log_prior(self):
        """E_q[log p(beta | theta)] (reference VIPRS.py:630-678, the K
        components and the null)."""
        st, h, _ = self._terms()
        null_pi = np.maximum(1.0 - h.pi.sum(-1),
                             np.finfo(np.float64).resolution)
        lp = 0.5 * (st['sum_gamma_k'] * np.log(h.tau_beta)).sum(-1)
        lp = lp + (st['sum_gamma_k'] * np.log(h.pi)).sum(-1)
        lp = lp + st['sum_null_g'] * np.log(null_pi)
        lp = lp - 0.5 * (h.tau_beta * st['sum_zeta_k']).sum(-1)
        return self._per_model(lp - 0.5 * self.n_snps * np.log(2.0 * np.pi))

    def entropy(self):
        """Entropy of the variational distribution (reference
        VIPRS.py:583-613)."""
        st = self._terms()[0]
        ent = -st['sum_g_logg'] - st['sum_ng_logng']
        ent = ent - 0.5 * st['sum_g_logvt'].sum(-1)
        return self._per_model(
            ent + 0.5 * self.n_snps * (np.log(2.0 * np.pi) + 1.0))

    def complete_loglikelihood(self):
        return self.loglikelihood() + self.log_prior()

    def to_history_table(self):
        """``history`` as a Table (see ``base.history_table``)."""
        return history_table(self.history)

    # ------------------------------------------------------------ posterior
    def _materialize_posterior_moments(self):
        if self._state is None:
            return
        g, mu, eta, _ = self._state
        vt = mix_var_tau(self._n_flat, self._hyper_dev())
        zeta = (g * (mu ** 2 + 1.0 / vt)).sum(dim=-3)
        lanes = (lambda x: x) if eta.dim() == 3 else (lambda x: x[None])
        self._pip = self._dict_view(lanes(g.sum(dim=-3)))
        self._post_mean_beta = self._dict_view(lanes(eta))
        self._post_var_beta = self._dict_view(lanes(zeta - eta * eta))

    def update_posterior_moments(self):
        self._materialize_posterior_moments()

    @property
    def var_gamma(self):
        """{chrom: (m_c, K)} responsibilities ((m_c, S, K) for S lanes)."""
        return self._lead_view(self._state.gamma)

    @property
    def var_mu(self):
        return self._lead_view(self._state.mu)

    @property
    def eta(self):
        return self._lead_view(self._state.eta)

    @property
    def q(self):
        return self._lead_view(self._state.q)

    def q_dict(self):
        """{chrom: q}, the cached (R - I) eta of the fitted state (float32;
        (m_c, S) for S lanes), which ``pseudo_validate`` takes for
        S.b = q + eta."""
        return self.q

    def compute_pip(self):
        """{chrom: PIP}, the responsibilities summed over the components."""
        return self._lead_view(self._state.gamma.sum(dim=-3))

    # ------------------------------------------------------------ getters
    @property
    def pi(self):
        return np.asarray(self._hyper.pi)

    @property
    def tau_beta(self):
        return np.asarray(self._hyper.tau_beta)

    @property
    def sigma_epsilon(self):
        return float(self._hyper.sigma_eps)

    def get_null_pi(self, chrom=None):
        return 1.0 - float(np.sum(self._hyper.pi))

    def get_proportion_causal(self):
        return float(np.sum(self._hyper.pi))

    def get_average_effect_size_variance(self):
        return float(np.sum(self.pi / self.tau_beta))

    def to_theta_table(self):
        """The fitted hyperparameters as a (Parameter, Value) Table, the JAX
        package's rows (viprs_tpu/model/mix.py:572-586)."""
        rows = [('ELBO', self.elbo()),
                ('Residual_variance', self.sigma_epsilon),
                ('Heritability', self.get_heritability()),
                ('Proportion_causal', self.get_proportion_causal()),
                ('Average_effect_variance',
                 self.get_average_effect_size_variance())]
        rows += [(f'tau_beta_{i + 1}', t)
                 for i, t in enumerate(np.atleast_1d(self.tau_beta))]
        rows += [(f'pi_{i + 1}', p)
                 for i, p in enumerate(np.atleast_1d(self.pi))]
        return self._theta_table(rows)

    def get_heritability(self):
        return float(self._sigma_g / (self._sigma_g + self.sigma_epsilon))
