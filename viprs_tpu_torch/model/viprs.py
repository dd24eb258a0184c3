"""VIPRS — the spike-and-slab variational PRS model (single model, S = 1).

Counterpart of viprs_tpu.model.viprs.VIPRS for the single-model fit:
initialization from LDSC, the CAVI e-step (CUDA kernels on the card, plain
PyTorch on the CPU), the closed-form M-step, the ELBO, the convergence
ladder and the restart on negative MSE, all through ops/em_loop.em_fit.

Randomness is the JAX package's: the initial pi draw and the restart draw
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
from ..utils.optimize import OptimizeResult

logger = logging.getLogger(__name__)

F32 = torch.float32


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
        self._state = None             # CaviState, (1, NB, B) float32
        self._hyper = None             # (sigma_eps, tau_beta, pi, lambda_min)
        self._sigma_g = 0.0
        self.optim_result = OptimizeResult()
        self.history = {}
        self._act_trace = []
        self._n_skip = 0
        self._std_beta_flat, self._n_flat = dataset.device_inputs()

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
        self._hyper = (sigma_eps, tau_beta, pi, lam)
        self._sigma_g = 0.0

    def initialize_variational_parameters(self):
        lay = self.dataset.layout
        shape = (1, lay.nb, lay.block_size)
        logit = float(np.float32(_logit(self._hyper[2])))
        self._state = CaviState(
            logits=torch.full(shape, logit, dtype=F32, device=self.device),
            mu=torch.zeros(shape, dtype=F32, device=self.device),
            eta=torch.zeros(shape, dtype=F32, device=self.device),
            q=torch.zeros(shape, dtype=F32, device=self.device))

    # ------------------------------------------------------------ fit
    def fit(self, max_iter=1000, theta_0=None, min_iter=3, f_abs_tol=1e-6,
            x_abs_tol=1e-6, patience=10, max_restarts=1, sweep_impl=None,
            hybrid_eps=None, rng=None):
        """Variational EM fit to convergence (the reference's VIPRS.fit).

        :param max_restarts: 0 or 1 — restart once, with sigma_epsilon fixed
            at 0.95, when the MSE goes negative.
        :param sweep_impl: None/'hybrid' (default) or 'xla' (all-active
            sweep every iteration); see model/_dispatch.py.
        :param hybrid_eps: gate epsilon of the hybrid's proposal mask
            (default ``x_abs_tol``).
        :param rng: numpy ``RandomState`` (or the ``np.random`` module, the
            default) for the pi draws.
        """
        if max_restarts not in (0, 1):
            raise ValueError("max_restarts must be 0 or 1")
        rng = np.random if rng is None else rng
        use_hybrid = _dispatch.use_hybrid(sweep_impl)
        self.initialize_theta(theta_0, rng)
        self.initialize_variational_parameters()
        self.optim_result.reset()

        # The restart theta is drawn now (the one rng.uniform the reference
        # makes at restart time) without advancing the stream; the draw is
        # consumed after the fit only if the restart fired.
        restart = max_restarts == 1 and 'sigma_epsilon' not in self.fix_params
        r_hyper = r_logit = rng_after = None
        if restart:
            before = rng.get_state()
            r_pi, r_se, r_tau = self._resolve_theta0(
                {**dict(theta_0 or {}), 'sigma_epsilon': 0.95}, rng)
            rng_after = rng.get_state()
            rng.set_state(before)
            r_hyper = (r_se, r_tau, r_pi)
            r_logit = np.float32(_logit(r_pi))

        res = em_loop.em_fit(
            self.dataset.ld, self._state, self._std_beta_flat, self._n_flat,
            tuple(float(np.float32(x)) for x in self._hyper),
            fix_sigma_eps='sigma_epsilon' in self.fix_params,
            fix_tau_beta='tau_beta' in self.fix_params,
            fix_pi='pi' in self.fix_params,
            n_sample=float(self.n), m_total=float(self.m),
            max_iter=max_iter, min_iter=min_iter, f_abs_tol=f_abs_tol,
            x_abs_tol=x_abs_tol, patience=patience, use_hybrid=use_hybrid,
            hybrid_eps=hybrid_eps, max_restarts=1 if restart else 0,
            restart_hyper=r_hyper, restart_logit=r_logit)

        if res.restarts_used > 0:
            logger.info("MSE was negative; the fit restarted with "
                        "sigma_epsilon fixed at 0.95 (reference behavior).")
            self.fix_params['sigma_epsilon'] = 0.95
            rng.set_state(rng_after)
        self._state = res.state
        self._hyper = tuple(float(x[0]) for x in res.hyper)
        self._sigma_g = float(res.sigma_g)
        self.history = {'ELBO': list(res.elbo_hist)}
        self._act_trace = res.act_hist[1:] if use_hybrid else []
        self._n_skip = res.n_skip
        self._pip = self._post_mean_beta = self._post_var_beta = None
        self.optim_result = OptimizeResult.from_status(
            res.status, res.final_elbo, res.nit)
        if not self.optim_result.success:
            logger.warning("\t%s", self.optim_result.message)
        return self

    # ------------------------------------------------------------ posterior
    def _dict_view(self, flat):
        """(1, NB, B) tensor -> {chrom: (m_c,) numpy}."""
        return self.dataset.layout.from_flat(flat[0].cpu().numpy().reshape(-1))

    def _materialize_posterior_moments(self):
        if self._state is None:
            return
        h32 = Hyper(*(torch.tensor([x], dtype=F32, device=self.device)
                      for x in self._hyper))
        var_tau = updates.compute_var_tau(self._n_flat, h32)
        zeta = updates.compute_zeta(self._state, var_tau)
        eta = self._state.eta
        self._pip = self._dict_view(self._state.gamma)
        self._post_mean_beta = self._dict_view(eta)
        self._post_var_beta = self._dict_view(zeta - eta * eta)

    # ------------------------------------------------------------ getters
    @property
    def sigma_epsilon(self):
        return self._hyper[0]

    @property
    def tau_beta(self):
        return self._hyper[1]

    @property
    def pi(self):
        return self._hyper[2]

    @property
    def sigma_g(self):
        return self._sigma_g

    def get_sigma_epsilon(self):
        return self.sigma_epsilon

    def get_tau_beta(self):
        return self.tau_beta

    def get_pi(self):
        return self.pi

    def get_proportion_causal(self):
        return self.pi

    def get_average_effect_size_variance(self):
        return self.pi / self.tau_beta

    def get_heritability(self):
        return self._sigma_g / (self._sigma_g + self.sigma_epsilon)
