"""VIPRSMix — the sparse Gaussian-mixture prior (K slab components and the
null spike).

Counterpart of viprs_tpu.model.mix.VIPRSMix: (K, NB, B) variational
parameters, softmax responsibilities over K+1 components, prior-variance
multipliers ``d``, renormalised pi updates and clipped tau_beta updates.
The fit runs ops/mix_em_loop.mix_em_fit, whose sweep is the CUDA kernel K6
(every iteration activity-gated, the default) or K5 (all blocks, with
``sweep_impl='xla'`` or ``'pallas'``) on the card and their plain PyTorch
versions on the CPU; a negative MSE restarts the fit once with
sigma_epsilon fixed at 0.95.

Randomness is the JAX package's: ``initialize_theta`` draws the total pi
(``uniform``), then its split over the components (``dirichlet``), then
runs the LDSC estimate, all from ``rng`` (default numpy's global stream),
so ``np.random.seed(s)`` gives both packages the same theta_0.
"""

import logging

import numpy as np
import torch

from . import _dispatch
from .base import BayesPRSModel
from ..data.ldsc import simple_ldsc
from ..ops import mix_em_loop
from ..ops.cavi_mix import MixHyper, MixState, mix_var_tau
from ..ops.mix_em_loop import MixFix
from ..utils import optimize as opt
from ..utils.optimize import OptimizeResult

logger = logging.getLogger(__name__)

F32 = torch.float32


class VIPRSMix(BayesPRSModel):
    """
    :ivar K: number of non-null mixture components.
    :ivar d: prior-variance multipliers, (K,).
    """

    def __init__(self, dataset, device, K=1, prior_multipliers=None,
                 fix_params=None, lambda_min=None):
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
        """
        super().__init__(dataset, device)
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
        self._std_beta_flat, self._n_flat = dataset.device_inputs()

    # ------------------------------------------------------------ init
    def initialize(self, theta_0=None, rng=None):
        self.initialize_theta(theta_0, rng)
        self.initialize_variational_parameters()
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

    def initialize_variational_parameters(self):
        lay = self.dataset.layout
        shape = (self.K, lay.nb, lay.block_size)
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
        """
        self._state = MixState.from_numpy(*state, device=self.device)
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

    def fit(self, max_iter=1000, theta_0=None, continued=False, min_iter=3,
            f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10, max_restarts=1,
            fused=True, sweep_impl=None, rng=None):
        """Mixture EM fit to convergence (the reference's VIPRSMix.fit).

        :param continued: start from the current state and hyperparameters
            (``set_state`` or an earlier fit) instead of initializing.
        :param max_restarts: restarts with sigma_epsilon fixed at 0.95 when
            the MSE goes negative (the whole fit is re-run).
        :param fused: only the fused loop is ported; ``False`` (the JAX
            package's host-stepped reference loop) raises.
        :param sweep_impl: None/'skip' (K6), 'xla'/'pallas' (K5); see
            model/_dispatch.py.
        :param rng: numpy ``RandomState`` (or the ``np.random`` module, the
            default) for the initial and restart draws.
        """
        if not fused:
            raise NotImplementedError(
                "fused=False (the host-stepped reference loop) is not ported "
                "yet; see ROADMAP.md, Queue 1")
        use_skip = _dispatch.select_mix_sweep_impl(sweep_impl)
        rng = np.random if rng is None else rng
        if not continued:
            self.initialize(theta_0, rng)
        self.history.setdefault('ELBO', [])
        restarts = 0
        while True:
            res = mix_em_loop.mix_em_fit(
                self.dataset.ld, self._state, self._std_beta_flat,
                self._n_flat, self._hyper, self._mix_fix(), self.d,
                n_sample=float(self.n), m_total=float(self.m),
                max_iter=max_iter, min_iter=min_iter, f_abs_tol=f_abs_tol,
                x_abs_tol=x_abs_tol, patience=patience, use_skip=use_skip,
                sigma_g0=float(self._sigma_g))
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

    # ------------------------------------------------------------ objective
    def _hyper_dev(self):
        return MixHyper(*(torch.from_numpy(np.asarray(x, np.float32))
                          .to(self.device) for x in self._hyper))

    def _lane_stats(self):
        """The single model's statistics as one lane ((1,) / (1, K))."""
        return mix_em_loop.read_stats(
            self._state, self._hyper_dev(), self._std_beta_flat,
            self._n_flat, self.dataset.ld.mask, 1, self.K)[0]

    def elbo(self):
        """The ELBO of the current state and hyperparameters."""
        h = MixHyper(*(np.reshape(x, s) for x, s in zip(
            self._hyper, (1, (1, self.K), (1, self.K), 1))))
        return float(mix_em_loop._mix_elbo(
            self._lane_stats(), h, 'sigma_epsilon' in self.fix_params,
            np.reshape(self._sigma_g, 1), float(self.n))[0])

    def objective(self):
        return self.elbo()

    def mse(self):
        st = self._lane_stats()
        return float((1.0 - 2.0 * st['sum_beta_eta'] + self._sigma_g
                      - st['sum_zeta_k'].sum(axis=1) + st['sum_eta_sq'])[0])

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

    def get_null_pi(self):
        return 1.0 - float(np.sum(self._hyper.pi))

    def get_proportion_causal(self):
        return float(np.sum(self._hyper.pi))

    def get_average_effect_size_variance(self):
        return float(np.sum(self.pi / self.tau_beta))

    def get_heritability(self):
        return float(self._sigma_g / (self._sigma_g + self.sigma_epsilon))
