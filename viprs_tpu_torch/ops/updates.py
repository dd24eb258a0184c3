"""Closed-form M-step updates and variational objectives (the ELBO and its
terms: entropy, log prior, log-likelihood; MSE, h2).

Counterpart of viprs_tpu.ops.updates, vectorized over the model axis S.
Precision: elementwise math in float32 on the state's device; per-block
float32 partial sums, accumulated across blocks in float64. The M-step and
objective functions take the (S,) float64 statistics on any device.

    pi        = mean(gamma)
    tau_beta  = pi * M / sum(zeta)
    sigma_g   = sum((1+lambda_min) zeta + q*eta)
    sigma_eps = 1 - 2 beta'eta + sigma_g
    mse       = 1 - 2 beta'eta + sigma_g - sum(zeta) + sum(eta^2)
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from .cavi_torch import CaviState, Hyper

F64 = torch.float64


class FixMask(NamedTuple):
    """Per-model booleans: True where a hyperparameter is pinned."""
    sigma_eps: torch.Tensor
    tau_beta: torch.Tensor
    pi: torch.Tensor

    @classmethod
    def from_numpy(cls, sigma_eps, tau_beta, pi):
        """(S,) bool CPU tensors from array-likes (e.g. ``np.asarray`` of a
        JAX FixMask, or the model's numpy mask); the M-step runs on the
        host."""
        return cls(*(torch.from_numpy(np.array(x, dtype=bool).reshape(-1))
                     for x in (sigma_eps, tau_beta, pi)))


def masked_sum(x, mask):
    """(S, NB, B) * (NB, B) -> (S,) float64 (float32 per block, float64
    across blocks)."""
    return (x * mask[None]).sum(dim=2).to(F64).sum(dim=1)


def compute_var_tau(n_per_snp, hyper: Hyper):
    """var_tau = n (1 + lambda_min) / sigma_eps + tau_beta, (S, NB, B), with
    the hyperparameters the e-step used."""
    n = n_per_snp[None]
    return (n * (1.0 + hyper.lambda_min[:, None, None])
            / hyper.sigma_eps[:, None, None] + hyper.tau_beta[:, None, None])


def compute_zeta(state: CaviState, var_tau):
    """zeta = gamma (mu^2 + 1/var_tau) = E[beta^2] under the posterior."""
    return state.gamma * (state.mu * state.mu + 1.0 / var_tau)


class SweepStats(NamedTuple):
    """Per-model (S,) float64 reductions shared by M-step / ELBO / MSE."""
    sum_gamma: torch.Tensor
    sum_zeta: torch.Tensor
    sum_q_eta: torch.Tensor
    sum_beta_eta: torch.Tensor
    sum_eta_sq: torch.Tensor
    sum_g_logg: torch.Tensor       # sum gamma*log(gamma)
    sum_ng_logng: torch.Tensor     # sum (1-gamma)*log(1-gamma)
    sum_g_logvt: torch.Tensor      # sum gamma*log(var_tau)


def _softplus(x):
    """log(1 + exp(x)) exactly (torch's softplus switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def collect_stats(state: CaviState, var_tau, std_beta, mask) -> SweepStats:
    g = state.gamma
    zeta = compute_zeta(state, var_tau)
    u = state.logits
    return SweepStats(
        sum_gamma=masked_sum(g, mask),
        sum_zeta=masked_sum(zeta, mask),
        sum_q_eta=masked_sum(state.q * state.eta, mask),
        sum_beta_eta=masked_sum(state.eta * std_beta[None], mask),
        sum_eta_sq=masked_sum(state.eta * state.eta, mask),
        sum_g_logg=masked_sum(-g * _softplus(-u), mask),
        sum_ng_logng=masked_sum(-(1.0 - g) * _softplus(u), mask),
        sum_g_logvt=masked_sum(g * torch.log(var_tau), mask),
    )


def m_step(stats: SweepStats, hyper: Hyper, fix: FixMask, m_total, active):
    """Closed-form hyperparameter updates; fixed or inactive lanes keep their
    values. Returns (new_hyper float64, sigma_g)."""
    m_total = float(m_total)
    frozen = ~active.to(torch.bool)

    pi = torch.where(fix.pi | frozen, hyper.pi.to(F64),
                     stats.sum_gamma / m_total)
    tau_beta = torch.where(fix.tau_beta | frozen, hyper.tau_beta.to(F64),
                           pi * m_total / stats.sum_zeta)
    lam = hyper.lambda_min.to(F64)
    sigma_g = (1.0 + lam) * stats.sum_zeta + stats.sum_q_eta
    sigma_eps = torch.where(fix.sigma_eps | frozen, hyper.sigma_eps.to(F64),
                            1.0 - 2.0 * stats.sum_beta_eta + sigma_g)
    return Hyper(sigma_eps=sigma_eps, tau_beta=tau_beta, pi=pi,
                 lambda_min=lam), sigma_g


def elbo(stats: SweepStats, hyper: Hyper, fix_sigma_eps, sigma_g, n, m_total):
    """Evidence lower bound, (S,) float64 (post-M-step ``hyper``, e-step
    ``stats``)."""
    sig_e = hyper.sigma_eps.to(F64)
    tau_b = hyper.tau_beta.to(F64)
    pi = hyper.pi.to(F64)
    n = float(n)
    m_total = float(m_total)

    quad = (1.0 / sig_e) * (1.0 - 2.0 * stats.sum_beta_eta + sigma_g)
    fit_term = torch.where(fix_sigma_eps.to(torch.bool), quad,
                           torch.ones_like(quad))
    e = 0.5 * n * (-torch.log(2.0 * math.pi * sig_e) - fit_term)
    e = e - (stats.sum_g_logg - stats.sum_gamma * torch.log(pi))
    e = e - (stats.sum_ng_logng
             - (m_total - stats.sum_gamma) * torch.log1p(-pi))
    e = e + 0.5 * (stats.sum_gamma * (1.0 + torch.log(tau_b))
                   - stats.sum_g_logvt)
    return e - 0.5 * tau_b * stats.sum_zeta


def mse(stats: SweepStats, sigma_g):
    """Summary-statistics training MSE."""
    return (1.0 - 2.0 * stats.sum_beta_eta + sigma_g
            - stats.sum_zeta + stats.sum_eta_sq)


def heritability(sigma_g, sigma_eps):
    return sigma_g / (sigma_g + sigma_eps.to(F64))


def entropy(stats: SweepStats, m_total):
    """Entropy of the variational distribution, (S,) float64."""
    m_total = float(m_total)
    e = -stats.sum_g_logg - stats.sum_ng_logng - 0.5 * stats.sum_g_logvt
    return 0.5 * m_total * (math.log(2.0 * math.pi) + 1.0) + e


def log_prior(stats: SweepStats, hyper: Hyper, m_total):
    """Expected log prior under the variational density, (S,) float64."""
    m_total = float(m_total)
    tau_b = hyper.tau_beta.to(F64)
    pi = hyper.pi.to(F64)
    lp = 0.5 * stats.sum_gamma * torch.log(tau_b)
    lp = lp + stats.sum_gamma * torch.log(pi)
    lp = lp + (m_total - stats.sum_gamma) * torch.log1p(-pi)
    lp = lp - 0.5 * tau_b * stats.sum_zeta
    return lp - 0.5 * m_total * math.log(2.0 * math.pi)


def loglikelihood(stats: SweepStats, hyper: Hyper, sigma_g, n):
    """Expected log-likelihood of the data, (S,) float64."""
    sig_e = hyper.sigma_eps.to(F64)
    return -0.5 * float(n) * (torch.log(2.0 * math.pi * sig_e)
                              + (1.0 / sig_e) * (1.0 - 2.0 * stats.sum_beta_eta
                                                 + sigma_g))


def stats_bundle(state: CaviState, n_per_snp, std_beta, mask, hyper: Hyper):
    """var_tau and the sweep statistics of a state in one call (on the
    state's device)."""
    return collect_stats(state, compute_var_tau(n_per_snp, hyper), std_beta,
                         mask)
