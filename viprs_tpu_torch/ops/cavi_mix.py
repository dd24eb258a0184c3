"""Blocked CAVI sweep for the sparse Gaussian-mixture prior (VIPRSMix) — the
plain PyTorch versions.

Counterpart of viprs_tpu.ops.cavi_mix. K slab components ride an axis of the
variational state; per tile the K+1 component logits (K slabs and the null)
go through a softmax, and the scalar eta update feeds the same rank-T q
update as the spike-and-slab sweep. These functions are the plain versions of
the mixture kernels in ops/cavi_cuda.py (csrc/cavi_mix.cu): the wrappers call
them for CPU tensors, the tests hold them against the JAX package's Pallas
kernels, and chip_smoke.py holds the kernels against them on the card.

State layout (the JAX package's): single model, gamma/mu (K, NB, B) and
eta/q (NB, B); S model lanes, gamma/mu (S, K, NB, B) and eta/q (S, NB, B).
Hyperparameters: single model, sigma_eps/lambda_min scalars and
tau_beta/pi (K,); S lanes, (S,) and (S, K).
"""

from typing import NamedTuple

import numpy as np
import torch

from . import cavi_torch
from .block_ld import BlockLD
from .cavi_torch import ETA_DIFF_EPS, INNER_STEPS, TILE, _dequant_matmul

F32 = torch.float32
F64 = torch.float64


def _from_numpy(x, device):
    return torch.from_numpy(np.require(x, requirements=['C', 'W'])).to(device)


class MixState(NamedTuple):
    """gamma (responsibilities of the slab components) and mu, (K, NB, B) or
    (S, K, NB, B); eta and q, (NB, B) or (S, NB, B); float32."""
    gamma: torch.Tensor
    mu: torch.Tensor
    eta: torch.Tensor
    q: torch.Tensor

    @classmethod
    def from_numpy(cls, gamma, mu, eta, q, *, device):
        """State from numpy arrays (e.g. ``np.asarray`` of the JAX fields)."""
        return cls(*(_from_numpy(np.asarray(x, np.float32), device)
                     for x in (gamma, mu, eta, q)))


class MixHyper(NamedTuple):
    """sigma_eps, lambda_min: scalar or (S,); tau_beta, pi: (K,) or (S, K)."""
    sigma_eps: torch.Tensor
    tau_beta: torch.Tensor
    pi: torch.Tensor
    lambda_min: torch.Tensor

    @classmethod
    def from_numpy(cls, sigma_eps, tau_beta, pi, lambda_min, *, device):
        """Hyperparameters from numpy arrays or numbers, keeping their dtype."""
        return cls(*(_from_numpy(np.array(x), device)
                     for x in (sigma_eps, tau_beta, pi, lambda_min)))

    def to32(self):
        return MixHyper(*(x.to(F32) for x in self))

    def lanes(self):
        """The single-model hyperparameters as one lane: (1,) and (1, K)."""
        return MixHyper(self.sigma_eps.reshape(1), self.tau_beta.reshape(1, -1),
                        self.pi.reshape(1, -1), self.lambda_min.reshape(1))


def log_null_pi(pi):
    """log(1 - sum_k pi_k) in float32 from float32 pi, (..., K) -> (...)."""
    return torch.log1p(-pi.to(F32).sum(dim=-1))


def compute_q_mix(ld: BlockLD, eta):
    """q = (R - I) eta for (NB, B) eta."""
    return cavi_torch.compute_q(ld, eta[None])[0]


def mix_var_tau(n_per_snp, hyper: MixHyper):
    """Posterior precisions with the e-step hyperparameters: (K, NB, B) for
    single-model hyperparameters, (S, K, NB, B) for S lanes."""
    sig_e = hyper.sigma_eps[..., None, None, None]
    lam = hyper.lambda_min[..., None, None, None]
    return n_per_snp * (1.0 + lam) / sig_e + hyper.tau_beta[..., None, None]


def mix_stats(state: MixState, var_tau, std_beta, mask):
    """Masked reductions used by the mixture M-step and ELBO.

    Mixed precision as in the JAX package (cavi_mix.py:308-356): every
    elementwise term, the entropy logs included, in float32, the minor (B)
    axis summed in float32, and only the per-block partial sums upcast to
    float64 for the sum across blocks. Works for one model (K, NB, B) and for
    S lanes (S, K, NB, B): per-component sums are (..., K), the others (...).
    """
    def rsum(x):                       # (..., NB, B) -> (...)
        return x.sum(dim=-1).to(F64).sum(dim=-1)

    g = state.gamma
    eta = state.eta
    zeta_k = g * (state.mu ** 2 + 1.0 / var_tau)
    # the JAX package clips to [eps, 1 - eps] in float32, where 1 - 1e-12
    # rounds to 1
    eps, hi = float(np.float32(1e-12)), float(np.float32(1.0) - np.float32(1e-12))
    pip = torch.clamp(g.sum(dim=-3), min=eps, max=hi)
    null_g = 1.0 - pip
    gc = torch.clamp(g, min=eps, max=hi)
    ngc = torch.clamp(null_g, min=eps, max=hi)
    return dict(
        sum_gamma_k=rsum(g * mask),
        sum_zeta_k=rsum(zeta_k * mask),
        sum_q_eta=rsum(state.q * eta * mask),
        sum_beta_eta=rsum(std_beta * eta * mask),
        sum_eta_sq=rsum(eta ** 2 * mask),
        sum_g_logg=rsum(gc * torch.log(gc) * mask).sum(dim=-1),
        sum_ng_logng=rsum(ngc * torch.log(ngc) * mask),
        sum_null_g=rsum(null_g * mask),
        sum_g_logvt=rsum(g * torch.log(var_tau) * mask))


def _mix_tile_loop(D, beta, n, mask, gamma, mu, eta, q, hyper: MixHyper,
                   active, scale, unit_diag):
    """Tile-Gauss-Seidel over the tiles of nb blocks for S lanes at once.

    Within a tile the coordinates take INNER_STEPS joint steps from a
    tile-locally refreshed q: the softmax over the K slabs and the null
    (its max seeded by log_null_pi), the under-relaxation

        w_j = act / (1 + sum_{k != j} |R_jk| pip*_k max_c |mu_mult_c,k|)

    recomputed every step, and the rank-T q update after the tile. There is
    no keep gate (the mixture kernels have none).

    D: (nb, B, B) int8; beta, n, mask: (nb, B); gamma, mu: (S, K, nb, B);
    eta, q: (S, nb, B); hyper: (S,) / (S, K) float32. ``active``: (S,)
    float32 step scales (the lane kernel, K7/K8), or None for the
    single-model kernels K5/K6, which have no step scale (w = 1 / (1 + c)
    and no lane gate). ``unit_diag``: the diagonal term of the relaxation is
    the variant mask (K6/K8) instead of |R_jj| read from the tile (K5/K7).
    Returns new (gamma, mu, eta, q).
    """
    S, K = gamma.shape[0], gamma.shape[1]
    sig_e = hyper.sigma_eps[:, None, None, None]            # (S,1,1,1)
    lam = hyper.lambda_min[:, None, None, None]
    tau_b = hyper.tau_beta[:, :, None, None]                # (S,K,1,1)
    pi_ = hyper.pi[:, :, None, None]
    base_logit = torch.log(pi_) - torch.log1p(-pi_) + 0.5 * torch.log(tau_b)
    lnp = log_null_pi(hyper.pi)[:, None, None]              # (S,1,1)
    if active is None:
        act = on = None
    else:
        act = active[:, None, None]
        on = (active > 0.0).to(F32)[:, None, None]
    scale32 = np.float32(scale)

    gamma, mu, eta, q = (x.clone() for x in (gamma, mu, eta, q))
    B = D.shape[1]
    for t in range(B // TILE):
        sl = slice(t * TILE, (t + 1) * TILE)
        q_t = q[..., sl]
        eta_t = eta[..., sl].clone()
        g_t = gamma[..., sl].clone()
        mu_t = mu[..., sl].clone()
        n_t = n[None, None, :, sl]                         # (1,1,nb,T)
        beta_t = beta[None, :, sl]                         # (1,nb,T)
        mask_t = mask[None, :, sl]

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b      # (S,K,nb,T)
        mu_mult_t = n_t / (var_tau_t * sig_e)
        mu_mult_max = mu_mult_t.abs().amax(dim=1)          # (S,nb,T)
        log_vt = torch.log(var_tau_t)

        D_rows = D[:, sl, :]                               # (nb,T,B)
        R_tt = D_rows[:, :, sl].to(F32) * scale32          # (nb,T,T)
        R_abs = R_tt.abs()
        rdiag = mask_t if unit_diag else \
            torch.diagonal(R_abs, dim1=1, dim2=2)[None]

        g_cur, mu_cur, eta_cur, q_cur = g_t, mu_t, eta_t, q_t
        for _ in range(INNER_STEPS):
            mu_star = mu_mult_t * (beta_t - q_cur)[:, None]        # (S,K,nb,T)
            u = base_logit - 0.5 * log_vt + 0.5 * var_tau_t * mu_star * mu_star
            u_max = torch.maximum(u.amax(dim=1), lnp)              # (S,nb,T)
            exp_u = torch.exp(u - u_max[:, None])
            denom = exp_u.sum(dim=1) + torch.exp(lnp - u_max)
            g_star = exp_u / denom[:, None]

            c = g_star.sum(dim=1) * mu_mult_max                   # (S,nb,T)
            coupling = _dequant_matmul(c, R_abs, 1.0) - rdiag * c
            w = (1.0 / (1.0 + coupling)) if act is None \
                else act / (1.0 + coupling)
            w = w[:, None]
            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            eta_new = (g_cur * mu_cur).sum(dim=1)
            d_in = (eta_new - eta_cur) * mask_t
            if on is not None:
                d_in = d_in * on
            q_cur = q_cur + _dequant_matmul(d_in, R_tt, 1.0) - d_in
            eta_cur = eta_cur + d_in

        d_t = (eta_cur - eta_t) * mask_t
        if on is not None:
            d_t = d_t * on
        gamma[..., sl] = g_cur
        mu[..., sl] = mu_cur
        eta[..., sl] = eta_t + d_t
        # rank-T q update over the whole block (R symmetric), then remove the
        # stored unit diagonal's contribution at the focal variants
        q += _dequant_matmul(d_t, D_rows, scale)
        q[..., sl] -= d_t
    return gamma, mu, eta, q


def mix_block_sweep(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                    hyper: MixHyper, active=None, blk_mask=None,
                    unit_diag=False):
    """The within-block part of one mixture sweep over the blocks flagged in
    ``blk_mask`` ((NB,) bool/int; None = all), for S lanes (state (S, K, NB,
    B) / (S, NB, B); hyper (S,) / (S, K)). Unflagged blocks pass through
    bit-exactly with a zero eta change. Coupling tiles are NOT applied
    (cavi_torch.coupling_pass). ``active`` and ``unit_diag``: see
    :func:`_mix_tile_loop`.

    :returns: (new_state, eta_diff) with eta_diff = eta_new - eta_old.
    """
    if ld.block_size % TILE:
        raise ValueError(f"block size {ld.block_size} is not a multiple of "
                         f"the tile width {TILE}")
    hyper = hyper.to32()
    if active is not None:
        active = active.to(F32)
    idx = None if blk_mask is None else \
        torch.nonzero(blk_mask.to(torch.bool)).reshape(-1)

    def rows(x, axis):
        return x if idx is None else x.index_select(axis, idx)

    out = _mix_tile_loop(rows(ld.diag, 0), rows(std_beta, 0),
                         rows(n_per_snp, 0), rows(ld.mask, 0),
                         rows(state.gamma, 2), rows(state.mu, 2),
                         rows(state.eta, 1), rows(state.q, 1), hyper, active,
                         ld.scale, unit_diag)
    if idx is None:
        new = MixState(*out)
    else:
        new = MixState(*(x.index_copy(ax, idx, o) for x, o, ax in
                         zip(state, out, (2, 2, 1, 1))))
    return new, new.eta - state.eta


def mix_block_proposal_mask(ld: BlockLD, state: MixState, std_beta,
                            n_per_snp, hyper: MixHyper, eps=ETA_DIFF_EPS):
    """Per-block activity of the single model from the unrelaxed first-step
    K-component proposal (no LD traffic; cavi_pallas.py:1439-1459).
    Returns (NB,) bool."""
    sig_e = hyper.sigma_eps.to(F32)
    tau_b = hyper.tau_beta.to(F32)[:, None, None]            # (K,1,1)
    pi_ = hyper.pi.to(F32)[:, None, None]
    lam = hyper.lambda_min.to(F32)
    lnp = log_null_pi(hyper.pi)
    n = n_per_snp[None]
    var_tau = n * (1.0 + lam) / sig_e + tau_b                # (K,NB,B)
    mu_star = (n / (var_tau * sig_e)) * (std_beta[None] - state.q[None])
    u = torch.log(pi_) - torch.log1p(-pi_) + 0.5 * torch.log(tau_b) \
        - 0.5 * torch.log(var_tau) + 0.5 * var_tau * mu_star * mu_star
    u_max = torch.maximum(u.amax(dim=0), lnp)
    exp_u = torch.exp(u - u_max[None])
    denom = exp_u.sum(dim=0) + torch.exp(lnp - u_max)
    eta_star = (exp_u / denom[None] * mu_star).sum(dim=0)
    prop = (eta_star - state.eta).abs() * ld.mask
    return prop.amax(dim=1) >= eps


def mix_block_proposal_mask_batch(ld: BlockLD, state: MixState, std_beta,
                                  n_per_snp, hyper: MixHyper,
                                  eps=ETA_DIFF_EPS):
    """Per-(lane, block) activity of S lanes from the unrelaxed first-step
    K-component proposal (no LD traffic; cavi_pallas.py:1567-1590).
    Returns (S, NB) bool."""
    sig_e = hyper.sigma_eps.to(F32)[:, None, None, None]     # (S,1,1,1)
    tau_b = hyper.tau_beta.to(F32)[:, :, None, None]         # (S,K,1,1)
    pi_ = hyper.pi.to(F32)[:, :, None, None]
    lam = hyper.lambda_min.to(F32)[:, None, None, None]
    lnp = log_null_pi(hyper.pi)[:, None, None]               # (S,1,1)
    n = n_per_snp[None, None]
    var_tau = n * (1.0 + lam) / sig_e + tau_b                # (S,K,NB,B)
    mu_star = (n / (var_tau * sig_e)) * (std_beta[None, None]
                                         - state.q[:, None])
    u = torch.log(pi_) - torch.log1p(-pi_) + 0.5 * torch.log(tau_b) \
        - 0.5 * torch.log(var_tau) + 0.5 * var_tau * mu_star * mu_star
    u_max = torch.maximum(u.amax(dim=1), lnp)
    exp_u = torch.exp(u - u_max[:, None])
    denom = exp_u.sum(dim=1) + torch.exp(lnp - u_max)
    eta_star = (exp_u * mu_star).sum(dim=1) / denom
    prop = (eta_star - state.eta).abs() * ld.mask[None]
    return prop.amax(dim=2) >= eps
