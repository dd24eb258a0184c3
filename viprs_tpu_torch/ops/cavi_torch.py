"""Blocked CAVI e-step sweep — the plain PyTorch version.

Counterpart of viprs_tpu.ops.cavi_jax, with S model lanes. These functions
are the plain versions of the CUDA kernels in ops/cavi_cuda.py: the kernel
wrappers call them for CPU tensors, the tests hold them against the JAX
package, and chip_smoke.py holds the kernels against them on the card.

Schedule (as in the JAX package): tiles of T coordinates update jointly
(Jacobi, INNER_STEPS tile-local passes with gamma-weighted
under-relaxation), tiles within a block sequentially (Gauss-Seidel, a rank-T
q update after each tile), blocks in parallel, and the coupling tiles between
blocks are applied once per sweep from the sweep's total eta change.

State layout: (S, NB, B) float32; ``std_beta``, ``n_per_snp`` and the LD mask
are (NB, B) float32.
"""

from typing import NamedTuple

import numpy as np
import torch

from .block_ld import BlockLD

F32 = torch.float32
# The reference zeroes updates below max(machine eps, 1e-8).
ETA_DIFF_EPS = 1e-8
#: Coordinates updated jointly (one tile), and tile-local passes per tile.
TILE = 128
INNER_STEPS = 8
#: Coupling tiles (resp. diagonal tiles) dequantized to float32 at a time.
OFF_CHUNK = 32
DIAG_CHUNK = 64


def _from_numpy(x, device):
    return torch.from_numpy(np.require(x, requirements=['C', 'W'])).to(device)


class CaviState(NamedTuple):
    """Per-variant variational state, all (S, NB, B) float32. ``logits`` are
    the Bernoulli logits of gamma."""
    logits: torch.Tensor
    mu: torch.Tensor
    eta: torch.Tensor
    q: torch.Tensor

    @property
    def gamma(self):
        return torch.sigmoid(self.logits)

    @classmethod
    def from_numpy(cls, logits, mu, eta, q, *, device):
        """State from numpy arrays (e.g. ``np.asarray`` of the JAX fields)."""
        return cls(*(_from_numpy(x, device) for x in (logits, mu, eta, q)))


class Hyper(NamedTuple):
    """Per-model hyperparameters, (S,) each (float32 on kernel entry)."""
    sigma_eps: torch.Tensor
    tau_beta: torch.Tensor
    pi: torch.Tensor
    lambda_min: torch.Tensor

    @classmethod
    def from_numpy(cls, sigma_eps, tau_beta, pi, lambda_min, *, device):
        """Hyperparameters from numpy arrays, keeping their dtype."""
        return cls(*(_from_numpy(np.atleast_1d(x), device)
                     for x in (sigma_eps, tau_beta, pi, lambda_min)))

    def to32(self):
        return Hyper(*(x.to(F32) for x in self))


def _dequant_matmul(d, R, scale):
    """(S, nb, K) x (nb, K, N) -> (S, nb, N), dequantizing R to float32;
    the scale multiplies the sum, as in the JAX package."""
    out = torch.einsum('sbk,bkn->sbn', d, R.to(F32))
    if scale != 1.0:
        out = out * float(np.float32(scale))
    return out


def _off_contrib(ld: BlockLD, v, tiles=None, out_dtype=F32):
    """Cross-tile contribution of the coupling tiles:
    out[src_o] += U_o @ v[dst_o]; out[dst_o] += U_o^T @ v[src_o].

    :param v: (S, NB, B) float32. :param tiles: optional (k,) long index of
        the coupling tiles to apply (default: all).
    :param out_dtype: the dtype the float32 tile products are summed in.
    :returns: (S, NB, B). Streams OFF_CHUNK tiles at a time, so the float32
        view of the int8 tiles stays small.
    """
    if tiles is None:
        tiles = torch.arange(ld.n_off, device=v.device)
    out = torch.zeros(v.shape, dtype=out_dtype, device=v.device)
    for i in range(0, tiles.numel(), OFF_CHUNK):
        sel = tiles[i:i + OFF_CHUNK]
        U = ld.off_data.index_select(0, sel).to(F32)         # (k, B, B)
        src = ld.off_src.index_select(0, sel).long()
        dst = ld.off_dst.index_select(0, sel).long()
        row = torch.einsum('oij,soj->soi', U, v.index_select(1, dst))
        col = torch.einsum('oji,soj->soi', U, v.index_select(1, src))
        out.index_add_(1, src, row.to(out_dtype))
        out.index_add_(1, dst, col.to(out_dtype))
    if ld.scale != 1.0:
        out = out * float(np.float32(ld.scale))
    return out


def compute_q(ld: BlockLD, eta):
    """q = (R - I) @ eta from scratch. eta: (S, NB, B) -> (S, NB, B).
    DIAG_CHUNK blocks at a time bound the float32 view of the tiles.

    A float64 eta is taken as the JAX package takes it (cavi_jax.compute_q
    under x64): the tile products in float32, of eta rounded to float32;
    the unit diagonal and the sums of the coupling tiles' products in
    float64, so q is float64."""
    e32 = eta.to(F32)
    q = torch.empty_like(e32)
    for i in range(0, ld.nb, DIAG_CHUNK):
        sl = slice(i, i + DIAG_CHUNK)
        q[:, sl] = torch.einsum('bij,sbj->sbi', ld.diag[sl].to(F32),
                                e32[:, sl])
    if ld.scale != 1.0:
        q = q * float(np.float32(ld.scale))
    q = q.to(eta.dtype) - eta
    if ld.n_off > 0:
        q = q + _off_contrib(ld, e32, out_dtype=eta.dtype)
    return q


def refresh_q(ld: BlockLD, q, eta_diff):
    """Apply the coupling-tile part of the q update for this sweep's total
    eta change (no-op for block-diagonal LD)."""
    if ld.n_off == 0:
        return q
    return q + _off_contrib(ld, eta_diff)


def coupling_pass(ld: BlockLD, q, eta_diff, blk_mask):
    """``refresh_q`` restricted to the coupling tiles whose src or dst block
    is flagged in ``blk_mask`` ((NB,) bool/int). A tile with both ends
    unflagged carries a zero eta change, so restricting is exact up to float
    summation order."""
    if ld.n_off == 0:
        return q
    blk = blk_mask.to(torch.bool)
    act = blk.index_select(0, ld.off_src.long()) \
        | blk.index_select(0, ld.off_dst.long())
    tiles = torch.nonzero(act).reshape(-1)
    if tiles.numel() == 0:
        return q
    return q + _off_contrib(ld, eta_diff, tiles)


def union_block_mask(prop_mask, active):
    """The block gate of the S-lane skip sweep (K4): a block is swept iff
    ANY live lane (active > 0) proposes a step on it, so sweeping a subset
    of the lanes keeps every lane's result (viprs_tpu/ops/em_loop.py:296).

    :param prop_mask: (S, NB) bool, e.g. ``cavi_cuda.block_proposal_mask``.
    :param active: (S,) float step scales.
    :returns: (NB,) bool.
    """
    return (prop_mask & (active > 0.0)[:, None]).any(dim=0)


def _block_tile_loop(D, beta, n, mask, logits, mu, eta, q, hyper: Hyper,
                     active, scale, relax):
    """Gauss-Seidel over the tiles of nb blocks at once (vectorized over
    blocks and lanes). Within a tile the coordinates take INNER_STEPS joint
    under-relaxed steps

        w_j = active / (1 + sum_{k in tile, k != j} |R_jk| gamma*_k |mu_mult_k|)

    from a tile-locally refreshed q; the keep gate drops |d_eta| < 1e-8.

    D: (nb, B, B) storage dtype; beta, n, mask: (nb, B); logits, mu, eta, q:
    (S, nb, B); hyper: (S,) float32; active: (S,) float32.
    Returns new (logits, mu, eta, q).
    """
    sig_e = hyper.sigma_eps[:, None, None]
    tau_b = hyper.tau_beta[:, None, None]
    lam = hyper.lambda_min[:, None, None]
    pi_ = hyper.pi[:, None, None]
    base_logit = torch.log(pi_) - torch.log1p(-pi_) + 0.5 * torch.log(tau_b)
    act = active[:, None, None]
    on = (active > 0.0).to(F32)[:, None, None]
    scale32 = float(np.float32(scale))

    logits, mu, eta, q = (x.clone() for x in (logits, mu, eta, q))
    B = D.shape[1]
    for t in range(B // TILE):
        sl = slice(t * TILE, (t + 1) * TILE)
        q_t = q[..., sl]
        eta_t = eta[..., sl].clone()
        logits_t = logits[..., sl].clone()
        mu_t = mu[..., sl].clone()
        n_t = n[None, :, sl]
        beta_t = beta[None, :, sl]
        mask_t = mask[None, :, sl]

        var_tau_t = n_t * (1.0 + lam) / sig_e + tau_b
        mu_mult_t = n_t / (var_tau_t * sig_e)

        D_rows = D[:, sl, :]                               # (nb, T, B)
        R_tt = D_rows[:, :, sl]                            # (nb, T, T)
        R_abs = R_tt.to(F32).abs()
        R_abs_diag = torch.diagonal(R_abs, dim1=1, dim2=2)[None] * scale32

        g_cur = torch.sigmoid(logits_t)
        mu_cur = mu_t
        eta_cur = eta_t
        q_cur = q_t
        w = act
        for _ in range(INNER_STEPS):
            mu_star = mu_mult_t * (beta_t - q_cur)
            u_star = base_logit - 0.5 * torch.log(var_tau_t) \
                + 0.5 * var_tau_t * mu_star * mu_star
            g_star = torch.sigmoid(u_star)
            if relax:
                c = g_star * mu_mult_t.abs()
                coupling = _dequant_matmul(c, R_abs, scale) - R_abs_diag * c
                w = act / (1.0 + coupling)
            g_cur = g_cur + w * (g_star - g_cur)
            mu_cur = mu_cur + w * (mu_star - mu_cur)
            eta_new = g_cur * mu_cur
            d_in = (eta_new - eta_cur) * mask_t * on
            q_cur = q_cur + _dequant_matmul(d_in, R_tt, scale) - d_in
            eta_cur = eta_cur + d_in

        d_t = (eta_cur - eta_t) * mask_t * on
        keep = d_t.abs() >= ETA_DIFF_EPS
        d_t = torch.where(keep, d_t, torch.zeros_like(d_t))

        u_new = torch.log(g_cur.clamp(min=1e-30)) \
            - torch.log1p(-g_cur.clamp(max=1.0 - 1e-7))
        logits[..., sl] = torch.where(keep, u_new, logits_t)
        mu[..., sl] = torch.where(keep, mu_cur, mu_t)
        eta[..., sl] = eta_t + d_t

        # rank-T q update over the whole block (R symmetric), then remove
        # the stored unit diagonal's contribution at the focal variants:
        q += _dequant_matmul(d_t, D_rows, scale)
        q[..., sl] -= d_t
    return logits, mu, eta, q


def block_sweep(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                hyper: Hyper, active, blk_mask=None, relax: bool = True):
    """The within-block part of one sweep, over the blocks flagged in
    ``blk_mask`` ((NB,) bool/int; None = all). Unflagged blocks pass through
    bit-exactly with a zero eta change. Coupling tiles are NOT applied
    (see :func:`coupling_pass`).

    :returns: (new_state, eta_diff) with eta_diff = eta_new - eta_old.
    """
    if ld.block_size % TILE:
        raise ValueError(f"block size {ld.block_size} is not a multiple of "
                         f"the tile width {TILE}")
    hyper = hyper.to32()
    active = active.to(F32)
    if blk_mask is None:
        idx = None
    else:
        idx = torch.nonzero(blk_mask.to(torch.bool)).reshape(-1)

    def rows(x, axis):
        return x if idx is None else x.index_select(axis, idx)

    out = _block_tile_loop(rows(ld.diag, 0), rows(std_beta, 0),
                           rows(n_per_snp, 0), rows(ld.mask, 0),
                           *(rows(x, 1) for x in state), hyper, active,
                           ld.scale, relax)
    if idx is None:
        new = CaviState(*out)
    else:
        new = CaviState(*(x.index_copy(1, idx, o) for x, o in zip(state, out)))
    return new, new.eta - state.eta


def cavi_sweep(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
               hyper: Hyper, active, relax: bool = True):
    """One full CAVI sweep over all blocks and lanes, coupling included
    (counterpart of viprs_tpu.ops.cavi_jax.cavi_sweep).

    :param active: (S,) — 1.0 for lanes being optimized, 0.0 freezes a lane,
        fractional values damp it.
    :param relax: the gamma-weighted under-relaxation (off only to compare
        schedules).
    :returns: (new_state, eta_diff).
    """
    new, eta_diff = block_sweep(ld, state, std_beta, n_per_snp, hyper, active,
                                relax=relax)
    return new._replace(q=refresh_q(ld, new.q, eta_diff)), eta_diff
