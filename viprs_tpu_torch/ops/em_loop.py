"""The variational EM loop for one model (S = 1), as a host loop.

Counterpart of viprs_tpu.ops.em_loop.em_fit at S = 1. Each iteration runs on
the device [activity mask -> sweep -> statistics] and reads back ONE small
float64 vector (the sweep statistics, max |d_eta| and the active-block
count); the M-step, ELBO and the convergence ladder then run on the host in
float64, with the float32 roundings of the JAX loop kept where they decide a
comparison (max |d_eta| and damping are float32 there).

The hybrid dispatch chooses its branch on the device, by the block mask it
hands the one sweep kernel pair (ops/cavi_cuda.cavi_sweep_s1_skip): the
proposal mask when at most ``int(HYBRID_FRAC * NB)`` blocks are active (the
skip branch), all ones otherwise (the all-active branch).
"""

import math
from typing import List, NamedTuple

import numpy as np
import torch

from . import updates
from .block_ld import BlockLD
from .cavi_cuda import block_proposal_mask, cavi_sweep_s1_skip
from .cavi_torch import CaviState, Hyper
from ..utils import optimize as opt

F32 = torch.float32
F64 = torch.float64

#: Active-block fraction at or below which an iteration takes the skip
#: branch (the JAX package's measured policy value).
HYBRID_FRAC = 0.35


class EMResult(NamedTuple):
    state: CaviState
    hyper: Hyper                 # (1,) float64 CPU tensors
    sigma_g: float
    status: int
    nit: int
    elbo_hist: List[float]       # [initial, iteration 1, ..., n_iter_total]
    n_iter_total: int
    final_elbo: float
    restarts_used: int
    act_hist: List[int]          # active blocks per iteration (-1: not measured)
    n_skip: int                  # iterations that took the skip branch


def _f32(x):
    return np.float32(x)


def _hyper_host(values):
    """Hyper of (1,) float64 CPU tensors from four floats."""
    return Hyper(*(torch.tensor([float(v)], dtype=F64) for v in values))


def _hyper_dev(h: Hyper, device):
    """float32 copy of a host Hyper on ``device``, in one transfer."""
    v = torch.tensor([float(x[0]) for x in h], dtype=F32).to(device)
    return Hyper(v[0:1], v[1:2], v[2:3], v[3:4])


def _stats_host(state, n_per_snp, std_beta, mask, h_dev, *extra):
    """Sweep statistics (+ extra scalars) read to the host in one transfer."""
    var_tau = updates.compute_var_tau(n_per_snp, h_dev)
    st = updates.collect_stats(state, var_tau, std_beta, mask)
    host = torch.cat([*st, *(x.reshape(1).to(F64) for x in extra)]).cpu()
    n = len(st)
    return updates.SweepStats(*(host[i:i + 1] for i in range(n))), host[n:]


def em_fit(ld: BlockLD, state0: CaviState, std_beta, n_per_snp, hyper0,
           fix_sigma_eps: bool, fix_tau_beta: bool, fix_pi: bool,
           n_sample, m_total, max_iter: int = 1000, min_iter: int = 3,
           f_abs_tol: float = 1e-6, x_abs_tol: float = 1e-6,
           patience: int = 10, use_hybrid: bool = True,
           hybrid_eps: float = None, max_restarts: int = 0,
           restart_hyper=None, restart_logit=None) -> EMResult:
    """Run EM until the model terminates or ``max_iter`` iterations.

    :param hyper0: (sigma_eps, tau_beta, pi, lambda_min) floats.
    :param use_hybrid: per-iteration activity-gated branch choice (above);
        False runs the all-active sweep every iteration.
    :param hybrid_eps: gate epsilon of the proposal mask (default
        ``x_abs_tol``).
    :param max_restarts: in-loop restart-on-negative-MSE budget: the state
        is re-initialized from ``restart_logit`` (float32 logit of the
        restart pi), the hyperparameters from ``restart_hyper`` (four
        floats, rounded through float32), sigma_eps is fixed from then on and
        the counters reset.
    """
    dev = ld.device
    mask = ld.mask
    nb = ld.nb
    thresh = int(HYBRID_FRAC * nb)
    gate_eps = x_abs_tol if hybrid_eps is None else hybrid_eps
    fix = updates.FixMask(*(torch.tensor([v]) for v in
                            (fix_sigma_eps, fix_tau_beta, fix_pi)))
    ones_blk = torch.ones(nb, dtype=torch.int32, device=dev)
    on_host = torch.ones(1, dtype=torch.bool)

    def initial_elbo(state, hyper, fix_se, sigma_g):
        h_dev = _hyper_dev(hyper, dev)
        st, _ = _stats_host(state, n_per_snp, std_beta, mask, h_dev)
        h32 = Hyper(*(x.to(F32) for x in hyper))
        return float(updates.elbo(st, h32, torch.tensor([fix_se]),
                                  torch.tensor([sigma_g], dtype=F64),
                                  n_sample, m_total)[0])

    state = state0
    hyper = _hyper_host(hyper0)
    sigma_g = 0.0
    fix_se = bool(fix_sigma_eps)
    prev_elbo = initial_elbo(state, hyper, fix_se, sigma_g)
    elbo_hist = [prev_elbo]
    act_hist = [-1]
    prev_dropped, osc, best_elbo, stall = False, 0, -math.inf, 0
    sigma_g_counter, div_counter, damping = 0, 0, _f32(1.0)
    restarts_left = max_restarts
    status, nit, n_skip = opt.RUNNING, 0, 0
    active = True

    i = 0
    while i < max_iter and active:
        i += 1
        gi = i
        h_dev = _hyper_dev(hyper, dev)
        act_f = _f32(1.0) * damping
        act_dev = torch.tensor([float(act_f)], dtype=F32).to(dev)

        # ---- E-step ----
        if use_hybrid:
            blk = block_proposal_mask(ld, state, std_beta, n_per_snp, h_dev,
                                      eps=gate_eps)[0] & bool(act_f > 0.0)
            n_act_blk = blk.sum()
            blk_mask = torch.where(n_act_blk <= thresh, blk.to(torch.int32),
                                   ones_blk)
        else:
            n_act_blk = torch.tensor(-1, device=dev)
            blk_mask = ones_blk
        state, eta_diff = cavi_sweep_s1_skip(ld, state, std_beta, n_per_snp,
                                             h_dev, act_dev, blk_mask)

        # ---- reductions with the e-step hyperparameters (one read) ----
        med_dev = (eta_diff.abs() * mask[None]).amax()
        stats, extra = _stats_host(state, n_per_snp, std_beta, mask, h_dev,
                                   med_dev, n_act_blk)
        max_ed = _f32(extra[0].item())
        n_act = int(extra[1].item())
        if use_hybrid and n_act <= thresh:
            n_skip += 1

        # ---- M-step and objectives (host, float64) ----
        fix_cur = fix._replace(sigma_eps=torch.tensor([fix_se]))
        new_hyper, sg = updates.m_step(stats, hyper, fix_cur, m_total,
                                       on_host)
        curr_elbo = float(updates.elbo(stats, new_hyper, fix_cur.sigma_eps,
                                       sg, n_sample, m_total)[0])
        curr_mse = float(updates.mse(stats, sg)[0])
        h2 = float(updates.heritability(sg, new_hyper.sigma_eps)[0])
        new_sigma_g = float(sg[0])
        hyper = new_hyper

        # ---- patience counters ----
        sigg_cond = (gi > min_iter
                     and abs(new_sigma_g - sigma_g) <= x_abs_tol
                     and max_ed < _f32(x_abs_tol * 10.0))
        sigma_g_counter = sigma_g_counter + 1 if sigg_cond else 0
        sigma_g = new_sigma_g

        dropped = curr_elbo < prev_elbo
        div_cond = dropped and not (abs(curr_elbo - prev_elbo)
                                    <= 1e3 * f_abs_tol + 1e-4 * abs(prev_elbo))
        div_counter = div_counter + 1 if div_cond else 0

        osc = osc + 1 if (dropped and prev_dropped) else (osc if dropped else 0)
        if osc > 5 and damping > _f32(0.01):
            damping = _f32(damping * _f32(0.7))
            osc = 0

        improved = curr_elbo > best_elbo + f_abs_tol
        best_elbo = max(best_elbo, curr_elbo)
        stall = 0 if improved else stall + 1
        if stall > 2 * patience and damping > _f32(0.01):
            damping = _f32(damping * _f32(0.5))
            stall = 0

        # ---- the ladder (ordered) ----
        sig_e = float(hyper.sigma_eps[0])
        if curr_mse < 0.0:
            status = opt.MSE_NEGATIVE
        elif not math.isfinite(curr_elbo):
            status = opt.ELBO_NONFINITE
        elif sig_e < 0.0:
            status = opt.SIGMA_EPS_NEGATIVE
        elif h2 > 1.0 or h2 < 0.0:
            status = opt.H2_OUT_OF_BOUNDS
        elif gi > min_iter and abs(curr_elbo - prev_elbo) <= f_abs_tol:
            status = opt.CONVERGED_F
        elif gi > min_iter and max_ed < _f32(x_abs_tol):
            status = opt.CONVERGED_X
        elif sigma_g_counter > patience:
            status = opt.CONVERGED_SIGMA_G
        elif div_counter > patience:
            status = opt.DIVERGED_ELBO
        else:
            status = opt.RUNNING

        prev_elbo_out = curr_elbo
        if (status == opt.MSE_NEGATIVE and restarts_left > 0 and not fix_se
                and i < max_iter):
            # in-loop restart on negative MSE (reference behavior)
            status = opt.RUNNING
            state = CaviState(
                logits=torch.full_like(state.logits, float(restart_logit)),
                mu=torch.zeros_like(state.mu),
                eta=torch.zeros_like(state.eta),
                q=torch.zeros_like(state.q))
            se, tb, pi = (float(_f32(x)) for x in restart_hyper[:3])
            hyper = Hyper(*(torch.tensor([v], dtype=F64) for v in (se, tb, pi)),
                          lambda_min=hyper.lambda_min)
            sigma_g = 0.0
            fix_se = True
            prev_elbo_out = initial_elbo(state, hyper, fix_se, sigma_g)
            prev_dropped, osc, best_elbo, stall = False, 0, -math.inf, 0
            sigma_g_counter, div_counter, damping = 0, 0, _f32(1.0)
            restarts_left -= 1
            dropped = False

        nit = gi
        active = status == opt.RUNNING
        elbo_hist.append(curr_elbo)
        act_hist.append(n_act)
        prev_elbo = prev_elbo_out
        prev_dropped = dropped

    if active:
        status = opt.MAX_ITER
    return EMResult(state=state, hyper=hyper, sigma_g=sigma_g, status=status,
                    nit=nit, elbo_hist=elbo_hist, n_iter_total=i,
                    final_elbo=prev_elbo, restarts_used=max_restarts - restarts_left,
                    act_hist=act_hist, n_skip=n_skip)
