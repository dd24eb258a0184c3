"""The variational EM loops of the mixture prior (VIPRSMix), as host loops.

Counterpart of viprs_tpu.ops.mix_em_loop. Each iteration runs on the device
[activity mask -> mixture sweep -> statistics] and reads back ONE small
float64 vector (the per-lane sweep statistics, max |d_eta| and, on the skip
path, the active-block count); the M-step (with the prior-variance
multipliers ``d_mult`` and the ``total_pi`` renormalisation), the ELBO and
the convergence ladder run on the host over (S,) numpy arrays in float64,
with the float32 roundings of the JAX loops kept where they decide a
comparison (max |d_eta| is float32 there).

The two loops differ on purpose, as in the JAX package:

- ``mix_em_fit`` (one model: gamma/mu (K, NB, B), eta/q (NB, B)) has no
  oscillation/stall damping ladder, and its sweep (K5, or K6 with the
  activity mask of ``cavi_mix.mix_block_proposal_mask``) has no step scale;
- ``mix_em_fit_batch`` (S lanes: (S, K, NB, B) / (S, NB, B)) carries the
  damping ladder, masks finished lanes (they keep state, hyperparameters,
  sigma_g and objective) and takes the chunk carry ``active0``, ``i0``,
  ``counters0``, ``init_elbo`` and ``sigma_g0``, so a chunked run takes the
  single call's path; its sweep is K7, or K8 with the union over the live
  lanes of ``cavi_mix.mix_block_proposal_mask_batch``.

A fit through the batch loop at S = 1 is therefore not a VIPRSMix fit.

On a shard of a mesh (``ld`` a ``parallel.mesh.ShardedLD``; the mixtures
split the blocks only) both loops run their sweeps on the rank's blocks
with the halo before the coupling pass, make the activity masks global
before the sweep, and add the statistics of every rank (max |d_eta| its
maximum) before the host M-step, as ``em_loop.em_fit`` does.
"""

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from . import cavi_mix
from .block_ld import BlockLD
from .cavi_cuda import (cavi_sweep_mix_s, cavi_sweep_mix_s1,
                        cavi_sweep_mix_s1_skip, cavi_sweep_mix_s_skip)
from .cavi_mix import MixHyper, MixState
from .cavi_torch import INNER_STEPS
from ..utils import optimize as opt

F32 = torch.float32
F64 = torch.float64

#: The sweep statistics read back each iteration: name, per component.
_STATS = (('sum_gamma_k', True), ('sum_zeta_k', True), ('sum_q_eta', False),
          ('sum_beta_eta', False), ('sum_eta_sq', False),
          ('sum_g_logg', False), ('sum_ng_logng', False),
          ('sum_null_g', False), ('sum_g_logvt', True))


class MixFix(NamedTuple):
    """Hyperparameters pinned out of the single-model M-step."""
    sigma_eps: bool
    tau_betas: bool          # pins the whole tau vector
    pis: bool                # pins the whole pi vector
    total_pi: float          # > 0: renormalise pi to this total

    @classmethod
    def from_numpy(cls, sigma_eps, tau_betas, pis, total_pi):
        """From array-likes (e.g. ``np.asarray`` of the JAX package's
        ``MixFix`` fields)."""
        return cls(bool(np.asarray(sigma_eps)), bool(np.asarray(tau_betas)),
                   bool(np.asarray(pis)), float(np.asarray(total_pi)))


class MixFixBatch(NamedTuple):
    """Per-lane pinning, (S,) numpy each: bool, bool, bool, float64."""
    sigma_eps: np.ndarray
    tau_betas: np.ndarray
    pis: np.ndarray
    total_pi: np.ndarray

    @classmethod
    def from_numpy(cls, sigma_eps, tau_betas, pis, total_pi):
        return cls(np.array(sigma_eps, bool).reshape(-1),
                   np.array(tau_betas, bool).reshape(-1),
                   np.array(pis, bool).reshape(-1),
                   np.array(total_pi, np.float64).reshape(-1))


class MixCounters(NamedTuple):
    """The batch loop's convergence-ladder state that survives across
    chunked calls, (S,) numpy each."""
    prev_dropped: np.ndarray     # bool
    osc_counter: np.ndarray      # int32
    best_elbo: np.ndarray        # float64
    stall_counter: np.ndarray    # int32
    sigma_g_counter: np.ndarray  # int32
    div_counter: np.ndarray      # int32
    damping: np.ndarray          # float32

    @classmethod
    def from_numpy(cls, prev_dropped, osc_counter, best_elbo, stall_counter,
                   sigma_g_counter, div_counter, damping):
        """Counters from array-likes (e.g. ``np.asarray`` of the JAX
        package's ``MixCounters``), as fresh arrays of the ladder's dtypes."""
        i32 = np.int32
        return cls(np.array(prev_dropped, bool).reshape(-1),
                   np.array(osc_counter, i32).reshape(-1),
                   np.array(best_elbo, np.float64).reshape(-1),
                   np.array(stall_counter, i32).reshape(-1),
                   np.array(sigma_g_counter, i32).reshape(-1),
                   np.array(div_counter, i32).reshape(-1),
                   np.array(damping, np.float32).reshape(-1))


def init_mix_counters(S) -> MixCounters:
    z = np.zeros(S, np.int32)
    return MixCounters(np.zeros(S, bool), z, np.full(S, -np.inf), z, z, z,
                       np.ones(S, np.float32))


class MixEMResult(NamedTuple):
    """The outcome of one loop call. Single model: state in its (K, NB, B) /
    (NB, B) layout, hyperparameters float64 scalars and (K,), the rest
    scalars. Batch: (S, ...) throughout."""
    state: MixState
    hyper: MixHyper              # float64 numpy
    sigma_g: np.ndarray
    status: np.ndarray           # int32
    nit: np.ndarray              # int32, global iteration numbers
    elbo_hist: List[np.ndarray]  # [initial, iteration 1, ...]
    n_iter_total: int            # iterations this call ran
    final_elbo: np.ndarray
    mse_of: Optional[Callable[[], np.ndarray]]  # computes final_mse
    counters: MixCounters        # None for the single model
    act_hist: List[int]          # active blocks per iteration (-1: all)

    @property
    def final_mse(self):
        """The MSE of the final state with the final hyperparameters
        (float64; (S,) for the batch), computed when read (one statistics
        pass and one device read; a fit never reads it)."""
        return None if self.mse_of is None else self.mse_of()


def _mix_elbo(st, hyper, se_fixed, sigma_g, n_sample):
    """The mixture ELBO per lane (float64 numpy; viprs_tpu's _mix_elbo):
    ``st`` the lane-shaped statistics, ``hyper`` (S,) / (S, K)."""
    sig_e, tau_b, pi = hyper.sigma_eps, hyper.tau_beta, hyper.pi
    quad = (1.0 / sig_e) * (1.0 - 2.0 * st['sum_beta_eta'] + sigma_g)
    fit_term = np.where(se_fixed, quad, 1.0)
    # a negative sigma_eps gives a NaN objective, which the ladder reports
    with np.errstate(invalid='ignore'):
        e = 0.5 * n_sample * (-np.log(2.0 * np.pi * sig_e) - fit_term)
    e = e - (st['sum_g_logg'] - (st['sum_gamma_k'] * np.log(pi)).sum(-1))
    null_pi = np.maximum(1.0 - pi.sum(-1), 1e-12)
    e = e - (st['sum_ng_logng'] - st['sum_null_g'] * np.log(null_pi))
    e = e + 0.5 * ((st['sum_gamma_k'] * (1.0 + np.log(tau_b))).sum(-1)
                   - st['sum_g_logvt'].sum(-1))
    return e - 0.5 * (tau_b * st['sum_zeta_k']).sum(-1)


def read_stats(state, hy_dev, std_beta, n_per_snp, mask, S, K, *extra):
    """The lane-shaped sweep statistics ({name: (S,) or (S, K) float64}) and
    ``extra`` tensors (as one flat float64 array), in one device->host
    transfer."""
    st = cavi_mix.mix_stats(state, cavi_mix.mix_var_tau(n_per_snp, hy_dev),
                            std_beta, mask)
    host = torch.cat([*(st[k].reshape(-1) for k, _ in _STATS),
                      *(x.reshape(-1).to(F64) for x in extra)]).cpu().numpy()
    out, i = {}, 0
    for k, per_k in _STATS:
        n = S * K if per_k else S
        out[k] = host[i:i + n].reshape((S, K) if per_k else (S,))
        i += n
    return out, host[i:]


def reduce_stats(shard, st, S, K, med=None):
    """``read_stats``'s statistics (and (S,) max |d_eta|) of a rank's
    blocks over every block of the mesh (``ShardedLD.reduce``); unchanged
    when ``shard`` is None."""
    if shard is None:
        return st, med
    rows = [st[k].reshape(S, -1).T for k, _ in _STATS]
    sums, mx = shard.reduce(np.concatenate(rows),
                            None if med is None else np.reshape(med, (1, S)))
    out, i = {}, 0
    for (k, per_k), r in zip(_STATS, rows):
        n = len(r)
        out[k] = sums[i:i + n].T.reshape((S, K) if per_k else (S,))
        i += n
    return out, None if med is None else mx[0]


def _f32(x):
    """Float64 values rounded through float32 (the JAX loops hand float32
    hyperparameters to every sweep)."""
    return np.asarray(x, np.float32).astype(np.float64)


def _run(ld: BlockLD, state0, std_beta, n_per_snp, hyper0, fix, d_mult,
         n_sample, m_total, init_elbo, max_iter, min_iter, f_abs_tol,
         x_abs_tol, patience, use_skip, sigma_g0, batch, active0=None, i0=0,
         counters0=None, inner_steps=INNER_STEPS):
    """The loop shared by both entry points; ``batch`` switches on the lane
    masking and the damping ladder (and the lane sweeps K7/K8)."""
    dev = ld.device
    mask = ld.mask
    shard = ld if getattr(ld, 'mesh', None) is not None else None
    halo = None
    if shard is not None:
        ld, halo = shard.ld, shard.couple
    K = state0.gamma.shape[-3]
    S = state0.gamma.shape[0] if batch else 1
    f32 = np.float32
    d = _f32(d_mult).reshape(K)
    h = MixHyper(*(_f32(x) for x in (np.reshape(hyper0.sigma_eps, S),
                                     np.reshape(hyper0.tau_beta, (S, K)),
                                     np.reshape(hyper0.pi, (S, K)),
                                     np.reshape(hyper0.lambda_min, S))))
    fix_se, fix_tb, fix_pi = (np.broadcast_to(np.asarray(x, bool), S)
                              for x in fix[:3])
    total_pi = np.broadcast_to(np.asarray(fix.total_pi, np.float64), S)
    ctr = init_mix_counters(S) if counters0 is None else \
        MixCounters.from_numpy(*counters0)
    prev_dropped, osc, best, stall, sgc, divc, damping = ctr
    sigma_g = np.zeros(S) if sigma_g0 is None else \
        np.array(sigma_g0, np.float64).reshape(S)
    active = np.ones(S, bool) if active0 is None else \
        np.array(active0, bool).reshape(S)

    def dev_hyper(h, act_f):
        """The float32 device hyperparameters (and step scales) of ``h``."""
        hv = torch.from_numpy(np.concatenate(
            [h.sigma_eps, h.lambda_min, act_f, h.tau_beta.ravel(),
             h.pi.ravel()]).astype(f32)).to(dev)
        se, lam, act = hv[:S], hv[S:2 * S], hv[2 * S:3 * S]
        tau = hv[3 * S:3 * S + S * K].view(S, K)
        pi = hv[3 * S + S * K:].view(S, K)
        if batch:
            return MixHyper(se, tau, pi, lam), act
        return MixHyper(se[0], tau[0], pi[0], lam[0]), act

    def global_stats(st, med=None):
        return reduce_stats(shard, st, S, K, med)

    def objective(state, h, sigma_g):
        hy, _ = dev_hyper(h, np.ones(S, f32))
        st, _ = global_stats(read_stats(state, hy, std_beta, n_per_snp,
                                        mask, S, K)[0])
        return _mix_elbo(st, MixHyper(*(_f32(x) for x in h)), fix_se,
                         sigma_g, n_sample)

    state = state0
    prev_elbo = objective(state, h, sigma_g) if init_elbo is None else \
        np.array(init_elbo, np.float64).reshape(S)
    elbo_hist = [prev_elbo.copy()]
    act_hist = [-1]
    status = np.full(S, opt.RUNNING, np.int32)
    nit = np.zeros(S, np.int32)

    i = 0
    while i < max_iter and active.any():
        i += 1
        gi = i0 + i
        act_f = active.astype(f32) * damping
        hy, act_dev = dev_hyper(h, act_f)

        # ---- E-step ----
        n_act_blk = n_act_g = None
        if use_skip:
            if batch:
                pm = cavi_mix.mix_block_proposal_mask_batch(
                    ld, state, std_beta, n_per_snp, hy)
                blk = (pm & (act_dev > 0.0)[:, None]).any(dim=0)
            else:
                blk = cavi_mix.mix_block_proposal_mask(ld, state, std_beta,
                                                       n_per_snp, hy)
            if shard is None:
                n_act_blk = blk.sum()
            else:
                blk, n_act_g = shard.count_blocks(blk)
        if not batch and use_skip:
            state, eta_diff = cavi_sweep_mix_s1_skip(ld, state, std_beta,
                                                     n_per_snp, hy, blk,
                                                     inner_steps, halo)
        elif not batch:
            state, eta_diff = cavi_sweep_mix_s1(ld, state, std_beta,
                                                n_per_snp, hy, inner_steps,
                                                halo)
        elif use_skip:
            state, eta_diff = cavi_sweep_mix_s_skip(ld, state, std_beta,
                                                    n_per_snp, hy, act_dev,
                                                    blk, inner_steps, halo)
        else:
            state, eta_diff = cavi_sweep_mix_s(ld, state, std_beta,
                                               n_per_snp, hy, act_dev,
                                               inner_steps, halo)

        # ---- reductions with the e-step hyperparameters (one read) ----
        med_dev = (eta_diff.abs() * mask).reshape(S, -1).amax(dim=1)
        extra = (med_dev,) if n_act_blk is None else (med_dev, n_act_blk)
        st, ex = read_stats(state, hy, std_beta, n_per_snp, mask, S, K,
                             *extra)
        if shard is None:
            max_ed = ex[:S].astype(f32)
            act_hist.append(-1 if n_act_blk is None else int(ex[S]))
        else:
            st, med = global_stats(st, ex[:S])
            max_ed = med.astype(f32)
            act_hist.append(-1 if n_act_g is None else n_act_g)

        # ---- M-step (VIPRSMix.py:227-260), float64 ----
        frozen = ~active
        pi_est = st['sum_gamma_k']
        pi_renorm = total_pi[:, None] * pi_est \
            / pi_est.sum(axis=1, keepdims=True)
        pi_new = np.where(total_pi[:, None] > 0, pi_renorm, pi_est / m_total)
        pi = np.where((fix_pi | frozen)[:, None], h.pi, pi_new)
        tau_est = pi.sum(axis=1) * m_total / (st['sum_zeta_k'] @ d)
        tau_new = np.clip(d[None] * tau_est[:, None], 1.0, None)
        tau = np.where((fix_tb | frozen)[:, None], h.tau_beta, tau_new)
        sg = (1.0 + h.lambda_min) * st['sum_zeta_k'].sum(axis=1) \
            + st['sum_q_eta']
        se_new = 1.0 - 2.0 * st['sum_beta_eta'] + sg
        se = np.where(fix_se | frozen, h.sigma_eps, se_new)
        h = MixHyper(se, tau, pi, h.lambda_min)

        curr = _mix_elbo(st, h, fix_se, sg, n_sample)
        curr_mse = (1.0 - 2.0 * st['sum_beta_eta'] + sg
                    - st['sum_zeta_k'].sum(axis=1) + st['sum_eta_sq'])
        sg = np.where(active, sg, sigma_g)
        curr = np.where(active, curr, prev_elbo)
        h2 = sg / (sg + se)

        # ---- patience counters ----
        sigg = ((gi > min_iter) & (np.abs(sg - sigma_g) <= x_abs_tol)
                & (max_ed < f32(x_abs_tol * 10.0)))
        sgc = np.where(sigg, sgc + 1, 0)
        dropped = curr < prev_elbo
        div_cond = dropped & ~(np.abs(curr - prev_elbo)
                               <= 1e3 * f_abs_tol + 1e-4 * np.abs(prev_elbo))
        divc = np.where(div_cond, divc + 1, 0)
        if batch:
            # oscillation / stall damping ladder (mix_em_loop.py:454-476)
            osc = np.where(dropped & prev_dropped, osc + 1,
                           np.where(dropped, osc, 0))
            esc = active & (osc > 5) & (damping > f32(0.01))
            damping = np.where(esc, damping * f32(0.7), damping).astype(f32)
            osc = np.where(esc, 0, osc)
            improved = curr > best + f_abs_tol
            best = np.maximum(best, curr)
            stall = np.where(improved | ~active, 0, stall + 1)
            esc = active & (stall > 2 * patience) & (damping > f32(0.01))
            damping = np.where(esc, damping * f32(0.5), damping).astype(f32)
            stall = np.where(esc, 0, stall)

        # ---- the ladder (ordered) ----
        st_code = np.full(S, opt.RUNNING, np.int32)
        late = gi > min_iter
        for cond, code in (
                (curr_mse < 0.0, opt.MSE_NEGATIVE),
                (~np.isfinite(curr), opt.ELBO_NONFINITE),
                (se < 0.0, opt.SIGMA_EPS_NEGATIVE),
                ((h2 > 1.0) | (h2 < 0.0), opt.H2_OUT_OF_BOUNDS),
                (late & (np.abs(curr - prev_elbo) <= f_abs_tol),
                 opt.CONVERGED_F),
                (late & (max_ed < f32(x_abs_tol)), opt.CONVERGED_X),
                (sgc > patience, opt.CONVERGED_SIGMA_G),
                (divc > patience, opt.DIVERGED_ELBO)):
            st_code[(st_code == opt.RUNNING) & cond] = code

        newly = active & (st_code != opt.RUNNING)
        status = np.where(newly, st_code, status)
        nit = np.where(active, gi, nit).astype(np.int32)
        active = active & ~newly
        sigma_g = sg
        prev_elbo = curr
        prev_dropped = dropped
        elbo_hist.append(curr)

    status = np.where(active, opt.MAX_ITER, status).astype(np.int32)
    counters = MixCounters.from_numpy(prev_dropped, osc, best, stall, sgc,
                                      divc, damping) if batch else None

    def mse_of(state=state, h=h, sigma_g=sigma_g.copy()):
        st, _ = global_stats(read_stats(state, dev_hyper(h, np.ones(S, f32))[0],
                                        std_beta, n_per_snp, mask, S, K)[0])
        return (1.0 - 2.0 * st['sum_beta_eta'] + sigma_g
                - st['sum_zeta_k'].sum(axis=1) + st['sum_eta_sq'])

    return MixEMResult(state=state, hyper=h, sigma_g=sigma_g, status=status,
                       nit=nit, elbo_hist=elbo_hist, n_iter_total=i,
                       final_elbo=prev_elbo, mse_of=mse_of,
                       counters=counters, act_hist=act_hist)


def mix_em_fit(ld: BlockLD, state0: MixState, std_beta, n_per_snp,
               hyper0: MixHyper, fix: MixFix, d_mult, n_sample, m_total,
               init_elbo=None, max_iter: int = 1000, min_iter: int = 3,
               f_abs_tol: float = 1e-6, x_abs_tol: float = 1e-6,
               patience: int = 10, use_skip: bool = False,
               sigma_g0=None, inner_steps: int = INNER_STEPS) -> MixEMResult:
    """Mixture EM for one model until it terminates or ``max_iter``.

    :param state0: MixState, gamma/mu (K, NB, B), eta/q (NB, B) float32 on
        ``ld.device``.
    :param hyper0: scalars and (K,) array-likes (rounded through float32).
    :param fix: MixFix. :param d_mult: (K,) prior-variance multipliers.
    :param init_elbo: the objective of ``state0`` (None: computed here).
    :param use_skip: the activity-gated sweep (K6) every iteration; else
        the all-active sweep (K5).
    :param sigma_g0: sigma_g carry of a continued fit (None = 0).
    :param inner_steps: the sweeps' inner steps per tile (the plain
        versions take INNER_STEPS only).
    :returns: MixEMResult with scalar hyperparameters, sigma_g, status, nit
        and objectives.
    """
    res = _run(ld, state0, std_beta, n_per_snp, hyper0, fix, d_mult,
               n_sample, m_total, init_elbo, max_iter, min_iter, f_abs_tol,
               x_abs_tol, patience, use_skip, sigma_g0, batch=False,
               inner_steps=inner_steps)
    h = res.hyper
    return res._replace(
        hyper=MixHyper(h.sigma_eps[0], h.tau_beta[0], h.pi[0],
                       h.lambda_min[0]),
        sigma_g=res.sigma_g[0], status=res.status[0], nit=res.nit[0],
        elbo_hist=[e[0] for e in res.elbo_hist], final_elbo=res.final_elbo[0],
        mse_of=lambda: res.final_mse[0])


def mix_em_fit_batch(ld: BlockLD, state0: MixState, std_beta, n_per_snp,
                     hyper0: MixHyper, fix: MixFixBatch, d_mult, n_sample,
                     m_total, max_iter: int = 1000, min_iter: int = 3,
                     f_abs_tol: float = 1e-6, x_abs_tol: float = 1e-6,
                     patience: int = 10, active0=None, sigma_g0=None, i0=0,
                     counters0: MixCounters = None, init_elbo=None,
                     use_skip: bool = False,
                     inner_steps: int = INNER_STEPS) -> MixEMResult:
    """Mixture EM for S lanes with finished-lane masking and the damping
    ladder, until every lane terminates or ``max_iter`` iterations.

    :param state0: MixState, gamma/mu (S, K, NB, B), eta/q (S, NB, B).
    :param hyper0: (S,) / (S, K) array-likes (rounded through float32).
    :param fix: MixFixBatch. :param d_mult: (K,), shared by the lanes.
    :param active0: (S,) bool, lanes to optimize (None: all); the others
        stay frozen bit-exactly.
    :param sigma_g0, i0, counters0, init_elbo: the chunk carry (sigma_g,
        global iteration offset, ladder counters, objective of ``state0``;
        None: zeros, fresh, computed here).
    :param use_skip: the union-gated sweep (K8); else all blocks (K7).
    :param inner_steps: the sweeps' inner steps per tile (the plain
        versions take INNER_STEPS only).
    :returns: MixEMResult of (S,) arrays (``status == MAX_ITER``: the lane
        ran out of THIS call's budget).
    """
    return _run(ld, state0, std_beta, n_per_snp, hyper0, fix, d_mult,
                n_sample, m_total, init_elbo, max_iter, min_iter, f_abs_tol,
                x_abs_tol, patience, use_skip, sigma_g0, batch=True,
                active0=active0, i0=i0, counters0=counters0,
                inner_steps=inner_steps)
