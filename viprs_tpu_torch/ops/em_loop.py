"""The variational EM loop for S model lanes, as a host loop.

Counterpart of viprs_tpu.ops.em_loop.em_fit. Each iteration runs on the
device [activity mask -> sweep -> statistics] and reads back ONE small
float64 vector (the (S,) sweep statistics, the (S,) max |d_eta| and the
active-block count); the M-step, ELBO and the convergence ladder then run on
the host over (S,) numpy arrays in float64, with the float32 roundings of the
JAX loop kept where they decide a comparison (max |d_eta| and damping are
float32 there). Lanes that are not active keep their state, hyperparameters,
sigma_g and objective, exactly as the JAX loop's ``jnp.where`` does.

The sweep per iteration (``model/_dispatch.py`` picks the rule):

- S = 1, hybrid: the proposal mask when at most ``int(HYBRID_FRAC * NB)``
  blocks are active (the skip branch), all ones otherwise, handed to the one
  S = 1 kernel pair (ops/cavi_cuda.cavi_sweep_s1_skip): the branch is chosen
  on the device;
- S = 1, skip: the proposal mask at the machine-precision gate;
- S > 1, skip: the union over live lanes of the proposal masks (K4);
- otherwise every block (K1 at S = 1, K3 at S > 1).

A fit split into chunks (lane compaction in model/viprs.py) carries the
objective (``init_elbo``), the active lanes, the global iteration offset
``i0``, the ladder's counters (``EMCounters``) and ``sigma_g`` across calls,
so a chunked run takes the single call's path.

On a shard of a mesh (``ld`` a ``parallel.mesh.ShardedLD``) the loop runs
the same sweeps on the rank's blocks, the coupling pass after the halo
exchange (``ShardedLD.couple``), and makes its one host vector global
before the M-step: sums and maxima over the ranks of the blocks group
(``ShardedLD.reduce``), then the lanes of the grid group where the lanes
are split (``lanes``). The skip rules' block masks are made global before
the sweep (``ShardedLD.count_blocks``): the hybrid gate compares the count
of every rank's proposed blocks with ``HYBRID_FRAC`` of the unpadded NB,
and K4's union spans the lanes of every rank. Every rank then runs the
same host M-step and ladder and takes the same decisions.
"""

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from . import updates
from .block_ld import BlockLD
from .cavi_cuda import (block_proposal_mask, cavi_sweep_s, cavi_sweep_s1,
                        cavi_sweep_s1_skip, cavi_sweep_s_skip)
from .cavi_torch import (CaviState, ETA_DIFF_EPS, INNER_STEPS, Hyper,
                         union_block_mask)
from ..utils import optimize as opt

F32 = torch.float32
F64 = torch.float64

#: Active-block fraction at or below which an iteration takes the skip
#: branch (the JAX package's measured policy value).
HYBRID_FRAC = 0.35


class EMCounters(NamedTuple):
    """The convergence-ladder state that survives across chunked ``em_fit``
    calls, (S,) numpy each."""
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
        package's ``EMCounters``), as fresh arrays of the ladder's dtypes."""
        i32 = np.int32
        return cls(np.array(prev_dropped, bool).reshape(-1),
                   np.array(osc_counter, i32).reshape(-1),
                   np.array(best_elbo, np.float64).reshape(-1),
                   np.array(stall_counter, i32).reshape(-1),
                   np.array(sigma_g_counter, i32).reshape(-1),
                   np.array(div_counter, i32).reshape(-1),
                   np.array(damping, np.float32).reshape(-1))


def init_counters(S) -> EMCounters:
    z = np.zeros(S, np.int32)
    return EMCounters(np.zeros(S, bool), z, np.full(S, -np.inf), z, z, z,
                      np.ones(S, np.float32))


class EMResult(NamedTuple):
    state: CaviState
    hyper: Hyper                 # (S,) float64 numpy
    sigma_g: np.ndarray          # (S,) float64
    status: np.ndarray           # (S,) int32
    nit: np.ndarray              # (S,) int32, global iteration numbers
    elbo_hist: List[np.ndarray]  # [initial, iteration 1, ...], (S,) each
    n_iter_total: int            # iterations this call ran
    final_elbo: np.ndarray       # (S,) float64
    mse_of: Optional[Callable[[], np.ndarray]]  # computes final_mse
    counters: EMCounters
    max_eta_diff: np.ndarray     # (S,) float32
    restarts_used: np.ndarray    # (S,) int32
    act_hist: List[int]          # active blocks per iteration (-1: not measured)
    n_skip: int                  # iterations that took the hybrid's skip branch

    @property
    def final_mse(self):
        """(S,) float64: the MSE of the final state with the final
        hyperparameters, computed when read (one statistics pass and one
        device read; a fit never reads it). None without a state."""
        return None if self.mse_of is None else self.mse_of()


def read_stats(state, n_per_snp, std_beta, mask, h_dev, *extra):
    """(S,) sweep statistics (+ extra tensors) read to the host in one
    transfer; returns (SweepStats of CPU float64 tensors, extra as one flat
    float64 tensor)."""
    var_tau = updates.compute_var_tau(n_per_snp, h_dev)
    st = updates.collect_stats(state, var_tau, std_beta, mask)
    host = torch.cat([*st, *(x.reshape(-1).to(F64) for x in extra)]).cpu()
    S = st[0].shape[0]
    n = len(st) * S
    return updates.SweepStats(*host[:n].reshape(len(st), S)), host[n:]


def _shard_sweep(shard, state, std_beta, n_per_snp, h_dev, act_dev, act_f,
                 S, use_skip, use_hybrid, gate_eps, thresh, split, has_lanes,
                 inner_steps):
    """The E-step of ``em_fit`` on a shard: the unsharded rule's kernels on
    the rank's blocks, the block masks made global before the sweep and
    the halo before the coupling pass. A rank holding no lane (its grid
    group's lanes all compacted away) sweeps nothing; the ranks it would
    exchange with hold the same lanes. Returns (state, eta_diff, global
    count of flagged blocks, -1 where the rule has no mask)."""
    ld = shard.ld
    halo = shard.couple
    if S == 1 and (use_hybrid or use_skip):
        eps = gate_eps if use_hybrid else ETA_DIFF_EPS
        blk = block_proposal_mask(ld, state, std_beta, n_per_snp, h_dev,
                                  eps=eps)[0] & bool(act_f[0] > 0.0)
        blk_mask, n_act = shard.count_blocks(blk)
        if use_hybrid and n_act > thresh:
            blk_mask = torch.ones_like(blk_mask)
        return (*cavi_sweep_s1_skip(ld, state, std_beta, n_per_snp, h_dev,
                                    act_dev, blk_mask, inner_steps, halo),
                n_act)
    if S == 1:
        return (*cavi_sweep_s1(ld, state, std_beta, n_per_snp, h_dev,
                               act_dev, inner_steps, halo), -1)
    n_act = -1
    if use_skip:
        blk = union_block_mask(
            block_proposal_mask(ld, state, std_beta, n_per_snp, h_dev),
            act_dev)
        blk_mask, n_act = shard.count_blocks(blk, split)
    if not has_lanes:
        return state, torch.zeros_like(state.eta), n_act
    if use_skip:
        return (*cavi_sweep_s_skip(ld, state, std_beta, n_per_snp, h_dev,
                                   act_dev, blk_mask, inner_steps, halo),
                n_act)
    return (*cavi_sweep_s(ld, state, std_beta, n_per_snp, h_dev, act_dev,
                          inner_steps, halo), n_act)


def _hyper_f64(values, S):
    """(S,) float64 CPU tensor of values rounded through float32, as the
    JAX driver hands hyperparameters to each em_fit call."""
    v = np.asarray(values, np.float32).astype(np.float64)
    return torch.from_numpy(np.array(np.broadcast_to(v.reshape(-1), (S,))))


def em_fit(ld: BlockLD, state0: CaviState, std_beta, n_per_snp, hyper0,
           fix, n_sample, m_total, init_elbo=None, active0=None,
           max_iter: int = 1000, min_iter: int = 3, f_abs_tol: float = 1e-6,
           x_abs_tol: float = 1e-6, patience: int = 10,
           use_skip: bool = False, use_hybrid: bool = False,
           hybrid_eps: float = None, i0: int = 0, counters0=None,
           sigma_g0=None, max_restarts: int = 0, restart_hyper=None,
           restart_logit=None, inner_steps: int = INNER_STEPS,
           lanes=None) -> EMResult:
    """Run EM until every lane terminates or ``max_iter`` iterations.

    :param ld: a BlockLD, or a ShardedLD (a rank's shard of a mesh; the
        tensors are then the rank's blocks).
    :param state0: CaviState of (S, NB, B) float32 on ``ld.device`` (on a
        shard whose lanes are split, the rank's ``lanes`` only).
    :param hyper0: (sigma_eps, tau_beta, pi, lambda_min), each (S,)
        array-like (a Hyper); rounded through float32.
    :param fix: (sigma_eps, tau_beta, pi) per-lane bools (a FixMask).
    :param init_elbo: (S,) objective of ``state0`` (None: computed here).
    :param active0: (S,) bool, lanes to optimize (None: all); others stay
        frozen.
    :param use_skip, use_hybrid: the sweep rule (module docstring); the
        hybrid is the S = 1 rule.
    :param hybrid_eps: gate epsilon of the hybrid's proposal mask (default
        ``x_abs_tol``).
    :param i0: global iteration offset (min_iter and nit count from the
        start of the whole fit); :param counters0: EMCounters carry (None =
        fresh); :param sigma_g0: (S,) sigma_g carry (None = zeros).
    :param max_restarts: in-loop restart-on-negative-MSE budget per lane: a
        lane is re-initialized from ``restart_logit`` (float32 logit of the
        restart pi), its hyperparameters from ``restart_hyper`` (three
        values or (S,) arrays: sigma_eps, tau_beta, pi; rounded through
        float32), sigma_eps is fixed from then on and its counters reset.
    :param inner_steps: the sweeps' inner steps per tile (the plain
        versions take INNER_STEPS only).
    :param lanes: on a shard whose grid axis splits the lanes, the indices
        (into the S lanes of ``hyper0``) of the lanes this rank holds, in
        the order of ``state0``'s rows (it may hold none); None: all.
    :returns: EMResult (``status == MAX_ITER`` means the lane ran out of
        THIS call's budget: a chunked driver continues it; on a shard the
        state is the rank's part).
    """
    shard = ld if getattr(ld, 'mesh', None) is not None else None
    S = len(np.atleast_1d(hyper0[0])) if shard is not None \
        else state0.eta.shape[0]
    if use_hybrid and S != 1:
        raise ValueError(f"the hybrid rule is the S == 1 dispatch; got S={S}")
    dev = ld.device
    mask = ld.mask
    if shard is None:
        nb = ld.nb
        own = slice(None)
    else:
        nb = shard.nb_total
        ld = shard.ld
        own = slice(None) if lanes is None else np.asarray(lanes, np.int64)
        layout = None if lanes is None else shard.mesh.lane_layout(own)
    has_lanes = state0.eta.shape[0] > 0
    thresh = int(HYBRID_FRAC * nb)
    gate_eps = x_abs_tol if hybrid_eps is None else hybrid_eps
    fix = updates.FixMask.from_numpy(*fix)
    hyper = Hyper(*(_hyper_f64(x, S) for x in hyper0))
    ctr = init_counters(S) if counters0 is None else \
        EMCounters.from_numpy(*counters0)
    prev_dropped, osc, best, stall, sgc, divc, damping = ctr
    sigma_g = np.zeros(S) if sigma_g0 is None else \
        np.array(sigma_g0, np.float64).reshape(S)
    active = np.ones(S, bool) if active0 is None else \
        np.array(active0, bool).reshape(S)
    fix_se = fix.sigma_eps.numpy().copy()
    restarts_left = np.full(S, max_restarts, np.int32)
    ones_blk = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    f32 = np.float32

    def global_stats(st, maxes=()):
        """The rank's statistics (and per-lane maxima) over every block
        and lane of the mesh; unchanged off a mesh."""
        if shard is None:
            return st, maxes
        sums, mx = shard.reduce(np.stack([x.numpy() for x in st]),
                                np.stack(maxes) if len(maxes) else None,
                                layout, S)
        return updates.SweepStats(*(torch.from_numpy(r) for r in sums)), \
            list(mx)

    def objective(state, hyper, fix_se, sigma_g):
        h32 = Hyper(*(x.to(F32) for x in hyper))
        st, _ = read_stats(state, n_per_snp, std_beta, mask,
                            Hyper(*(x[own].to(dev) for x in h32)))
        st, _ = global_stats(st)
        return updates.elbo(st, h32, torch.from_numpy(fix_se),
                            torch.from_numpy(sigma_g), n_sample,
                            m_total).numpy()

    state = state0
    prev_elbo = objective(state, hyper, fix_se, sigma_g) if init_elbo is None \
        else np.array(init_elbo, np.float64).reshape(S)
    elbo_hist = [prev_elbo.copy()]
    act_hist = [-1]
    status = np.full(S, opt.RUNNING, np.int32)
    nit = np.zeros(S, np.int32)
    max_ed_c = np.zeros(S, f32)
    n_skip = 0

    i = 0
    while i < max_iter and active.any():
        i += 1
        gi = i0 + i
        act_f = active.astype(f32) * damping
        hv = torch.from_numpy(np.stack(
            [hyper.sigma_eps.numpy(), hyper.tau_beta.numpy(), hyper.pi.numpy(),
             act_f, hyper.lambda_min.numpy()]).astype(f32)[:, own]).to(dev)
        h_dev = Hyper(hv[0], hv[1], hv[2], hv[4])
        act_dev = hv[3]

        # ---- E-step ----
        n_act_blk = None
        if shard is not None:
            state, eta_diff, n_act_g = _shard_sweep(
                shard, state, std_beta, n_per_snp, h_dev, act_dev, act_f, S,
                use_skip, use_hybrid, gate_eps, thresh, lanes is not None,
                has_lanes, inner_steps)
        elif S == 1 and (use_hybrid or use_skip):
            eps = gate_eps if use_hybrid else ETA_DIFF_EPS
            blk = block_proposal_mask(ld, state, std_beta, n_per_snp, h_dev,
                                      eps=eps)[0] & bool(act_f[0] > 0.0)
            n_act_blk = blk.sum()
            blk_mask = blk.to(torch.int32)
            if use_hybrid:
                blk_mask = torch.where(n_act_blk <= thresh, blk_mask, ones_blk)
            state, eta_diff = cavi_sweep_s1_skip(ld, state, std_beta,
                                                 n_per_snp, h_dev, act_dev,
                                                 blk_mask, inner_steps)
        elif S == 1:
            state, eta_diff = cavi_sweep_s1_skip(ld, state, std_beta,
                                                 n_per_snp, h_dev, act_dev,
                                                 ones_blk, inner_steps)
        elif use_skip:
            blk = union_block_mask(
                block_proposal_mask(ld, state, std_beta, n_per_snp, h_dev),
                act_dev)
            n_act_blk = blk.sum()
            state, eta_diff = cavi_sweep_s_skip(ld, state, std_beta,
                                                n_per_snp, h_dev, act_dev, blk,
                                                inner_steps)
        else:
            state, eta_diff = cavi_sweep_s(ld, state, std_beta, n_per_snp,
                                           h_dev, act_dev, inner_steps)

        # ---- reductions with the e-step hyperparameters (one read) ----
        med_dev = (eta_diff.abs() * mask[None]).amax(dim=(1, 2))
        extra_dev = (med_dev,) if n_act_blk is None else (med_dev, n_act_blk)
        stats, extra = read_stats(state, n_per_snp, std_beta, mask, h_dev,
                                   *extra_dev)
        if shard is None:
            max_ed = extra[:S].numpy().astype(f32)
            n_act = -1 if n_act_blk is None else int(extra[S])
        else:
            stats, (med,) = global_stats(stats, [extra.numpy()])
            max_ed = med.astype(f32)
            n_act = n_act_g
        if use_hybrid and n_act <= thresh:
            n_skip += 1

        # ---- M-step and objectives (host, float64) ----
        fix_cur = fix._replace(sigma_eps=torch.from_numpy(fix_se.copy()))
        new_hyper, sg = updates.m_step(stats, hyper, fix_cur, m_total,
                                       torch.from_numpy(active.copy()))
        sg = np.where(active, sg.numpy(), sigma_g)
        sg_t = torch.from_numpy(sg)
        curr = updates.elbo(stats, new_hyper, fix_cur.sigma_eps, sg_t,
                            n_sample, m_total).numpy()
        curr = np.where(active, curr, prev_elbo)
        curr_mse = updates.mse(stats, sg_t).numpy()
        h2 = updates.heritability(sg_t, new_hyper.sigma_eps).numpy()
        max_ed = np.where(active, max_ed, max_ed_c)
        hyper = new_hyper

        # ---- patience counters ----
        sigg = ((gi > min_iter) & (np.abs(sg - sigma_g) <= x_abs_tol)
                & (max_ed < f32(x_abs_tol * 10.0)))
        sgc = np.where(sigg, sgc + 1, 0)
        dropped = curr < prev_elbo
        div_cond = dropped & ~(np.abs(curr - prev_elbo)
                               <= 1e3 * f_abs_tol + 1e-4 * np.abs(prev_elbo))
        divc = np.where(div_cond, divc + 1, 0)
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
        st = np.full(S, opt.RUNNING, np.int32)
        late = gi > min_iter
        for cond, code in (
                (curr_mse < 0.0, opt.MSE_NEGATIVE),
                (~np.isfinite(curr), opt.ELBO_NONFINITE),
                (hyper.sigma_eps.numpy() < 0.0, opt.SIGMA_EPS_NEGATIVE),
                ((h2 > 1.0) | (h2 < 0.0), opt.H2_OUT_OF_BOUNDS),
                (late & (np.abs(curr - prev_elbo) <= f_abs_tol),
                 opt.CONVERGED_F),
                (late & (max_ed < f32(x_abs_tol)), opt.CONVERGED_X),
                (sgc > patience, opt.CONVERGED_SIGMA_G),
                (divc > patience, opt.DIVERGED_ELBO)):
            st[(st == opt.RUNNING) & cond] = code

        # ---- in-loop restart on negative MSE (reference behavior) ----
        prev_out = curr
        if max_restarts > 0:
            fire = (active & (st == opt.MSE_NEGATIVE) & (restarts_left > 0)
                    & ~fix_se & (i < max_iter))
            if fire.any():
                st[fire] = opt.RUNNING
                f3 = torch.from_numpy(fire[own]).to(dev)[:, None, None]
                rl = torch.from_numpy(np.array(np.broadcast_to(
                    np.float32(restart_logit), (S,)))[own]).to(dev)[
                        :, None, None]
                zero = torch.zeros((), dtype=F32, device=dev)
                state = CaviState(logits=torch.where(f3, rl, state.logits),
                                  mu=torch.where(f3, zero, state.mu),
                                  eta=torch.where(f3, zero, state.eta),
                                  q=torch.where(f3, zero, state.q))
                fire_t = torch.from_numpy(fire)
                hyper = Hyper(*(torch.where(fire_t, _hyper_f64(r, S), h)
                                for r, h in zip(restart_hyper[:3], hyper)),
                              lambda_min=hyper.lambda_min)
                sg = np.where(fire, 0.0, sg)
                fix_se = fix_se | fire
                prev_out = np.where(fire, objective(state, hyper, fix_se, sg),
                                    curr)
                fresh = init_counters(S)
                dropped = np.where(fire, fresh.prev_dropped, dropped)
                osc, best, stall, sgc, divc, damping = (
                    np.where(fire, f, c) for f, c in zip(
                        fresh[1:], (osc, best, stall, sgc, divc, damping)))
                damping = damping.astype(f32)
                restarts_left = restarts_left - fire

        newly = active & (st != opt.RUNNING)
        status = np.where(newly, st, status)
        nit = np.where(active, gi, nit).astype(np.int32)
        active = active & ~newly
        sigma_g = sg
        prev_elbo = prev_out
        prev_dropped = dropped
        max_ed_c = max_ed
        elbo_hist.append(curr)
        act_hist.append(n_act)

    status = np.where(active, opt.MAX_ITER, status).astype(np.int32)

    def mse_of(state=state, hyper=hyper, sigma_g=sigma_g.copy()):
        h32 = Hyper(*(x.to(F32)[own].to(dev) for x in hyper))
        st, _ = global_stats(read_stats(state, n_per_snp, std_beta, mask,
                                        h32)[0])
        return updates.mse(st, torch.from_numpy(sigma_g)).numpy()

    return EMResult(
        state=state, hyper=Hyper(*(x.numpy() for x in hyper)),
        sigma_g=sigma_g, status=status, nit=nit, elbo_hist=elbo_hist,
        n_iter_total=i, final_elbo=prev_elbo, mse_of=mse_of,
        counters=EMCounters.from_numpy(prev_dropped, osc, best, stall, sgc,
                                       divc, damping),
        max_eta_diff=max_ed_c,
        restarts_used=np.full(S, max_restarts, np.int32) - restarts_left,
        act_hist=act_hist, n_skip=n_skip)
