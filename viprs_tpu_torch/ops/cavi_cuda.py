"""The sweeps on the card: wrappers of the CUDA kernels in ``csrc/``
(counterpart of viprs_tpu.ops.cavi_pallas).

Single model (S = 1), ``csrc/cavi_s1.cu``; two kernels carry both branches
of the hybrid EM iteration:

- ``block_sweep_s1`` launches ``cavi_block_sweep_s1``: the tile-Gauss-Seidel
  sweep of every LD block flagged in a per-block mask (one CTA per block; an
  unflagged block passes through bit-exactly with a zero eta change; its
  rank-T updates skip the zero 32 x 32 blocks that ``BlockLD.diag_nz``
  leaves unflagged);
- ``coupling_pass_s1_inplace`` launches ``coupling_pass_s1``: the coupling
  tiles incident to a flagged block, applied in place to q from the sweep's
  eta change (one CTA per block's slab of 128 coordinates that a coupling
  tile can change, ``BlockLD.cpl_slabs``, reading only the 32 x 32 blocks
  ``BlockLD.off_nz`` flags); ``coupling_pass_s1`` runs it on a clone.

``cavi_sweep_s1`` (TPU kernel K1, all blocks flagged) and
``cavi_sweep_s1_skip`` (K2, the activity mask) are the two compositions;
they apply the coupling tiles in place on the q their block sweep has just
written.

Model grid (S lanes), ``csrc/cavi_s.cu``: ``block_sweep_s`` launches
``cavi_block_sweep_s`` (one CTA per lane tile of 4, 8, 16 or 20 lanes,
picked by ``sweep_lane_tile``, and block; its rank-T updates skip the zero
32 x 32 blocks that ``BlockLD.diag_nz`` leaves unflagged) and
``coupling_pass_s_inplace`` launches ``coupling_pass_s`` (one CTA per
block's slab of 128 coordinates that a coupling tile can change, and lane
tile), which updates q in place; ``coupling_pass_s`` runs it on a clone.
``cavi_sweep_s`` (K3, all blocks flagged) and ``cavi_sweep_s_skip`` (K4,
the union of the live lanes' activity masks) are their compositions, and
apply the coupling tiles in place on the q their block sweep has just
written. A lane with active == 0 passes through bit-exactly.

Mixture prior (VIPRSMix), ``csrc/cavi_mix.cu``: ``block_sweep_mix`` launches
``cavi_block_sweep_mix_s1`` (single model, one CTA per block) or
``cavi_block_sweep_mix_s`` (S lanes, one CTA per lane tile of 4, 8 or 20
lanes, picked by ``mix_sweep_lane_tile``, and block); the rank-T updates of
both skip the zero 32 x 32 blocks, as ``block_sweep_s`` does. The coupling
tiles after them are the passes above, in place. ``cavi_sweep_mix_s1`` (K5,
all blocks), ``cavi_sweep_mix_s1_skip`` (K6, the activity mask),
``cavi_sweep_mix_s`` (K7) and ``cavi_sweep_mix_s_skip`` (K8, the union mask)
are the compositions, each counted under its own name.

Every kernel has an instance for int8 LD tiles and one for float32
(dequantized) tiles; the wrappers launch the one that matches
``ld.diag.dtype`` (``diag`` and ``off_data`` share it; any other dtype
raises before anything is built or launched), and count the float32
instances under their names with ``_f32`` appended.

Each kernel wrapper takes the plain version in ops/cavi_torch.py for CPU
tensors, and for CUDA tensors launches its kernel or raises: there is no
fallback. ``LAUNCHES`` counts kernel launches (never plain-version calls).
"""

import numpy as np
import torch

from . import cavi_mix, cavi_torch
from .block_ld import BlockLD
from .cavi_mix import MixHyper, MixState
from .cavi_torch import CaviState, Hyper, ETA_DIFF_EPS, INNER_STEPS, TILE

F32 = torch.float32

#: Kernel launches per kernel name since the last ``reset_launches()``.
LAUNCHES = {'cavi_block_sweep_s1': 0, 'coupling_pass_s1': 0,
            'cavi_block_sweep_s1_f32': 0, 'coupling_pass_s1_f32': 0,
            'cavi_block_sweep_s': 0, 'coupling_pass_s': 0,
            'cavi_block_sweep_s_f32': 0, 'coupling_pass_s_f32': 0,
            'cavi_sweep_mix_s1': 0, 'cavi_sweep_mix_s1_skip': 0,
            'cavi_sweep_mix_s1_f32': 0, 'cavi_sweep_mix_s1_skip_f32': 0,
            'cavi_sweep_mix_s': 0, 'cavi_sweep_mix_s_skip': 0,
            'cavi_sweep_mix_s_f32': 0, 'cavi_sweep_mix_s_skip_f32': 0}

#: The LD tile types of the kernels, and the suffix of each instance's
#: launcher and LAUNCHES names.
_TILE_SUFFIX = {torch.int8: '', torch.float32: '_f32'}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(err, kernel):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _tiles(ld: BlockLD):
    """The suffix of the kernel instance for the LD's tiles
    (``_TILE_SUFFIX``): int8 or float32, ``diag`` and ``off_data`` alike;
    any other dtype raises."""
    if ld.diag.dtype not in _TILE_SUFFIX:
        raise ValueError(f"the CUDA kernels take int8 or float32 LD tiles, "
                         f"not {ld.diag.dtype}")
    if ld.off_data.dtype != ld.diag.dtype:
        raise ValueError(f"diag ({ld.diag.dtype}) and off_data "
                         f"({ld.off_data.dtype}) must share one dtype")
    return _TILE_SUFFIX[ld.diag.dtype]


def _check_coupling_ld(ld: BlockLD):
    """The coupling tiles and their launch plan as the coupling kernels
    take them: int8 or float32 tiles (``diag``'s type), int32 ends and
    incidence lists, the uint8 32 x 32 flags ``off_nz`` and the int32 slab
    list ``cpl_slabs``."""
    dev, nb, B = ld.device, ld.nb, ld.block_size
    _check('off_data', ld.off_data, ld.diag.dtype, (ld.n_off, B, B), dev)
    for name, x in (('off_src', ld.off_src), ('off_dst', ld.off_dst)):
        _check(name, x, torch.int32, (ld.n_off,), dev)
    _check('inc_ptr', ld.inc_ptr, torch.int32, (nb + 1,), dev)
    _check('inc_tile', ld.inc_tile, torch.int32, (2 * ld.n_off,), dev)
    _check('off_nz', ld.off_nz, torch.uint8, (ld.n_off, B // 32, B // 32),
           dev)
    _check('cpl_slabs', ld.cpl_slabs, torch.int32,
           (ld.cpl_slabs.numel(),), dev)


def _all_blocks(ld: BlockLD):
    return torch.ones(ld.nb, dtype=torch.int32, device=ld.device)


def _hyper_rows(hyper: Hyper, active, device):
    """(5, S) float32 rows [sigma_eps, tau_beta, pi, active, lambda_min]."""
    return torch.stack([hyper.sigma_eps, hyper.tau_beta, hyper.pi, active,
                        hyper.lambda_min]).to(device=device,
                                              dtype=F32).contiguous()


def block_sweep_s1(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                   hyper: Hyper, active, blk_mask, inner_steps=INNER_STEPS):
    """Sweep the blocks flagged in ``blk_mask`` ((NB,) int32) at S = 1.

    :param state: CaviState of (1, NB, B) float32.
    :param hyper: (1,) hyperparameters; :param active: (1,) float32 step
        scale (0 freezes the model).
    :param inner_steps: the kernel's inner steps per tile (a timing probe
        takes fewer; the plain version runs INNER_STEPS only).
    :returns: (new_state, eta_diff), coupling tiles not applied. The
        kernel's rank-T updates read ``ld.diag_nz`` (they skip the zero
        32 x 32 blocks).
    """
    if state.eta.device.type == 'cpu':
        if inner_steps != INNER_STEPS:
            raise ValueError(f"the plain sweep takes {INNER_STEPS} inner "
                             f"steps, not {inner_steps}")
        return cavi_torch.block_sweep(ld, state, std_beta, n_per_snp, hyper,
                                      active, blk_mask=blk_mask)
    kernel = 'cavi_block_sweep_s1' + _tiles(ld)
    from ._build import build
    lib, _ = build()
    dev = ld.device
    nb, B = ld.nb, ld.block_size
    if B % TILE:
        raise ValueError(f"block size {B} is not a multiple of {TILE}")
    _check('diag', ld.diag, ld.diag.dtype, (nb, B, B), dev)
    _check('diag_nz', ld.diag_nz, torch.uint8, (nb, B // 32, B // 32), dev)
    for name, x in (('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask)):
        _check(name, x, F32, (nb, B), dev)
    for name, x in zip(CaviState._fields, state):
        _check(name, x, F32, (1, nb, B), dev)
    _check('blk_mask', blk_mask, torch.int32, (nb,), dev)
    hv = _hyper_rows(hyper, active, dev)
    _check('hyper', hv, F32, (5, 1), dev)
    for name, x in (('diag', ld.diag), ('diag_nz', ld.diag_nz),
                    ('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask), *zip(CaviState._fields, state)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = CaviState(*(torch.empty_like(x) for x in state))
    eta_diff = torch.empty_like(state.eta)
    err = getattr(lib, kernel + '_launch')(
        ld.diag.data_ptr(), ld.diag_nz.data_ptr(), std_beta.data_ptr(),
        n_per_snp.data_ptr(), ld.mask.data_ptr(),
        *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
        eta_diff.data_ptr(), blk_mask.data_ptr(), hv.data_ptr(), nb, B,
        float(np.float32(ld.scale)), int(inner_steps),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return out, eta_diff


def coupling_pass_s1_inplace(ld: BlockLD, q, eta_diff, blk_mask):
    """``q += `` the coupling tiles incident to a block flagged in
    ``blk_mask`` ((NB,) int32), applied to ``eta_diff``, at S = 1, in place
    on the card: one launch of ``coupling_pass_s1``, a CTA for each (block,
    slab of 128 coordinates) of ``ld.cpl_slabs``, reading only the 32 x 32
    blocks of a tile that ``ld.off_nz`` flags. q of every other slab is not
    touched. q, eta_diff: (1, NB, B) float32 CUDA tensors. Returns q."""
    if ld.n_off == 0:
        return q
    if q.device.type == 'cpu':
        raise ValueError("coupling_pass_s1_inplace runs on the card; "
                         "coupling_pass_s1 takes CPU tensors")
    kernel = 'coupling_pass_s1' + _tiles(ld)
    from ._build import build
    lib, _ = build()
    dev = ld.device
    nb, B = ld.nb, ld.block_size
    _check_coupling_ld(ld)
    slabs = ld.cpl_slabs
    _check('blk_mask', blk_mask, torch.int32, (nb,), dev)
    _check('q', q, F32, (1, nb, B), dev)
    _check('eta_diff', eta_diff, F32, (1, nb, B), dev)
    for name, x in (('off_data', ld.off_data), ('eta_diff', eta_diff)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    err = getattr(lib, kernel + '_launch')(
        ld.off_data.data_ptr(), ld.off_src.data_ptr(), ld.off_dst.data_ptr(),
        ld.inc_ptr.data_ptr(), ld.inc_tile.data_ptr(), blk_mask.data_ptr(),
        ld.off_nz.data_ptr(), slabs.data_ptr(), eta_diff.data_ptr(),
        q.data_ptr(), slabs.numel(), nb, B, float(np.float32(ld.scale)),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return q


def coupling_pass_s1(ld: BlockLD, q, eta_diff, blk_mask):
    """q plus the coupling tiles incident to a block flagged in
    ``blk_mask`` ((NB,) int32), applied to ``eta_diff``. q, eta_diff:
    (1, NB, B) float32. Returns a new q and never writes the given one (on
    the card the kernel runs in place on a clone; q itself when there is no
    coupling tile)."""
    if ld.n_off == 0:
        return q
    if q.device.type == 'cpu':
        return cavi_torch.coupling_pass(ld, q, eta_diff, blk_mask)
    return coupling_pass_s1_inplace(ld, q.clone(), eta_diff, blk_mask)


def _couple_s1(ld: BlockLD, q, eta_diff, blk_mask):
    """The coupling tiles after a single-model block sweep: in place on the
    q the sweep kernel has just written (a fresh tensor) on the card, the
    plain version on the CPU."""
    if q.device.type == 'cpu':
        return coupling_pass_s1(ld, q, eta_diff, blk_mask)
    return coupling_pass_s1_inplace(ld, q, eta_diff, blk_mask)


def cavi_sweep_s1(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                  hyper: Hyper, active):
    """The all-active S = 1 sweep (replaces cavi_pallas.cavi_sweep_pallas_s1;
    same contract as cavi_torch.cavi_sweep at S = 1)."""
    return cavi_sweep_s1_skip(ld, state, std_beta, n_per_snp, hyper, active,
                              _all_blocks(ld))


def cavi_sweep_s1_skip(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                       hyper: Hyper, active, blk_mask):
    """The S = 1 sweep over the blocks flagged in ``blk_mask`` ((NB,) bool or
    int; replaces cavi_pallas.cavi_sweep_pallas_s1_skip): unflagged blocks
    pass through bit-exactly, and the coupling tiles touching a flagged
    block are applied (no refresh_q afterwards). With every block flagged it
    is the all-active sweep, so the hybrid EM iteration picks its branch by
    the mask alone."""
    blk_mask = blk_mask.to(torch.int32)
    new, eta_diff = block_sweep_s1(ld, state, std_beta, n_per_snp, hyper,
                                   active, blk_mask)
    q = _couple_s1(ld, new.q, eta_diff, blk_mask)
    return new._replace(q=q), eta_diff


#: The lane tiles of ``cavi_block_sweep_s``: lanes per CTA, one kernel
#: instance each. A lane's arithmetic is the same in all of them.
SWEEP_LANE_TILES = (4, 8, 16, 20)


def sweep_lane_tile(S):
    """The lane tile of ``cavi_block_sweep_s`` for S lanes: the smallest
    that holds S, else the largest (then ceil(S / 20) lane tiles)."""
    return next((L for L in SWEEP_LANE_TILES if S <= L), SWEEP_LANE_TILES[-1])


def block_sweep_s(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                  hyper: Hyper, active, blk_mask, inner_steps=INNER_STEPS):
    """Sweep the blocks flagged in ``blk_mask`` ((NB,) int32) for S lanes.

    :param state: CaviState of (S, NB, B) float32.
    :param hyper: (S,) hyperparameters; :param active: (S,) float32 step
        scale (0 freezes a lane bit-exactly).
    :param inner_steps: the kernel's inner steps per tile (a timing probe
        takes fewer; the plain version runs INNER_STEPS only).
    :returns: (new_state, eta_diff), coupling tiles not applied.
    """
    if state.eta.device.type == 'cpu':
        if inner_steps != INNER_STEPS:
            raise ValueError(f"the plain sweep takes {INNER_STEPS} inner "
                             f"steps, not {inner_steps}")
        return cavi_torch.block_sweep(ld, state, std_beta, n_per_snp, hyper,
                                      active, blk_mask=blk_mask)
    kernel = 'cavi_block_sweep_s' + _tiles(ld)
    from ._build import build
    lib, _ = build()
    dev = ld.device
    nb, B = ld.nb, ld.block_size
    S = state.eta.shape[0]
    if B % TILE:
        raise ValueError(f"block size {B} is not a multiple of {TILE}")
    _check('diag', ld.diag, ld.diag.dtype, (nb, B, B), dev)
    _check('diag_nz', ld.diag_nz, torch.uint8, (nb, B // 32, B // 32), dev)
    for name, x in (('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask)):
        _check(name, x, F32, (nb, B), dev)
    for name, x in zip(CaviState._fields, state):
        _check(name, x, F32, (S, nb, B), dev)
    _check('blk_mask', blk_mask, torch.int32, (nb,), dev)
    hv = _hyper_rows(hyper, active, dev)
    _check('hyper', hv, F32, (5, S), dev)
    out = CaviState(*(torch.empty_like(x) for x in state))
    eta_diff = torch.empty_like(state.eta)
    for name, x in (('diag', ld.diag), ('diag_nz', ld.diag_nz),
                    ('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask), *zip(CaviState._fields, state)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    err = getattr(lib, kernel + '_launch')(
        ld.diag.data_ptr(), ld.diag_nz.data_ptr(), std_beta.data_ptr(),
        n_per_snp.data_ptr(), ld.mask.data_ptr(),
        *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
        eta_diff.data_ptr(), blk_mask.data_ptr(), hv.data_ptr(), S, nb, B,
        float(np.float32(ld.scale)), int(inner_steps), sweep_lane_tile(S),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return out, eta_diff


#: The lane tiles of ``coupling_pass_s``: lanes per CTA, one kernel
#: instance each. A lane's arithmetic is the same in all of them.
COUPLING_LANE_TILES = (4, 16, 32, 100)


def coupling_lane_tile(S):
    """The lane tile of ``coupling_pass_s`` for S lanes: the smallest that
    holds S, else the largest (then ceil(S / 100) lane tiles)."""
    return next((L for L in COUPLING_LANE_TILES if S <= L),
                COUPLING_LANE_TILES[-1])


def coupling_pass_s_inplace(ld: BlockLD, q, eta_diff, blk_mask):
    """``q += `` the coupling tiles incident to a block flagged in
    ``blk_mask`` ((NB,) int32), applied to ``eta_diff``, for S lanes, in
    place on the card: one launch of ``coupling_pass_s``, a CTA for each
    (block, slab of 128 coordinates) of ``ld.cpl_slabs`` and lane tile; a
    CTA returns at once where no incident tile with a flagged end reaches
    its slab, and skips the chunks of a tile that are exactly zero. q of
    every other slab is not touched. Nothing is read back to the host.
    q, eta_diff: (S, NB, B) float32 CUDA tensors. Returns q."""
    if ld.n_off == 0:
        return q
    if q.device.type == 'cpu':
        raise ValueError("coupling_pass_s_inplace runs on the card; "
                         "coupling_pass_s takes CPU tensors")
    kernel = 'coupling_pass_s' + _tiles(ld)
    from ._build import build
    lib, _ = build()
    dev = ld.device
    nb, B = ld.nb, ld.block_size
    S = q.shape[0]
    _check_coupling_ld(ld)
    slabs = ld.cpl_slabs
    _check('blk_mask', blk_mask, torch.int32, (nb,), dev)
    _check('q', q, F32, (S, nb, B), dev)
    _check('eta_diff', eta_diff, F32, (S, nb, B), dev)
    for name, x in (('off_data', ld.off_data), ('q', q),
                    ('eta_diff', eta_diff)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    err = getattr(lib, kernel + '_launch')(
        ld.off_data.data_ptr(), ld.off_src.data_ptr(), ld.off_dst.data_ptr(),
        ld.inc_ptr.data_ptr(), ld.inc_tile.data_ptr(), blk_mask.data_ptr(),
        ld.off_nz.data_ptr(), slabs.data_ptr(), eta_diff.data_ptr(),
        q.data_ptr(), slabs.numel(), S, nb, B, float(np.float32(ld.scale)),
        coupling_lane_tile(S), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return q


def coupling_pass_s(ld: BlockLD, q, eta_diff, blk_mask):
    """q plus the coupling tiles incident to a block flagged in ``blk_mask``
    ((NB,) int32), applied to ``eta_diff``, for S lanes. q, eta_diff:
    (S, NB, B) float32. Returns a new q and never writes the given one (on
    the card the kernel runs in place on a clone; q itself when there is
    no coupling tile)."""
    if ld.n_off == 0:
        return q
    if q.device.type == 'cpu':
        return cavi_torch.coupling_pass(ld, q, eta_diff, blk_mask)
    return coupling_pass_s_inplace(ld, q.clone(), eta_diff, blk_mask)


def _couple_s(ld: BlockLD, q, eta_diff, blk_mask):
    """The coupling tiles after an S-lane block sweep: in place on the q the
    sweep kernel has just written (a fresh tensor) on the card, the plain
    version on the CPU."""
    if q.device.type == 'cpu':
        return coupling_pass_s(ld, q, eta_diff, blk_mask)
    return coupling_pass_s_inplace(ld, q, eta_diff, blk_mask)


def cavi_sweep_s(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                 hyper: Hyper, active):
    """The all-active S-lane sweep, coupling included (replaces
    cavi_pallas.cavi_sweep_pallas at S > 1 and its refresh_q; same contract
    as cavi_torch.cavi_sweep)."""
    return cavi_sweep_s_skip(ld, state, std_beta, n_per_snp, hyper, active,
                             _all_blocks(ld))


def cavi_sweep_s_skip(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                      hyper: Hyper, active, blk_mask):
    """The S-lane sweep over the blocks flagged in ``blk_mask`` ((NB,) bool
    or int, e.g. ``cavi_torch.union_block_mask`` of the proposal masks;
    replaces cavi_pallas.cavi_sweep_pallas_skip_s): unflagged blocks pass
    through bit-exactly, and the coupling tiles touching a flagged block are
    applied."""
    blk_mask = blk_mask.to(torch.int32)
    new, eta_diff = block_sweep_s(ld, state, std_beta, n_per_snp, hyper,
                                  active, blk_mask)
    q = _couple_s(ld, new.q, eta_diff, blk_mask)
    return new._replace(q=q), eta_diff


def block_proposal_mask(ld: BlockLD, state: CaviState, std_beta, n_per_snp,
                        hyper: Hyper, eps=ETA_DIFF_EPS):
    """Per-block activity check — elementwise, no LD traffic.

    The unrelaxed first-step CAVI proposal of every variant from the cached
    q and the current hyperparameters; a block is active iff any lane
    proposes a step >= eps. Returns (S, NB) bool.
    """
    h = hyper.to32()
    sig_e = h.sigma_eps[:, None, None]
    tau_b = h.tau_beta[:, None, None]
    pi_ = h.pi[:, None, None]
    lam = h.lambda_min[:, None, None]
    n = n_per_snp[None]
    var_tau = n * (1.0 + lam) / sig_e + tau_b
    mu_star = (n / (var_tau * sig_e)) * (std_beta[None] - state.q)
    u_star = torch.log(pi_) - torch.log1p(-pi_) + 0.5 * torch.log(tau_b) \
        - 0.5 * torch.log(var_tau) + 0.5 * var_tau * mu_star * mu_star
    eta_star = torch.sigmoid(u_star) * mu_star
    prop = (eta_star - state.eta).abs() * ld.mask[None]
    return prop.amax(dim=2) >= eps


def _mix_hyper_rows(hyper: MixHyper, active, device):
    """(4 + 2K, S) float32 rows [sigma_eps, lambda_min, active, log_null_pi,
    tau_beta_0..K-1, pi_0..K-1] of S lanes ((S,) / (S, K) hyperparameters)."""
    h = hyper.to32()
    rows = torch.cat([
        torch.stack([h.sigma_eps, h.lambda_min, active.to(F32),
                     cavi_mix.log_null_pi(h.pi)]),
        h.tau_beta.t(), h.pi.t()])
    return rows.to(device=device, dtype=F32).contiguous()


#: The lane tiles of ``cavi_block_sweep_mix_s`` and the largest K each
#: holds (one kernel instance per K and lane tile): a thread keeps its
#: elements' K gamma and mu in registers, so 8 and 20 lanes hold K <= 3 and
#: 4 lanes every K. A lane's arithmetic is the same in all of them.
MIX_SWEEP_LANE_TILES = {4: 8, 8: 3, 20: 3}


def mix_sweep_lane_tile(S, K):
    """The lane tile of ``cavi_block_sweep_mix_s`` for S lanes of K
    components: of the tiles that hold K, the smallest that holds S, else
    the largest (then ceil(S / L) lane tiles)."""
    tiles = [L for L, k_max in sorted(MIX_SWEEP_LANE_TILES.items())
             if K <= k_max]
    return next((L for L in tiles if S <= L), tiles[-1])


def block_sweep_mix(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                    hyper: MixHyper, active, blk_mask, unit_diag, count,
                    inner_steps=INNER_STEPS):
    """Mixture sweep of the blocks flagged in ``blk_mask`` ((NB,) int32) for
    S lanes: gamma/mu (S, K, NB, B), eta/q (S, NB, B) float32; hyper (S,) /
    (S, K). ``active``: (S,) float32 step scales, or None for the single
    model (S = 1; kernels K5/K6 have no step scale). ``unit_diag``: the
    relaxation's diagonal term is the variant mask (K6/K8). ``count``: the
    LAUNCHES entry a launch adds to (with ``_f32`` appended for a float32
    instance). ``inner_steps``: the kernel's inner steps per tile (a timing
    probe takes fewer; the plain version runs INNER_STEPS only). Both
    kernels read ``ld.diag_nz`` (their rank-T updates skip the zero 32 x 32
    blocks).

    :returns: (new_state, eta_diff), coupling tiles not applied.
    """
    if state.eta.device.type == 'cpu':
        if inner_steps != INNER_STEPS:
            raise ValueError(f"the plain sweep takes {INNER_STEPS} inner "
                             f"steps, not {inner_steps}")
        return cavi_mix.mix_block_sweep(ld, state, std_beta, n_per_snp, hyper,
                                        active, blk_mask=blk_mask,
                                        unit_diag=unit_diag)
    sfx = _tiles(ld)
    from ._build import build
    lib, _ = build()
    dev = ld.device
    nb, B = ld.nb, ld.block_size
    S, K = state.gamma.shape[:2]
    if B % TILE:
        raise ValueError(f"block size {B} is not a multiple of {TILE}")
    if not 1 <= K <= 8:
        raise ValueError(f"the mixture kernels take 1 <= K <= 8; got K={K}")
    if active is None and S != 1:
        raise ValueError(f"the single-model sweep takes one lane; got S={S}")
    _check('diag', ld.diag, ld.diag.dtype, (nb, B, B), dev)
    for name, x in (('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask)):
        _check(name, x, F32, (nb, B), dev)
    for name, x in zip(MixState._fields, state):
        _check(name, x, F32, (S, K, nb, B) if name in ('gamma', 'mu')
               else (S, nb, B), dev)
    _check('blk_mask', blk_mask, torch.int32, (nb,), dev)
    ones = torch.ones(S, dtype=F32, device=dev)
    hv = _mix_hyper_rows(hyper, ones if active is None else active, dev)
    _check('hyper', hv, F32, (4 + 2 * K, S), dev)
    _check('diag_nz', ld.diag_nz, torch.uint8, (nb, B // 32, B // 32), dev)
    for name, x in (('diag', ld.diag), ('diag_nz', ld.diag_nz),
                    ('std_beta', std_beta), ('n_per_snp', n_per_snp),
                    ('mask', ld.mask), *zip(MixState._fields, state)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = MixState(*(torch.empty_like(x) for x in state))
    eta_diff = torch.empty_like(state.eta)
    ptrs = (std_beta.data_ptr(), n_per_snp.data_ptr(), ld.mask.data_ptr(),
            *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
            eta_diff.data_ptr(), blk_mask.data_ptr(), hv.data_ptr())
    tail = (nb, B, float(np.float32(ld.scale)), int(inner_steps),
            int(unit_diag))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if active is None:
        kernel = 'cavi_block_sweep_mix_s1' + sfx
        err = getattr(lib, kernel + '_launch')(
            ld.diag.data_ptr(), ld.diag_nz.data_ptr(), *ptrs, K, *tail,
            stream)
        _raise_on(err, kernel)
    else:
        kernel = 'cavi_block_sweep_mix_s' + sfx
        err = getattr(lib, kernel + '_launch')(
            ld.diag.data_ptr(), ld.diag_nz.data_ptr(), *ptrs, S, K, *tail,
            mix_sweep_lane_tile(S, K), stream)
        _raise_on(err, kernel)
    LAUNCHES[count + sfx] += 1
    return out, eta_diff


def _sweep_mix_s1(ld, state, std_beta, n_per_snp, hyper, blk_mask, unit_diag,
                  count):
    blk_mask = blk_mask.to(torch.int32)
    lanes = MixState(*(x[None] for x in state))
    new, eta_diff = block_sweep_mix(ld, lanes, std_beta, n_per_snp,
                                    hyper.lanes(), None, blk_mask, unit_diag,
                                    count)
    q = _couple_s1(ld, new.q, eta_diff, blk_mask)
    return MixState(new.gamma[0], new.mu[0], new.eta[0], q[0]), eta_diff[0]


def cavi_sweep_mix_s1(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                      hyper: MixHyper):
    """The single-model all-active mixture sweep, coupling included
    (replaces cavi_pallas.cavi_sweep_mixture_pallas, K5): state gamma/mu
    (K, NB, B), eta/q (NB, B); hyper scalars and (K,). Returns (new_state,
    eta_diff)."""
    return _sweep_mix_s1(ld, state, std_beta, n_per_snp, hyper,
                         _all_blocks(ld), False, 'cavi_sweep_mix_s1')


def cavi_sweep_mix_s1_skip(ld: BlockLD, state: MixState, std_beta,
                           n_per_snp, hyper: MixHyper, blk_mask):
    """The single-model mixture sweep over the blocks flagged in
    ``blk_mask`` ((NB,) bool or int, e.g. cavi_mix.mix_block_proposal_mask;
    replaces cavi_pallas.cavi_sweep_mixture_pallas_skip, K6): unflagged
    blocks pass through bit-exactly, the coupling tiles touching a flagged
    block are applied, and the relaxation takes the variant mask as the unit
    diagonal."""
    return _sweep_mix_s1(ld, state, std_beta, n_per_snp, hyper, blk_mask,
                         True, 'cavi_sweep_mix_s1_skip')


def cavi_sweep_mix_s(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                     hyper: MixHyper, active):
    """The all-active S-lane mixture sweep, coupling included (replaces
    cavi_pallas.cavi_sweep_mixture_pallas_batch, K7): state gamma/mu
    (S, K, NB, B), eta/q (S, NB, B); hyper (S,) / (S, K); active (S,)
    float32 (0 freezes a lane bit-exactly)."""
    blk_mask = _all_blocks(ld)
    new, eta_diff = block_sweep_mix(ld, state, std_beta, n_per_snp, hyper,
                                    active.to(F32), blk_mask, False,
                                    'cavi_sweep_mix_s')
    return new._replace(q=_couple_s(ld, new.q, eta_diff, blk_mask)), \
        eta_diff


def cavi_sweep_mix_s_skip(ld: BlockLD, state: MixState, std_beta, n_per_snp,
                          hyper: MixHyper, active, blk_mask):
    """The S-lane mixture sweep over the blocks flagged in ``blk_mask``
    ((NB,) bool or int: the union over the live lanes of
    cavi_mix.mix_block_proposal_mask_batch; replaces
    cavi_pallas.cavi_sweep_mixture_pallas_skip_batch, K8), the variant mask
    as the unit diagonal."""
    blk_mask = blk_mask.to(torch.int32)
    new, eta_diff = block_sweep_mix(ld, state, std_beta, n_per_snp, hyper,
                                    active.to(F32), blk_mask, True,
                                    'cavi_sweep_mix_s_skip')
    return new._replace(q=_couple_s(ld, new.q, eta_diff, blk_mask)), \
        eta_diff
