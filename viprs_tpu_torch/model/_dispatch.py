"""Sweep-dispatch policy of the port.

Which implementation runs follows the tensors: the kernel wrappers
(ops/cavi_cuda.py) launch the CUDA kernels for CUDA tensors and take their
plain PyTorch versions for CPU tensors. What remains to choose is the sweep
rule, under the JAX package's names (viprs_tpu/model/_dispatch.py):

- ``None`` (default): at S = 1 the hybrid rule, at S > 1 the all-active
  lane sweep (TPU kernel K3);
- ``'hybrid'``: S = 1 only; each EM iteration computes the per-block
  proposal mask and sweeps only the active blocks when at most
  ``ops.em_loop.HYBRID_FRAC`` of them are active, all blocks otherwise;
- ``'xla'`` or ``'pallas'``: the all-active sweep every iteration (the two
  names mean the same here);
- ``'skip'``: the block-skipping sweep every iteration; at S > 1 a block is
  swept iff any live lane proposes a step on it (K4's union gate).

On the card every choice launches a kernel; the JAX package's S < 8 -> XLA
threshold (``MIN_PALLAS_LANES``) is a TPU measurement and has no
counterpart: every S >= 2 goes through the lane kernels.

The mixture prior has its own rule (``select_mix_sweep_impl``), the JAX
package's policy on its TPU backend:

- ``VIPRSMix``: ``None`` and ``'skip'`` take the activity-gated sweep (TPU
  kernel K6) every iteration (viprs_tpu/model/mix.py:505-506), ``'xla'``
  and ``'pallas'`` the all-active sweep (K5);
- ``VIPRSMixGrid``: ``None``, ``'xla'`` and ``'pallas'`` take the
  all-active lane sweep (K7; the JAX package's policy at S * K >= 8,
  mix_grid.py:289-291, for every width here), ``'skip'`` the union-gated
  sweep (K8);
- ``'hybrid'`` is the single-model VIPRS dispatch and raises for both.
"""

# the JAX package defines the hybrid's threshold here; the loop that reads
# it is the port's ops/em_loop.py
from ..ops.em_loop import HYBRID_FRAC  # noqa: F401

SWEEP_IMPLS = (None, 'xla', 'skip', 'pallas', 'hybrid')


def select_sweep_impl(S, sweep_impl=None):
    """Decide the sweep rule of a fit whose lane count is ``S``.

    :returns: ``(use_skip, use_hybrid)``.
    """
    if sweep_impl not in SWEEP_IMPLS:
        raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}; got "
                         f"{sweep_impl!r}")
    if sweep_impl == 'hybrid' and S != 1:
        raise ValueError(
            f"sweep_impl='hybrid' is the single-model (S == 1) "
            f"activity-gated dispatch; got S={S}. Wide grids use the lane "
            f"sweep ('pallas'/'xla') or the union-gated skip sweep ('skip').")
    if sweep_impl is None:
        return False, S == 1
    return sweep_impl == 'skip', sweep_impl == 'hybrid'


def select_mix_sweep_impl(sweep_impl=None, grid=False):
    """Decide the sweep rule of a mixture fit (``grid``: a VIPRSMixGrid).

    :returns: ``use_skip``.
    """
    if sweep_impl not in SWEEP_IMPLS:
        raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}; got "
                         f"{sweep_impl!r}")
    if sweep_impl == 'hybrid':
        raise ValueError(
            "sweep_impl='hybrid' is the single-model VIPRS dispatch; mixture "
            "fits use the all-active sweep ('xla'/'pallas') or the "
            "activity-gated skip sweep ('skip').")
    return sweep_impl == 'skip' or (sweep_impl is None and not grid)


#: What an explicit mesh raises: the port runs on one device.
NEEDS_MESH = ("an explicit mesh spreads the fit over several devices, which "
              "is not ported yet; see ROADMAP.md, Queue 1, item 10 ('auto', "
              "'off' and None mean the one device)")


def resolve_mesh(mesh):
    """The models' ``mesh`` argument: ``'auto'``, ``'off'`` and None mean
    the one device (None is returned); an explicit mesh raises."""
    if mesh is None or (isinstance(mesh, str) and mesh in ('auto', 'off')):
        return None
    raise NotImplementedError(NEEDS_MESH)


def check_tile(tile):
    """The models' ``tile`` argument: the port's sweeps (the kernels and
    their plain versions) take tiles of T = 128 variants."""
    from ..ops.cavi_torch import TILE
    if tile != TILE:
        raise ValueError(f"the port's sweeps use tiles of T = {TILE} "
                         f"variants; got tile={tile}")
    return tile
