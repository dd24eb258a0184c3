"""Sweep-dispatch policy of the port.

Which implementation runs follows the tensors: the kernel wrappers
(ops/cavi_cuda.py) launch the CUDA kernels for CUDA tensors and take their
plain PyTorch versions for CPU tensors. What remains to choose is the
branch rule of the single-model fit, under the JAX package's names:

- ``None`` or ``'hybrid'`` (default): each EM iteration computes the
  per-block proposal mask and sweeps only the active blocks when at most
  ``ops.em_loop.HYBRID_FRAC`` of them are active, all blocks otherwise;
- ``'xla'``: the all-active sweep every iteration.
"""

SWEEP_IMPLS = (None, 'hybrid', 'xla')


def use_hybrid(sweep_impl=None) -> bool:
    """True iff the fit takes the hybrid branch rule."""
    if sweep_impl not in SWEEP_IMPLS:
        raise ValueError(f"sweep_impl must be one of {SWEEP_IMPLS}; got "
                         f"{sweep_impl!r}")
    return sweep_impl != 'xla'
