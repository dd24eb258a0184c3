"""
viprs_tpu_torch — the PyTorch/CUDA port of viprs_tpu for one NVIDIA H100.

Variational inference of polygenic risk scores (spike-and-slab VIPRS) from
GWAS summary statistics and block-packed int8 LD. The module layout mirrors
``viprs_tpu`` so each piece has a named counterpart; the JAX package stays the
reference the port is tested against, and this package never imports it (nor
``jax``).

Precision follows the reference: per-variant state is float32, reductions
across blocks and the hyperparameter/ELBO arithmetic are explicit
``torch.float64``. Every entry point takes an explicit ``device``; the CUDA
kernels (``csrc/``) are built with ``nvcc`` at first use, and CPU tensors take
the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (importing the package loads no model code)."""
    if name in ('VIPRS', 'VIPRSGrid', 'VIPRSMix', 'VIPRSMixGrid',
                'LDPredInf', 'BayesPRSModel'):
        from . import model
        return getattr(model, name)
    if name == 'SummaryStatsDataset':
        from .data.dataset import SummaryStatsDataset
        return SummaryStatsDataset
    raise AttributeError(f"module 'viprs_tpu_torch' has no attribute {name!r}")
