"""Multi-device fits over processes (``torch.distributed``): the
('blocks', 'grid') mesh, the rank's shard of the LD and state, and the
process group (counterpart of viprs_tpu.parallel)."""

from .mesh import make_mesh, shard_problem, pad_blocks  # noqa: F401
from .distributed import init_distributed, global_mesh  # noqa: F401
