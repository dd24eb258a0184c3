"""Multi-process execution.

Counterpart of viprs_tpu.parallel.distributed. The JAX package spans hosts
with ``jax.distributed`` and lets XLA route the reductions; the port starts
one process per mesh cell (e.g. under ``torchrun``) joined in a
``torch.distributed`` process group over gloo, and its EM loops exchange
their host vectors and halo blocks through that group
(``parallel/mesh.py``).
"""

import logging
import os
from datetime import timedelta

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: How long a collective waits for the other ranks before the run fails.
TIMEOUT = timedelta(seconds=600)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, timeout=TIMEOUT):
    """Join this process to the default process group (gloo) and return its
    rank; a no-op returning 0 in a single process.

    :param coordinator_address: ``'host:port'`` of rank 0 (default:
        torchrun's ``MASTER_ADDR``/``MASTER_PORT``).
    :param num_processes: the world size (default: ``WORLD_SIZE``).
    :param process_id: this process's rank (default: ``RANK``).

    Where CUDA is available the rank's card becomes the current device
    (``cuda:{LOCAL_RANK % device_count}``), so ``device='cuda'`` means it.
    A group that is already initialized is kept.
    """
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank()
    world = int(num_processes if num_processes is not None
                else os.environ.get('WORLD_SIZE', 1))
    if world <= 1:
        return 0
    rank = int(process_id if process_id is not None
               else os.environ['RANK'])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    dist.init_process_group('gloo', init_method=f'tcp://{coordinator_address}',
                            world_size=world, rank=rank, timeout=timeout)
    if torch.cuda.is_available():
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    logger.info("torch.distributed initialized: process %d of %d", rank,
                world)
    return rank


def global_mesh(n_grid_axis=1):
    """A ('blocks', 'grid') mesh over every process."""
    from .mesh import make_mesh
    return make_mesh(n_grid_axis=n_grid_axis)


def fetch(x, mesh=None, split_lanes=False):
    """The host (numpy) value of sharded state, on every rank.

    ``x``: a tensor, or a tuple / list / NamedTuple of tensors (e.g. a
    CaviState), each this rank's part: blocks on axis -2 (the rank's range
    of a mesh's ``blocks`` axis) and, with ``split_lanes``, lanes on axis 0
    (its range of the ``grid`` axis). Without a mesh it is a host copy.
    With one it is an all-gather over the blocks group, then the grid
    group: a collective, which every rank reaches in lockstep (the host
    loops take the same decisions on every rank). The result keeps the
    padded blocks (NB padded to a multiple of the blocks axis).
    """
    if isinstance(x, (tuple, list)):
        vals = [fetch(v, mesh, split_lanes) for v in x]
        return type(x)(*vals) if hasattr(x, '_fields') else type(x)(vals)
    if mesh is None:
        return x.detach().cpu().numpy()
    h = x.detach().cpu()
    h = torch.cat(mesh.gather(h, 'blocks'), dim=h.dim() - 2)
    if split_lanes:
        h = torch.cat(mesh.gather(h, 'grid'), dim=0)
    return np.asarray(h.numpy())
