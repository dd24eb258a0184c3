"""viprs_warmup_torch — make ready, ahead of the first fit, what a cold
process on an LD store would otherwise pay for.

The port's counterpart of viprs_tpu.cli.warmup (``viprs_warmup``), with its
flags and ``--device``. In the JAX package a cold process pays for compiling
the fused EM program, which is keyed by the store's packed shapes. On this
port there is no shape-keyed program: the sweeps are the CUDA kernels of
``csrc/``, built by nvcc into one library (kept under
``viprs_tpu_torch/_build/``, named by a hash of the sources) and loaded with
ctypes. The library holds every kernel's int8 and float32 instances, and a
launch takes the shapes (NB, B, S) as arguments, so which kernels a fit
launches follows from the store's shapes, the lane count and the tile type
alone; what a cold process pays for is the build (once per source tree)
and the load.

So the warmup reads only the store's block boundaries (no LD data is read,
packed or uploaded), plans the packed layout from them (M, NB, B), and
drives the real models on a dataset of that layout whose tiles hold no data
(one zero element broadcast): ``VIPRS`` and a ``VIPRSGrid`` for each
``--grid-widths`` value, each ``fit(compile_only=True)``, which builds (or
finds) the library those fits would launch and changes no state and no
random stream. On the CPU (``--device cpu``) there is nothing to build.
Under ``--mesh`` (a torchrun launch) each rank warms the fits of its shard.

    python -m viprs_tpu_torch.cli.warmup -l <LD store or glob> \\
        [--block-size 1024] [--grid-widths 100] [--device cpu]
"""

import argparse
import logging
import os.path as osp
import sys
import time

import numpy as np

logger = logging.getLogger('viprs_warmup')


def build_parser():
    p = argparse.ArgumentParser(
        'viprs_warmup_torch', description=__doc__.split('\n\n')[0])
    p.add_argument('-l', '--ld-panel', dest='ld_dir', required=True,
                   help='Path (or glob) to the LD store(s) (native or '
                        'magenpy Zarr).')
    p.add_argument('--block-size', dest='block_size', type=int, default=1024)
    p.add_argument('--max-iter', dest='max_iter', type=int, default=1000,
                   help='Accepted for compatibility: no program here is '
                        'keyed by it.')
    p.add_argument('--grid-widths', dest='grid_widths', type=int, nargs='*',
                   default=[], help='Also warm grid fits at these model '
                                    'counts (e.g. 100).')
    p.add_argument('--dequantize-on-the-fly', dest='dequantize',
                   action='store_true',
                   help='int8 tiles, as the later fits take them (float32 '
                        'otherwise).')
    p.add_argument('--mesh', dest='mesh', default='auto',
                   help="As for viprs_fit_torch: 'auto' (default), 'off' "
                        "or '<NB>x<NG>' over the processes of a torchrun "
                        "launch; each rank warms its shard's fits.")
    p.add_argument('--device', dest='device', default='cuda',
                   help="Device of the later fits: 'cuda' (default; fails "
                        "without CUDA) or 'cpu'.")
    return p


def store_block_sizes(ld_dir):
    """{chrom: [LD block sizes]} of the store(s) at ``ld_dir`` (a path or a
    glob), from their metadata only: a native store's array headers, a
    magenpy Zarr store's row pointers and LD boundaries."""
    from ..data import ld_store
    from ..utils.system import get_filenames
    sizes = {}
    for path in get_filenames(ld_dir):
        if osp.exists(osp.join(path, 'metadata.json')):
            sizes.update(ld_store.native_store_block_sizes(path))
        else:
            sizes.update(ld_store.magenpy_zarr_block_sizes(path))
    return sizes


def shape_dataset(sizes, block_size, quantize, device):
    """A dataset with the packed layout of LD blocks of ``sizes`` and no LD
    data: its tiles are one zero element broadcast to (NB, B, B) (int8 with
    ``quantize``, float32 otherwise), and it has no coupling tiles (the
    JAX package's warmup packs zero blocks, which have none either). Only
    the layout's variant mask and the zero statistics go to ``device``."""
    import torch
    from ..data.dataset import SummaryStatsDataset
    from ..ops.block_ld import BlockLD, INT8_SCALE, NZ_BLOCK, plan_layout

    dev = torch.device(device)
    layout, _ = plan_layout(sizes, block_size=block_size)
    nb, B = layout.nb, layout.block_size
    dtype = torch.int8 if quantize else torch.float32
    i32 = dict(dtype=torch.int32, device=dev)
    m32 = -(-B // NZ_BLOCK)
    ld = BlockLD(
        diag=torch.zeros((), dtype=dtype, device=dev).expand(nb, B, B),
        off_data=torch.zeros((0, B, B), dtype=dtype, device=dev),
        off_src=torch.zeros(0, **i32), off_dst=torch.zeros(0, **i32),
        mask=torch.from_numpy(layout.mask()).to(dev),
        inc_ptr=torch.zeros(nb + 1, **i32), inc_tile=torch.zeros(0, **i32),
        off_nz=torch.zeros((0, m32, m32), dtype=torch.uint8, device=dev),
        cpl_slabs=torch.zeros(0, **i32),
        diag_nz=torch.zeros((), dtype=torch.uint8, device=dev).expand(
            nb, m32, m32),
        scale=INT8_SCALE if quantize else 1.0)
    std_beta = {c: np.zeros(m) for c, m in zip(layout.chromosomes,
                                                layout.chrom_sizes)}
    n_per_snp = {c: np.full(m, 1000.0) for c, m in zip(layout.chromosomes,
                                                        layout.chrom_sizes)}
    return SummaryStatsDataset(ld=ld, layout=layout, std_beta=std_beta,
                               n_per_snp=n_per_snp)


def warm(ds, S, max_iter, device, mesh='auto'):
    """``fit(compile_only=True)`` of the model a fit of S lanes makes on
    this dataset (VIPRS at S = 1, a VIPRSGrid of S points otherwise):
    builds or finds the kernel library it would launch. Returns seconds."""
    from ..gridsearch import HyperparameterGrid
    from ..model import VIPRS, VIPRSGrid

    t0 = time.perf_counter()
    if S == 1:
        model = VIPRS(ds, device, mesh=mesh)
    else:
        grid = HyperparameterGrid(pi_steps=S, n_snps=ds.m, h2_est=0.1,
                                  h2_se=0.05)
        model = VIPRSGrid(ds, grid, device, mesh=mesh)
    model.fit(max_iter=max_iter, compile_only=True)
    return time.perf_counter() - t0


def run(argv=None):
    """Warm the fits of a store; returns the record: its packed shapes
    (``m``, ``nb``, ``block_size``), the widths warmed, the seconds of each
    step and the kernel library (its path and build seconds, 0.0 where it
    was found built; None on the CPU)."""
    from .fit import resolve_device, resolve_mesh_arg
    args = build_parser().parse_args(argv)
    mesh = resolve_mesh_arg(args.mesh)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    sizes = store_block_sizes(args.ld_dir)
    ds = shape_dataset(sizes, args.block_size, args.dequantize, device)
    t_shapes = time.perf_counter() - t_start
    logger.info("> store shapes: M=%d NB=%d B=%d (%.2f s, metadata only)",
                ds.m, ds.layout.nb, ds.layout.block_size, t_shapes)
    seconds = {'shapes': t_shapes}
    widths = [1, *(int(S) for S in args.grid_widths)]
    for S in widths:
        seconds[f'S={S}'] = warm(ds, S, args.max_iter, device, mesh)
        logger.info("> S=%d: %.2f s", S, seconds[f'S={S}'])
    library = None
    if device.type == 'cuda':
        from ..ops import _build
        _, info = _build.build()
        library = {'path': info['path'], 'build_seconds': info['seconds']}
        logger.info("> kernel library %s (built in %.1f s; 0.0: found)",
                    info['path'], info['seconds'])
    seconds['total'] = time.perf_counter() - t_start
    return {'m': ds.m, 'nb': ds.layout.nb, 'block_size': ds.layout.block_size,
            'widths': widths, 'seconds': seconds, 'library': library,
            'device': str(device),
            'mesh': None if mesh is None else dict(mesh.shape)}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
