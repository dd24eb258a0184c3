"""Probe a configuration's set-up on the card: what a cell on it would pay
before its warm-up, and whether the panel fits.

    python -m portbench.setup --config <name> [--traits N]

First reckons, from the panel's block sizes alone (``reckon``), the packed
LD that the port's dense-block packer would make (the benchmark's own
tiling, ``layout.plan_layout``) and the host and device memory it needs;
where the machine cannot hold it, it stops there (exit code 4) and the
line says so (``fits`` false). Otherwise runs ``run.set_up`` (the CUDA
context, the panel, N traits of the pool of ``traffic/grid100.json``, the
panel packed and uploaded, the kernels built), then frees the packed LD
and builds the plain reference's LD (``reference.RefLD``). The
configuration is ``configs/<name>.json``, named in ``BENCHMARK.json`` or
not. Prints one JSON line: the reckoning, each step's seconds,
the host's peak resident set, the packed LD's bytes on the device (its
tiles, and every tensor of it), its ``nb`` and ``n_off``, ``RefLD``'s bytes
on the device, the device's peak, and the whole-panel check: the sum of
the packed diagonal tiles plus twice that of the coupling tiles (int64 for
int8 tiles, float64 for float32) against the sum over ``RefLD``'s blocks,
which must be equal (float32: within 1e-9 of it).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

#: tiles summed at a time (the widened copy of a chunk lives on the device)
SUM_CHUNK = 64
#: the traffic whose pool of traits the set-up draws
TRAFFIC = 'grid100'
#: the share of the host's memory the packer may take
HOST_SHARE = 0.9


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def config(bench, name):
    """The configuration ``name``: BENCHMARK.json's entry where it has one,
    else ``configs/<name>.json``."""
    from .run import load_json
    try:
        return bench.config(name)[1]
    except KeyError:
        return load_json(os.path.join(bench.here, 'configs', f'{name}.json'))


def host_bytes():
    """The memory this process's host may use: its physical memory, or its
    control group's limit where that is lower."""
    total = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    try:
        with open('/sys/fs/cgroup/memory.max') as f:
            limit = f.read().strip()
        if limit.isdigit():
            total = min(total, int(limit))
    except OSError:
        pass
    return total


def reckon(panel, cfg):
    """The packed LD of the panel, from its block sizes and AR(1)
    parameters alone: ``nb`` diagonal tiles and ``n_off`` coupling tiles
    (every pair of tiles of a block wider than a tile), their bytes, the
    host bytes the packer takes (its diagonal array, its dict of coupling
    tiles and their stacked copy) and the reference's bytes (every block
    whole); and the stored band (the largest |i - j| at which a block is
    nonzero): its median and largest over the blocks, and the nonzero
    entries the panel stores."""
    import numpy as np
    from .layout import plan_layout
    from .work import band
    B = int(cfg['block_size'])
    quantize = bool(cfg['quantize'])
    elem = 1 if quantize else 4
    nb, placements, _ = plan_layout(panel.sizes_by_chrom(), B)
    n_off = 0
    for _, _, _, _, m_b in placements:
        t = -(-m_b // B)
        n_off += t * (t - 1) // 2
    sizes = [int(m) for m in panel.sizes]
    bands = np.array([min(band(r, m, quantize), m - 1)
                      for r, m in zip(panel.rho, sizes)], np.int64)
    m = np.array(sizes, np.int64)
    return {
        'nb': int(nb), 'n_off': int(n_off),
        'ld_tile_bytes': (nb + n_off) * B * B * elem,
        'host_need_bytes': (nb + 2 * n_off) * B * B * elem,
        'ref_ld_bytes': int((m ** 2).sum()) * elem,
        'band_median': float(np.median(bands)),
        'band_max': int(bands.max()),
        'stored_nonzeros': int((m * (2 * bands + 1)
                                - bands * (bands + 1)).sum()),
    }


def tile_sum(x, wide):
    """The sum of a (n, B, B) tensor's entries in ``wide``, SUM_CHUNK tiles
    at a time."""
    import torch
    total = torch.zeros((), dtype=wide, device=x.device)
    for i in range(0, x.shape[0], SUM_CHUNK):
        total += x[i:i + SUM_CHUNK].to(wide).sum()
    return total.item()


def probe(bench, config_name, n_traits=None, device='cuda'):
    import torch
    from . import reference
    from .entries import sync
    from .panel import make_panel
    from .run import set_up
    steps = {'imports': time.perf_counter() - T_START}
    device = torch.device(device)
    cfg = config(bench, config_name)
    t0 = time.perf_counter()
    panel = make_panel(cfg)
    plan = reckon(panel, cfg)
    steps['reckon'] = time.perf_counter() - t0
    out = {'config': config_name, 'm': panel.m,
           'n_blocks': len(panel.sizes),
           'blocks_wider_than_tile': int((panel.sizes
                                          > int(cfg['block_size'])).sum()),
           'reckoned': plan, 'host_bytes': host_bytes()}
    if device.type == 'cuda':
        out['device_bytes'] = torch.cuda.mem_get_info(device)[1]
        out['device'] = torch.cuda.get_device_name(device)
    short = []
    if plan['host_need_bytes'] > HOST_SHARE * out['host_bytes']:
        short.append('host')
    need = max(plan['ld_tile_bytes'], plan['ref_ld_bytes'])
    if need > out.get('device_bytes', need):
        short.append('device')
    out['fits'] = not short
    if short:
        out['short_of'] = short
        out['steps_s'] = steps
        out['total_s'] = time.perf_counter() - T_START
        return out
    del panel
    traffic = dict(bench.traffic(TRAFFIC))
    if n_traits is not None:
        traffic['pool'] = dict(traffic['pool'], size=int(n_traits))
    su = set_up(cfg, traffic, 0, device)
    steps.update(su.steps)
    ld = su.ds0.ld
    quantize = bool(cfg['quantize'])
    wide = torch.int64 if quantize else torch.float64
    t0 = time.perf_counter()
    ld_sum = tile_sum(ld.diag, wide) + 2 * tile_sum(ld.off_data, wide)
    steps['ld_sum'] = time.perf_counter() - t0
    tensors = [v for v in vars(ld).values() if isinstance(v, torch.Tensor)]
    out.update({
        'traits': len(su.traits), 'nb': int(ld.nb), 'n_off': int(ld.n_off),
        'ld_tile_bytes': int(ld.diag.nbytes + ld.off_data.nbytes),
        'ld_device_bytes': int(sum(t.nbytes for t in tensors)),
    })
    panel = su.panel
    del su, ld, tensors
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        out['device_allocated_after_free'] = torch.cuda.memory_allocated(
            device)
    t0 = time.perf_counter()
    ref = reference.RefLD(panel, quantize, device)
    sync(device)
    steps['ref_ld'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_sum = sum(b.to(wide).sum().item() for b in ref.blocks)
    steps['ref_sum'] = time.perf_counter() - t0
    out['ref_ld_device_bytes'] = int(sum(b.nbytes for b in ref.blocks))
    out['ld_sum'], out['ref_sum'] = ld_sum, ref_sum
    out['sums_equal'] = bool(ld_sum == ref_sum if quantize else
                             abs(ld_sum - ref_sum) <= 1e-9 * abs(ref_sum))
    out['steps_s'] = steps
    out['total_s'] = time.perf_counter() - T_START
    # ru_maxrss is in KiB on Linux
    out['host_peak_rss_bytes'] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if device.type == 'cuda':
        out['device_peak_bytes'] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', required=True)
    ap.add_argument('--traits', type=int, default=None,
                    help=f"traits to draw (default: {TRAFFIC}'s pool)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    from .run import Bench
    out = probe(Bench(), args.config, args.traits)
    print(json.dumps(out), flush=True)
    if not out['fits']:
        log(f"stopped before packing: the packed LD does not fit the "
            f"{' and the '.join(out['short_of'])}")
        return 4
    return 0 if out['sums_equal'] else 1


if __name__ == '__main__':
    sys.exit(main())
