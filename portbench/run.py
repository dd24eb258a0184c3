"""Run one cell of the port's benchmark once and print one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (an LD
panel and how it is stored, ``configs/<name>.json``) and a traffic mix (the
entry, its grid and the traits, ``traffic/<name>.json``). The run:

1. set-up (``set_up``, then the warm-up): makes the panel on the host
   (``panel.py``), draws the pool of traits, packs and uploads the panel
   through ``SummaryStatsDataset.from_dense_blocks``, builds the CUDA
   kernels (the first run in a checkout only), and warms up with one fit
   capped at a few iterations at the cell's own lane width;
2. the window: one user's batch of traits, closed loop: each fit takes the
   next pair of the pool (a trait and the seed of numpy's theta_0 draws,
   the same pool for every run seed where the traffic fixes its seed), in
   an order drawn from the run's seed, in a dataset of its own over the
   panel's LD, and runs to convergence; the window ends on a whole pass
   over the pool: with the first fit that finishes at or after
   ``--seconds`` and brings the count of fits to a multiple of the pool's
   size, so that every run times the same work whatever its order. With
   ``--trace 1`` the window runs under ``torch.profiler``;
3. the judge: once the window has closed and the peak memory is read, the
   answers of the window's last fit (its trait set by the seed's order)
   are read and held by the traffic's entry (``entries/<entry>.py``) against
   the plain reference (``reference.py``), which builds the LD itself once
   the program's state is freed; each number is printed beside its limit
   (``checks/<cell>.json``).

The result line carries the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics and a breakdown of the trace (``--trace 1``), each read by
its own file under ``metrics/``; the line also gives the seconds the
kernel build took inside the set-up (``setup_build_s``: only the first run
in a checkout builds). The run exits non-zero and prints no
result without enough CUDA devices, or if JAX or the JAX package is loaded
when the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple  # noqa: E402

import numpy as np  # noqa: E402

from .panel import draw_trait, make_panel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that must not be loaded by a run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'viprs_tpu')


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split('.')[0] in FORBIDDEN})


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names, found by name under
    ``portbench/`` (``configs/``, ``traffic/``, ``entries/``, ``checks/``,
    ``metrics/``)."""

    def __init__(self, root=ROOT, here=HERE):
        self.root, self.here = root, here
        self.spec = load_json(os.path.join(root, 'BENCHMARK.json'))

    def cell(self, name):
        for w in self.spec['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec['configs']:
            if c['name'] == name:
                return c, load_json(os.path.join(self.root, c['file']))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return load_json(os.path.join(self.here, 'traffic', f'{name}.json'))

    def entry(self, name):
        """The ``Entry`` class of ``entries/<name>.py``."""
        from .entries import load
        return load(name, os.path.join(self.here, 'entries'))

    def checks(self, cell):
        return load_json(os.path.join(self.here, 'checks', f'{cell}.json'))

    def metric_names(self, cell, trace):
        key = 'per_layer' if trace else 'end_to_end'
        return [m['name'] for m in self.spec[key]
                if 'workloads' not in m or cell in m['workloads']]

    def metric_spec(self, name):
        for key in ('end_to_end', 'per_layer'):
            for m in self.spec[key]:
                if m['name'] == name:
                    return m
        raise KeyError(name)

    def metric(self, name):
        path = os.path.join(self.here, 'metrics', f'{name}.py')
        spec = importlib.util.spec_from_file_location(
            'portbench_metric_' + re.sub(r'\W', '_', name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class RunRecord:
    """What a run measured, for the metric files to read."""

    def __init__(self, panel, cfg, planes, device_kind, metrics_dir):
        self.panel, self.cfg, self.planes = panel, cfg, planes
        self.device_kind = device_kind
        self.metrics_dir = metrics_dir
        self.m = panel.m
        self.fits = []
        self.window_s = self.setup_s = self.pack_s = self.build_s = None
        self.peak_bytes = None
        self.timeline = None
        self._counts = None

    def counts(self):
        if self._counts is None:
            from .work import Counts
            self._counts = Counts(self.panel, bool(self.cfg['quantize']),
                                  int(self.cfg['block_size']))
        return self._counts

    def device_peaks(self):
        from .work import peaks
        return None if self.device_kind is None else peaks(self.device_kind)

    def lane_kernel_patterns(self):
        """The E-step kernels' name patterns, one file of regular
        expressions each under ``metrics/estep_roofline_pct/``."""
        d = os.path.join(self.metrics_dir, 'estep_roofline_pct')
        pats = []
        for fname in sorted(os.listdir(d)):
            if not fname.endswith('.txt'):
                continue
            with open(os.path.join(d, fname)) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith('#'):
                        pats.append(re.compile(line))
        return pats


def _pool(panel, traffic, seed):
    """The pool of fits, the traits with the theta_0 seed of each, drawn from
    the traffic's pool seed (the same work for every run seed), and the
    order the window takes them in, drawn from the run's seed."""
    t = traffic['trait']
    pool = traffic['pool']
    r_pool = np.random.default_rng(int(pool['seed']))
    traits, thetas = [], []
    for _ in range(int(pool['size'])):
        traits.append(draw_trait(panel, r_pool, float(t['h2']),
                                 float(t['prop_causal']), float(t['n'])))
        thetas.append(int(r_pool.integers(0, 2 ** 32)))
    order = np.random.default_rng(np.random.SeedSequence(
        int(seed) & (2 ** 64 - 1))).permutation(len(traits))
    return traits, thetas, order


def _dataset(ds0, trait):
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    std_beta, n_per_snp = trait
    return SummaryStatsDataset(ld=ds0.ld, layout=ds0.layout,
                               std_beta=std_beta, n_per_snp=n_per_snp)


def _no_span(name):
    return contextlib.nullcontext()


class SetUp(NamedTuple):
    """What a cell's set-up made before its warm-up."""
    panel: object
    traits: list           # the pool: (std_beta, n_per_snp) each
    thetas: list           # numpy's theta_0 seed of each
    order: np.ndarray      # the order the window takes the pool in
    ds0: object            # the packed LD on the device, the first trait
    steps: dict            # seconds of each step


def set_up(cfg, traffic, seed, device):
    """The set-up of a run before its warm-up: the CUDA context, the panel
    (``panel.make_panel``), the pool of traits, the panel packed and
    uploaded through ``SummaryStatsDataset.from_dense_blocks`` and the
    kernels built for it; each step's seconds in ``steps`` (``pack`` is
    ``pack_s``, ``build`` the kernel build)."""
    import torch
    from .entries import sync as _sync
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    steps = {}
    if device.type == 'cuda':
        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        steps['cuda'] = time.perf_counter() - t0
        log(f"set-up: CUDA context {steps['cuda']:.2f} s")
    t0 = time.perf_counter()
    panel = make_panel(cfg)
    steps['panel'] = time.perf_counter() - t0
    log(f"set-up: panel {steps['panel']:.2f} s ({panel.m} "
        f"variants, {len(panel.sizes)} blocks)")
    t0 = time.perf_counter()
    traits, thetas, order = _pool(panel, traffic, seed)
    steps['traits'] = time.perf_counter() - t0
    log(f"set-up: {len(traits)} traits {steps['traits']:.2f} s")
    t0 = time.perf_counter()
    ds0 = SummaryStatsDataset.from_dense_blocks(
        panel.blocks, *traits[0], block_size=int(cfg['block_size']),
        quantize=bool(cfg['quantize']), device=device)
    _sync(device)
    steps['pack'] = time.perf_counter() - t0
    log(f"set-up: pack and upload {steps['pack']:.2f} s")
    from viprs_tpu_torch.ops.cavi_cuda import build_for
    t0 = time.perf_counter()
    build_for(ds0.ld)
    steps['build'] = time.perf_counter() - t0
    log(f"set-up: kernel build {steps['build']:.2f} s")
    return SetUp(panel, traits, thetas, order, ds0, steps)


def run_cell(bench, workload, seed, seconds, trace, device='cuda',
             t_start=T_START):
    """Run the cell once. Returns (result dict, check lines)."""
    import torch
    from .entries import sync as _sync
    from . import reference

    device = torch.device(device)
    log(f"set-up: imports {time.perf_counter() - t_start:.2f} s")
    cell = bench.cell(workload)
    _, cfg = bench.config(cell['config'])
    traffic = bench.traffic(cell['traffic'])
    limits = bench.checks(workload)
    panel, traits, thetas, order, ds0, steps = set_up(cfg, traffic, seed,
                                                      device)
    pack_s, build_s = steps['pack'], steps['build']
    entry = bench.entry(traffic['entry'])(traffic, panel.m, device)
    np.random.seed(thetas[order[-1]])
    t0 = time.perf_counter()
    entry.warm_up(_dataset(ds0, traits[order[-1]]))
    _sync(device)
    log(f"set-up: warm-up fit {time.perf_counter() - t0:.2f} s")
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' \
        else None
    rec = RunRecord(panel, cfg, entry.planes, kind,
                    os.path.join(bench.here, 'metrics'))
    rec.pack_s, rec.build_s = pack_s, build_s

    # ---------------------------------------------------------- window
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        span = torch.profiler.record_function
    else:
        span = _no_span
    errors, last = [], None
    _sync(device)
    t_w = time.perf_counter()
    rec.setup_s = t_w - t_start
    try:
        with span('portbench.window'):
            while True:
                k = order[len(rec.fits) % len(order)]
                np.random.seed(thetas[k])
                fit, handle = entry.run(_dataset(ds0, traits[k]), span)
                rec.fits.append(fit)
                if time.perf_counter() - t_w >= seconds and \
                        len(rec.fits) % len(order) == 0:
                    last = (k, handle)
                    break
                del handle
            _sync(device)
    except (RuntimeError, ValueError) as e:
        errors.append(f"fit {len(rec.fits)}: {type(e).__name__}: {e}")
    rec.window_s = time.perf_counter() - t_w
    if device.type == 'cuda':
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    for i, f in enumerate(rec.fits):
        log(f"fit {i}: trait {order[i % len(order)]}, {f.seconds:.3f} s, "
            f"nit max {int(f.nit.max())}, sum {int(f.nit.sum())}"
            + ('' if f.bma_s is None else f", bma {f.bma_s:.4f} s"))
    log(f"window {rec.window_s:.3f} s, {len(rec.fits)} fits, set-up "
        f"{rec.setup_s:.2f} s")
    t0 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
        from .trace import read_profile
        rec.timeline = read_profile(prof)
        del prof
        log(f"trace read {time.perf_counter() - t0:.2f} s")
    found = forbidden_modules()
    if found:
        return None, [f"forbidden modules loaded: {', '.join(found)}"]

    # ---------------------------------------------------------- judge
    # the window's last fit, whose trait the run's seed decides (the order);
    # its answers are read now, the program's state is then freed and the
    # reference builds its LD where the program's was
    numbers = {}
    if last is not None:
        k, handle = last
        out = entry.answers(handle)
        del handle, last
        del ds0
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref_ld = reference.RefLD(panel, bool(cfg['quantize']), device)
        sb, nn = traits[k]
        beta = np.concatenate([sb[c] for c in sorted(sb)])
        n = np.concatenate([nn[c] for c in sorted(nn)])
        numbers = entry.judge(ref_ld, out, beta, n)
        del ref_ld, entry
        log(f"judged the last fit (trait {k}): " + ', '.join(
            f"{name} {v!r}" for name, v in numbers.items()))
        log(f"judge {time.perf_counter() - t0:.2f} s")
    checks = {name: {'value': numbers.get(name, math.inf),
                     'limit': float(v['limit'])}
              for name, v in limits.items()}
    failed_checks = [name for name, c in checks.items()
                     if not c['value'] <= c['limit']]
    correct = not errors and not failed_checks and bool(numbers)
    attempted = len(rec.fits) + (1 if errors else 0)
    failed = (1 if errors else 0) + (1 if failed_checks else 0)

    # ---------------------------------------------------------- metrics
    metrics = {}
    for name in bench.metric_names(workload, trace):
        mod = bench.metric(name)
        v = mod.read(rec)
        if v is not None:
            metrics[name] = {'value': float(v),
                             'unit': bench.metric_spec(name)['unit']}
    if rec._counts is not None:
        c = rec._counts
        log(f"work counts: {c.nb} diagonal tiles, {int(c.diag_nz.sum())} "
            f"nonzero diagonal 32 x 32 blocks, {c.n_off} coupling tiles, "
            f"{int(c.off_nz.sum())} nonzero coupling blocks")
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': kind, 'count': 1, 'memory_peak_bytes': rec.peak_bytes}
    result = {'correct': bool(correct), 'attempted': int(attempted),
              'failed': int(failed), 'metrics': metrics, 'device': dev}
    if rec.timeline is not None:
        from .trace import top
        tl = rec.timeline
        dev['busy_s'] = tl.busy_s
        dev['window_s'] = tl.window_s
        result['breakdown'] = {
            'device_ops': [[n[:160], s] for n, s in top(tl.kernels)],
            'idle_gaps': [[n[:160], s] for n, s in top(tl.idle_by_host())]}
    result['setup_build_s'] = build_s
    lines = [f"error: {e}" for e in errors]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    result['checks'] = checks
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        log(f"the cell needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 2
    out = sys.stdout
    sys.stdout = sys.stderr          # stray prints stay off the result line
    try:
        result, lines = run_cell(bench, args.workload, args.seed,
                                 args.seconds, bool(args.trace))
    finally:
        sys.stdout = out
    if result is None:
        for line in lines:
            log(line)
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
