#!/usr/bin/env python3
"""Fit bench.py's 20 x K=3 mixture grid on one NVIDIA GPU with the
viprs_tpu_torch package of the checkout in the working directory, and time
its lane kernel (K7/K8) on the fit's first-iteration state.

    cd <checkout> && python3 <path>/mix_grid_probe.py --tag NAME

The checkout's own package, chip_smoke.py helpers and bench.py are imported
(the working directory goes first on sys.path), so one copy of this script
compares two checkouts in one machine session: run it in each, in turns.
It records, in OUT/mix_grid_probe_NAME.json (``--out``, chiprun_out by
default; the profiler's trace under ``--trace-dir``) and on stdout:

- the card's name and power limit, and the build's seconds;
- VIPRSMixGrid(ds, HyperparameterGrid(pi_steps=20, h2_est=0.25,
  h2_se=0.05), 'cuda', K=3).fit(max_iter=500) cold after np.random.seed(0):
  seconds, chunk widths, and each lane's nit, h2 and final ELBO;
- one warm fit, and one under torch.profiler (device time by kernel, the
  device's busy share);
- cavi_sweep_mix_s (K7) at S = 20 and at its first 8 lanes, and
  cavi_sweep_mix_s_skip (K8) at the union mask and at every 20th block, on
  the grid's first-iteration state; and, on the first-iteration state of
  bench.py's 100-point VIPRSGrid, cavi_sweep_s (K3) at S = 100, 16 and 2,
  cavi_sweep_s_skip (K4) at every 20th block and coupling_pass_s at S = 2,
  8, 16, 20 and 100 on the block sweep's output: CUDA-event ms, and a
  SHA-256 of each output's bytes (equal digests in two checkouts:
  bit-identical outputs).

With ``--cells A,B`` it records instead, in OUT/grid_lanes_NAME.json, the
end point of each lane of the benchmark's grid fits: per named cell of
portbench, the peak device memory over packing and the fits, and per trait
of the cell's pool (drawn as the cell's traffic file says), ``VIPRSGrid(ds,
HyperparameterGrid(...), 'cuda').fit(max_iter)`` after ``np.random.seed``
of the trait's theta_0 seed, as the benchmark fits it: seconds, the loop
calls (width, iterations), the chunk widths, the lane-sweeps, and each
lane's nit, status, final ELBO (``float.hex``) and SHA-256 of its final
state (logits, mu, eta, q) and of its hyperparameters; equal digests in two
checkouts mean bit-identical lanes.

It imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def digest(*tensors):
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def card():
    """The card's name and power limit."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def trait_pool(panel, traffic):
    """The cell's pool of traits and the theta_0 seed of each, drawn from
    the traffic's pool seed as the benchmark draws them."""
    from portbench.panel import draw_trait
    t, pool = traffic['trait'], traffic['pool']
    rng = np.random.default_rng(int(pool['seed']))
    traits, thetas = [], []
    for _ in range(int(pool['size'])):
        traits.append(draw_trait(panel, rng, float(t['h2']),
                                 float(t['prop_causal']), float(t['n'])))
        thetas.append(int(rng.integers(0, 2 ** 32)))
    return traits, thetas


def grid_lanes(args, rec):
    """The ``--cells`` record: each lane's end point in the cells' grid
    fits."""
    import torch
    from portbench.panel import make_panel
    from portbench.run import Bench
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid
    from viprs_tpu_torch.ops.cavi_cuda import build_for

    dev = torch.device('cuda', 0)
    torch.zeros(1, device=dev)
    bench = Bench()
    rec['cells'] = {}
    for cell in args.cells.split(','):
        spec = bench.cell(cell)
        _, cfg = bench.config(spec['config'])
        traffic = bench.traffic(spec['traffic'])
        panel = make_panel(cfg)
        traits, thetas = trait_pool(panel, traffic)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ds0 = SummaryStatsDataset.from_dense_blocks(
            panel.blocks, *traits[0], block_size=int(cfg['block_size']),
            quantize=bool(cfg['quantize']), device=dev)
        del panel
        build_for(ds0.ld)
        grid = HyperparameterGrid(n_snps=ds0.m, **traffic['grid'])
        fits = []
        for k, (trait, theta) in enumerate(zip(traits, thetas)):
            np.random.seed(theta)
            g = VIPRSGrid(SummaryStatsDataset(
                ld=ds0.ld, layout=ds0.layout, std_beta=trait[0],
                n_per_snp=trait[1]), grid, 'cuda')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.fit(max_iter=int(traffic['max_iter']))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            fc, res = g.fit_counters, g._last_result
            hyper = np.stack([np.asarray(x, np.float64) for x in g._hyper])
            f = dict(trait=k, fit_s=dt,
                     calls=[[c.width, c.iterations] for c in fc.chunks],
                     chunk_widths=getattr(fc, 'outer_widths', None),
                     lane_sweeps=fc.lane_sweeps,
                     live_lane_sweeps=fc.live_lane_sweeps,
                     nit=res.nit.tolist(), status=res.status.tolist(),
                     elbo=[float(x).hex() for x in res.final_elbo],
                     state=[digest(*(x[s] for x in g._state))
                            for s in range(g.n_models)],
                     hyper=[hashlib.sha256(hyper[:, s].tobytes()).hexdigest()
                            for s in range(g.n_models)])
            fits.append(f)
            dead = 100.0 * (1 - f['live_lane_sweeps'] / f['lane_sweeps'])
            print(f"[{args.tag}] {cell} trait {k}: {dt:.3f} s, nit max "
                  f"{max(f['nit'])}, {len(f['calls'])} loop calls, dead "
                  f"lane-sweeps {dead:.2f}%, chunks {f['chunk_widths']}",
                  flush=True)
            del g
        peak = torch.cuda.max_memory_allocated(dev)
        rec['cells'][cell] = dict(fits=fits, peak_bytes=peak)
        print(f"[{args.tag}] {cell}: peak {peak / 2 ** 30:.4f} GiB",
              flush=True)
        del ds0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f'grid_lanes_{args.tag}.json')
    with open(path, 'w') as fh:
        json.dump(rec, fh)
    print(f"[{args.tag}] wrote {path}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tag', required=True,
                    help='name of this checkout in the output file')
    ap.add_argument('--out', default='chiprun_out',
                    help='directory of the record')
    ap.add_argument('--trace-dir', default=os.path.join('viprs_tpu_torch',
                                                        '_build'),
                    help='directory of the profiler trace (tens of MB)')
    ap.add_argument('--cells', default=None,
                    help='portbench grid cells (comma-separated): record '
                         'the end point of each lane of their fits instead')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    rec = {'tag': args.tag, 'cwd': os.getcwd(), 'card': card()}
    print(f"[{args.tag}] {rec['card']}", flush=True)
    if args.cells:
        grid_lanes(args, rec)
        return
    import bench
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid, VIPRSMixGrid
    from viprs_tpu_torch.ops import _build, cavi_cuda, cavi_mix
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

    torch.backends.cuda.matmul.allow_tf32 = False
    _, info = _build.build()
    rec['build_seconds'] = info['seconds']
    rec['ptxas'] = [ln.strip() for ln in info['ptxas'].splitlines()
                    if 'registers' in ln or 'spill' in ln
                    or 'Compiling entry' in ln]
    print(f"[{args.tag}] build {info['seconds']:.1f} s", flush=True)

    dev = torch.device('cuda', 0)
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(
        m_target=cs.FULL_M)
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True,
        device=dev)
    del ld_blocks
    ld = ds.ld

    def grid():
        np.random.seed(0)
        return VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m,
                                                   **cs.MIX_GRID_SPEC),
                            'cuda', K=cs.MIX_K)

    fits = {}
    for name in ('cold', 'warm'):
        g = grid()
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        g.fit(max_iter=500)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fits[name] = dict(
            fit_s=dt, widths=[c.width for c in g.fit_counters.chunks],
            nit=[int(r.nit) for r in g.optim_results],
            h2=[float(x) for x in g.get_heritability()],
            elbo=[float(x) for x in g.elbo()],
            valid=int(g.valid_terminated_models.sum()),
            launches={k: v for k, v in cavi_cuda.LAUNCHES.items() if v})
        f = fits[name]
        print(f"[{args.tag}] mixture grid {name}: {dt:.3f} s, nit max "
              f"{max(f['nit'])} ({1e3 * dt / max(f['nit']):.2f} ms/it), "
              f"widths {f['widths']}, valid {f['valid']}/20, launches "
              f"{f['launches']}", flush=True)
    print(f"[{args.tag}] per-lane nit {fits['cold']['nit']}", flush=True)
    print(f"[{args.tag}] per-lane h2 {fits['cold']['h2']}", flush=True)
    print(f"[{args.tag}] per-lane ELBO {fits['cold']['elbo']}", flush=True)
    rec['fits'] = fits

    g = grid()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.fit(max_iter=500)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cs.OUT_DIR = args.trace_dir
    rec['profile'] = cs._device_time(prof, wall,
                                     f'mix_grid_trace_{args.tag}.json')
    del prof

    # the lane kernel on the grid's first-iteration state
    g = grid()
    g.initialize()
    st, h = g._state, g._hyper_dev()
    sb, nf = ds.device_inputs()
    S = st.eta.shape[0]
    act = torch.ones(S, device=dev)
    union = (cavi_mix.mix_block_proposal_mask_batch(ld, st, sb, nf, h)
             .any(dim=0)).to(torch.int32)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    first8 = (MixState(*(x[:8].contiguous() for x in st)),
              MixHyper(*(x[:8] for x in h)), act[:8])
    runs = {
        'K7 S=20': lambda: cavi_cuda.cavi_sweep_mix_s(ld, st, sb, nf, h, act),
        'K7 S=8': lambda: cavi_cuda.cavi_sweep_mix_s(
            ld, first8[0], sb, nf, first8[1], first8[2]),
        f'K8 S=20 union mask ({int(union.sum())} blocks)':
            lambda: cavi_cuda.cavi_sweep_mix_s_skip(ld, st, sb, nf, h, act,
                                                    union),
        f'K8 S=20 every 20th block ({int(few.sum())} blocks)':
            lambda: cavi_cuda.cavi_sweep_mix_s_skip(ld, st, sb, nf, h, act,
                                                    few)}
    # the model grid's lane kernels on its first-iteration state
    np.random.seed(0)
    gg = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **cs.GRID_SPEC),
                   'cuda')
    gg.initialize_theta()
    gg.initialize_variational_parameters()
    gs, gh = gg._state, gg._hyper_dev()
    gact = torch.ones(gs.eta.shape[0], device=dev)
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)

    def lanes(n):
        return (CaviState(*(x[:n].contiguous() for x in gs)),
                Hyper(*(x[:n] for x in gh)), gact[:n])

    def k3(n):
        st_n, h_n, a_n = lanes(n)
        return lambda: cavi_cuda.cavi_sweep_s(ld, st_n, sb, nf, h_n, a_n)

    def coupling(n):
        q, d = (x[:n].contiguous() for x in (new.q, d1))
        return lambda: (cavi_cuda.coupling_pass_s(ld, q, d, ones),)

    new, d1 = cavi_cuda.block_sweep_s(ld, gs, sb, nf, gh, gact, ones)
    runs.update({f'K3 S={n}': k3(n) for n in (100, 16, 2)})
    runs[f'K4 S=100 every 20th block ({int(few.sum())} blocks)'] = \
        lambda: cavi_cuda.cavi_sweep_s_skip(ld, gs, sb, nf, gh, gact, few)
    runs.update({f'coupling_pass_s S={n}': coupling(n)
                 for n in (2, 8, 16, 20, 100)})
    rec['kernels'] = {}
    for name, fn in runs.items():
        ms = cs.time_ms(fn, reps=5)
        out = fn()
        flat = (*out[0], out[1]) if len(out) == 2 else out
        rec['kernels'][name] = dict(ms=ms, sha256=digest(*flat))
        print(f"[{args.tag}] {name}: {ms:.3f} ms, outputs sha256 "
              f"{rec['kernels'][name]['sha256'][:16]}", flush=True)
        del out, flat
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f'mix_grid_probe_{args.tag}.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print(f"[{args.tag}] done", flush=True)


if __name__ == '__main__':
    main()
