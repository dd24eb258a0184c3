#!/usr/bin/env python3
"""Fit bench.py's VIPRSMix(K=3) on one NVIDIA GPU with the viprs_tpu_torch
package of the checkout in the working directory, and time its
single-model kernels (K5/K6) on two states of that fit.

    cd <checkout> && python3 <path>/mix_probe.py --tag NAME

The single-model twin of mix_grid_probe.py: the checkout's own package,
chip_smoke.py helpers and bench.py are imported (the working directory
goes first on sys.path), so one copy of this script compares two
checkouts in one machine session: run it in each, in turns. It records,
in OUT/mix_probe_NAME.json (``--out``, chiprun_out by default) and on
stdout:

- the card's name and power limit, the build's seconds and ptxas report;
- VIPRSMix(ds, 'cuda', K=3).fit(max_iter=500) after np.random.seed(0),
  cold and warm: seconds, nit, h2 (repr), and the blocks the activity
  mask flags per iteration (quantiles);
- one warm fit under torch.profiler (device time by kernel, the device's
  busy share);
- on the fit's first-iteration state and on its state after LATER_ITERS
  iterations: cavi_sweep_mix_s1 (K5, every block, coupling included), its
  block sweep alone and with every 32 x 32 block flagged nonzero, its
  probes of 0 and 1 inner steps, the coupling pass alone on the sweep's
  output; cavi_sweep_mix_s1_skip (K6) at the fit's activity mask and at
  every 20th block, and its block sweep alone there: ms by CUDA events
  around the calls and around replays of a CUDA graph of one call (which
  leaves out the card's waits for the host), and a SHA-256 of each
  output's bytes (equal digests in two checkouts: bit-identical outputs).

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

#: The later state the kernels are also timed and digested on: the fit's
#: state after this many iterations (np.random.seed(0), as the fit).
LATER_ITERS = 60


def digest(*tensors):
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def graph_ms(fn, reps):
    """Mean device ms per call over ``reps`` replays of ``fn`` captured in
    a CUDA graph (CUDA events around the replays): unlike events around
    the calls themselves it leaves out the card's waits for the host. (The
    script's own copy: a parent checkout's chip_smoke.py may have none.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def quantiles(x):
    """Min, quartiles, max and mean of a list of counts."""
    a = np.asarray(x, float)
    return dict(zip(('min', 'q25', 'median', 'q75', 'max'),
                    np.quantile(a, [0, .25, .5, .75, 1]).tolist()),
                mean=float(a.mean()), n=int(a.size))


def kernel_runs(ds, st, h, blk):
    """The timed calls on one single-model state: name -> a function
    returning the outputs to digest."""
    import dataclasses
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.ops.cavi_mix import MixState
    ld = ds.ld
    dev = ld.device
    sb, nf = ds.device_inputs()
    lanes = MixState(*(x[None] for x in st))
    hl = h.lanes()
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    dense = dataclasses.replace(ld, diag_nz=torch.ones_like(ld.diag_nz))

    def sweep(x, mask, unit_diag, steps=8):
        return cavi_cuda.block_sweep_mix(
            x, lanes, sb, nf, hl, None, mask, unit_diag,
            'cavi_sweep_mix_s1_skip' if unit_diag else 'cavi_sweep_mix_s1',
            inner_steps=steps)

    def flat(out):
        return (*out[0], out[1])

    new, d = sweep(ld, ones, False)
    q_after = new.q
    n_blk = int(blk.sum())
    return {
        'K5': lambda: flat(cavi_cuda.cavi_sweep_mix_s1(ld, st, sb, nf, h)),
        'K5 sweep alone': lambda: flat(sweep(ld, ones, False)),
        'K5 sweep alone, every 32 x 32 block flagged':
            lambda: flat(sweep(dense, ones, False)),
        'K5 sweep alone, 0 inner steps':
            lambda: flat(sweep(ld, ones, False, 0)),
        'K5 sweep alone, 1 inner step':
            lambda: flat(sweep(ld, ones, False, 1)),
        'K5 coupling pass alone': lambda: (cavi_cuda.coupling_pass_s1(
            ld, q_after, d, ones),),
        f'K6 at the activity mask ({n_blk} blocks)': lambda: flat(
            cavi_cuda.cavi_sweep_mix_s1_skip(ld, st, sb, nf, h, blk)),
        f'K6 sweep alone at the activity mask ({n_blk} blocks)':
            lambda: flat(sweep(ld, blk, True)),
        f'K6 at every 20th block ({int(few.sum())} blocks)': lambda: flat(
            cavi_cuda.cavi_sweep_mix_s1_skip(ld, st, sb, nf, h, few)),
        f'K6 sweep alone at every 20th block ({int(few.sum())} blocks)':
            lambda: flat(sweep(ld, few, True)),
        f'K6 sweep alone at every 20th block, 0 inner steps':
            lambda: flat(sweep(ld, few, True, 0)),
        f'K6 sweep alone at every 20th block, 1 inner step':
            lambda: flat(sweep(ld, few, True, 1)),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tag', required=True,
                    help='name of this checkout in the output file')
    ap.add_argument('--out', default='chiprun_out',
                    help='directory of the record')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    import bench
    import chip_smoke as cs
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.model import VIPRSMix
    from viprs_tpu_torch.ops import _build, cavi_cuda, cavi_mix

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    rec = {'tag': args.tag, 'cwd': os.getcwd(), 'card': card}
    print(f"[{args.tag}] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, info = _build.build()
    rec['build_seconds'] = info['seconds']
    rec['build_source_seconds'] = info['source_seconds']
    rec['ptxas'] = [ln.strip() for ln in info['ptxas'].splitlines()
                    if 'registers' in ln or 'spill' in ln
                    or 'Compiling entry' in ln]
    print(f"[{args.tag}] build {info['seconds']:.1f} s "
          f"({info['source_seconds']})", flush=True)

    dev = torch.device('cuda', 0)
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(
        m_target=cs.FULL_M)
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True,
        device=dev)
    del ld_blocks
    ld = ds.ld

    def model():
        np.random.seed(0)
        return VIPRSMix(ds, 'cuda', K=cs.MIX_K)

    fits = {}
    for name in ('cold', 'warm'):
        m = model()
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        m.fit(max_iter=500)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = m.optim_result
        blocks = [int(a) for a in m._last_result.act_hist[1:]]
        fits[name] = dict(fit_s=dt, nit=int(r.nit),
                          h2=repr(float(m.get_heritability())),
                          ms_per_it=1e3 * dt / max(r.nit, 1),
                          message=r.message, blocks_per_it=blocks,
                          blocks_quantiles=quantiles(blocks),
                          launches={k: v for k, v in
                                    cavi_cuda.LAUNCHES.items() if v})
        f = fits[name]
        print(f"[{args.tag}] VIPRSMix(K={cs.MIX_K}) {name}: {dt:.3f} s, nit "
              f"{f['nit']} ({f['ms_per_it']:.2f} ms/it), h2 {f['h2']}, "
              f"launches {f['launches']}; K6 blocks per iteration "
              f"{f['blocks_quantiles']}", flush=True)
    rec['fits'] = fits
    rec['profile'] = cs.profile_fit(ds, dict(max_iter=500), make=model,
                                    trace_name=None)

    sb, nf = ds.device_inputs()
    states = {}
    m = model()
    m.initialize()
    states['first iteration'] = (m._state, m._hyper_dev())
    m = model()
    m.fit(max_iter=LATER_ITERS)
    states[f'after {LATER_ITERS} iterations'] = (m._state, m._hyper_dev())
    rec['kernels'] = {}
    for sname, (st, h) in states.items():
        blk = cavi_mix.mix_block_proposal_mask(ld, st, sb, nf, h).to(
            torch.int32)
        out = {}
        for name, fn in kernel_runs(ds, st, h, blk).items():
            ms = cs.time_ms(fn, reps=10)
            g = graph_ms(fn, reps=10)
            res = fn()
            out[name] = dict(ms=ms, graph_ms=g, sha256=digest(*res))
            print(f"[{args.tag}] {sname}: {name}: {ms:.3f} ms by events, "
                  f"{g:.3f} ms in a CUDA graph, outputs sha256 "
                  f"{out[name]['sha256'][:16]}", flush=True)
            del res
        rec['kernels'][sname] = out
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f'mix_probe_{args.tag}.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    print(f"[{args.tag}] done", flush=True)


if __name__ == '__main__':
    main()
