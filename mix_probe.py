#!/usr/bin/env python3
"""Fit one of bench.py's single-model configurations on one NVIDIA GPU
with the viprs_tpu_torch package of the checkout in the working directory,
and time its kernels on two states of that fit.

    cd <checkout> && python3 <path>/mix_probe.py --tag NAME [--model M]

``--model mix`` (the default): VIPRSMix(K=3) and its kernels K5/K6 with
the coupling pass; ``--model viprs``: the S = 1 VIPRS hybrid fit (bench.py's
headline) and its kernels K1/K2 with the coupling pass.

The single-model twin of mix_grid_probe.py: the checkout's own package,
chip_smoke.py helpers and bench.py are imported (the working directory
goes first on sys.path), so one copy of this script compares two
checkouts in one machine session: run it in each, in turns. It records,
in OUT/mix_probe_NAME.json (``--model viprs``: OUT/s1_probe_NAME.json;
OUT is ``--out``) and on stdout:

- the card's name and power limit, the build's seconds and ptxas report;
- the fit after np.random.seed(0), cold and warm: seconds, nit, h2 (repr),
  and the blocks the activity mask flags per iteration (quantiles):
  VIPRSMix(ds, 'cuda', K=3).fit(max_iter=500), or VIPRS(ds, 'cuda')
  .fit() with chip_smoke.py's phase-5 arguments (and the iterations on the
  skip branch);
- one warm fit under torch.profiler (device time by kernel, the device's
  busy share);
- on the fit's first-iteration state and on its state after LATER_ITERS
  iterations, each call's ms by CUDA events around the calls and around
  replays of a CUDA graph of one call (which leaves out the card's waits
  for the host), and a SHA-256 of each output's bytes (equal digests in
  two checkouts: bit-identical outputs). mix: cavi_sweep_mix_s1 (K5, every
  block, coupling included), its block sweep alone and with every 32 x 32
  block flagged nonzero, its probes of 0 and 1 inner steps, the coupling
  pass alone on the sweep's output; cavi_sweep_mix_s1_skip (K6) at the
  fit's activity mask and at every 20th block, and its block sweep alone
  there. viprs: cavi_sweep_s1 (K1, every block, coupling included), its
  block sweep alone, with every 32 x 32 block of the diagonal tiles
  flagged nonzero and (where the checkout's wrapper takes them) its probes
  of 0 and 1 inner steps; the coupling pass alone on the sweep's output
  over every tile, with every 32 x 32 block of the coupling tiles flagged
  nonzero, on dense random int8 tiles (seeded) with a third of their
  32 x 32 blocks zeroed; cavi_sweep_s1_skip
  (K2) at the hybrid's activity mask and at every 20th block, its block
  sweep alone and its coupling pass alone there.

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


def s1_kernel_runs(ds, st, h, blk):
    """The timed calls on one S = 1 VIPRS state (CaviState of (1, NB, B);
    ``blk`` the hybrid's (NB,) int32 activity mask): name -> a function
    returning the outputs to digest."""
    import dataclasses
    import inspect
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.ops.block_ld import coupling_slabs, nonzero_blocks
    ld = ds.ld
    dev = ld.device
    sb, nf = ds.device_inputs()
    act = torch.ones(1, device=dev)
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    dense = dataclasses.replace(ld, diag_nz=torch.ones_like(ld.diag_nz))
    # every 32 x 32 block of the coupling tiles flagged: the dense walk
    slabs = coupling_slabs(np.ones(tuple(ld.off_nz.shape), np.uint8),
                           ld.off_src.cpu().numpy(), ld.off_dst.cpu().numpy(),
                           ld.nb)
    dense_cpl = dataclasses.replace(
        ld, off_nz=torch.ones_like(ld.off_nz),
        cpl_slabs=torch.as_tensor(slabs, device=dev))
    # dense random coupling tiles with a third of their 32 x 32 blocks
    # zeroed: each row and column of a tile sums many flagged blocks
    g = torch.Generator(device=dev).manual_seed(0)
    n, B = ld.n_off, ld.block_size
    m = B // 32
    rb, cb, o = (torch.arange(k, device=dev) for k in (m, m, n))
    zero = (rb.view(1, m, 1, 1, 1) + 2 * cb.view(1, 1, 1, m, 1)
            + o.view(n, 1, 1, 1, 1)) % 3 == 0
    off = torch.randint(-127, 128, (n, m, 32, m, 32), generator=g,
                        device=dev, dtype=torch.int8).masked_fill(
        zero, 0).view(n, B, B)
    off_nz = nonzero_blocks(off)
    random_cpl = dataclasses.replace(
        ld, off_data=off, off_nz=off_nz,
        cpl_slabs=torch.as_tensor(coupling_slabs(
            off_nz.cpu().numpy(), ld.off_src.cpu().numpy(),
            ld.off_dst.cpu().numpy(), ld.nb), device=dev))
    probes = 'inner_steps' in inspect.signature(
        cavi_cuda.block_sweep_s1).parameters

    def sweep(x, mask, steps=None):
        kw = {} if steps is None else dict(inner_steps=steps)
        return cavi_cuda.block_sweep_s1(x, st, sb, nf, h, act, mask, **kw)

    def flat(out):
        return (*out[0], out[1])

    after = {}
    for name, mask in (('all', ones), ('mask', blk), ('few', few)):
        new, d = sweep(ld, mask)
        after[name] = (new.q, d, mask)

    def cpl(x, name):
        q, d, mask = after[name]
        return lambda: (cavi_cuda.coupling_pass_s1(x, q, d, mask),)

    n_blk, n_few = int(blk.sum()), int(few.sum())
    runs = {
        'K1': lambda: flat(cavi_cuda.cavi_sweep_s1(ld, st, sb, nf, h, act)),
        'K1 sweep alone': lambda: flat(sweep(ld, ones)),
        'K1 sweep alone, every 32 x 32 block flagged':
            lambda: flat(sweep(dense, ones)),
        'coupling pass alone, every tile': cpl(ld, 'all'),
        'coupling pass alone, every tile, every 32 x 32 block flagged':
            cpl(dense_cpl, 'all'),
        'coupling pass alone, every tile, dense random tiles with zero '
        'blocks': cpl(random_cpl, 'all'),
        f'K2 at the activity mask ({n_blk} blocks)': lambda: flat(
            cavi_cuda.cavi_sweep_s1_skip(ld, st, sb, nf, h, act, blk)),
        f'K2 sweep alone at the activity mask ({n_blk} blocks)':
            lambda: flat(sweep(ld, blk)),
        f'coupling pass alone at the activity mask ({n_blk} blocks)':
            cpl(ld, 'mask'),
        f'K2 at every 20th block ({n_few} blocks)': lambda: flat(
            cavi_cuda.cavi_sweep_s1_skip(ld, st, sb, nf, h, act, few)),
        f'K2 sweep alone at every 20th block ({n_few} blocks)':
            lambda: flat(sweep(ld, few)),
        f'coupling pass alone at every 20th block ({n_few} blocks)':
            cpl(ld, 'few'),
    }
    if probes:
        runs['K1 sweep alone, 0 inner steps'] = lambda: flat(sweep(ld, ones,
                                                                   0))
        runs['K1 sweep alone, 1 inner step'] = lambda: flat(sweep(ld, ones,
                                                                  1))
    return runs


def fit_record(tag, name, m, dt, blocks, extra=''):
    """The record of one timed fit of model m (``blocks``: the blocks its
    activity mask flagged per iteration), printed on one line."""
    from viprs_tpu_torch.ops import cavi_cuda
    r = m.optim_result
    blocks = [int(a) for a in blocks]
    rec = dict(fit_s=dt, nit=int(r.nit), h2=repr(float(m.get_heritability())),
               ms_per_it=1e3 * dt / max(r.nit, 1), message=r.message,
               blocks_per_it=blocks,
               blocks_quantiles=quantiles(blocks) if blocks else None,
               launches={k: v for k, v in cavi_cuda.LAUNCHES.items() if v})
    print(f"[{tag}] {name}: {dt:.3f} s, nit {rec['nit']} "
          f"({rec['ms_per_it']:.2f} ms/it), h2 {rec['h2']}{extra}, "
          f"launches {rec['launches']}; activity-masked blocks per "
          f"iteration {rec['blocks_quantiles']}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tag', required=True,
                    help='name of this checkout in the output file')
    ap.add_argument('--model', choices=('mix', 'viprs'), default='mix',
                    help='VIPRSMix(K=3) and K5/K6, or the S = 1 VIPRS '
                         'hybrid fit and K1/K2')
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
    from viprs_tpu_torch.model import VIPRS, VIPRSMix
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

    sb, nf = ds.device_inputs()
    if args.model == 'mix':
        def model():
            np.random.seed(0)
            return VIPRSMix(ds, 'cuda', K=cs.MIX_K)
        fit_kw = dict(max_iter=500)
        label = f'VIPRSMix(K={cs.MIX_K})'
    else:
        def model():
            np.random.seed(0)
            return VIPRS(ds, 'cuda')
        fit_kw = dict(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6,
                      patience=10)
        label = 'VIPRS (S = 1, hybrid)'

    fits = {}
    for name in ('cold', 'warm'):
        m = model()
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        m.fit(**fit_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if args.model == 'mix':
            fits[name] = fit_record(args.tag, f'{label} {name}', m, dt,
                                    m._last_result.act_hist[1:])
        else:
            fits[name] = fit_record(
                args.tag, f'{label} {name}', m, dt,
                m.fit_counters.active_blocks,
                f', skip-branch iterations {m.fit_counters.skip_iterations}')
            fits[name]['n_skip'] = m.fit_counters.skip_iterations
    rec['fits'] = fits
    rec['profile'] = cs.profile_fit(ds, fit_kw, make=model, trace_name=None)

    states = {}
    m = model()
    if args.model == 'mix':
        m.initialize()
    else:
        m.initialize_theta(rng=np.random.RandomState(0))
        m.initialize_variational_parameters()
    states['first iteration'] = (m._state, m._hyper_dev())
    m = model()
    m.fit(**{**fit_kw, 'max_iter': LATER_ITERS})
    states[f'after {LATER_ITERS} iterations'] = (m._state, m._hyper_dev())
    rec['kernels'] = {}
    for sname, (st, h) in states.items():
        if args.model == 'mix':
            blk = cavi_mix.mix_block_proposal_mask(ld, st, sb, nf, h)
            runs = kernel_runs(ds, st, h, blk.to(torch.int32))
        else:
            # the hybrid's gate at its default epsilon (x_abs_tol)
            blk = cavi_cuda.block_proposal_mask(ld, st, sb, nf, h,
                                                eps=fit_kw['x_abs_tol'])[0]
            runs = s1_kernel_runs(ds, st, h, blk.to(torch.int32))
        out = {}
        for name, fn in runs.items():
            ms = cs.time_ms(fn, reps=10)
            g = graph_ms(fn, reps=10)
            res = fn()
            out[name] = dict(ms=ms, graph_ms=g, sha256=digest(*res))
            print(f"[{args.tag}] {sname}: {name}: {ms:.3f} ms by events, "
                  f"{g:.3f} ms in a CUDA graph, outputs sha256 "
                  f"{out[name]['sha256'][:16]}", flush=True)
            del res
        rec['kernels'][sname] = out
        del runs
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    stem = 'mix_probe' if args.model == 'mix' else 's1_probe'
    with open(os.path.join(args.out, f'{stem}_{args.tag}.json'), 'w') as f:
        json.dump(rec, f, indent=1)
    print(f"[{args.tag}] done", flush=True)


if __name__ == '__main__':
    main()
