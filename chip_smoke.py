#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (viprs_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from viprs_tpu_torch/csrc with nvcc (sm_90a);
3. synthesize the genome-scale problem of bench.py (AR(1) LD blocks, B = 1024,
   int8) and pack it with the port's packer;
4. check each kernel against its plain PyTorch version on a few blocks cut
   from that genome (coupling tiles included): all blocks active, half
   active (quiescent blocks bit-exact), none active, the coupling pass
   against refresh_q, and a whole fit on the cut against the plain fit on
   the CPU;
5. fit the genome with VIPRS(ds, device='cuda').fit() as bench.py does
   (np.random.seed(0), max_iter=1000, tolerances 1e-6, patience 10), with the
   kernel launch counters reset just before and read just after; then the
   all-active configuration (sweep_impl='xla');
6. check and time each kernel against its plain version at the fit's shapes (all
   blocks active from the first iteration's state, and the skip branch at
   5% of the blocks active), and, under torch.profiler, the device time by
   kernel and the device's idle share over one warm fit.

The full record goes to chiprun_out/chip_smoke.json, the profiler's trace
to chiprun_out/fit_trace.json.

The second-to-last line is the kernels JSON object, the last line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: The JAX package's results on this genome, which do not depend on the
#: chip (BENCH_r05.json, BENCH.md): the hybrid fit's iterations and h2, and
#: the all-active loop's iterations.
REF_NIT, REF_H2, REF_NIT_ALL_ACTIVE = 96, 0.2156, 112
FULL_M = 1_100_000
#: The full record (chip_smoke.json) and the profiler trace go here.
OUT_DIR = 'chiprun_out'
#: Kernel vs plain version, relative to each value's own size: the error of
#: a quantity is max_i |kernel_i - plain_i| / max(|plain_i|, REL_FLOOR *
#: max|plain|). Most variants of the genome are not causal, with gamma near
#: pi ~ 2e-3 and |eta| of 1e-5 or less, so an absolute bound sized for the
#: causal ones would not see a fault on them; the floor keeps values that
#: are zero (eta_diff of a frozen variant) or rounding-sized from dividing
#: by ~0. The order of float32 sums differs between kernel and plain
#: version, so they agree to rounding, not bit for bit. Each bound is about
#: 10x the largest reading on an H100 over the cut and the genome's first
#: iteration: eta 9.2e-5, mu 7.8e-4, q 3.2e-3 (mu and q of a variant can
#: come from cancellation), gamma 2.2e-5, eta_diff 3.1e-5, coupling 2.1e-6.
REL_FLOOR = 1e-4
TOL = {'eta': 1e-3, 'mu': 1e-2, 'gamma': 3e-4, 'q': 3e-2, 'eta_diff': 3e-4}
TOL_COUPLING = 3e-5


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cut_blocks(ld, sel, device):
    """The LD of blocks ``sel`` (ascending) and the coupling tiles between
    them, renumbered, on ``device``."""
    import torch
    from viprs_tpu_torch.ops.block_ld import BlockLD
    sel = np.asarray(sel)
    pos = {int(b): i for i, b in enumerate(sel)}
    src = ld.off_src.cpu().numpy()
    dst = ld.off_dst.cpu().numpy()
    keep = [o for o in range(ld.n_off) if src[o] in pos and dst[o] in pos]
    idx = torch.as_tensor(sel, device=ld.device)
    off = ld.off_data.index_select(
        0, torch.as_tensor(keep, dtype=torch.long, device=ld.device))
    return BlockLD.from_numpy(
        ld.diag.index_select(0, idx).cpu().numpy(), off.cpu().numpy(),
        [pos[src[o]] for o in keep], [pos[dst[o]] for o in keep],
        ld.mask.index_select(0, idx).cpu().numpy(), ld.scale, device=device)


def errors(got, want):
    """(max abs error, max|plain|, relative error as in REL_FLOOR)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    den = want.abs().clamp_min(REL_FLOOR * scale) if scale > 0 else 1.0
    return float(diff.max()), scale, float((diff / den).max())


def check(tag, name, got, want, bound, abs_errs):
    """Hold ``got`` to ``want`` within ``bound`` (relative); print the
    errors and the scale, and record the absolute error."""
    e_abs, scale, e_rel = errors(got, want)
    abs_errs.append(e_abs)
    phase('check', f"{tag}: {name}: relative error {e_rel:.3e} (bound "
                   f"{bound:.0e}); max|kernel - plain| {e_abs:.3e}, "
                   f"max|plain| {scale:.3e}")
    if not e_rel <= bound:
        fail(f"{tag}: {name} differs from the plain version by {e_rel:.3e} "
             f"relative")


def check_state(tag, got, want, errs):
    """Compare two (state, eta_diff) pairs within TOL."""
    import torch
    (gs, gd), (ws, wd) = got, want
    pairs = {'eta': (gs.eta, ws.eta), 'mu': (gs.mu, ws.mu), 'q': (gs.q, ws.q),
             'gamma': (torch.sigmoid(gs.logits), torch.sigmoid(ws.logits)),
             'eta_diff': (gd, wd)}
    for k, (a, b) in pairs.items():
        check(tag, k, a, b, TOL[k], errs)


def time_ms(fn, reps, warmup=2):
    """Mean device ms per call over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    record = {'m_target': FULL_M}

    # ---- 1. the card ----
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ''
    if not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    # the plain versions are the reference: full float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record['card'] = card
    record['torch'] = torch.__version__
    record['cuda'] = torch.version.cuda

    # ---- 2. build ----
    from viprs_tpu_torch.ops import _build, cavi_cuda, cavi_torch
    from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
    t0 = time.perf_counter()
    _, info = _build.build()
    phase('build', f"nvcc {' '.join(_build.NVCC_FLAGS)}: "
                   f"{info['seconds']:.1f} s compile, "
                   f"{time.perf_counter() - t0:.1f} s with load -> "
                   f"{os.path.relpath(info['path'])}")
    for line in info['ptxas'].splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            phase('ptxas', line.strip())
    record['build_seconds'] = info['seconds']

    # ---- 3. the genome ----
    import bench
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.model import VIPRS
    t0 = time.perf_counter()
    ld_blocks, std_beta, n_per_snp = bench.synthesize_genome(
        m_target=FULL_M)
    t_syn = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=True,
        device=dev)
    del ld_blocks
    t_pack = time.perf_counter() - t0
    ld = ds.ld
    phase('data', f"synthesis {t_syn:.1f} s, packing+upload {t_pack:.1f} s: "
                  f"M={ds.m} NB={ld.nb} B={ld.block_size} n_off={ld.n_off} "
                  f"LD {ld.diag.numel() / 1e9:.3f}+{ld.off_data.numel() / 1e9:.3f}"
                  f" GB int8")
    record.update(m=ds.m, nb=ld.nb, n_off=ld.n_off, synth_s=t_syn,
                  pack_s=t_pack)
    if ld.n_off == 0:
        fail("the genome has no coupling tiles")

    # ---- 4. kernels against their plain versions ----
    src0 = int(ld.off_src[0])
    sel = np.arange(src0, min(src0 + 8, ld.nb))
    sub = cut_blocks(ld, sel, dev)
    sb, nf = (x.index_select(0, torch.as_tensor(sel, device=dev))
              for x in ds.device_inputs())
    rng = np.random.default_rng(0)
    S1 = (1, sub.nb, sub.block_size)
    pi = 0.002
    eta0 = torch.as_tensor(rng.standard_normal(S1) * 2e-3, dtype=torch.float32,
                           device=dev) * sub.mask
    state = CaviState(
        logits=torch.full(S1, math.log(pi / (1 - pi)), device=dev),
        mu=eta0 * 5.0, eta=eta0, q=cavi_torch.compute_q(sub, eta0))
    hyper = Hyper(*(torch.tensor([v], dtype=torch.float32, device=dev)
                    for v in (0.75, pi * ds.m / 0.25, pi, 0.0)))
    act = torch.ones(1, device=dev)
    phase('check', f"{sub.nb} blocks cut from the genome, {sub.n_off} "
                   f"coupling tiles, B={sub.block_size}, T=128, 8 inner steps")
    errs_sweep, errs_cpl = [], []

    got = cavi_cuda.cavi_sweep_s1(sub, state, sb, nf, hyper, act)
    want = cavi_torch.cavi_sweep(sub, state, sb, nf, hyper, act)
    check_state('all blocks active', got, want, errs_sweep)

    half = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    half[::2] = 1
    got = cavi_cuda.cavi_sweep_s1_skip(sub, state, sb, nf, hyper, act, half)
    st, d = cavi_torch.block_sweep(sub, state, sb, nf, hyper, act,
                                   blk_mask=half)
    want = (st._replace(q=cavi_torch.coupling_pass(sub, st.q, d, half)), d)
    check_state('half active', got, want, errs_sweep)
    quiet = half == 0
    for k in ('logits', 'mu', 'eta'):
        if not torch.equal(getattr(got[0], k)[0][quiet],
                           getattr(state, k)[0][quiet]):
            fail(f"half active: quiescent blocks' {k} changed")
    if not torch.equal(got[1][0][quiet], torch.zeros_like(got[1][0][quiet])):
        fail("half active: quiescent blocks report an eta change")
    phase('check', "half active: quiescent blocks bit-exact (logits, mu, "
                   "eta; eta_diff 0)")

    none = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    got = cavi_cuda.cavi_sweep_s1_skip(sub, state, sb, nf, hyper, act, none)
    for k in CaviState._fields:
        if not torch.equal(getattr(got[0], k), getattr(state, k)):
            fail(f"none active: {k} changed")
    phase('check', "none active: state bit-exact (logits, mu, eta, q)")

    diff = torch.as_tensor(rng.standard_normal(S1) * 1e-3,
                           dtype=torch.float32, device=dev) * sub.mask
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    check('coupling pass vs refresh_q', 'q',
          cavi_cuda.coupling_pass_s1(sub, state.q, diff, ones),
          cavi_torch.refresh_q(sub, state.q, diff), TOL_COUPLING, errs_cpl)
    torch.cuda.synchronize()

    # a whole fit on the cut: kernels on the card vs plain versions on the CPU
    fits = {}
    for where in ('cuda', 'cpu'):
        dsx = _dataset_from_cut(sub, sb, nf, torch.device(where))
        np.random.seed(0)
        fits[where] = VIPRS(dsx, where).fit(max_iter=300)
    gc, gp = fits['cuda'], fits['cpu']
    dh2 = abs(gc.get_heritability() - gp.get_heritability())
    phase('check', f"fit on the cut: nit {gc.optim_result.nit} (card) vs "
                   f"{gp.optim_result.nit} (plain, CPU); h2 "
                   f"{gc.get_heritability():.6f} vs {gp.get_heritability():.6f}"
                   f" (|diff| {dh2:.2e}, bound 1e-4)")
    if not (gc.optim_result.success and dh2 <= 1e-4
            and abs(gc.optim_result.nit - gp.optim_result.nit) <= 2):
        fail("the fit on the cut disagrees with the plain fit")
    record['checks'] = {'sweep_max_abs_err': max(errs_sweep),
                        'coupling_max_abs_err': max(errs_cpl),
                        'cut_fit_nit': [gc.optim_result.nit,
                                        gp.optim_result.nit],
                        'cut_fit_h2': [gc.get_heritability(),
                                       gp.get_heritability()]}

    # ---- 5. the genome-scale fit (the main path) ----
    fit_kw = dict(max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10)
    runs = {}
    n_warm = 5
    for name, kw in (('cold', {}),
                     *((f'warm{i}', {}) for i in range(n_warm)),
                     ('all_active', {'sweep_impl': 'xla'})):
        np.random.seed(0)
        torch.cuda.synchronize()
        if name == 'cold':
            cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        model = VIPRS(ds, 'cuda').fit(**fit_kw, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if name == 'cold':
            launches = dict(cavi_cuda.LAUNCHES)
        runs[name] = dict(seconds=dt, nit=model.optim_result.nit,
                          h2=model.get_heritability(),
                          success=bool(model.optim_result.success),
                          message=model.optim_result.message,
                          n_skip=model._n_skip)
        phase('fit', f"{name}: {dt:.3f} s, nit {model.optim_result.nit}, "
                     f"h2 {model.get_heritability():.6f}, skip-branch "
                     f"iterations {model._n_skip}, "
                     f"'{model.optim_result.message}'")
        if name == 'warm0':
            fitted = model
    cold, warm, alla = runs['cold'], runs['warm0'], runs['all_active']
    warm_s = sorted(runs[f'warm{i}']['seconds'] for i in range(n_warm))
    if any(runs[f'warm{i}']['nit'] != cold['nit'] for i in range(n_warm)):
        fail("repeated fits took different numbers of iterations")
    record['warm_median_s'] = warm_s[n_warm // 2]
    phase('fit', f"hybrid: nit {warm['nit']} (JAX package: {REF_NIT}), h2 "
                 f"{warm['h2']:.4f} (JAX package: {REF_H2}); all-active: nit "
                 f"{alla['nit']} (JAX package: {REF_NIT_ALL_ACTIVE}); "
                 f"launches {launches}; cold {cold['seconds']:.3f} s, warm "
                 f"median {warm_s[n_warm // 2]:.3f} s of {n_warm} (min "
                 f"{warm_s[0]:.3f}, max {warm_s[-1]:.3f}; "
                 f"{1e3 * warm_s[n_warm // 2] / max(warm['nit'], 1):.2f} ms/it)")
    record['fit'] = runs
    record['launches'] = launches

    if not (cold['success'] and warm['success']):
        fail(f"the fit did not converge: {warm['message']}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was never launched: {launches}")
    if warm['n_skip'] < 1:
        fail("no iteration took the skip branch")
    pip = np.concatenate([fitted.pip[c] for c in fitted.chromosomes])
    beta = np.concatenate([fitted.post_mean_beta[c]
                           for c in fitted.chromosomes])
    if pip.shape != (ds.m,) or beta.shape != (ds.m,) or \
            not (np.isfinite(pip).all() and np.isfinite(beta).all()):
        fail("posterior PIP/mean are not finite of shape (M,)")
    if not 0.0 < warm['h2'] < 1.0:
        fail(f"h2 {warm['h2']} out of (0, 1)")
    if abs(warm['h2'] - REF_H2) > 0.005:
        fail(f"h2 {warm['h2']} is not within 0.005 of {REF_H2}")

    # ---- 6. kernels against their plain versions at the fit's shapes:
    # results (from the first iteration's state) and times ----
    sb_f, nf_f = ds.device_inputs()
    fitted.initialize_theta(rng=np.random.RandomState(0))
    fitted.initialize_variational_parameters()
    st0 = fitted._state
    h0 = Hyper(*(torch.tensor([v], dtype=torch.float32, device=dev)
                 for v in fitted._hyper))
    all_blk = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    ms_sweep = time_ms(lambda: cavi_cuda.block_sweep_s1(
        ld, st0, sb_f, nf_f, h0, act, all_blk), reps=20)
    plain_sweep = time_ms(lambda: cavi_torch.block_sweep(
        ld, st0, sb_f, nf_f, h0, act), reps=3, warmup=1)
    st1, d1 = cavi_cuda.block_sweep_s1(ld, st0, sb_f, nf_f, h0, act, all_blk)
    check_state(f'all {ld.nb} blocks', (st1, d1),
                cavi_torch.block_sweep(ld, st0, sb_f, nf_f, h0, act),
                errs_sweep)
    ms_cpl = time_ms(lambda: cavi_cuda.coupling_pass_s1(ld, st1.q, d1,
                                                        all_blk), reps=20)
    plain_cpl = time_ms(lambda: cavi_torch.refresh_q(ld, st1.q, d1), reps=5)
    check(f'coupling pass over {ld.n_off} tiles vs refresh_q', 'q',
          cavi_cuda.coupling_pass_s1(ld, st1.q, d1, all_blk),
          cavi_torch.refresh_q(ld, st1.q, d1), TOL_COUPLING, errs_cpl)
    ld_gb = (ld.diag.numel() + ld.off_data.numel()) / 1e9
    phase('time', f"first-iteration state, all {ld.nb} blocks: block sweep "
                  f"{ms_sweep:.3f} ms (plain {plain_sweep:.3f} ms); coupling "
                  f"pass over {ld.n_off} tiles {ms_cpl:.3f} ms (plain "
                  f"{plain_cpl:.3f} ms); one-read floor of {ld_gb:.2f} GB at "
                  f"3.35 TB/s = {ld_gb / 3.35:.3f} ms")
    # the skip branch at 5% of the blocks active (the kernel pair vs plain)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    ms_skip = time_ms(lambda: cavi_cuda.cavi_sweep_s1_skip(
        ld, st0, sb_f, nf_f, h0, act, few), reps=20)
    plain_skip = time_ms(lambda: _plain_skip(ld, st0, sb_f, nf_f, h0, act,
                                             few), reps=5)
    check_state(f'{int(few.sum())} of {ld.nb} blocks active',
                cavi_cuda.cavi_sweep_s1_skip(ld, st0, sb_f, nf_f, h0, act, few),
                _plain_skip(ld, st0, sb_f, nf_f, h0, act, few), errs_sweep)
    phase('time', f"skip branch, {int(few.sum())} of {ld.nb} blocks active: "
                  f"sweep + coupling {ms_skip:.3f} ms (plain "
                  f"{plain_skip:.3f} ms)")
    record['times_ms'] = dict(block_sweep=ms_sweep, block_sweep_plain=plain_sweep,
                              coupling=ms_cpl, coupling_plain=plain_cpl,
                              skip_5pct=ms_skip, skip_5pct_plain=plain_skip)
    record['profile'] = profile_fit(ds, fit_kw)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump(record, f, indent=1, default=str)

    src = 'viprs_tpu_torch/csrc/cavi_s1.cu'
    print(json.dumps({'kernels': [
        {'name': 'cavi_block_sweep_s1', 'route': 'cuda', 'source': src,
         'replaces': 'viprs_tpu/ops/cavi_pallas.py:133',
         'launches': launches['cavi_block_sweep_s1'],
         'max_abs_err': max(errs_sweep), 'ms': ms_sweep,
         'plain_ms': plain_sweep},
        {'name': 'coupling_pass_s1', 'route': 'cuda', 'source': src,
         'replaces': 'viprs_tpu/ops/cavi_pallas.py:492',
         'launches': launches['coupling_pass_s1'],
         'max_abs_err': max(errs_cpl), 'ms': ms_cpl,
         'plain_ms': plain_cpl}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def _plain_skip(ld, state, sb, nf, hyper, act, blk):
    """The plain version of the skip branch (block sweep + coupling pass)."""
    from viprs_tpu_torch.ops import cavi_torch
    st, d = cavi_torch.block_sweep(ld, state, sb, nf, hyper, act,
                                   blk_mask=blk)
    return st._replace(q=cavi_torch.coupling_pass(ld, st.q, d, blk)), d


def profile_fit(ds, fit_kw):
    """One warm fit under torch.profiler: device time by kernel, and the
    device's busy share of the fit's wall time (the profiler's own cost
    included). The trace goes to OUT_DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from viprs_tpu_torch.model import VIPRS
    np.random.seed(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = VIPRS(ds, 'cuda').fit(**fit_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # kernel events only: a CPU-side op (aten::mul) also reports the
        # device time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    trace = os.path.join(OUT_DIR, 'fit_trace.json')
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(trace)
    if not rows:
        phase('profile', f"fit {wall:.3f} s under the profiler; device time "
                         f"not measured (no device events)")
        return {'wall_s': wall, 'device_s': None}
    phase('profile', f"fit {wall:.3f} s under the profiler, nit "
                     f"{model.optim_result.nit}: device busy {busy:.3f} s "
                     f"({100 * busy / wall:.1f}%), idle "
                     f"{100 * (1 - busy / wall):.1f}%; trace {trace}")
    for us, n, key in rows[:12]:
        phase('profile', f"{us / 1e3:9.3f} ms  {n:5d} calls  {key[:90]}")
    return {'wall_s': wall, 'device_s': busy, 'nit': model.optim_result.nit,
            'top': [(us / 1e3, n, key) for us, n, key in rows[:20]]}


def _dataset_from_cut(sub, sb, nf, device):
    """A one-chromosome dataset over the cut blocks (every lane of the cut
    that the LD mask marks real is a variant)."""
    import torch
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.ops.block_ld import BlockLD, BlockLayout
    mask = sub.mask.cpu().numpy()
    flat_index = np.nonzero(mask.reshape(-1))[0]
    layout = BlockLayout(chromosomes=[1], chrom_sizes=[len(flat_index)],
                         chrom_block_range=[(0, sub.nb)],
                         flat_index=flat_index, block_size=sub.block_size,
                         nb=sub.nb)
    ld = BlockLD.from_numpy(sub.diag.cpu().numpy(), sub.off_data.cpu().numpy(),
                            sub.off_src.cpu().numpy(),
                            sub.off_dst.cpu().numpy(), mask, sub.scale,
                            device=device)
    take = torch.as_tensor(flat_index)
    std_beta = {1: sb.cpu().reshape(-1)[take].double().numpy()}
    n_per_snp = {1: nf.cpu().reshape(-1)[take].double().numpy()}
    return SummaryStatsDataset(ld=ld, layout=layout, std_beta=std_beta,
                               n_per_snp=n_per_snp)


if __name__ == '__main__':
    main()
