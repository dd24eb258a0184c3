#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (viprs_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from viprs_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together;
3. synthesize the genome-scale problem of bench.py (AR(1) LD blocks, B = 1024,
   int8) and pack it with the port's packer; F0: pack it a second time as
   float32 (quantize=False, the JAX package's default): its GB, nonzero
   32 x 32 blocks of the diagonal and coupling tiles (int8 beside them)
   and block slabs a coupling tile can change;
4. check each S = 1 kernel against its plain PyTorch version on a few blocks
   cut from that genome (coupling tiles included): all blocks active, half
   active (quiescent blocks bit-exact), none active, the coupling pass
   against refresh_q; on the cut and on the cut with a third of its 32 x 32
   blocks zeroed (inside and outside the (T, T) tiles and in the coupling
   tiles), K1 and K2 against their plain versions, the block sweep and the
   coupling pass with their real flags bit for bit (the sign of a zero
   included) against their dense walks (every 32 x 32 block flagged), the
   public coupling pass's input q untouched and the sweep's probe of 0
   inner steps leaving the state as it was; and a whole fit on the cut
   against the plain fit on the CPU;
5. fit the genome with VIPRS(ds, device='cuda').fit() as bench.py does
   (np.random.seed(0), max_iter=1000, tolerances 1e-6, patience 10), with the
   kernel launch counters reset just before and read just after; then the
   all-active configuration (sweep_impl='xla');
6. check and time each S = 1 kernel against its plain version at the fit's
   shapes (all blocks active from the first iteration's state, and the skip
   branch at 5% of the blocks active), also in CUDA graphs: the block sweep
   split by its probes of 0 and 1 inner steps, its dense rank-T walk and
   the coupling pass's dense walk timed and held bit for bit, the coupling
   pass in place and with its clone, K2 at 5% of the blocks with its sweep
   and its coupling part each alone; the -0.0 entries of q; and, under
   torch.profiler, the device time by kernel and the device's idle share
   over one warm fit;
G1. check the S-lane kernels (K3, K4) against their plain versions on the
   8-block cut at S = 100 with the bench grid's hyperparameter rows: all
   lanes and blocks active, half the lanes frozen (bit-exact), half the
   blocks flagged (quiescent blocks bit-exact), S = 3 and S = 13, lane
   independence (lanes 3, 50, 97 swept at S = 3, and the first lanes at
   either side of each lane tile's boundary, 4|5, 8|9, 16|17, 20|21, and at
   S = 101, bit-identical to the same lanes at S = 100), and the sweep with
   every 32 x 32 block flagged nonzero bit-identical to the sweep with the
   real flags (BlockLD.diag_nz); the coupling pass alone against refresh_q,
   its input q untouched, frozen lanes and the slabs no tile with a flagged end
   reaches bit-exact, and its lanes bit-identical at S = 3, on either side
   of each lane tile's boundary (4|5, 16|17, 32|33) and at S = 101;
G2. a 16-point grid fit on the cut, kernels on the card against the plain
   versions on the CPU, chunk_iters=2 so that lane compaction engages;
G3. the genome-scale grid exactly as bench.py: np.random.seed(0), the
   100-point HyperparameterGrid(pi_steps=20, sigma_epsilon_steps=5),
   VIPRSGrid(ds, grid, device='cuda').fit(max_iter=500) and
   bayesian_model_average, cold then warm (launch counters reset just before
   the cold fit and read just after its BMA); one fit with
   sweep_impl='skip'; select_best_model (ELBO) on a fresh fit, under
   torch.profiler;
G4. check and time the S-lane kernels against their plain versions at the
   genome's shapes at S = 100 (first iteration's state), against two bounds
   (every diagonal tile dense, and only its nonzero 32 x 32 blocks in the
   inner steps and the rank-T updates), with the sweep split into inner
   steps and the rest by probes of 0 and 1 inner steps, the dense rank-T
   walk (every block flagged) timed and held bit-identical, and the sweep
   at S = 8 and 9 (lane tiles 8 and 16); the coupling pass at S = 2, 8,
   16, 20 and 100 against refresh_q, one torch.bmm of the tile products
   and its bound, on the genome's tiles (mostly exact zeros, which it
   skips) and on dense random tiles of the same shapes (held to a float64
   run);
M1. check the single-model mixture kernels (K5, K6) against their plain
   versions on the 8-block cut at K = 3: all blocks, half the blocks
   flagged, none flagged (bit-exact); then on the cut and on the cut with a
   third of its off-diagonal 32 x 32 blocks zeroed (zero blocks inside and
   outside the (T, T) tiles, and in the coupling tiles), K5 and K6 against
   their plain versions and their sweeps with the real diag_nz
   bit-identical to the dense walk;
M2. fit the genome with VIPRSMix(ds, 'cuda', K=3).fit(max_iter=500) as
   bench.py does (np.random.seed(0)), cold then warm (the skip sweep K6),
   then with sweep_impl='xla' (K5), each with the launch counters reset just
   before and read just after; the blocks K6 sweeps per iteration
   (quantiles, histogram); one warm fit under torch.profiler (device time
   by kernel, the device's busy share);
M3. check the mixture lane kernels (K7, K8) against their plain versions on
   the cut at S = 20 and K = 3: half the lanes frozen (bit-exact), every
   lane frozen (state bit-exact), a union mask at about half the blocks
   (unflagged blocks bit-exact), lane independence (3 lanes swept at S = 3,
   and the first lanes at either side of each lane tile's boundary, 4|5,
   8|9, 20|21, bit-identical to the same lanes at S = 20), K7 and K8 with
   every 32 x 32 block flagged nonzero bit-identical to the real flags
   (BlockLD.diag_nz), and K7 at K = 1 and K = 8 (lane tiles 20 and 4);
M4. bench.py's mixture grid on the genome, VIPRSMixGrid(ds,
   HyperparameterGrid(pi_steps=20, h2_est=0.25, h2_se=0.05), K=3)
   .fit(max_iter=500), cold then warm (K7), then with sweep_impl='skip'
   (K8), launch counters as in M2; the cold fit's per-lane nit and h2 held
   bit for bit to the port's earlier runs; one warm fit under
   torch.profiler (device time by kernel, the device's busy share);
M5. check and time the four mixture kernels against their plain versions
   at the genome's shapes (the first iteration's state; CUDA events), and
   hold each kernel's error against a float64 run of its plain version to
   at most twice the float32 plain version's; each against two bounds
   (every diagonal tile dense, and only its nonzero 32 x 32 blocks in the
   inner steps and the rank-T updates); each block sweep alone, with its
   bounds, split into inner steps, rank-T updates and the rest by probes
   of 0 and 1 inner steps, the dense rank-T walk timed (and held
   bit-identical for K5, K6 and K7), K6's also at every 20th block; K7 at
   S = 8 and 20 (lane tiles 8 and 20), K6 and K8 at their masks and every
   20th block, K8 at every block; the coupling part of each alone, against
   its plain version, its bound and (every tile) torch.bmm.
F1. check the float32 instances of the single-model kernels on phase 4's 8
   blocks cut from the float32 packing against their plain versions with
   phase 4's and M1's bounds: K1, K2 (half the blocks flagged, none
   flagged bit-exact), coupling_pass_s1 in place and with its clone, K5 and
   K6 at K = 3 (unflagged blocks bit-exact); on the cut and on the cut with
   a third of its 32 x 32 blocks zeroed, every zero-block skip bit for bit
   (the sign of a zero included) against its dense walk; VIPRS and
   VIPRSMix(K=3) fits on the float32 cut, on the card against the CPU (h2
   within 1e-4, nit within 2);
F2. fit the float32 genome: VIPRS(ds32, 'cuda') with phase 5's arguments
   cold, warm (3 times) and 'xla'; VIPRSMix(ds32, 'cuda', K=3)
   .fit(max_iter=500) cold, warm and 'xla'; launch counters reset before
   each fit and read after it (the float32 instances launched, no int8
   one); every fit converges, repeated fits take the same nit, h2 within
   0.005 of the JAX package's and equal to the port's earlier float32 runs
   (PORT_F32_*), its gap to the int8 fit printed; one warm fit of each
   under torch.profiler;
F3. time the float32 instances on the float32 genome's first-iteration
   state by CUDA events and CUDA graphs beside their plain versions and
   bounds (4 bytes an element): K1's sweep over every block, alone and
   with its coupling pass; coupling_pass_s1 over every tile, in place and
   with its clone, beside torch.bmm of the float32 tiles; K2 at 57 blocks;
   K5 and K6 at K = 3, their sweeps and coupling parts alone.
F4. check the float32 instances of the lane kernels on phase 4's 8 blocks
   cut from the float32 packing with G1's and M3's bounds: K3 at S = 100, 3
   and 13 (frozen lanes bit-exact), K4 at half the blocks (unflagged blocks
   bit-exact), lane independence across each lane tile's boundary and at
   S = 101, the coupling pass alone (input q untouched, lane independence
   across its lane tiles), K7/K8 at S = 20, K = 3 and K7 at K = 1 and 8,
   each block sweep's zero-block skip bit for bit against its dense walk;
   on the cut and on the cut with a third of its 32 x 32 blocks zeroed, K3,
   K4, K7 and K8 at S = 20 against their plain versions and every
   zero-block skip (the block sweeps, the coupling pass) bit for bit, the
   sign of a zero included, against its dense walk; a 16-point VIPRSGrid
   fit and an 8-point VIPRSMixGrid(K=3) fit on the float32 cut, on the card
   against the CPU (h2 within 1e-4, nit within 2);
F5. G3 and M4 on the float32 genome: the 100-point grid + BMA cold, warm,
   sweep_impl='skip' and a fresh fit for select_best_model under
   torch.profiler, every lane converged, the BMA h2 within 0.005 of the
   int8 grid's and held bit for bit (PORT_F32_GRID_BMA_H2); the 20 x K=3
   mixture grid cold, warm, 'skip' and a warm fit under torch.profiler,
   every lane converged, per-lane nit and h2 held bit for bit
   (PORT_F32_MIX_GRID_*); launch counters reset before each fit and read
   after it, and only the lane kernels' float32 instances launched;
F6. G4 and M5's timings of the lane kernels on the float32 genome's
   first-iteration state (S = 100 for K3/K4 and the coupling pass at
   S = 2, 8, 16, 20 and 100 beside torch.bmm of the float32 tiles; K7 at
   S = 8 and 20, K8 at its mask, every 20th block and every block), beside
   their plain versions and both bounds at 4 bytes an element.
P0. model selection on the 8-block cut and its float32 twin, the kernels
   on the card against the plain versions on the CPU, every fit at its own
   tolerances: the PUMAS split within 1e-9; viprs_fit's selection flow on
   a 16-point grid (split, fit, pseudo_validate, select_best_model by
   pseudo-R^2, restore, refit) with the CPU's selected row, pseudo-R^2
   within 1e-5 and h2 within 1e-6; GridSearch(VIPRS), one fit (K1/K2) a
   row of 4, with the CPU's selected row and ELBOs within 1e-6; the
   pathwise 16-point grid; the host-stepped VIPRSMix(K=3); every lane of
   these fits with the CPU's nit and status where its stop is clear of the
   thresholds (a factor 2 either way), the waived lanes counted;
   LDPredInf within 1e-6 and infer_lambda_min within 1e-9;
P1. the PUMAS split of the int8 genome (0.8, seed 0), timed, its identity
   n b = n_t b_train + (n - n_t) b_test on every variant and finite
   halves;
P2. viprs_fit's selection flow on the genome, int8 and float32 LD: the
   bench grid(100) fitted on the split (K3), pseudo_validate,
   select_best_model by pseudo-R^2, restore_full_sumstats and the hybrid
   refit of the selected row (K1/K2), each step timed, the launches per
   step (only the LD's tile type), the selected row and the refit's h2
   held to the port's earlier runs (PORT_PV_*, PORT_F32_PV_*);
P3. the pathwise grid(100) on the int8 genome: per-lane nit and status,
   the row with the best ELBO, seconds, and K1 launched once an iteration;
P4. the host-stepped VIPRSMix(K=3) on the int8 genome (K5 every
   iteration; h2 within 0.005 of the JAX package's) beside the fused fit,
   then GridSearch over VIPRSMix (one VIPRSMixGrid, K7) by pseudo-R^2 on
   bench.py's 20-point mixture grid after its model's split;
P5. LDPredInf (CG iterations, relative residual, seconds) and
   infer_lambda_min (value, seconds) on both packings.

Every kernel's line in the kernels JSON object carries its time, its
plain version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes it must move at 3.35 TB/s and its
FP32 operations at 67 TFLOP/s, the published H100 SXM peaks at 700 W; for
the coupling passes what the tiles' nonzero entries need, ``coupling_work``,
and for the sweeps the inner steps and rank-T updates over the diagonal
tiles' nonzero 32 x 32 blocks, ``sweep_work_nz``, with every tile dense
beside it as ``bound_ms_dense``)
and, for the coupling passes, the time of one PyTorch call computing the
tile products (``library_ms``; the sweeps have none). The S = 1 kernels'
lines, and the lane sweeps', also carry their time in a CUDA graph
(``graph_ms``). The float32 instances (F3, F6) have lines of their own,
their names ending in ``_f32``. ``paths`` gives each kernel's launches
on each selection path of P2-P4 that launched it.

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
#: The port's own S = 1 result on this genome, the same on every H100 run
#: (the kernels are deterministic): nit and h2 of the hybrid fit.
PORT_NIT, PORT_H2 = 129, 0.215610
#: The JAX package's grid(100)+BMA result (BENCH_r05.json): converged lanes.
REF_GRID_CONVERGED = 100
#: The port's own results on this genome, the same on every H100 run: the
#: grid(100) BMA h2, VIPRSMix(K=3)'s nit and h2, and the 20 x K=3 mixture
#: grid's per-lane nit and h2 (cold), held bit for bit.
PORT_GRID_BMA_H2 = 0.37959008051545073
PORT_MIX_NIT, PORT_MIX_H2 = 146, 0.217575
PORT_MIX_GRID_NIT = [55, 64, 75, 62, 67, 44, 77, 124, 80, 85, 71, 101, 84, 108, 103, 65, 85, 124, 54, 166]
PORT_MIX_GRID_H2 = [
    0.23906535928303982,
    0.24029268447233154,
    0.24162197274428351,
    0.24287991913596108,
    0.24427068825217135,
    0.24573229520511236,
    0.24731884832559292,
    0.24814162537240975,
    0.2510633883912738,
    0.2533964816167058,
    0.2564368785583893,
    0.26033314742592384,
    0.2655434538624474,
    0.2724864166116333,
    0.2819246590028597,
    0.29509728694243714,
    0.3140214325195417,
    0.3430690418728746,
    0.39072460728769903,
    0.2367098005806265]
#: The port's own results on the genome packed as float32 (quantize=False),
#: the same on every H100 run (F2): nit and h2 of the hybrid VIPRS fit and
#: of VIPRSMix(K=3).
PORT_F32_NIT, PORT_F32_H2 = 101, 0.215599
PORT_F32_MIX_NIT, PORT_F32_MIX_H2 = 146, 0.217578
#: ... and of the grids on it (F5), held bit for bit: grid(100)'s BMA h2,
#: and the 20 x K=3 mixture grid's per-lane nit and h2 (cold).
PORT_F32_GRID_BMA_H2 = 0.3795550011499705
PORT_F32_MIX_GRID_NIT = [67, 64, 75, 71, 97, 52, 85, 138, 74, 70, 71, 78, 84, 121, 160, 64, 72, 158, 110, 168]
PORT_F32_MIX_GRID_H2 = [
    0.23906582227311576,
    0.24029260427310972,
    0.24162015232855494,
    0.2428815178868986,
    0.24427261690601826,
    0.24573658109711052,
    0.24731619155636908,
    0.24821834840049006,
    0.25106427882907817,
    0.2533973419925087,
    0.2564832385269536,
    0.26030360727922525,
    0.265543104080443,
    0.27249056620432044,
    0.2819656073782317,
    0.29509285426724785,
    0.31401141295866347,
    0.343163073519603,
    0.39070596521829476,
    0.2366782755778169]
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
#: The same measure for the coupling pass alone on the q and eta change of
#: a block sweep of the cut (phase 4): the sweep leaves q near zero where
#: the random state's terms cancel, so the summation order's rounding (max
#: abs error 2.3e-10, as in the check above) reads larger against the
#: floor; about 10x the first reading on an H100, 1.4e-4.
TOL_COUPLING_SWEPT = 2e-3
#: The same measure for the S-lane kernels at S = 100 with the bench grid's
#: lanes (pi up to 9e-3, sigma_eps down to 0.65: more causal variants and
#: stronger coupling within a tile than at S = 1, so rounding is amplified
#: more): about 10x the largest first readings on an H100, eta 3.4e-4, mu
#: 3.6e-3, q 4.5e-3, gamma 3.3e-4, eta_diff 2.8e-4, coupling 2.2e-5, all of
#: them 1e-5 or less against the largest value (max abs error <= 7e-7).
TOL_S = {'eta': 3e-3, 'mu': 3e-2, 'gamma': 3e-3, 'q': 5e-2, 'eta_diff': 3e-3}
TOL_COUPLING_S = 2e-4
#: The same measure for the mixture kernels (K = 3) against their plain
#: versions, single model and S = 20 lanes, sweep and coupling tiles
#: together (eta_diff's floor from max|eta|): about 10x the largest readings
#: on an H100, which come from the lane kernel on the genome's first
#: iteration: eta 4.7e-4, mu 2.8e-2, q 1.1e-2, gamma 4.5e-4, eta_diff 4.7e-4
#: (max abs error 1.1e-6, 3e-5 of the largest value). The plain version in
#: float32 reads as far from a float64 run of it there (mu 2.6e-2, q 1.4e-2):
#: the small-pi lanes amplify rounding, so M5 also holds each kernel's error
#: against the float64 run to at most twice the float32 plain version's.
TOL_MIX = {'eta': 5e-3, 'mu': 3e-1, 'gamma': 5e-3, 'q': 1e-1, 'eta_diff': 5e-3}
#: M5: max|kernel - float64 plain| <= ACC_RATIO * max|float32 plain -
#: float64 plain| + ACC_FLOOR, per quantity.
ACC_RATIO, ACC_FLOOR = 2.0, 1e-9
#: G4, the S-lane coupling pass on dense random tiles, the same measure:
#: its sums run k in order over 1024 terms, against cuBLAS's blocked sums
#: in the plain version, so its rounding error is the larger one.
ACC_RATIO_DENSE = 8.0
#: The JAX package's VIPRSMix(K=3) result on this genome (BENCH_r05.json):
#: h2; the port is held within 0.005 of it.
REF_MIX_H2 = 0.2176
#: The mixture grid of bench.py (bench.py:199-204) and the mixture's K.
MIX_GRID_SPEC = dict(pi_steps=20, h2_est=0.25, h2_se=0.05)
MIX_K = 3
#: The card's published peaks (H100 SXM, 700 W) that bound_ms divides by.
HBM_TBS = 3.35


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


def errors(got, want, scale=None, ref=None):
    """(max abs error, max|plain|, relative error as in REL_FLOOR; the floor
    is taken from ``scale`` where given instead of max|plain|; with ``ref``
    each error is relative to |ref| and the floor from max|ref|)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel_to = want if ref is None else ref.double()
    scale = float(rel_to.abs().max()) if scale is None else scale
    den = rel_to.abs().clamp_min(REL_FLOOR * scale) if scale > 0 else 1.0
    return float(diff.max()), scale, float((diff / den).max())


def check(tag, name, got, want, bound, abs_errs, scale=None, ref=None):
    """Hold ``got`` to ``want`` within ``bound`` (relative, the floor from
    ``scale`` where given; relative to ``ref`` where given); print the
    errors and the scale, and record the absolute error."""
    label = 'max|plain|' if scale is None and ref is None else 'floor scale'
    e_abs, scale, e_rel = errors(got, want, scale, ref)
    abs_errs.append(e_abs)
    phase('check', f"{tag}: {name}: relative error {e_rel:.3e} (bound "
                   f"{bound:.0e}); max|kernel - plain| {e_abs:.3e}, "
                   f"{label} {scale:.3e}")
    if not e_rel <= bound:
        fail(f"{tag}: {name} differs from the plain version by {e_rel:.3e} "
             f"relative")


def check_state(tag, got, want, errs, tol=TOL, eta_in=None):
    """Compare two (state, eta_diff) pairs within ``tol``. With ``eta_in``
    (the swept state's eta; the float32 lane checks): the kernel's eta_diff
    must be its eta less eta_in bit for bit, so that its error is eta's, and
    that error is measured against |eta| (a second sweep's eta changes are
    small against eta, and an ulp of eta reads as a large error against
    the change itself)."""
    import torch
    (gs, gd), (ws, wd) = got, want
    pairs = {'eta': (gs.eta, ws.eta), 'mu': (gs.mu, ws.mu), 'q': (gs.q, ws.q),
             'gamma': (torch.sigmoid(gs.logits), torch.sigmoid(ws.logits))}
    for k, (a, b) in pairs.items():
        check(tag, k, a, b, tol[k], errs)
    if eta_in is not None and not same_bits(gd, gs.eta - eta_in):
        fail(f"{tag}: eta_diff is not eta less the swept eta bit for bit")
    check(tag, 'eta_diff', gd, wd, tol['eta_diff'], errs,
          ref=None if eta_in is None else ws.eta)


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


def graph_ms(fn, reps, warmup=2):
    """Mean device ms per call over ``reps`` replays of ``fn`` captured in
    a CUDA graph (CUDA events around the replays). Unlike ``time_ms`` it
    leaves out the card's waits for the host between calls, which bound a
    short call: the Python around a launch takes ~0.1-0.2 ms."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    del graph
    return ms


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
    t0 = time.perf_counter()
    _, info = _build.build()
    phase('build', f"nvcc {' '.join(_build.NVCC_FLAGS)}: "
                   f"{info['seconds']:.1f} s compile ("
                   + ', '.join(f"{k} {v:.1f} s" for k, v in
                               sorted(info['source_seconds'].items()))
                   + f"), {time.perf_counter() - t0:.1f} s with load -> "
                   f"{os.path.relpath(info['path'])}")
    ptxas = [line.strip() for line in info['ptxas'].splitlines()
             if 'registers' in line or 'spill' in line
             or 'Compiling entry' in line]
    for line in ptxas:
        if 'spill' not in line:
            phase('ptxas', line)
    record['build_seconds'] = info['seconds']
    record['build_source_seconds'] = info['source_seconds']
    record['ptxas'] = ptxas

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
    t_pack = time.perf_counter() - t0
    # F0: the same genome packed as float32 (quantize=False)
    t0 = time.perf_counter()
    ds32 = SummaryStatsDataset.from_dense_blocks(
        ld_blocks, std_beta, n_per_snp, block_size=1024, quantize=False,
        device=dev)
    t_pack32 = time.perf_counter() - t0
    del ld_blocks
    ld = ds.ld
    phase('data', f"synthesis {t_syn:.1f} s, packing+upload {t_pack:.1f} s: "
                  f"M={ds.m} NB={ld.nb} B={ld.block_size} n_off={ld.n_off} "
                  f"LD {ld.diag.numel() / 1e9:.3f}+{ld.off_data.numel() / 1e9:.3f}"
                  f" GB int8")
    nnz = int((ld.off_data != 0).sum())
    nz_blocks = int(ld.off_nz.sum())
    phase('data', f"coupling tiles: {nnz} nonzero entries of "
                  f"{ld.off_data.numel()}, in {nz_blocks} of "
                  f"{ld.off_nz.numel()} blocks of 32 x 32; "
                  f"{ld.cpl_slabs.numel()} block slabs of 128 coordinates "
                  f"that a tile can change")
    record.update(m=ds.m, nb=ld.nb, n_off=ld.n_off, synth_s=t_syn,
                  pack_s=t_pack, off_nnz=nnz, off_nz_blocks=nz_blocks,
                  cpl_slabs=ld.cpl_slabs.numel())
    if ld.n_off == 0:
        fail("the genome has no coupling tiles")
    ld32 = ds32.ld
    if ld32.diag.dtype != torch.float32 or ld32.nb != ld.nb or \
            ld32.n_off != ld.n_off:
        fail(f"F0: the float32 packing differs in shape or type: "
             f"{ld32.diag.dtype}, NB={ld32.nb}, n_off={ld32.n_off}")
    nz32, nz8 = _nz_blocks(ld32), _nz_blocks(ld)
    gb32 = (ld32.diag.numel() * 4 / 1e9, ld32.off_data.numel() * 4 / 1e9)
    phase('F0', f"float32 packing+upload {t_pack32:.1f} s: LD "
                f"{gb32[0]:.3f}+{gb32[1]:.3f} GB float32 (int8 "
                f"{ld.diag.numel() / 1e9:.3f}+{ld.off_data.numel() / 1e9:.3f}"
                f" GB); nonzero 32 x 32 blocks: diagonal tiles {nz32[0]} of "
                f"{ld32.diag_nz.numel()} (int8 {nz8[0]}), coupling tiles "
                f"{nz32[1]} of {ld32.off_nz.numel()} (int8 {nz8[1]}); "
                f"{ld32.cpl_slabs.numel()} block slabs of 128 coordinates "
                f"that a float32 tile can change (int8 "
                f"{ld.cpl_slabs.numel()})")
    record['f32_data'] = dict(pack_s=t_pack32, gb=gb32, diag_nz_blocks=nz32[0],
                              off_nz_blocks=nz32[1],
                              cpl_slabs=ld32.cpl_slabs.numel())

    # ---- 4. kernels against their plain versions ----
    src0 = int(ld.off_src[0])
    sel = np.arange(src0, min(src0 + 8, ld.nb))
    sub = cut_blocks(ld, sel, dev)
    sb, nf = (x.index_select(0, torch.as_tensor(sel, device=dev))
              for x in ds.device_inputs())
    act = torch.ones(1, device=dev)
    phase('check', f"{sub.nb} blocks cut from the genome, {sub.n_off} "
                   f"coupling tiles, B={sub.block_size}, T=128, 8 inner steps")
    errs_sweep, errs_cpl = [], []
    s1_cut_checks(sub, ds.m, sb, nf, errs_sweep, errs_cpl)
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
    if min(launches[k] for k in ('cavi_block_sweep_s1',
                                 'coupling_pass_s1')) < 1:
        fail(f"a kernel of the S = 1 path was never launched: {launches}")
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
    if warm['nit'] != PORT_NIT or abs(warm['h2'] - PORT_H2) > 5e-7:
        fail(f"the S = 1 fit moved: nit {warm['nit']}, h2 {warm['h2']:.6f} "
             f"(the port's earlier runs: {PORT_NIT}, {PORT_H2})")

    # ---- 6. kernels against their plain versions at the fit's shapes:
    # results (from the first iteration's state) and times ----
    sb_f, nf_f = ds.device_inputs()
    fitted.initialize_theta(rng=np.random.RandomState(0))
    fitted.initialize_variational_parameters()
    st0 = fitted._state
    h0 = fitted._hyper_dev()
    all_blk = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    # the kernels' times by CUDA events and in CUDA graphs
    p1 = s1_probes(ld, st0, sb_f, nf_f, h0, act, few)
    ms_sweep, ms_cpl = p1['sweep_event_ms'], p1['coupling_event_ms']
    ms_skip = p1['k2_5pct']['event_ms']
    plain_sweep = time_ms(lambda: cavi_torch.block_sweep(
        ld, st0, sb_f, nf_f, h0, act), reps=3, warmup=1)
    st1, d1 = cavi_cuda.block_sweep_s1(ld, st0, sb_f, nf_f, h0, act, all_blk)
    check_state(f'all {ld.nb} blocks', (st1, d1),
                cavi_torch.block_sweep(ld, st0, sb_f, nf_f, h0, act),
                errs_sweep)
    plain_cpl = time_ms(lambda: cavi_torch.refresh_q(ld, st1.q, d1), reps=5)
    check(f'coupling pass over {ld.n_off} tiles vs refresh_q', 'q',
          cavi_cuda.coupling_pass_s1(ld, st1.q, d1, all_blk),
          cavi_torch.refresh_q(ld, st1.q, d1), TOL_COUPLING, errs_cpl)
    lib_cpl = library_coupling_ms(ld, d1)
    # the bound by what this LD needs (its nonzero 32 x 32 blocks), and
    # with every diagonal tile dense
    b_sweep = bound(*sweep_work_nz(ld, 1, 4, 5)[:2])
    b_sweep_dense = bound(*sweep_work(ld, 1, 4, 5, ld.nb))
    b_cpl = bound(*coupling_work(ld, 1))
    phase('time', f"first-iteration state, all {ld.nb} blocks: block sweep "
                  f"{ms_sweep:.3f} ms (plain {plain_sweep:.3f} ms, bound "
                  f"{b_sweep[0]:.3f} ms by {b_sweep[1]} over the nonzero 32 "
                  f"x 32 blocks, every tile dense {b_sweep_dense[0]:.3f} ms "
                  f"by {b_sweep_dense[1]}); coupling pass over "
                  f"{ld.n_off} tiles {ms_cpl:.3f} ms (plain {plain_cpl:.3f} "
                  f"ms, one torch.bmm of the tile products {lib_cpl:.3f} ms, "
                  f"bound {b_cpl[0]:.3f} ms by {b_cpl[1]})")
    # the skip branch at 5% of the blocks active (the kernel pair vs plain)
    plain_skip = time_ms(lambda: _plain_skip(ld, st0, sb_f, nf_f, h0, act,
                                             few), reps=5)
    check_state(f'{int(few.sum())} of {ld.nb} blocks active',
                cavi_cuda.cavi_sweep_s1_skip(ld, st0, sb_f, nf_f, h0, act, few),
                _plain_skip(ld, st0, sb_f, nf_f, h0, act, few), errs_sweep)
    b_skip = bound(*_add(sweep_work_nz(ld, 1, 4, 5, few)[:2],
                         coupling_work(ld, 1, few)))
    b_skip_dense = bound(*_add(sweep_work(ld, 1, 4, 5, int(few.sum())),
                               coupling_work(ld, 1, few)))
    phase('time', f"skip branch, {int(few.sum())} of {ld.nb} blocks active, "
                  f"{_tiles_touching(ld, few)} coupling tiles: sweep + "
                  f"coupling {ms_skip:.3f} ms (plain {plain_skip:.3f} ms, "
                  f"bound {b_skip[0]:.3f} ms by {b_skip[1]} over the "
                  f"nonzero 32 x 32 blocks, every tile dense "
                  f"{b_skip_dense[0]:.3f} ms)")
    record['times_ms'] = dict(block_sweep=ms_sweep, block_sweep_plain=plain_sweep,
                              block_sweep_bound=b_sweep,
                              block_sweep_bound_dense=b_sweep_dense,
                              coupling=ms_cpl,
                              coupling_plain=plain_cpl, coupling_library=lib_cpl,
                              coupling_bound=b_cpl, skip_5pct=ms_skip,
                              skip_5pct_plain=plain_skip,
                              skip_5pct_bound=b_skip,
                              skip_5pct_bound_dense=b_skip_dense)
    record['s1_probes'] = p1
    record['profile'] = profile_fit(ds, fit_kw)

    # ---- G1-G4: the model grid (S lanes) ----
    errs_s, errs_cpl_s = [], []
    record['grid_checks'] = grid_checks(ds, sub, sb, nf, errs_s, errs_cpl_s)
    record['grid_cut_fit'] = grid_cut_fit(sub, sb, nf)
    record['grid'] = grid_genome(ds)
    record['grid_times_ms'] = grid_times(ds, errs_s, errs_cpl_s)
    g_launch = record['grid']['launches']

    # ---- M1-M5: the mixture prior (VIPRSMix, VIPRSMixGrid) ----
    errs_mix = {k: [] for k in MIX_KERNELS}
    record['mix_checks'] = mix_checks(ds, sub, sb, nf, errs_mix)
    record['mix'] = mix_genome(ds)
    record['mix_grid'] = mix_grid_genome(ds)
    record['mix_times_ms'] = mix_times(ds, errs_mix)
    m_launch = {
        'cavi_sweep_mix_s1': record['mix']["sweep_impl='xla'"]['launches'],
        'cavi_sweep_mix_s1_skip': record['mix']['cold']['launches'],
        'cavi_sweep_mix_s': record['mix_grid']['cold']['launches'],
        'cavi_sweep_mix_s_skip':
            record['mix_grid']["sweep_impl='skip'"]['launches']}

    # ---- F1-F3: float32 LD (the float32 instances) ----
    errs32 = {k: [] for k in F32_KERNELS}
    sub32 = f32_checks(ld32, sel, sb, nf, ds.m, errs32)
    record['f32_cut_fits'] = f32_cut_fits(sub32, sb, nf)
    del sub32
    record['f32'] = f32_genome(ds32, fit_kw)
    record['f32_times_ms'] = f32_times(ds32, errs32)
    f32_launch = record['f32']['launches']

    # ---- F4-F6: float32 LD, the grid models (the lane kernels' float32
    # instances) ----
    sub32 = f32_lane_checks(ds32, sel, sb, nf, errs32)
    record['f32_grid_cut_fits'] = f32_grid_cut_fits(sub32, sb, nf)
    del sub32
    record['f32_grid'] = grid_genome(ds32)
    record['f32_mix_grid'] = mix_grid_genome(ds32)
    record['f32_grid_times_ms'] = grid_times(
        ds32, errs32['cavi_block_sweep_s_f32'], errs32['coupling_pass_s_f32'])
    record['f32_mix_times_ms'] = mix_times(
        ds32, {k: errs32[k + '_f32'] for k in ('cavi_sweep_mix_s',
                                               'cavi_sweep_mix_s_skip')},
        names=('cavi_sweep_mix_s', 'cavi_sweep_mix_s_skip'))
    f32_launch.update(
        cavi_block_sweep_s_f32=record['f32_grid']['launches'][
            'cavi_block_sweep_s_f32'],
        coupling_pass_s_f32=record['f32_grid']['launches'][
            'coupling_pass_s_f32'],
        cavi_sweep_mix_s_f32=record['f32_mix_grid']['cold']['launches'][
            'cavi_sweep_mix_s_f32'],
        cavi_sweep_mix_s_skip_f32=record['f32_mix_grid']["sweep_impl='skip'"][
            'launches']['cavi_sweep_mix_s_skip_f32'])

    # ---- P0-P5: model selection (the PUMAS split, pseudo-validation,
    # the pathwise grid, the host-stepped mixture loop, LDPredInf) ----
    paths = {}
    sub32 = cut_blocks(ld32, sel, dev)
    record['select_cut'] = {'int8': select_cut_checks(sub, sb, nf, paths),
                            'float32': select_cut_checks(sub32, sb, nf,
                                                         paths)}
    del sub32
    record['select'] = select_genome(ds, paths)
    record['select_f32'] = select_genome(ds32, paths)
    record['pathwise'] = pathwise_genome(ds, paths)
    record['mix_select'] = mix_select_genome(ds, paths)
    record['ldpred_lambda'] = {'int8': ldpred_lambda_genome(ds),
                               'float32': ldpred_lambda_genome(ds32)}
    record['select_paths'] = paths

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
        json.dump(record, f, indent=1, default=str)

    def entry(name, source, replaces, launches, err, ms, plain, bnd, lib):
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': f'viprs_tpu/ops/cavi_pallas.py:{replaces}',
                'launches': launches, 'max_abs_err': err, 'ms': ms,
                'plain_ms': plain, 'bound_ms': bnd[0], 'bound_by': bnd[1],
                'library_ms': lib}

    src = 'viprs_tpu_torch/csrc/cavi_s1.cu'
    src_s = 'viprs_tpu_torch/csrc/cavi_s.cu'
    t1, gt, mt = record['times_ms'], record['grid_times_ms'], \
        record['mix_times_ms']
    kernels = [
        dict(entry('cavi_block_sweep_s1', src, 133,
                   launches['cavi_block_sweep_s1'], max(errs_sweep),
                   t1['block_sweep'], t1['block_sweep_plain'],
                   t1['block_sweep_bound'], None),
             bound_ms_dense=t1['block_sweep_bound_dense'][0],
             graph_ms=p1['sweep_graph_ms']),
        dict(entry('coupling_pass_s1', src, 492, launches['coupling_pass_s1'],
                   max(errs_cpl), t1['coupling'], t1['coupling_plain'],
                   t1['coupling_bound'], t1['coupling_library']),
             graph_ms=p1['coupling_graph_ms']),
        dict(entry('cavi_block_sweep_s', src_s, 49,
                   g_launch['cavi_block_sweep_s'], max(errs_s),
                   gt['block_sweep'], gt['block_sweep_plain'],
                   gt['block_sweep_bound'], None),
             bound_ms_dense=gt['block_sweep_bound_dense'][0],
             graph_ms=gt['block_sweep_graph']),
        entry('coupling_pass_s', src_s, 1191, g_launch['coupling_pass_s'],
              max(errs_cpl_s), gt['coupling'], gt['coupling_plain'],
              gt['coupling_bound'], gt['coupling_library'])]
    for name, (replaces, lanes, _) in MIX_KERNELS.items():
        r = mt[name]
        e = entry(name, 'viprs_tpu_torch/csrc/'
                  + ('mix_lane.cuh' if lanes else 'cavi_mix.cu'),
                  replaces.rsplit(':', 1)[1], m_launch[name][name],
                  max(errs_mix[name]), r['ms'], r['plain_ms'],
                  (r['bound_ms'], r['bound_by']), None)
        # bound_ms counts the nonzero 32 x 32 blocks, this every tile dense
        e['bound_ms_dense'] = r['bound_ms_dense']
        kernels.append(e)
    f3 = record['f32_times_ms']
    f3_rows = {
        'cavi_block_sweep_s1_f32': (f3['sweep']['event_ms'],
                                    f3['sweep']['plain_ms'],
                                    f3['sweep']['bound'],
                                    f3['sweep']['bound_dense'],
                                    f3['sweep']['graph_ms'], None),
        'coupling_pass_s1_f32': (f3['coupling']['event_ms'],
                                 f3['coupling']['plain_ms'],
                                 f3['coupling']['bound'], None,
                                 f3['coupling']['graph_ms'],
                                 f3['coupling']['library_ms']),
        **{name: (f3[name[:-4]]['ms'], f3[name[:-4]]['plain_ms'],
                  f3[name[:-4]]['bound'], f3[name[:-4]]['bound_dense'],
                  f3[name[:-4]]['graph_ms'], None)
           for name in ('cavi_sweep_mix_s1_f32',
                        'cavi_sweep_mix_s1_skip_f32')}}
    gt32, mt32 = record['f32_grid_times_ms'], record['f32_mix_times_ms']
    f6_rows = {
        'cavi_block_sweep_s_f32': (
            gt32['block_sweep'], gt32['block_sweep_plain'],
            gt32['block_sweep_bound'], gt32['block_sweep_bound_dense'],
            gt32['block_sweep_graph'], None),
        'coupling_pass_s_f32': (
            gt32['coupling'], gt32['coupling_plain'], gt32['coupling_bound'],
            None, None, gt32['coupling_library']),
        **{name + '_f32': (mt32[name]['ms'], mt32[name]['plain_ms'],
                           (mt32[name]['bound_ms'], mt32[name]['bound_by']),
                           (mt32[name]['bound_ms_dense'],),
                           mt32[name]['graph_ms'], None)
           for name in ('cavi_sweep_mix_s', 'cavi_sweep_mix_s_skip')}}
    for name, (replaces, source) in F32_KERNELS.items():
        ms, plain, bnd, dense, graph, lib = {**f3_rows, **f6_rows}[name]
        e = entry(name, f'viprs_tpu_torch/csrc/{source}', replaces,
                  f32_launch[name], max(errs32[name]), ms, plain, bnd, lib)
        if graph is not None:
            e['graph_ms'] = graph
        if dense is not None:
            e['bound_ms_dense'] = dense[0]
        kernels.append(e)
    # the launches of each kernel on each selection path (P0, P2-P4)
    for e in kernels:
        e['paths'] = {p: paths[p][e['name']] for p in SELECT_PATHS
                      if paths.get(p, {}).get(e['name'])}
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def _same_state(tag, got, want):
    """Fail unless two (state, eta_diff) pairs are equal bit for bit."""
    for name, a, b in zip((*got[0]._fields, 'eta_diff'), (*got[0], got[1]),
                          (*want[0], want[1])):
        if not same_bits(a, b):
            fail(f"{tag}: {name} differs "
                 + ("only in the sign of a zero" if a.equal(b) else
                    "in value"))


def s1_cut_checks(sub, m, sb, nf, errs_sweep, errs_cpl, prefix='',
                  need_zeros=True):
    """Phase 4 (F1 with ``prefix`` 'F1 ' on the float32 cut): the S = 1
    kernels on the cut from phase 4's random state (``_s1_state``) against
    their plain versions: K1 with every block active; K2 with half of them
    (quiescent blocks bit-exact, their eta change 0) and with none (the
    state bit-exact); the coupling pass in place and with its clone (the
    same bits) against refresh_q; then ``s1_zero_block_checks``."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    from viprs_tpu_torch.ops.cavi_torch import CaviState
    dev = sub.device
    rng = np.random.default_rng(0)
    state, hyper = _s1_state(sub, m, rng)
    act = torch.ones(1, device=dev)
    check_state(f'{prefix}all blocks active', cavi_cuda.cavi_sweep_s1(
        sub, state, sb, nf, hyper, act), cavi_torch.cavi_sweep(
        sub, state, sb, nf, hyper, act), errs_sweep)
    half = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    half[::2] = 1
    got = cavi_cuda.cavi_sweep_s1_skip(sub, state, sb, nf, hyper, act, half)
    check_state(f'{prefix}half active', got,
                _plain_skip(sub, state, sb, nf, hyper, act, half), errs_sweep)
    quiet = half == 0
    for k in ('logits', 'mu', 'eta'):
        if not same_bits(getattr(got[0], k)[0][quiet],
                         getattr(state, k)[0][quiet]):
            fail(f"{prefix}half active: quiescent blocks' {k} changed")
    if bool(got[1][0][quiet].any()):
        fail(f"{prefix}half active: quiescent blocks report an eta change")
    phase('check', f"{prefix}half active: quiescent blocks bit-exact "
                   f"(logits, mu, eta; eta_diff 0)")
    got = cavi_cuda.cavi_sweep_s1_skip(sub, state, sb, nf, hyper, act,
                                       torch.zeros_like(half))
    for k in CaviState._fields:
        if not same_bits(getattr(got[0], k), getattr(state, k)):
            fail(f"{prefix}none active: {k} changed")
    phase('check', f"{prefix}none active: state bit-exact (logits, mu, eta, "
                   f"q)")
    diff = torch.as_tensor(rng.standard_normal(state.q.shape) * 1e-3,
                           dtype=torch.float32, device=dev) * sub.mask
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    q = cavi_cuda.coupling_pass_s1(sub, state.q, diff, ones)
    q_in = state.q.clone()
    if cavi_cuda.coupling_pass_s1_inplace(sub, q_in, diff, ones) is not q_in \
            or not same_bits(q, q_in):
        fail(f"{prefix}coupling_pass_s1 in place and with its clone differ")
    check(f'{prefix}coupling pass vs refresh_q', 'q', q,
          cavi_torch.refresh_q(sub, state.q, diff), TOL_COUPLING, errs_cpl)
    s1_zero_block_checks(sub, state, sb, nf, hyper, act, errs_sweep,
                         errs_cpl, prefix, need_zeros)


def s1_zero_block_checks(sub, state, sb, nf, hyper, act, errs_sweep,
                         errs_cpl, prefix='', need_zeros=True):
    """Phase 4 (F1 with ``prefix`` 'F1 ' on the float32 cut), the S = 1
    kernels on the cut and on the cut with a third of its 32 x 32 blocks
    zeroed (inside and outside the (T, T) tiles, and in the coupling
    tiles): K1 and K2 (half the blocks flagged) against their plain
    versions; the block sweep and the coupling pass with their real flags
    (BlockLD.diag_nz, off_nz and cpl_slabs) bit for bit, the sign of a zero
    included, against their dense walks (every 32 x 32 block flagged); the
    public coupling pass's input q untouched; the block sweep's probe of 0
    inner steps leaving the state as it was. The cut itself must hold zero
    blocks of every kind unless ``need_zeros`` is false (float32 tiles
    hold few); the zeroed cut always must."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    dev = sub.device
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    half = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    half[::2] = 1
    for tag, x, need in (('the cut', sub, need_zeros),
                         ('the cut, blocks zeroed', zero_blocks_cut(sub),
                          True)):
        n_in, n_out = zero_blocks(x)
        n_cz, n_cnz = int((x.off_nz == 0).sum()), int(x.off_nz.sum())
        if need and not (n_in and n_out and n_cz and n_cnz):
            fail(f"{prefix or 'phase 4, '}{tag}: the diagonal tiles need "
                 f"zero 32 x 32 blocks inside ({n_in}) and outside ({n_out}) "
                 f"the (T, T) tiles, the coupling tiles zero ({n_cz}) and "
                 f"nonzero ({n_cnz}) ones")
        st = state._replace(q=cavi_torch.compute_q(x, state.eta))
        check_state(f'{prefix}K1 on {tag}', cavi_cuda.cavi_sweep_s1(
            x, st, sb, nf, hyper, act), cavi_torch.cavi_sweep(
            x, st, sb, nf, hyper, act), errs_sweep)
        check_state(f'{prefix}K2 on {tag}, half the blocks flagged',
                    cavi_cuda.cavi_sweep_s1_skip(x, st, sb, nf, hyper, act,
                                                 half),
                    _plain_skip(x, st, sb, nf, hyper, act, half), errs_sweep)
        dense_d, dense_c = dense_diag_flags(x), dense_off_flags(x)
        for label, mask in (('every block', ones), ('half the blocks', half)):
            t = f'{tag}, {label}'
            got = cavi_cuda.block_sweep_s1(x, st, sb, nf, hyper, act, mask)
            _same_state(f'{prefix}K1 block sweep on {t}: the real diag_nz '
                        f'against the dense walk', got,
                        cavi_cuda.block_sweep_s1(dense_d, st, sb, nf, hyper,
                                                 act, mask))
            new, d = got
            q0 = new.q.clone()
            q = cavi_cuda.coupling_pass_s1(x, new.q, d, mask)
            if not same_bits(new.q, q0):
                fail(f"{prefix}coupling_pass_s1 on {t} wrote its input q")
            if not same_bits(q, cavi_cuda.coupling_pass_s1(dense_c, new.q, d,
                                                           mask)):
                fail(f"{prefix}coupling_pass_s1 on {t}: q with the real "
                     f"off_nz differs from the dense walk's")
            check(f'{prefix}coupling_pass_s1 on {t}', 'q', q,
                  cavi_torch.coupling_pass(x, new.q, d, mask),
                  TOL_COUPLING_SWEPT, errs_cpl)
        new, d = cavi_cuda.block_sweep_s1(x, st, sb, nf, hyper, act, ones,
                                          inner_steps=0)
        if any(not torch.equal(a, b) for a, b in zip(new, st)) or \
                bool(d.any()):
            fail(f"{prefix}K1 block sweep on {tag}, 0 inner steps: the state "
                 f"moved")
        phase('check', f"{prefix}{tag} ({n_in} zero 32 x 32 blocks inside "
                       f"the (T, T) tiles, {n_out} outside, {n_cz} zero and "
                       f"{n_cnz} nonzero in the {x.n_off} coupling tiles): K1 "
                       f"and K2 within bounds; the block sweep and the "
                       f"coupling pass, every block and half the blocks "
                       f"flagged, bit for bit their dense walks; the "
                       f"coupling pass's input q untouched; 0 inner steps: "
                       f"state unchanged")


def s1_probes(ld, st0, sb, nf, h0, act, few):
    """Phase 6, the S = 1 kernels on the genome from the first iteration's
    state, by CUDA events and in a CUDA graph (which leaves out the card's
    waits for the host): the block sweep over every block, split by its
    probes of 0 and 1 inner steps, and its dense rank-T walk (every 32 x 32
    block flagged), held bit for bit; the coupling pass over every tile in
    place (the kernel), with its clone (the public wrapper) and its dense
    walk, held bit for bit; K2 at every 20th block, its sweep alone and its
    coupling part alone; the -0 entries of q before and after the sweep."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    ones = torch.ones(ld.nb, dtype=torch.int32, device=ld.device)
    inplace = cavi_cuda.coupling_pass_s1_inplace

    def sweep(x, mask, k=8):
        return cavi_cuda.block_sweep_s1(x, st0, sb, nf, h0, act, mask,
                                        inner_steps=k)

    dense_ld = dense_diag_flags(ld)
    probes = ((ld, 8), (dense_ld, 8), (ld, 0), (ld, 1))
    ev = [time_ms(lambda: sweep(x, ones, k), reps=10) for x, k in probes]
    gr = [graph_ms(lambda: sweep(x, ones, k), reps=10) for x, k in probes]
    _same_state('K1 block sweep on the genome: the real diag_nz against the '
                'dense walk', sweep(ld, ones), sweep(dense_ld, ones))
    del dense_ld
    step = (gr[0] - gr[3]) / 7
    rec = dict(sweep_event_ms=ev[0], sweep_graph_ms=gr[0],
               split_graph_ms=dict(inner_steps=8 * step, rest=gr[3] - step,
                                   every_block_extra=gr[1] - gr[0]),
               probe_event_ms=dict(every_block=ev[1], steps_0=ev[2],
                                   steps_1=ev[3]),
               probe_graph_ms=dict(every_block=gr[1], steps_0=gr[2],
                                   steps_1=gr[3]))
    phase('time', f"K1 block sweep, all {ld.nb} blocks: {gr[0]:.3f} ms in a "
                  f"CUDA graph, {ev[0]:.3f} ms by CUDA events; split (graph): "
                  f"8 inner steps {8 * step:.3f}, the rest (tile staging, "
                  f"set-up, rank-T updates, state I/O) {gr[3] - step:.3f}; "
                  f"probes (graph, events): 0 steps {gr[2]:.3f}, {ev[2]:.3f}; "
                  f"1 step {gr[3]:.3f}, {ev[3]:.3f}; every 32 x 32 block "
                  f"flagged {gr[1]:.3f}, {ev[1]:.3f} (bit for bit the same "
                  f"outputs)")

    new, d = sweep(ld, ones)
    dense_c = dense_off_flags(ld)
    scratch = new.q.clone()
    rec.update(
        coupling_event_ms=time_ms(lambda: inplace(ld, scratch, d, ones),
                                  reps=20),
        coupling_graph_ms=graph_ms(lambda: inplace(ld, scratch, d, ones),
                                   reps=20),
        coupling_clone_event_ms=time_ms(lambda: cavi_cuda.coupling_pass_s1(
            ld, new.q, d, ones), reps=20),
        coupling_dense_graph_ms=graph_ms(
            lambda: inplace(dense_c, scratch, d, ones), reps=10),
        neg_zeros_q=dict(state=neg_zeros(st0.q), after_sweep=neg_zeros(new.q)))
    if not same_bits(cavi_cuda.coupling_pass_s1(ld, new.q, d, ones),
                     cavi_cuda.coupling_pass_s1(dense_c, new.q, d, ones)):
        fail("coupling_pass_s1 on the genome: q with the real off_nz differs "
             "from the dense walk's")
    del scratch, dense_c
    phase('time', f"coupling_pass_s1, {ld.n_off} tiles, "
                  f"{ld.cpl_slabs.numel()} block slabs: in place "
                  f"{rec['coupling_graph_ms']:.4f} ms in a CUDA graph, "
                  f"{rec['coupling_event_ms']:.4f} ms by CUDA events; with "
                  f"the clone {rec['coupling_clone_event_ms']:.4f} ms by "
                  f"events; every 32 x 32 block flagged (the dense walk, bit "
                  f"for bit the same q) {rec['coupling_dense_graph_ms']:.3f} "
                  f"ms in a CUDA graph; q holds {rec['neg_zeros_q']['state']} "
                  f"-0.0 entries before the sweep, "
                  f"{rec['neg_zeros_q']['after_sweep']} after it")

    n_few = int(few.sum())
    new, d = sweep(ld, few)
    scratch = new.q.clone()
    k2 = lambda: cavi_cuda.cavi_sweep_s1_skip(ld, st0, sb, nf, h0, act, few)
    rec['k2_5pct'] = dict(
        event_ms=time_ms(k2, reps=20), graph_ms=graph_ms(k2, reps=20),
        sweep_event_ms=time_ms(lambda: sweep(ld, few), reps=20),
        sweep_graph_ms=graph_ms(lambda: sweep(ld, few), reps=20),
        coupling_event_ms=time_ms(lambda: inplace(ld, scratch, d, few),
                                  reps=20),
        coupling_graph_ms=graph_ms(lambda: inplace(ld, scratch, d, few),
                                   reps=20),
        sweep_bound=bound(*sweep_work_nz(ld, 1, 4, 5, few)[:2]),
        coupling_bound=bound(*coupling_work(ld, 1, few)),
        library_coupling_ms=library_coupling_ms(ld, d, bmm_tiles(
            ld, _tiles_on(ld, few))),
        blocks=n_few, tiles=_tiles_touching(ld, few))
    del scratch
    r = rec['k2_5pct']
    phase('time', f"K2 at {n_few} of {ld.nb} blocks, {r['tiles']} coupling "
                  f"tiles: {r['graph_ms']:.3f} ms in a CUDA graph, "
                  f"{r['event_ms']:.3f} ms by CUDA events; its sweep alone "
                  f"{r['sweep_graph_ms']:.3f} ms (graph), "
                  f"{r['sweep_event_ms']:.3f} ms (events), bound "
                  f"{r['sweep_bound'][0]:.4f} ms by {r['sweep_bound'][1]}; "
                  f"its coupling part alone {r['coupling_graph_ms']:.4f} ms "
                  f"(graph), {r['coupling_event_ms']:.4f} ms (events), bound "
                  f"{r['coupling_bound'][0]:.5f} ms by "
                  f"{r['coupling_bound'][1]}, torch.bmm of its tiles "
                  f"{r['library_coupling_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return rec


#: The bench grid (bench.py:170-172), and the H100 SXM's published FP32 peak
#: (700 W) that bound_ms divides operations by.
GRID_SPEC = dict(pi_steps=20, sigma_epsilon_steps=5, h2_est=0.25, h2_se=0.05)
FP32_TFLOPS = 67.0


def grid_hyper(m, S, dev, rows=None):
    """Per-lane hyperparameters from the bench grid's rows (pi, sigma_eps;
    tau_beta as the model's initialization makes it from them), the lanes
    ``rows`` (default the first S)."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.ops.cavi_torch import Hyper
    g = HyperparameterGrid(n_snps=m, **GRID_SPEC).combine_grids()
    rows = np.arange(S) if rows is None else np.asarray(rows)
    pi = np.array([g[r]['pi'] for r in rows])
    se = np.array([g[r]['sigma_epsilon'] for r in rows])
    tau = pi * m / np.maximum(0.01, 1.0 - se)
    return Hyper(*(torch.tensor(x, dtype=torch.float32, device=dev)
                   for x in (se, tau, pi, np.zeros(len(rows)))))


def _lane_state(sub, S, rng, hyper):
    import torch
    from viprs_tpu_torch.ops import cavi_torch
    from viprs_tpu_torch.ops.cavi_torch import CaviState
    dev = sub.device
    shape = (S, sub.nb, sub.block_size)
    eta0 = torch.as_tensor(rng.standard_normal(shape) * 2e-3,
                           dtype=torch.float32, device=dev) * sub.mask
    pi = hyper.pi
    logit = (torch.log(pi) - torch.log1p(-pi))[:, None, None]
    return CaviState(logits=(logit + 0.3 * torch.as_tensor(
        rng.standard_normal(shape), dtype=torch.float32, device=dev)),
        mu=eta0 * 5.0, eta=eta0, q=cavi_torch.compute_q(sub, eta0))


def _plain_lanes(sub, state, sb, nf, hyper, act, blk):
    from viprs_tpu_torch.ops import cavi_torch
    st, d = cavi_torch.block_sweep(sub, state, sb, nf, hyper, act,
                                   blk_mask=blk)
    return st._replace(q=cavi_torch.coupling_pass(sub, st.q, d, blk)), d


def _sub_hyper(h, idx):
    from viprs_tpu_torch.ops.cavi_torch import Hyper
    return Hyper(*(x[idx] for x in h))


def grid_checks(ds, sub, sb, nf, errs, errs_cpl, prefix=''):
    """G1 (F4 with ``prefix`` 'F4 ' on the float32 cut): the S-lane kernels
    against their plain versions on the cut."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    from viprs_tpu_torch.ops.cavi_torch import CaviState
    dev = sub.device
    S = 100
    rng = np.random.default_rng(1)
    hyper = grid_hyper(ds.m, S, dev)
    state = _lane_state(sub, S, rng, hyper)
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    act = torch.ones(S, device=dev)
    phase(prefix.strip() or 'G1',
          f"S = {S} lanes (bench grid rows), {sub.nb} blocks, {sub.n_off} "
          f"coupling tiles, {sub.diag.dtype} tiles, lane tile "
          f"{cavi_cuda.sweep_lane_tile(S)}")
    rec = {}
    # float32 LD (F4): eta_diff held to eta less the swept eta (check_state)
    f32 = sub.diag.dtype == torch.float32

    full = cavi_cuda.cavi_sweep_s(sub, state, sb, nf, hyper, act)
    check_state(f'{prefix}S=100 all active', full,
                cavi_torch.cavi_sweep(sub, state, sb, nf, hyper, act), errs,
                TOL_S, state.eta if f32 else None)

    half_act = act.clone()
    half_act[1::2] = 0.0
    got = cavi_cuda.cavi_sweep_s(sub, state, sb, nf, hyper, half_act)
    check_state(f'{prefix}S=100 half the lanes frozen', got,
                cavi_torch.cavi_sweep(sub, state, sb, nf, hyper, half_act),
                errs, TOL_S, state.eta if f32 else None)
    for k in CaviState._fields:
        if not torch.equal(getattr(got[0], k)[1::2], getattr(state, k)[1::2]):
            fail(f"{prefix}frozen lanes: {k} changed")
    if bool(got[1][1::2].any()):
        fail(f"{prefix}frozen lanes report an eta change")
    phase('check', f"{prefix}S=100 frozen lanes bit-exact (logits, mu, eta, "
                   f"q; eta_diff 0)")

    # K4's mask: the union over the live lanes (half of them frozen) of
    # the proposal masks, at the gate epsilon that flags half the blocks
    blk = None
    for eps in np.geomspace(1e-8, 1e-1, 57):
        cand = cavi_torch.union_block_mask(cavi_cuda.block_proposal_mask(
            sub, full[0], sb, nf, hyper, eps=float(eps)), half_act)
        if blk is None or abs(int(cand.sum()) - sub.nb // 2) < \
                abs(int(blk.sum()) - sub.nb // 2):
            blk, blk_eps = cand, float(eps)
    blk = blk.to(torch.int32)
    if not 0 < int(blk.sum()) < sub.nb:
        fail(f"{prefix}no gate epsilon splits the cut's blocks")
    st_k4 = full[0]
    got = cavi_cuda.cavi_sweep_s_skip(sub, st_k4, sb, nf, hyper, half_act,
                                      blk)
    check_state(f'{prefix}K4, S=100, union mask at eps {blk_eps:.1e} flags '
                f'{int(blk.sum())} of {sub.nb} blocks', got,
                _plain_lanes(sub, st_k4, sb, nf, hyper, half_act, blk), errs,
                TOL_S, st_k4.eta if f32 else None)
    state_k4 = st_k4
    quiet = blk == 0
    for k in ('logits', 'mu', 'eta'):
        if not torch.equal(getattr(got[0], k)[:, quiet],
                           getattr(state_k4, k)[:, quiet]):
            fail(f"{prefix}K4: quiescent blocks' {k} changed")
        if not torch.equal(getattr(got[0], k)[1::2],
                           getattr(state_k4, k)[1::2]):
            fail(f"{prefix}K4: frozen lanes' {k} changed")
    if bool(got[1][:, quiet].any()) or bool(got[1][1::2].any()):
        fail(f"{prefix}K4: quiescent blocks or frozen lanes report an eta "
             f"change")
    phase('check', f"{prefix}K4 quiescent blocks and frozen lanes bit-exact "
                   f"(logits, mu, eta; eta_diff 0)")

    diff = torch.as_tensor(rng.standard_normal(tuple(state.q.shape)) * 1e-3,
                           dtype=torch.float32, device=dev) * sub.mask
    coupling_checks(sub, state.q, diff, errs_cpl, prefix)

    for n in (3, 13):
        idx = torch.arange(n, device=dev) * 7
        st_n = CaviState(*(x[idx].contiguous() for x in state))
        h_n = _sub_hyper(hyper, idx)
        a_n = torch.ones(n, device=dev)
        check_state(f'{prefix}S={n}', cavi_cuda.cavi_sweep_s(
            sub, st_n, sb, nf, h_n, a_n),
                    cavi_torch.cavi_sweep(sub, st_n, sb, nf, h_n, a_n), errs,
                    TOL_S, st_n.eta if f32 else None)

    widths = []
    for n in (3, *(L + e for L in cavi_cuda.SWEEP_LANE_TILES for e in (0, 1)),
              S + 1):
        lanes = torch.tensor([3, 50, 97], device=dev) if n == 3 else \
            torch.arange(n, device=dev) % S
        got = cavi_cuda.cavi_sweep_s(
            sub, CaviState(*(x[lanes].contiguous() for x in state)), sb, nf,
            _sub_hyper(hyper, lanes), torch.ones(n, device=dev))
        for name, a, b in zip((*CaviState._fields, 'eta_diff'),
                              (*got[0], got[1]), (*full[0], full[1])):
            if not torch.equal(a, b[lanes]):
                fail(f"{prefix}lane independence: {name} at S = {n} (lane "
                     f"tile {cavi_cuda.sweep_lane_tile(n)}) differs from the "
                     f"same lanes at S = {S}")
        widths.append(f"{n} ({cavi_cuda.sweep_lane_tile(n)})")
    phase('check', f"{prefix}lane independence: lanes 3, 50, 97 at S = 3 and "
                   f"the first lanes at S (lane tile) = "
                   f"{', '.join(widths[1:])} bit-identical to the same lanes "
                   f"at S = {S} (logits, mu, eta, q, eta_diff)")
    same_bits_dense_walk(prefix.strip() or 'G1', sub,
                         _k3_sweep(state, sb, nf, hyper, act))
    torch.cuda.synchronize()
    rec['sweep_max_abs_err'] = max(errs)
    rec['coupling_max_abs_err'] = max(errs_cpl)
    return rec


def coupling_checks(sub, q, diff, errs, prefix=''):
    """G1 (F4 with ``prefix`` 'F4 '), the S-lane coupling pass alone on the
    cut (S = 100 lanes): against refresh_q; its input q untouched; frozen
    lanes (a zero eta change) and the slabs that no tile with a flagged end
    reaches bit-exact; every lane bit-identical whatever the width it is
    applied at, across the lane tiles' boundaries and past the largest tile
    (S = 101)."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    dev = sub.device
    S = q.shape[0]
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    q0 = q.clone()
    full = cavi_cuda.coupling_pass_s(sub, q, diff, ones)
    check(f'{prefix}coupling_pass_s vs refresh_q, S={S}', 'q', full,
          cavi_torch.refresh_q(sub, q, diff), TOL_COUPLING_S, errs)
    if not torch.equal(q, q0):
        fail(f"{prefix}coupling_pass_s wrote its input q")

    frozen = diff.clone()
    frozen[1::2] = 0.0
    got = cavi_cuda.coupling_pass_s(sub, q, frozen, ones)
    check(f'{prefix}coupling_pass_s, S={S}, half the lanes frozen', 'q', got,
          cavi_torch.refresh_q(sub, q, frozen), TOL_COUPLING_S, errs)
    if not torch.equal(got[1::2], q[1::2]):
        fail(f"{prefix}coupling_pass_s: frozen lanes' q changed")

    blk = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    blk[int(sub.off_dst[0])] = 1
    got = cavi_cuda.coupling_pass_s(sub, q, diff, blk)
    check(f'{prefix}coupling_pass_s, S={S}, block {int(sub.off_dst[0])} '
          f'flagged', 'q', got, cavi_torch.coupling_pass(sub, q, diff, blk),
          TOL_COUPLING_S, errs)
    idle = ~_slabs_with_work(sub, blk).reshape(-1)
    view = (S, idle.numel(), 128)
    if not torch.equal(got.reshape(view)[:, idle], q.reshape(view)[:, idle]):
        fail(f"{prefix}coupling_pass_s: a slab that no tile with a flagged "
             f"end reaches changed")
    phase('check', f"{prefix}coupling_pass_s: input q untouched; frozen "
                   f"lanes and the {int(idle.sum())} of {idle.numel()} block "
                   f"slabs that no tile with a flagged end reaches bit-exact")

    widths = []
    for n in (3, *(L + e for L in cavi_cuda.COUPLING_LANE_TILES[:-1]
                   for e in (0, 1)), S + 1):
        lanes = torch.tensor([3, 50, 97], device=dev) if n == 3 else \
            torch.arange(n, device=dev) % S
        got = cavi_cuda.coupling_pass_s(sub, q[lanes].contiguous(),
                                        diff[lanes].contiguous(), ones)
        if not torch.equal(got, full[lanes]):
            fail(f"{prefix}coupling lane independence: S = {n} (lane tile "
                 f"{cavi_cuda.coupling_lane_tile(n)}) differs from the same "
                 f"lanes at S = {S}")
        widths.append(f"{n} ({cavi_cuda.coupling_lane_tile(n)})")
    phase('check', f"{prefix}coupling lane independence: lanes 3, 50, 97 at "
                   f"S = 3 "
                   f"and the first lanes at S (lane tile) = "
                   f"{', '.join(widths[1:])} bit-identical to the same lanes "
                   f"at S = {S}")


def grid_cut_fit(sub, sb, nf, tag='G2', nit_window=3):
    """G2 (F4 on the float32 cut): a 16-point grid fit on the cut, card
    against CPU: every lane valid, h2 within 1e-4, nit within
    ``nit_window``, the lanes compacted."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid
    fits = {}
    for key, where in (('card', 'cuda'), ('plain', 'cpu')):
        dsx = _dataset_from_cut(sub, sb, nf, torch.device(where))
        np.random.seed(0)
        grid = HyperparameterGrid(pi_steps=16, n_snps=dsx.m)
        t0 = time.perf_counter()
        fits[key] = VIPRSGrid(dsx, grid, where).fit(max_iter=300,
                                                      chunk_iters=2)
        fits[key + '_s'] = time.perf_counter() - t0
    gc, gp = fits['card'], fits['plain']
    nit_c, nit_p = gc._last_result.nit, gp._last_result.nit
    st_c, st_p = gc._last_result.status, gp._last_result.status
    h2_c, h2_p = gc.get_heritability(), gp.get_heritability()
    widths = ([w for w, *_ in gc._chunk_trace],
              [w for w, *_ in gp._chunk_trace])
    phase(tag, f"16-point grid on the {sub.diag.dtype} cut, chunk_iters=2: "
               f"card "
                f"{fits['card_s']:.1f} s, CPU {fits['plain_s']:.1f} s; "
                f"widths per chunk (card) {_runs(widths[0])}, (CPU) "
                f"{_runs(widths[1])}")
    for i in range(len(nit_c)):
        phase(tag, f"lane {i:2d}: nit {nit_c[i]:3d} vs {nit_p[i]:3d}, "
                    f"status {st_c[i]} vs {st_p[i]}, h2 {h2_c[i]:.6f} vs "
                    f"{h2_p[i]:.6f}")
    dh2 = float(np.max(np.abs(h2_c - h2_p)))
    dnit = int(np.max(np.abs(nit_c.astype(int) - nit_p)))
    if not (gc.valid_terminated_models.all() and gp.valid_terminated_models.all()
            and dh2 <= 1e-4 and dnit <= nit_window and min(widths[0]) < 16):
        fail(f"{tag}: the grid fit on the cut disagrees with the plain fit "
             f"(max |dh2| {dh2:.2e}, max |dnit| {dnit}) or did not compact")
    phase('check', f"{tag} grid fit on the cut: max |dh2| {dh2:.2e} (bound "
                   f"1e-4), max |dnit| {dnit} (bound {nit_window}), every "
                   f"lane valid")
    return {'nit': [nit_c.tolist(), nit_p.tolist()],
            'status': [st_c.tolist(), st_p.tolist()],
            'h2': [h2_c.tolist(), h2_p.tolist()], 'widths': widths,
            'seconds': [fits['card_s'], fits['plain_s']]}


def _runs(widths):
    """'100x10, 32x2, 8' for a list of chunk widths."""
    out = []
    for w in widths:
        if out and out[-1][0] == w:
            out[-1][1] += 1
        else:
            out.append([w, 1])
    return ', '.join(f"{w}x{n}" if n > 1 else f"{w}" for w, n in out)


def grid_genome(ds):
    """G3 (F5 on the genome packed as float32): the 100-point grid + BMA on
    the genome, as bench.py runs it, cold, warm and with
    sweep_impl='skip', launch counters reset before each fit and read
    after it (the lane kernels' instances for the LD's tiles launched, no
    other one); select_best_model on a fresh fit under torch.profiler. The
    cold fit's BMA h2 is held bit for bit to the port's earlier runs
    (PORT_GRID_BMA_H2, or PORT_F32_GRID_BMA_H2 for float32 LD, which must
    also converge on every lane and lie within 0.005 of the int8 grid's)."""
    import torch
    from viprs_tpu_torch.gridsearch import (HyperparameterGrid,
                                            bayesian_model_average,
                                            select_best_model)
    from viprs_tpu_torch.model import VIPRSGrid
    from viprs_tpu_torch.ops import cavi_cuda
    f32 = ds.ld.diag.dtype == torch.float32
    tag, held, trace = ('F5', PORT_F32_GRID_BMA_H2, None) if f32 else \
        ('G3', PORT_GRID_BMA_H2, 'grid_trace.json')
    lane = ('cavi_block_sweep_s', 'coupling_pass_s')
    mine = [k + '_f32' if f32 else k for k in lane]
    # every kernel instance of the other tile type
    other = [k for k in cavi_cuda.LAUNCHES if k.endswith('_f32') != f32]
    rec = {}

    def run(name, bma=True, **kw):
        np.random.seed(0)
        grid = HyperparameterGrid(n_snps=ds.m, **GRID_SPEC)
        g = VIPRSGrid(ds, grid, device='cuda')
        if g.n_models != 100:
            fail(f"the bench grid has {g.n_models} points, not 100")
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        g.fit(max_iter=500, **kw)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        nit = g._last_result.nit
        out = dict(fit_s=t_fit, converged=int(g.converged_models.sum()),
                   valid=int(g.valid_terminated_models.sum()),
                   nit_max=int(nit.max()), nit_median=float(np.median(nit)),
                   ms_per_it=1e3 * t_fit / max(int(nit.max()), 1),
                   widths=[w for w, *_ in g._chunk_trace],
                   act_trace=list(g._act_trace))
        if bma:
            t0 = time.perf_counter()
            bayesian_model_average(g)
            torch.cuda.synchronize()
            out.update(bma_s=time.perf_counter() - t0,
                       h2=g.get_heritability(), pi=g.pi,
                       sigma_eps=g.sigma_epsilon)
        out['launches'] = dict(cavi_cuda.LAUNCHES)
        msg = (f"{name}: fit {t_fit:.3f} s ({out['ms_per_it']:.2f} ms/it at "
               f"nit max), converged {out['converged']}/100 (JAX package: "
               f"{REF_GRID_CONVERGED}/100), valid {out['valid']}/100, nit max "
               f"{out['nit_max']} median {out['nit_median']:g}; widths per "
               f"chunk {_runs(out['widths'])}; launches "
               f"{ {k: v for k, v in out['launches'].items() if v} }")
        if bma:
            msg += (f"; BMA {out['bma_s']:.3f} s: h2 {out['h2']!r}, pi "
                    f"{out['pi']:.6g}, sigma_eps {out['sigma_eps']:.6f}")
        phase(tag, msg)
        if out['valid'] < 100:
            fail(f"{tag} {name}: only {out['valid']}/100 grid points "
                 f"terminated validly")
        if f32 and out['converged'] < 100:
            fail(f"{tag} {name}: only {out['converged']}/100 grid points "
                 f"converged")
        if any(out['launches'][k] for k in other):
            fail(f"{tag} {name}: the grid on {ds.ld.diag.dtype} LD launched "
                 f"another tile type's kernel: {out['launches']}")
        if bma and not (np.isfinite(out['h2']) and 0.0 < out['h2'] < 1.0):
            fail(f"{tag} {name}: the BMA h2 {out['h2']} is not in (0, 1)")
        return out, g

    rec['cold'], g = run('cold')
    rec['launches'] = rec['cold']['launches']
    if f32:
        gap = rec['cold']['h2'] - PORT_GRID_BMA_H2
        phase(tag, f"BMA h2 on float32 LD {rec['cold']['h2']!r}, the int8 "
                   f"grid's {PORT_GRID_BMA_H2!r}: gap {gap:+.3e} (bound "
                   f"0.005)")
        if abs(gap) > 0.005:
            fail(f"{tag}: the grid's BMA h2 on float32 LD is not within 0.005 "
                 f"of the int8 grid's")
    if rec['cold']['h2'] != held:
        fail(f"{tag}: the grid's BMA h2 {rec['cold']['h2']!r} moved from the "
             f"port's earlier runs ({held!r})")
    if min(rec['launches'][k] for k in mine) < 1:
        fail(f"{tag}: an S-lane kernel was never launched: {rec['launches']}")
    pip = np.concatenate([g.pip[c] for c in g.chromosomes])
    if pip.shape != (ds.m,) or not np.isfinite(pip).all():
        fail("the BMA posterior PIP is not finite of shape (M,)")
    rec['warm'], _ = run('warm')
    rec['skip'], _ = run("sweep_impl='skip'", bma=False, sweep_impl='skip')
    if rec['skip']['launches'][mine[0]] < 1:
        fail(f"{tag}: the skip grid fit launched no S-lane sweep")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sel, g = run('fresh fit for select_best_model (under the profiler)',
                     bma=False)
        elbos = np.asarray(g.elbo())
        t0 = time.perf_counter()
        select_best_model(g, criterion='ELBO')
        torch.cuda.synchronize()
        sel['select_s'] = time.perf_counter() - t0
    elbos[~g.valid_terminated_models] = -np.inf
    sel['index'] = int(np.argmax(elbos))
    sel['row'] = {k: float(v) for k, v in g.fix_params.items()}
    phase(tag, f"select_best_model (ELBO): index {sel['index']}, "
               f"{sel['row']}, h2 {g.get_heritability():.6f}")
    sel['profile'] = _device_time(prof, sel['fit_s'] + sel['select_s'],
                                  trace)
    rec['select'] = sel
    return rec


def _device_time(prof, wall, trace_name):
    """Device time by kernel from a profiler run, and the device's busy
    share of ``wall`` seconds (the profiler's own cost included); the trace
    goes to OUT_DIR as ``trace_name`` (None: not written)."""
    import torch
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
    if trace_name is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        prof.export_chrome_trace(os.path.join(OUT_DIR, trace_name))
    if not rows:
        phase('profile', "device time not measured (no device events)")
        return {'wall_s': wall, 'device_s': None}
    phase('profile', f"{wall:.3f} s under the profiler: device busy "
                     f"{busy:.3f} s ({100 * busy / wall:.1f}%), idle "
                     f"{100 * (1 - busy / wall):.1f}%")
    for us, n, key in rows[:10]:
        phase('profile', f"{us / 1e3:10.3f} ms  {n:6d} calls  {key[:90]}")
    return {'wall_s': wall, 'device_s': busy,
            'top': [(us / 1e3, n, key) for us, n, key in rows[:20]]}


def grid_times(ds, errs, errs_cpl):
    """G4 (F6 on the genome packed as float32): the S-lane kernels against
    their plain versions at the genome's shapes, S = 100, from the first
    iteration's state; the coupling pass also on dense random int8 tiles
    (G4 only)."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    ld = ds.ld
    dev = ld.device
    f32 = ld.diag.dtype == torch.float32
    tag = 'F6' if f32 else 'G4'
    pre = 'F6 ' if f32 else ''
    np.random.seed(0)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_SPEC), 'cuda')
    g.initialize_theta()
    g.initialize_variational_parameters()
    st0, h0 = g._state, g._hyper_dev()
    sb, nf = ds.device_inputs()
    S = st0.eta.shape[0]
    act = torch.ones(S, device=dev)
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    dense_ld = dense_diag_flags(ld)
    ms_sweep, ms_dense, ms_0, ms_1 = (time_ms(lambda: cavi_cuda.block_sweep_s(
        x, st0, sb, nf, h0, act, ones, inner_steps=k), reps=5)
        for x, k in ((ld, 8), (dense_ld, 8), (ld, 0), (ld, 1)))
    graph_sweep = graph_ms(lambda: cavi_cuda.block_sweep_s(
        ld, st0, sb, nf, h0, act, ones), reps=5)
    plain_sweep = time_ms(lambda: cavi_torch.block_sweep(
        ld, st0, sb, nf, h0, act), reps=2, warmup=1)
    st1, d1 = cavi_cuda.block_sweep_s(ld, st0, sb, nf, h0, act, ones)
    check_state(f'{pre}S={S}, all {ld.nb} blocks', (st1, d1),
                cavi_torch.block_sweep(ld, st0, sb, nf, h0, act), errs,
                TOL_S, st0.eta if f32 else None)
    same_bits_dense_walk(tag, ld, _k3_sweep(st0, sb, nf, h0, act))
    split = probe_split(ms_sweep, ms_dense, ms_0, ms_1)
    phase(tag, f"S={S} sweep split (ms): 8 inner steps "
                f"{split['inner_steps']:.3f}, rank-T updates over the "
                f"nonzero blocks {split['rank_t']:.3f} (every block "
                f"{split['rank_t_dense']:.3f}), the rest (state I/O, "
                f"dequantizing, the gate) {split['rest']:.3f}; probes: 0 "
                f"steps {ms_0:.3f}, 1 step {ms_1:.3f}, 8 steps "
                f"{ms_sweep:.3f}, 8 steps every block flagged "
                f"{ms_dense:.3f}")
    del dense_ld
    # the 8-lane instance against the 16-lane one: S = 8 runs one 8-lane
    # tile, S = 9 one 16-lane tile (its missing lanes computed, inert)
    lane_tiles = {}
    for n in (8, 9):
        lanes = torch.arange(n, device=dev)
        st_n = cavi_torch.CaviState(*(x[:n] for x in st0))
        h_n, a_n = _sub_hyper(h0, lanes), act[:n]
        lane_tiles[n] = (cavi_cuda.sweep_lane_tile(n), time_ms(
            lambda: cavi_cuda.block_sweep_s(ld, st_n, sb, nf, h_n, a_n, ones),
            reps=5))
    phase(tag, 'block sweep by lane tile, all blocks: ' + ', '.join(
        f"S = {n} (lane tile {L}) {ms:.3f} ms"
        for n, (L, ms) in lane_tiles.items()))
    cpl = coupling_times(ld, st1.q, d1, ones, COUPLING_WIDTHS, errs_cpl,
                         tag=tag)
    cpl_dense = None
    if not f32:
        dense = dense_tiles(ld)
        cpl_dense = coupling_times(dense, st1.q, d1, ones, COUPLING_WIDTHS,
                                   errs_cpl, tag='G4 dense',
                                   exact=refresh_q_f64)
        del dense
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    ms_skip = time_ms(lambda: cavi_cuda.cavi_sweep_s_skip(
        ld, st0, sb, nf, h0, act, few), reps=5)
    graph_skip = graph_ms(lambda: cavi_cuda.cavi_sweep_s_skip(
        ld, st0, sb, nf, h0, act, few), reps=5)
    plain_skip = time_ms(lambda: _plain_lanes(ld, st0, sb, nf, h0, act, few),
                         reps=2, warmup=1)
    check_state(f'{pre}K4, S={S}, {int(few.sum())} of {ld.nb} blocks',
                cavi_cuda.cavi_sweep_s_skip(ld, st0, sb, nf, h0, act, few),
                _plain_lanes(ld, st0, sb, nf, h0, act, few), errs, TOL_S,
                st0.eta if f32 else None)
    # K4's coupling part as one PyTorch call: torch.bmm of the tiles it
    # touches with the eta change of its block sweep
    _, d_few = cavi_cuda.block_sweep_s(ld, st0, sb, nf, h0, act, few)
    lib_skip = library_coupling_ms(ld, d_few, bmm_tiles(ld, _tiles_on(ld,
                                                                      few)))
    del d_few
    b_sweep = bound(*sweep_work(ld, S, 4, 5, ld.nb))
    work_nz = sweep_work_nz(ld, S, 4, 5)
    b_sweep_nz = bound(*work_nz[:2])
    b_skip = bound(*_add(sweep_work(ld, S, 4, 5, int(few.sum())),
                         coupling_work(ld, S, few)))
    b_skip_nz = bound(*_add(sweep_work_nz(ld, S, 4, 5, few),
                            coupling_work(ld, S, few)))
    c = cpl[S]
    phase(tag, f"S={S}, first-iteration state, all {ld.nb} blocks: block "
                f"sweep {ms_sweep:.3f} ms by CUDA events, {graph_sweep:.3f} "
                f"ms in a CUDA graph (plain {plain_sweep:.3f} ms; bound "
                f"by what the data needs {b_sweep_nz[0]:.3f} ms by "
                f"{b_sweep_nz[1]} = {100 * b_sweep_nz[0] / ms_sweep:.1f}% of "
                f"it, the inner steps over the {work_nz[2]} of "
                f"{work_nz[3]} blocks of 32 x 32 in the (T, T) tiles that "
                f"are nonzero; every tile dense {b_sweep[0]:.3f} ms = "
                f"{100 * b_sweep[0] / ms_sweep:.1f}%); coupling "
                f"pass {c['ms']:.3f} ms (plain {c['plain_ms']:.3f} ms, one "
                f"torch.bmm of the tile products {c['library_ms']:.3f} ms, "
                f"bound {c['bound_ms']:.3f} ms by {c['bound_by']}); skip "
                f"sweep at {int(few.sum())} blocks, "
                f"{_tiles_touching(ld, few)} coupling tiles {ms_skip:.3f} ms "
                f"by events, {graph_skip:.3f} ms in a CUDA graph (plain "
                f"{plain_skip:.3f} ms, bound {b_skip_nz[0]:.3f} ms by "
                f"{b_skip_nz[1]}, every tile dense {b_skip[0]:.3f} ms; its "
                f"coupling part as one torch.bmm {lib_skip:.3f} ms)")
    del g, st0, st1, d1
    torch.cuda.empty_cache()
    return dict(block_sweep=ms_sweep, block_sweep_graph=graph_sweep,
                block_sweep_plain=plain_sweep,
                block_sweep_bound=b_sweep_nz, block_sweep_bound_dense=b_sweep,
                block_sweep_tile_blocks=work_nz[2:],
                block_sweep_lane_tiles=lane_tiles,
                block_sweep_every_block=ms_dense, block_sweep_split=split,
                coupling=c['ms'],
                coupling_plain=c['plain_ms'], coupling_library=c['library_ms'],
                coupling_bound=(c['bound_ms'], c['bound_by']),
                coupling_widths=cpl, coupling_widths_dense=cpl_dense,
                skip_5pct=ms_skip, skip_5pct_graph=graph_skip,
                skip_5pct_plain=plain_skip, skip_5pct_bound=b_skip_nz,
                skip_5pct_bound_dense=b_skip,
                skip_5pct_library_coupling=lib_skip)


#: G4 times the S-lane coupling pass at these widths: the grid's chunks
#: (100, then 16 and 2 after compaction) and the mixture grid's (20, 8).
COUPLING_WIDTHS = (2, 8, 16, 20, 100)


def dense_tiles(ld, seed=0):
    """The LD operator with its coupling tiles replaced by dense random int8
    tiles (seeded): the coupling pass's dense path at the same shapes (the
    genome's own tiles are mostly exact zeros, which the kernel skips)."""
    import dataclasses
    import torch
    g = torch.Generator(device=ld.device).manual_seed(seed)
    off = torch.randint(-127, 128, tuple(ld.off_data.shape), generator=g,
                        device=ld.device, dtype=torch.int8)
    return dataclasses.replace(dense_off_flags(ld), off_data=off)


def dense_diag_flags(ld):
    """The LD operator with every 32 x 32 block of its diagonal tiles
    flagged nonzero: the rank-T updates' dense walk."""
    import dataclasses
    import torch
    return dataclasses.replace(ld, diag_nz=torch.ones_like(ld.diag_nz))


def dense_off_flags(ld):
    """The LD operator with every 32 x 32 block of its coupling tiles
    flagged nonzero, and the slab list to match: the coupling passes' dense
    walk."""
    import dataclasses
    import torch
    from viprs_tpu_torch.ops.block_ld import coupling_slabs
    slabs = coupling_slabs(np.ones(tuple(ld.off_nz.shape), np.uint8),
                           ld.off_src.cpu().numpy(), ld.off_dst.cpu().numpy(),
                           ld.nb)
    return dataclasses.replace(
        ld, off_nz=torch.ones_like(ld.off_nz),
        cpl_slabs=torch.as_tensor(slabs, device=ld.device))


def same_bits(a, b):
    """Equal bit for bit, the sign of a zero included (torch.equal holds
    -0.0 equal to +0.0)."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def neg_zeros(x):
    """The number of entries of x that are -0.0."""
    import torch
    return int(((x == 0) & torch.signbit(x)).sum())


def same_bits_dense_walk(tag, ld, sweep):
    """A lane sweep skipping the zero blocks of its rank-T updates gives the
    bits of its dense walk (every block flagged), the sign of a zero
    included: ``sweep(ld)`` returns its (state, eta_diff) on an LD
    operator."""
    got, want = sweep(ld), sweep(dense_diag_flags(ld))
    _same_state(f"{tag}: the sweep with the real diag_nz against the dense "
                f"walk", got, want)
    phase('check', f"{tag}: S = {got[1].shape[0]}, the sweep with the real "
                   f"diag_nz ({int(ld.diag_nz.sum())} of "
                   f"{ld.diag_nz.numel()} blocks of 32 x 32 nonzero) "
                   f"bit-identical to the dense walk (the sign of a zero "
                   f"included)")


def _k3_sweep(state, sb, nf, hyper, act):
    """``same_bits_dense_walk``'s sweep for the S-lane block sweep (K3)."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    return lambda x: cavi_cuda.block_sweep_s(
        x, state, sb, nf, hyper, act,
        torch.ones(x.nb, dtype=torch.int32, device=x.device))


def probe_split(ms_8, ms_dense, ms_0, ms_1):
    """A lane sweep's time split by its probes of 8, 0 and 1 inner steps and
    its dense rank-T walk: inner steps are the 7 steps between the probes of
    1 and 8; the rank-T updates the probe of 1 step less that step and the
    probe of 0 (whose eta changes are all zero, so it skips every row)."""
    step_ms = (ms_8 - ms_1) / 7
    return dict(inner_steps=8 * step_ms, rank_t=ms_1 - step_ms - ms_0,
                rest=ms_0, rank_t_dense=ms_dense - 8 * step_ms - ms_0)


def coupling_times(ld, q, d, blk, widths, errs, tag='G4', exact=None):
    """The S-lane coupling pass at the first ``S`` lanes of (q, d) for each
    width S: the kernel in place on a copy of q (as the sweeps apply it), the
    public wrapper (a clone, then the kernel), refresh_q / coupling_pass,
    one torch.bmm of the tile products and the bound; each result held
    against the plain version (``exact``: against this float64 version,
    with the float32 plain version's own error as the yardstick)."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    tiles = bmm_tiles(ld)
    n_til = _tiles_touching(ld, blk)
    n_w = int(_slabs_with_work(ld, blk).sum())
    out = {}
    for S in widths:
        qs, ds = q[:S], d[:S]
        plain = (lambda: cavi_torch.refresh_q(ld, qs, ds)) if n_til == \
            ld.n_off else (lambda: cavi_torch.coupling_pass(ld, qs, ds, blk))
        scratch = qs.clone()
        ms = time_ms(lambda: cavi_cuda.coupling_pass_s_inplace(
            ld, scratch, ds, blk), reps=10)
        ms_clone = time_ms(lambda: cavi_cuda.coupling_pass_s(ld, qs, ds, blk),
                           reps=10)
        plain_ms = time_ms(plain, reps=2, warmup=1)
        lib = library_coupling_ms(ld, ds, tiles)
        del scratch
        got = cavi_cuda.coupling_pass_s(ld, qs, ds, blk)
        if exact is None:
            check(f'coupling_pass_s over {n_til} tiles vs the plain version, '
                  f'S={S}', 'q', got, plain(), TOL_COUPLING_S, errs)
        else:
            # random dense tiles: q cancels, so the float32 plain version is
            # itself far from the exact sum; hold both to a float64 run
            x = exact(ld, qs, ds)
            e_k = float((got.double() - x).abs().max())
            e_p = float((plain().double() - x).abs().max())
            errs.append(e_k)
            phase('check', f"{tag} S={S}: q against float64: kernel "
                           f"{e_k:.3e}, plain float32 {e_p:.3e}")
            if not e_k <= ACC_RATIO_DENSE * e_p + ACC_FLOOR:
                fail(f"{tag} S={S}: coupling_pass_s is further from the "
                     f"float64 sum ({e_k:.3e}) than {ACC_RATIO_DENSE} x the "
                     f"float32 plain version ({e_p:.3e})")
            del x
        del got
        b_ms, b_by = bound(*coupling_work(ld, S, blk))
        out[S] = dict(ms=ms, ms_with_clone=ms_clone, plain_ms=plain_ms,
                      library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                      lane_tile=cavi_cuda.coupling_lane_tile(S), tiles=n_til,
                      slabs=n_w)
        phase(tag, f"coupling_pass_s S={S} (lane tile "
                   f"{out[S]['lane_tile']}), {n_til} tiles, {n_w} block slabs "
                   f"with work: {ms:.3f} ms in place, {ms_clone:.3f} ms with "
                   f"the clone (plain {plain_ms:.3f} ms, torch.bmm {lib:.3f} "
                   f"ms, "
                   f"bound {b_ms:.3f} ms by {b_by} = {100 * b_ms / ms:.0f}% "
                   f"of it)")
    del tiles
    torch.cuda.empty_cache()
    return out


def _plain_skip(ld, state, sb, nf, hyper, act, blk):
    """The plain version of the skip branch (block sweep + coupling pass)."""
    from viprs_tpu_torch.ops import cavi_torch
    st, d = cavi_torch.block_sweep(ld, state, sb, nf, hyper, act,
                                   blk_mask=blk)
    return st._replace(q=cavi_torch.coupling_pass(ld, st.q, d, blk)), d


def profile_fit(ds, fit_kw, make=None, trace_name='fit_trace.json'):
    """One warm fit of ``make()`` (default VIPRS(ds, 'cuda'), made after
    np.random.seed(0)) under torch.profiler: device time by kernel, and the
    device's busy share of the fit's wall time (the profiler's own cost
    included). The trace goes to OUT_DIR as ``trace_name`` (None: not
    written)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from viprs_tpu_torch.model import VIPRS
    np.random.seed(0)
    model = VIPRS(ds, 'cuda') if make is None else make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(**fit_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _device_time(prof, wall, trace_name)
    rec['nit'] = model.optim_result.nit
    return rec


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


# ---------------------------------------------------------------- bounds
def bound(nbytes, flops):
    """(the least ms the card could take for the work, what bounds it):
    ``nbytes`` at HBM_TBS, ``flops`` FP32 operations at FP32_TFLOPS."""
    t_b = nbytes / (HBM_TBS * 1e12) * 1e3
    t_o = flops / (FP32_TFLOPS * 1e12) * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def sweep_work(ld, S, planes_in, planes_out, n_blocks):
    """Bytes and FP32 operations of one block sweep over ``n_blocks`` blocks
    for S lanes: the blocks' diagonal tiles (int8 or float32, at their
    element size) and beta/n/mask read once, ``planes_in`` float32 state
    planes of (S, n_blocks, B) read and ``planes_out`` written; per tile, 8
    inner steps of two (T x T) matvecs and the rank-T update of the block's
    q (an FMA is 2 operations)."""
    from viprs_tpu_torch.ops.cavi_torch import INNER_STEPS, TILE
    B = ld.block_size
    nbytes = n_blocks * B * B * ld.diag.element_size() + 4 * n_blocks * B * (
        3 + S * (planes_in + planes_out))
    fma = S * n_blocks * (B // TILE) * (INNER_STEPS * 2 * TILE * TILE
                                        + TILE * B)
    return nbytes, 2 * fma


def sweep_work_nz(ld, S, planes_in, planes_out, blk=None):
    """``sweep_work`` over the blocks flagged in ``blk`` ((NB,) int; None:
    all), counting what this LD needs: only the diagonal tiles' nonzero
    32 x 32 blocks (``BlockLD.diag_nz``) are read (once, with the flags)
    and multiplied, 32 x 32 FMA per lane each: in the rank-T updates every
    such block, and in each of the 8 inner steps' two products those inside
    a (T, T) tile. Returns (bytes, operations, blocks inside the (T, T)
    tiles that are nonzero, all blocks inside them)."""
    import torch
    from viprs_tpu_torch.ops.cavi_torch import INNER_STEPS, TILE
    B = ld.block_size
    sel = torch.ones(ld.nb, dtype=torch.bool, device=ld.device) \
        if blk is None else blk.to(torch.bool)
    n_blocks = int(sel.sum())
    nz = ld.diag_nz.bool()[sel]                     # (n, m, m)
    m, per = nz.shape[1], TILE // 32
    tiles = torch.arange(m, device=ld.device) // per
    in_tile = tiles[:, None] == tiles[None, :]      # inside a (T, T) tile
    n_inner = int((nz & in_tile).sum())
    nbytes = 32 * 32 * ld.diag.element_size() * int(nz.sum()) + nz.numel() \
        + 4 * n_blocks * B * (3 + S * (planes_in + planes_out))
    fma = S * 32 * 32 * (INNER_STEPS * 2 * n_inner + int(nz.sum()))
    return nbytes, 2 * fma, n_inner, n_blocks * m * per


def coupling_work(ld, S, blk=None):
    """Bytes and FP32 operations that a coupling pass over the tiles with a
    flagged end (``blk`` (NB,) int; None: all) needs on this LD, for S
    lanes. int8 LD that decays with distance is mostly exact zeros in the
    coupling tiles, so this counts what the data needs (``BlockLD.off_nz``):
    the nonzero 32 x 32 blocks of those tiles read once (at the tiles'
    element size), the eta change of
    the 32-coordinate chunks they multiply read once, q of the slabs of 128
    coordinates they can change read and written, and one FMA (2
    operations) per nonzero element per lane, each tile applied both ways."""
    import torch
    on = torch.ones(ld.n_off, dtype=torch.bool, device=ld.device) \
        if blk is None else _tiles_on(ld, blk)
    src, dst = ld.off_src.long()[on], ld.off_dst.long()[on]
    nz = ld.off_nz.bool()[on]                        # (n, m, m)
    nnz = int((ld.off_data != 0).sum(dim=(1, 2))[on].sum())
    m = nz.shape[1]
    reads = torch.zeros(ld.nb, m, dtype=torch.int32, device=ld.device)
    reads.index_add_(0, dst, nz.any(dim=1).int())   # b = src reads dst's
    reads.index_add_(0, src, nz.any(dim=2).int())   # b = dst reads src's
    ns = m // 4
    writes = torch.zeros(ld.nb, ns, dtype=torch.int32, device=ld.device)
    writes.index_add_(0, src, nz.reshape(-1, ns, 4 * m).any(dim=2).int())
    writes.index_add_(0, dst, nz.reshape(-1, m, ns, 4).any(dim=(1, 3)).int())
    nbytes = (int(nz.sum()) * 32 * 32 * ld.off_data.element_size()
              + 4 * S * 32 * int((reads > 0).sum())
              + 2 * 4 * S * 128 * int((writes > 0).sum()))
    return nbytes, 2 * 2 * nnz * S


def _add(*works):
    return tuple(sum(w[i] for w in works) for i in range(2))


def bmm_tiles(ld, on=None):
    """The float32 coupling tiles (those flagged in ``on``, (n_off,) bool;
    None: all) and their transposes, (2 n, B, B), and the block each one's
    product reads: the operands of library_coupling_ms that do not depend
    on the eta change."""
    import torch
    sel = slice(None) if on is None else on
    U = ld.off_data[sel].float()
    return (torch.cat([U, U.transpose(1, 2)]),
            torch.cat([ld.off_dst[sel], ld.off_src[sel]]).long())


def library_coupling_ms(ld, d, tiles=None):
    """One PyTorch call computing every coupling tile's product both ways:
    torch.bmm of the float32 tiles and their transposes (``bmm_tiles``,
    made here unless given) with the gathered eta changes ``d``
    ((S, NB, B)); the scatter-add into q is left out."""
    import torch
    Uf, idx = bmm_tiles(ld) if tiles is None else tiles
    X = d.index_select(1, idx).permute(1, 2, 0).contiguous()
    ms = time_ms(lambda: torch.bmm(Uf, X), reps=5)
    del Uf, X
    torch.cuda.empty_cache()
    return ms


def _tiles_on(ld, blk):
    """(n_off,) bool: the coupling tiles with a flagged source or
    destination."""
    b = blk.to(bool)
    return b[ld.off_src.long()] | b[ld.off_dst.long()]


def _tiles_touching(ld, blk):
    """The number of coupling tiles with a flagged source or destination."""
    return int(_tiles_on(ld, blk).sum())


def _slabs_with_work(ld, blk):
    """(NB, B / 128) bool: the slabs of 128 coordinates that a coupling
    tile with a flagged end holds a nonzero for (in its rows for its src
    block, in its columns for its dst block)."""
    import torch
    on = _tiles_on(ld, blk)
    nz = ld.off_nz.bool()[on]
    m = nz.shape[1]
    hit = torch.zeros(ld.nb, m // 4, dtype=torch.int32, device=ld.device)
    hit.index_add_(0, ld.off_src.long()[on],
                   nz.reshape(-1, m // 4, 4 * m).any(dim=2).int())
    hit.index_add_(0, ld.off_dst.long()[on],
                   nz.reshape(-1, m, m // 4, 4).any(dim=(1, 3)).int())
    return hit > 0


def refresh_q_f64(ld, q, d):
    """cavi_torch.refresh_q in float64 on float64 copies of q and the eta
    change (the LD keeps its tile type)."""
    import torch
    from viprs_tpu_torch.ops import cavi_torch
    cavi_torch.F32 = torch.float64
    try:
        return cavi_torch.refresh_q(ld, q.double(), d.double())
    finally:
        cavi_torch.F32 = torch.float32


# ------------------------------------------------------------ the mixture
#: The four mixture wrappers: (TPU kernel line replaced, lane kernel?,
#: activity mask?)
MIX_KERNELS = {
    'cavi_sweep_mix_s1': ('viprs_tpu/ops/cavi_pallas.py:700', False, False),
    'cavi_sweep_mix_s1_skip': ('viprs_tpu/ops/cavi_pallas.py:1037', False,
                               True),
    'cavi_sweep_mix_s': ('viprs_tpu/ops/cavi_pallas.py:849', True, False),
    'cavi_sweep_mix_s_skip': ('viprs_tpu/ops/cavi_pallas.py:1593', True,
                              True),
}


def mix_kernel(name, ld, state, sb, nf, hyper, act=None, blk=None):
    """Call the mixture wrapper ``name`` (a kernel for CUDA tensors)."""
    from viprs_tpu_torch.ops import cavi_cuda
    fn = getattr(cavi_cuda, name)
    lanes, skip = MIX_KERNELS[name][1:]
    args = ((act,) if lanes else ()) + ((blk,) if skip else ())
    return fn(ld, state, sb, nf, hyper, *args)


def mix_plain(name, ld, state, sb, nf, hyper, act=None, blk=None):
    """The plain version of the mixture wrapper ``name``: the plain block
    sweep of the flagged blocks (the variant mask as the relaxation's
    diagonal for the skip kernels), then the coupling tiles."""
    from viprs_tpu_torch.ops import cavi_mix, cavi_torch
    from viprs_tpu_torch.ops.cavi_mix import MixState
    lanes, skip = MIX_KERNELS[name][1:]
    st_l, h_l = (state, hyper) if lanes else \
        (MixState(*(x[None] for x in state)), hyper.lanes())
    st, d = cavi_mix.mix_block_sweep(ld, st_l, sb, nf, h_l,
                                     act if lanes else None,
                                     blk_mask=blk if skip else None,
                                     unit_diag=skip)
    q = cavi_torch.coupling_pass(ld, st.q, d, blk) if skip else \
        cavi_torch.refresh_q(ld, st.q, d)
    st = st._replace(q=q)
    if not lanes:
        st, d = MixState(*(x[0] for x in st)), d[0]
    return st, d


def mix_plain_f64(name, ld, state, sb, nf, hyper, act=None, blk=None):
    """``mix_plain`` in float64 on float64 copies of the inputs (the LD keeps
    its tile type): the plain versions cast to their modules' ``F32``, which
    is float64 for the duration of the call."""
    import torch
    from viprs_tpu_torch.ops import cavi_mix, cavi_torch
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    f64 = torch.float64
    cavi_mix.F32 = cavi_torch.F32 = f64
    try:
        return mix_plain(name, ld, MixState(*(x.to(f64) for x in state)),
                         sb.to(f64), nf.to(f64),
                         MixHyper(*(x.to(f64) for x in hyper)),
                         None if act is None else act.to(f64), blk)
    finally:
        cavi_mix.F32 = cavi_torch.F32 = torch.float32


def check_accuracy(tag, got, want, exact):
    """Hold the kernel's (MixState, eta_diff) against a float64 run of the
    plain version ``exact``: its max abs error at most ACC_RATIO times the
    float32 plain version's ``want``, plus ACC_FLOOR."""
    from viprs_tpu_torch.ops.cavi_mix import MixState
    (gs, gd), (ws, wd), (xs, xd) = got, want, exact
    for k, a, b, x in zip((*MixState._fields, 'eta_diff'), (*gs, gd),
                          (*ws, wd), (*xs, xd)):
        e_k = float((a.double() - x).abs().max())
        e_p = float((b.double() - x).abs().max())
        phase('check', f"{tag}: {k} against float64: kernel {e_k:.3e}, "
                       f"plain float32 {e_p:.3e}")
        if not e_k <= ACC_RATIO * e_p + ACC_FLOOR:
            fail(f"{tag}: {k} is further from the float64 plain version "
                 f"({e_k:.3e}) than {ACC_RATIO} x the float32 plain version "
                 f"({e_p:.3e})")


def check_mix_state(tag, got, want, errs):
    """Compare two (MixState, eta_diff) pairs within TOL_MIX."""
    (gs, gd), (ws, wd) = got, want
    for k in ('eta', 'mu', 'q', 'gamma'):
        check(tag, k, getattr(gs, k), getattr(ws, k), TOL_MIX[k], errs)
    # eta_diff is a difference of two eta values, so its rounding is eta's:
    # its floor comes from max|eta| (after a first sweep the changes are
    # small against eta, and an ulp of eta would read as a large error)
    check(tag, 'eta_diff', gd, wd, TOL_MIX['eta_diff'], errs,
          scale=float(ws.eta.abs().max()))


def zero_blocks_cut(sub):
    """The cut with a third of the off-diagonal 32 x 32 blocks of its
    diagonal tiles set to exact zeros, symmetrically (block (r, c) of tile b
    where r != c and (r + c + b) % 3 == 0): zero blocks inside the (T, T)
    tiles and outside them; and a third of the nonzero blocks of each
    coupling tile o ((r + 2 c + o) % 3 == 0), its first nonzero block
    (row-major) kept."""
    from viprs_tpu_torch.ops.block_ld import BlockLD
    diag = sub.diag.cpu().numpy().copy()
    m = diag.shape[1] // 32
    for b in range(diag.shape[0]):
        for r in range(m):
            for c in range(m):
                if r != c and (r + c + b) % 3 == 0:
                    diag[b, 32 * r:32 * r + 32, 32 * c:32 * c + 32] = 0
    off = sub.off_data.cpu().numpy().copy()
    for o, flags in enumerate(sub.off_nz.cpu().numpy()):
        nz = list(zip(*np.nonzero(flags)))
        for r, c in nz[1:]:
            if (r + 2 * c + o) % 3 == 0:
                off[o, 32 * r:32 * r + 32, 32 * c:32 * c + 32] = 0
    return BlockLD.from_numpy(
        diag, off, sub.off_src.cpu().numpy(), sub.off_dst.cpu().numpy(),
        sub.mask.cpu().numpy(), sub.scale, device=sub.device)


def zero_blocks(ld):
    """The diagonal tiles' zero 32 x 32 blocks inside the (T, T) tiles and
    outside them (BlockLD.diag_nz)."""
    import torch
    from viprs_tpu_torch.ops.cavi_torch import TILE
    zero = ~ld.diag_nz.bool()
    tile = torch.arange(zero.shape[1], device=zero.device) // (TILE // 32)
    inside = tile[:, None] == tile[None, :]
    return int((zero & inside).sum()), int((zero & ~inside).sum())


def _mix_lane_state(sub, S, m, rng, K=MIX_K):
    """S lanes of mixture state on the cut, from the bench mixture grid's
    rows: each row's total pi split over the K components, tau_beta as the
    model's initialization makes it at an h2 of 0.25, gamma and mu spread
    around them, q = (R - I) eta."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.ops import cavi_torch
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    dev = sub.device
    rows = HyperparameterGrid(n_snps=m, **MIX_GRID_SPEC).combine_grids()
    total = np.array([rows[i % len(rows)]['pi'] for i in range(S)])
    pis = total[:, None] * rng.dirichlet(np.ones(K), size=S)
    d = 2.0 ** np.linspace(-min(K - 1, 7), 0, K)
    tau = d[None] * (m * (pis @ (1.0 / d)) / 0.25)[:, None]
    shape = (S, K, sub.nb, sub.block_size)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    gamma = t(pis[:, :, None, None] * np.exp(0.3 * rng.standard_normal(shape)))
    mu = t(rng.standard_normal(shape) * 2e-3)
    eta = (gamma * mu).sum(dim=1) * sub.mask
    state = MixState(gamma, mu, eta, cavi_torch.compute_q(sub, eta))
    hyper = MixHyper(t(np.full(S, 0.75)), t(tau), t(pis), t(np.zeros(S)))
    return state, hyper


def _mix_one(state, hyper, i=0):
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    return (MixState(*(x[i].contiguous() for x in state)),
            MixHyper(*(x[i] for x in hyper)))


def _half_blocks(masks, nb):
    """Of a mask for each gate epsilon, the one closest to half of nb."""
    best = None
    for eps in np.geomspace(1e-8, 1e-1, 57):
        cand = masks(float(eps))
        if best is None or abs(int(cand.sum()) - nb // 2) < \
                abs(int(best.sum()) - nb // 2):
            best = cand
    return best


def mix_s1_cut_checks(sub, one, h1, sb, nf, errs5, errs6, prefix='M1 ',
                      need_zeros=True):
    """M1 (F1 with ``prefix`` 'F1 ' on the float32 cut): K5 and K6 at K = 3
    on the cut against their plain versions, K6 with half the blocks
    flagged (unflagged blocks bit-exact, their eta change 0) and with none
    (the state bit-exact); then on the cut and on the cut with a third of
    its off-diagonal 32 x 32 blocks zeroed, K5 and K6 against their plain
    versions and their block sweeps with the real diag_nz bit for bit (the
    sign of a zero included) against the dense walk. The cut itself must
    hold zero blocks inside and outside the (T, T) tiles unless
    ``need_zeros`` is false."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.ops.cavi_mix import MixState
    k5, k6 = 'cavi_sweep_mix_s1', 'cavi_sweep_mix_s1_skip'
    check_mix_state(f'{prefix}K5 all blocks', mix_kernel(
        k5, sub, one, sb, nf, h1), mix_plain(k5, sub, one, sb, nf, h1), errs5)
    half = torch.zeros(sub.nb, dtype=torch.int32, device=sub.device)
    half[::2] = 1
    got = mix_kernel(k6, sub, one, sb, nf, h1, blk=half)
    check_mix_state(f'{prefix}K6 half the blocks flagged', got,
                    mix_plain(k6, sub, one, sb, nf, h1, blk=half), errs6)
    quiet = half == 0
    for k in MixState._fields[:3]:
        if not same_bits(getattr(got[0], k)[..., quiet, :],
                         getattr(one, k)[..., quiet, :]):
            fail(f"{prefix}K6: unflagged blocks' {k} changed")
    if bool(got[1][quiet].any()):
        fail(f"{prefix}K6: unflagged blocks report an eta change")
    got = mix_kernel(k6, sub, one, sb, nf, h1, blk=torch.zeros_like(half))
    for k in MixState._fields:
        if not same_bits(getattr(got[0], k), getattr(one, k)):
            fail(f"{prefix}K6, no block flagged: {k} changed")
    phase('check', f"{prefix}K6 unflagged blocks bit-exact (gamma, mu, eta; "
                   f"eta_diff 0); no block flagged: state bit-exact (gamma, "
                   f"mu, eta, q)")
    for tag, x, need in (('the cut', sub, need_zeros),
                         ('the cut, blocks zeroed', zero_blocks_cut(sub),
                          True)):
        n_in, n_out = zero_blocks(x)
        if need and not (n_in and n_out):
            fail(f"{prefix}{tag}: no zero 32 x 32 block inside ({n_in}) or "
                 f"outside ({n_out}) the (T, T) tiles")
        check_mix_state(f'{prefix}K5 on {tag}', mix_kernel(
            k5, x, one, sb, nf, h1), mix_plain(k5, x, one, sb, nf, h1), errs5)
        check_mix_state(f'{prefix}K6 on {tag}, half the blocks flagged',
                        mix_kernel(k6, x, one, sb, nf, h1, blk=half),
                        mix_plain(k6, x, one, sb, nf, h1, blk=half), errs6)
        for kname, mask, unit_diag in ((k5, torch.ones_like(half), False),
                                       (k6, half, True)):
            def sweep(y):
                return cavi_cuda.block_sweep_mix(
                    y, MixState(*(v[None] for v in one)), sb, nf,
                    h1.lanes(), None, mask, unit_diag, kname)
            _same_state(f'{prefix}{kname} block sweep on {tag}: the real '
                        f'diag_nz against the dense walk', sweep(x),
                        sweep(dense_diag_flags(x)))
        phase('check', f"{prefix}K5 and K6 on {tag} ({n_in} zero 32 x 32 "
                       f"blocks inside the (T, T) tiles, {n_out} outside): "
                       f"within bounds; their block sweeps bit for bit "
                       f"(the sign of a zero included) their dense walks")


def mix_checks(ds, sub, sb, nf, errs):
    """M1 and M3: the mixture kernels against their plain versions on the
    cut (K = 3; single model, and S = 20 lanes; K7 also at K = 1 and 8)."""
    rng = np.random.default_rng(2)
    state, hyper = _mix_lane_state(sub, 20, ds.m, rng)
    one, h1 = _mix_one(state, hyper, 4)
    nb = sub.nb
    phase('M1', f"K = {MIX_K}, {nb} blocks cut from the genome, {sub.n_off} "
                f"coupling tiles; hyperparameters of the bench mixture grid")
    mix_s1_cut_checks(sub, one, h1, sb, nf, errs['cavi_sweep_mix_s1'],
                      errs['cavi_sweep_mix_s1_skip'])
    mix_lane_checks(ds.m, sub, sb, nf, state, hyper, rng,
                    errs['cavi_sweep_mix_s'], errs['cavi_sweep_mix_s_skip'])
    return {k: max(v) for k, v in errs.items()}


def mix_lane_checks(m, sub, sb, nf, state, hyper, rng, errs7, errs8,
                    prefix='M3 '):
    """M3 (F4 with ``prefix`` 'F4 ' on the float32 cut): the mixture lane
    kernels K7 and K8 against their plain versions on the cut at S = 20 and
    K = 3 from ``state``: half the lanes frozen (bit-exact), every lane
    frozen, a union mask at about half the blocks (unflagged blocks
    bit-exact), lane independence (3 lanes at S = 3 and the first lanes on
    either side of each lane tile's boundary), K7 and K8 with every 32 x 32
    block flagged bit for bit their sweeps with the real flags, and K7 at
    K = 1 and 8 (lane tiles 20 and 4; states drawn from ``rng``)."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_mix
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    dev = sub.device
    nb = sub.nb
    S = state.eta.shape[0]
    phase(prefix.strip(), f"S = {S} lanes, K = {MIX_K}, {sub.diag.dtype} "
                          f"tiles, lane tile "
                          f"{cavi_cuda.mix_sweep_lane_tile(S, MIX_K)}")
    act = torch.ones(S, device=dev)
    full = mix_kernel('cavi_sweep_mix_s', sub, state, sb, nf, hyper, act)
    check_mix_state(f'{prefix}K7 S={S} all active', full, mix_plain(
        'cavi_sweep_mix_s', sub, state, sb, nf, hyper, act), errs7)
    half_act = act.clone()
    half_act[1::2] = 0.0
    got = mix_kernel('cavi_sweep_mix_s', sub, state, sb, nf, hyper, half_act)
    check_mix_state(f'{prefix}K7 S={S} half the lanes frozen', got, mix_plain(
        'cavi_sweep_mix_s', sub, state, sb, nf, hyper, half_act), errs7)
    for k in MixState._fields:
        if not torch.equal(getattr(got[0], k)[1::2], getattr(state, k)[1::2]):
            fail(f"{prefix}K7: frozen lanes' {k} changed")
    if bool(got[1][1::2].any()):
        fail(f"{prefix}K7: frozen lanes report an eta change")
    phase('check', f"{prefix}K7 frozen lanes bit-exact (gamma, mu, eta, q; "
                   f"eta_diff 0)")
    st_k8 = full[0]
    blk = _half_blocks(lambda eps: (cavi_mix.mix_block_proposal_mask_batch(
        sub, st_k8, sb, nf, hyper, eps=eps) & (half_act > 0)[:, None])
        .any(dim=0), nb).to(torch.int32)
    if not 0 < int(blk.sum()) < nb:
        fail(f"{prefix}no gate epsilon splits the cut's blocks")
    name = 'cavi_sweep_mix_s_skip'
    got = mix_kernel(name, sub, st_k8, sb, nf, hyper, half_act, blk)
    check_mix_state(f'{prefix}K8 S={S} union mask flags {int(blk.sum())} of '
                    f'{nb} blocks, half the lanes frozen', got, mix_plain(
                        name, sub, st_k8, sb, nf, hyper, half_act, blk),
                    errs8)
    quiet = blk == 0
    for k in MixState._fields[:3]:
        if not torch.equal(getattr(got[0], k)[..., quiet, :],
                           getattr(st_k8, k)[..., quiet, :]) or \
                not torch.equal(getattr(got[0], k)[1::2],
                                getattr(st_k8, k)[1::2]):
            fail(f"{prefix}K8: unflagged blocks' or frozen lanes' {k} changed")
    if bool(got[1][:, quiet].any()) or bool(got[1][1::2].any()):
        fail(f"{prefix}K8: unflagged blocks or frozen lanes report an eta "
             f"change")
    phase('check', f"{prefix}K8 unflagged blocks and frozen lanes bit-exact "
                   f"(gamma, mu, eta; eta_diff 0)")
    got = mix_kernel('cavi_sweep_mix_s', sub, state, sb, nf, hyper,
                     torch.zeros_like(act))
    for k in MixState._fields:
        if not torch.equal(getattr(got[0], k), getattr(state, k)):
            fail(f"{prefix}K7, every lane frozen: {k} changed")
    if bool(got[1].any()):
        fail(f"{prefix}K7, every lane frozen: an eta change reported")
    phase('check', f"{prefix}K7 every lane frozen (all-frozen lane tiles): "
                   f"state bit-exact (gamma, mu, eta, q; eta_diff 0)")
    widths = []
    for n in (3, *(L + e for L in cavi_cuda.MIX_SWEEP_LANE_TILES
                   for e in (0, 1))):
        lanes = torch.tensor([3, 10, 17], device=dev) if n == 3 else \
            torch.arange(n, device=dev) % S
        got = mix_kernel('cavi_sweep_mix_s', sub,
                         MixState(*(x[lanes].contiguous() for x in state)),
                         sb, nf, MixHyper(*(x[lanes] for x in hyper)),
                         torch.ones(n, device=dev))
        L = cavi_cuda.mix_sweep_lane_tile(n, MIX_K)
        for k, a, b in zip((*MixState._fields, 'eta_diff'),
                           (*got[0], got[1]), (*full[0], full[1])):
            if not torch.equal(a, b[lanes]):
                fail(f"{prefix}mixture lane independence: {k} at S = {n} (lane "
                     f"tile {L}) differs from the same lanes at S = {S}")
        widths.append(f"{n} ({L})")
    phase('check', f"{prefix}mixture lane independence: lanes 3, 10, 17 at "
                   f"S = 3 and the first lanes at S (lane tile) = "
                   f"{', '.join(widths[1:])} bit-identical to the same lanes "
                   f"at S = {S} (gamma, mu, eta, q, eta_diff)")
    same_bits_dense_walk(f'{prefix}K7', sub, lambda x: mix_kernel(
        'cavi_sweep_mix_s', x, state, sb, nf, hyper, act))
    same_bits_dense_walk(f'{prefix}K8', sub, lambda x: mix_kernel(
        name, x, st_k8, sb, nf, hyper, half_act, blk))
    # every K instance family: K = 1 (lane tile 20) and K = 8 (lane tile 4)
    for K in (1, 8):
        st_K, h_K = _mix_lane_state(sub, S, m, rng, K)
        check_mix_state(f'{prefix}K7 S={S} K={K} (lane tile '
                        f'{cavi_cuda.mix_sweep_lane_tile(S, K)})',
                        mix_kernel('cavi_sweep_mix_s', sub, st_K, sb, nf, h_K,
                                   act),
                        mix_plain('cavi_sweep_mix_s', sub, st_K, sb, nf, h_K,
                                  act), errs7)
    torch.cuda.synchronize()


def mix_probes(name, ld, st, sb, nf, h, act, blk, unit_diag, tag='M5'):
    """M5, the mixture block sweep of ``name`` alone (its coupling tiles not
    applied) over the blocks flagged in ``blk`` on the genome, against its
    bounds (the nonzero 32 x 32 blocks, and every tile dense): the sweep
    split into inner steps, rank-T updates and the rest by probes of 0 and
    1 inner steps; the dense rank-T walk (every 32 x 32 block flagged)
    timed and held bit-identical; for K7 the sweep at S = 8 and 20 (lane
    tiles 8 and 20). ``act`` None: the single model (K5/K6), whose state
    and hyperparameters go in as one lane."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    single = act is None
    if single:
        st, h = MixState(*(x[None] for x in st)), h.lanes()
    S, K = st.gamma.shape[:2]
    dense_ld = dense_diag_flags(ld)

    def sweep(x, k):
        return cavi_cuda.block_sweep_mix(x, st, sb, nf, h, act, blk,
                                         unit_diag, name, inner_steps=k)

    # CUDA events around the calls (the card's waits for the host
    # included) and around replays of a CUDA graph of one call (without)
    probes = ((ld, 8), (dense_ld, 8), (ld, 0), (ld, 1))
    ev_8, ev_dense, ev_0, ev_1 = (time_ms(lambda: sweep(x, k), reps=5)
                                  for x, k in probes)
    ms_8, ms_dense, ms_0, ms_1 = (graph_ms(lambda: sweep(x, k), reps=5)
                                  for x, k in probes)
    if name != 'cavi_sweep_mix_s_skip':   # K8's is held in M3
        same_bits_dense_walk(f'{tag} {name}, {int(blk.sum())} blocks', ld,
                             lambda x: sweep(x, 8))
    del dense_ld
    if single:
        # the single-model kernel does the same rank-T work at any step
        # count: the probes split off the inner steps only
        step = (ms_8 - ms_1) / 7
        split = dict(inner_steps=8 * step, rest=ms_1 - step,
                     every_block_extra=ms_dense - ms_8)
        text = (f"8 inner steps {split['inner_steps']:.3f}, the rest "
                f"(tile staging, set-up, rank-T updates, state I/O) "
                f"{split['rest']:.3f}; every block flagged adds "
                f"{split['every_block_extra']:.3f}")
    else:
        split = probe_split(ms_8, ms_dense, ms_0, ms_1)
        text = (f"8 inner steps {split['inner_steps']:.3f}, rank-T updates "
                f"over the nonzero blocks {split['rank_t']:.3f} (every "
                f"block {split['rank_t_dense']:.3f}), the rest (state I/O, "
                f"tile staging) {split['rest']:.3f}")
    b_nz = bound(*sweep_work_nz(ld, S, 2 * K + 2, 2 * K + 3, blk)[:2])
    b_dense = bound(*sweep_work(ld, S, 2 * K + 2, 2 * K + 3,
                                int(blk.sum())))
    phase(tag, f"{name} sweep alone, {int(blk.sum())} blocks: "
                f"{ms_8:.3f} ms in a CUDA graph, {ev_8:.3f} ms by CUDA "
                f"events (bound {b_nz[0]:.3f} ms by {b_nz[1]} over the "
                f"nonzero 32 x 32 blocks = {100 * b_nz[0] / ms_8:.0f}% of "
                f"it; every tile dense {b_dense[0]:.3f} ms by "
                f"{b_dense[1]}), split (ms, graph): {text}; probes (graph, "
                f"events): 0 steps {ms_0:.3f}, {ev_0:.3f}; 1 step "
                f"{ms_1:.3f}, {ev_1:.3f}; 8 steps every block flagged "
                f"{ms_dense:.3f}, {ev_dense:.3f}")
    rec = dict(sweep_ms=ms_8, sweep_event_ms=ev_8, split=split,
               every_block_ms=ms_dense,
               probe_event_ms=dict(steps_0=ev_0, steps_1=ev_1,
                                   every_block=ev_dense),
               sweep_bound_ms=b_nz[0], sweep_bound_by=b_nz[1],
               sweep_bound_ms_dense=b_dense[0])
    if name == 'cavi_sweep_mix_s':
        lane_tiles = {}
        for n in (8, S):
            st_n = MixState(*(x[:n].contiguous() for x in st))
            h_n = MixHyper(*(x[:n] for x in h))
            lane_tiles[n] = (cavi_cuda.mix_sweep_lane_tile(n, K), time_ms(
                lambda: cavi_cuda.cavi_sweep_mix_s(ld, st_n, sb, nf, h_n,
                                                   act[:n]), reps=5))
        phase(tag, 'K7 by lane tile, all blocks, coupling included: '
              + ', '.join(f"S = {n} (lane tile {L}) {ms:.3f} ms"
                          for n, (L, ms) in lane_tiles.items()))
        rec['lane_tiles'] = lane_tiles
    torch.cuda.empty_cache()
    return rec


def s1_coupling_times(ld, q, d, blk, errs, tag='M5'):
    """M5 (and F3), the coupling part of K5/K6 alone: coupling_pass_s1 on
    the block sweep's output (q, d: (1, NB, B)) over the tiles with an end
    flagged in ``blk``, the kernel in place on a copy of q (as the sweeps
    apply it) and the public wrapper (a clone, then the kernel), against
    its plain version, torch.bmm and its bound."""
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    n_til = _tiles_touching(ld, blk)
    scratch = q.clone()
    ms = time_ms(lambda: cavi_cuda.coupling_pass_s1_inplace(
        ld, scratch, d, blk), reps=10)
    dev = graph_ms(lambda: cavi_cuda.coupling_pass_s1_inplace(
        ld, scratch, d, blk), reps=10)
    ms_clone = time_ms(lambda: cavi_cuda.coupling_pass_s1(ld, q, d, blk),
                       reps=10)
    del scratch
    plain_ms = time_ms(lambda: cavi_torch.coupling_pass(ld, q, d, blk),
                       reps=2, warmup=1)
    check(f'{tag} coupling_pass_s1 over {n_til} tiles after the mixture '
          f'sweep', 'q', cavi_cuda.coupling_pass_s1(ld, q, d, blk),
          cavi_torch.coupling_pass(ld, q, d, blk), TOL_COUPLING, errs)
    lib = library_coupling_ms(ld, d) if n_til == ld.n_off else None
    b_ms, b_by = bound(*coupling_work(ld, 1, blk))
    phase(tag, f"coupling_pass_s1 alone, {n_til} tiles: in place "
                f"{ms:.4f} ms by CUDA events, {dev:.4f} ms in a CUDA graph; "
                f"with the clone {ms_clone:.4f} ms by events (plain "
                f"{plain_ms:.3f} ms"
                + (f", torch.bmm {lib:.3f} ms" if lib is not None else '')
                + f", bound {b_ms:.5f} ms by {b_by})")
    return dict(ms=ms, graph_ms=dev, ms_with_clone=ms_clone,
                plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, tiles=n_til)


def mix_genome(ds):
    """M2: VIPRSMix(K=3) on the genome as bench.py fits it, cold, warm and
    with the all-active sweep; launch counters reset before each fit."""
    import torch
    from viprs_tpu_torch.model import VIPRSMix
    from viprs_tpu_torch.ops import cavi_cuda
    runs = {}
    for name, kw in (('cold', {}), ('warm', {}),
                     ("sweep_impl='xla'", {'sweep_impl': 'xla'})):
        np.random.seed(0)
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        model = VIPRSMix(ds, 'cuda', K=MIX_K).fit(max_iter=500, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = model.optim_result
        runs[name] = dict(seconds=dt, nit=r.nit, h2=model.get_heritability(),
                          success=bool(r.success), message=r.message,
                          ms_per_it=1e3 * dt / max(r.nit, 1),
                          pi=model.pi.tolist(),
                          launches=dict(cavi_cuda.LAUNCHES))
        phase('M2', f"VIPRSMix(K={MIX_K}) {name}: {dt:.3f} s, nit {r.nit} "
                    f"({runs[name]['ms_per_it']:.2f} ms/it), h2 "
                    f"{model.get_heritability()!r} (JAX package: "
                    f"{REF_MIX_H2}), pi {np.round(model.pi, 6).tolist()}, "
                    f"'{r.message}'; launches {runs[name]['launches']}")
        if name == 'warm':
            # the blocks K6 sweeps per iteration (its activity mask)
            blocks = np.asarray(model._last_result.act_hist[1:])
            q = np.quantile(blocks, [0, .1, .25, .5, .75, .9, 1])
            edges = [0, 57, 114, 227, 567, 1133]
            hist = np.histogram(blocks, bins=edges)[0].tolist()
            runs[name]['k6_blocks'] = dict(
                per_iteration=blocks.tolist(), quantiles=q.tolist(),
                histogram=dict(edges=edges, counts=hist))
            phase('M2', f"K6 blocks swept per iteration, of {ds.ld.nb}: "
                        f"min/10%/25%/median/75%/90%/max "
                        f"{[int(x) for x in q]}; iterations by blocks "
                        + ', '.join(f"[{a}, {b}): {c}" for a, b, c in
                                    zip(edges, edges[1:], hist)))
        if name == 'cold':
            pip = np.concatenate([model.pip[c] for c in model.chromosomes])
            if pip.shape != (ds.m,) or not np.isfinite(pip).all():
                fail("the mixture PIP is not finite of shape (M,)")
    cold, warm = runs['cold'], runs['warm']
    if not (cold['success'] and warm['success']):
        fail(f"VIPRSMix did not converge: {warm['message']}")
    if warm['nit'] != cold['nit'] or warm['h2'] != cold['h2']:
        fail("repeated mixture fits differ")
    if abs(warm['h2'] - REF_MIX_H2) > 0.005:
        fail(f"the mixture h2 {warm['h2']} is not within 0.005 of "
             f"{REF_MIX_H2}")
    if warm['nit'] != PORT_MIX_NIT or abs(warm['h2'] - PORT_MIX_H2) > 5e-7:
        fail(f"VIPRSMix moved: nit {warm['nit']}, h2 {warm['h2']:.6f} (the "
             f"port's earlier runs: {PORT_MIX_NIT}, {PORT_MIX_H2})")
    if cold['launches']['cavi_sweep_mix_s1_skip'] < 1:
        fail(f"the default mixture fit never launched K6: {cold['launches']}")
    if runs["sweep_impl='xla'"]['launches']['cavi_sweep_mix_s1'] < 1:
        fail("the all-active mixture fit never launched K5")
    runs['profile'] = profile_fit(
        ds, dict(max_iter=500), trace_name=None,
        make=lambda: VIPRSMix(ds, 'cuda', K=MIX_K))
    return runs


def mix_grid_genome(ds):
    """M4 (F5 on the genome packed as float32): bench.py's 20-point mixture
    grid (K = 3) on the genome, cold, warm and with the union-gated sweep;
    launch counters as in M2 (the lane kernels' instances for the LD's
    tiles launched, no other one). The cold fit's per-lane nit and h2 are
    held bit for bit to the port's earlier runs (PORT_MIX_GRID_*, or
    PORT_F32_MIX_GRID_* for float32 LD, on which every lane must also
    converge); one warm fit under torch.profiler."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSMixGrid
    from viprs_tpu_torch.ops import cavi_cuda
    f32 = ds.ld.diag.dtype == torch.float32
    tag, held_nit, held_h2 = \
        ('F5', PORT_F32_MIX_GRID_NIT, PORT_F32_MIX_GRID_H2) if f32 else \
        ('M4', PORT_MIX_GRID_NIT, PORT_MIX_GRID_H2)
    sfx = '_f32' if f32 else ''
    # every kernel instance of the other tile type
    other = [k for k in cavi_cuda.LAUNCHES if k.endswith('_f32') != f32]
    runs = {}
    for name, kw in (('cold', {}), ('warm', {}),
                     ("sweep_impl='skip'", {'sweep_impl': 'skip'})):
        np.random.seed(0)
        grid = HyperparameterGrid(n_snps=ds.m, **MIX_GRID_SPEC)
        g = VIPRSMixGrid(ds, grid, 'cuda', K=MIX_K)
        if g.n_models != 20:
            fail(f"the bench mixture grid has {g.n_models} points, not 20")
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        g.fit(max_iter=500, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        h2 = g.get_heritability()
        out = dict(fit_s=dt, converged=int(g.converged_models.sum()),
                   valid=int(g.valid_terminated_models.sum()),
                   nit_max=int(g._nit.max()),
                   nit_median=float(np.median(g._nit)),
                   ms_per_it=1e3 * dt / max(int(g._nit.max()), 1),
                   widths=list(g._chunk_trace),
                   h2_range=[float(h2.min()), float(h2.max())],
                   nit=[int(x) for x in g._nit], h2=[float(x) for x in h2],
                   elbo=[float(x) for x in g.elbo()],
                   launches=dict(cavi_cuda.LAUNCHES))
        runs[name] = out
        phase(tag, f"VIPRSMixGrid(20 x K={MIX_K}) on {ds.ld.diag.dtype} LD "
                   f"{name}: fit {dt:.3f} s ({out['ms_per_it']:.2f} ms/it at "
                   f"nit max), converged {out['converged']}/20 (JAX package: "
                   f"20/20), valid {out['valid']}/20, nit max "
                   f"{out['nit_max']} median {out['nit_median']:g}; widths "
                   f"per chunk {_runs(out['widths'])}; h2 "
                   f"{h2.min():.4f}..{h2.max():.4f}; launches "
                   f"{ {k: v for k, v in out['launches'].items() if v} }")
        if name != "sweep_impl='skip'" and out['valid'] < 20:
            fail(f"{tag} {name}: only {out['valid']}/20 mixture grid points "
                 f"terminated validly")
        if f32 and name != "sweep_impl='skip'" and out['converged'] < 20:
            fail(f"{tag} {name}: only {out['converged']}/20 mixture grid "
                 f"points converged")
        if any(out['launches'][k] for k in other):
            fail(f"{tag} {name}: the mixture grid on {ds.ld.diag.dtype} LD "
                 f"launched another tile type's kernel: {out['launches']}")
        if name == 'cold':
            pip = np.concatenate([g.pip[c] for c in g.chromosomes])
            if pip.shape != (ds.m, 20) or not np.isfinite(pip).all():
                fail("the mixture grid's PIP is not finite of shape (M, 20)")
    if runs['cold']['launches']['cavi_sweep_mix_s' + sfx] < 1:
        fail(f"{tag}: the mixture grid never launched K7")
    if runs["sweep_impl='skip'"]['launches']['cavi_sweep_mix_s_skip' + sfx] \
            < 1:
        fail(f"{tag}: the union-gated mixture grid never launched K8")
    if runs['warm']['widths'] != runs['cold']['widths'] or \
            runs['warm']['nit_max'] != runs['cold']['nit_max']:
        fail(f"{tag}: repeated mixture grid fits differ")
    cold = runs['cold']
    same = cold['nit'] == held_nit and cold['h2'] == held_h2
    phase(tag, f"cold per-lane nit {cold['nit']}; h2 {cold['h2']}; ELBO "
               f"{cold['elbo']}: nit and h2 "
               f"{'bit-identical to' if same else 'DIFFER from'} the port's "
               f"earlier runs")
    if not same:
        fail(f"{tag}: the mixture grid's per-lane nit or h2 moved from the "
             f"port's earlier runs ({'PORT_F32' if f32 else 'PORT'}"
             f"_MIX_GRID_NIT, _H2)")
    runs['profile'] = profile_fit(
        ds, dict(max_iter=500), trace_name=None, make=lambda: VIPRSMixGrid(
            ds, HyperparameterGrid(n_snps=ds.m, **MIX_GRID_SPEC), 'cuda',
            K=MIX_K))
    return runs


def mix_times(ds, errs, names=tuple(MIX_KERNELS)):
    """M5 (F6 on the genome packed as float32): the mixture kernels
    ``names`` against their plain versions at the genome's shapes, from the
    first iteration's state of VIPRSMix(K=3) and of the 20-point mixture
    grid: checks, times, and the work that bounds them."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSMix, VIPRSMixGrid
    from viprs_tpu_torch.ops import cavi_cuda, cavi_mix
    from viprs_tpu_torch.ops.cavi_mix import MixState
    ld = ds.ld
    dev = ld.device
    tag = 'F6' if ld.diag.dtype == torch.float32 else 'M5'
    sb, nf = ds.device_inputs()
    K = MIX_K
    inputs = {}
    if not all(MIX_KERNELS[n][1] for n in names):
        np.random.seed(0)
        m1 = VIPRSMix(ds, 'cuda', K=K)
        m1.initialize()
        inputs['cavi_sweep_mix_s1'] = inputs['cavi_sweep_mix_s1_skip'] = (
            m1._state, m1._hyper_dev(), None)
        del m1
    np.random.seed(0)
    mg = VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m, **MIX_GRID_SPEC),
                      'cuda', K=K)
    mg.initialize()
    S = mg.n_models
    act = torch.ones(S, device=dev)
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    inputs['cavi_sweep_mix_s'] = inputs['cavi_sweep_mix_s_skip'] = (
        mg._state, mg._hyper_dev(), act)
    del mg
    out = {}
    for name in names:
        st, h, a = inputs[name]
        lanes, skip = MIX_KERNELS[name][1:]
        blk = None
        if skip:
            blk = (cavi_mix.mix_block_proposal_mask_batch(
                ld, st, sb, nf, h) & (a > 0)[:, None]).any(dim=0) if lanes \
                else cavi_mix.mix_block_proposal_mask(ld, st, sb, nf, h)
            blk = blk.to(torch.int32)
        n_blk = ld.nb if blk is None else int(blk.sum())
        n_til = ld.n_off if blk is None else _tiles_touching(ld, blk)
        S_k = S if lanes else 1
        work_dense = _add(sweep_work(ld, S_k, 2 * K + 2, 2 * K + 3, n_blk),
                          coupling_work(ld, S_k, blk))
        # the bound counts what this LD needs: its nonzero 32 x 32 blocks
        work = _add(sweep_work_nz(ld, S_k, 2 * K + 2, 2 * K + 3, blk)[:2],
                    coupling_work(ld, S_k, blk))
        b_ms, b_by = bound(*work)
        ms = time_ms(lambda: mix_kernel(name, ld, st, sb, nf, h, a, blk),
                     reps=5)
        plain = time_ms(lambda: mix_plain(name, ld, st, sb, nf, h, a, blk),
                        reps=2, warmup=1)
        got = mix_kernel(name, ld, st, sb, nf, h, a, blk)
        want = mix_plain(name, ld, st, sb, nf, h, a, blk)
        what = f'{tag} {name} at the genome, {n_blk} of {ld.nb} blocks'
        check_mix_state(what, got, want, errs[name])
        check_accuracy(what, got, want,
                       mix_plain_f64(name, ld, st, sb, nf, h, a, blk))
        del got, want
        b_dense = bound(*work_dense)
        # the whole composition (sweep, coupling pass and the small ops
        # around them) without the card's waits for the host
        dev_ms = graph_ms(lambda: mix_kernel(name, ld, st, sb, nf, h, a,
                                             blk), reps=5)
        rec = dict(ms=ms, graph_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by,
                   bound_ms_dense=b_dense[0], bound_by_dense=b_dense[1],
                   blocks=n_blk, tiles=n_til, S=S_k, bytes=work[0],
                   flops=work[1])
        few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
        few[::20] = 1
        if skip:
            rec['ms_5pct'] = time_ms(lambda: mix_kernel(
                name, ld, st, sb, nf, h, a, few), reps=5)
            rec['graph_ms_5pct'] = graph_ms(lambda: mix_kernel(
                name, ld, st, sb, nf, h, a, few), reps=5)
            rec['plain_ms_5pct'] = time_ms(lambda: mix_plain(
                name, ld, st, sb, nf, h, a, few), reps=2, warmup=1)
            rec['bound_5pct'] = bound(*_add(
                sweep_work_nz(ld, S_k, 2 * K + 2, 2 * K + 3, few)[:2],
                coupling_work(ld, S_k, few)))
            if lanes:
                rec['ms_all_blocks'] = time_ms(lambda: mix_kernel(
                    name, ld, st, sb, nf, h, a, ones), reps=5)
        mask = ones if blk is None else blk
        rec.update(mix_probes(name, ld, st, sb, nf, h, a, mask, skip, tag))
        if skip and not lanes:
            rec['at_5pct'] = mix_probes(name, ld, st, sb, nf, h, a, few,
                                        skip, tag)
        # the coupling part alone, on the block sweep's output
        if lanes:
            new, d = cavi_cuda.block_sweep_mix(ld, st, sb, nf, h, a, mask,
                                               skip, name)
            rec['coupling'] = coupling_times(ld, new.q, d, mask, (S_k,),
                                             errs[name], tag=tag)[S_k]
        else:
            new, d = cavi_cuda.block_sweep_mix(
                ld, MixState(*(x[None] for x in st)), sb, nf, h.lanes(),
                None, mask, skip, name)
            rec['coupling'] = s1_coupling_times(ld, new.q, d, mask,
                                                errs[name], tag)
            if skip:
                new, d = cavi_cuda.block_sweep_mix(
                    ld, MixState(*(x[None] for x in st)), sb, nf, h.lanes(),
                    None, few, skip, name)
                rec['coupling_5pct'] = s1_coupling_times(ld, new.q, d, few,
                                                         errs[name], tag)
        del new, d
        out[name] = rec
        phase(tag, f"{name} (S={S_k}, K={K}), first-iteration state, "
                    f"{n_blk} of {ld.nb} blocks, {n_til} coupling tiles: "
                    f"{ms:.3f} ms by CUDA events, {dev_ms:.3f} ms in a CUDA "
                    f"graph (plain {plain:.3f} ms); bound {b_ms:.3f} ms "
                    f"by {b_by} ({work[0] / 1e9:.3f} GB, {work[1] / 1e9:.1f} "
                    f"GFLOP) = {100 * b_ms / ms:.0f}% of it"
                    + (f" (the nonzero 32 x 32 blocks; every tile dense "
                       f"{b_dense[0]:.3f} ms by {b_dense[1]})")
                    + (f"; at {int(few.sum())} blocks {rec['ms_5pct']:.3f} ms "
                       f"by events, {rec['graph_ms_5pct']:.3f} ms in a CUDA "
                       f"graph (plain {rec['plain_ms_5pct']:.3f} ms, bound "
                       f"{rec['bound_5pct'][0]:.3f} ms by "
                       f"{rec['bound_5pct'][1]})" if skip else '')
                    + (f"; every block flagged {rec['ms_all_blocks']:.3f} ms"
                       if skip and lanes else ''))
    del inputs
    torch.cuda.empty_cache()
    return out



# ------------------------------------------------------ float32 LD (F0-F3)
#: The float32 instances of the single-model kernels, as LAUNCHES names
#: them: (the TPU kernel line replaced, source).
F32_KERNELS = {
    'cavi_block_sweep_s1_f32': (133, 'cavi_s1.cu'),
    'coupling_pass_s1_f32': (492, 'cavi_s1.cu'),
    'cavi_sweep_mix_s1_f32': (700, 'cavi_mix.cu'),
    'cavi_sweep_mix_s1_skip_f32': (1037, 'cavi_mix.cu'),
    # the lane kernels (F4-F6)
    'cavi_block_sweep_s_f32': (49, 'cavi_s.cu'),
    'coupling_pass_s_f32': (1191, 'cavi_s.cu'),
    'cavi_sweep_mix_s_f32': (849, 'mix_lane.cuh'),
    'cavi_sweep_mix_s_skip_f32': (1593, 'mix_lane.cuh'),
}


def _s1_state(sub, m, rng):
    """Phase 4's random S = 1 state on a cut: eta spread around zero, mu =
    5 eta, q = (R - I) eta, pi = 0.002 and tau_beta as at an h2 of 0.25."""
    import torch
    from viprs_tpu_torch.ops import cavi_torch
    from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
    dev = sub.device
    shape = (1, sub.nb, sub.block_size)
    pi = 0.002
    eta0 = torch.as_tensor(rng.standard_normal(shape) * 2e-3,
                           dtype=torch.float32, device=dev) * sub.mask
    state = CaviState(
        logits=torch.full(shape, math.log(pi / (1 - pi)), device=dev),
        mu=eta0 * 5.0, eta=eta0, q=cavi_torch.compute_q(sub, eta0))
    hyper = Hyper(*(torch.tensor([v], dtype=torch.float32, device=dev)
                    for v in (0.75, pi * m / 0.25, pi, 0.0)))
    return state, hyper


def _nz_blocks(ld):
    """The nonzero 32 x 32 blocks of the diagonal and the coupling tiles."""
    return int(ld.diag_nz.sum()), int(ld.off_nz.sum())


def f32_checks(ld32, sel, sb, nf, m, errs):
    """F1: the float32 instances on phase 4's 8 blocks, cut from the
    float32 packing, against their plain versions on the card with phase
    4's and M1's relative bounds: K1, K2 (half the blocks flagged; none
    flagged: the state bit-exact), the coupling pass in place and with its
    clone (bit for bit the same q) against refresh_q, K5 and K6 at K = 3;
    on the cut and on the cut with a third of its 32 x 32 blocks zeroed,
    each zero-block skip (the block sweeps, the coupling pass) bit for bit
    against its dense walk, the sign of a zero included. Returns the cut."""
    import torch
    dev = ld32.device
    sub = cut_blocks(ld32, sel, dev)
    if sub.diag.dtype != torch.float32 or sub.off_data.dtype != torch.float32:
        fail(f"F1: the cut's tiles are {sub.diag.dtype}, not float32")
    nz_d, nz_c = _nz_blocks(sub)
    phase('F1', f"{sub.nb} blocks cut from the float32 packing, {sub.n_off} "
                f"coupling tiles, scale {sub.scale}: {nz_d} of "
                f"{sub.diag_nz.numel()} blocks of 32 x 32 nonzero in the "
                f"diagonal tiles, {nz_c} of {sub.off_nz.numel()} in the "
                f"coupling tiles")
    s1_cut_checks(sub, m, sb, nf, errs['cavi_block_sweep_s1_f32'],
                  errs['coupling_pass_s1_f32'], prefix='F1 ',
                  need_zeros=False)
    st20, h20 = _mix_lane_state(sub, 20, m, np.random.default_rng(2))
    one, h1 = _mix_one(st20, h20, 4)
    mix_s1_cut_checks(sub, one, h1, sb, nf, errs['cavi_sweep_mix_s1_f32'],
                      errs['cavi_sweep_mix_s1_skip_f32'], prefix='F1 ',
                      need_zeros=False)
    torch.cuda.synchronize()
    return sub


def f32_cut_fits(sub, sb, nf):
    """F1: VIPRS and VIPRSMix(K=3) on the float32 cut, the kernels on the
    card against the plain versions on the CPU (np.random.seed(0) each):
    h2 within 1e-4 and nit within 2, as phase 4 holds the int8 cut fit."""
    import torch
    from viprs_tpu_torch.model import VIPRS, VIPRSMix
    out = {}
    for label, make in (('VIPRS', VIPRS),
                        (f'VIPRSMix(K={MIX_K})',
                         lambda d, w: VIPRSMix(d, w, K=MIX_K))):
        fits = {}
        for where in ('cuda', 'cpu'):
            dsx = _dataset_from_cut(sub, sb, nf, torch.device(where))
            np.random.seed(0)
            fits[where] = make(dsx, where).fit(max_iter=500)
        gc, gp = fits['cuda'], fits['cpu']
        h_c, h_p = gc.get_heritability(), gp.get_heritability()
        dh2 = abs(h_c - h_p)
        out[label] = dict(nit=[gc.optim_result.nit, gp.optim_result.nit],
                          h2=[h_c, h_p])
        phase('F1', f"{label} fit on the float32 cut: nit "
                    f"{gc.optim_result.nit} (card) vs {gp.optim_result.nit} "
                    f"(plain, CPU); h2 {h_c:.6f} vs {h_p:.6f} (|diff| "
                    f"{dh2:.2e}, bound 1e-4)")
        if not (gc.optim_result.success and dh2 <= 1e-4
                and abs(gc.optim_result.nit - gp.optim_result.nit) <= 2):
            fail(f"F1: the {label} fit on the float32 cut disagrees with the "
                 f"plain fit")
    return out


def f32_genome(ds32, fit_kw):
    """F2: VIPRS and VIPRSMix(K=3) on the genome packed as float32: VIPRS
    with phase 5's arguments cold, warm (3 times) and all-active
    (sweep_impl='xla'); VIPRSMix(K=3).fit(max_iter=500) cold, warm and
    'xla' (K5); launch counters reset before each fit and read after it;
    one warm fit of each under torch.profiler. Each fit converges, repeated
    fits take the same nit, h2 lies within 0.005 of the JAX package's and
    nit and h2 are the port's earlier float32 runs' (PORT_F32_*); the fits
    launch the float32 instances and no int8 one."""
    import torch
    from viprs_tpu_torch.model import VIPRS, VIPRSMix
    from viprs_tpu_torch.ops import cavi_cuda
    int8_s1 = ('cavi_block_sweep_s1', 'coupling_pass_s1',
               'cavi_sweep_mix_s1', 'cavi_sweep_mix_s1_skip')
    out = {}
    for model, make, kw_fit, runs_kw, ref, port_int8 in (
            ('VIPRS', lambda: VIPRS(ds32, 'cuda'), fit_kw,
             (('cold', {}), ('warm0', {}), ('warm1', {}), ('warm2', {}),
              ("sweep_impl='xla'", {'sweep_impl': 'xla'})), REF_H2, PORT_H2),
            (f'VIPRSMix(K={MIX_K})', lambda: VIPRSMix(ds32, 'cuda', K=MIX_K),
             dict(max_iter=500),
             (('cold', {}), ('warm0', {}),
              ("sweep_impl='xla'", {'sweep_impl': 'xla'})), REF_MIX_H2,
             PORT_MIX_H2)):
        runs = {}
        for name, kw in runs_kw:
            np.random.seed(0)
            torch.cuda.synchronize()
            cavi_cuda.reset_launches()
            t0 = time.perf_counter()
            m = make().fit(**kw_fit, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = m.optim_result
            launches = {k: v for k, v in cavi_cuda.LAUNCHES.items() if v}
            runs[name] = dict(seconds=dt, nit=r.nit, h2=m.get_heritability(),
                              success=bool(r.success), message=r.message,
                              ms_per_it=1e3 * dt / max(r.nit, 1),
                              n_skip=getattr(m, '_n_skip', None),
                              launches=launches)
            phase('F2', f"{model} on float32 LD, {name}: {dt:.3f} s, nit "
                        f"{r.nit} ({runs[name]['ms_per_it']:.2f} ms/it), h2 "
                        f"{m.get_heritability()!r}, '{r.message}'"
                        + (f", skip-branch iterations {m._n_skip}"
                           if model == 'VIPRS' else '')
                        + f"; launches {launches}")
            if not r.success:
                fail(f"F2: {model} {name} on float32 LD did not converge: "
                     f"{r.message}")
            if any(launches.get(k) for k in int8_s1):
                fail(f"F2: {model} {name} on float32 LD launched an int8 "
                     f"kernel: {launches}")
        cold = runs['cold']
        warm = sorted(v['seconds'] for k, v in runs.items()
                      if k.startswith('warm'))
        if any(v['nit'] != cold['nit'] for k, v in runs.items()
               if k.startswith('warm')):
            fail(f"F2: repeated {model} fits on float32 LD took different "
                 f"numbers of iterations")
        h2 = runs['warm0']['h2']
        phase('F2', f"{model} on float32 LD: nit {cold['nit']}, h2 {h2:.6f} "
                    f"(JAX package: {ref}; the int8 fit: {port_int8}, gap "
                    f"{h2 - port_int8:+.6f}); warm median "
                    f"{warm[len(warm) // 2]:.3f} s of {len(warm)}")
        if abs(h2 - ref) > 0.005:
            fail(f"F2: {model} h2 {h2} on float32 LD is not within 0.005 of "
                 f"{ref}")
        port_nit, port_h2 = (PORT_F32_NIT, PORT_F32_H2) if model == 'VIPRS' \
            else (PORT_F32_MIX_NIT, PORT_F32_MIX_H2)
        if cold['nit'] != port_nit or abs(h2 - port_h2) > 5e-7:
            fail(f"F2: {model} on float32 LD moved: nit {cold['nit']}, h2 "
                 f"{h2:.6f} (the port's earlier runs: {port_nit}, "
                 f"{port_h2})")
        runs['warm_median_s'] = warm[len(warm) // 2]
        runs['profile'] = profile_fit(ds32, kw_fit, trace_name=None,
                                      make=make)
        out[model] = runs
    s1 = out['VIPRS']
    mx = out[f'VIPRSMix(K={MIX_K})']
    launches = {
        'cavi_block_sweep_s1_f32': s1['cold']['launches'].get(
            'cavi_block_sweep_s1_f32', 0),
        'coupling_pass_s1_f32': s1['cold']['launches'].get(
            'coupling_pass_s1_f32', 0),
        'cavi_sweep_mix_s1_f32': mx["sweep_impl='xla'"]['launches'].get(
            'cavi_sweep_mix_s1_f32', 0),
        'cavi_sweep_mix_s1_skip_f32': mx['cold']['launches'].get(
            'cavi_sweep_mix_s1_skip_f32', 0)}
    if min(launches.values()) < 1:
        fail(f"F2: a float32 instance was never launched: {launches}")
    out['launches'] = launches
    return out



def f32_times(ds32, errs):
    """F3: the float32 instances on the float32 genome's first-iteration
    state (VIPRS and VIPRSMix(K=3) after np.random.seed(0)), by CUDA events
    and in CUDA graphs, each checked against and timed beside its plain
    version and its bounds (the nonzero 32 x 32 blocks, and every tile
    dense, at 4 bytes an element): the K1 block sweep over every block,
    alone and with its coupling pass (K1); coupling_pass_s1 in place over
    every tile, with its clone, and torch.bmm of the float32 tiles; K2 at
    every 20th block (57), its coupling part's torch.bmm; K5 and K6 at
    K = 3 (K6 at its activity mask and at every 20th block), their sweeps
    alone and their coupling parts alone."""
    import torch
    from viprs_tpu_torch.model import VIPRS, VIPRSMix
    from viprs_tpu_torch.ops import cavi_cuda, cavi_mix, cavi_torch
    from viprs_tpu_torch.ops.cavi_mix import MixState
    ld = ds32.ld
    dev = ld.device
    sb, nf = ds32.device_inputs()
    m = VIPRS(ds32, 'cuda')
    m.initialize_theta(rng=np.random.RandomState(0))
    m.initialize_variational_parameters()
    st0, h0 = m._state, m._hyper_dev()
    act = torch.ones(1, device=dev)
    ones = torch.ones(ld.nb, dtype=torch.int32, device=dev)
    few = torch.zeros(ld.nb, dtype=torch.int32, device=dev)
    few[::20] = 1
    e_sw, e_cpl = errs['cavi_block_sweep_s1_f32'], errs['coupling_pass_s1_f32']
    out = {}

    def sweep(mask):
        return cavi_cuda.block_sweep_s1(ld, st0, sb, nf, h0, act, mask)

    k1 = lambda: cavi_cuda.cavi_sweep_s1(ld, st0, sb, nf, h0, act)
    b_nz = bound(*sweep_work_nz(ld, 1, 4, 5)[:2])
    b_dense = bound(*sweep_work(ld, 1, 4, 5, ld.nb))
    b_cpl = bound(*coupling_work(ld, 1))
    out['sweep'] = dict(
        event_ms=time_ms(lambda: sweep(ones), reps=10),
        graph_ms=graph_ms(lambda: sweep(ones), reps=10),
        with_coupling_event_ms=time_ms(k1, reps=10),
        with_coupling_graph_ms=graph_ms(k1, reps=10),
        plain_ms=time_ms(lambda: cavi_torch.block_sweep(
            ld, st0, sb, nf, h0, act), reps=3, warmup=1),
        with_coupling_plain_ms=time_ms(lambda: cavi_torch.cavi_sweep(
            ld, st0, sb, nf, h0, act), reps=3, warmup=1),
        bound=b_nz, bound_dense=b_dense,
        with_coupling_bound=bound(*_add(sweep_work_nz(ld, 1, 4, 5)[:2],
                                        coupling_work(ld, 1))))
    new, d = sweep(ones)
    check_state(f'F3 K1 block sweep, all {ld.nb} blocks', (new, d),
                cavi_torch.block_sweep(ld, st0, sb, nf, h0, act), e_sw)
    check_state(f'F3 K1 with its coupling pass, all {ld.nb} blocks', k1(),
                cavi_torch.cavi_sweep(ld, st0, sb, nf, h0, act), e_sw)
    r = out['sweep']
    phase('F3', f"K1 float32 block sweep, all {ld.nb} blocks: "
                f"{r['graph_ms']:.3f} ms in a CUDA graph, {r['event_ms']:.3f} "
                f"ms by CUDA events (plain {r['plain_ms']:.3f} ms; bound "
                f"{b_nz[0]:.3f} ms by {b_nz[1]} over the nonzero 32 x 32 "
                f"blocks = {100 * b_nz[0] / r['graph_ms']:.0f}% of it, every "
                f"tile dense {b_dense[0]:.3f} ms by {b_dense[1]}); with its "
                f"coupling pass {r['with_coupling_graph_ms']:.3f} ms (graph), "
                f"{r['with_coupling_event_ms']:.3f} ms (events), plain "
                f"{r['with_coupling_plain_ms']:.3f} ms, bound "
                f"{r['with_coupling_bound'][0]:.3f} ms")

    scratch = new.q.clone()
    inplace = lambda: cavi_cuda.coupling_pass_s1_inplace(ld, scratch, d, ones)
    out['coupling'] = dict(
        event_ms=time_ms(inplace, reps=20), graph_ms=graph_ms(inplace,
                                                                reps=20),
        clone_event_ms=time_ms(lambda: cavi_cuda.coupling_pass_s1(
            ld, new.q, d, ones), reps=20),
        plain_ms=time_ms(lambda: cavi_torch.refresh_q(ld, new.q, d), reps=3,
                         warmup=1),
        library_ms=library_coupling_ms(ld, d), bound=b_cpl)
    del scratch
    check(f'F3 coupling_pass_s1 over {ld.n_off} float32 tiles vs refresh_q',
          'q', cavi_cuda.coupling_pass_s1(ld, new.q, d, ones),
          cavi_torch.refresh_q(ld, new.q, d), TOL_COUPLING, e_cpl)
    r = out['coupling']
    phase('F3', f"coupling_pass_s1 on float32 tiles, {ld.n_off} tiles, "
                f"{ld.cpl_slabs.numel()} block slabs: in place "
                f"{r['graph_ms']:.4f} ms in a CUDA graph, {r['event_ms']:.4f} "
                f"ms by CUDA events, with the clone {r['clone_event_ms']:.4f} "
                f"ms (plain {r['plain_ms']:.3f} ms, torch.bmm of the float32 "
                f"tiles {r['library_ms']:.3f} ms, bound {b_cpl[0]:.4f} ms by "
                f"{b_cpl[1]})")
    del new, d

    k2 = lambda: cavi_cuda.cavi_sweep_s1_skip(ld, st0, sb, nf, h0, act, few)
    new, d = sweep(few)
    scratch = new.q.clone()
    out['k2_5pct'] = dict(
        event_ms=time_ms(k2, reps=20), graph_ms=graph_ms(k2, reps=20),
        sweep_graph_ms=graph_ms(lambda: sweep(few), reps=20),
        coupling_graph_ms=graph_ms(lambda: cavi_cuda.coupling_pass_s1_inplace(
            ld, scratch, d, few), reps=20),
        plain_ms=time_ms(lambda: _plain_skip(ld, st0, sb, nf, h0, act, few),
                         reps=5),
        library_coupling_ms=library_coupling_ms(ld, d, bmm_tiles(
            ld, _tiles_on(ld, few))),
        bound=bound(*_add(sweep_work_nz(ld, 1, 4, 5, few)[:2],
                          coupling_work(ld, 1, few))),
        bound_dense=bound(*_add(sweep_work(ld, 1, 4, 5, int(few.sum())),
                                coupling_work(ld, 1, few))),
        blocks=int(few.sum()), tiles=_tiles_touching(ld, few))
    del scratch, new, d
    check_state(f'F3 K2 at {int(few.sum())} of {ld.nb} blocks', k2(),
                _plain_skip(ld, st0, sb, nf, h0, act, few), e_sw)
    r = out['k2_5pct']
    phase('F3', f"K2 on float32 LD at {r['blocks']} of {ld.nb} blocks, "
                f"{r['tiles']} coupling tiles: {r['graph_ms']:.3f} ms in a "
                f"CUDA graph, {r['event_ms']:.3f} ms by CUDA events (plain "
                f"{r['plain_ms']:.3f} ms; bound {r['bound'][0]:.4f} ms by "
                f"{r['bound'][1]}, every tile dense {r['bound_dense'][0]:.4f} "
                f"ms); its sweep alone {r['sweep_graph_ms']:.3f} ms, its "
                f"coupling part alone {r['coupling_graph_ms']:.4f} ms (graph; "
                f"torch.bmm of its tiles {r['library_coupling_ms']:.3f} ms)")
    del m
    torch.cuda.empty_cache()

    np.random.seed(0)
    mm = VIPRSMix(ds32, 'cuda', K=MIX_K)
    mm.initialize()
    st, h = mm._state, mm._hyper_dev()
    K = MIX_K
    for name, skip in (('cavi_sweep_mix_s1', False),
                       ('cavi_sweep_mix_s1_skip', True)):
        e = errs[name + '_f32']
        blk = cavi_mix.mix_block_proposal_mask(ld, st, sb, nf, h).to(
            torch.int32) if skip else None
        mask = ones if blk is None else blk
        n_blk = int(mask.sum())
        run = lambda b=blk: mix_kernel(name, ld, st, sb, nf, h, blk=b)
        work = _add(sweep_work_nz(ld, 1, 2 * K + 2, 2 * K + 3, blk)[:2],
                    coupling_work(ld, 1, blk))
        rec = dict(ms=time_ms(run, reps=5), graph_ms=graph_ms(run, reps=5),
                   plain_ms=time_ms(lambda: mix_plain(
                       name, ld, st, sb, nf, h, blk=blk), reps=2, warmup=1),
                   bound=bound(*work), bound_dense=bound(*_add(
                       sweep_work(ld, 1, 2 * K + 2, 2 * K + 3, n_blk),
                       coupling_work(ld, 1, blk))), blocks=n_blk)
        check_mix_state(f'F3 {name} on float32 LD, {n_blk} of {ld.nb} '
                        f'blocks', run(), mix_plain(name, ld, st, sb, nf, h,
                                                    blk=blk), e)
        one = MixState(*(x[None] for x in st))

        def alone(b):
            return cavi_cuda.block_sweep_mix(ld, one, sb, nf, h.lanes(), None,
                                             b, skip, name)
        rec['sweep_graph_ms'] = graph_ms(lambda: alone(mask), reps=5)
        new, d = alone(mask)
        rec['coupling'] = s1_coupling_times(ld, new.q, d, mask, e, tag='F3')
        del new, d
        if skip:
            rec['ms_5pct'] = time_ms(lambda: run(few), reps=5)
            rec['graph_ms_5pct'] = graph_ms(lambda: run(few), reps=5)
            rec['sweep_graph_ms_5pct'] = graph_ms(lambda: alone(few), reps=5)
            rec['bound_5pct'] = bound(*_add(
                sweep_work_nz(ld, 1, 2 * K + 2, 2 * K + 3, few)[:2],
                coupling_work(ld, 1, few)))
        out[name] = rec
        phase('F3', f"{name} (K={K}) on float32 LD, first-iteration state, "
                    f"{n_blk} of {ld.nb} blocks: {rec['graph_ms']:.3f} ms in "
                    f"a CUDA graph, {rec['ms']:.3f} ms by CUDA events (plain "
                    f"{rec['plain_ms']:.3f} ms; bound {rec['bound'][0]:.3f} "
                    f"ms by {rec['bound'][1]} over the nonzero 32 x 32 "
                    f"blocks, every tile dense {rec['bound_dense'][0]:.3f} "
                    f"ms); its sweep alone {rec['sweep_graph_ms']:.3f} ms "
                    f"(graph)"
                    + (f"; at {int(few.sum())} blocks "
                       f"{rec['graph_ms_5pct']:.3f} ms (graph), "
                       f"{rec['ms_5pct']:.3f} ms (events), its sweep alone "
                       f"{rec['sweep_graph_ms_5pct']:.3f} ms, bound "
                       f"{rec['bound_5pct'][0]:.4f} ms" if skip else ''))
    del mm
    torch.cuda.empty_cache()
    return out


# --------------------------------------- float32 LD, the grid models (F4-F6)
def f32_lane_checks(ds32, sel, sb, nf, errs):
    """F4: the float32 instances of the lane kernels on phase 4's 8 blocks,
    cut from the float32 packing, with G1's and M3's bounds: K3 at S = 100,
    3 and 13 (frozen lanes bit-exact), K4 at half the blocks (unflagged
    blocks bit-exact), lane independence across each lane tile's boundary
    and at S = 101, the coupling pass alone (input q untouched, lane
    independence), the dense walk (``grid_checks``); K7/K8 at S = 20,
    K = 3 and K7 at K = 1 and 8 (``mix_lane_checks``); then every
    zero-block skip on the cut and the zeroed cut (``lane_zero_block_checks``).
    Returns the cut."""
    import torch
    sub = cut_blocks(ds32.ld, sel, ds32.ld.device)
    if sub.diag.dtype != torch.float32 or sub.off_data.dtype != torch.float32:
        fail(f"F4: the cut's tiles are {sub.diag.dtype}, not float32")
    grid_checks(ds32, sub, sb, nf, errs['cavi_block_sweep_s_f32'],
                errs['coupling_pass_s_f32'], prefix='F4 ')
    rng = np.random.default_rng(2)
    state, hyper = _mix_lane_state(sub, 20, ds32.m, rng)
    mix_lane_checks(ds32.m, sub, sb, nf, state, hyper, rng,
                    errs['cavi_sweep_mix_s_f32'],
                    errs['cavi_sweep_mix_s_skip_f32'], prefix='F4 ')
    lane_zero_block_checks(sub, ds32.m, sb, nf, errs, prefix='F4 ')
    torch.cuda.synchronize()
    return sub


def lane_zero_block_checks(sub, m, sb, nf, errs, prefix='F4 '):
    """F4, the lane kernels on the cut and on the cut with a third of its
    32 x 32 blocks zeroed (inside and outside the (T, T) tiles, and in the
    coupling tiles), at S = 20 (the bench grid's rows; K = 3 for the
    mixture): K3 and K4 (half the blocks flagged), K7 and K8 against their
    plain versions; the block sweeps (every block, and half the blocks
    flagged) and the coupling pass with their real flags bit for bit, the
    sign of a zero included, against their dense walks (every 32 x 32 block
    flagged), and the coupling pass's input q untouched. ``errs``: the
    F32_KERNELS error lists."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
    dev = sub.device
    S = 20
    ones = torch.ones(sub.nb, dtype=torch.int32, device=dev)
    half = torch.zeros(sub.nb, dtype=torch.int32, device=dev)
    half[::2] = 1
    act = torch.ones(S, device=dev)
    hyper = grid_hyper(m, S, dev)
    for tag, x, need in (('the cut', sub, False),
                         ('the cut, blocks zeroed', zero_blocks_cut(sub),
                          True)):
        n_in, n_out = zero_blocks(x)
        n_cz, n_cnz = int((x.off_nz == 0).sum()), int(x.off_nz.sum())
        if need and not (n_in and n_out and n_cz and n_cnz):
            fail(f"{prefix}{tag}: the diagonal tiles need zero 32 x 32 "
                 f"blocks inside ({n_in}) and outside ({n_out}) the (T, T) "
                 f"tiles, the coupling tiles zero ({n_cz}) and nonzero "
                 f"({n_cnz}) ones")
        rng = np.random.default_rng(3)
        state = _lane_state(x, S, rng, hyper)
        check_state(f'{prefix}K3 S={S} on {tag}', cavi_cuda.cavi_sweep_s(
            x, state, sb, nf, hyper, act), cavi_torch.cavi_sweep(
            x, state, sb, nf, hyper, act), errs['cavi_block_sweep_s_f32'],
            TOL_S, state.eta)
        check_state(f'{prefix}K4 S={S} on {tag}, half the blocks flagged',
                    cavi_cuda.cavi_sweep_s_skip(x, state, sb, nf, hyper, act,
                                                half),
                    _plain_lanes(x, state, sb, nf, hyper, act, half),
                    errs['cavi_block_sweep_s_f32'], TOL_S, state.eta)
        dense_d, dense_c = dense_diag_flags(x), dense_off_flags(x)
        for label, mask in (('every block', ones), ('half the blocks', half)):
            t = f'{tag}, {label}'
            got = cavi_cuda.block_sweep_s(x, state, sb, nf, hyper, act, mask)
            _same_state(f'{prefix}K3 block sweep on {t}: the real diag_nz '
                        f'against the dense walk', got,
                        cavi_cuda.block_sweep_s(dense_d, state, sb, nf, hyper,
                                                act, mask))
            new, d = got
            q0 = new.q.clone()
            q = cavi_cuda.coupling_pass_s(x, new.q, d, mask)
            if not same_bits(new.q, q0):
                fail(f"{prefix}coupling_pass_s on {t} wrote its input q")
            if not same_bits(q, cavi_cuda.coupling_pass_s(dense_c, new.q, d,
                                                          mask)):
                fail(f"{prefix}coupling_pass_s on {t}: q with the real "
                     f"off_nz differs from the dense walk's")
        mst, mh = _mix_lane_state(x, S, m, rng)
        for name, mask in (('cavi_sweep_mix_s', None),
                           ('cavi_sweep_mix_s_skip', half)):
            check_mix_state(f'{prefix}{name} S={S} on {tag}', mix_kernel(
                name, x, mst, sb, nf, mh, act, mask), mix_plain(
                name, x, mst, sb, nf, mh, act, mask), errs[name + '_f32'])
            skip = mask is not None

            def sweep(y, b=ones if mask is None else mask):
                return cavi_cuda.block_sweep_mix(y, mst, sb, nf, mh, act, b,
                                                 skip, name)
            _same_state(f'{prefix}{name} block sweep on {tag}: the real '
                        f'diag_nz against the dense walk', sweep(x),
                        sweep(dense_d))
        phase('check', f"{prefix}{tag} ({n_in} zero 32 x 32 blocks inside "
                       f"the (T, T) tiles, {n_out} outside, {n_cz} zero and "
                       f"{n_cnz} nonzero in the {x.n_off} coupling tiles): "
                       f"K3, K4, K7 and K8 within bounds; the K3 block sweep "
                       f"and the coupling pass, every block and half the "
                       f"blocks flagged, and the K7 and K8 block sweeps bit "
                       f"for bit their dense walks; the coupling pass's "
                       f"input q untouched")


def f32_grid_cut_fits(sub, sb, nf):
    """F4: a 16-point VIPRSGrid fit (as G2) and an 8-point VIPRSMixGrid(K=3)
    fit on the float32 cut, the kernels on the card against the plain
    versions on the CPU (np.random.seed(0) each): per lane h2 within 1e-4
    and nit within 2."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSMixGrid
    out = {'VIPRSGrid': grid_cut_fit(sub, sb, nf, tag='F4', nit_window=2)}
    fits = {}
    for where in ('cuda', 'cpu'):
        dsx = _dataset_from_cut(sub, sb, nf, torch.device(where))
        np.random.seed(0)
        fits[where] = VIPRSMixGrid(dsx, HyperparameterGrid(
            pi_steps=8, n_snps=dsx.m), where, K=MIX_K).fit(max_iter=300)
    gc, gp = fits['cuda'], fits['cpu']
    nit_c = np.array([r.nit for r in gc.optim_results])
    nit_p = np.array([r.nit for r in gp.optim_results])
    h2_c, h2_p = gc.get_heritability(), gp.get_heritability()
    dh2 = float(np.max(np.abs(h2_c - h2_p)))
    dnit = int(np.max(np.abs(nit_c - nit_p)))
    phase('F4', f"VIPRSMixGrid(8 x K={MIX_K}) on the float32 cut: nit "
                f"{nit_c.tolist()} (card) vs {nit_p.tolist()} (plain, CPU); "
                f"max |dh2| {dh2:.2e} (bound 1e-4), max |dnit| {dnit} "
                f"(bound 2)")
    if not (gc.valid_terminated_models.all() and dh2 <= 1e-4 and dnit <= 2):
        fail("F4: the mixture grid fit on the float32 cut disagrees with the "
             "plain fit")
    out['VIPRSMixGrid'] = dict(nit=[nit_c.tolist(), nit_p.tolist()],
                               h2=[h2_c.tolist(), h2_p.tolist()])
    return out


# ------------------------------------------- model selection (P0-P5)
#: The port's own results of viprs_fit's selection flow on the genome (P2),
#: the same on every H100 run: the grid row selected by pseudo-R^2 and the
#: refit's h2 (int8 LD; float32 LD).
PORT_PV_INDEX, PORT_PV_H2 = 12, 0.24172945622183165
PORT_F32_PV_INDEX, PORT_F32_PV_H2 = 12, 0.24172779422571386
#: The kernels of each selection path, as LAUNCHES names them (float32
#: instances with '_f32' appended).
SELECT_PATHS = ('P0 GridSearch(VIPRS) int8', 'P0 GridSearch(VIPRS) float32',
                'P2 grid fit', 'P2 refit', 'P2 grid fit f32', 'P2 refit f32',
                'P3 pathwise', 'P4 host-stepped VIPRSMix', 'P4 fused VIPRSMix',
                'P4 GridSearch(VIPRSMix)')


def _pv_index(scores):
    """select_best_model's pseudo-validation choice."""
    return int(np.argmax(np.nan_to_num(np.asarray(scores, np.float64),
                                       nan=0., neginf=0., posinf=0.)))


def _launched(launches):
    return {k: v for k, v in launches.items() if v}


#: P0's guard: a lane's stop on the cut is clear of its thresholds when the
#: CPU stops it at the same iteration, with the same status, with f_abs_tol
#: or x_abs_tol scaled by STOP_MARGIN or by its inverse (the CPU tests'
#: LADDER_MARGIN). At n = 350,000 the ELBO carries ~1e-4 of float32
#: summation order, so a comparison near its threshold may go either way:
#: in one H100 run the pathwise grid's lane 3 stopped on the ELBO on the CPU
#: and on max |d eta| on the card, at the same iteration.
STOP_MARGIN = 2.0
#: The fits' own f_abs_tol and x_abs_tol, at which P0 runs them.
TOLS = (1e-6, 1e-6)


def guarded_stops(tag, what, run, card, cpu):
    """Hold the card's per-lane stops (tuples such as (nit, status)) to the
    CPU's on every lane whose stop is clear (STOP_MARGIN). Where the two
    disagree, the CPU repeats ``run(device, f_abs_tol, x_abs_tol)`` with
    each tolerance moved, and a lane whose stop moves with them is waived;
    a lane where the two agree needs no such proof. Fails on a clear lane
    that disagrees; returns the counts."""
    f, x, m = *TOLS, STOP_MARGIN
    off = [l for l, (a, b) in enumerate(zip(card, cpu)) if a != b]
    waived = set()
    if off:
        for tol in ((f * m, x), (f / m, x), (f, x * m), (f, x / m)):
            alt = run('cpu', *tol)
            waived |= {l for l in off if alt[l] != cpu[l]}
    clear_off = [l for l in off if l not in waived]
    phase(tag, f"{what}: {len(cpu) - len(off)} of {len(cpu)} stops as on "
               f"the CPU, {len(waived)} waived (within a factor {m:g} of a "
               f"threshold on the CPU: {sorted(waived)}), {len(clear_off)} "
               f"clear and different {clear_off}")
    if clear_off:
        fail(f"{tag}: {what} on the card stops clear lanes {clear_off} "
             f"otherwise than the CPU")
    return dict(stops=len(cpu), differ=len(off), waived=sorted(waived))


def select_cut_checks(sub, sb, nf, record_paths):
    """P0 on one packing of the 8-block cut: the selection layer with the
    kernels on the card against the plain versions on the CPU, every fit at
    its own tolerances (TOLS). The split, its factorizations on each
    device, within 1e-9; viprs_fit's selection flow on a 16-point grid
    (split, fit, pseudo_validate, select_best_model by pseudo-R^2, restore,
    refit) with the CPU's selected row, pseudo-R^2 within 1e-5 (relative)
    and the refit's h2 within 1e-6; GridSearch(VIPRS), one fit a row of a
    4-point grid (K1/K2 on the card), with the CPU's selected row and every
    row's ELBO within 1e-6 (relative); every lane of those fits, of the
    pathwise 16-point grid and of the host-stepped VIPRSMix(K=3) stopping
    at the CPU's iteration with the CPU's status where the stop is clear of
    its thresholds (guarded_stops); LDPredInf the CPU's posterior means
    within 1e-6 of the largest; infer_lambda_min the CPU's value within
    1e-9."""
    import torch
    from viprs_tpu_torch.data.split import sumstats_train_test_split
    from viprs_tpu_torch.gridsearch import (GridSearch, HyperparameterGrid,
                                            select_best_model)
    from viprs_tpu_torch.model import LDPredInf, VIPRS, VIPRSGrid, VIPRSMix
    from viprs_tpu_torch.ops import cavi_cuda
    kind = str(sub.diag.dtype).replace('torch.', '')
    sfx = '_f32' if sub.diag.dtype == torch.float32 else ''
    tag = f'P0 {kind}'
    where = ('cuda', 'cpu')
    dss = {w: _dataset_from_cut(sub, sb, nf, torch.device(w)) for w in where}
    rec = {}

    sp, t_sp = {}, {}
    for w in where:
        t0 = time.perf_counter()
        sp[w] = sumstats_train_test_split(dss[w], 0.8, seed=0)
        t_sp[w] = time.perf_counter() - t0
    d_sp = max(float(np.abs(sp['cuda'][c][k] - sp['cpu'][c][k]).max())
               for c in sp['cpu'] for k in ('train_beta', 'test_beta'))
    rec['split'] = dict(max_abs_diff=d_sp, seconds=t_sp)
    phase(tag, f"PUMAS split of the cut: card {t_sp['cuda']:.3f} s, CPU "
               f"{t_sp['cpu']:.3f} s, max |diff| {d_sp:.2e} (bound 1e-9)")
    if not d_sp <= 1e-9:
        fail(f"{tag}: the split on the card differs from the CPU's")

    def grid16(w):
        np.random.seed(0)
        return VIPRSGrid(dss[w], HyperparameterGrid(pi_steps=16,
                                                    n_snps=dss[w].m), w)

    def flow(w, f_abs_tol, x_abs_tol):
        tol = dict(max_iter=300, f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol)
        g = grid16(w)
        g.split_gwas_sumstats(prop_train=0.8, seed=0)
        g.fit(**tol)
        r = g._last_result
        stops = list(zip(r.nit.tolist(), r.status.tolist()))
        pv = g.pseudo_validate()
        select_best_model(g, criterion='pseudo_validation')
        g.restore_full_sumstats()
        g.fit(**tol)
        stops.append((g.optim_result.nit, g.optim_results[0].message))
        return dict(stops=stops, pv=pv.tolist(),
                    index=_pv_index(g.validation_result[
                        'Pseudo_Validation_R2']),
                    refit_h2=g.get_heritability())
    fl = {w: flow(w, *TOLS) for w in where}
    c, p = fl['cuda'], fl['cpu']
    pv_c, pv_p = np.asarray(c['pv']), np.asarray(p['pv'])
    d_pv = float(np.max(np.abs(pv_c - pv_p) / np.abs(pv_p)))
    d_h2 = abs(c['refit_h2'] - p['refit_h2'])
    phase(tag, f"selection flow, 16-point grid: (nit, status) per lane and "
               f"the refit's (nit, message) {c['stops']} (card) vs "
               f"{p['stops']} (CPU); pseudo-R^2 max relative |diff| "
               f"{d_pv:.2e} (bound 1e-5); selected row {c['index']} vs "
               f"{p['index']}; refit h2 {c['refit_h2']:.8f} vs "
               f"{p['refit_h2']:.8f} (|diff| {d_h2:.2e}, bound 1e-6)")
    if not (d_pv <= 1e-5 and c['index'] == p['index'] and d_h2 <= 1e-6):
        fail(f"{tag}: the selection flow on the card disagrees with the CPU")
    fl['guard'] = guarded_stops(tag, 'the selection flow',
                                lambda *a: flow(*a)['stops'], c['stops'],
                                p['stops'])
    rec['flow'] = fl

    def per_row(w, f_abs_tol, x_abs_tol):
        np.random.seed(0)
        gs = GridSearch(dss[w], HyperparameterGrid(pi_steps=4,
                                                   n_snps=dss[w].m), w,
                        model_class=VIPRS)
        best = gs.fit(max_iter=300, f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol)
        elbo = np.asarray(gs.validation_result['ELBO'], np.float64)
        return dict(elbo=elbo.tolist(), index=int(np.argmax(elbo)),
                    stops=[(best.optim_result.nit, best.optim_result.message)])
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    rows = {'cuda': per_row('cuda', *TOLS)}
    torch.cuda.synchronize()
    launches = dict(cavi_cuda.LAUNCHES)
    record_paths[f'P0 GridSearch(VIPRS) {kind}'] = launches
    rows['cpu'] = per_row('cpu', *TOLS)
    e_c, e_p = np.asarray(rows['cuda']['elbo']), np.asarray(rows['cpu']['elbo'])
    d_e = float(np.max(np.abs(e_c - e_p) / np.abs(e_p)))
    phase(tag, f"GridSearch(VIPRS), one fit a row of 4: selected row "
               f"{rows['cuda']['index']} vs {rows['cpu']['index']} (CPU), "
               f"ELBO max relative |diff| {d_e:.2e} (bound 1e-6); launches "
               f"{_launched(launches)}")
    if not (rows['cuda']['index'] == rows['cpu']['index'] and d_e <= 1e-6):
        fail(f"{tag}: GridSearch(VIPRS) on the card disagrees with the CPU")
    if min(launches[k + sfx] for k in ('cavi_block_sweep_s1',
                                       'coupling_pass_s1')) < 1:
        fail(f"{tag}: GridSearch(VIPRS) did not launch K1/K2")
    rows['guard'] = guarded_stops(tag, "GridSearch(VIPRS)'s selected row",
                                  lambda *a: per_row(*a)['stops'],
                                  rows['cuda']['stops'],
                                  rows['cpu']['stops'])
    rec['grid_search_rows'] = rows

    def pathwise(w, f_abs_tol, x_abs_tol):
        g = grid16(w)
        g.fit(pathwise=True, max_iter=300, f_abs_tol=f_abs_tol,
              x_abs_tol=x_abs_tol)
        return list(zip(g._last_result.nit.tolist(),
                        g._last_result.status.tolist()))
    path = {w: pathwise(w, *TOLS) for w in where}
    phase(tag, f"pathwise 16-point grid: (nit, status) {path['cuda']} "
               f"(card) vs {path['cpu']} (CPU)")
    path['guard'] = guarded_stops(tag, 'the pathwise grid', pathwise,
                                  path['cuda'], path['cpu'])
    rec['pathwise'] = path

    def mix(w, f_abs_tol, x_abs_tol):
        np.random.seed(0)
        m = VIPRSMix(dss[w], w, K=MIX_K).fit(
            fused=False, max_iter=300, f_abs_tol=f_abs_tol,
            x_abs_tol=x_abs_tol)
        return [(m.optim_result.nit, m.optim_result.message)]
    mx = {w: mix(w, *TOLS) for w in where}
    phase(tag, f"host-stepped VIPRSMix(K={MIX_K}): (nit, message) "
               f"{mx['cuda']} (card) vs {mx['cpu']} (CPU)")
    mx['guard'] = guarded_stops(tag, 'the host-stepped VIPRSMix', mix,
                                mx['cuda'], mx['cpu'])
    rec['host_stepped_mix'] = mx

    beta, lam = {}, {}
    for w in where:
        m = LDPredInf(dss[w], w).fit()
        beta[w] = np.concatenate([m.post_mean_beta[ch]
                                  for ch in m.chromosomes])
        lam[w] = VIPRS(dss[w], w).infer_lambda_min()
    d_beta = float(np.abs(beta['cuda'] - beta['cpu']).max()
                   / np.abs(beta['cpu']).max())
    d_lam = abs(lam['cuda'] - lam['cpu'])
    phase(tag, f"LDPredInf: posterior means max |diff| {d_beta:.2e} of the "
               f"largest (bound 1e-6); infer_lambda_min {lam['cuda']!r} "
               f"(card) vs {lam['cpu']!r} (CPU), |diff| {d_lam:.2e} (bound "
               f"1e-9)")
    if not (d_beta <= 1e-6 and d_lam <= 1e-9):
        fail(f"{tag}: LDPredInf or infer_lambda_min on the card disagrees "
             f"with the CPU")
    rec.update(ldpred_inf_rel_diff=d_beta, lambda_min=[lam['cuda'],
                                                       lam['cpu']])
    return rec


def select_genome(ds, record_paths):
    """P2 (and P1 on int8 LD): viprs_fit's selection flow at full width
    (viprs_tpu/cli/fit.py:337-400): np.random.seed(0), the bench grid(100),
    VIPRSGrid(ds, grid, 'cuda'), the PUMAS split (0.8, seed 0), fit(max_iter
    =500), pseudo_validate, select_best_model by pseudo-R^2,
    restore_full_sumstats and fit(max_iter=1000) of the selected row. The
    split's identity n b = n_t b_train + (n - n_t) b_test holds on every
    variant within 1e-9 of its terms' size (P1); the grid fit launches K3,
    the refit K1 and K2 (the hybrid), each only in the LD's tile type; the
    selected row and the refit's h2 are held to the port's earlier runs
    (PORT_PV_*, PORT_F32_PV_*)."""
    import torch
    from viprs_tpu_torch.gridsearch import (HyperparameterGrid,
                                            select_best_model)
    from viprs_tpu_torch.model import VIPRSGrid
    from viprs_tpu_torch.ops import cavi_cuda
    f32 = ds.ld.diag.dtype == torch.float32
    sfx = '_f32' if f32 else ''
    tag = 'P2 float32' if f32 else 'P2 int8'
    held_idx, held_h2 = (PORT_F32_PV_INDEX, PORT_F32_PV_H2) if f32 else \
        (PORT_PV_INDEX, PORT_PV_H2)
    other = [k for k in cavi_cuda.LAUNCHES if k.endswith('_f32') != f32]
    rec = {}
    np.random.seed(0)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_SPEC), 'cuda')
    t0 = time.perf_counter()
    g.split_gwas_sumstats(prop_train=0.8, seed=0)
    torch.cuda.synchronize()
    rec['split_s'] = time.perf_counter() - t0
    worst, finite = 0.0, True
    for c in g.chromosomes:
        n = np.asarray(ds.n_per_snp[c], np.float64)
        tr, te = g.std_beta[c], g.validation_std_beta[c]
        n_t = 0.8 * n
        terms = np.abs(n_t * tr) + np.abs((n - n_t) * te)
        err = np.abs(n * ds.std_beta[c] - (n_t * tr + (n - n_t) * te))
        worst = max(worst, float(np.max(err / np.maximum(terms, 1e-300))))
        finite &= bool(np.isfinite(tr).all() and np.isfinite(te).all())
    rec.update(identity_rel_err=worst, finite=finite)
    phase('P1' if not f32 else tag,
          f"PUMAS split of the {'float32' if f32 else 'int8'} genome "
          f"(prop_train 0.8, seed 0, factorized on the card): "
          f"{rec['split_s']:.3f} s; "
          f"n b = n_t b_train + (n - n_t) b_test on all {ds.m} variants "
          f"within {worst:.2e} of the terms (bound 1e-9); train and test "
          f"betas {'finite' if finite else 'NOT FINITE'}")
    if not (worst <= 1e-9 and finite):
        fail(f"{tag}: the PUMAS split breaks its identity or is not finite")
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    g.fit(max_iter=500)
    torch.cuda.synchronize()
    rec['fit_s'] = time.perf_counter() - t0
    rec['fit_launches'] = dict(cavi_cuda.LAUNCHES)
    nit = g._last_result.nit
    rec.update(valid=int(g.valid_terminated_models.sum()),
               converged=int(g.converged_models.sum()),
               nit_max=int(nit.max()), nit_median=float(np.median(nit)),
               widths=[w for w, *_ in g._chunk_trace])
    t0 = time.perf_counter()
    pv = g.pseudo_validate()
    rec['pseudo_validate_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    select_best_model(g, criterion='pseudo_validation')
    torch.cuda.synchronize()
    rec['select_s'] = time.perf_counter() - t0
    idx = _pv_index(g.validation_result['Pseudo_Validation_R2'])
    rec.update(index=idx, row={k: float(v) for k, v in g.fix_params.items()},
               pseudo_r2=float(pv[idx]),
               pseudo_r2_range=[float(np.nanmin(pv)), float(np.nanmax(pv))])
    t0 = time.perf_counter()
    g.restore_full_sumstats()
    rec['restore_s'] = time.perf_counter() - t0
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    g.fit(max_iter=1000)
    torch.cuda.synchronize()
    rec['refit_s'] = time.perf_counter() - t0
    rec['refit_launches'] = dict(cavi_cuda.LAUNCHES)
    rec.update(refit_nit=g.optim_result.nit, h2=g.get_heritability(),
               refit_message=g.optim_results[0].message,
               refit_success=bool(g.optim_result.success),
               refit_skip_iterations=g._n_skip)
    phase(tag, f"grid(100) on the split: fit {rec['fit_s']:.3f} s, valid "
               f"{rec['valid']}/100, converged {rec['converged']}/100, nit "
               f"max {rec['nit_max']} median {rec['nit_median']:g}, widths "
               f"per chunk {_runs(rec['widths'])}; launches "
               f"{_launched(rec['fit_launches'])}")
    phase(tag, f"pseudo_validate {rec['pseudo_validate_s']:.3f} s "
               f"(pseudo-R^2 {rec['pseudo_r2_range'][0]:.6f}.."
               f"{rec['pseudo_r2_range'][1]:.6f}); select_best_model "
               f"{rec['select_s']:.3f} s: row {idx} {rec['row']}, pseudo-R^2 "
               f"{rec['pseudo_r2']:.6f}; restore {rec['restore_s']:.3f} s; "
               f"refit {rec['refit_s']:.3f} s: nit {rec['refit_nit']} "
               f"({rec['refit_skip_iterations']} on the skip branch), h2 "
               f"{rec['h2']!r}, '{rec['refit_message']}'; launches "
               f"{_launched(rec['refit_launches'])}")
    if rec['valid'] < 2 or not rec['refit_success'] or \
            not 0.0 < rec['h2'] < 1.0:
        fail(f"{tag}: the selection flow did not end in a converged refit")
    if rec['fit_launches']['cavi_block_sweep_s' + sfx] < 1 or \
            min(rec['refit_launches'][k + sfx] for k in (
                'cavi_block_sweep_s1', 'coupling_pass_s1')) < 1 or \
            rec['refit_skip_iterations'] < 1:
        fail(f"{tag}: the flow did not launch K3 in the grid fit and K1/K2 "
             f"in the refit")
    if any(rec['fit_launches'][k] or rec['refit_launches'][k]
           for k in other):
        fail(f"{tag}: another tile type's kernel was launched")
    if idx != held_idx or abs(rec['h2'] - held_h2) > 1e-9:
        fail(f"{tag}: the selected row {idx} or the refit's h2 "
             f"{rec['h2']!r} moved from the port's earlier runs "
             f"({held_idx}, {held_h2!r})")
    record_paths['P2 grid fit' + (' f32' if f32 else '')] = \
        rec['fit_launches']
    record_paths['P2 refit' + (' f32' if f32 else '')] = \
        rec['refit_launches']
    return rec


def pathwise_genome(ds, record_paths):
    """P3: VIPRSGrid(ds, grid(100), 'cuda').fit(pathwise=True, max_iter=
    500) on the int8 genome: S = 1 fits one after another, each from the
    previous one's finished state, every iteration one K1 launch (the
    all-active sweep and its coupling pass) and no initial one, so K1's
    count is the summed nit."""
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSGrid
    from viprs_tpu_torch.ops import cavi_cuda
    np.random.seed(0)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_SPEC), 'cuda')
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    g.fit(pathwise=True, max_iter=500)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cavi_cuda.LAUNCHES)
    nit, status = g._last_result.nit, g._last_result.status
    elbo = np.asarray(g.validation_result['ELBO'])
    best = int(np.argmax(np.where(g.valid_terminated_models, elbo, -np.inf)))
    rec = dict(seconds=dt, nit=nit.tolist(), status=status.tolist(),
               nit_sum=int(nit.sum()),
               converged=int(g.converged_models.sum()),
               valid=int(g.valid_terminated_models.sum()), best=best,
               best_row=g.grid_row(best), launches=launches,
               ms_per_it=1e3 * dt / max(int(nit.sum()), 1))
    phase('P3', f"pathwise grid(100): {dt:.3f} s ({rec['ms_per_it']:.2f} "
                f"ms/it over {rec['nit_sum']} iterations), nit min/median/max "
                f"{int(nit.min())}/{float(np.median(nit)):g}/{int(nit.max())},"
                f" converged {rec['converged']}/100, valid {rec['valid']}/100;"
                f" best by ELBO row {best} {rec['best_row']}; K1 launches "
                f"{launches['cavi_block_sweep_s1']} = the summed nit "
                f"{rec['nit_sum']} (no initial call); launches "
                f"{_launched(launches)}")
    if rec['valid'] < 100 or launches['cavi_block_sweep_s1'] != \
            rec['nit_sum'] or launches['coupling_pass_s1'] != rec['nit_sum']:
        fail("P3: the pathwise grid did not terminate validly on every lane "
             "or its K1 launches are not its iterations")
    record_paths['P3 pathwise'] = launches
    return rec


def mix_select_genome(ds, record_paths):
    """P4: VIPRSMix(ds, 'cuda', K=3).fit(fused=False, max_iter=500), the
    host-stepped loop (K5 every iteration), beside the fused fit in the
    same run; then GridSearch over VIPRSMix with the pseudo-validation
    criterion (one VIPRSMixGrid, K7) over bench.py's 20-point mixture grid,
    its model split first (0.8, seed 0)."""
    import torch
    from viprs_tpu_torch.gridsearch import GridSearch, HyperparameterGrid
    from viprs_tpu_torch.model import VIPRSMix, VIPRSMixGrid
    from viprs_tpu_torch.ops import cavi_cuda
    rec = {}
    for name, kw in (('host-stepped', dict(fused=False)), ('fused', {})):
        np.random.seed(0)
        m = VIPRSMix(ds, 'cuda', K=MIX_K)
        torch.cuda.synchronize()
        cavi_cuda.reset_launches()
        t0 = time.perf_counter()
        m.fit(max_iter=500, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = m.optim_result
        rec[name] = dict(seconds=dt, nit=r.nit, h2=m.get_heritability(),
                         success=bool(r.success), message=r.message,
                         launches=dict(cavi_cuda.LAUNCHES))
        record_paths[f'P4 {name} VIPRSMix'] = rec[name]['launches']
        phase('P4', f"VIPRSMix(K={MIX_K}) {name}: {dt:.3f} s, nit {r.nit}, "
                    f"h2 {rec[name]['h2']!r} (JAX package: {REF_MIX_H2}), "
                    f"'{r.message}'; launches "
                    f"{_launched(rec[name]['launches'])}")
    hs = rec['host-stepped']
    if not (hs['success'] and abs(hs['h2'] - REF_MIX_H2) <= 0.005
            and hs['launches']['cavi_sweep_mix_s1'] >= hs['nit']):
        fail("P4: the host-stepped VIPRSMix fit did not converge within "
             "0.005 of the JAX package's h2 on K5")

    np.random.seed(0)
    gs = GridSearch(ds, HyperparameterGrid(n_snps=ds.m, **MIX_GRID_SPEC),
                    'cuda', criterion='pseudo_validation',
                    model_class=VIPRSMix, K=MIX_K)
    if not isinstance(gs.model, VIPRSMixGrid):
        fail("P4: GridSearch over VIPRSMix did not build a VIPRSMixGrid")
    t0 = time.perf_counter()
    gs.model.split_gwas_sumstats(prop_train=0.8, seed=0)
    t_split = time.perf_counter() - t0
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    best = gs.fit(max_iter=500)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scores = gs.validation_result['Pseudo_Validation_R2']
    idx = _pv_index(scores)
    rec['grid_search'] = dict(
        split_s=t_split, seconds=dt, index=idx, row={k: float(v) for k, v in
                                    best.fix_params.items()},
        pseudo_r2=float(scores[idx]), h2=best.get_heritability(),
        valid=int(np.isfinite(scores).sum()),
        launches=dict(cavi_cuda.LAUNCHES))
    gsr = rec['grid_search']
    record_paths['P4 GridSearch(VIPRSMix)'] = gsr['launches']
    phase('P4', f"GridSearch(VIPRSMix, K={MIX_K}, pseudo_validation) over "
                f"20 rows: split {t_split:.3f} s, fit and selection "
                f"{dt:.3f} s, row {idx} {gsr['row']}, "
                f"pseudo-R^2 {gsr['pseudo_r2']:.6f}, h2 {gsr['h2']!r}; "
                f"launches {_launched(gsr['launches'])}")
    if gsr['launches']['cavi_sweep_mix_s'] < 1 or best.n_models != 1 or \
            not np.isfinite(gsr['pseudo_r2']):
        fail("P4: the mixture grid search did not launch K7 or select a row")
    return rec


def ldpred_lambda_genome(ds):
    """P5 on one packing: LDPredInf(ds, 'cuda', h2=None).fit() (CG
    iterations, final relative residual, seconds) and infer_lambda_min
    (value, seconds)."""
    import torch
    from viprs_tpu_torch.model import LDPredInf, VIPRS
    kind = str(ds.ld.diag.dtype).replace('torch.', '')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = LDPredInf(ds, 'cuda').fit()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    beta = np.concatenate([m.post_mean_beta[c] for c in m.chromosomes])
    t0 = time.perf_counter()
    lam = VIPRS(ds, 'cuda').infer_lambda_min()
    torch.cuda.synchronize()
    t_lam = time.perf_counter() - t0
    rec = dict(seconds=t_fit, cg_iterations=m.cg_iterations,
               relative_residual=m.cg_relative_residual, h2=m.h2,
               lambda_min=lam, lambda_min_s=t_lam)
    phase('P5', f"{kind} LD: LDPredInf (h2 {m.h2:.6f} from LDSC) {t_fit:.3f} "
                f"s, {m.cg_iterations} CG iterations, relative residual "
                f"{m.cg_relative_residual:.3e}; infer_lambda_min {lam!r} in "
                f"{t_lam:.3f} s")
    if beta.shape != (ds.m,) or not np.isfinite(beta).all() or \
            not m.cg_relative_residual <= 1e-6 or not np.isfinite(lam):
        fail(f"P5: LDPredInf or infer_lambda_min on {kind} LD failed")
    return rec


if __name__ == '__main__':
    main()
