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
E0. the rest of the model surface on that cut, the kernels on the card
   against the plain versions on the CPU: e_step from one carried start at
   S = 1 (K1 with coupling_pass_s1) and on a 16-point grid (K3 with
   coupling_pass_s) within phase 4's and G1's bounds, m_step; the ELBO's
   terms (entropy, log_prior, loglikelihood, complete_loglikelihood, mse)
   and the ELBO on one state within 1e-6; a fit tracking every quantity and
   a fit continued after 5 iterations, their stops held by guarded_stops;
   checkpoints written on the card and loaded on the CPU and the reverse,
   bit for bit; VIPRSMix(K=3)'s diagnostics within 1e-6;
5. fit the genome with VIPRS(ds, device='cuda').fit() as bench.py does
   (np.random.seed(0), max_iter=1000, tolerances 1e-6, patience 10), with the
   kernel launch counters reset just before and read just after; then the
   all-active configuration (sweep_impl='xla');
E1. on the genome: VIPRS tracking every quantity with phase 5's seed and
   arguments (one chunk an iteration), its nit, message, h2 and ELBO
   history equal to phase 5's untracked fit, its seconds beside phase 5's;
   initialize() then 5 x (e_step(); m_step()) timed by CUDA events;
   save_checkpoint / load_checkpoint of the converged state (seconds,
   bytes, bit for bit); fit(continued=True, sweep_impl='skip') from it
   (K2), h2 within 1e-4 of the start; a fit with a progress_callback whose
   last call is its nit; and (in D's temporary directory, before D0)
   viprs_warmup_torch on the genome's Zarr stores in a fresh process: its
   seconds, the stores' packed shapes, the library found and not rebuilt;
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
D0. viprs_fit from files on disk (python -m viprs_tpu_torch.cli.fit,
   through ``cli.fit.run``): phase 3 writes the genome as 22 magenpy Zarr
   stores (int8, upper-triangular rows) and its summary statistics (10% of
   the variants' alleles swapped with Z negated, 10% strand-complemented),
   and chromosomes 21-22 (~45k variants) as a native and a Zarr store with
   statistics of which 2% are absent and 5 the LD lacks, into a temporary
   directory deleted at the end. D0 runs the CLI on the cut on the card
   and on the CPU in eight modes (VIPRS, VIPRSMix, GS by pseudo-validation
   after the PUMAS split, BMA, --validation-sumstats, --extract, streamed
   under a small --device-memory-gb, the Zarr store with int8 tiles): the
   same rows, the CPU's stops (guarded_stops), ELBO and h2 within 1e-6,
   pseudo-R^2 within 1e-5, BETA within 1e-4 of the largest, PIP within
   1e-2;
D1. viprs_fit --dequantize-on-the-fly on the genome's Zarr stores: the
   loader's int8 tiles equal phase 3's bit for bit, its std_beta the
   genome's within 1e-12 after the flips are undone, the .fit.gz rows in
   the stores' order, h2 within 1e-4 of PORT_H2; the seconds of each stage
   (tables, sumstats, harmonize, LD read, pack, upload, fit, write);
D2. the same with the default packing (float32 tiles = int8 / 127): h2
   within 0.005 of the JAX package's, nit and h2 held to PORT_DISK_F32_*;
D3. the pack cache in the temporary directory: D1 misses it and writes
   it, a second run hits it, reads no LD data and writes D1's files byte
   for byte; the data-preparation seconds of each;
V0. individual-level data on a cut, card against CPU: plink filesets of
   AR(1) genotypes (the port's simulate_dosages; 2,003 training samples,
   not a multiple of 4, and 1,001 validation samples; chromosomes 21-22,
   2,000 variants each; 1% missing), run once with --device cuda and once
   with --device cpu: GWAS, compute_ld with each of the four estimators,
   save_ld_store, viprs_fit (VIPRS, and --hyp-search GS --grid-metric
   validation on the validation fileset), viprs_score and
   viprs_evaluate. Held: dosages bit for bit, GWAS BETA/SE/Z within rtol
   1e-9, LD within 1e-12, the fits' stops behind guarded_stops (then the
   .hyp, the selected row and Validation_R2 within rtol 1e-6), the card's
   fits scored on the card and the CPU within rtol 1e-9, the .eval within
   1e-9;
V1. genome-wide scoring at a cohort's size: the genome's 1,099,965
   variants (D's tables, 10% of the alleles swapped) x 10,000 samples as
   22 BED filesets (2.75 GB; rows drawn from a pool of HWE rows rotated by
   a byte offset), viprs_score of D1's .fit.gz on the card, its stage
   seconds (.bim/.fam read, .fit read, harmonize, BED read, upload,
   decode+standardize, product, write); the card and the CPU score the same
   --keep of 1,000 samples within rtol 1e-9;
V2. GWAS (perform_gwas) on V1's filesets with a seeded phenotype, timed,
   chromosome 22's BETA held card against CPU within rtol 1e-9; block LD
   (compute_ld('block')) of a 5,000-sample AR(1) panel of chromosomes
   21-22, timed, its three smallest blocks held card against CPU within
   1e-12.
MC0. the posterior-check samplers (model/sampler.py, plain torch: no
   kernel) on phase 4's 8-block cut, the card against the CPU with the
   same draws made once on the host: one Gibbs sweep from a nonzero state
   (gamma equal, beta and q within MC0_REL of their largest, on the chains
   and tiles clear of a near tie by a float64 replay) and an HMC run of 6
   samples (energies and acceptance probabilities step by step within
   MC0_ENERGY_REL and MC0_ALPHA, to the first near tie);
MC1. benchmarks/benchmark_sampler.py's workload on the first tiles of the
   int8 genome holding >= 150,000 variants: a VIPRS fit, Gibbs (4 chains,
   MC1_GIBBS), SMC over 8 pi particles (tau = pi m / 0.25, sigma_eps 0.75,
   MC1_SMC), HMC on VI's PIP > 0.5 variants (MC1_HMC, seeds 3 and 4: cold
   and steady); seconds, ms per sweep and its device launches (one sweep
   under torch.profiler), ms per HMC step, accept rates, step size and the
   PIP and posterior-mean correlations with VI; held: finite outputs, SMC
   weights summing to 1, HMC accept rates in (0.2, 1], the selected
   variants' correlation > 0.5. No module of pandas, jax or viprs_tpu is
   imported after D0-MC1.
X0. the fits over processes (parallel/): two ranks spawned on the one
   card, joined over gloo on localhost, reading the genome from files this
   phase writes (each copies only its shard of the LD to the card); 3
   sweeps at fixed hyperparameters on 8 blocks of the genome with a
   coupling tile across the two ranks' boundary, K1 + the halo +
   coupling_pass_s1 at S = 1 and K3 + the halo + coupling_pass_s at
   S = 16: each rank's blocks bit for bit the whole cut's sweep;
X1. on the int8 genome, VIPRS over '2x1' (the blocks split) held to phase
   5's fit (nit and status through guarded_stops, h2 and the final ELBO
   within X1_REL, PIP within X1_PIP) and grid(100) + BMA over '1x2' (the
   lanes split) held to PORT_GRID_BMA_H2 within X1_GRID_REL, every point
   converged; each rank's LD bytes on the card, its launches and the
   seconds beside phase 5's and G3's. The ranks import no module of jax
   or viprs_tpu. Two ranks on one card measure the protocol's cost, not a
   speed-up.

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
on each surface path of E0-E1, each selection path of P0 and P2-P4,
each disk path of D0-D2, each genotype path of V0 and each rank's
sharded fits of X1 that launched it.

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
    # D: the genome and a cut of it as files on disk, for viprs_fit
    disk = disk_prepare(ld_blocks, std_beta, n_per_snp)
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
    # E0: the rest of the model surface on the cut; ``paths`` collects the
    # launches of every path after the main one (E0-E1, P0-P4, D0-D2, V0)
    paths = {}
    record['surface_cut'] = surface_cut_checks(sub, sb, nf, paths)

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
                          n_skip=model.fit_counters.skip_iterations)
        phase('fit', f"{name}: {dt:.3f} s, nit {model.optim_result.nit}, "
                     f"h2 {model.get_heritability():.6f}, skip-branch "
                     f"iterations {model.fit_counters.skip_iterations}, "
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
    # X1 holds the fit over 2 ranks to this one
    x_ref = dict(nit=int(fitted.optim_result.nit),
                 status=int(fitted._last_result.status[0]),
                 h2=float(fitted.get_heritability()),
                 elbo=float(fitted.history['ELBO'][-1]), pip=pip,
                 cold_s=cold['seconds'], warm_s=record['warm_median_s'],
                 ld_gb=(ld.diag.numel() + ld.off_data.numel()) / 1e9)
    # E1: the rest of the model surface on the genome
    record['surface'] = surface_genome(ds, fit_kw, warm,
                                       list(fitted.history['ELBO']), paths)

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

    # ---- D0-D3: viprs_fit from files on disk; V0-V2: genotypes ----
    import shutil
    try:
        record['warmup'] = warmup_genome(disk, ds)
        record['disk'] = disk_phases(disk, ds, paths)
        record['geno'] = geno_phases(disk, card, paths)
    finally:
        shutil.rmtree(disk['root'], ignore_errors=True)

    # ---- MC0-MC1: the posterior-check samplers ----
    record['samplers_cut'] = sampler_cut_checks(sub, sb, nf)
    record['samplers'] = sampler_genome(ds)

    # ---- X0-X1: the fits over two processes (parallel/) ----
    record['sharded'] = x_phases(ds, x_ref, record['grid']['cold'], paths)
    loaded = [m for m in ('pandas', 'jax', 'viprs_tpu') if m in sys.modules]
    if loaded:
        fail(f"the viprs_fit, viprs_score, viprs_evaluate and sampler paths "
             f"imported {loaded}")

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
        e['paths'] = {p: paths[p][e['name']]
                      for p in (*SURFACE_PATHS, *SELECT_PATHS, *DISK_PATHS,
                                *GENO_PATHS, *X_PATHS)
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
    widths = ([c.width for c in gc.fit_counters.chunks],
              [c.width for c in gp.fit_counters.chunks])
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
                   widths=[c.width for c in g.fit_counters.chunks],
                   act_trace=g.fit_counters.active_blocks)
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
        nit = np.array([r.nit for r in g.optim_results])
        out = dict(fit_s=dt, converged=int(g.converged_models.sum()),
                   valid=int(g.valid_terminated_models.sum()),
                   nit_max=int(nit.max()),
                   nit_median=float(np.median(nit)),
                   ms_per_it=1e3 * dt / max(int(nit.max()), 1),
                   widths=[c.width for c in g.fit_counters.chunks],
                   h2_range=[float(h2.min()), float(h2.max())],
                   nit=[int(x) for x in nit], h2=[float(x) for x in h2],
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
                              n_skip=m.fit_counters.skip_iterations,
                              launches=launches)
            phase('F2', f"{model} on float32 LD, {name}: {dt:.3f} s, nit "
                        f"{r.nit} ({runs[name]['ms_per_it']:.2f} ms/it), h2 "
                        f"{m.get_heritability()!r}, '{r.message}'"
                        + (f", skip-branch iterations "
                           f"{m.fit_counters.skip_iterations}"
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


def guarded_stops(tag, what, run, card, cpu, devices=('cpu',)):
    """Hold the card's per-lane stops (tuples such as (nit, status)) to the
    CPU's on every lane whose stop is clear (STOP_MARGIN). Where the two
    disagree, each of ``devices`` repeats ``run(device, f_abs_tol,
    x_abs_tol)`` with each tolerance moved, and a lane whose stop moves
    with them there is waived (P0 asks the CPU only; D0 the card too, whose
    kernels can leave max |d eta| just above x_abs_tol for iterations where
    the plain versions fall clear below it); a lane where the two agree
    needs no such proof. Fails on a clear lane that disagrees; returns the
    counts."""
    f, x, m = *TOLS, STOP_MARGIN
    off = [l for l, (a, b) in enumerate(zip(card, cpu)) if a != b]
    waived = set()
    for dev in devices if off else ():
        own = cpu if dev == 'cpu' else card
        for tol in ((f * m, x), (f / m, x), (f, x * m), (f, x / m)):
            alt = run(dev, *tol)
            waived |= {l for l in off if alt[l] != own[l]}
    clear_off = [l for l in off if l not in waived]
    where = ' or the card' if 'cuda' in devices else ''
    phase(tag, f"{what}: {len(cpu) - len(off)} of {len(cpu)} stops as on "
               f"the CPU, {len(waived)} waived (within a factor {m:g} of a "
               f"threshold on the CPU{where}: {sorted(waived)}), "
               f"{len(clear_off)} clear and different {clear_off}")
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
               widths=[c.width for c in g.fit_counters.chunks])
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
               refit_skip_iterations=g.fit_counters.skip_iterations)
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


# ------------------------------ the rest of the model surface (E0-E1)
#: The kernels each surface path launched (as in SELECT_PATHS).
SURFACE_PATHS = ('E0 e_step S=1', 'E0 e_step S=16', 'E0 tracked fit',
                 'E0 continued fit', 'E1 tracked fit', 'E1 e_step',
                 'E1 continued fit', 'E1 progress fit')
#: Every quantity a fit can track.
TRACKED = ['pi', 'pis', 'heritability', 'sigma_epsilon', 'tau_beta',
           'sigma_g', 'entropy', 'loglikelihood', 'log_prior', 'mse',
           'max_eta_diff']
#: The ELBO's terms and the ELBO, each a device reduction and a host read.
DIAGNOSTICS = ('entropy', 'log_prior', 'loglikelihood',
               'complete_loglikelihood', 'mse', 'elbo')


def _launched_in(fn):
    """(``fn()``, the kernels it launched): the launch counts set to 0 just
    before and read just after."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _launched(cavi_cuda.LAUNCHES)


def _carry(src, dst):
    """``src``'s state, hyperparameters, sigma_g and fix mask into ``dst``
    (on ``dst``'s device), on the same bytes."""
    from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
    dst._S = src._S
    dst._state = CaviState(*(x.to(dst.device).clone() for x in src._state))
    dst._hyper = Hyper(*(np.array(x, np.float64) for x in src._hyper))
    dst._sigma_g = np.array(src._sigma_g, np.float64)
    dst._fix_mask = src._fix_mask
    dst._clear_posterior()


def _same_npz(a, b):
    """Two checkpoint files hold the same keys, shapes, dtypes and bytes."""
    with np.load(a) as za, np.load(b) as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
            and za[k].tobytes() == zb[k].tobytes() for k in za.files)


def _diagnostics_close(tag, got, want, bound=1e-6):
    """The ELBO's terms of two models within ``bound`` relative."""
    rec = {}
    for name in DIAGNOSTICS:
        g = np.asarray(getattr(got, name)(), np.float64)
        w = np.asarray(getattr(want, name)(), np.float64)
        rec[name] = float(np.max(np.abs(g - w) / np.abs(w)))
    worst = max(rec, key=rec.get)
    phase(tag, "diagnostics, card against CPU on one state: " + ', '.join(
        f"{k} {v:.1e}" for k, v in rec.items()) + f" (bound {bound:.0e})")
    if not rec[worst] <= bound:
        fail(f"{tag}: {worst} differs from the CPU's by {rec[worst]:.2e} "
             f"relative")
    return rec


def surface_cut_checks(sub, sb, nf, record_paths):
    """E0 on phase 4's 8-block cut, the kernels on the card against the
    plain versions on the CPU: e_step from one carried start at S = 1 (K1
    with coupling_pass_s1) and on a 16-point grid (K3 with coupling_pass_s)
    within phase 4's and G1's bounds, then m_step (hyperparameters within
    1e-5); the five diagnostics and the ELBO on one state within 1e-6
    relative; a fit tracking every quantity and a fit continued after 5
    iterations (continued=True), their stops held by guarded_stops and h2
    within 1e-4; checkpoints written on the card and loaded on the CPU, and
    the reverse, bit for bit; VIPRSMix(K=3)'s diagnostics on one carried
    state within 1e-6."""
    import tempfile
    import torch
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    from viprs_tpu_torch.model import VIPRS, VIPRSGrid, VIPRSMix
    from viprs_tpu_torch.ops.cavi_torch import CaviState
    t_e0 = time.perf_counter()
    dev = torch.device('cuda', 0)
    where = ('cuda', 'cpu')
    dss = {w: _dataset_from_cut(sub, sb, nf, torch.device(w)) for w in where}
    rec = {}
    sfx = '_f32' if sub.diag.dtype == torch.float32 else ''

    for S, tol, path, kernels in (
            (1, TOL, 'E0 e_step S=1', ('cavi_block_sweep_s1',
                                        'coupling_pass_s1')),
            (16, TOL_S, 'E0 e_step S=16', ('cavi_block_sweep_s',
                                            'coupling_pass_s'))):
        if S == 1:
            ms = {w: VIPRS(dss[w], w) for w in where}
        else:
            ms = {w: VIPRSGrid(dss[w], HyperparameterGrid(
                pi_steps=S, n_snps=dss[w].m), w) for w in where}
        np.random.seed(0)
        ms['cpu'].initialize()
        _carry(ms['cpu'], ms['cuda'])
        _, launched = _launched_in(ms['cuda'].e_step)
        record_paths[path] = launched
        ms['cpu'].e_step()
        errs = []
        check_state(f'E0 e_step S={S}',
                    (ms['cuda']._state, ms['cuda']._last_eta_diff),
                    (CaviState(*(x.to(dev) for x in ms['cpu']._state)),
                     ms['cpu']._last_eta_diff.to(dev)), errs, tol)
        if launched != {k + sfx: 1 for k in kernels}:
            fail(f"E0: e_step at S = {S} launched {launched}")
        for m in ms.values():
            m.m_step()
        d_h = max(float(np.max(np.abs(np.asarray(getattr(ms['cuda']._hyper,
                                                         f))
                                      / np.asarray(getattr(ms['cpu']._hyper,
                                                           f)) - 1.0)))
                  for f in ('sigma_eps', 'tau_beta', 'pi'))
        phase('E0', f"e_step at S = {S}: launches {launched}, max abs err "
                    f"{max(errs):.3e}; m_step hyperparameters max relative "
                    f"|diff| {d_h:.2e} (bound 1e-5)")
        if not d_h <= 1e-5:
            fail(f"E0: m_step at S = {S} disagrees with the CPU's")
        rec[f'e_step_S{S}'] = dict(max_abs_err=max(errs), launches=launched,
                                   hyper_rel=d_h)
        if S == 1:
            # the ELBO's terms on the card's state, card against CPU
            _carry(ms['cuda'], ms['cpu'])
            rec['diagnostics'] = _diagnostics_close('E0', ms['cuda'],
                                                    ms['cpu'])

    def tracked(w, f_abs_tol, x_abs_tol):
        np.random.seed(0)
        return VIPRS(dss[w], w, tracked_params=TRACKED).fit(
            max_iter=300, f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol)

    def stop(m):
        return [(m.optim_result.nit, m.optim_result.message)]
    tc, launched = _launched_in(lambda: tracked('cuda', *TOLS))
    record_paths['E0 tracked fit'] = launched
    tp = tracked('cpu', *TOLS)
    nit = tc.optim_result.nit
    lens_ok = all(len(tc.history[k]) == (nit if k == 'max_eta_diff'
                                         else nit + 1) for k in TRACKED)
    dh2 = abs(tc.get_heritability() - tp.get_heritability())
    phase('E0', f"tracked fit on the cut: (nit, message) {stop(tc)} (card) "
                f"vs {stop(tp)} (CPU), h2 |diff| {dh2:.2e} (bound 1e-4), "
                f"{len(tc.history)} histories of {nit + 1} entries, launches "
                f"{launched}")
    if not (lens_ok and set(tc.history) == set(tp.history) and dh2 <= 1e-4):
        fail("E0: the tracked fit on the card disagrees with the CPU's")
    rec['tracked'] = dict(card=stop(tc), cpu=stop(tp), h2_diff=dh2,
                          guard=guarded_stops('E0', 'the tracked fit',
                                              lambda *a: stop(tracked(*a)),
                                              stop(tc), stop(tp)))

    def continued(w, f_abs_tol, x_abs_tol, first=None):
        """The fit of 5 iterations, then continued; returns the model and
        its ELBO history's length after the 5 (and with ``first``, what
        ``first`` returns of the continued fit)."""
        np.random.seed(0)
        m = VIPRS(dss[w], w).fit(max_iter=5)
        n0 = len(m.history['ELBO'])
        run = lambda: m.fit(continued=True, max_iter=300,  # noqa: E731
                            f_abs_tol=f_abs_tol, x_abs_tol=x_abs_tol)
        return (run() if first is None else first(run)), n0
    (cc, launched), n0 = continued('cuda', *TOLS, first=_launched_in)
    record_paths['E0 continued fit'] = launched
    cp, _ = continued('cpu', *TOLS)
    dh2 = abs(cc.get_heritability() - cp.get_heritability())
    phase('E0', f"fit continued after 5 iterations: (nit, message) "
                f"{stop(cc)} (card) vs {stop(cp)} (CPU), h2 |diff| "
                f"{dh2:.2e} (bound 1e-4), {len(cc.history['ELBO'])} ELBO "
                f"entries ({n0} before), launches {launched}")
    if not (dh2 <= 1e-4
            and len(cc.history['ELBO']) == n0 + cc.optim_result.nit):
        fail("E0: the continued fit on the card disagrees with the CPU's")
    rec['continued'] = dict(card=stop(cc), cpu=stop(cp), h2_diff=dh2,
                            guard=guarded_stops(
                                'E0', 'the continued fit',
                                lambda *a: stop(continued(*a)[0]),
                                stop(cc), stop(cp)))

    with tempfile.TemporaryDirectory() as d:
        same = []
        for src, dst in ((tc, VIPRS(dss['cpu'], 'cpu')),
                         (tp, VIPRS(dss['cuda'], 'cuda'))):
            a, b = os.path.join(d, 'a.npz'), os.path.join(d, 'b.npz')
            src.save_checkpoint(a)
            dst.load_checkpoint(a).save_checkpoint(b)
            same.append(_same_npz(a, b) and all(
                torch.equal(x.cpu(), y.cpu())
                for x, y in zip(src._state, dst._state)))
    phase('E0', f"checkpoints: card -> CPU {'bit for bit' if same[0] else 'DIFFER'}"
                f", CPU -> card {'bit for bit' if same[1] else 'DIFFER'}")
    if not all(same):
        fail("E0: a checkpoint did not round-trip bit for bit")

    np.random.seed(0)
    mc = VIPRSMix(dss['cpu'], 'cpu', K=MIX_K).fit(max_iter=5,
                                                  sweep_impl='xla')
    mg = VIPRSMix(dss['cuda'], 'cuda', K=MIX_K)
    mg.set_state([x.numpy() for x in mc._state],
                 [np.asarray(x) for x in mc._hyper], mc._sigma_g)
    rec['mix_diagnostics'] = _diagnostics_close(f'E0 VIPRSMix(K={MIX_K})',
                                                mg, mc)
    rec['seconds'] = time.perf_counter() - t_e0
    phase('E0', f"{rec['seconds']:.1f} s")
    return rec


def surface_genome(ds, fit_kw, warm, ref_hist, record_paths):
    """E1 on the int8 genome: VIPRS tracking every quantity (one chunk an
    iteration) with phase 5's seed and arguments, its nit, message, h2 and
    ELBO history equal to phase 5's untracked fit (``warm``, ``ref_hist``)
    and its seconds; initialize() then 5 x (e_step(); m_step()), each timed
    by CUDA events; save_checkpoint / load_checkpoint of the converged
    state (seconds, bytes; the state bit for bit); fit(continued=True,
    sweep_impl='skip') from it (K2) in a model made with the fit's
    fix_params, h2 within 1e-4 of the start and the ELBO not lower; a fit
    with a progress_callback, whose last call is its nit (phase 5's)."""
    import tempfile
    import torch
    from viprs_tpu_torch.model import VIPRS
    t_e1 = time.perf_counter()
    rec = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    np.random.seed(0)
    (tm, dt), launched = _launched_in(lambda: timed(
        lambda: VIPRS(ds, 'cuda', tracked_params=TRACKED).fit(**fit_kw)))
    record_paths['E1 tracked fit'] = launched
    # the ELBO history holds NaN where the fit restarts (a negative MSE:
    # inside the one-chunk fit, between chunks here), on both sides
    same = (tm.optim_result.nit == warm['nit']
            and tm.optim_result.message == warm['message']
            and tm.get_heritability() == warm['h2']
            and np.array_equal(tm.history['ELBO'], ref_hist, equal_nan=True))
    restart = [i for i, e in enumerate(tm.history['ELBO']) if np.isnan(e)]
    rec['tracked'] = dict(seconds=dt, nit=tm.optim_result.nit,
                          h2=tm.get_heritability(), same_as_phase5=same,
                          launches=launched, nan_elbo_at=restart,
                          fix_params=dict(tm.fix_params))
    phase('E1', f"VIPRS tracking {len(TRACKED)} quantities: {dt:.3f} s "
                f"({1e3 * dt / max(tm.optim_result.nit, 1):.2f} ms/it; phase "
                f"5's untracked warm fit {warm['seconds']:.3f} s), nit "
                f"{tm.optim_result.nit}, h2 {tm.get_heritability()!r}, "
                f"'{tm.optim_result.message}'; nit, message, h2 and the ELBO "
                f"history {'equal' if same else 'DIFFER from'} phase 5's "
                f"(the ELBO NaN at iterations {restart}, fix_params "
                f"{tm.fix_params}); launches {launched}")
    if not same:
        hist = tm.history['ELBO']
        diff = [i for i, (a, b) in enumerate(zip(hist, ref_hist))
                if a != b and not (np.isnan(a) and np.isnan(b))]
        first = diff[0] if diff else None
        fail(f"E1: the tracked fit differs from phase 5's untracked fit: "
             f"{len(hist)} and {len(ref_hist)} ELBO entries, {len(diff)} "
             f"differ, the first at {first}: "
             f"{None if first is None else (hist[first], ref_hist[first])}")

    m = VIPRS(ds, 'cuda')
    np.random.seed(0)
    m.initialize()

    def steps():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(15)]
        for i in range(5):
            ev[3 * i].record()
            m.e_step()
            ev[3 * i + 1].record()
            m.m_step()
            ev[3 * i + 2].record()
        torch.cuda.synchronize()
        return ([ev[3 * i].elapsed_time(ev[3 * i + 1]) for i in range(5)],
                [ev[3 * i + 1].elapsed_time(ev[3 * i + 2]) for i in range(5)])
    (e_ms, m_ms), launched = _launched_in(steps)
    record_paths['E1 e_step'] = launched
    rec['steps'] = dict(e_step_ms=e_ms, m_step_ms=m_ms, launches=launched)
    phase('E1', f"initialize() then 5 x (e_step(); m_step()), CUDA events: "
                f"e_step {', '.join(f'{x:.3f}' for x in e_ms)} ms, m_step "
                f"{', '.join(f'{x:.3f}' for x in m_ms)} ms; launches "
                f"{launched}; h2 after them {m.get_heritability():.6f}")
    if launched != {'cavi_block_sweep_s1': 5, 'coupling_pass_s1': 5}:
        fail(f"E1: the manual steps launched {launched}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'fit.npz')
        _, t_save = timed(lambda: tm.save_checkpoint(path))
        nbytes = os.path.getsize(path)
        # a checkpoint holds no fix_params (as in the JAX package): the
        # model that loads it is made with the fit's (its restart fixed
        # sigma_epsilon at 0.95)
        loaded, t_load = timed(lambda: VIPRS(
            ds, 'cuda', fix_params=dict(tm.fix_params)).load_checkpoint(path))
    bits = all(torch.equal(x, y) for x, y in zip(tm._state, loaded._state))
    state_mb = sum(x.numel() * 4 for x in tm._state) / 1e6
    rec['checkpoint'] = dict(save_s=t_save, load_s=t_load, bytes=nbytes,
                             state_mb=state_mb, bit_for_bit=bits)
    phase('E1', f"checkpoint of the converged state ({state_mb:.1f} MB "
                f"float32): save_checkpoint {t_save:.3f} s, {nbytes} bytes "
                f"compressed; load_checkpoint {t_load:.3f} s, the state "
                f"{'bit for bit' if bits else 'DIFFERS'}")
    if not bits:
        fail("E1: the checkpoint did not load bit for bit")
    # the fit stopped on the LD-weighted criterion (|d sigma_g| small for
    # `patience` iterations, max |d eta| below 10 x_abs_tol); continued
    # with fresh counters it runs on to max |d eta| < x_abs_tol, which
    # moves h2 by some 1e-5: held to 1e-4 (phase 4's card-CPU bound), the
    # ELBO not lower than the start's beyond its float32 rounding (1e-3)
    h2_0, elbo_0 = loaded.get_heritability(), loaded.elbo()
    (cm, dt), launched = _launched_in(lambda: timed(lambda: loaded.fit(
        continued=True, sweep_impl='skip', **fit_kw)))
    record_paths['E1 continued fit'] = launched
    dh2 = abs(cm.get_heritability() - h2_0)
    d_elbo = cm.history['ELBO'][-1] - elbo_0
    act = cm.fit_counters.active_blocks
    rec['continued'] = dict(seconds=dt, nit=cm.optim_result.nit,
                            message=cm.optim_result.message, h2_diff=dh2,
                            elbo_gain=d_elbo, active_blocks=act,
                            launches=launched)
    phase('E1', f"fit(continued=True, sweep_impl='skip') from the checkpoint:"
                f" {dt:.3f} s, nit {cm.optim_result.nit}, "
                f"'{cm.optim_result.message}', h2 moved {dh2:.2e} (bound "
                f"1e-4), ELBO {d_elbo:+.3e} from the start's; K2's blocks "
                f"an iteration, of {ds.ld.nb}: min {min(act)}, median "
                f"{int(np.median(act))}, max {max(act)}; launches {launched}")
    if not (cm.optim_result.success and dh2 <= 1e-4 and d_elbo >= -1e-3
            and launched.get('cavi_block_sweep_s1')):
        fail("E1: the continued fit moved or did not converge")

    calls = []
    np.random.seed(0)
    (pm, dt), launched = _launched_in(lambda: timed(lambda: VIPRS(
        ds, 'cuda').fit(progress_callback=lambda mod, it, st: calls.append(
            it), **fit_kw)))
    record_paths['E1 progress fit'] = launched
    rec['progress'] = dict(seconds=dt, calls=calls, nit=pm.optim_result.nit)
    phase('E1', f"fit with a progress_callback (chunks of 25): {dt:.3f} s, "
                f"calls at {calls}, nit {pm.optim_result.nit}, h2 "
                f"{pm.get_heritability()!r}")
    if not (calls and calls[-1] == pm.optim_result.nit == warm['nit']
            and pm.get_heritability() == warm['h2']):
        fail("E1: the progress fit's last call is not its nit, or the fit "
             "differs from phase 5's")
    rec['seconds'] = time.perf_counter() - t_e1
    phase('E1', f"{rec['seconds']:.1f} s")
    return rec


def warmup_genome(disk, ds):
    """E1's warmup: ``python -m viprs_tpu_torch.cli.warmup`` on the
    genome's 22 Zarr stores as D writes them (int8 tiles, S = 1 and the
    grid width 100) in a fresh process: its seconds, the packed shapes it
    read from the stores' block boundaries (phase 3's M and NB), and the
    kernel library found, not rebuilt."""
    import re
    from viprs_tpu_torch.ops import _build
    lib = _build.build()[1]['path']
    argv = [sys.executable, '-m', 'viprs_tpu_torch.cli.warmup', '-l',
            os.path.join(disk['root'], 'genome', 'chr_*'), '--block-size',
            '1024', '--dequantize-on-the-fly', '--grid-widths', '100']
    t0 = time.perf_counter()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    log = out.stdout + out.stderr
    shapes = re.search(r'M=(\d+) NB=(\d+) B=(\d+) \(([\d.]+) s', log)
    built = re.search(r'kernel library (\S+) \(built in ([\d.]+) s', log)
    rec = dict(seconds=dt, returncode=out.returncode,
               shapes=shapes.groups() if shapes else None,
               library=built.groups() if built else None)
    phase('E1', f"viprs_warmup_torch on the genome's 22 Zarr stores: "
                f"{dt:.1f} s in a fresh process (exit {out.returncode}); "
                f"M, NB, B, metadata seconds {rec['shapes']}; library "
                f"{rec['library']}")
    if out.returncode != 0 or shapes is None or built is None:
        fail(f"E1: viprs_warmup_torch failed: {log[-2000:]}")
    if (int(shapes.group(1)), int(shapes.group(2))) != (ds.m, ds.ld.nb) \
            or built.group(1) != lib or float(built.group(2)) != 0.0:
        fail("E1: viprs_warmup_torch read other shapes or rebuilt the "
             "library")
    return rec


# ------------------------------------------- viprs_fit from disk (D0-D3)
#: The port's own result of viprs_fit on the genome's magenpy Zarr store
#: with the default packing (D2: float32 tiles = int8 / 127, which the
#: genome's float64 blocks never give): nit and h2, held bit for bit.
PORT_DISK_F32_NIT, PORT_DISK_F32_H2 = 111, 0.21560984128543248
#: The kernels each disk path launched (as in SELECT_PATHS).
DISK_PATHS = ('D0 VIPRS', 'D0 VIPRSMix', 'D0 GS-PUMAS', 'D0 BMA',
              'D0 validation-sumstats', 'D0 extract', 'D0 streamed',
              'D0 zarr-int8', 'D1 viprs_fit int8', 'D2 viprs_fit float32')
#: The alleles the disk phases draw for a variant (palindromic and
#: multi-letter ones among them) and the strand complement.
ALLELES = (('A', 'G'), ('C', 'T'), ('G', 'A'), ('T', 'C'), ('A', 'C'),
           ('G', 'T'), ('A', 'T'), ('C', 'G'), ('AT', 'A'), ('G', 'GCA'))
COMPLEMENT = str.maketrans('ATCG', 'TAGC')
#: D0's cut of the genome.
D0_CHROMS = (21, 22)
#: D0's viprs_fit modes (the arguments after the store and the sumstats).
D0_MODES = {
    'VIPRS': [],
    'VIPRSMix': ['-m', 'VIPRSMix', '--n-components', '3'],
    'GS-PUMAS': ['--hyp-search', 'GS', '--grid-metric', 'pseudo_validation',
                 '--pi-steps', '4'],
    'BMA': ['--hyp-search', 'BMA', '--pi-steps', '4'],
    'validation-sumstats': ['--hyp-search', 'GS', '--grid-metric',
                            'pseudo_validation', '--pi-steps', '4',
                            '--validation-sumstats', '{root}/cut_val.txt'],
    'extract': ['--extract', '{root}/cut_extract.txt'],
    'streamed': ['--device-memory-gb', '{gb}'],
    'zarr-int8': ['--dequantize-on-the-fly'],
}


def disk_tables(chroms, seed):
    """{chrom: Table(CHR, SNP, POS, A1, A2)} of chromosomes {chrom: m}."""
    from viprs_tpu_torch.utils.table import Table
    rng = np.random.default_rng(seed)
    out = {}
    for c, m in chroms.items():
        pick = rng.integers(0, len(ALLELES), m)
        out[c] = Table({'CHR': c, 'SNP': np.char.add(f'rs{c}_', np.arange(
                            m).astype(str)),
                        'POS': 10_000 + 1_000 * np.arange(m, dtype=np.int64),
                        'A1': np.asarray([a for a, _ in ALLELES])[pick],
                        'A2': np.asarray([b for _, b in ALLELES])[pick]})
    return out


def write_zarr_stores(root, blocks, tables):
    """One magenpy Zarr store a chromosome, int8, upper-triangular rows
    (the published panels' layout), with the port's writer."""
    from viprs_tpu_torch.data import ld_store
    for c in sorted(blocks):
        data, indptr, left = ld_store.dense_blocks_to_banded(blocks[c])
        ld_store.save_magenpy_zarr(os.path.join(root, f'chr_{c}'), data,
                                   indptr, left, snp_table=tables[c],
                                   chrom=c, triangular=True)


def write_disk_sumstats(path, tables, std_beta, n, seed, drop=0.0, extra=0):
    """A magenpy-format summary statistics file of ``std_beta`` (Z written
    exactly, N = ``n``): ~10% of the variants with A1/A2 swapped and Z
    negated, ~10% of the others (not palindromic) strand-complemented,
    ``drop`` of them absent and ``extra`` variants the LD lacks. Returns
    the row count."""
    from viprs_tpu_torch.utils.table import Table
    rng = np.random.default_rng(seed)
    t = Table.concat(tables[c] for c in sorted(tables))
    b = np.concatenate([np.asarray(std_beta[c], np.float64)
                        for c in sorted(tables)])
    z = b * np.sqrt(n / (1.0 - b * b))
    a1, a2 = t['A1'], t['A2']
    m = len(t)
    swap = rng.random(m) < 0.1
    pal = np.char.translate(a1, COMPLEMENT) == a2
    comp = (rng.random(m) < 0.1) & ~pal & ~swap
    s1, s2 = np.where(swap, a2, a1), np.where(swap, a1, a2)
    s1 = np.where(comp, np.char.translate(s1, COMPLEMENT), s1)
    s2 = np.where(comp, np.char.translate(s2, COMPLEMENT), s2)
    keep = rng.random(m) >= drop
    ss = Table({'CHR': t['CHR'], 'SNP': t['SNP'], 'POS': t['POS'], 'A1': s1,
                'A2': s2, 'N': np.full(m, float(n)),
                'Z': np.where(swap, -z, z)}).take(keep)
    if extra:
        c = max(tables)
        ss = Table.concat([ss, Table({
            'CHR': c, 'SNP': [f'rsX{c}_{i}' for i in range(extra)],
            'POS': np.arange(extra, dtype=np.int64), 'A1': 'A', 'A2': 'G',
            'N': float(n), 'Z': rng.standard_normal(extra)})])
    ss.write(path)
    return len(ss)


def disk_prepare(ld_blocks, std_beta, n_per_snp):
    """Write the disk phases' files into a temporary directory: the genome
    as 22 Zarr stores and its summary statistics with flips and complements
    and no variant removed (D1-D3); D0's cut (chromosomes D0_CHROMS) as a
    native int8 store and as Zarr stores, its summary statistics (2% of
    the variants absent, 5 the LD lacks), validation statistics (the
    betas again with fresh noise) and an --extract list."""
    import atexit
    import shutil
    import tempfile
    from viprs_tpu_torch.data import ld_store
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix='viprs_fit_disk_')
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    n = float(np.max(n_per_snp[1]))
    tables = disk_tables({c: len(v) for c, v in std_beta.items()}, seed=1)
    write_zarr_stores(os.path.join(root, 'genome'), ld_blocks, tables)
    t_store = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = write_disk_sumstats(os.path.join(root, 'genome_ss.txt'), tables,
                               std_beta, n, seed=2)
    t_ss = time.perf_counter() - t0
    cut = {c: ld_blocks[c] for c in D0_CHROMS}
    cut_tab = {c: tables[c] for c in D0_CHROMS}
    ld_store.save_ld_store(os.path.join(root, 'cut_native'), cut, cut_tab,
                           quantize=True)
    write_zarr_stores(os.path.join(root, 'cut_zarr'), cut, cut_tab)
    cut_sb = {c: std_beta[c] for c in D0_CHROMS}
    write_disk_sumstats(os.path.join(root, 'cut_ss.txt'), cut_tab, cut_sb, n,
                        seed=3, drop=0.02, extra=5)
    rng = np.random.default_rng(4)
    val_sb = {c: v + rng.standard_normal(len(v)) / np.sqrt(n)
              for c, v in cut_sb.items()}
    write_disk_sumstats(os.path.join(root, 'cut_val.txt'), cut_tab, val_sb,
                        n, seed=5)
    with open(os.path.join(root, 'cut_extract.txt'), 'w') as f:
        for c in D0_CHROMS:
            f.write('\n'.join(cut_tab[c]['SNP'][::4].tolist()) + '\n')
    m_cut = sum(len(cut_tab[c]) for c in D0_CHROMS)
    phase('D', f"files in {root}: the genome's 22 Zarr stores (int8, "
               f"upper-triangular rows) {t_store:.1f} s, its summary "
               f"statistics ({rows} rows) {t_ss:.1f} s; the cut, chromosomes "
               f"{D0_CHROMS} ({m_cut} variants), as a native and a Zarr "
               f"store")
    return dict(root=root, tables=tables, m_cut=m_cut, store_s=t_store,
                sumstats_s=t_ss)


def _stages(sec):
    """A run's stage seconds as printed on a phase line."""
    names = (('tables', 'tables'), ('sumstats', 'sumstats'),
             ('harmonize', 'harmonize'), ('ld_read', 'LD read'),
             ('pack', 'pack'), ('cache', 'cache'), ('upload', 'upload'),
             ('fit', 'fit'), ('write', 'write'), ('total', 'total'))
    return ', '.join(f"{label} {sec[k]:.2f} s" for k, label in names
                     if k in sec)


def _cli(argv, device, cache='off'):
    """One viprs_fit run through the port's CLI entry (its record), with
    the pack cache at ``cache``; on the card the launch counters are reset
    just before and read just after."""
    import torch
    from viprs_tpu_torch.cli import fit as cli_fit
    from viprs_tpu_torch.ops import cavi_cuda
    os.environ['VIPRS_TPU_TORCH_PACK_CACHE'] = cache
    if device == 'cuda':
        torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    rec = cli_fit.run([*argv, '--device', device])
    if device == 'cuda':
        torch.cuda.synchronize()
    rec['launches'] = dict(cavi_cuda.LAUNCHES)
    return rec


def _outputs(prefix):
    """The tables a run wrote: .fit.gz, .hyp and .validation (or None)."""
    from viprs_tpu_torch.utils.table import read_table
    out = {'fit': read_table(prefix + '.fit.gz', sep='\t'),
           'hyp': read_table(prefix + '.hyp', sep='\t')}
    v = prefix + '.validation'
    out['validation'] = read_table(v, sep='\t') if os.path.exists(v) \
        else None
    return out


def _hyp(out, name):
    """The .hyp values of a parameter (one a chromosome group)."""
    hyp = out['hyp']
    return hyp['Value'][hyp['Parameter'] == name]


def _stops(rec, out):
    """The stops of a run: its iterations and last messages, then each grid
    point's message and the row selected by pseudo-R^2 (a grid's
    validation table)."""
    v = out['validation']
    stops = [(rec['nit'], *rec['messages'])]
    if v is not None:
        stops += v['Optimization_message'].tolist()
        if 'Pseudo_Validation_R2' in v:
            stops.append(_pv_index(v['Pseudo_Validation_R2']))
        if 'Validation_R2' in v:
            stops.append(int(np.argmax(v['Validation_R2'])))
    return stops


def d0_cut(disk, record_paths):
    """D0: viprs_fit on the cut in each mode of D0_MODES, on the card and
    on the CPU. The card's .fit.gz has the CPU's variants in the CPU's
    order; its stops are the CPU's or waived (guarded_stops, asking the
    CPU and the card; a CLI run being one fit or one grid); where the
    stops agree the .hyp ELBO is within 1e-6 (relative) and h2 within
    1e-6, the .validation ELBOs within 1e-6 and pseudo-R^2 within 1e-5
    (relative) with the CPU's selected row, BETA within 1e-4 of the
    largest |BETA| and PIP within 1e-2 (at n = 350,000 a variant's logit
    is large, and a PIP near 1/2 carries its float32 summation order: one
    read 1.5e-3 on an H100). The CPU run launches no kernel."""
    from viprs_tpu_torch.data.loader import GWADataLoader
    root = disk['root']
    store = {'native': os.path.join(root, 'cut_native'),
             'zarr': os.path.join(root, 'cut_zarr', 'chr_*')}
    per = GWADataLoader(ld_store_files=store['native'],
                        sumstats_files=os.path.join(root, 'cut_ss.txt'),
                        ).estimate_packed_bytes()
    gb = 1.2 * max(per.values()) / 0.65 / 1e9
    rec = {}
    for mode, extra in D0_MODES.items():
        st = store['zarr' if mode == 'zarr-int8' else 'native']
        args = [a.format(root=root, gb=gb) for a in extra]

        def run(where, f_abs_tol=TOLS[0], x_abs_tol=TOLS[1], tag=''):
            out = os.path.join(root, 'd0', f'{mode}_{where}{tag}')
            r = _cli(['-l', st, '-s', os.path.join(root, 'cut_ss.txt'),
                      '--seed', '0', '--f-abs-tol', repr(f_abs_tol),
                      '--x-abs-tol', repr(x_abs_tol), *args,
                      '--output-file', out], where)
            return r, _outputs(out)
        (rc, oc), (rp, op) = run('cuda'), run('cpu')
        record_paths[f'D0 {mode}'] = rc['launches']
        if any(rp['launches'].values()):
            fail(f"D0 {mode}: the CPU run launched a kernel")
        if list(oc['fit']['SNP']) != list(op['fit']['SNP']) or \
                oc['fit'].columns != op['fit'].columns:
            fail(f"D0 {mode}: the card's .fit.gz rows differ from the CPU's")
        e_c, e_p = _hyp(oc, 'ELBO'), _hyp(op, 'ELBO')
        h_c, h_p = _hyp(oc, 'Heritability'), _hyp(op, 'Heritability')
        bc, bp = oc['fit']['BETA'], op['fit']['BETA']
        d = dict(elbo=float(np.max(np.abs(e_c - e_p) / np.abs(e_p))),
                 h2=float(np.max(np.abs(h_c - h_p))),
                 beta=float(np.abs(bc - bp).max() / np.abs(bp).max()),
                 pip=float(np.abs(oc['fit']['PIP'] - op['fit']['PIP']).max()))
        vc, vp = oc['validation'], op['validation']
        if vp is not None:
            d['val_elbo'] = float(np.max(np.abs(vc['ELBO'] - vp['ELBO'])
                                         / np.abs(vp['ELBO'])))
            if 'Pseudo_Validation_R2' in vp:
                pc, pp = vc['Pseudo_Validation_R2'], vp['Pseudo_Validation_R2']
                d['pv'] = float(np.max(np.abs(pc - pp) / np.abs(pp)))
                d['row'] = [_pv_index(pc), _pv_index(pp)]
        sc, sp = _stops(rc, oc), _stops(rp, op)
        phase('D0', f"{mode}: card {_stages(rc['seconds'])}; CPU fit "
                    f"{rp['seconds']['fit']:.2f} s; stops {sc} (card) vs "
                    f"{sp} (CPU); h2 {h_c.tolist()} vs {h_p.tolist()}; |diff|: ELBO "
                    f"{d['elbo']:.2e} (relative), h2 {d['h2']:.2e}, BETA "
                    f"{d['beta']:.2e} of the largest, PIP {d['pip']:.2e}"
                    + (f", grid ELBOs {d['val_elbo']:.2e}" if 'val_elbo' in d
                       else '')
                    + (f", pseudo-R^2 {d['pv']:.2e}, rows {d['row']}"
                       if 'pv' in d else '')
                    + f"; launches {_launched(rc['launches'])}")
        guard = guarded_stops(
            f'D0 {mode}', 'viprs_fit',
            lambda w, f, x: _stops(*run(w, f, x, tag='_tol')), sc, sp,
            devices=('cpu', 'cuda'))
        held = not guard['differ']
        if not held:
            phase('D0', f"{mode}: the stops differ and are waived; the "
                        f"outputs are not held")
        row = d.get('row')
        if held and not (d['elbo'] <= 1e-6 and d['h2'] <= 1e-6
                         and d['beta'] <= 1e-4 and d['pip'] <= 1e-2
                         and d.get('val_elbo', 0.0) <= 1e-6
                         and d.get('pv', 0.0) <= 1e-5
                         and (row is None or row[0] == row[1])):
            fail(f"D0 {mode}: the card's outputs differ from the CPU's")
        if not any(rc['launches'].values()):
            fail(f"D0 {mode}: the card run launched no kernel")
        if (mode == 'streamed') != (rc['groups'] is not None):
            fail(f"D0 {mode}: streamed over {rc['groups']}")
        rec[mode] = dict(card=rc['seconds'], cpu=rp['seconds'],
                         stops=[sc, sp],
                         h2=[h_c.tolist(), h_p.tolist()], diff=d,
                         guard=guard, groups=rc['groups'],
                         launches=_launched(rc['launches']))
    return rec


def _same_files(a, b):
    return all(open(a + s, 'rb').read() == open(b + s, 'rb').read()
               for s in ('.fit.gz', '.hyp'))


def disk_genome(disk, ds, record_paths):
    """D1-D3 on the genome's Zarr stores (1,099,965 variants), on the card.

    D1: viprs_fit --dequantize-on-the-fly (int8 tiles, the hybrid VIPRS
    fit, seed 0): the loader's tiles equal phase 3's bit for bit, its
    std_beta the genome's within 1e-12 (relative) after the flips are
    undone, the .fit.gz rows in the stores' variant order, h2 within 1e-4
    of PORT_H2 (nit recorded, not held: std_beta passes through text).
    D2: the default packing (float32 = int8 / 127): h2 within 0.005 of the
    JAX package's, nit and h2 held to PORT_DISK_F32_*. D3: the pack cache
    in a temporary directory: D1 runs with it and misses (it writes the
    cache); D1 again hits it, reads no LD data and writes D1's files byte
    for byte."""
    import torch
    root = disk['root']
    base = ['-l', os.path.join(root, 'genome', 'chr_*'), '-s',
            os.path.join(root, 'genome_ss.txt'), '--seed', '0']
    out = {k: os.path.join(root, 'out', k) for k in ('d1', 'd2', 'd3b')}
    rec = {}

    cache = os.path.join(root, 'pack_cache')
    r1 = _cli([*base, '--dequantize-on-the-fly', '--output-file', out['d1']],
              'cuda', cache=cache)
    record_paths['D1 viprs_fit int8'] = r1['launches']
    lds = r1['loader']._dataset
    same = all(torch.equal(getattr(lds.ld, f), getattr(ds.ld, f))
               for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask'))
    same &= np.array_equal(lds.layout.flat_index, ds.layout.flat_index)
    rel = max(float(np.max(np.abs(lds.std_beta[c] - ds.std_beta[c])
                           / np.abs(ds.std_beta[c])))
              for c in ds.std_beta)
    o1 = _outputs(out['d1'])
    order = list(o1['fit']['SNP']) == [
        s for c in sorted(disk['tables']) for s in disk['tables'][c]['SNP']]
    h1 = float(_hyp(o1, 'Heritability')[0])
    del lds
    r1.pop('loader')
    phase('D1', f"viprs_fit --dequantize-on-the-fly on the genome's Zarr "
                f"stores: {_stages(r1['seconds'])}; {len(o1['fit'])} rows in "
                f"the stores' order: {order}; tiles equal to phase 3's: "
                f"{same}; std_beta max relative |diff| {rel:.2e} (bound "
                f"1e-12); nit {r1['nit']} (phase 5: {PORT_NIT}), h2 {h1!r} "
                f"(PORT_H2 {PORT_H2}, bound 1e-4); launches "
                f"{_launched(r1['launches'])}")
    if not (same and order and rel <= 1e-12 and abs(h1 - PORT_H2) <= 1e-4
            and len(o1['fit']) == ds.m):
        fail("D1: viprs_fit from the Zarr stores disagrees with phase 3")
    if min(r1['launches'][k] for k in ('cavi_block_sweep_s1',
                                       'coupling_pass_s1')) < 1:
        fail(f"D1: a kernel of the path was never launched: {r1['launches']}")
    rec['d1'] = dict(seconds=r1['seconds'], nit=r1['nit'], h2=h1,
                     std_beta_rel=rel, launches=_launched(r1['launches']),
                     fit=out['d1'] + '.fit.gz')

    r2 = _cli([*base, '--output-file', out['d2']], 'cuda')
    record_paths['D2 viprs_fit float32'] = r2['launches']
    r2.pop('loader')
    h2 = float(_hyp(_outputs(out['d2']), 'Heritability')[0])
    phase('D2', f"viprs_fit (float32 tiles) on the genome's Zarr stores: "
                f"{_stages(r2['seconds'])}; nit {r2['nit']}, h2 {h2!r} "
                f"(JAX package {REF_H2}, bound 0.005; PORT_DISK_F32_* "
                f"{PORT_DISK_F32_NIT}, {PORT_DISK_F32_H2}); launches "
                f"{_launched(r2['launches'])}")
    if abs(h2 - REF_H2) > 0.005:
        fail(f"D2: h2 {h2} is not within 0.005 of {REF_H2}")
    if (r2['nit'], h2) != (PORT_DISK_F32_NIT, PORT_DISK_F32_H2):
        fail(f"D2: nit {r2['nit']}, h2 {h2!r} moved from the port's earlier "
             f"runs ({PORT_DISK_F32_NIT}, {PORT_DISK_F32_H2!r})")
    if min(r2['launches'][k] for k in ('cavi_block_sweep_s1_f32',
                                       'coupling_pass_s1_f32')) < 1:
        fail(f"D2: a kernel of the path was never launched: {r2['launches']}")
    rec['d2'] = dict(seconds=r2['seconds'], nit=r2['nit'], h2=h2,
                     launches=_launched(r2['launches']))

    hit = _cli([*base, '--dequantize-on-the-fly', '--output-file',
                out['d3b']], 'cuda', cache=cache)
    hit.pop('loader')
    r3 = {'d3a': r1, 'd3b': hit}
    miss = r1
    prep = {k: sum(v for s, v in r3[k]['seconds'].items()
                   if s not in ('fit', 'write', 'total')) for k in r3}
    ok = (miss['ld_data_reads'] == 22 and hit['ld_data_reads'] == 0
          and _same_files(out['d3b'], out['d1']))
    phase('D3', f"the pack cache: miss {_stages(miss['seconds'])} (data "
                f"preparation {prep['d3a']:.2f} s, {miss['ld_data_reads']} "
                f"stores read); hit {_stages(hit['seconds'])} (data "
                f"preparation {prep['d3b']:.2f} s, {hit['ld_data_reads']} "
                f"stores read); the hit's .fit.gz and .hyp byte for byte "
                f"D1's: {ok}")
    if not ok:
        fail("D3: the pack cache missed, read LD data on a hit, or changed "
             "the outputs")
    rec['d3'] = dict(miss=miss['seconds'], hit=hit['seconds'],
                     prep_s=prep)
    return rec


def disk_phases(disk, ds, record_paths):
    """D0-D3 (viprs_fit from files on disk; the caller deletes the
    files)."""
    rec = {'prepare': {k: disk[k] for k in ('store_s', 'sumstats_s',
                                            'm_cut')},
           'd0': d0_cut(disk, record_paths)}
    rec.update(disk_genome(disk, ds, record_paths))
    return rec

# ------------------------------------------------------------- genotypes
#: The genotype paths whose kernel launches the kernels line reports.
GENO_PATHS = ('V0 VIPRS', 'V0 GS-validation')
#: V0's cut: training samples (2,003 is not a multiple of 4, so the last
#: byte of each BED row holds padding codes), validation samples, and
#: variants on each of V0_CHROMS.
V0_N, V0_N_VAL, V0_M = 2003, 1001, 2000
V0_CHROMS = (21, 22)
#: compute_ld's estimators on V0 and their arguments; 'block' is fitted
#: (blocks of 1,500 variants span two 1,024-variant tiles: the fits launch
#: the coupling passes too).
V0_ESTIMATORS = {'sample': {}, 'block': {'max_block_size': 1500},
                 'windowed': {'window_kb': 200},
                 'shrinkage': {'max_block_size': 500}}
#: V0's viprs_fit modes (after the store and the sumstats). The grid's
#: second point (pi 0.0108) converges in 628 iterations on this cut, a stop
#: within a factor 2 of a threshold that guarded_stops then reruns 8 times
#: (~170 s on a slow host), so the grid stops at 150 iterations: pi 0.0025
#: converges (25 iterations), pi 0.0108 reaches the limit, and pi 0.046 and
#: 0.2, whose negative MSE is restarted only when iterations remain after
#: the chunk, end invalid and score -inf.
V0_MODES = {
    'VIPRS': [],
    'GS-validation': ['--hyp-search', 'GS', '--grid-metric', 'validation',
                      '--pi-steps', '4', '--max-iter', '150',
                      '--validation-bed', '{root}/val', '--validation-pheno',
                      '{root}/val_pheno.txt'],
}
#: V1: a cohort scored genome-wide; the samples the card and the CPU both
#: score; the HWE rows the genotype bytes are drawn from.
V1_N, V1_KEEP, V1_POOL = 10_000, 1_000, 4096
#: V2: the LD panel's samples and chromosomes.
V2_N, V2_CHROMS = 5_000, (21, 22)


def bed_rows(dosages):
    """The variant-major plink BED rows ((m, ceil(n / 4)) uint8) of (n, m)
    dosages: 2 -> 00, 1 -> 10, 0 -> 11, NaN (missing) -> 01; a row's unused
    last codes 00."""
    n, m = dosages.shape
    d = dosages.T
    code = np.zeros((m, n + (-n) % 4), np.uint8)
    code[:, :n] = np.where(np.isnan(d), 1, np.where(
        d == 2, 0, np.where(d == 1, 2, 3)))
    q = code.reshape(m, -1, 4)
    return q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6


def write_plink(prefix, rows, bim, fam):
    """A plink fileset: the BED magic and ``rows``, and the .bim and .fam
    Tables as headerless tab-separated text (this script's own writer)."""
    with open(prefix + '.bed', 'wb') as f:
        f.write(b'\x6c\x1b\x01')
        np.ascontiguousarray(rows, np.uint8).tofile(f)
    for ext, t in (('.bim', bim), ('.fam', fam)):
        cols = [np.asarray(v).astype(str).tolist() for _, v in t.items()]
        with open(prefix + ext, 'w') as f:
            f.write('\n'.join('\t'.join(r) for r in zip(*cols)) + '\n')
    return prefix


def plink_tables(tables, swap=None):
    """The .bim Table of {chrom: Table(CHR SNP POS A1 A2)} (CM 0), A1 and
    A2 exchanged where ``swap``."""
    from viprs_tpu_torch.utils.table import Table
    t = Table.concat(tables[c] for c in sorted(tables))
    a1, a2 = t['A1'], t['A2']
    if swap is not None:
        a1, a2 = np.where(swap, a2, a1), np.where(swap, a1, a2)
    return Table({'CHR': t['CHR'], 'SNP': t['SNP'], 'CM': 0, 'POS': t['POS'],
                  'A1': a1, 'A2': a2})


def fam_table(prefix, n, pheno=-9):
    from viprs_tpu_torch.utils.table import Table
    ids = np.char.add(prefix, np.arange(n).astype(str))
    return Table({'FID': ids, 'IID': ids, 'father': 0, 'mother': 0,
                  'sex': 1, 'PHENO': pheno})


def write_pheno(path, fam, y):
    with open(path, 'w') as f:
        f.write(''.join(f'{a} {b} {v!r}\n' for a, b, v in
                        zip(fam['FID'].tolist(), fam['IID'].tolist(),
                            np.asarray(y, np.float64).tolist())))


def ar1_dosages(n, m, rng, block=100, rho=0.8, missing=0.01):
    """(n, m) AR(1) dosages from the port's simulate_dosages, LD blocks of
    ``block`` variants, ``missing`` of the calls NaN."""
    from viprs_tpu_torch.data.simulate import simulate_dosages
    parts, left = [], m
    while left:
        parts.append(simulate_dosages(n, min(block, left), rho=rho, rng=rng))
        left -= parts[-1].shape[1]
    dos = np.concatenate(parts, axis=1)
    dos[rng.random(dos.shape) < missing] = np.nan
    return dos


def _sync():
    import torch
    torch.cuda.synchronize()


def _close(got, want, rtol, atol=0.0):
    """max |got - want| / (rtol |want| + atol) (<= 1 within tolerance)."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    if got.shape != want.shape:
        return np.inf
    return float(np.max(np.abs(got - want) / (rtol * np.abs(want) + atol
                                              + 1e-300), initial=0.0))


def v0_files(root):
    """V0's filesets: training (PHENO in its .fam) and validation (with a
    phenotype file), the same variants; h2 0.4 over 2% of them."""
    rng = np.random.default_rng(14)
    n = V0_N + V0_N_VAL
    dos = ar1_dosages(n, len(V0_CHROMS) * V0_M, rng, missing=0.0)
    sd = dos.std(0)
    x = (dos - dos.mean(0)) / np.where(sd > 0, sd, 1.0)
    beta = np.where(rng.random(dos.shape[1]) < 0.02,
                    rng.standard_normal(dos.shape[1]), 0.0)
    g = x @ beta
    y = g / g.std() * np.sqrt(0.4) + rng.standard_normal(n) * np.sqrt(0.6)
    dos[rng.random(dos.shape) < 0.01] = np.nan
    bim = plink_tables(disk_tables({c: V0_M for c in V0_CHROMS}, seed=15))
    write_plink(os.path.join(root, 'train'), bed_rows(dos[:V0_N]), bim,
                fam_table('T', V0_N, y[:V0_N]))
    vfam = fam_table('V', V0_N_VAL)
    write_plink(os.path.join(root, 'val'), bed_rows(dos[V0_N:]), bim, vfam)
    write_pheno(os.path.join(root, 'val_pheno.txt'), vfam, y[V0_N:])


def v0_data(root, dev):
    """GWAS and the four LD estimators on V0's training fileset on ``dev``;
    the GWAS written as summary statistics and the block LD as an int8
    store for viprs_fit. Returns the arrays held and the seconds."""
    from viprs_tpu_torch.data import ld_store
    from viprs_tpu_torch.data.genotype import GenotypeMatrix
    from viprs_tpu_torch.data.loader import GWADataLoader
    train = os.path.join(root, 'train')
    out, sec = {}, {}
    out['dosages'] = GenotypeMatrix(train, device=dev).dosages()
    loader = GWADataLoader(bed_files=train, device=dev)
    t0 = time.perf_counter()
    gwas = loader.perform_gwas()
    sec['gwas'] = time.perf_counter() - t0
    gwas.table.write(os.path.join(root, f'ss_{dev}.txt'))
    out['gwas'] = gwas.table
    out['ld'] = {}
    for est, kw in V0_ESTIMATORS.items():
        t0 = time.perf_counter()
        loader.compute_ld(est, **kw)
        sec[est] = time.perf_counter() - t0
        out['ld'][est] = loader.ld_blocks
    ld_store.save_ld_store(os.path.join(root, f'ld_{dev}'), out['ld']['block'],
                           loader.ld_snp_tables, quantize=True)
    return out, sec


def _score(argv, device):
    from viprs_tpu_torch.cli import score as cli_score
    if device == 'cuda':
        _sync()
    return cli_score.run([*argv, '--device', device])


def _evaluate(prs, pheno, out):
    from viprs_tpu_torch.cli import evaluate as cli_evaluate
    from viprs_tpu_torch.utils.table import read_table
    cli_evaluate.main(['--prs-file', prs, '--phenotype-file', pheno,
                       '--output-file', out])
    return read_table(out + '.eval', sep='\t')


def v0_cut(root, card, record_paths):
    """V0 (see the module docstring)."""
    from viprs_tpu_torch.utils.table import read_table
    t0 = time.perf_counter()
    v0_files(root)
    t_files = time.perf_counter() - t0
    data, sec = {}, {}
    for dev in ('cuda', 'cpu'):
        data[dev], sec[dev] = v0_data(root, dev)
    c, p = data['cuda'], data['cpu']
    same_dos = c['dosages'].shape == (V0_N, len(V0_CHROMS) * V0_M) and \
        np.array_equal(c['dosages'], p['dosages'], equal_nan=True)
    gwas = {k: _close(c['gwas'][k], p['gwas'][k], 1e-9, 1e-15)
            for k in ('BETA', 'SE', 'Z')}
    ld = {est: max(float(np.abs(a - b).max()) for ch in p['ld'][est]
                   for a, b in zip(c['ld'][est][ch], p['ld'][est][ch]))
          for est in V0_ESTIMATORS}
    same_blocks = all([x.shape for x in c['ld'][e][ch]]
                      == [x.shape for x in p['ld'][e][ch]]
                      for e in V0_ESTIMATORS for ch in p['ld'][e])
    phase('V0', f"{card}: files {t_files:.2f} s; dosages ({V0_N} x "
                f"{len(V0_CHROMS) * V0_M}) bit for bit: {same_dos}; GWAS "
                f"|diff| / (1e-9 |CPU|): "
                + ', '.join(f"{k} {v:.2e}" for k, v in gwas.items())
                + "; LD max |diff| (bound 1e-12): "
                + ', '.join(f"{k} {v:.2e}" for k, v in ld.items())
                + f"; seconds card {sec['cuda']}, CPU {sec['cpu']}")
    if not (same_dos and same_blocks and max(gwas.values()) <= 1
            and max(ld.values()) <= 1e-12):
        fail("V0: the card's dosages, GWAS or LD differ from the CPU's")

    rec = dict(files_s=t_files, data_s=sec, gwas=gwas, ld=ld, fits={})
    for mode, extra in V0_MODES.items():
        args = [a.format(root=root) for a in extra]

        def run(where, f_abs_tol=TOLS[0], x_abs_tol=TOLS[1], tag=''):
            out = os.path.join(root, 'v0', f'{mode}_{where}{tag}')
            r = _cli(['-l', os.path.join(root, f'ld_{where}'), '-s',
                      os.path.join(root, f'ss_{where}.txt'), '--seed', '0',
                      '--f-abs-tol', repr(f_abs_tol), '--x-abs-tol',
                      repr(x_abs_tol), *args, '--output-file', out], where)
            r.pop('loader')
            return r, _outputs(out)
        (rc, oc), (rp, op) = run('cuda'), run('cpu')
        record_paths[f'V0 {mode}'] = rc['launches']
        if any(rp['launches'].values()):
            fail(f"V0 {mode}: the CPU run launched a kernel")
        if not any(rc['launches'].values()):
            fail(f"V0 {mode}: the card run launched no kernel")
        if list(oc['fit']['SNP']) != list(op['fit']['SNP']):
            fail(f"V0 {mode}: the card's .fit.gz rows differ from the CPU's")
        e_c, e_p = _hyp(oc, 'ELBO'), _hyp(op, 'ELBO')
        h_c, h_p = _hyp(oc, 'Heritability'), _hyp(op, 'Heritability')
        d = dict(elbo=float(np.max(np.abs(e_c - e_p) / np.abs(e_p))),
                 h2=float(np.max(np.abs(h_c - h_p))))
        vc, vp = oc['validation'], op['validation']
        if vp is not None:
            # a lane that did not terminate validly scores -inf
            r_c, r_p = vc['Validation_R2'], vp['Validation_R2']
            fin = np.isfinite(r_p)
            d['val_r2'] = float(np.max(np.abs(r_c[fin] - r_p[fin])
                                       / np.abs(r_p[fin]), initial=0.0)) \
                if np.array_equal(fin, np.isfinite(r_c)) else np.inf
            d['row'] = [int(np.argmax(r_c)), int(np.argmax(r_p))]
        sc, sp = _stops(rc, oc), _stops(rp, op)
        phase('V0', f"{card}: viprs_fit {mode}: card fit "
                    f"{rc['seconds']['fit']:.2f} s, CPU fit "
                    f"{rp['seconds']['fit']:.2f} s; stops {sc} (card) vs "
                    f"{sp} (CPU); h2 {h_c.tolist()} vs {h_p.tolist()}; ELBO "
                    f"|diff| {d['elbo']:.2e} (relative)"
                    + (f"; Validation_R2 {vc['Validation_R2'].tolist()} vs "
                       f"{vp['Validation_R2'].tolist()}, rows {d['row']}"
                       if vp is not None else '')
                    + f"; launches {_launched(rc['launches'])}")
        guard = guarded_stops(
            f'V0 {mode}', 'viprs_fit',
            lambda w, f, x: _stops(*run(w, f, x, tag='_tol')), sc, sp,
            devices=('cpu', 'cuda'))
        if not guard['differ'] and not (
                d['elbo'] <= 1e-6 and d['h2'] <= 1e-6
                and d.get('val_r2', 0.0) <= 1e-6
                and d.get('row', [0, 0])[0] == d.get('row', [0, 0])[1]):
            fail(f"V0 {mode}: the card's outputs differ from the CPU's")

        # the card's fit scored on the card and on the CPU, then evaluated
        fit_file = os.path.join(root, 'v0', f"{mode}_{'cuda'}.fit.gz")
        prs, ev = {}, {}
        for dev in ('cuda', 'cpu'):
            out = os.path.join(root, 'v0', f'{mode}_score_{dev}')
            s = _score(['-f', fit_file, '--bed-files',
                        os.path.join(root, 'val'), '--output-file', out], dev)
            prs[dev] = read_table(s['output'], sep='\t')
            ev[dev] = _evaluate(s['output'],
                                os.path.join(root, 'val_pheno.txt'), out)
        d_prs = _close(prs['cuda']['PRS'], prs['cpu']['PRS'], 1e-9)
        d_eval = float(np.max(np.abs(ev['cuda']['Value']
                                     - ev['cpu']['Value'])))
        r2 = float(ev['cuda']['Value'][ev['cuda']['Metric'] == 'R2'][0])
        phase('V0', f"{card}: viprs_score of the card's {mode} fit on the "
                    f"validation samples, card vs CPU: |diff| / (1e-9 |CPU|) "
                    f"{d_prs:.2e}; viprs_evaluate |diff| {d_eval:.2e} (bound "
                    f"1e-9), R2 {r2:.4f}")
        if not (d_prs <= 1 and d_eval <= 1e-9 and len(prs['cuda']) == V0_N_VAL
                and np.isfinite(prs['cuda']['PRS']).all()
                and list(ev['cuda']['Metric']) == list(ev['cpu']['Metric'])):
            fail(f"V0 {mode}: the card's scores or evaluation differ from "
                 f"the CPU's")
        rec['fits'][mode] = dict(card=rc['seconds'], cpu=rp['seconds'],
                                 stops=[sc, sp], h2=[h_c.tolist(),
                                                     h_p.tolist()],
                                 diff=d, guard=guard, prs=d_prs, eval=d_eval,
                                 r2=r2, launches=_launched(rc['launches']))
    return rec


def v1_files(root, tables):
    """V1's 22 filesets: the genome's variants (10% of the alleles
    swapped) x V1_N samples; each variant's row is a row of a pool of
    V1_POOL HWE rows (MAF uniform in [0.05, 0.5], 1% missing) rotated by a
    random number of bytes."""
    rng = np.random.default_rng(21)
    stride = (V1_N + 3) // 4
    maf = rng.uniform(0.05, 0.5, V1_POOL)
    pool = rng.binomial(2, maf, (V1_N, V1_POOL)).astype(np.float64)
    pool[rng.random(pool.shape) < 0.01] = np.nan
    pool = bed_rows(pool)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([pool, pool], axis=1), stride, axis=1)
    fam = fam_table('S', V1_N)
    for c in sorted(tables):
        m = len(tables[c])
        bim = plink_tables({c: tables[c]}, swap=rng.random(m) < 0.1)
        rows = win[rng.integers(0, V1_POOL, m), rng.integers(0, stride, m)]
        write_plink(os.path.join(root, f'chr_{c}'), rows, bim, fam)
    with open(os.path.join(root, 'keep.txt'), 'w') as f:
        f.write(''.join(f'{i} {i}\n' for i in fam['IID'][:V1_KEEP].tolist()))
    return fam


def _stage_line(sec):
    names = (('tables', '.bim/.fam read'), ('fit_read', '.fit read'),
             ('harmonize', 'harmonize'), ('bed_read', 'BED read'),
             ('upload', 'upload'), ('decode', 'decode+standardize'),
             ('product', 'product'), ('write', 'write'), ('total', 'total'))
    return ', '.join(f"{label} {sec[k]:.3f} s" for k, label in names
                     if k in sec)


def v1_genome_scoring(root, tables, fit_file, card):
    """V1 (see the module docstring)."""
    from viprs_tpu_torch.utils.table import read_table
    t0 = time.perf_counter()
    v1_files(root, tables)
    t_files = time.perf_counter() - t0
    m = sum(len(t) for t in tables.values())
    beds = os.path.join(root, 'chr_*.bed')
    r = _score(['-f', fit_file, '--bed-files', beds, '--output-file',
                os.path.join(root, 'genome')], 'cuda')
    prs = read_table(r['output'], sep='\t')
    phase('V1', f"{card}: viprs_score of D1's fit, {r['m']} variants x "
                f"{r['n']} samples (22 BED filesets written in {t_files:.1f} "
                f"s), on the card: {_stage_line(r['seconds'])}; "
                f"{r['matched']} variants matched")
    if not (r['n'] == V1_N and r['m'] == m and r['matched'] == m
            and len(prs) == V1_N and np.isfinite(prs['PRS']).all()
            and np.std(prs['PRS']) > 0):
        fail("V1: the genome-wide scores are not finite scores of every "
             "sample over every variant")
    keep = {}
    for dev in ('cuda', 'cpu'):
        k = _score(['-f', fit_file, '--bed-files', beds, '--keep',
                    os.path.join(root, 'keep.txt'), '--output-file',
                    os.path.join(root, f'keep_{dev}')], dev)
        keep[dev] = (k, read_table(k['output'], sep='\t'))
    d_keep = _close(keep['cuda'][1]['PRS'], keep['cpu'][1]['PRS'], 1e-9)
    phase('V1', f"{card}: --keep {V1_KEEP} samples, card vs CPU: |diff| / "
                f"(1e-9 |CPU|) {d_keep:.2e}; card "
                f"{_stage_line(keep['cuda'][0]['seconds'])}; CPU "
                f"{_stage_line(keep['cpu'][0]['seconds'])}")
    if not (d_keep <= 1 and len(keep['cuda'][1]) == V1_KEEP):
        fail("V1: the card's scores of the kept samples differ from the "
             "CPU's")
    return dict(files_s=t_files, seconds=r['seconds'], n=r['n'], m=r['m'],
                keep=dict(diff=d_keep, card=keep['cuda'][0]['seconds'],
                          cpu=keep['cpu'][0]['seconds']))


def v2_gwas_ld(root, v1_root, tables, card):
    """V2 (see the module docstring)."""
    from viprs_tpu_torch.data import ld_estimators
    from viprs_tpu_torch.data.genotype import GenotypeMatrix
    from viprs_tpu_torch.data.loader import GWADataLoader
    rng = np.random.default_rng(22)
    y = rng.standard_normal(V1_N)
    pheno = os.path.join(v1_root, 'pheno.txt')
    write_pheno(pheno, fam_table('S', V1_N), y)
    loader = GWADataLoader(bed_files=os.path.join(v1_root, 'chr_*.bed'),
                           phenotype_file=pheno, device='cuda')
    _sync()
    t0 = time.perf_counter()
    gwas = loader.perform_gwas()
    _sync()
    t_gwas = time.perf_counter() - t0
    g22 = GenotypeMatrix(os.path.join(v1_root, 'chr_22'), device='cpu')
    want = g22.perform_gwas(loader.phenotype).table
    got = gwas.table.take(gwas.table['CHR'] == 22)
    d_gwas = _close(got['BETA'], want['BETA'], 1e-9, 1e-15)
    stages = loader.genotype.timings
    phase('V2', f"{card}: GWAS of {loader.genotype.m} variants x "
                f"{loader.n} samples on the card {t_gwas:.3f} s ("
                f"{_stage_line(stages)}); chromosome 22's BETA card vs CPU "
                f"|diff| / (1e-9 |CPU|) {d_gwas:.2e}")
    if not (d_gwas <= 1 and len(gwas) == loader.genotype.m
            and np.isfinite(gwas.table['BETA']).all()):
        fail("V2: the card's GWAS differs from the CPU's")

    t0 = time.perf_counter()
    panel = {c: tables[c] for c in V2_CHROMS}
    m = sum(len(t) for t in panel.values())
    rows = np.concatenate([bed_rows(ar1_dosages(V2_N, 1000, rng)
                                    [:, :min(1000, m - i)])
                           for i in range(0, m, 1000)])
    prefix = write_plink(os.path.join(root, 'panel'), rows,
                         plink_tables(panel), fam_table('P', V2_N))
    t_files = time.perf_counter() - t0
    ld_loader = GWADataLoader(bed_files=prefix, device='cuda')
    _sync()
    t0 = time.perf_counter()
    ld_loader.compute_ld('block')
    _sync()
    t_ld = time.perf_counter() - t0
    g = ld_loader.genotype
    blocks = [(c, i, b) for c in V2_CHROMS
              for i, b in enumerate(ld_loader.ld_blocks[c])]
    cpu = GenotypeMatrix(prefix, device='cpu')
    held = sorted(blocks, key=lambda x: x[2].shape[0])[:3]
    d_ld = 0.0
    for c, i, b in held:
        idx = np.where(g.bim['CHR'] == c)[0][i * 4096:(i + 1) * 4096]
        d_ld = max(d_ld, float(np.abs(
            b - ld_estimators._corr(cpu, idx)).max()))
    phase('V2', f"{card}: block LD of {m} variants (chromosomes "
                f"{V2_CHROMS}) x {V2_N} samples on the card {t_ld:.3f} s "
                f"({_stage_line(g.timings)}; panel written in {t_files:.1f} "
                f"s), {len(blocks)} blocks; blocks "
                f"{[(c, i, b.shape[0]) for c, i, b in held]} card vs CPU max "
                f"|diff| {d_ld:.2e} (bound 1e-12)")
    if not (d_ld <= 1e-12 and all(np.isfinite(b).all()
                                  for _, _, b in blocks)):
        fail("V2: the card's LD differs from the CPU's")
    return dict(gwas_s=t_gwas, gwas_stages=stages, gwas_diff=d_gwas,
                ld_s=t_ld, ld_stages=g.timings, ld_diff=d_ld,
                ld_blocks=len(blocks), panel_files_s=t_files)


def geno_phases(disk, card, record_paths):
    """V0-V2 in the disk phases' temporary directory (V1 scores D1's
    .fit.gz)."""
    root = os.path.join(disk['root'], 'geno')
    v1_root = os.path.join(root, 'v1')
    os.makedirs(v1_root)
    rec = {'v0': v0_cut(root, card, record_paths)}
    fit_file = os.path.join(disk['root'], 'out', 'd1.fit.gz')
    rec['v1'] = v1_genome_scoring(v1_root, disk['tables'], fit_file, card)
    rec['v2'] = v2_gwas_ld(root, v1_root, disk['tables'], card)
    return rec



# ------------------------------------------------- the samplers (MC0-MC1)
#: MC1: benchmarks/benchmark_sampler.py's workload on a cut of the genome
#: of at least this many variants (its widths: 4 Gibbs chains, 8 SMC
#: particles, 4 HMC chains).
MC1_M = 150_000
#: Its depths. A Gibbs sweep is host-bound, ~0.25 s (15 launches a
#: coordinate at ~16 us each on the card's host), so the full depths took
#: 104 s (Gibbs, 400 sweeps) and 77 s (SMC, 290 one-chain sweeps): cut to
#: 80 sweeps with the same share of burn-in (30), and to one sweep a stage
#: over the 6 stages (98 sweeps with the final 50), to keep MC0 + MC1 near
#: 60 s. HMC keeps its depth (1.6 s a run).
MC1_GIBBS = dict(n_iter=80, burn_in=30)
MC1_SMC = dict(n_stages=6, sweeps_per_stage=1)
MC1_HMC = dict(n_samples=120, n_leapfrog=10)
#: MC0's near-tie guard: a Gibbs decision is clear when logit(u) lies at
#: least this far, times 1 + |log-odds|, from the coordinate's float64
#: log-odds (float32 log-odds are within 8e-7 of it, tests/
#: test_torch_sampler.py); an HMC acceptance when |log u - log alpha| is
#: at least MC0_HMC_CLEAR.
MC0_GIBBS_CLEAR = 4e-6
MC0_HMC_CLEAR = 1e-3
#: MC0's bounds, card against CPU, each about 10x the deviation measured on
#: an H100 (PERF.md section 6): beta and q within this share of their
#: largest magnitude (measured: equal bit for bit; 1e-6 is ~10 float32
#: ulps of the largest); the HMC energies within this relative error
#: (measured 4.9e-8) and the acceptance probabilities within MC0_ALPHA
#: absolute (measured 1.0e-5).
MC0_REL = 1e-6
MC0_ENERGY_REL = 5e-7
MC0_ALPHA = 1e-4


class FixedDraws:
    """A sampler draw source handing out draws made beforehand (copied to
    ``device``), in order."""

    def __init__(self, device, gibbs=(), hmc=()):
        self.device = device
        self._gibbs, self._hmc = list(gibbs), list(hmc)

    def gibbs(self, shape):
        u, z = self._gibbs.pop(0)
        assert u.shape == shape
        return u.to(self.device), z.to(self.device)

    def hmc(self, shape, n_lo, n_hi):
        z, L, u = self._hmc.pop(0)
        assert z.shape == shape and n_lo <= L <= n_hi
        return z.to(self.device), L, u.to(self.device)

    def clone(self):
        return FixedDraws(self.device, self._gibbs, self._hmc)


def gibbs_margins(ds, state, u, z, g):
    """(C, NB) smallest |logit(u) - u_j| / (1 + |u_j|) of each chain and
    tile over one Gibbs sweep of sampler ``g`` from ``state``, replayed in
    float64 on the host with the sweep's draws (padding lanes left out)."""
    ld = ds.ld
    D = ld.diag.cpu().numpy().astype(np.float64) * ld.scale
    beta, q = (x.cpu().numpy().astype(np.float64) for x in (state.beta,
                                                             state.q))
    u, z = (x.cpu().numpy().astype(np.float64) for x in (u, z))
    sb, nf = (x.cpu().numpy().astype(np.float64)
              for x in ds.device_inputs())
    keep = ld.mask.cpu().numpy() != 0
    v = nf * (1.0 + g.lambda_min) / g.sigma_eps + g.tau_beta
    a = np.log(g.pi) - np.log1p(-g.pi) + 0.5 * (np.log(g.tau_beta)
                                                - np.log(v))
    with np.errstate(divide='ignore'):
        logit_u = np.log(u) - np.log1p(-u)
    worst = np.full(beta.shape[:2], np.inf)
    for j in range(beta.shape[2]):
        m = nf[:, j] / (v[:, j] * g.sigma_eps) * (sb[:, j] - q[:, :, j])
        uj = a[:, j] + 0.5 * v[:, j] * m * m
        gap = np.abs(logit_u[:, :, j] - uj) / (1.0 + np.abs(uj))
        worst = np.minimum(worst, np.where(keep[:, j], gap, np.inf))
        take = (u[:, :, j] < 1.0 / (1.0 + np.exp(-uj))) & keep[:, j]
        b = take * (m + z[:, :, j] / np.sqrt(v[:, j]))
        d = b - beta[:, :, j]
        q = q + d[:, :, None] * D[None, :, j]
        q[:, :, j] -= d
        beta[:, :, j] = b
    return worst


def sampler_cut_checks(sub, sb, nf):
    """MC0: on phase 4's 8-block cut, one Gibbs sweep from a nonzero state
    and a short HMC run (6 samples, 4 leapfrog steps), on the card and on
    the CPU with the same draws (made once on the host): gamma equal and
    beta, q within MC0_REL of their largest magnitude on the chains and
    tiles whose every decision is clear (MC0_GIBBS_CLEAR); the HMC
    energies and acceptance probabilities step by step within
    MC0_ENERGY_REL and MC0_ALPHA, up to the first step with an acceptance
    within MC0_HMC_CLEAR of its draw (after it the chains may part)."""
    import torch
    from viprs_tpu_torch.model import sampler
    t_all = time.perf_counter()
    dss = {w: _dataset_from_cut(sub, sb, nf, torch.device(w))
           for w in ('cuda', 'cpu')}
    cpu = dss['cpu']
    shape = (4, sub.nb, sub.block_size)
    gen = torch.Generator().manual_seed(11)

    def draw():
        return (torch.rand(shape, generator=gen),
                torch.randn(shape, generator=gen))
    first, second = draw(), draw()
    samplers = {w: sampler.GibbsSampler(d, pi=0.01, sigma_eps=0.9,
                                        n_chains=4, seed=0)
                for w, d in dss.items()}
    g = samplers['cpu']
    st0 = g.init_state()._replace(key=FixedDraws('cpu', [first]))
    st1 = sampler._gibbs_sweep(cpu.ld, st0, *g._args(1.0))
    out = {}
    t0 = time.perf_counter()
    for w, d in dss.items():
        st = sampler.GibbsState(*(x.to(w) for x in st1[:3]),
                                key=FixedDraws(torch.device(w), [second]))
        out[w] = sampler._gibbs_sweep(d.ld, st, *samplers[w]._args(1.0))
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    clear = gibbs_margins(cpu, st1, *second, g) >= MC0_GIBBS_CLEAR
    c, cp = out['cuda'], out['cpu']
    if not clear.any():
        fail("MC0: every chain and tile of the Gibbs sweep has a near tie")
    sel = torch.from_numpy(clear)
    n_gamma = int((c.gamma.cpu() != cp.gamma)[sel].sum())
    errs = {k: float((getattr(c, k).cpu() - getattr(cp, k))[sel].abs().max())
            for k in ('beta', 'q')}
    scale = {k: float(getattr(cp, k).abs().max()) for k in ('beta', 'q')}
    phase('MC0', f"Gibbs sweep on the cut ({shape[0]} chains x {sub.nb} "
                 f"tiles x {sub.block_size}), card vs CPU from one state "
                 f"with one set of draws: {int(clear.sum())} of "
                 f"{clear.size} chain-tiles clear of a near tie; gamma "
                 f"differs at {n_gamma} of {int(c.gamma.cpu()[sel].numel())} "
                 f"(included: {int(cp.gamma[sel].sum())}); max |diff| beta "
                 f"{errs['beta']:.3e} (max|beta| {scale['beta']:.3e}), q "
                 f"{errs['q']:.3e} (max|q| {scale['q']:.3e}); bound "
                 f"{MC0_REL:.0e} of the largest")
    if n_gamma or not all(errs[k] <= MC0_REL * scale[k] for k in errs):
        fail("MC0: the Gibbs sweep on the card differs from the CPU's")

    # HMC: the same draws on both devices, every step recorded
    top = np.abs(cpu.std_beta[1]) > np.quantile(np.abs(cpu.std_beta[1]), 0.98)
    gmask = {1: top.astype(np.float64)}
    n_samples, n_leapfrog = 6, 4
    steps = [(torch.randn(shape, generator=gen),
              int(torch.randint(2, n_leapfrog + 1, (), generator=gen)),
              torch.rand(shape[0], generator=gen, dtype=torch.float64))
             for _ in range(n_samples)]
    rec, hmc = {}, {}
    step, source = sampler._hmc_step, sampler._draw_source
    try:
        for w, d in dss.items():
            rec[w] = []

            def spy(*a, _w=w):
                res = step(*a)
                rec[_w].append((res[1].cpu().numpy(), res[2].cpu().numpy()))
                return res
            sampler._hmc_step = spy
            sampler._draw_source = lambda key, device: FixedDraws(device,
                                                                  hmc=steps)
            hmc[w] = sampler.hmc_refine(d, gmask, sigma_eps=0.9,
                                        n_samples=n_samples,
                                        n_leapfrog=n_leapfrog, seed=0)
    finally:
        sampler._hmc_step, sampler._draw_source = step, source
    n_cmp, e_diff, e_scale, a_err = 0, 0.0, 0.0, 0.0
    for k, ((ec, ac), (ep, ap)) in enumerate(zip(rec['cuda'], rec['cpu'])):
        n_cmp = k + 1
        e_diff = max(e_diff, float(np.max(np.abs(ec - ep))))
        e_scale = max(e_scale, float(np.max(np.abs(ep))))
        a_err = max(a_err, float(np.max(np.abs(ac - ap))))
        with np.errstate(divide='ignore'):
            gap = np.abs(np.log(steps[k][2].numpy()) - np.log(ap))
        if gap.min() < MC0_HMC_CLEAR:
            break
    # the energies' error relative to the largest energy compared (the
    # state at zero has energy 0)
    e_err = e_diff / e_scale if e_scale > 0 else e_diff
    phase('MC0', f"HMC on the cut ({int(top.sum())} variants, {n_samples} "
                 f"samples, L <= {n_leapfrog}), card vs CPU with one set of "
                 f"draws: {n_cmp} of {n_samples} steps compared (to the "
                 f"first near tie); energies max |diff| {e_diff:.3e} of "
                 f"max|energy| {e_scale:.3e} (relative bound "
                 f"{MC0_ENERGY_REL:.0e}), acceptance "
                 f"probabilities max |diff| {a_err:.3e} (bound "
                 f"{MC0_ALPHA:.0e}); accept rate {hmc['cuda']['accept_rate']:.4f}"
                 f" vs {hmc['cpu']['accept_rate']:.4f}, step size "
                 f"{hmc['cuda']['step_size']:.4g} vs "
                 f"{hmc['cpu']['step_size']:.4g}")
    if not (e_err <= MC0_ENERGY_REL and a_err <= MC0_ALPHA):
        fail("MC0: the HMC run on the card differs from the CPU's")
    secs = time.perf_counter() - t_all
    phase('MC0', f"{secs:.1f} s")
    return dict(seconds=secs, sweep_s=t_sweep, clear=int(clear.sum()),
                chain_tiles=int(clear.size), beta_err=errs['beta'],
                q_err=errs['q'], scale=scale, hmc_steps_compared=n_cmp,
                energy_rel_err=e_err, alpha_err=a_err,
                accept=[hmc[w]['accept_rate'] for w in ('cuda', 'cpu')])


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


def sampler_launches(ld_ds, g):
    """The device events (kernel launches, copies, fills) of one Gibbs
    sweep of sampler ``g`` under torch.profiler (None: the profiler saw no
    device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from viprs_tpu_torch.model import sampler
    st = g.init_state(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sampler._gibbs_sweep(ld_ds.ld, st, *g._args(1.0))
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def sampler_genome(ds):
    """MC1: benchmarks/benchmark_sampler.py's workload on the card, on the
    first tiles of the int8 genome holding at least MC1_M variants: a VIPRS
    fit (the reference), blocked Gibbs at its hyperparameters, tempered SMC
    over a pi grid of 8 particles and HMC on its PIP > 0.5 variants (cold,
    then steady); seconds, ms per sweep and per step, launches per sweep,
    accept rates, step size, agreement with VI."""
    import torch
    from viprs_tpu_torch.model import VIPRS, sampler
    t_all = time.perf_counter()
    ld = ds.ld
    dev = ld.device
    per_tile = ld.mask.sum(dim=1).cpu().numpy()
    k = int(np.searchsorted(np.cumsum(per_tile), MC1_M)) + 1
    sel = np.arange(min(k, ld.nb))
    sub = cut_blocks(ld, sel, dev)
    sb, nf = (x.index_select(0, torch.as_tensor(sel, device=dev))
              for x in ds.device_inputs())
    dsm = _dataset_from_cut(sub, sb, nf, dev)
    ch = dsm.chromosomes
    np.random.seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vi = VIPRS(dsm, 'cuda').fit(max_iter=1000)
    torch.cuda.synchronize()
    t_vi = time.perf_counter() - t0
    vi_pip = np.concatenate([vi.pip[c] for c in ch])
    vi_eta = np.concatenate([vi.post_mean_beta[c] for c in ch])
    hyper = dict(pi=float(vi.pi), tau_beta=float(vi.tau_beta),
                 sigma_eps=float(vi.sigma_epsilon))
    phase('MC1', f"the cut: {dsm.m} variants in {sub.nb} tiles of "
                 f"{sub.block_size}, {sub.n_off} coupling tiles; VI fit "
                 f"{t_vi:.2f} s ({vi.optim_result.nit} iterations, h2 "
                 f"{vi.get_heritability():.4f}, pi {hyper['pi']:.5f}, "
                 f"{int((vi_pip > 0.5).sum())} variants with PIP > 0.5)")
    rec = dict(m=dsm.m, tiles=sub.nb, vi_s=t_vi, vi_nit=vi.optim_result.nit,
               hyper=hyper)

    def agree(out, name, secs):
        pip = np.concatenate([out['pip'][c] for c in ch])
        eta = np.concatenate([out['post_mean_beta'][c] for c in ch])
        var = np.concatenate([out['post_var_beta'][c] for c in ch])
        if not (np.isfinite(pip).all() and np.isfinite(eta).all()
                and np.isfinite(var).all()):
            fail(f"MC1: {name}'s posterior is not finite")
        top = vi_pip > 0.5
        r = dict(seconds=secs, pip_corr=_corr(vi_pip, pip),
                 eta_corr=_corr(vi_eta, eta),
                 top_agreement=float(np.mean(pip[top] > 0.5))
                 if top.any() else None)
        return r

    g = sampler.GibbsSampler(dsm, n_chains=4, seed=1, **hyper)
    launches = sampler_launches(dsm, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = g.run(**MC1_GIBBS)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    rec['gibbs'] = agree(out, 'Gibbs', t_g)
    rec['gibbs'].update(ms_per_sweep=1e3 * t_g / MC1_GIBBS['n_iter'],
                        launches_per_sweep=launches, **MC1_GIBBS)
    r = rec['gibbs']
    phase('MC1', f"Gibbs (4 chains, {MC1_GIBBS['n_iter']} sweeps, "
                 f"{MC1_GIBBS['burn_in']} burn-in): {t_g:.2f} s, "
                 f"{r['ms_per_sweep']:.2f} ms per sweep, {launches} device "
                 f"launches per sweep; PIP corr {r['pip_corr']:.4f}, eta "
                 f"corr {r['eta_corr']:.4f}, P(PIP > .5 | VI PIP > .5) "
                 f"{r['top_agreement']}")

    pis = np.geomspace(2e-4, 2e-2, 8)
    grid = {'pi': pis, 'tau_beta': pis * dsm.m / 0.25,
            'sigma_epsilon': np.full(8, 0.75)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smc = sampler.smc_over_grid(dsm, grid, seed=2, **MC1_SMC)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    w = smc['weights']
    if not (w.shape == (8,) and np.isfinite(w).all()
            and abs(w.sum() - 1.0) <= 1e-8):
        fail(f"MC1: the SMC weights {w} are not 8 finite weights summing "
             f"to 1")
    n_sweeps = 8 * MC1_SMC['n_stages'] * MC1_SMC['sweeps_per_stage'] + 50
    rec['smc'] = agree(smc['posterior'], 'SMC', t_s)
    rec['smc'].update(weights=w.tolist(), best_hyper=smc['best_hyper'],
                      sweeps=n_sweeps, ms_per_sweep=1e3 * t_s / n_sweeps,
                      **MC1_SMC)
    r = rec['smc']
    phase('MC1', f"SMC (8 particles, {MC1_SMC['n_stages']} stages x "
                 f"{MC1_SMC['sweeps_per_stage']} sweeps, then 50): {t_s:.2f}"
                 f" s ({r['ms_per_sweep']:.2f} ms per 1-chain sweep); best pi "
                 f"{smc['best_hyper']['pi']:.5f} (VI {hyper['pi']:.5f}), "
                 f"weights {np.round(w, 3).tolist()}; PIP corr "
                 f"{r['pip_corr']:.4f}, eta corr {r['eta_corr']:.4f}")

    gmask = {c: (vi.pip[c] > 0.5).astype(np.float64) for c in ch}
    selected = np.concatenate([gmask[c] for c in ch]) > 0
    if not selected.any():
        fail("MC1: VI selected no variant for HMC")
    runs = {}
    for name, seed in (('cold', 3), ('steady', 4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = sampler.hmc_refine(dsm, gmask, seed=seed, **hyper, **MC1_HMC)
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, h)
    t_h, h = runs['steady']
    eta = np.concatenate([h['post_mean_beta'][c] for c in ch])
    var = np.concatenate([h['post_var_beta'][c] for c in ch])
    r_sel = _corr(vi_eta[selected], eta[selected])
    rec['hmc'] = dict(seconds_cold=runs['cold'][0], seconds=t_h,
                      ms_per_step=1e3 * t_h / MC1_HMC['n_samples'],
                      accept=h['accept_rate'],
                      warmup_accept=h['warmup_accept_rate'],
                      step_size=h['step_size'], eta_corr_selected=r_sel,
                      selected=int(selected.sum()),
                      accept_cold=runs['cold'][1]['accept_rate'], **MC1_HMC)
    r = rec['hmc']
    phase('MC1', f"HMC ({int(selected.sum())} variants, 4 chains, "
                 f"{MC1_HMC['n_samples']} samples, L <= "
                 f"{MC1_HMC['n_leapfrog']}): cold {r['seconds_cold']:.2f} s, "
                 f"steady {t_h:.2f} s ({r['ms_per_step']:.2f} ms per step); "
                 f"accept {h['accept_rate']:.4f} (warm-up "
                 f"{h['warmup_accept_rate']:.4f}; cold run "
                 f"{r['accept_cold']:.4f}), step size {h['step_size']:.4g}; "
                 f"eta corr with VI on the selected {r_sel:.4f}")
    if not (np.isfinite(eta).all() and np.isfinite(var).all()
            and np.all(eta[~selected] == 0)):
        fail("MC1: the HMC posterior is not finite, or moved an unselected "
             "variant")
    for name, (_, hr) in runs.items():
        if not 0.2 < hr['accept_rate'] <= 1.0:
            fail(f"MC1: HMC ({name}) accept rate {hr['accept_rate']} is "
                 f"not in (0.2, 1]")
    if not r_sel > 0.5:
        fail(f"MC1: HMC's posterior mean correlates {r_sel:.4f} with VI's "
             f"on the selected variants")
    secs = time.perf_counter() - t_all
    rec['seconds'] = secs
    phase('MC1', f"{secs:.1f} s")
    return rec


# --------------------------------------- multi-process fits (X0-X1)
#: X1's bounds against phase 5's fit: h2 and the final ELBO (relative),
#: PIP (absolute); the grid's BMA h2 against PORT_GRID_BMA_H2 (relative).
X1_REL, X1_PIP, X1_GRID_REL = 1e-7, 1e-5, 1e-6
#: Seconds the two ranks may take together (X0 and X1).
X_TIMEOUT = 420
#: The launch paths X1 adds to each kernel's ``paths``.
X_PATHS = tuple(f'X1 {what} rank {r}' for what in ('VIPRS 2x1',
                                                  'grid(100) 1x2')
                for r in (0, 1))
#: The genome's packed LD fields the ranks read from disk.
X_FIELDS = ('diag', 'off_data', 'off_src', 'off_dst', 'mask', 'off_nz',
            'diag_nz')


def x_cut(ld):
    """X0's 8 blocks of the genome: from 3 blocks before the first coupling
    tile (s, s + 1) with s >= 3, so that tile crosses the boundary of two
    ranks of 4 blocks each."""
    src, dst = ld.off_src.cpu().numpy(), ld.off_dst.cpu().numpy()
    s = next(int(a) for a, b in zip(src, dst)
             if b == a + 1 and 3 <= a and a + 5 <= ld.nb)
    return np.arange(s - 3, s + 5)


def x_prepare(ds, root, ref):
    """Write what the ranks read into ``root``: the genome's packed LD as
    .npy files (each rank maps them and copies only its shard to the card),
    its layout, statistics and LD scores (those phase 5 computed on the
    card, so every fit starts where phase 5's did), and phase 5's PIP."""
    import pickle
    for k in X_FIELDS:
        np.save(os.path.join(root, k + '.npy'),
                getattr(ds.ld, k).cpu().numpy())
    ds.compute_ld_scores()
    with open(os.path.join(root, 'meta.pkl'), 'wb') as f:
        pickle.dump(dict(scale=ds.ld.scale, layout=ds.layout,
                         std_beta=ds.std_beta, n_per_snp=ds.n_per_snp,
                         ld_scores=ds.ld_scores), f)
    np.save(os.path.join(root, 'pip.npy'), ref['pip'])


def x_genome(root):
    """The genome's dataset with its LD on the host, from x_prepare's
    files, memory-mapped (a rank reads the pages of its shard)."""
    import pickle
    import torch
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    from viprs_tpu_torch.ops.block_ld import (BlockLD, coupling_slabs,
                                              incident_tiles)
    a = {k: torch.from_numpy(np.load(os.path.join(root, k + '.npy'),
                                     mmap_mode='c')) for k in X_FIELDS}
    with open(os.path.join(root, 'meta.pkl'), 'rb') as f:
        meta = pickle.load(f)
    src, dst = a['off_src'].numpy(), a['off_dst'].numpy()
    nb = a['diag'].shape[0]
    inc_ptr, inc_tile = incident_tiles(src, dst, nb)
    ld = BlockLD(**a, inc_ptr=torch.from_numpy(inc_ptr),
                 inc_tile=torch.from_numpy(inc_tile),
                 cpl_slabs=torch.from_numpy(coupling_slabs(
                     a['off_nz'].numpy(), src, dst, nb)),
                 scale=meta['scale'])
    return SummaryStatsDataset(ld=ld, layout=meta['layout'],
                               std_beta=meta['std_beta'],
                               n_per_snp=meta['n_per_snp'],
                               ld_scores=meta['ld_scores'])


def x0_sweeps(ds, dev):
    """X0 on this rank: 3 sweeps at fixed hyperparameters on an 8-block cut
    (x_cut) over a 2 x 1 mesh, K1 + halo + coupling_pass_s1 at S = 1 and K3
    + halo + coupling_pass_s at S = 16, against the whole cut's sweeps on
    the same card: the rank's blocks of every field after every sweep must
    be the same bits."""
    import torch
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
    from viprs_tpu_torch.parallel.mesh import make_mesh, shard_ld
    sel = x_cut(ds.ld)
    host = cut_blocks(ds.ld, sel, 'cpu')
    whole = cut_blocks(ds.ld, sel, dev)
    mesh = make_mesh(2, 1)
    sld = shard_ld(mesh, host, dev)
    if sld.halo_rows < 1:
        raise AssertionError("X0: no coupling tile crosses the boundary")
    lo, hi = sld.lo, sld.hi
    lay = ds.layout
    idx = torch.as_tensor(sel)
    sb, nf = (torch.from_numpy(lay.to_flat(d).reshape(lay.nb, -1))[idx]
              .to(dev) for d in (ds.std_beta, ds.n_per_snp))
    out = {'blocks': [int(sel[0]), int(sel[-1])], 'shard': [lo, hi],
           'halo_rows': sld.halo_rows, 'ghosts': sld.view.ghosts.tolist()}
    for S, sweep in ((1, cavi_cuda.cavi_sweep_s1),
                     (16, cavi_cuda.cavi_sweep_s)):
        pis = np.geomspace(0.005, 0.2, S)
        h = Hyper(*(torch.tensor(v, dtype=torch.float32, device=dev)
                    for v in (np.full(S, 0.7), pis * ds.m / 0.3, pis,
                              np.zeros(S))))
        act = torch.ones(S, device=dev)
        shape = (S, len(sel), whole.block_size)
        lg = torch.from_numpy(np.log(pis) - np.log1p(-pis)).float().to(dev)
        z = torch.zeros(shape, device=dev)
        full = CaviState(lg[:, None, None].expand(shape).contiguous(),
                         z, z.clone(), z.clone())
        part = CaviState(*(x[:, lo:hi].contiguous() for x in full))
        same = []
        for _ in range(3):
            full, d_full = sweep(whole, full, sb, nf, h, act)
            part, d_part = sweep(sld.ld, part, sb[lo:hi], nf[lo:hi], h, act,
                                 halo=sld.couple)
            same.append(all(same_bits(a, b[:, lo:hi]) for a, b in
                            zip((*part, d_part), (*full, d_full))))
        torch.cuda.synchronize()
        out[f'S={S}'] = same
        if not all(same):
            raise AssertionError(f"X0: S = {S}, the rank's blocks differ "
                                 f"from the whole cut's sweep: {same}")
    return out


def x1_fits(ds, root, rank, dev):
    """X1 on this rank: VIPRS over '2x1' (the blocks split) and grid(100)
    + BMA over '1x2' (the lanes split), as phase 5 and G3 run them."""
    import torch
    from viprs_tpu_torch.gridsearch import (HyperparameterGrid,
                                            bayesian_model_average)
    from viprs_tpu_torch.model import VIPRS, VIPRSGrid
    from viprs_tpu_torch.ops import cavi_cuda
    from viprs_tpu_torch.parallel.mesh import resolve_mesh
    out = {}
    np.random.seed(0)
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    m = VIPRS(ds, 'cuda', mesh='2x1').fit(
        max_iter=1000, f_abs_tol=1e-6, x_abs_tol=1e-6, patience=10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in cavi_cuda.LAUNCHES.items() if v}
    pip = np.concatenate([m.pip[c] for c in m.chromosomes])
    if rank == 0:
        np.save(os.path.join(root, 'x1_pip.npy'), pip)
    nit = int(m.optim_result.nit)
    out['viprs'] = dict(
        seconds=dt, nit=nit, status=int(m._last_result.status[0]),
        ms_per_it=1e3 * dt / max(nit, 1), h2=float(m.get_heritability()),
        elbo=float(m.history['ELBO'][-1]),
        n_skip=m.fit_counters.skip_iterations,
        launches=launches, ld_bytes=m._ld.nbytes(),
        shard=[m._ld.lo, m._ld.hi], halo_rows=m._ld.halo_rows,
        finite=bool(np.isfinite(pip).all()), m=int(pip.shape[0]))
    del m
    np.random.seed(0)
    grid = HyperparameterGrid(n_snps=ds.m, **GRID_SPEC)
    g = VIPRSGrid(ds, grid, 'cuda', mesh=resolve_mesh('1x2'))
    torch.cuda.synchronize()
    cavi_cuda.reset_launches()
    t0 = time.perf_counter()
    g.fit(max_iter=500)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nit = g._last_result.nit
    rec = dict(seconds=dt, converged=int(g.converged_models.sum()),
               valid=int(g.valid_terminated_models.sum()),
               nit_max=int(nit.max()),
               ms_per_it=1e3 * dt / max(int(nit.max()), 1),
               widths=[c.width for c in g.fit_counters.chunks],
               lanes=list(g._lane_range()),
               launches={k: v for k, v in cavi_cuda.LAUNCHES.items() if v},
               ld_bytes=g._ld.nbytes())
    t0 = time.perf_counter()
    bayesian_model_average(g)
    torch.cuda.synchronize()
    rec.update(bma_s=time.perf_counter() - t0,
               h2=float(g.get_heritability()))
    out['grid'] = rec
    return out


def x_rank(rank, world, port, root, out):
    """One rank of X0-X1 (a process spawned by x_phases): joins the gloo
    group, runs X0 and X1 on its share of the card and writes its record
    as JSON to ``out``. A failure raises (the process exits non-zero)."""
    import torch
    from viprs_tpu_torch.parallel import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f'127.0.0.1:{port}', world, rank)
    dev = torch.device('cuda', torch.cuda.current_device())
    from viprs_tpu_torch.ops import _build
    _build.build()
    ds = x_genome(root)
    rec = {'rank': rank}
    t0 = time.perf_counter()
    rec['x0'] = x0_sweeps(ds, dev)
    rec['x0']['seconds'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec['x1'] = x1_fits(ds, root, rank, dev)
    rec['x1']['seconds'] = time.perf_counter() - t0
    rec['modules'] = [m for m in ('pandas', 'jax', 'viprs_tpu')
                      if m in sys.modules]
    with open(out, 'w') as f:
        json.dump(rec, f)


def x_phases(ds, ref, grid_ref, paths):
    """X0-X1: two ranks spawned on the one card, joined over gloo, run
    x_rank; held here: X0 bit for bit, X1's VIPRS to phase 5's fit (nit
    and status through guarded_stops, h2 and the final ELBO within X1_REL,
    PIP within X1_PIP), its grid's BMA h2 to PORT_GRID_BMA_H2 within
    X1_GRID_REL with every point converged, each rank's LD bytes on the
    card and its launches (added to ``paths``)."""
    import shutil
    import socket
    import tempfile
    import torch.multiprocessing as mp
    t_all = time.perf_counter()
    root = tempfile.mkdtemp(prefix='viprs_x_')
    try:
        x_prepare(ds, root, ref)
        t_prep = time.perf_counter() - t_all
        with socket.socket() as sk:
            sk.bind(('127.0.0.1', 0))
            port = sk.getsockname()[1]
        outs = [os.path.join(root, f'rank{r}.json') for r in (0, 1)]
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=x_rank, args=(r, 2, port, root, outs[r]))
                 for r in (0, 1)]
        for p in procs:
            p.start()
        deadline = time.time() + X_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            fail(f"X0-X1: the ranks exited with {[p.exitcode for p in procs]}"
                 f"{' (killed at the time limit)' if hung else ''}")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
        pip = np.load(os.path.join(root, 'x1_pip.npy'))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter() - t_all
    rec = {'seconds': t_all, 'prepare_s': t_prep, 'ranks': ranks}
    for r in ranks:
        if r['modules']:
            fail(f"X0-X1: rank {r['rank']} imported {r['modules']}")
    x0 = ranks[0]['x0']
    phase('X0', f"blocks {x0['blocks'][0]}-{x0['blocks'][1]} of the genome "
                f"over 2 ranks ({[r['x0']['shard'] for r in ranks]}; ghost "
                f"blocks {[r['x0']['ghosts'] for r in ranks]}): 3 sweeps, "
                f"each rank's blocks bit for bit the whole cut's at S = 1 "
                f"(K1 + halo + coupling_pass_s1) and S = 16 (K3 + halo + "
                f"coupling_pass_s); "
                f"{max(r['x0']['seconds'] for r in ranks):.1f} s")

    v = [r['x1']['viprs'] for r in ranks]
    for key in ('nit', 'status', 'h2', 'elbo'):
        if v[0][key] != v[1][key]:
            fail(f"X1: the ranks' VIPRS fits differ in {key}: "
                 f"{v[0][key]} vs {v[1][key]}")
    rel_h2 = abs(v[0]['h2'] - ref['h2']) / abs(ref['h2'])
    rel_elbo = abs(v[0]['elbo'] - ref['elbo']) / abs(ref['elbo'])
    d_pip = float(np.abs(pip - ref['pip']).max())
    gb = [x['ld_bytes'] / 1e9 for x in v]
    phase('X1', f"VIPRS over '2x1': nit {v[0]['nit']} (phase 5: "
                f"{ref['nit']}), h2 {v[0]['h2']!r} (phase 5: {ref['h2']!r}; "
                f"relative {rel_h2:.2e}, bound {X1_REL:g}), final ELBO "
                f"relative {rel_elbo:.2e}, max |dPIP| {d_pip:.2e} (bound "
                f"{X1_PIP:g}); {v[0]['seconds']:.3f} s, "
                f"{v[0]['ms_per_it']:.2f} ms/it (phase 5: cold "
                f"{ref['cold_s']:.3f} s, warm median {ref['warm_s']:.3f} s, "
                f"{1e3 * ref['warm_s'] / max(ref['nit'], 1):.2f} ms/it); LD "
                f"on each rank's card {gb[0]:.3f} + {gb[1]:.3f} GB (the whole "
                f"{ref['ld_gb']:.3f} GB); launches per rank "
                f"{[x['launches'] for x in v]}")
    stops = guarded_stops(
        'X1', "VIPRS over '2x1' (\"the CPU\" here) against phase 5's fit "
              "on the card",
        lambda dev, f, x: [x1_stop(ds, f, x)], card=[(ref['nit'],
                                                      ref['status'])],
        cpu=[(v[0]['nit'], v[0]['status'])], devices=('cuda',))
    if not (v[0]['finite'] and v[0]['m'] == ds.m):
        fail("X1: the sharded fit's PIP is not finite of shape (M,)")
    if rel_h2 > X1_REL or rel_elbo > X1_REL or d_pip > X1_PIP:
        fail(f"X1: the VIPRS fit over 2 ranks moved from phase 5's: h2 "
             f"{rel_h2:.2e}, ELBO {rel_elbo:.2e}, PIP {d_pip:.2e}")
    if not all(x['ld_bytes'] < 0.6 * ref['ld_gb'] * 1e9 for x in v):
        fail(f"X1: a rank's card holds more than its shard of the LD: {gb}")

    gr = [r['x1']['grid'] for r in ranks]
    for key in ('h2', 'converged', 'widths', 'nit_max'):
        if gr[0][key] != gr[1][key]:
            fail(f"X1: the ranks' grids differ in {key}: {gr[0][key]} vs "
                 f"{gr[1][key]}")
    rel_g = abs(gr[0]['h2'] - PORT_GRID_BMA_H2) / PORT_GRID_BMA_H2
    phase('X1', f"grid(100) + BMA over '1x2' (lanes {[x['lanes'] for x in gr]}"
                f"): converged {gr[0]['converged']}/100, nit max "
                f"{gr[0]['nit_max']}, widths per chunk {_runs(gr[0]['widths'])}"
                f", BMA h2 {gr[0]['h2']!r} (PORT_GRID_BMA_H2 "
                f"{PORT_GRID_BMA_H2!r}; relative {rel_g:.2e}, bound "
                f"{X1_GRID_REL:g}); fit {gr[0]['seconds']:.3f} s, "
                f"{gr[0]['ms_per_it']:.2f} ms/it at nit max, BMA "
                f"{gr[0]['bma_s']:.3f} s (G3 cold: fit "
                f"{grid_ref['fit_s']:.3f} s, {grid_ref['ms_per_it']:.2f} "
                f"ms/it); LD on each card "
                f"{gr[0]['ld_bytes'] / 1e9:.3f} GB; launches per rank "
                f"{[x['launches'] for x in gr]}")
    if gr[0]['converged'] != 100 or rel_g > X1_GRID_REL:
        fail(f"X1: the grid over 2 ranks: converged {gr[0]['converged']}/100,"
             f" BMA h2 relative {rel_g:.2e}")
    for r in ranks:
        for what, x in (('VIPRS 2x1', r['x1']['viprs']),
                        ('grid(100) 1x2', r['x1']['grid'])):
            paths[f"X1 {what} rank {r['rank']}"] = x['launches']
    if min(v[0]['launches'].get(k, 0) for k in ('cavi_block_sweep_s1',
                                                 'coupling_pass_s1')) < 1 or \
            min(gr[0]['launches'].get(k, 0) for k in ('cavi_block_sweep_s',
                                                       'coupling_pass_s')) < 1:
        fail(f"X1: a kernel of the sharded paths was never launched: "
             f"{v[0]['launches']}, {gr[0]['launches']}")
    phase('X0-X1', f"{t_all:.1f} s (writing the genome for the ranks "
                   f"{t_prep:.1f} s)")
    rec['stops'] = stops
    return rec


def x1_stop(ds, f_abs_tol, x_abs_tol):
    """(nit, status) of phase 5's fit on the card at other tolerances (for
    guarded_stops)."""
    from viprs_tpu_torch.model import VIPRS
    np.random.seed(0)
    m = VIPRS(ds, 'cuda').fit(max_iter=1000, f_abs_tol=f_abs_tol,
                              x_abs_tol=x_abs_tol, patience=10)
    return (int(m.optim_result.nit), int(m._last_result.status[0]))



if __name__ == '__main__':
    main()
