"""The control of the judge: the program with its plain sweeps in the
kernels' place, computed in TF32, judged by the same judge, which has to
find it not correct.

Both configurations compute in float32 (the int8 one stores its tiles in
int8 and takes them to float32 for the products), so the control is the
step a tensor-core redesign of the lane kernels would take: the LD
products in TF32. ``plain_tf32`` routes the port's sweep wrappers
(``ops/cavi_cuda.py``) to the port's plain PyTorch sweeps
(``ops/cavi_torch.py``, ``ops/cavi_mix.py``), which the port runs on the
CPU, and rounds every float32 operand of ``torch.einsum`` to TF32 (a
10-bit mantissa, round to nearest; the products of two such operands are
exact in float32, so the float32 sums then give what a TF32 tensor core
gives). Everything else is the program: its chunk drivers, convergence
ladder, compaction and M-steps.

    python -m portbench.control --workload <cell> --traits 0,1,2 \\
        [--program 1] [--control 1] [--tf32 1] [--out readings.json]

For each trait of the cell's pool (the traffic fixes the pool, so a run's
seed only orders it and the judged answer is one of these fits) it fits the
trait with the program (``--program 1``: the sound readings) and with the
control (``--control 1``; ``--tf32 0``: the plain sweeps in float32), and
prints both judges' numbers, with each lane's.
"""

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from . import reference

F32 = torch.float32


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def tf32_round(x):
    """float32 -> the nearest TF32 value (10-bit mantissa), as float32."""
    xi = x.contiguous().view(torch.int32)
    return ((xi + 0x1000) & ~0x1FFF).view(F32)


@contextlib.contextmanager
def plain_tf32(tf32=True):
    """The port's plain sweeps in place of its kernels, every float32
    ``torch.einsum`` operand rounded to TF32 (``tf32=False``: left as it
    is), for the duration of the block."""
    from viprs_tpu_torch.ops import cavi_cuda, cavi_mix, cavi_torch

    def block_sweep(ld, state, std_beta, n_per_snp, hyper, active, blk_mask,
                    inner_steps=cavi_torch.INNER_STEPS):
        return cavi_torch.block_sweep(ld, state, std_beta, n_per_snp, hyper,
                                      active, blk_mask=blk_mask)

    def block_sweep_mix(ld, state, std_beta, n_per_snp, hyper, active,
                        blk_mask, unit_diag, count,
                        inner_steps=cavi_torch.INNER_STEPS):
        return cavi_mix.mix_block_sweep(ld, state, std_beta, n_per_snp,
                                        hyper, active, blk_mask=blk_mask,
                                        unit_diag=unit_diag)

    def coupling(ld, q, eta_diff, blk_mask):
        if ld.n_off == 0:
            return q
        return cavi_torch.coupling_pass(ld, q, eta_diff, blk_mask)

    einsum = torch.einsum

    def einsum_tf32(eq, *ops):
        return einsum(eq, *(tf32_round(x) if x.dtype == F32 else x
                            for x in ops))

    patches = {'block_sweep_s': block_sweep, 'block_sweep_s1': block_sweep,
               'block_sweep_mix': block_sweep_mix,
               'coupling_pass_s_inplace': coupling,
               'coupling_pass_s1_inplace': coupling}
    saved = {k: getattr(cavi_cuda, k) for k in patches}
    try:
        for k, f in patches.items():
            setattr(cavi_cuda, k, f)
        if tf32:
            torch.einsum = einsum_tf32
        yield
    finally:
        torch.einsum = einsum
        for k, f in saved.items():
            setattr(cavi_cuda, k, f)


def readings(bench, workload, traits, program=True, control=True,
             device=None, tf32=True, out_path=None):
    """Per trait of the cell's pool (indices), the judge's numbers of the
    program's and the control's fit of it."""
    from .panel import make_panel
    from .run import _dataset, _no_span, _pool
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    cell = bench.cell(workload)
    _, cfg = bench.config(cell['config'])
    traffic = bench.traffic(cell['traffic'])
    dev = torch.device(device or ('cuda' if torch.cuda.is_available()
                                  else 'cpu'))
    panel = make_panel(cfg)
    ref_ld = reference.RefLD(panel, bool(cfg['quantize']), dev)
    pool, thetas, _ = _pool(panel, traffic, 0)
    entry = bench.entry(traffic['entry'])(traffic, panel.m, dev)
    ds0 = None
    out_all = []
    sides = [s for s, on in (('program', program), ('control', control))
             if on]
    for k in traits:
        trait = pool[k]
        beta = np.concatenate([trait[0][c] for c in sorted(trait[0])])
        n = np.concatenate([trait[1][c] for c in sorted(trait[1])])
        if ds0 is None:
            ds0 = SummaryStatsDataset.from_dense_blocks(
                panel.blocks, *trait, block_size=int(cfg['block_size']),
                quantize=bool(cfg['quantize']), device=dev)
        rec = {'trait': int(k)}
        for side in sides:
            ctx = entry.control() if side == 'control' and tf32 else \
                plain_tf32(False) if side == 'control' else \
                contextlib.nullcontext()
            np.random.seed(thetas[k])
            t0 = time.perf_counter()
            with ctx:
                fit, handle = entry.run(_dataset(ds0, trait), _no_span)
            rec[side + '_s'] = time.perf_counter() - t0
            rec[side + '_status'] = [r.message[:24] for r in
                                     handle[0].optim_results]
            rec[side + '_nit'] = fit.nit.tolist()
            out = entry.answers(handle)
            del handle
            lanes = {}
            rec[side] = entry.judge(ref_ld, out, beta, n, lanes)
            rec[side + '_lanes'] = lanes
            log(json.dumps({'trait': int(k), 'side': side,
                            'seconds': rec[side + '_s'],
                            'nit_max': int(fit.nit.max()),
                            'numbers': rec[side]}))
        out_all.append(rec)
        if out_path:
            with open(out_path, 'w') as f:
                json.dump({'workload': workload, 'tf32': tf32,
                           'readings': out_all}, f)
    return out_all


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--traits', required=True)
    ap.add_argument('--program', type=int, default=1)
    ap.add_argument('--control', type=int, default=1)
    ap.add_argument('--tf32', type=int, default=1)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    from .run import Bench
    readings(Bench(), args.workload, [int(k) for k in args.traits.split(',')],
             bool(args.program), bool(args.control), tf32=bool(args.tf32),
             out_path=args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
