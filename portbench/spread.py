"""Run a cell several times, one process after another, and report the
spread of each metric: the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python -m portbench.spread --workload <cell> --seeds 11,12,13 \
        --seconds 51 [--trace 0] [--sets 2] [--out runs.json]

Each run is ``python -m portbench.run`` on this machine with the next seed;
with ``--sets 2`` the seeds are run twice over, set after set, and the
spread is given per set. Every run's result line, its exit code and the
end of its standard error go to ``--out``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def run_once(workload, seed, seconds, trace):
    cmd = [sys.executable, '-m', 'portbench.run', '--workload', workload,
           '--seed', str(seed), '--seconds', str(seconds),
           '--trace', str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    result = None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {'seed': seed, 'rc': proc.returncode, 'wall_s': wall,
            'result': result, 'stderr_tail': proc.stderr[-6000:]}


def summarize(runs):
    names = sorted({k for r in runs if r['result']
                    for k in r['result']['metrics']})
    out = {}
    for k in names:
        vals = [r['result']['metrics'][k]['value'] for r in runs
                if r['result'] and k in r['result']['metrics']]
        out[k] = {'median': statistics.median(vals), 'spread': spread(vals),
                  'values': vals}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, default=0)
    ap.add_argument('--sets', type=int, default=1)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',')]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = run_once(args.workload, seed, args.seconds, args.trace)
            res = r['result']
            print(json.dumps({'set': k, 'seed': seed, 'rc': r['rc'],
                              'wall_s': round(r['wall_s'], 1),
                              'correct': res and res['correct'],
                              'metrics': res and {
                                  n: m['value']
                                  for n, m in res['metrics'].items()},
                              'checks': res and {
                                  n: c['value']
                                  for n, c in res['checks'].items()}}),
                  flush=True)
            if r['rc'] != 0:
                print(r['stderr_tail'][-3000:], flush=True)
            runs.append(r)
        sets.append(runs)
        print(json.dumps({'set': k, 'summary': summarize(runs)}), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'workload': args.workload, 'seconds': args.seconds,
                       'trace': args.trace, 'sets': sets}, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
