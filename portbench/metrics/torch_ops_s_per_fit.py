"""Device seconds a fit of every kernel that no lane-kernel pattern matches
(``estep_roofline_pct/*.txt``): the plain-torch statistics, M-step inputs,
proposal masks and compaction copies."""

KIND = 'per_layer'
UNIT = 's'
BETTER = 'lower'
SOURCE = 'device_trace'
LAYER = 'plain statistics (ops/updates.py, ops/cavi_mix.py)'
MOVES = 'lane_updates_per_s'


def read(run):
    tl = run.timeline
    if tl is None or not run.fits or not tl.kernels:
        return None
    pats = run.lane_kernel_patterns()
    other = sum(s for name, s in tl.kernels.items()
                if not any(p.search(name) for p in pats))
    return other / len(run.fits)
