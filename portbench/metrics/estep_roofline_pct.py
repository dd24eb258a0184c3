"""The lane kernels' share of their roofline: the least time of the E-step
work these inputs need (every iteration's block sweep and coupling pass
over the lanes still live, counted on the benchmark's own tiling of its
panel, ``work.py``), over the device time of the kernels whose names match
a pattern of this metric's folder (``estep_roofline_pct/*.txt``, one
regular expression a line). Peaks from ``peaks.json`` for the card's kind;
a card not in the table has no reading."""

KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = 'lane kernels (csrc/ via ops/cavi_cuda.py)'
MOVES = 'lane_updates_per_s'


def read(run):
    tl = run.timeline
    peak = run.device_peaks()
    if tl is None or peak is None or not run.fits:
        return None
    pats = run.lane_kernel_patterns()
    t = sum(s for name, s in tl.kernels.items()
            if any(p.search(name) for p in pats))
    if t <= 0:
        return None
    from portbench import work
    counts = run.counts()
    pin, pout = run.planes
    need = sum(work.estep_bound_s(counts, f.nit, pin, pout, peak)
               for f in run.fits)
    return 100.0 * need / t
