"""The whole fit's share of the card's peak: the least time of the E-step
work these inputs need (as ``estep_roofline_pct`` counts it, each pass at
the larger of its bytes over the peak bandwidth and its operations over
the peak FP32 rate) over the traced window. It bounds
``estep_roofline_pct`` from below whatever kernels do the work, so a
change that moves work off the lane kernels still shows here."""

KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = 'device'
MOVES = 'lane_updates_per_s'


def read(run):
    tl = run.timeline
    peak = run.device_peaks()
    if tl is None or peak is None or not run.fits or tl.window_s <= 0:
        return None
    from portbench import work
    counts = run.counts()
    pin, pout = run.planes
    need = sum(work.estep_bound_s(counts, f.nit, pin, pout, peak)
               for f in run.fits)
    return 100.0 * need / tl.window_s
