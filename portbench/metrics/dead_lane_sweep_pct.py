"""The share of the lane-sweeps of the window's fits spent on lanes that
had stopped: 100 x (1 - live / all), summed over the fits' counters in the
program's tracer (``lane_sweeps``: each chunk's width every iteration;
``live_lane_sweeps``: the lanes still running and not padding). Compaction
runs only between chunks, so a lane swept after it stopped is this
waste."""

KIND = 'per_layer'
UNIT = '%'
BETTER = 'lower'
SOURCE = 'program_counter'
LAYER = 'chunk drivers (model/grid.py, model/mix_grid.py)'
MOVES = 'lane_updates_per_s'


def value(recs):
    if recs is None:
        return None
    sweeps = sum(c.get('lane_sweeps', 0) for c in recs.counters.values())
    live = sum(c.get('live_lane_sweeps', 0) for c in recs.counters.values())
    if sweeps <= 0:
        return None
    return 100.0 * (1.0 - live / sweeps)


def read(run):
    from portbench.program import records
    return value(records())
