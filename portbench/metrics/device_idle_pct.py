"""The share of the traced window in which no kernel, copy or set ran on
the card."""

KIND = 'per_layer'
UNIT = '%'
BETTER = 'lower'
SOURCE = 'device_trace'
LAYER = 'host EM loops (ops/em_loop.py, ops/mix_em_loop.py) and device'
MOVES = 'lane_updates_per_s'


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
