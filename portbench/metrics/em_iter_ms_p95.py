"""The 95th percentile of the milliseconds of an EM iteration (the
``viprs.em.iter`` spans of the program's tracer) over the window's
iterations: thousands of samples, host and device together."""

KIND = 'per_layer'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'program_span'
LAYER = 'host EM loops (ops/em_loop.py, ops/mix_em_loop.py) and device'
MOVES = 'fit_s'


def value(recs):
    if recs is None:
        return None
    import numpy as np
    from portbench.program import em_iterations
    whole, _ = em_iterations(recs)
    if not len(whole):
        return None
    return float(np.percentile(whole, 95))


def read(run):
    from portbench.program import records
    return value(records())
