"""Milliseconds of host work an EM iteration, mean over the window's
iterations: each ``viprs.em.iter`` span of the program's tracer less its
``viprs.em.read`` child (the statistics' enqueue and the one device-to-host
read). The rest (the hyperparameter upload, the masks and sweep launches,
the float64 M-step, objectives and convergence checks) is time in which
the device has nothing queued."""

KIND = 'per_layer'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'program_span'
LAYER = 'host EM loops (ops/em_loop.py, ops/mix_em_loop.py)'
MOVES = 'fit_s'


def value(recs):
    if recs is None:
        return None
    from portbench.program import em_iterations
    _, host = em_iterations(recs)
    if not len(host):
        return None
    return float(host.mean())


def read(run):
    from portbench.program import records
    return value(records())
