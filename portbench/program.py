"""What the program records about its own work: the tracer of the port
(``viprs_tpu_torch.utils.trace``), read once the window has closed. The
tracer records only while a ``torch.profiler`` session does, so in a
``--trace 1`` run its records are the window's. A program without that
tracer has nothing to read (None), and a metric that reads it is left out
of the result line."""

import numpy as np


def records():
    """The tracer's records, or None where the program has no tracer or
    the tracer recorded nothing."""
    try:
        from viprs_tpu_torch.utils import trace
    except ImportError:
        return None
    r = trace.records()
    return r if r.spans or r.counters else None


def em_iterations(recs):
    """Milliseconds of each closed ``viprs.em.iter`` span, and of the same
    span less its ``viprs.em.read`` child (the host's own time, during
    which the device has nothing queued), as two arrays."""
    spans = recs.spans
    read = {}
    for s in spans:
        if s.name == 'viprs.em.read' and s.end_ns >= 0 and s.parent >= 0:
            read[s.parent] = read.get(s.parent, 0) + s.end_ns - s.start_ns
    whole, host = [], []
    for i, s in enumerate(spans):
        if s.name == 'viprs.em.iter' and s.end_ns >= 0:
            ns = s.end_ns - s.start_ns
            whole.append(ns)
            host.append(ns - read.get(i, 0))
    return np.array(whole, np.float64) / 1e6, np.array(host, np.float64) / 1e6
