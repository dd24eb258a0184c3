"""The metrics that read the program's own tracer (``program.py``):
``dead_lane_sweep_pct``, ``em_host_ms_per_iter`` and ``em_iter_ms_p95``, on
synthetic tracer records, with nothing to read, and in a traced run of a
tiny cell on the CPU."""

import numpy as np
import pytest

from portbench import program
from portbench.run import Bench, run_cell

from viprs_tpu_torch.utils import trace

NEW = ('dead_lane_sweep_pct', 'em_host_ms_per_iter', 'em_iter_ms_p95')


@pytest.fixture
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.reset()


def _records(iter_ms, read_ms, counters):
    """Records of one fit: a chunk holding an iteration span per entry of
    ``iter_ms``, each with a read child of ``read_ms``."""
    S = trace.Span
    spans = [S('viprs.fit', 0, 10 ** 12, -1, 1),
             S('viprs.chunk', 0, 10 ** 12, 0, 1)]
    t = 0
    for it, rd in zip(iter_ms, read_ms):
        i = len(spans)
        d, r = int(it * 1e6), int(rd * 1e6)
        spans += [S('viprs.em.iter', t, t + d, 1, 1),
                  S('viprs.em.estep', t, t + 10, i, 1),
                  S('viprs.em.read', t + 10, t + 10 + r, i, 1),
                  S('viprs.em.mstep', t + 10 + r, t + d, i, 1)]
        t += d
    spans.append(S('viprs.bma', t, t + 5, -1, 0))
    return trace.Records(spans, counters, 0)


def test_the_readers_on_synthetic_records():
    bench = Bench()
    iters = np.arange(1, 101, dtype=np.float64)     # 1 .. 100 ms
    reads = 0.25 * iters
    recs = _records(iters, reads,
                    {1: {'lane_sweeps': 1000, 'live_lane_sweeps': 600},
                     2: {'lane_sweeps': 1000, 'live_lane_sweeps': 200}})
    dead = bench.metric('dead_lane_sweep_pct').value(recs)
    host = bench.metric('em_host_ms_per_iter').value(recs)
    p95 = bench.metric('em_iter_ms_p95').value(recs)
    assert dead == pytest.approx(60.0)
    assert host == pytest.approx(0.75 * iters.mean(), rel=1e-6)
    assert p95 == pytest.approx(np.percentile(iters, 95), rel=1e-6)
    # an open span is not read
    spans = list(recs.spans)
    spans[2] = spans[2]._replace(end_ns=-1)
    opened = recs._replace(spans=spans)
    assert bench.metric('em_iter_ms_p95').value(opened) == pytest.approx(
        np.percentile(iters[1:], 95), rel=1e-6)


def test_the_readers_return_none_with_nothing_to_read(fresh_tracer):
    bench = Bench()
    empty = trace.Records([], {}, 0)
    no_iter = _records([], [], {})
    assert program.records() is None
    for name in NEW:
        mod = bench.metric(name)
        assert mod.value(None) is None
        assert mod.value(empty) is None
        assert mod.value(no_iter) is None
        assert mod.read(None) is None


def test_a_traced_tiny_run_reads_them(tiny_bench, fresh_tracer):
    res, lines = run_cell(tiny_bench, 'tiny8.tmix', 4, 1.0, True,
                          device='cpu')
    assert res['correct'], lines
    m = res['metrics']
    assert set(NEW) <= set(m), sorted(m)
    assert 0.0 <= m['dead_lane_sweep_pct']['value'] < 100.0
    assert 0.0 < m['em_host_ms_per_iter']['value'] <= \
        m['em_iter_ms_p95']['value'] * 10
