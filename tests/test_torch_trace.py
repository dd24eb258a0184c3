"""The port's tracer (viprs_tpu_torch/utils/trace.py) on the CPU: off, a fit
records nothing, never enters ``record_function`` and reads no clock of
the tracer's; under ``torch.profiler`` the spans nest as documented, share
their fit's id and reach the exported Chrome trace as ``user_annotation``
events in the same parent order; ``enable()`` records without a profiler.
The counters' values are held against the JAX package's chunk widths and
the lanes' iterations in tests/test_torch_grid.py and test_torch_mix.py.
"""

import json
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.data.simulate import simulate_sumstats_blocks
from viprs_tpu_torch.gridsearch import (HyperparameterGrid,
                                        bayesian_model_average)
from viprs_tpu_torch.model import VIPRSGrid, VIPRSMixGrid
from viprs_tpu_torch.utils import trace

#: span -> the spans it may run inside (None: at the top)
PARENTS = {'viprs.pack': {None}, 'viprs.fit': {None}, 'viprs.bma': {None},
           'viprs.chunk': {'viprs.fit'}, 'viprs.compact': {'viprs.fit'},
           'viprs.em.iter': {'viprs.chunk'},
           'viprs.em.estep': {'viprs.em.iter'},
           'viprs.em.read': {'viprs.em.iter'},
           'viprs.em.mstep': {'viprs.em.iter'},
           'viprs.em.objective': {'viprs.chunk', 'viprs.em.mstep'}}


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _sim():
    return simulate_sumstats_blocks(n=3000, block_sizes=(250, 200), h2=0.4,
                                    prop_causal=0.04, seed=7)


def _pack(sim):
    return SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], sim['std_beta'], sim['n_per_snp'], block_size=128,
        quantize=True, device='cpu')


def _fits(ds):
    """A 16-lane grid in chunks of 2 (its lanes compacted to 1) and its
    model average, then a 10-lane mixture grid in chunks of 4."""
    np.random.seed(9)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=16), 'cpu')
    g.fit(max_iter=150, chunk_iters=2)
    bayesian_model_average(g)
    np.random.seed(5)
    mg = VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=10),
                      'cpu', K=1)
    mg.fit(max_iter=60, chunk_iters=4)
    return g, mg


def test_off_a_fit_records_nothing(monkeypatch):
    """With no profiler session and no ``enable()``, packing, fits and the
    model average enter no ``record_function``, read no clock of the
    tracer's and record no span or counter; a span site gets the one
    shared null object. The models keep their counters all the same."""
    def refuse(*a, **kw):
        raise AssertionError("the tracer touched the profiler while off")

    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("the tracer read its clock while off")

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(trace, 'time', NoClock())
    ds = _pack(_sim())
    g, mg = _fits(ds)
    r = trace.records()
    assert r.spans == [] and r.counters == {} and r.dropped == 0
    assert trace.span('viprs.em.read') is trace.steps('viprs.em.iter')
    for m in (g, mg):
        assert m.fit_counters.chunks and m.fit_counters.lane_sweeps > 0


def _chrome_nesting(events):
    """(name, parent name) of the ``viprs.*`` user annotations in start
    order, the parent being the latest earlier annotation that covers it."""
    evs = sorted(((float(e['ts']), float(e['ts']) + float(e['dur']),
                   e['name']) for e in events
                  if e.get('cat') == 'user_annotation'
                  and e.get('ph') == 'X'
                  and e['name'].startswith('viprs.')),
                 key=lambda e: (e[0], -e[1]))
    out, stack = [], []
    for a, b, name in evs:
        while stack and stack[-1][1] < b:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def test_under_the_profiler_spans_nest_share_fit_ids_and_reach_the_trace(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile
    sim = _sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ds = _pack(sim)
        g, mg = _fits(ds)
    r = trace.records()
    spans = r.spans
    names = Counter(s.name for s in spans)
    assert set(names) == set(PARENTS), names
    assert names['viprs.fit'] == 2 and names['viprs.pack'] == 1
    assert names['viprs.compact'] >= 2       # a gather and a scatter back
    parent = [None if s.parent < 0 else spans[s.parent].name for s in spans]
    for s, p in zip(spans, parent):
        assert p in PARENTS[s.name], (s.name, p)
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
            assert s.fit == up.fit
    # each iteration: the E-step, the read, the M-step, in that order
    kids = defaultdict(list)
    for s in spans:
        if s.parent >= 0 and spans[s.parent].name == 'viprs.em.iter':
            kids[s.parent].append(s.name)
    assert len(kids) == names['viprs.em.iter']
    assert all(k == ['viprs.em.estep', 'viprs.em.read', 'viprs.em.mstep']
               for k in kids.values())
    fits = [s.fit for s in spans if s.name == 'viprs.fit']
    assert 0 not in fits and len(set(fits)) == 2
    assert {s.fit for s in spans if s.name in ('viprs.pack', 'viprs.bma')} \
        == {0}
    # the fits' counters, under their ids
    assert r.counters == {fits[0]: g.fit_counters.totals(),
                          fits[1]: mg.fit_counters.totals()}
    assert names['viprs.em.iter'] == sum(
        c.iterations for m in (g, mg) for c in m.fit_counters.chunks)
    # the same spans in the profiler's trace, in the same parent order
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert _chrome_nesting(events) == list(zip((s.name for s in spans),
                                               parent))
    # the profiler session has ended: the tracer is off again
    np.random.seed(9)
    VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=4),
              'cpu').fit(max_iter=5)
    assert len(trace.records().spans) == len(spans)


def test_enable_records_without_a_profiler(monkeypatch):
    """After ``enable()`` the tracer records with no profiler session, and
    enters no ``record_function``; ``disable()`` and ``reset()`` undo it."""
    def refuse(*a, **kw):
        raise AssertionError("no profiler session records")

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    ds = _pack(_sim())
    trace.enable()
    np.random.seed(9)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=4), 'cpu')
    g.fit(max_iter=20)
    r = trace.records()
    assert Counter(s.name for s in r.spans)['viprs.fit'] == 1
    assert list(r.counters.values()) == [g.fit_counters.totals()]
    trace.disable()
    trace.reset()
    g.fit(max_iter=20)
    assert trace.records() == trace.Records([], {}, 0)
