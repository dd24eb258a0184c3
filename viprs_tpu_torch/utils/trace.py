"""The port's one tracer: spans, per-fit counters and stage totals.

**Spans.** ``with trace.span('viprs.em.iter'):`` records the span's name,
its start and end (``time.perf_counter_ns()``), the index of the span it
runs inside and the id of the fit it belongs to, in a list in memory of at
most ``MAX_SPANS`` spans (later ones are counted in ``dropped``). While a
``torch.profiler`` session records, a span also enters
``torch.profiler.record_function(name)``, so the same interval is in the
profiler's trace (a ``user_annotation`` event) on the clock of the
device's kernels.

**When it records.** At the start of each fit, model average and packing
(the port's entries, ``entry``: the spans ``viprs.fit``, ``viprs.bma`` and
``viprs.pack`` below) the tracer checks once whether a ``torch.profiler``
session records; it records until that entry returns. After ``enable()``
it always records (``disable()`` undoes it). Otherwise it is off, and a
span site costs one test of a module-level bool and returns a shared null
context: no clock read, no allocation, no ``record_function``.

**The spans of the port.**

| span | where | what |
|---|---|---|
| ``viprs.fit`` | ``fit()`` of VIPRS, VIPRSGrid, VIPRSMix, VIPRSMixGrid | one fit; assigns the fit's id |
| ``viprs.chunk`` | model/viprs.py, model/grid.py, model/mix.py, model/mix_grid.py | one EM loop call (``em_fit``, ``mix_em_fit``, ``mix_em_fit_batch``) |
| ``viprs.compact`` | model/viprs.py, model/mix_grid.py | the gather into a compacted lane width, and the scatter back (model/viprs.py: the live lanes' rows moved to the front of the state, their results written back, and the state put back in lane order at a chunk's end) |
| ``viprs.em.iter`` | ops/em_loop.py, ops/mix_em_loop.py | one EM iteration, with the three children below |
| ``viprs.em.estep`` | the same | the hyperparameter upload, the block masks and the sweep launches |
| ``viprs.em.read`` | the same | enqueueing the statistics and their one device-to-host read (on a mesh, the reduction over the ranks): the host's wait on the device |
| ``viprs.em.mstep`` | the same | the host float64 M-step, objectives, counters, convergence checks and the restart |
| ``viprs.em.objective`` | the same | an extra objective pass (at a loop call's start, on a restart) |
| ``viprs.bma`` | gridsearch/search.py | ``bayesian_model_average`` |
| ``viprs.pack`` | data/dataset.py | ``SummaryStatsDataset.from_dense_blocks``: packing and upload |

On a mesh each rank records its own spans; the ranks run the same fits,
so a fit has the same id on every rank. Tracing adds no collective. The
tracer keeps one stack of open spans: it records the thread that runs
the fits.

**Counters.** Named integers per fit (``count``). A fit's chunk driver
keeps a ``FitCounters`` record on the model whether the tracer records or
not (``model.fit_counters``); while it records, the record's totals also
go to the tracer under the fit's id when the fit returns.

**Reading.** ``records()`` returns the spans and the per-fit counters kept
since ``reset()`` (call it between fits).

**Stage totals.** ``StageClock``: seconds per named stage of the data path
(``GWADataLoader.timings``, ``GenotypeMatrix.timings``).
"""

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, NamedTuple

import torch

#: The most spans kept between two ``reset()`` calls.
MAX_SPANS = 1 << 20

_on = False            # span sites test this, and only this
_profiling = False     # a profiler session records: spans enter it too
_enabled = False       # enable()


class Span(NamedTuple):
    name: str
    start_ns: int          # time.perf_counter_ns()
    end_ns: int            # -1 while the span is open
    parent: int            # index in ``records().spans``; -1: none
    fit: int               # the fit's id; 0: outside any fit


class Records(NamedTuple):
    spans: List[Span]
    counters: Dict[int, Dict[str, int]]    # {fit id: {name: value}}
    dropped: int                           # spans past MAX_SPANS


class _Tracer:
    def __init__(self):
        self.spans = []        # [name, start, end, parent, fit] lists
        self.stack = []        # indices of the open spans (-1: dropped)
        self.counters = {}
        self.dropped = 0
        self.fit = 0
        self.last_fit = 0


_T = _Tracer()


def _decide():
    """At an entry of the port with no span open: record while a profiler
    session records, or after ``enable()``."""
    global _on, _profiling
    _profiling = bool(torch._C._autograd._profiler_enabled())
    _on = _enabled or _profiling


class _Span:
    __slots__ = ('name', 'new_fit', 'rec', 'rf', 'prev_fit')

    def __init__(self, name, new_fit=False):
        self.name, self.new_fit = name, new_fit

    def __enter__(self):
        t = _T
        if self.new_fit:
            t.last_fit += 1
            self.prev_fit, t.fit = t.fit, t.last_fit
        self.rf = None
        if _profiling:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = t.stack[-1] if t.stack else -1
        if len(t.spans) < MAX_SPANS:
            self.rec = [self.name, time.perf_counter_ns(), -1, parent, t.fit]
            t.stack.append(len(t.spans))
            t.spans.append(self.rec)
        else:
            self.rec = None
            t.dropped += 1
            t.stack.append(-1)
        return self

    def __exit__(self, *exc):
        global _on, _profiling
        t = _T
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
        if t.stack:
            t.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.new_fit:
            t.fit = self.prev_fit
        if not t.stack:
            _on, _profiling = _enabled, False
        return False


class _Null:
    """What a span site gets while the tracer is off: a context manager
    that does nothing, and a ``step`` that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __call__(self, name):
        pass


_NULL = _Null()


def span(name):
    """A span named ``name`` (a context manager); the shared ``_NULL``
    while the tracer is off."""
    if not _on:
        return _NULL
    return _Span(name)


class _Steps(_Span):
    """A span whose children follow one another: ``step(name)`` ends the
    open child and starts the next; leaving the span ends both."""
    __slots__ = ('child',)

    def __enter__(self):
        self.child = None
        return super().__enter__()

    def __call__(self, name):
        if self.child is not None:
            self.child.__exit__(None, None, None)
        self.child = _Span(name)
        self.child.__enter__()

    def __exit__(self, *exc):
        if self.child is not None:
            self.child.__exit__(*exc)
        return super().__exit__(*exc)


def steps(name):
    """A span of consecutive children (a context manager ``step``;
    ``step(child)`` starts each child, ending the one before); a shared
    null one, whose ``step`` does nothing, while the tracer is off."""
    if not _on:
        return _NULL
    return _Steps(name)


def entry(name, fit=False):
    """Decorate an entry of the port (``viprs.fit``, ``viprs.bma``,
    ``viprs.pack``): with no span open, each call first decides whether the
    tracer records, then runs as the span ``name``. ``fit=True``: the span
    assigns the fit's id, a fit called inside a fit (a grid of one running
    the model's own) is part of it, and when the fit returns the totals of
    the model's ``fit_counters`` (the record the fit made) go to the tracer
    under the fit's id."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _T.stack:
                _decide()
            if not _on or (fit and _T.fit):
                return fn(*args, **kwargs)
            with _Span(name, new_fit=fit):
                if not fit:
                    return fn(*args, **kwargs)
                model = args[0]
                before = model.fit_counters
                out = fn(*args, **kwargs)
                if model.fit_counters is not before:   # the fit's own record
                    for key, n in model.fit_counters.totals().items():
                        count(key, n)
                return out
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to the counter ``name`` of the current fit (fit id 0
    outside fits); nothing while the tracer is off."""
    if _on:
        c = _T.counters.setdefault(_T.fit, {})
        c[name] = c.get(name, 0) + int(n)


def enable():
    """Record from now on, with or without a profiler session (spans enter
    ``record_function`` only while a session records)."""
    global _enabled, _on
    _enabled = _on = True


def disable():
    """Undo ``enable()``: record only while a profiler session records."""
    global _enabled, _on
    _enabled = False
    if not _T.stack:
        _on = False


def records() -> Records:
    """The spans and per-fit counters kept since the last ``reset()``."""
    t = _T
    return Records([Span(*s) for s in t.spans],
                   {f: dict(c) for f, c in t.counters.items()}, t.dropped)


def reset():
    """Forget the spans and counters kept so far (between fits: a span
    open now is not kept)."""
    t = _T
    t.spans, t.stack, t.counters, t.dropped = [], [], {}, 0


class Chunk(NamedTuple):
    """One EM loop call of a fit."""
    width: int                   # lanes swept each iteration, padding too
    rule: str                    # 'all', 'skip' or 'hybrid' (em_loop.py)
    iterations: int
    live_lane_iterations: int    # sum over iterations of running lanes
    outer: int = 0               # its chunk's index in ``outer_widths``


@dataclasses.dataclass
class FitCounters:
    """What a fit's chunk driver did, kept by the driver of every fit.

    :ivar chunks: a ``Chunk`` per EM loop call.
    :ivar outer_widths: the width the driver's chunk rule chose for each
        chunk (the JAX package's chunk trace); a chunk runs as one loop
        call, or as several (sub-chunks, model/viprs.py) at the width of
        their running lanes.
    :ivar lane_sweeps: sum over iterations of the chunk's width.
    :ivar live_lane_sweeps: sum over iterations of the lanes still running
        (not stopped, not padding); ``lane_sweeps`` less this is the
        lane-sweeps of lanes that had stopped.
    :ivar host_reads: the loops' device-to-host reads (on a mesh, the
        halo exchange's copies are not counted).
    :ivar compactions: loop calls run at a compacted width (model/viprs.py:
        on the state's leading rows, their lanes' rows moved there;
        model/mix_grid.py: a gather into it and a scatter back).
    :ivar skip_iterations: iterations that took the S = 1 hybrid's skip
        branch.
    :ivar active_blocks: under the skip rules, the blocks swept each
        iteration (-1 where not measured).
    """
    chunks: List[Chunk] = dataclasses.field(default_factory=list)
    outer_widths: List[int] = dataclasses.field(default_factory=list)
    lane_sweeps: int = 0
    live_lane_sweeps: int = 0
    host_reads: int = 0
    compactions: int = 0
    skip_iterations: int = 0
    active_blocks: List[int] = dataclasses.field(default_factory=list)

    def begin_outer(self, width):
        """Start a chunk of ``width`` lanes whose loop calls follow as
        ``add_chunk(..., sub=True)``."""
        self.outer_widths.append(int(width))

    def add_chunk(self, width, rule, res, sub=False):
        """Count one loop call of ``width`` lanes under ``rule`` from its
        result (an ``EMResult`` or ``MixEMResult``): a chunk of its own, or
        with ``sub`` one of the chunk ``begin_outer`` started."""
        if not sub:
            self.begin_outer(width)
        n, live = int(res.n_iter_total), int(res.live_lane_sweeps)
        self.chunks.append(Chunk(int(width), rule, n, live,
                                 len(self.outer_widths) - 1))
        self.lane_sweeps += int(width) * n
        self.live_lane_sweeps += live
        self.host_reads += int(res.host_reads)
        self.skip_iterations += int(getattr(res, 'n_skip', 0))
        if rule != 'all':
            self.active_blocks.extend(int(a) for a in res.act_hist[1:])

    def totals(self):
        """{counter: int}, the record's scalars (what the tracer keeps)."""
        return {'chunks': len(self.chunks),
                'iterations': sum(c.iterations for c in self.chunks),
                'lane_sweeps': self.lane_sweeps,
                'live_lane_sweeps': self.live_lane_sweeps,
                'host_reads': self.host_reads,
                'compactions': self.compactions,
                'skip_iterations': self.skip_iterations}


def sweep_rule(use_skip, use_hybrid=False):
    """The name of a chunk's sweep rule (``Chunk.rule``)."""
    return 'hybrid' if use_hybrid else 'skip' if use_skip else 'all'


class StageClock:
    """Seconds per stage. Host stages (reading, uploading) by the host
    clock; device stages (decoding, products) by CUDA events on a CUDA
    device, read once, when ``seconds()`` is asked for; by the host clock
    on the CPU. A stage run again adds to its total."""

    def __init__(self, device=None):
        self._cuda = device is not None and torch.device(device).type == \
            'cuda'
        self._host = {}
        self._events = {}

    @contextlib.contextmanager
    def host(self, name):
        t0 = time.perf_counter()
        yield
        self._host[name] = self._host.get(name, 0.0) + \
            time.perf_counter() - t0

    @contextlib.contextmanager
    def device(self, name):
        if not self._cuda:
            with self.host(name):
                yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._events.setdefault(name, []).append((start, end))

    def add(self, seconds):
        """Add {stage: seconds} (another clock's ``seconds()``)."""
        for name, s in seconds.items():
            self._host[name] = self._host.get(name, 0.0) + s

    def seconds(self):
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize()
        for name, pairs in self._events.items():
            out[name] = out.get(name, 0.0) + sum(
                s.elapsed_time(e) for s, e in pairs) / 1e3
        return out
