"""The traced run's device timeline, read from ``torch.profiler``.

The window runs under the profiler (CPU and CUDA activities); its Chrome
trace is written to a temporary file, read back and deleted. From it:

- the device intervals (kernels, copies, sets), merged: ``busy_s``;
- the window (the benchmark's ``portbench.window`` span): ``window_s``;
- device seconds by kernel name (``kernels``);
- every idle gap of the device inside the window, put down to what the host
  was doing at its middle: the innermost host event (an operator, a runtime
  call or one of the benchmark's spans) covering it, else ``host_python``.
"""

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
WINDOW_SPAN = 'portbench.window'


class Timeline:
    def __init__(self, events):
        self.kernels = defaultdict(float)     # name -> device seconds
        self.kernel_count = defaultdict(int)
        dev, host = [], []
        win = None
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat, ts, dur = e.get('cat'), e.get('ts'), e.get('dur')
            if ts is None or dur is None:
                continue
            ts, dur = float(ts), float(dur)
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur))
                if cat == 'kernel':
                    self.kernels[e['name']] += dur * 1e-6
                    self.kernel_count[e['name']] += 1
            elif cat in HOST_CATS:
                if e.get('name') == WINDOW_SPAN and cat == 'user_annotation':
                    win = (ts, ts + dur)
                host.append((ts, ts + dur, e.get('name', '?'), e.get('tid')))
        if win is None:
            raise ValueError("the trace holds no window span")
        self.window = win
        self.window_s = (win[1] - win[0]) * 1e-6
        busy = []
        for a, b in sorted(dev):
            a, b = max(a, win[0]), min(b, win[1])
            if b <= a:
                continue
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        self.busy = busy
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self._host = self._nest(host)

    @staticmethod
    def _nest(host):
        """Host events of the thread that holds the most, in start order,
        with each one's parent (the latest earlier event that covers it)."""
        by_tid = defaultdict(list)
        for ev in host:
            by_tid[ev[3]].append(ev)
        main = max(by_tid.values(), key=len) if by_tid else []
        main.sort(key=lambda ev: (ev[0], -ev[1]))
        parent, stack = [], []
        for i, (a, b, _, _) in enumerate(main):
            while stack and main[stack[-1]][1] < b:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        return main, [ev[0] for ev in main], parent

    def host_at(self, t):
        main, starts, parent = self._host
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and main[i][1] < t:
            i = parent[i]
        return main[i][2] if i >= 0 else 'host_python'

    def idle_by_host(self):
        """{what the host was doing: idle device seconds}."""
        out = defaultdict(float)
        lo, hi = self.window
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out[self.host_at(0.5 * (a + b))] += (b - a) * 1e-6
        return out


def read_profile(prof):
    """The profiler's trace as a Timeline (the file is removed)."""
    fd, path = tempfile.mkstemp(suffix='.json', prefix='portbench_trace_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    return Timeline(events)


def top(d, k=10):
    return [[name, v] for name, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]
