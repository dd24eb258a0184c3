"""The entries: how each kind of traffic drives the system under test.

A traffic file names its entry (``"entry"``); the entry is the file
``entries/<entry>.py``, found by that name and loaded from its path
(``load``), so a new kind of traffic is a new file here and no edit. The
file defines ``Entry(traffic, m, device)`` (a ``BaseEntry``) with:

- ``planes``: the (read, written) state planes a lane sweep touches, for
  the E-step's work counts;
- ``warm_up(ds)``: one fit capped at the traffic's ``warmup_iters``;
- ``run(ds, span)``: one whole fit of a trait's dataset; returns a
  ``FitRecord`` and a handle on its answers, a tuple whose first item is
  the model whose lanes are judged;
- ``answers(handle)``: the answers through the models' public views, in the
  panel's variant order, read once the window has closed;
- ``judge(ld, out, beta, n, lanes=None)``: the plain reference's numbers of
  those answers (``reference.py``);
- ``control()``: a context under which ``run`` is the judge's control
  (by default ``control.plain_tf32``).

The entries are the only modules that call the port (``viprs_tpu_torch``),
and they import it inside their methods. An entry file imports what it
shares with the others by absolute name (``portbench.entries``,
``portbench.reference``).
"""

import importlib.util
import os
import re
import sys
from dataclasses import dataclass

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name, directory=HERE):
    """The ``Entry`` class of ``<directory>/<name>.py``; an unknown name
    raises."""
    path = os.path.join(directory, f'{name}.py')
    if not re.fullmatch(r'[A-Za-z0-9]\w*', str(name)) or \
            not os.path.isfile(path):
        raise KeyError(f"no entry {name!r}: no file {path}")
    modname = f'portbench_entry_{name}'
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.Entry


def concat(view):
    """{chrom: (m_c, ...)} -> (M, ...) in chromosome order."""
    return np.concatenate([np.asarray(view[c]) for c in sorted(view)], axis=0)


def sync(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize()


@dataclass
class FitRecord:
    seconds: float           # host clock, the fit and its averaging
    nit: np.ndarray          # (S,) each lane's iterations
    bma_s: float = None


class BaseEntry:
    """What every entry shares: the traffic, the panel's size, the device."""

    def __init__(self, traffic, m, device):
        self.traffic, self.m, self.device = traffic, int(m), device
        self.max_iter = int(traffic['max_iter'])

    def control(self):
        from portbench.control import plain_tf32
        return plain_tf32()
