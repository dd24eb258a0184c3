"""Chromosome-keyed dict helpers (NumPy only; the subset of
viprs_tpu.utils.compute the port needs)."""

import numpy as np


def dict_concat(d, axis=0):
    """Concatenate chromosome-keyed arrays in sorted-chromosome order."""
    if len(d) == 1:
        (only,) = d.values()
        return only
    return np.concatenate([d[c] for c in sorted(d)], axis=axis)


def dict_max(d, axis=None):
    """Max of the per-chromosome maxima."""
    return np.max(np.asarray([np.max(v, axis=axis) for v in d.values()]),
                  axis=axis)
