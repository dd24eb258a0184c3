"""Datasets: summary statistics with block-packed LD (lazy exports:
importing the package loads no data code)."""

_EXPORTS = {'simulate_sumstats_blocks': 'simulate'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
