"""Host-side helpers (NumPy only; lazy exports)."""

_EXPORTS = {'OptimizeResult': 'optimize',
            'IterationConditionCounter': 'optimize',
            'OptimizationDivergence': 'exceptions'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
