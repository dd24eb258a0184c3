"""Evaluation metrics of the port (lazy exports: importing the package
loads no model code)."""

_EXPORTS = {'pseudo_r2': 'pseudo', 'pseudo_pearson_r': 'pseudo'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
