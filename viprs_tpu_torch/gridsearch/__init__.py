"""Grid construction, model selection and averaging (lazy exports:
importing the package loads no model code, pandas or scipy)."""

_EXPORTS = {'HyperparameterGrid': 'grid', 'select_best_model': 'search',
            'bayesian_model_average': 'search', 'GridSearch': 'search'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
