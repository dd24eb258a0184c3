"""Models of the port: the VIPRS fit, its grid, the mixture prior with its
grid, and the LDPred-inf baseline (lazy exports: importing the package
loads no model code)."""

_EXPORTS = {'BayesPRSModel': 'base', 'VIPRS': 'viprs', 'VIPRSGrid': 'grid',
            'VIPRSMix': 'mix', 'VIPRSMixGrid': 'mix_grid',
            'LDPredInf': 'ldpred_inf'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
