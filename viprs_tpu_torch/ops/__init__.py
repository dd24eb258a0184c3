"""Device compute: LD packing, CAVI sweeps (plain and CUDA), updates, EM loop
(lazy exports: importing the package loads no torch code)."""

_EXPORTS = {'BlockLD': 'block_ld', 'BlockLayout': 'block_ld',
            'pack_dense_blocks': 'block_ld', 'pack_banded': 'block_ld',
            'cavi_sweep': 'cavi_torch', 'compute_q': 'cavi_torch',
            'refresh_q': 'cavi_torch'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
