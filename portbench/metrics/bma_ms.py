"""Milliseconds of ``bayesian_model_average`` and the averaged model's
heritability, host clock around the call, synchronized, mean over the
window's fits."""

KIND = 'per_layer'
UNIT = 'ms'
BETTER = 'lower'
SOURCE = 'host_clock'
LAYER = 'model averaging (gridsearch/search.py)'
MOVES = 'fit_s'


def read(run):
    times = [f.bma_s for f in run.fits if f.bma_s is not None]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
