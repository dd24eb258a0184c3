"""The slowest lane's iterations, mean over the window's fits (each lane's
nit from the model's public ``optim_results``)."""

KIND = 'per_layer'
UNIT = 'it'
BETTER = 'lower'
SOURCE = 'program_counter'
LAYER = 'chunk drivers (model/grid.py, model/mix_grid.py)'
MOVES = 'fit_s'


def read(run):
    if not run.fits:
        return None
    return sum(int(f.nit.max()) for f in run.fits) / len(run.fits)
