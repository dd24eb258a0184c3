"""Useful coordinate updates a second, in billions: M times the sum over the
window's fits of every lane's iterations (each lane counted to its own
convergence, not past it), over the window's time."""

KIND = 'end_to_end'
UNIT = 'Gupd/s'
BETTER = 'higher'
SOURCE = 'host_clock'


def read(run):
    if not run.fits:
        return None
    n = sum(int(f.nit.sum()) for f in run.fits)
    return run.m * n / run.window_s / 1e9
