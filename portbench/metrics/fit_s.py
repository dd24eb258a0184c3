"""Seconds per whole fit: the window's time over its fits (grid traffic:
the fit and its model average), what a geneticist pays per trait."""

KIND = 'end_to_end'
UNIT = 's'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(run):
    if not run.fits:
        return None
    return run.window_s / len(run.fits)
