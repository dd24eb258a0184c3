"""Seconds from the process's start to the window's: imports, the panel,
packing and upload, the trait pool, the kernel build (first run in a
checkout only) and the warm-up fit."""

KIND = 'end_to_end'
UNIT = 's'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(run):
    return run.setup_s
