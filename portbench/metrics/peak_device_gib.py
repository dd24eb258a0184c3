"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""

KIND = 'end_to_end'
UNIT = 'GiB'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2.0 ** 30
