"""Seconds of ``SummaryStatsDataset.from_dense_blocks``: the packer
(``ops/block_ld.pack_dense_blocks``) and the upload to the card, host clock
around the call, synchronized."""

KIND = 'per_layer'
UNIT = 's'
BETTER = 'lower'
SOURCE = 'host_clock'
LAYER = 'data packer (ops/block_ld.py, data/dataset.py)'
MOVES = 'setup_s'


def read(run):
    return run.pack_s
