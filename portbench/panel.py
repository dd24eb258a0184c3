"""The LD panel and the traits: the benchmark's data, made from seeds.

``synthesize_genome`` is a frozen copy of the repository's ``bench.py``
generator (held byte for byte against it by ``tests/test_bench_data.py``):
AR(1) LD blocks at LDetect-like sizes over 22 chromosomes, and one
spike-and-slab trait on them. The panel (the configuration's data, which
plays the part of weights) is that recipe's blocks at the configuration's
seed (``make_panel``), without a dense float64 copy: the generator's
random stream is replayed, and each block is built when it is read, in
the type the configuration stores (int8 at scale 1/127 or float32), as a
read-only Toeplitz view of its first column (``StoredBlocks``). The traits
(the traffic's data) are fresh spike-and-slab draws on the panel's blocks
(``draw_trait``), where R beta of an AR(1) block is two first-order
filters, O(m) a block.

A configuration's ``density`` (1 where it has none: HapMap3's) scales the
panel to a denser variant set over the same LD regions: each block holds
``density`` times the variants, and its AR(1) parameter is rho ** (1 /
density), so that two variants as far apart on the genome keep their
correlation. At ``density`` 1 the panel is ``synthesize_genome``'s.
"""

from collections.abc import Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy.linalg import toeplitz
from scipy.signal import lfilter


def log(*args):
    import sys
    print(*args, file=sys.stderr, flush=True)


def _block_sizes(rng, m_target, density=1.0):
    """{chrom: [m_b, ...]}: the block sizes of chromosomes 1..22, the first
    draws of ``synthesize_genome``'s stream; ``density`` scales the sizes
    and their clip."""
    chrom_weights = np.linspace(2.0, 0.55, 22)
    chrom_weights /= chrom_weights.sum()
    blocks_per_chrom = {}
    for c in range(1, 23):
        m_c = int(m_target * chrom_weights[c - 1])
        sizes = []
        while sum(sizes) < m_c:
            m_b = rng.lognormal(np.log(600 * density), 0.5)
            sizes.append(int(np.clip(m_b, 80 * density, 3500 * density)))
        sizes[-1] -= sum(sizes) - m_c
        if sizes[-1] < 40 * density:
            sizes.pop()
        blocks_per_chrom[c] = sizes
    return blocks_per_chrom


def synthesize_genome(m_target=1_100_000, n_gwas=350_000, h2=0.25,
                      prop_causal=0.002, seed=0, block_dtype=None):
    """Analytic genome-scale problem: AR(1) LD blocks + spike-slab sumstats
    (``bench.synthesize_genome``'s draws and arithmetic, unchanged).

    :returns: ({chrom: [dense (m_b, m_b) blocks]}, {chrom: std_beta},
        {chrom: n_per_snp}).
    """
    rng = np.random.default_rng(seed)
    blocks_per_chrom = _block_sizes(rng, m_target)
    total = sum(sum(sizes) for sizes in blocks_per_chrom.values())

    ld_blocks, std_beta, n_per_snp = {}, {}, {}
    for c, sizes in blocks_per_chrom.items():
        blocks, sb_parts = [], []
        for m_b in sizes:
            rho = rng.uniform(0.2, 0.95)
            R = toeplitz(rho ** np.arange(m_b))
            blocks.append(R if block_dtype is None else R.astype(block_dtype))

            beta = np.where(rng.random(m_b) < prop_causal,
                            rng.standard_normal(m_b) * np.sqrt(h2 / (prop_causal * total)),
                            0.0)
            z = rng.standard_normal(m_b)
            a = np.sqrt(1 - rho ** 2)
            z[0] /= a
            eps = lfilter([1.0], [1.0, -rho], a * z)
            sb_parts.append(R @ beta + eps / np.sqrt(n_gwas))
        ld_blocks[c] = blocks
        m_c = sum(sizes)
        std_beta[c] = np.concatenate(sb_parts)
        n_per_snp[c] = np.full(m_c, float(n_gwas))

    return ld_blocks, std_beta, n_per_snp


def stored_column(rho, m, quantize):
    """The stored first column of an AR(1) block, rho^k for k < m: int8
    (round-half-even of 127 rho^k, clipped) or float32."""
    col = rho ** np.arange(m)
    if quantize:
        return np.clip(np.rint(col * 127.0), -127, 127).astype(np.int8)
    return col.astype(np.float32)


def toeplitz_view(col):
    """The symmetric Toeplitz matrix of ``col`` (entry (i, j) is
    col[|i - j|]) as a read-only view over 2m - 1 values."""
    v = np.concatenate((col[:0:-1], col))
    return sliding_window_view(v, len(col))[::-1]


class StoredBlocks(Sequence):
    """One chromosome's AR(1) blocks in their stored type, each built when
    it is read (``toeplitz_view`` of ``stored_column``): entry for entry the
    dense float64 block quantized to int8, or cast to float32."""

    def __init__(self, rho, sizes, quantize):
        self.rho, self.sizes = list(rho), [int(m) for m in sizes]
        self.quantize = bool(quantize)

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        return toeplitz_view(stored_column(self.rho[i], self.sizes[i],
                                           self.quantize))


class Panel:
    """The LD blocks of one configuration, with the AR(1) parameter of each.

    :ivar blocks: {chrom: ``StoredBlocks``}, chromosomes 1..22 in order
        (the variant order of every per-variant array here).
    :ivar rho: (n_blocks,) float64, the blocks' AR(1) parameters in order
        (each float64 block's entry (0, 1)).
    :ivar sizes: (n_blocks,) int64.
    :ivar chrom_of_block: (n_blocks,) chromosome labels.
    """

    def __init__(self, blocks, sizes, rho):
        self.blocks = blocks
        self.sizes = np.asarray(sizes, np.int64)
        self.rho = np.asarray(rho, np.float64)
        self.chrom_of_block = np.concatenate(
            [[c] * len(blocks[c]) for c in sorted(blocks)])
        self.starts = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])

    @property
    def m(self):
        return int(self.sizes.sum())

    def flat_blocks(self):
        """The blocks in order, one at a time."""
        return (b for c in sorted(self.blocks) for b in self.blocks[c])

    def sizes_by_chrom(self):
        """{chrom: [m_b, ...]} in order."""
        return {c: [int(m) for m in self.sizes[self.chrom_of_block == c]]
                for c in sorted(self.blocks)}

    def chrom_sizes(self):
        return {c: sum(sizes) for c, sizes in self.sizes_by_chrom().items()}


def make_panel(cfg):
    """The configuration's panel: ``synthesize_genome``'s blocks at its
    ``m_target`` and ``panel_seed`` (scaled by its ``density``), built when
    read in the type ``quantize`` says. The generator's random stream is
    replayed: each block's rho is drawn, the draws of its trait are taken
    and dropped, and no block or trait is built."""
    density = float(cfg.get('density', 1.0))
    quantize = bool(cfg['quantize'])
    rng = np.random.default_rng(int(cfg['panel_seed']))
    blocks, sizes, rho = {}, [], []
    for c, chrom_sizes in _block_sizes(rng, int(cfg['m_target']),
                                       density).items():
        rhos = []
        for m_b in chrom_sizes:
            r = rng.uniform(0.2, 0.95) ** (1.0 / density)
            rng.random(m_b)
            rng.standard_normal(m_b)
            rng.standard_normal(m_b)
            rhos.append(r)
            # entry (0, 1) as the float64 block holds it
            rho.append((r ** np.arange(m_b))[1] if m_b > 1 else 0.0)
        blocks[c] = StoredBlocks(rhos, chrom_sizes, quantize)
        sizes += chrom_sizes
    return Panel(blocks, sizes, rho)


def _ar1_filter(x, rho):
    return lfilter([1.0], [1.0, -rho], x)


def draw_trait(panel, rng, h2, prop_causal, n_gwas):
    """One spike-and-slab trait on the panel, as ``synthesize_genome`` draws
    its own (bench.py's architecture): a variant is causal with probability
    ``prop_causal`` and its effect N(0, h2 / (prop_causal M)); the marginal
    betas are R beta + eps / sqrt(n) with eps ~ N(0, R), an AR(1) series per
    block. R beta of an AR(1) block is f + b - beta, f and b the forward and
    backward first-order filters of beta.

    :returns: (std_beta, n_per_snp) as {chrom: (m_c,) float64}.
    """
    m = panel.m
    causal = rng.random(m) < prop_causal
    beta = np.where(causal, rng.standard_normal(m)
                    * np.sqrt(h2 / (prop_causal * m)), 0.0)
    z = rng.standard_normal(m)
    out = np.empty(m)
    for s, m_b, rho in zip(panel.starts, panel.sizes, panel.rho):
        sl = slice(s, s + m_b)
        b = beta[sl]
        if b.any():
            rb = _ar1_filter(b, rho) + _ar1_filter(b[::-1], rho)[::-1] - b
        else:
            rb = np.zeros(m_b)
        a = np.sqrt(1.0 - rho ** 2)
        zz = z[sl] * a
        zz[0] = z[s]
        eps = _ar1_filter(zz, rho)
        out[sl] = rb + eps / np.sqrt(n_gwas)
    std_beta, n_per_snp, i = {}, {}, 0
    for c, m_c in panel.chrom_sizes().items():
        std_beta[c] = out[i:i + m_c]
        n_per_snp[c] = np.full(m_c, float(n_gwas))
        i += m_c
    return std_beta, n_per_snp
