"""The LD panel and the traits: the benchmark's data, made from seeds.

``synthesize_genome`` is a frozen copy of the repository's ``bench.py``
generator (held byte for byte against it by ``tests/test_panel.py``): AR(1)
LD blocks at LDetect-like sizes over 22 chromosomes, and one spike-and-slab
trait on them. The panel (the configuration's data, which plays the part of
weights) is that recipe at its own seed; the traits (the traffic's data) are
fresh spike-and-slab draws on the panel's blocks (``draw_trait``), where
R beta of an AR(1) block is two first-order filters, O(m) a block.
"""

import numpy as np
from scipy.linalg import toeplitz
from scipy.signal import lfilter


def log(*args):
    import sys
    print(*args, file=sys.stderr, flush=True)


def synthesize_genome(m_target=1_100_000, n_gwas=350_000, h2=0.25,
                      prop_causal=0.002, seed=0, block_dtype=None):
    """Analytic genome-scale problem: AR(1) LD blocks + spike-slab sumstats
    (``bench.synthesize_genome``, unchanged).

    :returns: ({chrom: [dense (m_b, m_b) blocks]}, {chrom: std_beta},
        {chrom: n_per_snp}).
    """
    rng = np.random.default_rng(seed)

    chrom_weights = np.linspace(2.0, 0.55, 22)
    chrom_weights /= chrom_weights.sum()
    blocks_per_chrom = {}
    total = 0
    for c in range(1, 23):
        m_c = int(m_target * chrom_weights[c - 1])
        sizes = []
        while sum(sizes) < m_c:
            sizes.append(int(np.clip(rng.lognormal(np.log(600), 0.5), 80, 3500)))
        sizes[-1] -= sum(sizes) - m_c
        if sizes[-1] < 40:
            sizes.pop()
        blocks_per_chrom[c] = sizes
        total += sum(sizes)

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


class Panel:
    """The LD blocks of one configuration, with the AR(1) parameter of each.

    :ivar blocks: {chrom: [dense float64 (m_b, m_b)]}, chromosomes 1..22 in
        order (the variant order of every per-variant array here).
    :ivar rho: (n_blocks,) float64, the blocks' AR(1) parameters in order.
    :ivar sizes: (n_blocks,) int64.
    :ivar chrom_of_block: (n_blocks,) chromosome labels.
    """

    def __init__(self, blocks):
        self.blocks = blocks
        flat = [b for c in sorted(blocks) for b in blocks[c]]
        self.sizes = np.array([b.shape[0] for b in flat], np.int64)
        self.rho = np.array([b[0, 1] if b.shape[0] > 1 else 0.0
                             for b in flat], np.float64)
        self.chrom_of_block = np.concatenate(
            [[c] * len(blocks[c]) for c in sorted(blocks)])
        self.starts = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])

    @property
    def m(self):
        return int(self.sizes.sum())

    def flat_blocks(self):
        return [b for c in sorted(self.blocks) for b in self.blocks[c]]

    def chrom_sizes(self):
        return {c: int(sum(b.shape[0] for b in self.blocks[c]))
                for c in sorted(self.blocks)}


def make_panel(cfg):
    """The configuration's panel: ``synthesize_genome`` at the config's
    ``m_target``, ``n_gwas`` and ``panel_seed`` (its own trait is dropped)."""
    blocks, _, _ = synthesize_genome(m_target=int(cfg['m_target']),
                                     n_gwas=float(cfg['n_gwas']),
                                     seed=int(cfg['panel_seed']))
    return Panel(blocks)


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
