"""Synthetic GWAS data simulation (counterpart of viprs_tpu.data.simulate,
numpy and scipy only): deterministic simulators of (LD blocks, summary
statistics, true effects) with a known architecture, and AR(1) genotypes
with their 0/1/2 dosages. The same seed gives the JAX package's arrays bit
for bit.
"""

import numpy as np


def _standardize(X):
    X = X - X.mean(axis=0, keepdims=True)
    sd = X.std(axis=0, keepdims=True)
    sd[sd == 0] = 1.0
    return X / sd


def simulate_dosages(n, m, rho=0.6, maf_low=0.05, maf_high=0.5, rng=None):
    """Simulate an (n, m) block of 0/1/2 dosages with AR(1)-like LD.

    Latent Gaussian with AR(1) correlation ``rho`` thresholded to 0/1/2 by
    Hardy-Weinberg probabilities at a random MAF per site.
    """
    rng = rng or np.random.default_rng(0)
    z = rng.standard_normal((n, m))
    for j in range(1, m):
        z[:, j] = rho * z[:, j - 1] + np.sqrt(1 - rho ** 2) * z[:, j]
    maf = rng.uniform(maf_low, maf_high, size=m)
    # two independent latent draws approximated by thresholding z twice:
    from scipy.stats import norm
    t = norm.ppf(1.0 - maf)
    g = (z > t).astype(np.float64)
    z2 = np.roll(z, 1, axis=0) * rho + np.sqrt(1 - rho ** 2) * \
        rng.standard_normal((n, m))
    g += (z2 > t).astype(np.float64)
    return g


def simulate_genotypes(n, m, rho=0.6, maf_low=0.05, maf_high=0.5, rng=None):
    """Simulate an (n, m) standardized genotype block with AR(1)-like LD
    (``simulate_dosages`` standardized per variant)."""
    return _standardize(simulate_dosages(n, m, rho=rho, maf_low=maf_low,
                                         maf_high=maf_high, rng=rng))


def simulate_sumstats_blocks(n=2000,
                             block_sizes=(300, 200, 250),
                             h2=0.3,
                             prop_causal=0.05,
                             rho=0.6,
                             seed=0,
                             chrom=22):
    """Simulate a single-chromosome dataset with block-diagonal LD.

    :returns: dict with keys:
        ``ld_blocks``: {chrom: [dense (m_i, m_i) float64 LD blocks]},
        ``std_beta``: {chrom: (M,)} standardized marginal betas,
        ``n_per_snp``: {chrom: (M,)},
        ``beta_true``: {chrom: (M,)} true standardized effects,
        ``h2``, ``n``, ``m``, ``genotypes`` (n, M) and ``phenotype`` (n,).
    """
    rng = np.random.default_rng(seed)
    Xs = [simulate_genotypes(n, m_i, rho=rho, rng=rng) for m_i in block_sizes]
    X = np.concatenate(Xs, axis=1)
    m = X.shape[1]

    causal = rng.random(m) < prop_causal
    if not causal.any():
        causal[rng.integers(m)] = True
    beta = np.zeros(m)
    beta[causal] = rng.standard_normal(causal.sum()) * np.sqrt(h2 / causal.sum())

    g = X @ beta
    g_var = g.var()
    if g_var > 0:
        # rescale to the target heritability exactly
        beta *= np.sqrt(h2 / g_var)
        g = X @ beta
    y = g + rng.standard_normal(n) * np.sqrt(max(1e-8, 1.0 - h2))
    y = (y - y.mean()) / y.std()

    # marginal standardized betas (pseudo-correlations): X'y / n
    std_beta = X.T @ y / n

    ld_blocks = [Xi.T @ Xi / n for Xi in Xs]

    return dict(
        ld_blocks={chrom: ld_blocks},
        std_beta={chrom: std_beta.astype(np.float64)},
        n_per_snp={chrom: np.full(m, n, dtype=np.float64)},
        beta_true={chrom: beta},
        h2=h2, n=n, m=m,
        genotypes=X, phenotype=y,
    )
