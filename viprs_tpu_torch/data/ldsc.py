"""Simple LD-score-regression heritability estimate (initializes theta_0).

Method-of-moments estimator, as viprs_tpu.data.ldsc:

    E[chi2_j] = 1 + n * h2 * l_j / M
    h2_hat    = M * (mean(chi2) - 1) / (n * mean(l))
"""

import numpy as np

from ..utils.compute import dict_concat


def simple_ldsc(dataset):
    """h2 estimate from the dataset's summary statistics and LD scores
    (cached on the dataset)."""
    cache = dataset._cache
    if 'ldsc_h2' in cache:
        return cache['ldsc_h2']
    ld_scores = dict_concat(dataset.compute_ld_scores())
    std_beta = dict_concat(dataset.std_beta)
    n = dict_concat(dataset.n_per_snp).astype(np.float64)

    # recover chi2 from the pseudo-correlation r = z/sqrt(n + z^2):
    r2 = np.clip(np.asarray(std_beta, dtype=np.float64) ** 2, 0.0, 1.0 - 1e-12)
    chi2 = n * r2 / (1.0 - r2)

    m = len(std_beta)
    denom = np.mean(n) * np.mean(ld_scores)
    h2 = 0.0 if denom <= 0 else float(m * (np.mean(chi2) - 1.0) / denom)
    cache['ldsc_h2'] = h2
    return h2
