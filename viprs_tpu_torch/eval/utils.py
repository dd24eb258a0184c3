"""Evaluation helpers (counterpart of viprs_tpu.eval.utils; parity:
viprs/eval/eval_utils.py)."""

import numpy as np

from .glm import fit_linear_model  # noqa: F401  (re-exported)


def infer_likelihood(y, likelihood='infer'):
    """(y, likelihood): 'infer' (or None) makes a phenotype coded 0/1 or
    1/2 'binomial' (plink's 1/2 coding becomes 0/1) and any other
    'gaussian'; NaN values are ignored."""
    y = np.asarray(y, dtype=np.float64)
    if likelihood not in ('infer', None):
        return y, likelihood
    uniq = set(np.unique(y[~np.isnan(y)]).tolist())
    if uniq <= {0.0, 1.0} or uniq <= {1.0, 2.0}:
        if uniq <= {1.0, 2.0} and 2.0 in uniq:
            y = y - 1.0
        return y, 'binomial'
    return y, 'gaussian'


def r2_stats(r2_val, n):
    """SE / CI / p-value for an R^2 estimate (Momin et al. 2023)."""
    if not 0. < r2_val < 1.:
        raise ValueError("R^2 value must be between 0 and 1.")

    r2_var = (4. * r2_val * (1. - r2_val) ** 2 * (n - 2) ** 2) / \
        ((n ** 2 - 1) * (n + 3))
    r2_se = np.sqrt(r2_var)
    lower_r2 = r2_val - 1.97 * r2_se
    upper_r2 = r2_val + 1.97 * r2_se

    from scipy import stats
    pval = stats.chi2.sf((r2_val / r2_se) ** 2, df=1)

    return {'R2': r2_val, 'Lower_R2': lower_r2, 'Upper_R2': upper_r2,
            'P_Value': pval, 'SE': r2_se}
