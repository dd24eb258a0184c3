"""Continuous-phenotype prediction metrics (counterpart of
viprs_tpu.eval.continuous; parity: viprs/eval/continuous_metrics.py).
Covariates are a 2-D array or a Table."""

import numpy as np

from .glm import as_matrix, fit_linear_model


def r2(true_val, pred_val):
    """Squared correlation (variance explained) between PRS and phenotype."""
    from scipy import stats
    _, _, r_val, _, _ = stats.linregress(pred_val, true_val)
    return r_val ** 2


def mse(true_val, pred_val):
    return np.mean((np.asarray(pred_val) - np.asarray(true_val)) ** 2)


def spearman_r(true_val, pred_val):
    from scipy import stats
    return stats.spearmanr(true_val, pred_val).statistic


def pearson_r(true_val, pred_val):
    return np.corrcoef(true_val, pred_val)[0, 1]


def r2_residualized_target(true_val, pred_val, covariates):
    """R^2 after residualizing the phenotype on covariates."""
    resid_model = fit_linear_model(true_val, covariates, add_intercept=True)
    return r2(resid_model.resid, pred_val)


def with_prediction(true_val, pred_val, covariates):
    """(null design, full design, add_intercept): the covariates (a column
    of ones without them) and the covariates followed by the PRS."""
    if covariates is None:
        null = np.ones((len(true_val), 1))
        add_intercept = False
    else:
        null = as_matrix(covariates)
        null = null[:, None] if null.ndim == 1 else null
        add_intercept = True
    full = np.column_stack([null, np.asarray(pred_val, np.float64)])
    return null, full, add_intercept


def incremental_r2(true_val, pred_val, covariates=None, return_all_r2=False):
    """R^2(covariates + PRS) - R^2(covariates)."""
    null, full, add_intercept = with_prediction(true_val, pred_val,
                                                covariates)
    null_result = fit_linear_model(true_val, null, add_intercept=add_intercept)
    full_result = fit_linear_model(true_val, full, add_intercept=add_intercept)
    if return_all_r2:
        return {'Null_R2': null_result.rsquared,
                'Full_R2': full_result.rsquared,
                'Incremental_R2': full_result.rsquared - null_result.rsquared}
    return full_result.rsquared - null_result.rsquared


def partial_correlation(true_val, pred_val, covariates):
    """Correlation between phenotype and PRS residuals after removing
    covariates."""
    true_res = fit_linear_model(true_val, covariates, add_intercept=True)
    pred_res = fit_linear_model(pred_val, covariates, add_intercept=True)
    return np.corrcoef(true_res.resid, pred_res.resid)[0, 1]
