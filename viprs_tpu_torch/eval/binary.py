"""Binary-phenotype (case/control) prediction metrics (counterpart of
viprs_tpu.eval.binary; parity: viprs/eval/binary_metrics.py, with the
liability-scale R^2 family). The rank and curve metrics are computed here
with numpy and scipy, with scikit-learn's conventions: AUROC is the
Mann-Whitney statistic (ties count one half), the precision-recall curve
has a point per distinct score and ends at (recall 0, precision 1), the
average precision is its step sum. Covariates are a 2-D array or a Table.
"""

import numpy as np

from .continuous import incremental_r2, with_prediction
from .glm import fit_linear_model


def roc_auc(true_val, pred_val):
    """Area under the ROC curve: the Mann-Whitney U of the cases' scores
    over n_cases * n_controls, tied scores at their average rank (NaN when
    only one class is present)."""
    from scipy.stats import rankdata
    y = np.asarray(true_val) == 1
    n1 = int(y.sum())
    n0 = len(y) - n1
    if n1 == 0 or n0 == 0:
        return np.nan
    ranks = rankdata(np.asarray(pred_val, np.float64))
    return (ranks[y].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0)


def precision_recall_curve(true_val, pred_val):
    """(precision, recall) at every distinct score, highest first,
    reversed and closed by (precision 1, recall 0) as scikit-learn's
    ``precision_recall_curve`` returns them."""
    y = (np.asarray(true_val) == 1).astype(np.float64)
    score = np.asarray(pred_val, np.float64)
    order = np.argsort(score, kind='mergesort')[::-1]
    score, y = score[order], y[order]
    idx = np.r_[np.where(np.diff(score))[0], len(y) - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx - tps
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]))


def pr_auc(true_val, pred_val):
    """Area under the precision-recall curve by the trapezoid rule."""
    precision, recall = precision_recall_curve(true_val, pred_val)
    trapezoid = getattr(np, 'trapezoid', None) or np.trapz  # numpy < 2
    return -trapezoid(precision, recall)


def avg_precision(true_val, pred_val):
    """Average precision: sum over the curve's points of
    (R_n - R_{n-1}) P_n."""
    precision, recall = precision_recall_curve(true_val, pred_val)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def f1(true_val, pred_val, threshold=0.5):
    """F1 after fitting phenotype ~ logistic(PRS) and thresholding."""
    if not 0. <= threshold <= 1.:
        raise ValueError("The F1 threshold must be between 0 and 1.")
    logit_result = fit_linear_model(true_val, np.asarray(pred_val)[:, None],
                                    family='binomial', add_intercept=True)
    labels = logit_result.predict() >= threshold
    y = np.asarray(true_val) == 1
    tp = int(np.sum(y & labels))
    denom = 2 * tp + int(np.sum(~y & labels)) + int(np.sum(y & ~labels))
    return 2.0 * tp / denom if denom else 0.0


def _null_full_binom(true_val, pred_val, covariates, link=None):
    null, full, add_intercept = with_prediction(true_val, pred_val,
                                                covariates)
    null_result = fit_linear_model(true_val, null, family='binomial',
                                   link=link, add_intercept=add_intercept)
    full_result = fit_linear_model(true_val, full, family='binomial',
                                   link=link, add_intercept=add_intercept)
    return null_result, full_result


def mcfadden_r2(true_val, pred_val, covariates=None):
    null_result, full_result = _null_full_binom(true_val, pred_val, covariates)
    return 1. - (full_result.llf / null_result.llf)


def cox_snell_r2(true_val, pred_val, covariates=None):
    null_result, full_result = _null_full_binom(true_val, pred_val, covariates)
    n = len(true_val)
    return 1. - np.exp(-2 * (full_result.llf - null_result.llf) / n)


def nagelkerke_r2(true_val, pred_val, covariates=None):
    null_result, full_result = _null_full_binom(true_val, pred_val, covariates)
    n = len(true_val)
    cox_snell = 1. - np.exp(-2 * (full_result.llf - null_result.llf) / n)
    return cox_snell / (1. - np.exp(2 * null_result.llf / n))


def liability_r2(true_val, pred_val, covariates=None, return_all_r2=False):
    """Observed-scale incremental R^2 rescaled to the liability scale
    (Lee et al. 2012): multiply by K(1-K)/z^2 at prevalence K."""
    r2_obs = incremental_r2(true_val, pred_val, covariates,
                            return_all_r2=return_all_r2)

    from scipy.stats import norm
    k = np.mean(true_val)
    z2 = norm.pdf(norm.ppf(1. - k)) ** 2
    mult = k * (1. - k) / z2

    if return_all_r2:
        return {key: val * mult for key, val in r2_obs.items()}
    return r2_obs * mult


def _liability_var_r2(true_val, pred_val, covariates, link, denom_extra):
    null_result, full_result = _null_full_binom(true_val, pred_val, covariates,
                                                link=link)
    null_var = np.var(null_result.predict())
    full_var = np.var(full_result.predict())
    null_r2 = null_var / (null_var + denom_extra)
    full_r2 = full_var / (full_var + denom_extra)
    return null_r2, full_r2


def liability_probit_r2(true_val, pred_val, covariates=None,
                        return_all_r2=False):
    """R^2_probit = Var(pred)/(Var(pred) + 1)."""
    null_r2, full_r2 = _liability_var_r2(true_val, pred_val, covariates,
                                         'probit', 1.0)
    if return_all_r2:
        return {'Null_R2': null_r2, 'Full_R2': full_r2,
                'Incremental_R2': full_r2 - null_r2}
    return full_r2 - null_r2


def liability_logit_r2(true_val, pred_val, covariates=None,
                       return_all_r2=False):
    """R^2_logit = Var(pred)/(Var(pred) + pi^2/3)."""
    null_r2, full_r2 = _liability_var_r2(true_val, pred_val, covariates,
                                         None, np.pi ** 2 / 3)
    if return_all_r2:
        return {'Null_R2': null_r2, 'Full_R2': full_r2,
                'Incremental_R2': full_r2 - null_r2}
    return full_r2 - null_r2
