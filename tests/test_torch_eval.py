"""The port's evaluation metrics (``viprs_tpu_torch.eval``: every metric of
``eval_metric_names``, the GLM fits, ``r2_stats``) against the JAX
package's (which takes AUROC, the precision-recall curve, the average
precision and F1 from scikit-learn), on the CPU.

Each metric runs on the same numpy inputs in both packages: gaussian and
binary phenotypes, scores rounded so that many tie, with no covariates
and with covariates as a 2-D array and as a Table (the JAX package gets a
DataFrame). Tolerances: rank, curve and F1 metrics within 1e-12; the
others (correlations, MSE and the GLM fits) within 1e-9.
"""

import numpy as np
import pandas as pd
import pytest

from viprs_tpu import eval as jax_eval
from viprs_tpu.eval import glm as jax_glm

from viprs_tpu_torch import eval as port_eval
from viprs_tpu_torch.eval import binary, glm
from viprs_tpu_torch.utils.table import Table

#: Metrics computed from ranks, the precision-recall curve or labels.
RANK_METRICS = ('AUROC', 'AUPRC', 'Avg_Precision', 'F1_Score', 'Spearman_R')
#: Metrics that need a binary phenotype.
BINARY_ONLY = ('AUROC', 'AUPRC', 'Avg_Precision', 'F1_Score', 'Liability_R2',
               'Liability_Probit_R2', 'Liability_Logit_R2', 'Nagelkerke_R2',
               'CoxSnell_R2', 'McFadden_R2')
#: Metrics whose covariates are required.
NEED_COVARIATES = ('R2_residualized_target', 'Partial_Correlation')


def data(kind, seed=0, n=400):
    """(phenotype, PRS rounded to 1 decimal: many ties, covariates (n, 2))."""
    rng = np.random.default_rng(seed)
    cov = rng.standard_normal((n, 2))
    g = rng.standard_normal(n)
    if kind == 'binary':
        y = (g + 0.5 * cov[:, 0] + rng.standard_normal(n) > 0.8) \
            .astype(np.float64)
    else:
        y = g + 0.3 * cov[:, 1] + rng.standard_normal(n)
    prs = np.round(g + 0.5 * rng.standard_normal(n), 1)
    return y, prs, cov


def cases():
    out = []
    for name in sorted(port_eval._METRICS):
        kinds = ('binary',) if name in BINARY_ONLY else ('gaussian', 'binary')
        if name not in port_eval.eval_incremental_metrics:
            covs = ('none',)
        elif name in NEED_COVARIATES:
            covs = ('array', 'table')
        else:
            covs = ('none', 'array', 'table')
        out += [(name, k, c) for k in kinds for c in covs]
    return out


@pytest.mark.parametrize('name,kind,cov', cases())
def test_metric_matches_jax(name, kind, cov):
    y, prs, c = data(kind)
    fn = port_eval.eval_metric_names[name]
    jfn = jax_eval.eval_metric_names[name]
    if cov == 'none':
        args, jargs = (y, prs), (y, prs)
        if name in port_eval.eval_incremental_metrics:
            args, jargs = args + (None,), jargs + (None,)
    else:
        port_cov = c if cov == 'array' else Table({'c0': c[:, 0],
                                                   'c1': c[:, 1]})
        args, jargs = (y, prs, port_cov), (y, prs, pd.DataFrame(c))
    got, want = fn(*args), jfn(*jargs)
    assert np.isfinite(want)
    tol = 1e-12 if name in RANK_METRICS else 1e-9
    assert abs(got - want) <= tol, (got, want)


@pytest.mark.parametrize('fn', ['incremental_r2', 'liability_r2',
                                'liability_probit_r2', 'liability_logit_r2'])
def test_return_all_r2_matches_jax(fn):
    y, prs, c = data('binary', seed=1)
    got = getattr(port_eval, fn)(y, prs, c, return_all_r2=True)
    want = getattr(jax_eval, fn)(y, prs, pd.DataFrame(c), return_all_r2=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k


def test_curves_on_edge_inputs_match_sklearn():
    """Every score tied, every label positive or alternating, a single
    case: the curve metrics keep scikit-learn's conventions."""
    from sklearn.metrics import (average_precision_score, auc,
                                 precision_recall_curve, roc_auc_score)
    rng = np.random.default_rng(3)
    for y, s in (
            (np.array([0., 1, 0, 1]), np.zeros(4)),
            (np.array([1., 0, 0, 0, 0]), np.array([.1, .2, .2, .3, .1])),
            (np.tile([0., 1], 50), np.round(rng.random(100), 1)),
            ((rng.random(60) < .2).astype(float), rng.standard_normal(60))):
        p, r = binary.precision_recall_curve(y, s)
        sp, sr, _ = precision_recall_curve(y, s)
        np.testing.assert_array_equal(p, sp)
        np.testing.assert_array_equal(r, sr)
        assert abs(binary.pr_auc(y, s) - auc(sr, sp)) <= 1e-12
        assert abs(binary.avg_precision(y, s)
                   - average_precision_score(y, s)) <= 1e-12
        assert abs(binary.roc_auc(y, s) - roc_auc_score(y, s)) <= 1e-12
    assert np.isnan(binary.roc_auc(np.ones(4), np.arange(4.)))
    with pytest.raises(ValueError, match='threshold'):
        binary.f1(np.ones(4), np.arange(4.), threshold=2)


@pytest.mark.parametrize('family,link', [('gaussian', None),
                                         ('binomial', None),
                                         ('binomial', 'probit')])
@pytest.mark.parametrize('intercept', [False, True])
def test_glm_matches_jax(family, link, intercept):
    kind = 'gaussian' if family == 'gaussian' else 'binary'
    y, prs, c = data(kind, seed=2)
    x = np.column_stack([c, prs])
    got = glm.fit_linear_model(y, x, family=family, link=link,
                               add_intercept=intercept)
    want = jax_glm.fit_linear_model(y, x, family=family, link=link,
                                    add_intercept=intercept)
    np.testing.assert_allclose(got.params, want.params, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.predict(), want.predict(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.resid, want.resid, rtol=0, atol=1e-9)
    assert abs(got.llf - want.llf) <= 1e-9 * abs(want.llf)
    assert abs(got.rsquared - want.rsquared) <= 1e-9
    table = Table({f'x{i}': x[:, i] for i in range(x.shape[1])})
    np.testing.assert_array_equal(
        glm.fit_linear_model(y, table, family=family, link=link,
                             add_intercept=intercept).params, got.params)
    with pytest.raises(ValueError, match='family'):
        glm.fit_linear_model(y, x, family='poisson')
    with pytest.raises(ValueError, match='rows'):
        glm.fit_linear_model(y[:-1], x)


@pytest.mark.parametrize('r2,n', [(0.05, 500), (0.3, 120), (0.9, 10_000)])
def test_r2_stats_matches_jax(r2, n):
    got, want = port_eval.r2_stats(r2, n), jax_eval.r2_stats(r2, n)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-300), k
    with pytest.raises(ValueError, match='between 0 and 1'):
        port_eval.r2_stats(1.2, n)


def test_registry_matches_jax():
    assert list(port_eval.eval_metric_names) == \
        list(jax_eval.eval_metric_names)
    assert port_eval.eval_incremental_metrics == \
        jax_eval.eval_incremental_metrics
