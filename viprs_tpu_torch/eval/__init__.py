"""Evaluation metrics of the port (lazy exports: importing the package
loads no model code and no scipy). ``eval_metric_names`` maps the
``viprs_evaluate`` metric names to their functions;
``eval_incremental_metrics`` lists those that take covariates."""

_EXPORTS = {'pseudo_r2': 'pseudo', 'pseudo_pearson_r': 'pseudo',
            'r2_stats': 'utils', 'fit_linear_model': 'glm',
            **{f: 'continuous' for f in (
                'r2', 'mse', 'spearman_r', 'pearson_r',
                'r2_residualized_target', 'incremental_r2',
                'partial_correlation')},
            **{f: 'binary' for f in (
                'roc_auc', 'pr_auc', 'avg_precision', 'f1', 'mcfadden_r2',
                'cox_snell_r2', 'nagelkerke_r2', 'liability_r2',
                'liability_probit_r2', 'liability_logit_r2')}}

#: metric name -> function name (parity: viprs/eval/__init__.py:6-38)
_METRICS = {
    'Pearson_R': 'pearson_r',
    'Spearman_R': 'spearman_r',
    'MSE': 'mse',
    'R2': 'r2',
    'R2_residualized_target': 'r2_residualized_target',
    'Incremental_R2': 'incremental_r2',
    'Partial_Correlation': 'partial_correlation',
    'AUROC': 'roc_auc',
    'AUPRC': 'pr_auc',
    'Avg_Precision': 'avg_precision',
    'F1_Score': 'f1',
    'Liability_R2': 'liability_r2',
    'Liability_Probit_R2': 'liability_probit_r2',
    'Liability_Logit_R2': 'liability_logit_r2',
    'Nagelkerke_R2': 'nagelkerke_r2',
    'CoxSnell_R2': 'cox_snell_r2',
    'McFadden_R2': 'mcfadden_r2',
}

# Metrics that accept (or require) covariates:
eval_incremental_metrics = [
    'Incremental_R2',
    'R2_residualized_target',
    'Partial_Correlation',
    'Liability_R2',
    'Liability_Probit_R2',
    'Liability_Logit_R2',
    'Nagelkerke_R2',
    'CoxSnell_R2',
    'McFadden_R2',
]

__all__ = list(_EXPORTS) + ['eval_metric_names', 'eval_incremental_metrics']


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f'.{_EXPORTS[name]}', __name__),
                       name)
    if name == 'eval_metric_names':
        return {k: __getattr__(f) for k, f in _METRICS.items()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
