"""viprs_evaluate_torch — predictive performance of polygenic scores.

The port's counterpart of viprs_tpu.cli.evaluate (``viprs_evaluate``), with
the same flags and output: join the PRS file (``viprs_score``'s FID IID
PRS...) with the phenotype (and covariates) on FID and IID, infer the
phenotype's likelihood, compute the metrics (``eval.eval_metric_names``)
with the standard errors of the R^2 ones, and write ``<prefix>.eval``. On
the host: numpy and scipy, no torch work.

    python -m viprs_tpu_torch.cli.evaluate --prs-file <prefix>.prs \\
        --phenotype-file <pheno> --output-file <prefix>
"""

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger("viprs_evaluate")


def build_parser():
    parser = argparse.ArgumentParser(
        prog='viprs_evaluate_torch',
        description="Evaluate PRS predictive performance against a phenotype "
                    "(the PyTorch/CUDA port of viprs_tpu).")
    parser.add_argument('--prs-file', dest='prs_file', required=True,
                        help="PRS file (FID IID PRS) from viprs_score.")
    parser.add_argument('--phenotype-file', dest='pheno_file', required=True,
                        help="Phenotype file (FID IID phenotype).")
    parser.add_argument('--phenotype-col', dest='pheno_col', type=int,
                        default=2)
    parser.add_argument('--phenotype-likelihood', dest='pheno_lik',
                        default='infer',
                        choices=['infer', 'gaussian', 'binomial'])
    parser.add_argument('--keep', dest='keep_file', default=None)
    parser.add_argument('--output-file', dest='output_file', required=True)
    parser.add_argument('--metrics', dest='metrics', nargs='+', default=None,
                        help="Metric names (see the eval registry); defaults "
                             "depend on the phenotype likelihood.")
    parser.add_argument('--covariates-file', dest='covariates_file',
                        default=None,
                        help="Covariates file (FID IID cov1 cov2 ...).")
    parser.add_argument('--log-level', dest='log_level', default='WARNING')
    return parser


DEFAULT_METRICS = {
    'gaussian': ['Pearson_R', 'R2', 'MSE'],
    'binomial': ['AUROC', 'AUPRC', 'McFadden_R2'],
}
DEFAULT_METRICS_COVARIATES = {
    'gaussian': ['Incremental_R2', 'Partial_Correlation'],
    'binomial': ['AUROC', 'Liability_R2', 'Nagelkerke_R2'],
}


def inner_join(left, right):
    """The rows of ``left`` and ``right`` (Tables) with equal FID and IID
    (compared as strings), in ``left``'s order, each left row once per
    match in ``right``'s order (pandas' inner merge); the columns of
    ``left``, then ``right``'s others."""
    from ..data.harmonize import _join_rows
    from ..utils.table import Table

    def keys(t):
        return np.char.add(np.char.add(t['FID'].astype(str), '\0'),
                           t['IID'].astype(str))
    li, ri = _join_rows(keys(left), keys(right), 'inner')
    cols = {k: v[li] for k, v in left.items()}
    cols.update({k: v[ri] for k, v in right.items()
                 if k not in ('FID', 'IID')})
    return Table(cols)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.WARNING))

    from .. import eval as eval_mod
    from ..eval.utils import infer_likelihood
    from ..utils.table import Table, read_table
    from .fit import read_keep_ids

    prs = read_table(args.prs_file)
    pheno = read_table(args.pheno_file, header=False)
    pheno = Table({'FID': pheno['0'], 'IID': pheno['1'],
                   'phenotype': pheno[str(args.pheno_col)]})
    merged = inner_join(prs, pheno)
    if args.keep_file:
        keep = read_keep_ids(args.keep_file)
        merged = merged.take(np.isin(merged['IID'].astype(str),
                                     np.asarray(sorted(keep), dtype=str)))

    y = np.asarray(merged['phenotype'], np.float64)
    merged = merged.take(~np.isnan(y))
    if len(merged) == 0:
        raise ValueError("No overlapping samples between PRS and phenotype.")

    covariates = None
    if args.covariates_file:
        cov = read_table(args.covariates_file, header=False)
        cov = cov.rename({'0': 'FID', '1': 'IID'})
        merged = inner_join(merged, cov)
        covariates = merged.select([c for c in merged.columns
                                    if c not in ('FID', 'IID', 'phenotype')
                                    and not c.startswith('PRS')])

    y, likelihood = infer_likelihood(merged['phenotype'], args.pheno_lik)
    logger.info("> Phenotype likelihood: %s", likelihood)

    if args.metrics:
        metrics = args.metrics
    elif covariates is not None:
        metrics = DEFAULT_METRICS_COVARIATES[likelihood]
    else:
        metrics = DEFAULT_METRICS[likelihood]

    registry = eval_mod.eval_metric_names
    prs_cols = [c for c in merged.columns if c.startswith('PRS')]
    rows = []
    for prs_col in prs_cols:
        pred = np.asarray(merged[prs_col], np.float64)
        for name in metrics:
            fn = registry.get(name)
            if fn is None:
                logger.warning("Unknown metric: %s (skipped)", name)
                continue
            try:
                if name in eval_mod.eval_incremental_metrics:
                    val = fn(y, pred, covariates)
                else:
                    val = fn(y, pred)
            except Exception as e:
                # a metric that cannot be computed on these data is
                # skipped, as the JAX package's CLI skips it
                logger.warning("Metric %s failed: %s", name, e)
                continue
            row = {'PRS': [prs_col], 'Metric': [name], 'Value': [val]}
            if 'R2' in name and np.isscalar(val) and 0 < val < 1:
                stats = eval_mod.r2_stats(float(val), len(y))
                row.update(SE=[stats['SE']], P_Value=[stats['P_Value']])
            rows.append(Table(row))

    fname = args.output_file if args.output_file.endswith('.eval') \
        else args.output_file + '.eval'
    Table.concat(rows).write(fname)
    print(f"viprs_evaluate_torch wrote {fname}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
