"""viprs_score_torch — polygenic scores of individuals from inferred effect
sizes, on the card.

The port's counterpart of viprs_tpu.cli.score (``viprs_score``), with the
same flags and output: read plink BED filesets and ``.fit`` files,
harmonize the effect sizes by allele onto the genotypes' variants, score
genotype . beta, and write FID, IID and PRS (``PRS_<i>`` for several BETA
columns) to ``<prefix>.prs`` (``.prs.gz`` with ``--compress``). The
genotypes are decoded and the products taken on ``--device`` (default
``cuda``; without CUDA the command fails unless ``--device cpu`` was asked
for). numpy, the standard library and torch only.

    python -m viprs_tpu_torch.cli.score -f <prefix>.fit.gz \\
        --bed-files <bed prefix or glob> --output-file <prefix> [--device cpu]
"""

import argparse
import logging
import re
import sys
import time

import numpy as np

logger = logging.getLogger("viprs_score")


def build_parser():
    parser = argparse.ArgumentParser(
        prog='viprs_score_torch',
        description="Compute polygenic scores from inferred effect sizes "
                    "(the PyTorch/CUDA port of viprs_tpu).")
    parser.add_argument('-f', '--fit-files', dest='fit_files', required=True,
                        nargs='+',
                        help="Path(s) to .fit files from viprs_fit.")
    parser.add_argument('--bfile', '--bed-files', dest='bed_files',
                        required=True, nargs='+',
                        help="Path(s)/glob of plink BED fileset(s) to score "
                             "(e.g. one per chromosome).")
    parser.add_argument('--output-file', dest='output_file', required=True)
    parser.add_argument('--keep', dest='keep_file', default=None,
                        help="File listing sample IDs to keep.")
    parser.add_argument('--extract', dest='extract_file', default=None,
                        help="File listing variant IDs to use.")
    parser.add_argument('--compress', dest='compress', action='store_true')
    parser.add_argument('--temp-dir', dest='temp_dir', default='temp',
                        help="Accepted for reference compatibility.")
    parser.add_argument('--backend', dest='backend', default='native',
                        help="Accepted for reference compatibility; genotype "
                             "IO is native.")
    parser.add_argument('--threads', dest='threads', type=int, default=1,
                        help="Accepted for reference compatibility.")
    parser.add_argument('--device', dest='device', default='cuda',
                        help="Device that decodes and scores the genotypes: "
                             "'cuda' (default; fails without CUDA) or 'cpu'.")
    parser.add_argument('--log-level', dest='log_level', default='WARNING')
    return parser


def _read_extract(path):
    """The variant IDs of an --extract file: the first comma-separated
    field of each line (headerless)."""
    with open(path) as f:
        return [line.rstrip('\r\n').split(',')[0] for line in f
                if line.strip()]


def run(argv=None):
    """viprs_score on the port: parse ``argv``, score and write. Returns a
    record of the run: the seconds of each stage (``seconds``: 'tables' the
    .bim/.fam read, 'fit_read', 'harmonize', 'bed_read', 'upload',
    'decode' (decoding and standardization), 'product', 'write', 'total'),
    the variants matched, the output file and the device."""
    from .fit import read_keep_ids, resolve_device
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.WARNING))
    device = resolve_device(args.device)

    from ..data.genotype import open_genotypes
    from ..data.harmonize import merge_snp_tables
    from ..utils.system import get_filenames
    from ..utils.table import Table, read_table

    t_start = time.perf_counter()
    keep = read_keep_ids(args.keep_file) if args.keep_file else None
    extract = _read_extract(args.extract_file) if args.extract_file else None

    logger.info("> Loading genotype data...")
    prefixes = sorted({re.sub(r'\.(bed|bim|fam)$', '', f)
                       for f in get_filenames(args.bed_files)})
    genotype = open_genotypes(prefixes, keep_samples=keep,
                              extract_snps=extract, device=device)

    logger.info("> Loading inferred parameters...")
    t0 = time.perf_counter()
    fit_tables = Table.concat(read_table(f) for f in args.fit_files)
    t_fit = time.perf_counter() - t0
    beta_cols = [c for c in fit_tables.columns
                 if 'BETA' in c and 'VAR' not in c]
    if not beta_cols:
        raise ValueError("The fit files must contain BETA columns.")

    t0 = time.perf_counter()
    merged = merge_snp_tables(genotype.bim.select(['SNP', 'A1', 'A2']),
                              fit_tables, how='left',
                              signed_statistics=beta_cols)
    beta = np.column_stack([np.asarray(merged[c], np.float64)
                            for c in beta_cols])
    n_matched = int((~np.isnan(beta[:, 0])).sum())
    beta = np.where(np.isnan(beta), 0.0, beta)
    t_harm = time.perf_counter() - t0
    logger.info("> Matched %d of %d scoring variants.", n_matched,
                len(fit_tables))
    if n_matched == 0:
        raise ValueError("No variants in the fit files matched the genotype "
                         "data.")

    logger.info("> Scoring...")
    prs = genotype.score(beta)

    t0 = time.perf_counter()
    out = genotype.fam.select(['FID', 'IID'])
    prs2 = np.atleast_2d(np.asarray(prs).T).T
    if prs2.shape[1] == 1:
        out['PRS'] = prs2[:, 0]
    else:
        for i in range(prs2.shape[1]):
            out[f'PRS_{i}'] = prs2[:, i]
    fname = args.output_file
    if args.compress and not fname.endswith('.gz'):
        fname = fname + '.prs.gz'
    elif not fname.endswith(('.prs', '.gz')):
        fname = fname + '.prs'
    out.write(fname)
    t_write = time.perf_counter() - t0
    print(f"viprs_score_torch wrote {fname}")

    seconds = genotype.timings
    seconds.update(fit_read=t_fit, harmonize=t_harm, write=t_write,
                   total=time.perf_counter() - t_start)
    return {'seconds': seconds, 'matched': n_matched, 'n': genotype.n,
            'm': genotype.m, 'output': fname, 'device': str(device)}


def main(argv=None):
    run(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
