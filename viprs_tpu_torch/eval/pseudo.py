"""Summary-statistics-only (pseudo) validation metrics.

Counterpart of viprs_tpu.eval.pseudo: Corr(PRS, y) ~= r'b / sqrt(b'Sb),
where r are standardized marginal betas from an independent validation set,
b the PRS weights and S the LD matrix (Mak et al. 2017; Yang & Zhou 2020).
The models' ``pseudo_validate`` computes it from a PUMAS split
(``split_gwas_sumstats``) through ``_streamlined_pseudo_r2`` or its device
form, and over a separate test dataset through ``pseudo_r2``.
"""

import numpy as np
import torch


def _match_variant_stats(test_dataset, prs_beta_table):
    """Align a PRS table with a test dataset's variants by allele and compute
    the LD-weighted PRS weights S.b with the dataset's LD on its device.

    :param test_dataset: a SummaryStatsDataset (a GWADataLoader is packed
        on the card first).
    :param prs_beta_table: a Table with CHR, SNP, A1, A2 and BETA (or
        BETA_0, BETA_1, ...).
    :returns: (validation std betas, PRS betas, LD-weighted betas) arrays.
    """
    from ..data.harmonize import merge_snp_tables
    from ..ops.cavi_torch import compute_q

    if hasattr(test_dataset, 'to_summary_dataset'):
        test_dataset = test_dataset.to_summary_dataset()
    snp_tables = test_dataset.default_snp_table()
    for col in ('CHR', 'SNP', 'A1', 'A2'):
        if col not in prs_beta_table:
            raise ValueError(f"The PRS effect sizes table must contain a "
                             f"column named {col}.")
    if 'BETA' in prs_beta_table:
        beta_cols = ['BETA']
    else:
        beta_cols = [c for c in prs_beta_table.columns
                     if 'BETA' in c and 'VAR' not in c]
        if not beta_cols:
            raise ValueError("The PRS effect sizes table must contain a "
                             "column named BETA or BETA_0, BETA_1, etc.")

    per_chrom = {c: prs_beta_table.take(rows)
                 for c, rows in prs_beta_table.group_rows('CHR').items()}
    validation_beta, prs_beta_chr = [], {}
    for c in test_dataset.layout.chromosomes:
        validation_beta.append(np.asarray(test_dataset.std_beta[c],
                                          dtype=np.float64))
        if c in per_chrom:
            merged = merge_snp_tables(snp_tables[c].select(['SNP', 'A1', 'A2']),
                                      per_chrom[c], how='left',
                                      signed_statistics=beta_cols)
            vals = np.stack([np.asarray(merged[b], np.float64)
                             for b in beta_cols], axis=1)
            prs_beta_chr[c] = np.where(np.isnan(vals), 0.0, vals)
        else:
            prs_beta_chr[c] = np.zeros((test_dataset.shapes[c],
                                        len(beta_cols)))

    lay = test_dataset.layout
    n_cols = len(beta_cols)
    flat = np.stack([lay.to_flat({c: prs_beta_chr[c][:, i]
                                  for c in lay.chromosomes})
                     for i in range(n_cols)])
    beta = torch.from_numpy(flat.reshape(n_cols, lay.nb, lay.block_size))
    q = compute_q(test_dataset.ld, beta.to(test_dataset.device))
    q = q.cpu().numpy().reshape(n_cols, -1)
    beta_flat = flat.reshape(n_cols, -1)
    # ldw = S.b = q + b (q excludes the diagonal)
    ldw = q + beta_flat
    idx = lay.flat_index
    return (np.concatenate(validation_beta), beta_flat[:, idx].T,
            ldw[:, idx].T)


def pseudo_r2(test_dataset, prs_beta_table):
    """Squared pseudo correlation of a PRS table on a test dataset."""
    return pseudo_pearson_r(test_dataset, prs_beta_table) ** 2


def pseudo_pearson_r(test_dataset, prs_beta_table):
    """r'b / sqrt(b'Sb) per PRS column of a table on a test dataset."""
    std_beta, prs_beta, ldw = _match_variant_stats(test_dataset,
                                                   prs_beta_table)
    rb = np.sum(prs_beta * std_beta[:, None], axis=0)
    bsb = np.sum(prs_beta * ldw, axis=0)
    out = rb / np.sqrt(bsb)
    return out if out.size > 1 else float(out[0])


def _streamlined_pseudo_r2(validation_beta, prs_beta, ldw_prs_beta):
    """Pseudo-R^2 reusing precomputed LD-weighted betas (the model's cached q;
    reference pseudo_metrics.py:130-152)."""
    validation_beta = np.asarray(validation_beta)
    prs_beta = np.asarray(prs_beta)
    ldw_prs_beta = np.asarray(ldw_prs_beta)
    if prs_beta.ndim == 1:
        rb = np.sum(prs_beta * validation_beta)
        bsb = np.sum(prs_beta * ldw_prs_beta)
        return rb ** 2 / bsb
    rb = np.sum(prs_beta * validation_beta[:, None], axis=0)
    bsb = np.sum(prs_beta * ldw_prs_beta, axis=0)
    return rb ** 2 / bsb
