"""Summary-statistics-only (pseudo) validation metrics.

Counterpart of viprs_tpu.eval.pseudo: Corr(PRS, y) ~= r'b / sqrt(b'Sb),
where r are standardized marginal betas from an independent validation set,
b the PRS weights and S the LD matrix (Mak et al. 2017; Yang & Zhou 2020).
The models' ``pseudo_validate`` computes it from a PUMAS split
(``split_gwas_sumstats``) through ``_streamlined_pseudo_r2`` or its device
form. The metrics over a separate test dataset need the loaders and allele
harmonization, which are not ported yet (ROADMAP.md, Queue 1, item 6).
"""

import numpy as np

NEEDS_LOADERS = ("pseudo-validation against a separate test dataset needs "
                 "the loaders and allele harmonization, which are not ported "
                 "yet; see ROADMAP.md, Queue 1, item 6")


def pseudo_r2(test_dataset, prs_beta_table):
    """Squared pseudo correlation of a PRS table on a test dataset."""
    raise NotImplementedError(NEEDS_LOADERS)


def pseudo_pearson_r(test_dataset, prs_beta_table):
    """r'b / sqrt(b'Sb) per PRS column of a table on a test dataset."""
    raise NotImplementedError(NEEDS_LOADERS)


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
