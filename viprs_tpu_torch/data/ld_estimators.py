"""LD matrix estimation from genotype data (counterpart of
viprs_tpu.data.ld_estimators; the magenpy estimators {sample, windowed,
block, shrinkage} the reference consumes).

Each block's R = X'X / n is taken in float64 on the genotype's device
(``torch.matmul`` of the standardized genotypes) and returned as a host
numpy block, so that packing and ``save_ld_store`` take it as they take a
store's blocks. Per chromosome:

- ``sample``: one dense block (R = X'X/n);
- ``block``: blocks delimited by LDetect-style boundaries (or uniform
  chunks of ``max_block_size`` variants);
- ``windowed``: blocks cut at twice the window, entries beyond the window
  set to 0;
- ``shrinkage``: Wen-Stephens (2010) shrinkage of the block estimator's
  correlations by genetic-map distance.
"""

import numpy as np

from ..utils.table import read_table


def _corr(genotype, idx):
    """R = X'X / n of the variants ``idx`` (float64, on the genotype's
    device), as a host numpy array."""
    X = genotype.standardized_tensor(idx)
    with genotype.clock.device('product'):
        R = (X @ X.T) / X.shape[1]
    return R.cpu().numpy()


def read_ldetect_blocks(block_file):
    """Parse an LDetect block boundary file (columns: chr start stop, with
    a header line) into a Table whose chromosome column 'chr' holds the
    names without a 'chr' prefix, as strings."""
    t = read_table(block_file)
    t = t.rename({c: c.strip().lower() for c in t.columns})
    chrom_col = 'chr' if 'chr' in t else t.columns[0]
    t[chrom_col] = np.char.replace(t[chrom_col].astype(str), 'chr', '')
    return t.rename({chrom_col: 'chr'})


def _chrom_rows(genotype, c):
    return np.where(genotype.bim['CHR'] == c)[0]


def sample_ld(genotype, chrom=None):
    """Full sample correlation per chromosome: {chrom: [R]}"""
    out = {}
    for c in genotype.chromosomes if chrom is None else [chrom]:
        out[c] = [_corr(genotype, _chrom_rows(genotype, c))]
    return out


def block_ld(genotype, ldetect_blocks=None, max_block_size=4096):
    """Block-diagonal LD with LDetect boundaries (or uniform chunks of
    ``max_block_size`` variants when no boundary table is given)."""
    out = {}
    for c in genotype.chromosomes:
        idx = _chrom_rows(genotype, c)
        pos = genotype.bim['POS'][idx]
        if ldetect_blocks is not None:
            mine = ldetect_blocks['chr'].astype(str) == str(c)
            bounds = sorted(set(ldetect_blocks['start'][mine].tolist())
                            .union(ldetect_blocks['stop'][mine].tolist()))
            edges = np.searchsorted(pos, bounds)
            edges = sorted(set([0] + list(edges) + [len(idx)]))
        else:
            edges = sorted(set(list(range(0, len(idx), max_block_size))
                               + [len(idx)]))
        out[c] = [_corr(genotype, idx[lo:hi])
                  for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]
    return out


def windowed_ld(genotype, window_kb=1000):
    """Banded LD: correlations zeroed beyond ``window_kb``; emitted as blocks
    cut at window boundaries (each block spans <= 2x the window)."""
    out = {}
    for c in genotype.chromosomes:
        idx = _chrom_rows(genotype, c)
        pos = genotype.bim['POS'][idx].astype(np.float64)
        blocks = []
        lo = 0
        while lo < len(idx):
            hi = int(np.searchsorted(pos, pos[lo] + 2 * window_kb * 1e3))
            hi = max(hi, lo + 1)
            R = _corr(genotype, idx[lo:hi])
            d = np.abs(pos[lo:hi, None] - pos[None, lo:hi])
            R[d > window_kb * 1e3] = 0.0
            blocks.append(R)
            lo = hi
        out[c] = blocks
    return out


def shrinkage_ld(genotype, ldetect_blocks=None, genetic_map_cm=None,
                 n_eff=11418.0, m_ref=183, cutoff=1e-3, max_block_size=4096):
    """Wen-Stephens shrinkage estimator: r_jk * exp(-rho_jk) with
    rho_jk = 4 * n_eff * d_cM/100 / (2 * m_ref), hard-thresholded at
    ``cutoff``, the diagonal 1.

    :param genetic_map_cm: {chrom: per-variant genetic-map positions (cM)};
        falls back to 1 cM/Mb from base-pair positions.
    """
    raw = block_ld(genotype, ldetect_blocks, max_block_size=max_block_size)
    out = {}
    for c, blocks in raw.items():
        idx = _chrom_rows(genotype, c)
        if genetic_map_cm is not None:
            cm = np.asarray(genetic_map_cm[c], dtype=np.float64)
        else:
            cm = genotype.bim['POS'][idx].astype(np.float64) / 1e6
        shrunk = []
        lo = 0
        for R in blocks:
            m_b = R.shape[0]
            d = np.abs(cm[lo:lo + m_b, None] - cm[None, lo:lo + m_b])
            rho = 4.0 * n_eff * (d / 100.0) / (2.0 * m_ref)
            S = R * np.exp(-rho)
            S[np.abs(S) < cutoff] = 0.0
            np.fill_diagonal(S, 1.0)
            shrunk.append(S)
            lo += m_b
        out[c] = shrunk
    return out


ESTIMATORS = {
    'sample': sample_ld,
    'block': block_ld,
    'windowed': windowed_ld,
    'shrinkage': shrinkage_ld,
}
