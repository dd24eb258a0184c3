"""PUMAS-style summary-statistics train/validation splitting (Zhao et al.
2021), its factorizations on the LD's device.

Counterpart of viprs_tpu.data.split: subsample GWAS summary statistics
without individual-level data,

    beta_train ~ N(beta_hat, (1/n_t - 1/n) * Sigma),   n_t = prop_train * n
    beta_test  = (n * beta_hat - n_t * beta_train) / (n - n_t)

with LD-correlated noise from per-block Cholesky factors of the diagonal
LD tiles (independent noise where a block is not positive definite even
after jitter). The noise ``z`` of a chromosome is drawn with numpy once,
before its tile loop, so a seed gives both packages the same split. The
tiles are factorized where the LD lives, ``CHOL_CHUNK`` at a time in
float64 (batched ``torch.linalg.cholesky_ex``; the JAX package converts a
chromosome's tiles to float64 at once, 9.5 GB for the 1.1M-variant
genome's int8 LD). Each tile's padding lanes are set to the identity, so
that its real variants' factor is that of their submatrix, and a tile that
fails goes down the jitter ladder alone.
"""

import numpy as np
import torch

#: The jitter ladder of a tile's factorization (the JAX package's
#: ``_block_chol``): each step adds j * I, j relative to ``JITTER``.
JITTER, LADDER = 1e-3, (0.0, 1.0, 10.0, 100.0)
#: Diagonal tiles factorized at a time (8 MB of float64 each at B = 1024).
CHOL_CHUNK = 32


def _correlate(ld, b0, b1, z_tiles):
    """L_b z_b for tiles b0..b1: z_tiles (n, B) float64 numpy, zero on
    padding lanes; returns (n, B) numpy, z itself on a tile no step of the
    ladder factorizes."""
    f64, dev = torch.float64, ld.diag.device
    eye = torch.eye(ld.block_size, dtype=f64, device=dev)
    out = np.empty_like(z_tiles)
    for i in range(b0, b1, CHOL_CHUNK):
        j1 = min(i + CHOL_CHUNK, b1)
        real = ld.mask[i:j1] > 0
        pair = real[:, :, None] & real[:, None, :]
        R = torch.where(pair, ld.diag[i:j1].to(f64) * ld.scale,
                        eye * (~real[:, :, None]))
        z = torch.from_numpy(z_tiles[i - b0:j1 - b0]).to(dev)
        y = z.clone()
        todo = torch.arange(j1 - i, device=dev)
        for step in LADDER:
            if todo.numel() == 0:
                break
            L, info = torch.linalg.cholesky_ex(
                R[todo] + (step * JITTER) * eye)
            ok = info == 0
            y[todo[ok]] = (L[ok] @ z[todo[ok], :, None])[..., 0]
            todo = todo[~ok]
        out[i - b0:j1 - b0] = y.cpu().numpy()
    return out


def sumstats_train_test_split(dataset, prop_train=0.8, seed=None,
                              ld_aware=True):
    """Split the dataset's standardized betas into train/test pseudo-replicates.

    :param dataset: a viprs_tpu_torch SummaryStatsDataset (its LD on any
        device).
    :param prop_train: fraction of the GWAS sample assigned to training.
    :param ld_aware: correlate the noise within each diagonal LD tile.
    :returns: {chrom: {'train_beta': ..., 'test_beta': ...}}, float64.
    """
    rng = np.random.default_rng(seed)
    lay, ld = dataset.layout, dataset.ld
    B = lay.block_size
    out = {}
    start = 0
    for ci, c in enumerate(lay.chromosomes):
        beta = np.asarray(dataset.std_beta[c], dtype=np.float64)
        n = np.asarray(dataset.n_per_snp[c], dtype=np.float64)
        m_c = len(beta)
        n_t = prop_train * n
        var_scale = np.maximum(1.0 / n_t - 1.0 / n, 0.0)

        z = rng.standard_normal(m_c)
        if ld_aware:
            b0, b1 = lay.chrom_block_range[ci]
            # chromosome-local indices -> positions within its first block
            idx = lay.flat_index[start:start + m_c] - b0 * B
            z_tiles = np.zeros((b1 - b0) * B)
            z_tiles[idx] = z
            z = _correlate(ld, b0, b1, z_tiles.reshape(b1 - b0, B)
                           ).reshape(-1)[idx]
        start += m_c

        noise = np.sqrt(var_scale) * z
        train_beta = beta + noise
        test_beta = (n * beta - n_t * train_beta) / (n - n_t)
        out[c] = {'train_beta': train_beta, 'test_beta': test_beta}
    return out
