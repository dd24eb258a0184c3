"""LDPredInf — the infinitesimal (ridge) baseline model.

Counterpart of viprs_tpu.model.ldpred_inf.LDPredInf (reference
viprs/model/LDPredInf.py): solves (R + lam I) beta = beta_hat, lam =
M / (N h2), by conjugate gradient in float64 on the LD's device, the
matrix-vector product through the blocked LD operator
(``cavi_torch.compute_q``, which takes a float64 vector as the JAX package
does). The iteration and its stopping rule are those of
``jax.scipy.sparse.linalg.cg``: x0 = 0, stop once ||r|| <= max(tol ||b||,
atol) or after ``maxiter`` iterations.

Operates on standardized effect sizes (the framework's canonical scale).
"""

import numpy as np
import torch

from .base import BayesPRSModel
from ..ops.cavi_torch import compute_q

F64 = torch.float64


class LDPredInf(BayesPRSModel):
    """
    :ivar cg_iterations: CG iterations of the last fit.
    :ivar cg_relative_residual: ||r|| / ||b|| after the last fit, from the
        CG recurrence's residual.
    """

    def __init__(self, dataset, device, h2=None, float_precision='float32'):
        """
        :param dataset: a viprs_tpu_torch SummaryStatsDataset.
        :param device: the device the solve runs on; it must hold the
            dataset's LD.
        :param h2: heritability; the dataset's simple LDSC estimate, clipped
            to [1e-3, 1 - 1e-3], if omitted.
        :param float_precision: sets ``float_eps`` only, as in the JAX
            package (the solve is float64).
        """
        super().__init__(dataset, device, float_precision=float_precision)
        if h2 is None:
            from ..data.ldsc import simple_ldsc
            h2 = float(np.clip(simple_ldsc(dataset), 1e-3, 1 - 1e-3))
        self.h2 = h2
        self.cg_iterations = None
        self.cg_relative_residual = None

    def get_heritability(self):
        return self.h2

    def get_proportion_causal(self):
        return 1.0  # infinitesimal model: every variant is causal

    def fit(self, solver='cg', tol=1e-6, atol=0.0, maxiter=500):
        """Solve the ridge system (R + lam I) beta = std_beta on the
        device."""
        if solver != 'cg':
            raise ValueError(f"only the 'cg' solver is ported; got {solver!r}")
        lam = self.n_snps / (self.n * self.h2)
        lay, ld = self.dataset.layout, self.dataset.ld
        b = torch.from_numpy(lay.to_flat(self.std_beta).reshape(
            1, lay.nb, lay.block_size)).to(self.device, F64)
        mask = ld.mask[None].to(F64)

        def matvec(x):
            # R x + lam x, restricted to real variant lanes
            return (compute_q(ld, x) + (1.0 + lam) * x) * mask

        def vdot(u, v):
            return (u * v).sum()

        b = b * mask
        bs = vdot(b, b)
        atol2 = torch.maximum(tol ** 2 * bs,
                              torch.tensor(atol ** 2, dtype=F64,
                                           device=b.device))
        # x0 = 0, so r0 = b - A(0) = b exactly
        x, r, p = torch.zeros_like(b), b, b
        gamma = vdot(r, r)
        k = 0
        while k < maxiter and bool(gamma > atol2):
            Ap = matvec(p)
            alpha = gamma / vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            gamma_new = vdot(r, r)
            p = r + (gamma_new / gamma) * p
            gamma = gamma_new
            k += 1
        self.cg_iterations = k
        self.cg_relative_residual = float(torch.sqrt(gamma / bs))
        self._post_mean_beta = lay.from_flat(x.cpu().numpy().reshape(-1))
        return self
