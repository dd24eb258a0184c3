"""Minimal GLM fitting (OLS / logistic / probit) with numpy and scipy
(counterpart of viprs_tpu.eval.glm, the same steps: least squares for
OLS, scipy's L-BFGS-B on the binomial negative log-likelihood). The
surface downstream metrics read: ``.params``, ``.predict()``, ``.resid``,
``.rsquared``, ``.llf``.
"""

import dataclasses

import numpy as np
from scipy import optimize, stats

from ..utils.table import Table


@dataclasses.dataclass
class GLMResult:
    params: np.ndarray
    fitted: np.ndarray        # linear predictor for OLS; probabilities for binomial
    y: np.ndarray
    llf: float
    family: str

    @property
    def resid(self):
        return self.y - self.fitted

    @property
    def rsquared(self):
        sst = np.sum((self.y - self.y.mean()) ** 2)
        ssr = np.sum((self.y - self.fitted) ** 2)
        return 1.0 - ssr / sst if sst > 0 else 0.0

    def predict(self, X=None):
        return self.fitted


def as_matrix(x):
    """A float64 design matrix from an array (1-D: one column) or a Table
    (its columns in order)."""
    if isinstance(x, Table):
        return np.column_stack([np.asarray(v, np.float64)
                                for _, v in x.items()])
    return np.asarray(x, dtype=np.float64)


def _design(x, add_intercept):
    X = as_matrix(x)
    if X.ndim == 1:
        X = X[:, None]
    if add_intercept:
        X = np.column_stack([np.ones(X.shape[0]), X])
    return X


def fit_ols(y, x, add_intercept=False):
    y = np.asarray(y, dtype=np.float64)
    X = _design(x, add_intercept)
    params, *_ = np.linalg.lstsq(X, y, rcond=None)
    fitted = X @ params
    n = len(y)
    sigma2 = max(np.mean((y - fitted) ** 2), 1e-300)
    llf = -0.5 * n * (np.log(2 * np.pi * sigma2) + 1.0)
    return GLMResult(params=params, fitted=fitted, y=y, llf=llf,
                     family='gaussian')


def _binom_nll(params, X, y, link):
    z = X @ params
    if link == 'logit':
        nll = np.sum(np.logaddexp(0.0, z) - y * z)
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
        grad = X.T @ (p - y)
    else:  # probit
        z = np.clip(z, -8, 8)
        p = np.clip(stats.norm.cdf(z), 1e-12, 1 - 1e-12)
        nll = -np.sum(y * np.log(p) + (1 - y) * np.log1p(-p))
        pdf = stats.norm.pdf(z)
        grad = -X.T @ (pdf * (y - p) / (p * (1 - p)))
    return nll, grad


def fit_binomial(y, x, link='logit', add_intercept=False):
    y = np.asarray(y, dtype=np.float64)
    X = _design(x, add_intercept)
    x0 = np.zeros(X.shape[1])
    res = optimize.minimize(_binom_nll, x0, args=(X, y, link), jac=True,
                            method='L-BFGS-B', options={'maxiter': 500})
    params = res.x
    z = X @ params
    if link == 'logit':
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
    else:
        p = np.clip(stats.norm.cdf(np.clip(z, -8, 8)), 1e-12, 1 - 1e-12)
    llf = float(np.sum(y * np.log(np.clip(p, 1e-12, None))
                       + (1 - y) * np.log(np.clip(1 - p, 1e-12, None))))
    return GLMResult(params=params, fitted=p, y=y, llf=llf, family='binomial')


def fit_linear_model(y, x, family='gaussian', link=None, add_intercept=False):
    """Fit y on the design ``x`` (a 2-D array, a 1-D array or a Table):
    OLS for 'gaussian', logit or probit for 'binomial'."""
    if family not in ('gaussian', 'binomial'):
        raise ValueError("The family must be either 'gaussian' or "
                         "'binomial'.")
    y = np.asarray(y, dtype=np.float64)
    x = as_matrix(x)
    if y.shape[0] != x.shape[0]:
        raise ValueError("The number of rows in the design matrix and the "
                         "response must match.")
    if family == 'gaussian':
        return fit_ols(y, x, add_intercept=add_intercept)
    if link not in ('logit', 'probit', None):
        raise ValueError(f"link must be 'logit' or 'probit'; got {link!r}")
    return fit_binomial(y, x, link=link or 'logit',
                        add_intercept=add_intercept)
