"""Hyperparameter grid construction for grid-search VIPRS models.

A copy of viprs_tpu.gridsearch.grid (NumPy and SciPy only), so the port's
grids are the JAX package's to the bit; ``to_table`` imports pandas inside
the call.

Parity surface with the reference's gridsearch/HyperparameterGrid.py: the same
grid *math* is mandated (h2-informed sigma_epsilon/tau_beta grids from normal
percentiles of the (h2_est, h2_se) estimate, log-spaced pi grids bounded by
[10/M, min(1e4/M, 0.2)], lambda_min grids scaled by an empirical minimum
eigenvalue, Cartesian combination) — but the construction is organized
declaratively: each hyperparameter is an entry in a generator registry, and
the grid state is one name->values dict rather than four parallel attributes.
"""

import numpy as np

# Hyperparameters a grid can span, in the reference's column order.
GRID_PARAMS = ('sigma_epsilon', 'tau_beta', 'pi', 'lambda_min')


def h2_percentile_values(h2_est, h2_se, steps):
    """Heritability values at evenly spaced percentiles of the N(h2_est, h2_se)
    sampling distribution, clipped to the [10th, 90th] percentile window."""
    if steps <= 0:
        raise ValueError("steps must be positive")
    if not 0.0 < h2_est < 1.0:
        raise ValueError(f"h2_est must be in (0, 1); got {h2_est}")
    h2_se = h2_se if h2_se is not None else 0.5 * h2_est
    if h2_se <= 0:
        raise ValueError(f"h2_se must be positive; got {h2_se}")

    from scipy.stats import norm

    dist = norm(loc=h2_est, scale=h2_se)
    lo = max(0.1, dist.cdf(1e-5))
    hi = min(0.9, dist.cdf(1.0 - 1e-5))
    return dist.ppf(np.linspace(lo, hi, steps))


def pi_log_grid(n_snps, steps, max_pi=0.2):
    """Log-spaced pi grid over the reference's initialization bounds
    [max(10/M, 1e-5), min(1e4/M, max_pi)]."""
    if steps <= 0:
        raise ValueError("steps must be positive")
    lo = max(10.0 / n_snps, 1e-5)
    hi = min(1e4 / n_snps, max_pi)
    if lo >= hi:
        raise ValueError(f"degenerate pi bounds [{lo}, {hi}] at M={n_snps}")
    return np.logspace(np.log10(lo), np.log10(hi), steps)


def lambda_min_grid(steps, emp_lambda_min=None):
    """{0} followed by steps-1 log-spaced multipliers of the empirical minimum
    eigenvalue (or raw values when none is given)."""
    if steps <= 0:
        raise ValueError("steps must be positive")
    vals = np.concatenate([[0.0], np.logspace(-4, 1.0, steps - 1)])
    return vals if emp_lambda_min is None else vals * emp_lambda_min


class HyperparameterGrid:
    """Grid over (a subset of) sigma_epsilon / tau_beta / pi / lambda_min.

    Each parameter is either given explicitly (``<name>_grid=values``) or
    generated from a step count (``<name>_steps=k``) using the registry of
    generators above; unspecified parameters stay out of the grid (the model
    learns them in its M-step).

    :ivar h2_est, h2_se: heritability estimate (+SE) informing the
        sigma_epsilon / tau_beta generators.
    :ivar n_snps: variant count for scale-aware pi bounds.
    """

    def __init__(self, h2_est=None, h2_se=None, n_snps=1e6, **spec):
        self.h2_est = h2_est if h2_est is not None else 0.1
        self.h2_se = h2_se if h2_se is not None else 0.1
        self.n_snps = n_snps
        self._grids = {}   # name -> 1-D value array, insertion-ordered

        unknown = {k for k in spec
                   if not (k.endswith('_grid') or k.endswith('_steps'))
                   or k.rsplit('_', 1)[0] not in GRID_PARAMS}
        if unknown:
            raise TypeError(f"Unknown grid spec arguments: {sorted(unknown)}")

        for name in GRID_PARAMS:
            explicit = spec.get(f'{name}_grid')
            steps = spec.get(f'{name}_steps')
            if explicit is not None:
                self._grids[name] = np.asarray(explicit, dtype=np.float64)
            elif steps is not None:
                self._generate(name, steps)

    # ------------------------------------------------------------- generators
    def _generate(self, name, steps, **kwargs):
        if name == 'sigma_epsilon':
            values = 1.0 - h2_percentile_values(self.h2_est, self.h2_se, steps)
        elif name == 'tau_beta':
            # the reference's convention: ~1% of variants causal
            values = 0.01 * self.n_snps / h2_percentile_values(
                self.h2_est, self.h2_se, steps)
        elif name == 'pi':
            values = pi_log_grid(self.n_snps, steps, **kwargs)
        elif name == 'lambda_min':
            values = lambda_min_grid(steps, **kwargs)
        else:
            raise KeyError(name)
        self._grids[name] = values
        return values

    def generate_sigma_epsilon_grid(self, steps=5):
        self._generate('sigma_epsilon', steps)

    def generate_tau_beta_grid(self, steps=5):
        self._generate('tau_beta', steps)

    def generate_pi_grid(self, steps=5, max_pi=0.2):
        self._generate('pi', steps, max_pi=max_pi)

    def generate_lambda_min_grid(self, steps=5, emp_lambda_min=None):
        self._generate('lambda_min', steps, emp_lambda_min=emp_lambda_min)

    # ------------------------------------------------------------- accessors
    def __getattr__(self, name):
        # attribute-style access to the grid values (reference API surface):
        if name in GRID_PARAMS:
            return self.__dict__.get('_grids', {}).get(name)
        raise AttributeError(name)

    @property
    def n_models(self):
        n = 1
        for v in self._grids.values():
            n *= len(v)
        return n

    # ------------------------------------------------------------ combination
    def combine_grids(self):
        """Cartesian product of the active grids as a list of row dicts."""
        if not self._grids:
            raise ValueError("All the grids are empty!")
        names = list(self._grids)
        mesh = np.meshgrid(*(self._grids[n] for n in names), indexing='ij')
        flat = [m.reshape(-1) for m in mesh]
        return [dict(zip(names, row)) for row in zip(*flat)]

    def to_table(self):
        import pandas as pd
        return pd.DataFrame(self.combine_grids())
