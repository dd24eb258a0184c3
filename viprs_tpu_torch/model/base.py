"""BayesPRSModel — base class for summary-statistics Bayesian PRS models
(counterpart of viprs_tpu.model.base; the fit path only)."""

import numpy as np
import torch

from ..data.dataset import SummaryStatsDataset
from ..utils.compute import dict_max


class BayesPRSModel:
    """Holds the dataset, the marginal statistics and the posterior slots.

    ``pip``, ``post_mean_beta`` and ``post_var_beta`` ({chrom: array}, the
    array (m_c,) for one model and (m_c, S) for S model lanes) are lazy: a
    fit keeps the posterior on the device, and the first access copies all
    three to the host.
    """

    def __init__(self, dataset, device):
        if not isinstance(dataset, SummaryStatsDataset):
            raise TypeError("dataset must be a viprs_tpu_torch "
                            "SummaryStatsDataset")
        self.dataset = dataset
        self.device = torch.device(device)
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        if self.device != dataset.device:
            raise ValueError(f"the dataset's LD is on {dataset.device}, the "
                             f"model was asked for {self.device}")
        self.shapes = dict(dataset.shapes)
        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in dataset.n_per_snp.items()}
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in dataset.std_beta.items()}
        self._sample_size = dict_max(self.n_per_snp)
        self._pip = None
        self._post_mean_beta = None
        self._post_var_beta = None

    def _materialize_posterior_moments(self):
        """Fill the three posterior slots from the fitted state."""

    def _dict_view(self, flat):
        """(S, NB, B) tensor -> {chrom: (m_c,) numpy at S = 1, (m_c, S) at
        S > 1}."""
        lay = self.dataset.layout
        arr = flat.cpu().numpy().reshape(flat.shape[0], -1)[:, lay.flat_index]
        out, start = {}, 0
        for c, sz in zip(lay.chromosomes, lay.chrom_sizes):
            part = arr[:, start:start + sz]
            out[c] = part[0] if arr.shape[0] == 1 else part.T
            start += sz
        return out

    @property
    def pip(self):
        if self._pip is None:
            self._materialize_posterior_moments()
        return self._pip

    @property
    def post_mean_beta(self):
        if self._post_mean_beta is None:
            self._materialize_posterior_moments()
        return self._post_mean_beta

    @property
    def post_var_beta(self):
        if self._post_var_beta is None:
            self._materialize_posterior_moments()
        return self._post_var_beta

    @property
    def chromosomes(self):
        return sorted(self.shapes.keys())

    @property
    def m(self) -> int:
        return int(sum(self.shapes.values()))

    @property
    def n(self):
        return self._sample_size

    @property
    def n_snps(self) -> int:
        return self.m

    def get_pip(self):
        return self.pip

    def get_posterior_mean_beta(self):
        return self.post_mean_beta

    def get_posterior_variance_beta(self):
        return self.post_var_beta

    def to_table(self):
        """Posterior estimates of one model as one DataFrame (CHR, SNP, BETA,
        PIP, VAR_BETA); pandas is imported here only."""
        if getattr(self, '_S', 1) != 1:
            raise ValueError("to_table needs one model; select or average "
                             "the grid first (gridsearch)")
        import pandas as pd
        tabs = []
        for c in self.chromosomes:
            m_c = self.shapes[c]
            snps = (self.dataset.snp_table[c]['SNP'].values
                    if self.dataset.snp_table is not None
                    else [f'rs_{c}_{i}' for i in range(m_c)])
            tabs.append(pd.DataFrame({
                'CHR': c, 'SNP': snps, 'BETA': self.post_mean_beta[c],
                'PIP': self.pip[c], 'VAR_BETA': self.post_var_beta[c]}))
        return pd.concat(tabs, ignore_index=True)
