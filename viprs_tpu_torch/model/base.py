"""BayesPRSModel — base class for summary-statistics Bayesian PRS models
(counterpart of viprs_tpu.model.base: the fit path, the PUMAS split of the
marginal statistics and pseudo-validation)."""

import logging

import numpy as np
import torch

from ..data.dataset import SummaryStatsDataset
from ..utils.compute import dict_concat, dict_max

logger = logging.getLogger(__name__)


class BayesPRSModel:
    """Holds the dataset, the marginal statistics and the posterior slots.

    ``pip``, ``post_mean_beta`` and ``post_var_beta`` ({chrom: array}, the
    array (m_c,) for one model and (m_c, S) for S model lanes) are lazy: a
    fit keeps the posterior on the device, and the first access copies all
    three to the host.

    ``std_beta`` and ``n_per_snp`` start as the dataset's own arrays; a
    PUMAS split (``split_gwas_sumstats``) replaces them with the training
    half and sets ``validation_std_beta``, and ``restore_full_sumstats``
    puts the dataset's back. Models with device inputs rebuild them from
    these dicts at every fit (``_refresh_inputs``).
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
        self.validation_std_beta = None
        self._pip = None
        self._post_mean_beta = None
        self._post_var_beta = None

    # --------------------------------------------------------------- inputs
    def _refresh_inputs(self):
        """(Re)build the flat device inputs ``_std_beta_flat`` and
        ``_n_flat`` ((NB, B) float32) from the current ``std_beta`` /
        ``n_per_snp`` dicts. Where the dicts are still the dataset's own
        arrays, the dataset's cached tensors are taken, so a fit on unsplit
        statistics uploads nothing new."""
        if self._inputs_are_dataset_views():
            self._std_beta_flat, self._n_flat = self.dataset.device_inputs()
            return
        lay = self.dataset.layout

        def flat(d):
            return torch.from_numpy(lay.to_flat(d).reshape(
                lay.nb, lay.block_size)).to(self.device)
        self._std_beta_flat = flat(self.std_beta)
        self._n_flat = flat(self.n_per_snp)

    def _inputs_are_dataset_views(self):
        """True when std_beta/n_per_snp alias the dataset's own arrays
        (``np.asarray(x, float64)`` passes a float64 array through, possibly
        as a new view object, so the buffers are compared, not the
        objects)."""
        def same_buffer(a, b):
            a, b = np.asarray(a), np.asarray(b)
            return (a.dtype == b.dtype and a.shape == b.shape
                    and a.strides == b.strides
                    and a.__array_interface__['data'][0]
                    == b.__array_interface__['data'][0])
        ds = self.dataset
        try:
            return (self.validation_std_beta is None
                    and all(same_buffer(self.std_beta[c], ds.std_beta[c])
                            for c in ds.std_beta)
                    and all(same_buffer(self.n_per_snp[c], ds.n_per_snp[c])
                            for c in ds.n_per_snp))
        except (KeyError, TypeError):
            return False

    def set_validation_sumstats(self, sumstats):
        """Attach validation standardized betas for pseudo-validation: a
        {chrom: array} dict aligned with this model's variants. (The table
        form, harmonized by allele, needs the loaders: ROADMAP.md, Queue 1,
        item 6.)"""
        if not isinstance(sumstats, dict):
            raise NotImplementedError(
                "validation summary statistics as a table need allele "
                "harmonization (merge_snp_tables) and pandas, which are not "
                "ported yet; pass a {chrom: std_beta} dict aligned with the "
                "model's variants, or see ROADMAP.md, Queue 1, item 6")
        for c, sz in self.shapes.items():
            if c not in sumstats or len(sumstats[c]) != sz:
                raise ValueError(
                    f"validation std_beta for chromosome {c} is missing or "
                    f"has the wrong length")
        self.validation_std_beta = {c: np.asarray(sumstats[c], np.float64)
                                    for c in self.shapes}
        return self

    def split_gwas_sumstats(self, prop_train=0.8, seed=None, **kwargs):
        """PUMAS split of the marginal statistics (reference
        BayesPRSModel.py:151-187): ``std_beta`` becomes the training half,
        ``n_per_snp`` is scaled by ``prop_train`` and the held-out half
        becomes ``validation_std_beta`` (data/split.py)."""
        from ..data.split import sumstats_train_test_split
        logger.debug("> Splitting GWAS summary statistics (PUMAS), "
                     "prop_train=%s", prop_train)
        split = sumstats_train_test_split(self.dataset, prop_train=prop_train,
                                          seed=seed, **kwargs)
        self.std_beta = {c: split[c]['train_beta'] for c in self.chromosomes}
        self.n_per_snp = {c: self.n_per_snp[c] * prop_train
                          for c in self.chromosomes}
        self.validation_std_beta = {c: split[c]['test_beta']
                                    for c in self.chromosomes}

    def restore_full_sumstats(self):
        """Undo a PUMAS split (the selection flow refits the selected model
        on the full statistics; reference bin/viprs_fit:557-570)."""
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in self.dataset.std_beta.items()}
        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in self.dataset.n_per_snp.items()}
        self.validation_std_beta = None

    def _lane_pseudo_r2(self, eta, q):
        """(S,) pseudo-R^2 of lanes (S, NB, B) from the cached q (S.b =
        q + eta, reference pseudo_metrics.py:130-152): masked sums of eta*r
        and eta*(q + eta) on the device, float32 per block and float64
        across blocks; only the (S,) sums come to the host."""
        from ..ops import updates
        lay = self.dataset.layout
        r = torch.from_numpy(lay.to_flat(self.validation_std_beta).reshape(
            lay.nb, lay.block_size)).to(self.device)
        mask = self.dataset.ld.mask
        rb = updates.masked_sum(eta * r[None], mask)
        bsb = updates.masked_sum(eta * (q + eta), mask)
        rb, bsb = torch.stack([rb, bsb]).cpu().numpy()
        return rb ** 2 / bsb

    def pseudo_validate(self, test_gdl=None):
        """Summary-statistics-only R^2 on the held-out half of a PUMAS split
        (reference BayesPRSModel.py:375-410): r'b squared over b'Sb, with
        S.b from the model's cached q where it has one (``q_dict``), else
        from ``cavi_torch.compute_q`` of the posterior means on the LD's
        device. ``test_gdl`` (a separate test dataset) needs the loaders:
        ROADMAP.md, Queue 1, item 6."""
        from ..eval.pseudo import NEEDS_LOADERS, _streamlined_pseudo_r2
        if test_gdl is not None:
            raise NotImplementedError(NEEDS_LOADERS)
        if self.validation_std_beta is None:
            raise ValueError("Provide validation statistics "
                             "(set_validation_sumstats) or run "
                             "split_gwas_sumstats() first.")
        post = self.post_mean_beta
        if post is None:
            raise ValueError("The posterior means for BETA are not set. "
                             "Call `.fit()` first.")
        if hasattr(self, 'q_dict'):
            q = self.q_dict()
        else:
            from ..ops.cavi_torch import compute_q
            lay = self.dataset.layout
            beta = torch.from_numpy(lay.to_flat(post).reshape(
                1, lay.nb, lay.block_size)).to(self.device)
            q = lay.from_flat(compute_q(self.dataset.ld, beta)
                              .cpu().numpy().reshape(-1))
        ldw = {c: np.asarray(q[c]) + np.asarray(post[c]) for c in self.shapes}
        return _streamlined_pseudo_r2(dict_concat(self.validation_std_beta),
                                      dict_concat(post), dict_concat(ldw))

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
