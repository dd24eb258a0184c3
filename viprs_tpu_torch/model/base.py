"""BayesPRSModel — base class for summary-statistics Bayesian PRS models
(counterpart of viprs_tpu.model.base: the fit path, the PUMAS split of the
marginal statistics, pseudo-validation, prediction on genotypes, allele-
aware harmonization of effect tables and their I/O)."""

import logging
import os.path as osp

import numpy as np
import torch

from ..data.dataset import SummaryStatsDataset
from ..utils.compute import dict_concat, dict_max

logger = logging.getLogger(__name__)


def history_table(history):
    """A model's ``history`` as a Table, a column per quantity and a row
    per entry; a quantity recorded per lane (S > 1) gives a column per
    lane, ``<name>_<lane>`` (the JAX package's DataFrame holds the (S,)
    rows in one object column). Quantities of unequal lengths raise, as
    pandas does."""
    from ..utils.table import Table
    cols = {}
    for name, vals in history.items():
        arr = np.asarray(vals)
        if arr.ndim <= 1:
            cols[name] = arr
        else:
            for s in range(arr.shape[1]):
                cols[f'{name}_{s}'] = arr[:, s]
    return Table(cols)


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

    def __init__(self, dataset, device, float_precision='float32'):
        """
        :param dataset: a viprs_tpu_torch SummaryStatsDataset.
        :param device: the device of the fit; it must hold the dataset's LD.
        :param float_precision: sets ``float_eps`` only, as in the JAX
            package: the state stays float32 whatever is passed.
        """
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
        self.float_precision = float_precision
        self.float_eps = np.finfo(float_precision).eps
        self.shapes = dict(dataset.shapes)
        self.initialize_input_data_arrays()
        self.validation_std_beta = None
        self._pip = None
        self._post_mean_beta = None
        self._post_var_beta = None

    @property
    def gdl(self):
        """The dataset (the reference API's name for it)."""
        return self.dataset

    # --------------------------------------------------------------- inputs
    def initialize_input_data_arrays(self):
        """(Re)set the marginal statistics ``std_beta`` and ``n_per_snp``
        from the dataset (reference BayesPRSModel.py:118-142); models with
        device inputs rebuild those too."""
        self.n_per_snp = {c: np.asarray(v, dtype=np.float64)
                          for c, v in self.dataset.n_per_snp.items()}
        self.std_beta = {c: np.asarray(v, dtype=np.float64)
                         for c, v in self.dataset.std_beta.items()}
        self._sample_size = dict_max(self.n_per_snp)
        if getattr(self, '_std_beta_flat', None) is not None:
            self._refresh_inputs()

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
        {chrom: array} dict aligned with this model's variants, or a
        SumstatsTable / Table with SNP, A1 and A2, harmonized by allele onto
        the dataset's variants (a flip changes the sign; a variant missing
        from the validation statistics contributes 0). A Table without a
        STD_BETA column needs ``get_snp_pseudo_corr`` (a SumstatsTable)."""
        if isinstance(sumstats, dict):
            for c, sz in self.shapes.items():
                if c not in sumstats or len(sumstats[c]) != sz:
                    raise ValueError(
                        f"validation std_beta for chromosome {c} is missing "
                        f"or has the wrong length")
            self.validation_std_beta = {c: np.asarray(sumstats[c], np.float64)
                                        for c in self.shapes}
            return self

        from ..data.harmonize import merge_snp_tables
        from ..utils.table import Table
        table = getattr(sumstats, 'table', sumstats)
        if not isinstance(table, Table):
            raise TypeError("validation summary statistics must be a "
                            "{chrom: std_beta} dict, a SumstatsTable or a "
                            "Table")
        table = table.copy()
        if 'STD_BETA' not in table:
            get_corr = getattr(sumstats, 'get_snp_pseudo_corr', None)
            if get_corr is None:
                raise ValueError("validation sumstats need a STD_BETA column "
                                 "or a get_snp_pseudo_corr() method")
            table['STD_BETA'] = get_corr()
        out = {}
        for c, tab in self.dataset.default_snp_table().items():
            merged = merge_snp_tables(tab.select(['SNP', 'A1', 'A2']), table,
                                      how='left',
                                      signed_statistics=['STD_BETA'])
            v = np.asarray(merged['STD_BETA'], np.float64)
            out[c] = np.where(np.isnan(v), 0.0, v)
        self.validation_std_beta = out
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
        """Summary-statistics-only R^2 (reference BayesPRSModel.py:375-410):
        r'b squared over b'Sb. With ``test_gdl`` (a GWADataLoader or a
        SummaryStatsDataset of independent statistics, which the loader
        packs on this model's device), ``eval.pseudo.pseudo_r2`` of this
        model's table on it; else on the held-out half of a PUMAS split (or
        ``set_validation_sumstats``), with S.b from the model's cached q
        where it has one (``q_dict``), else from ``cavi_torch.compute_q`` of
        the posterior means on the LD's device."""
        from ..eval.pseudo import _streamlined_pseudo_r2, pseudo_r2
        if test_gdl is not None:
            if hasattr(test_gdl, 'to_summary_dataset'):
                test_gdl = test_gdl.to_summary_dataset(device=self.device)
            return pseudo_r2(test_gdl, self.to_table())
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
        return self._lead_view(flat[0] if flat.shape[0] == 1 else flat)

    def _lead_view(self, x):
        """(..., NB, B) tensor -> {chrom: (m_c, ...) numpy}, the leading
        axes (lanes, components) after the variant axis."""
        lay = self.dataset.layout
        lead = tuple(x.shape[:-2])
        arr = x.reshape(-1, lay.nb * lay.block_size).cpu().numpy()[
            :, lay.flat_index]
        out, start = {}, 0
        for c, sz in zip(lay.chromosomes, lay.chrom_sizes):
            out[c] = arr[:, start:start + sz].T.reshape((sz,) + lead)
            start += sz
        return out

    @property
    def pip(self):
        if self._pip is None:
            self._materialize_posterior_moments()
        return self._pip

    @pip.setter
    def pip(self, value):
        self._pip = value

    @property
    def post_mean_beta(self):
        if self._post_mean_beta is None:
            self._materialize_posterior_moments()
        return self._post_mean_beta

    @post_mean_beta.setter
    def post_mean_beta(self, value):
        self._post_mean_beta = value

    @property
    def post_var_beta(self):
        if self._post_var_beta is None:
            self._materialize_posterior_moments()
        return self._post_var_beta

    @post_var_beta.setter
    def post_var_beta(self, value):
        self._post_var_beta = value

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

    # ---------------------------------------------------- what models define
    def fit(self, *args, **kwargs):
        raise NotImplementedError

    def get_proportion_causal(self):
        raise NotImplementedError

    def get_heritability(self):
        raise NotImplementedError

    def get_pip(self):
        return self.pip

    def get_posterior_mean_beta(self):
        return self.post_mean_beta

    def get_posterior_variance_beta(self):
        return self.post_var_beta

    def _theta_table(self, rows):
        """The (Parameter, Value) table of (name, value) pairs of one
        model."""
        if getattr(self, '_S', 1) != 1:
            raise ValueError("the hyperparameter table needs one model; "
                             "select or average the grid first (gridsearch)")
        from ..utils.table import Table
        return Table({'Parameter': [name for name, _ in rows],
                      'Value': np.asarray([float(np.asarray(v).reshape(-1)[0])
                                           for _, v in rows], np.float64)})

    def to_validation_table(self):
        """A grid's per-point fit outcomes (``validation_result``: the grid
        columns, ELBO, Converged, Optimization_message and, after selection
        by pseudo-validation, Pseudo_Validation_R2) as a Table."""
        from ..utils.table import Table
        result = getattr(self, 'validation_result', None)
        if not result:
            raise ValueError("Validation result is not set!")
        return Table(result)

    def write_validation_result(self, v_filename, sep="\t"):
        """Write ``to_validation_table()`` as delimited text (the CLI's
        .validation)."""
        self.to_validation_table().write(v_filename, sep=sep)

    def write_inferred_theta(self, f_name, sep="\t"):
        """Write ``to_theta_table()`` as delimited text (the CLI's .hyp)."""
        self.to_theta_table().write(f_name, sep=sep)

    def to_table(self, col_subset=('CHR', 'SNP', 'POS', 'A1', 'A2'),
                 per_chromosome=False):
        """Posterior estimates of one model as a Table (the columns of
        ``col_subset`` the variant tables have, then BETA, PIP, VAR_BETA),
        or {chrom: Table} (reference BayesPRSModel.py:333-373)."""
        if getattr(self, '_S', 1) != 1:
            raise ValueError("to_table needs one model; select or average "
                             "the grid first (gridsearch)")
        return self._posterior_tables(col_subset, per_chromosome)

    def _posterior_tables(self, col_subset=('CHR', 'SNP', 'POS', 'A1', 'A2'),
                          per_chromosome=False):
        """``to_table`` for any number of lanes: S lanes give the columns
        BETA_0 .. BETA_{S-1}, PIP_i and VAR_BETA_i (the JAX package's grid
        tables)."""
        from ..utils.table import Table
        if self.post_mean_beta is None:
            raise ValueError("The posterior means for BETA are not set. "
                             "Call `.fit()` first.")
        snp_tables = self.dataset.default_snp_table()
        tables = {}
        for c in self.chromosomes:
            base = snp_tables[c]
            tab = base.select([col for col in col_subset if col in base])
            if 'CHR' not in tab:
                tab.insert(0, 'CHR', c)
            for name, d in (('BETA', self.post_mean_beta), ('PIP', self.pip),
                            ('VAR_BETA', self.post_var_beta)):
                if d is None:
                    continue
                v = np.asarray(d[c])
                v = v.reshape(len(v), -1)
                cols = [name] if v.shape[1] == 1 else \
                    [f'{name}_{i}' for i in range(v.shape[1])]
                for i, col in enumerate(cols):
                    tab[col] = v[:, i]
            tables[c] = tab
        if per_chromosome:
            return tables
        return Table.concat(tables[c] for c in self.chromosomes)

    # ------------------------------------------------------------ prediction
    def predict(self, test_gdl=None):
        """Linear scoring (genotype . beta) of the samples of ``test_gdl``
        (a GWADataLoader with genotypes): the posterior means harmonized by
        allele onto its variants, scored on its genotype's device. (n,) for
        one model, (n, S) for S lanes."""
        if self.post_mean_beta is None:
            raise ValueError("The posterior means for BETA are not set. "
                             "Call `.fit()` first.")
        if test_gdl is None:
            test_gdl = self.dataset
            post_mean_beta = self.post_mean_beta
        else:
            _, post_mean_beta, _ = self.harmonize_data(gdl=test_gdl)
        score = getattr(test_gdl, 'score', None) or \
            getattr(test_gdl, 'predict', None)
        if score is None:
            raise ValueError("The provided data object does not support "
                             "scoring (no genotype data attached).")
        return score(post_mean_beta)

    def harmonize_data(self, gdl=None, parameter_table=None):
        """Align posterior effect sizes with another dataset's variants,
        flipping the signs of the BETA columns where the alleles are
        swapped (reference BayesPRSModel.py:252-331). ``parameter_table``
        (a Table with CHR, SNP, A1, A2 and BETA/PIP/VAR_BETA columns)
        defaults to this model's posterior; ``gdl`` to its dataset.
        Returns (pip, post_mean_beta, post_var_beta) dicts over the
        chromosomes both have (pip and post_var_beta None where the table
        has no such column); a variant of ``gdl`` the table lacks gets 0."""
        from ..data.harmonize import merge_snp_tables
        if gdl is None and parameter_table is None:
            return None
        if gdl is None:
            gdl = self.dataset
        if parameter_table is None:
            parameter_table = self._posterior_tables(per_chromosome=True)
        else:
            parameter_table = {c: parameter_table.take(rows) for c, rows in
                               parameter_table.group_rows('CHR').items()}
        snp_tables = gdl.snp_table \
            if getattr(gdl, 'snp_table', None) is not None \
            else gdl.default_snp_table()

        pip, post_mean_beta, post_var_beta = {}, {}, {}
        for c in sorted(set(snp_tables).intersection(parameter_table)):
            ptab = parameter_table[c]
            pip_cols = [col for col in ptab.columns if 'PIP' in col]
            var_cols = [col for col in ptab.columns if 'VAR_BETA' in col]
            mean_cols = [col for col in ptab.columns
                         if 'BETA' in col and col not in var_cols]
            merged = merge_snp_tables(
                snp_tables[c].select(['SNP', 'A1', 'A2']), ptab, how='left',
                signed_statistics=mean_cols)
            if len(merged) < len(snp_tables[c]):
                raise ValueError(
                    "The parameter table could not be aligned with the "
                    "reference SNP table; check reference vs. alternative "
                    "allele assignments.")

            def stack(cols):
                v = np.column_stack([np.asarray(merged[k], np.float64)
                                     for k in cols])
                return np.where(np.isnan(v), 0.0, v).squeeze()
            post_mean_beta[c] = stack(mean_cols)
            if pip_cols:
                pip[c] = stack(pip_cols)
            if var_cols:
                post_var_beta[c] = stack(var_cols)
        return pip or None, post_mean_beta, post_var_beta or None

    # --------------------------------------------------------- parameter I/O
    def set_model_parameters(self, parameter_table):
        """Set the posterior slots from a parameter Table (a .fit file's
        columns), harmonized onto this model's variants."""
        self.pip, self.post_mean_beta, self.post_var_beta = \
            self.harmonize_data(parameter_table=parameter_table)

    def read_inferred_parameters(self, f_names, sep=r"\s+"):
        """Read .fit files (delimited text with a header line) into the
        posterior slots (``set_model_parameters``)."""
        from ..utils.table import Table, read_table
        if isinstance(f_names, str):
            f_names = [f_names]
        tables = [read_table(f, sep=sep) for f in f_names]
        if not tables:
            raise FileNotFoundError("no parameter files given")
        self.set_model_parameters(Table.concat(tables))

    def write_inferred_parameters(self, f_name, per_chromosome=False,
                                  sep="\t"):
        """Write ``to_table()`` as ``f_name`` (+ '.fit' unless the name has
        it), or one ``chr_<c>.fit`` a chromosome in the directory
        ``f_name``."""
        tables = self.to_table(per_chromosome=per_chromosome)
        if per_chromosome:
            for c, tab in tables.items():
                tab.write(osp.join(f_name, f'chr_{c}.fit'), sep=sep)
        else:
            ext = '' if '.fit' in f_name else '.fit'
            tables.write(f_name + ext, sep=sep)
