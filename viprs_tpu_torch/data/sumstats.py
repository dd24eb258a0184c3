"""GWAS summary-statistics tables and file-format parsers (counterpart of
viprs_tpu.data.sumstats, on :class:`~viprs_tpu_torch.utils.table.Table`).

Supported formats (parity with ``viprs_fit --sumstats-format``):
plink1.9, plink2, cojo, magenpy, fastgwa, ssf (= gwas-ssf), gwascatalog, saige,
and ``custom`` via an explicit column mapping.
"""

import logging

import numpy as np

from ..utils.table import Table, read_table

logger = logging.getLogger(__name__)

# canonical column names:
CANONICAL = ['CHR', 'SNP', 'POS', 'A1', 'A2', 'MAF', 'N', 'BETA', 'SE', 'Z', 'P']

# per-format mapping {format: {file_column: canonical_column}}:
_FORMAT_MAPS = {
    'magenpy': {
        'CHR': 'CHR', 'SNP': 'SNP', 'POS': 'POS', 'A1': 'A1', 'A2': 'A2',
        'MAF': 'MAF', 'N': 'N', 'BETA': 'BETA', 'Z': 'Z', 'SE': 'SE', 'P': 'P',
    },
    'fastgwa': {
        'CHR': 'CHR', 'SNP': 'SNP', 'POS': 'POS', 'A1': 'A1', 'A2': 'A2',
        'N': 'N', 'AF1': 'MAF', 'BETA': 'BETA', 'SE': 'SE', 'P': 'P',
    },
    'plink1.9': {
        'CHR': 'CHR', 'SNP': 'SNP', 'BP': 'POS', 'A1': 'A1', 'A2': 'A2',
        'NMISS': 'N', 'BETA': 'BETA', 'OR': 'OR', 'SE': 'SE', 'STAT': 'Z',
        'T': 'Z', 'P': 'P',
    },
    'plink2': {
        '#CHROM': 'CHR', 'ID': 'SNP', 'POS': 'POS', 'A1': 'A1', 'REF': 'REF',
        'ALT': 'ALT', 'A2': 'A2', 'OBS_CT': 'N', 'BETA': 'BETA', 'SE': 'SE',
        'T_STAT': 'Z', 'Z_STAT': 'Z', 'P': 'P', 'A1_FREQ': 'MAF',
    },
    'cojo': {
        'SNP': 'SNP', 'A1': 'A1', 'A2': 'A2', 'freq': 'MAF', 'b': 'BETA',
        'se': 'SE', 'p': 'P', 'N': 'N',
    },
    'ssf': {
        'chromosome': 'CHR', 'variant_id': 'SNP', 'rsid': 'SNP',
        'base_pair_location': 'POS', 'effect_allele': 'A1',
        'other_allele': 'A2', 'beta': 'BETA', 'standard_error': 'SE',
        'effect_allele_frequency': 'MAF', 'p_value': 'P', 'n': 'N',
    },
    'gwascatalog': {
        'hm_chrom': 'CHR', 'hm_rsid': 'SNP', 'hm_pos': 'POS',
        'hm_effect_allele': 'A1', 'hm_other_allele': 'A2', 'hm_beta': 'BETA',
        'hm_effect_allele_frequency': 'MAF', 'standard_error': 'SE',
        'p_value': 'P', 'n': 'N',
    },
    'saige': {
        'CHR': 'CHR', 'MarkerID': 'SNP', 'POS': 'POS', 'Allele2': 'A1',
        'Allele1': 'A2', 'AF_Allele2': 'MAF', 'N': 'N', 'BETA': 'BETA',
        'SE': 'SE', 'p.value': 'P',
    },
}
_FORMAT_MAPS['gwas-ssf'] = _FORMAT_MAPS['ssf']


class SumstatsTable:
    """A harmonization-ready summary-statistics table for one or more
    chromosomes.

    Canonical columns: CHR SNP POS A1 A2 [MAF] N BETA [SE] Z [P]. Derived
    quantities follow the reference's magenpy surface:

    - ``z_score``: BETA/SE when Z is absent;
    - ``get_snp_pseudo_corr()``: standardized marginal beta r = z/sqrt(n + z^2);
    - ``n_per_snp``: per-variant sample size.
    """

    def __init__(self, table: Table):
        t = table.copy()
        if 'SNP' not in t:
            raise ValueError("Summary statistics must contain a SNP column.")
        if 'A1' not in t:
            raise ValueError("Summary statistics must contain the effect "
                             "allele (A1).")
        if 'Z' not in t or np.isnan(np.asarray(t['Z'], np.float64)).all():
            if 'BETA' in t and 'SE' in t:
                t['Z'] = t['BETA'] / t['SE']
            elif 'BETA' in t and 'P' in t:
                from scipy.stats import norm
                t['Z'] = np.sign(t['BETA']) * np.abs(norm.ppf(t['P'] / 2))
            else:
                raise ValueError("Cannot derive Z-scores: need (BETA, SE) or "
                                 "(BETA, P).")
        self.table = t

    def __len__(self):
        return len(self.table)

    @property
    def chromosomes(self):
        if 'CHR' in self.table:
            return sorted(np.unique(self.table['CHR']))
        return [0]

    @property
    def snps(self):
        return self.table['SNP']

    @property
    def a1(self):
        return self.table['A1']

    @property
    def a2(self):
        return self.table['A2'] if 'A2' in self.table else None

    @property
    def z_score(self):
        return np.asarray(self.table['Z'], dtype=np.float64)

    @property
    def marginal_beta(self):
        if 'BETA' in self.table:
            return np.asarray(self.table['BETA'], dtype=np.float64)
        return self.z_score / np.sqrt(self.n_per_snp)

    @property
    def n_per_snp(self):
        if 'N' in self.table:
            return np.asarray(self.table['N'], dtype=np.float64)
        raise ValueError("Per-SNP sample size (N) not available; "
                         "call set_sample_size() first.")

    def set_sample_size(self, n):
        """Set a scalar (or per-variant) GWAS sample size."""
        self.table['N'] = n

    def get_snp_pseudo_corr(self):
        """Standardized marginal beta: r = z / sqrt(n + z^2)."""
        z = self.z_score
        return z / np.sqrt(self.n_per_snp + z ** 2)

    def split_by_chromosome(self):
        if 'CHR' not in self.table:
            return {0: self}
        return {c: SumstatsTable(self.table.take(rows))
                for c, rows in self.table.group_rows('CHR').items()}

    def filter_snps(self, extract_snps):
        keep = np.isin(self.table['SNP'], np.asarray(list(extract_snps),
                                                     dtype=str))
        self.table = self.table.take(keep)
        return self

    def to_table(self, col_subset=None, per_chromosome=False):
        t = self.table
        if col_subset and 'STD_BETA' in col_subset:
            t = t.copy()
            t['STD_BETA'] = self.get_snp_pseudo_corr()
        out = t.select([c for c in (col_subset or t.columns) if c in t])
        if per_chromosome:
            return {c: out.take(rows)
                    for c, rows in out.group_rows('CHR').items()}
        return out


def read_sumstats(f_name, sumstats_format='magenpy', sep=None,
                  column_map=None, n=None) -> SumstatsTable:
    """Parse a summary-statistics file into a SumstatsTable.

    :param sumstats_format: one of the supported formats, or 'custom' with an
        explicit ``column_map`` {file_column: canonical_column}.
    :param sep: the field separator (default: runs of whitespace).
    :param n: fallback scalar GWAS sample size when the file lacks an N column.
    """
    if sumstats_format == 'custom':
        if not column_map:
            raise ValueError("custom format requires a column_map.")
        mapping = column_map
    elif sumstats_format in _FORMAT_MAPS:
        mapping = _FORMAT_MAPS[sumstats_format]
    else:
        raise ValueError(f"Unknown summary statistics format: "
                         f"{sumstats_format}")

    raw = read_table(f_name, sep=sep)
    # rename; a repeated canonical name (e.g. both T_STAT and Z_STAT mapped
    # to Z) keeps its first column:
    cols = {}
    for k, v in raw.items():
        cols.setdefault(mapping.get(k, k), v)
    df = Table(cols)

    # plink2: A2 is whichever of REF/ALT is not A1
    if sumstats_format == 'plink2' and 'A2' not in df \
            and all(c in df for c in ('REF', 'ALT', 'A1')):
        df['A2'] = np.where(df['A1'] == df['ALT'], df['REF'], df['ALT'])

    # odds ratios -> log-odds betas:
    if 'OR' in df and 'BETA' not in df:
        df['BETA'] = np.log(df['OR'])

    df = df.select([c for c in CANONICAL if c in df])
    if 'N' not in df:
        if n is None:
            raise ValueError(f"File {f_name} has no sample-size column; "
                             f"pass n=.")
        df['N'] = n
    return SumstatsTable(df)
