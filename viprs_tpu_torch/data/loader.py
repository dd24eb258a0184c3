"""GWADataLoader — from files on disk to the device-facing dataset.

Counterpart of viprs_tpu.data.loader: LD stores (native ``chr_<c>.npz``
stores and magenpy Zarr stores), summary statistics files and plink BED
genotypes in; summary statistics harmonized by allele, filtered, packed
(through the packed-LD cache) and uploaded as a
:class:`~viprs_tpu_torch.data.dataset.SummaryStatsDataset`. numpy and the
standard library on the host: the variant tables are
:class:`~viprs_tpu_torch.utils.table.Table`. Genotypes (``bed_files``) are
decoded on ``device`` (the card unless the caller asks for the CPU), where
``compute_ld``, ``perform_gwas`` and ``score`` take their products.

The LD data loads lazily: construction reads only the stores' variant
tables; the LD itself is read when the dataset is packed, and never when
the pack cache hits. Stores without variant tables are read at once (the
eager path).
"""

import logging
import os
import os.path as osp
import re
import time

import numpy as np

from . import ld_estimators
from . import ld_store as ld_store_mod
from .dataset import SummaryStatsDataset
from .harmonize import merge_snp_tables
from .sumstats import SumstatsTable, read_sumstats
from ..utils.system import get_filenames
from ..utils.table import Table, read_table

logger = logging.getLogger(__name__)

# Long-range LD regions (hg19/GRCh37; Price et al. 2008 AJHG) as
# (chrom, start_mb, stop_mb):
LONG_RANGE_LD_REGIONS = [
    (1, 48, 52), (2, 86, 100.5), (2, 134.5, 138), (2, 183, 190),
    (3, 47.5, 50), (3, 83.5, 87), (3, 89, 97.5), (5, 44.5, 50.5),
    (5, 98, 100.5), (5, 129, 132), (5, 135.5, 138.5), (6, 25.5, 33.5),
    (6, 57, 64), (6, 140, 142.5), (7, 55, 66), (8, 8, 12), (8, 43, 50),
    (8, 112, 115), (10, 37, 43), (11, 46, 57), (11, 87.5, 90.5),
    (12, 33, 40), (12, 109.5, 112), (20, 32, 34.5),
]


class GWADataLoader:
    """
    :ivar genotype: GenotypeMatrix / MultiGenotypeMatrix or None.
    :ivar phenotype: (n,) float64 phenotype of the genotype's samples, or
        None; ``phenotype_likelihood`` 'gaussian' or 'binomial'.
    :ivar sumstats_table: {chrom: SumstatsTable} after harmonization.
    :ivar ld_blocks: {chrom: [dense LD blocks]} (host-side, before packing;
        int8 at scale 1/127 from a quantized store).
    :ivar ld_snp_tables: {chrom: Table} variant tables aligned with ld_blocks.
    :ivar timings: {stage: seconds} of the stages run so far ('tables',
        'sumstats', 'harmonize', 'ld_read', 'pack', 'upload', 'cache').
    """

    def __init__(self, bed_files=None, ld_store_files=None,
                 sumstats_files=None, sumstats_format='magenpy',
                 keep_samples=None, extract_snps=None, phenotype_file=None,
                 phenotype_likelihood='infer', n=None, block_size=1024,
                 quantize_ld=False, device='cuda', **sumstats_kwargs):
        self.genotype = None
        if bed_files:
            from .genotype import open_genotypes
            beds = sorted({re.sub(r'\.(bed|bim|fam)$', '', f)
                           for f in get_filenames(bed_files)})
            self.genotype = open_genotypes(beds, keep_samples=keep_samples,
                                           extract_snps=extract_snps,
                                           device=device)
        self.block_size = block_size
        self.quantize_ld = quantize_ld
        self.timings = {}
        self._ld_blocks = None
        self.ld_snp_tables = None
        self._ld_sources = None      # [(kind, path)] for lazy loads + cache key
        self._ld_source_chroms = []  # parallel to _ld_sources: chroms per store
        self._ld_present = None      # {chrom: bool mask in STORE order}
        self.ld_data_reads = 0       # stores whose LD data was read

        t0 = time.perf_counter()
        if ld_store_files:
            self._open_stores(get_filenames(ld_store_files))
        self.timings['tables'] = time.perf_counter() - t0

        self.sumstats_table = None
        self._raw_sumstats = None
        if sumstats_files:
            t0 = time.perf_counter()
            files = get_filenames(sumstats_files)
            self._raw_sumstats = SumstatsTable(Table.concat(
                read_sumstats(f, sumstats_format=sumstats_format, n=n,
                              **sumstats_kwargs).table for f in files))
            self.timings['sumstats'] = time.perf_counter() - t0

        self.phenotype = None
        self.phenotype_likelihood = None
        if phenotype_file:
            self.read_phenotype(phenotype_file,
                                likelihood=phenotype_likelihood)
        elif self.genotype is not None and \
                _n_unique(self.genotype.fam['PHENO']) > 1:
            self._set_phenotype(self.genotype.fam['PHENO'],
                                phenotype_likelihood)

        self._dataset = None
        if self._raw_sumstats is not None and (
                self._ld_blocks is not None or self._ld_sources):
            self.harmonize_data()

    # -------------------------------------------------------------- phenotype
    def read_phenotype(self, phenotype_file, likelihood='infer', pheno_col=2):
        """Read a headerless whitespace-separated phenotype file (FID IID
        value ...; column ``pheno_col`` holds the phenotype). With genotypes
        attached, the values are those of the genotype's samples, matched
        on (FID, IID) as strings (NaN where a sample has no row)."""
        t = read_table(phenotype_file, header=False)
        vals = t[str(pheno_col)]
        if self.genotype is not None:
            fam = self.genotype.fam
            row = {}
            for i, key in enumerate(zip(t['0'].astype(str).tolist(),
                                        t['1'].astype(str).tolist())):
                row.setdefault(key, i)
            at = np.fromiter((row.get(k, -1) for k in zip(
                fam['FID'].astype(str).tolist(),
                fam['IID'].astype(str).tolist())), np.int64, len(fam))
            vals = np.where(at >= 0, np.asarray(vals, np.float64)[at],
                            np.nan)
        self._set_phenotype(vals, likelihood)

    def _set_phenotype(self, vals, likelihood='infer'):
        """Set the phenotype and its likelihood (``eval.utils.
        infer_likelihood``: 0/1 and 1/2 codings binomial, plink's 1/2 made
        0/1)."""
        from ..eval.utils import infer_likelihood
        self.phenotype, self.phenotype_likelihood = infer_likelihood(
            vals, likelihood)

    @property
    def sample_table(self):
        """The genotype's samples (the .fam Table, PHENO replaced by the
        phenotype when one is set; also as ``.phenotype``), or None."""
        if self.genotype is None:
            return None
        tab = self.genotype.fam.copy()
        if self.phenotype is not None:
            tab['PHENO'] = self.phenotype
        tab.phenotype = self.phenotype
        return tab

    # ----------------------------------------------------------- LD and GWAS
    def compute_ld(self, estimator='block', ldetect_blocks=None,
                   block_file=None, **kwargs):
        """Estimate LD from the attached genotype (data/ld_estimators.py;
        the products on the genotype's device): ``ld_blocks`` becomes the
        estimator's host blocks and ``ld_snp_tables`` the .bim's variants
        (CHR SNP POS A1 A2) per chromosome."""
        if self.genotype is None:
            raise ValueError("No genotype data attached.")
        if block_file is not None and ldetect_blocks is None:
            ldetect_blocks = ld_estimators.read_ldetect_blocks(block_file)
        func = ld_estimators.ESTIMATORS[estimator]
        if estimator in ('block', 'shrinkage'):
            self.ld_blocks = func(self.genotype, ldetect_blocks, **kwargs)
        else:
            self.ld_blocks = func(self.genotype, **kwargs)
        bim = self.genotype.bim
        self.ld_snp_tables = {
            c: bim.take(bim['CHR'] == c).select(['CHR', 'SNP', 'POS', 'A1',
                                                 'A2'])
            for c in self.genotype.chromosomes}
        self._dataset = None
        return self

    def perform_gwas(self, **kwargs):
        """Marginal GWAS of the phenotype on the genotype (the products on
        its device); the statistics are harmonized with the LD when the
        loader has LD. Returns the SumstatsTable."""
        if self.genotype is None or self.phenotype is None:
            raise ValueError("perform_gwas needs genotypes and a phenotype.")
        self._raw_sumstats = self.genotype.perform_gwas(self.phenotype,
                                                        **kwargs)
        if self._ld_blocks is not None or self._ld_sources:
            self.harmonize_data()
        return self._raw_sumstats

    def _open_stores(self, stores):
        """Read the stores' variant tables (the lazy path); a store without
        them is read whole (the eager path)."""
        self.ld_snp_tables = {}
        self._ld_sources = []
        eager_blocks = {}
        for store in stores:
            if not osp.exists(store):
                raise FileNotFoundError(f"LD store not found: {store}")
            if osp.isdir(store) and any(f.startswith('chr_')
                                        for f in os.listdir(store)):
                _, tables = ld_store_mod.load_ld_store(store, tables_only=True)
                if tables:
                    self.ld_snp_tables.update(tables)
                    self._ld_sources.append(('native', store))
                    self._ld_source_chroms.append(set(tables))
                else:
                    # no variant tables: nothing to harmonize against
                    # lazily; the blocks are read now (int8 stays int8)
                    blocks, _ = ld_store_mod.load_ld_store(store,
                                                           dequantize=False)
                    self.ld_data_reads += 1
                    eager_blocks.update(blocks)
            else:
                # a magenpy Zarr store (the published panels' format)
                tables = ld_store_mod.load_magenpy_zarr_tables(store)
                if tables:
                    self.ld_snp_tables.update(tables)
                    self._ld_sources.append(('zarr', store))
                    self._ld_source_chroms.append(set(tables))
                else:
                    banded, _ = ld_store_mod.load_magenpy_zarr(store)
                    self.ld_data_reads += 1
                    for c, (data, indptr, left) in banded.items():
                        eager_blocks[c] = ld_store_mod.banded_to_blocks(
                            data, indptr, left, keep_quantized=True)
        if eager_blocks and self._ld_sources:
            # table-less and tabled stores together: all eager (the lazy
            # and cache paths assume every block comes from a source)
            for kind, store in self._ld_sources:
                eager_blocks.update(self._load_source_blocks(kind, store))
            self._ld_sources = []
        if eager_blocks:
            self._ld_blocks = eager_blocks
        if not self.ld_snp_tables:
            self.ld_snp_tables = None

    # ------------------------------------------------------ lazy LD plumbing
    def _load_source_blocks(self, kind, store, chromosomes=None):
        """Read the LD blocks of one recorded store (int8 stays int8: the
        packer takes it as it is, scale 1/127)."""
        self.ld_data_reads += 1
        if kind == 'native':
            blocks, _ = ld_store_mod.load_ld_store(store,
                                                   chromosomes=chromosomes,
                                                   dequantize=False)
            return blocks
        banded, _ = ld_store_mod.load_magenpy_zarr(store)
        return {c: ld_store_mod.banded_to_blocks(data, indptr, left,
                                                 keep_quantized=True)
                for c, (data, indptr, left) in banded.items()
                if chromosomes is None or c in chromosomes}

    @staticmethod
    def _slice_blocks(blocks, present):
        """Filter a chromosome's block list to the ``present`` store-order
        mask; returns (blocks, kept_row_indices)."""
        out, kept_rows = [], []
        offset = 0
        for blk in blocks:
            m_b = blk.shape[0]
            sel = np.where(present[offset:offset + m_b])[0]
            if len(sel):
                out.append(np.ascontiguousarray(blk[np.ix_(sel, sel)]))
                kept_rows.extend(offset + sel)
            offset += m_b
        return out, np.asarray(kept_rows, dtype=np.int64)

    @property
    def ld_blocks(self):
        """Per-chromosome LD block lists; store-backed loaders read them on
        first access (harmonization and pack-cache hits never do)."""
        if self._ld_blocks is None and self._ld_sources:
            self._ensure_ld_blocks()
        return self._ld_blocks

    @ld_blocks.setter
    def ld_blocks(self, value):
        self._ld_blocks = value

    def _ensure_ld_blocks(self):
        """Read the LD blocks from the recorded sources (the lazy path),
        applying the accumulated variant masks."""
        if self._ld_blocks is not None or not self._ld_sources:
            return self._ld_blocks
        t0 = time.perf_counter()
        chroms = set(self.ld_snp_tables or {})
        blocks = {}
        src_chroms = self._ld_source_chroms or [None] * len(self._ld_sources)
        for (kind, store), known in zip(self._ld_sources, src_chroms):
            if chroms and known is not None and not (chroms & known):
                continue  # nothing wanted from this store: skip the read
            loaded = self._load_source_blocks(kind, store,
                                              chromosomes=chroms or None)
            for c, blks in loaded.items():
                if c in chroms or not chroms:
                    blocks[c] = blks
        if self._ld_present is not None:
            sliced = {}
            for c, blks in blocks.items():
                if c not in self._ld_present:
                    continue
                sub, _ = self._slice_blocks(blks, self._ld_present[c])
                if sub:
                    sliced[c] = sub
            blocks = sliced
        self._ld_blocks = blocks
        self.timings['ld_read'] = time.perf_counter() - t0
        return self._ld_blocks

    # ------------------------------------------------------------ harmonization
    def harmonize_data(self):
        """Intersect and allele-align the summary statistics with the LD
        variant tables (the LD store's variant order defines the blocks).
        Table work only: the LD data is sliced when, and if, it is read."""
        t0 = time.perf_counter()
        if self._raw_sumstats is None:
            raise ValueError("No summary statistics loaded.")
        if self.ld_snp_tables is None:
            raise ValueError("The LD store has no variant tables; cannot "
                             "harmonize.")

        ss = self._raw_sumstats.table
        signed = [col for col in ('BETA', 'Z') if col in ss]
        self.sumstats_table = {}
        new_blocks, new_tables = {}, {}
        lazy = self._ld_blocks is None
        self._ld_present = {} if lazy else None
        # the statistics' rows by SNP id, built once: each chromosome's
        # merge then takes only the rows of its variants (the same result
        # as merging the whole table, whose other rows match nothing)
        ids = ss['SNP'].astype(str).tolist()
        row_of = dict(zip(ids, range(len(ids))))
        if len(row_of) < len(ids):        # repeated ids: merge all rows
            row_of = None

        for c, ld_tab in self.ld_snp_tables.items():
            right = ss
            if row_of is not None:
                rows = np.fromiter((row_of.get(k, -1) for k in
                                    ld_tab['SNP'].astype(str).tolist()),
                                   np.int64, len(ld_tab))
                right = ss.take(np.sort(rows[rows >= 0]))
            merged = merge_snp_tables(ld_tab.select(['SNP', 'A1', 'A2']),
                                      right, how='left',
                                      signed_statistics=signed)
            present = ~np.isnan(merged['Z' if 'Z' in merged else 'BETA'])
            if not present.any():
                continue

            if lazy:
                self._ld_present[c] = present
                kept = np.where(present)[0]
            else:
                blocks, kept = self._slice_blocks(self._ld_blocks[c], present)
                if not blocks:
                    continue
                new_blocks[c] = blocks

            keep_tab = ld_tab.take(kept)
            if 'CHR' not in keep_tab:
                keep_tab.insert(0, 'CHR', c)
            new_tables[c] = keep_tab

            sub = merged.take(kept)
            sub['CHR'] = c
            sub['POS'] = keep_tab['POS'] if 'POS' in keep_tab \
                else np.arange(len(sub))
            self.sumstats_table[c] = SumstatsTable(sub)

        if not lazy:
            self._ld_blocks = new_blocks
        self.ld_snp_tables = new_tables
        self._dataset = None
        self.timings['harmonize'] = time.perf_counter() - t0
        return self

    def filter_snps(self, extract_snps, chromosome=None):
        """Keep only the given variants (reference
        GWADataLoader.filter_snps)."""
        snpset = np.asarray(list(extract_snps)).astype(str)
        lazy = self._ld_blocks is None and self._ld_sources
        for c in list(self.ld_snp_tables or {}):
            if chromosome is not None and c != chromosome:
                continue
            tab = self.ld_snp_tables[c]
            keep = np.isin(tab['SNP'], snpset)
            if lazy:
                # compose into the store-order mask; the LD is sliced once,
                # when it is read
                if self._ld_present is None:
                    self._ld_present = {}
                if c in self._ld_present:
                    mask = self._ld_present[c].copy()
                    mask[np.where(mask)[0]] &= keep
                    self._ld_present[c] = mask
                else:
                    self._ld_present[c] = keep.copy()
                kept = np.where(keep)[0]
            else:
                blocks, kept = self._slice_blocks(self.ld_blocks[c], keep)
                self.ld_blocks[c] = blocks
            self.ld_snp_tables[c] = tab.take(kept)
            if self.sumstats_table and c in self.sumstats_table:
                self.sumstats_table[c] = SumstatsTable(
                    self.sumstats_table[c].table.take(kept))
        self._dataset = None
        return self

    def filter_long_range_ld_regions(self):
        """Drop variants in known long-range LD regions (hg19 coordinates;
        reference use-site bin/viprs_fit:216-218)."""
        if self.ld_snp_tables is None:
            return self
        keep_snps = []
        for c, tab in self.ld_snp_tables.items():
            pos_mb = tab['POS'] / 1e6
            mask = np.ones(len(tab), dtype=bool)
            for chrom, start, stop in LONG_RANGE_LD_REGIONS:
                if str(chrom) == str(c):
                    mask &= ~((pos_mb >= start) & (pos_mb <= stop))
            keep_snps.extend(tab['SNP'][mask].tolist())
        return self.filter_snps(keep_snps)

    # ------------------------------------------------------------------- views
    @property
    def chromosomes(self):
        if self.sumstats_table is not None:
            return sorted(self.sumstats_table.keys())
        if self.ld_snp_tables is not None:
            return sorted(self.ld_snp_tables.keys())
        if self.genotype is not None:
            return self.genotype.chromosomes
        return []

    @property
    def shapes(self):
        if self.sumstats_table is not None:
            return {c: len(t) for c, t in self.sumstats_table.items()}
        if self.ld_snp_tables is not None:
            return {c: len(t) for c, t in self.ld_snp_tables.items()}
        if self.genotype is not None:
            chrom = self.genotype.bim['CHR']
            return {c: int((chrom == c).sum())
                    for c in self.genotype.chromosomes}
        return {}

    @property
    def m(self):
        return int(sum(self.shapes.values()))

    @property
    def n_snps(self):
        return self.m

    @property
    def n(self):
        if self.genotype is not None:
            return self.genotype.n
        if self.sumstats_table is not None:
            return float(max(t.n_per_snp.max()
                             for t in self.sumstats_table.values()))
        return None

    @property
    def snps(self):
        return {c: t['SNP'] for c, t in (self.ld_snp_tables or {}).items()}

    def default_snp_table(self):
        """Per-chromosome variant tables (the surface that aligns posterior
        effect tables with this loader's variants)."""
        return self.to_snp_table(per_chromosome=True)

    def to_snp_table(self, col_subset=None, per_chromosome=False):
        """Per-chromosome variant tables: the LD's when the loader has LD,
        else the genotype's .bim."""
        tables = {}
        source = self.ld_snp_tables
        if source is None and self.genotype is not None:
            bim = self.genotype.bim
            source = {c: bim.take(bim['CHR'] == c)
                      for c in self.genotype.chromosomes}
        for c, tab in (source or {}).items():
            t = tab.copy()
            if 'CHR' not in t:
                t.insert(0, 'CHR', c)
            if col_subset:
                t = t.select([col for col in col_subset if col in t])
            tables[c] = t
        if per_chromosome:
            return tables
        return Table.concat(tables[c] for c in sorted(tables)) \
            if tables else None

    def to_summary_statistics_table(self, col_subset=None,
                                    per_chromosome=False):
        if self.sumstats_table is None:
            raise ValueError("No harmonized summary statistics.")
        tables = {c: t.to_table(col_subset=col_subset)
                  for c, t in self.sumstats_table.items()}
        if per_chromosome:
            return tables
        return Table.concat(tables[c] for c in sorted(tables))

    def to_individual_table(self):
        if self.genotype is None:
            raise ValueError("No genotype data attached.")
        return self.genotype.fam.select(['FID', 'IID'])

    def to_phenotype_table(self):
        tab = self.to_individual_table()
        tab['phenotype'] = self.phenotype
        return tab

    # ---------------------------------------------------------------- scoring
    def score(self, beta):
        """PRS of the genotype's samples (numpy, (n,) or (n, S)): ``beta``
        an array aligned with the .bim or a {chrom: array} dict taken in
        sorted-chromosome order; the products on the genotype's device."""
        if self.genotype is None:
            raise ValueError("No genotype data for scoring.")
        return self.genotype.score(beta)

    predict = score

    # ----------------------------------------------------------------- dataset
    def to_summary_dataset(self, block_size=None, quantize=None,
                           device='cuda') -> SummaryStatsDataset:
        """Pack the harmonized data and upload it to ``device`` (the card
        unless the caller asks for the CPU).

        When the LD came from stores, the packed tiles are cached on disk,
        keyed on (store signatures, kept variants, block size, int8 or
        float32): a repeated fit on the same panel reads no LD data
        (data/pack_cache.py)."""
        import torch
        if self._dataset is not None and \
                self._dataset.device == _resolve(torch.device(device)):
            return self._dataset
        if self.sumstats_table is None or (self._ld_blocks is None
                                           and not self._ld_sources):
            raise ValueError("Loader must have harmonized summary "
                             "statistics and LD.")

        block_size = block_size or self.block_size
        quantize = self.quantize_ld if quantize is None else quantize

        std_beta = {c: t.get_snp_pseudo_corr()
                    for c, t in self.sumstats_table.items()}
        n_per_snp = {c: t.n_per_snp for c, t in self.sumstats_table.items()}
        snp_tables = {}
        for c, tab in self.ld_snp_tables.items():
            t = tab.copy()
            if 'CHR' not in t:
                t.insert(0, 'CHR', c)
            snp_tables[c] = t

        from . import pack_cache
        from ..ops.block_ld import pack_dense_blocks
        key = hit = None
        if self._ld_sources and pack_cache.cache_root() is not None:
            t0 = time.perf_counter()
            key = pack_cache.compute_key(
                [s for _, s in self._ld_sources],
                {c: t['SNP'] for c, t in self.ld_snp_tables.items()},
                block_size, quantize)
            hit = pack_cache.load_packed(key)
            self.timings['cache'] = time.perf_counter() - t0
        if hit is not None:
            logger.info("Packed-LD cache hit (%s...)", key[:12])
            packed, layout = hit
        else:
            self._ensure_ld_blocks()
            t0 = time.perf_counter()
            packed, layout = pack_dense_blocks(
                self.ld_blocks, block_size=block_size, quantize=quantize)
            self.timings['pack'] = time.perf_counter() - t0
            if key is not None:
                t0 = time.perf_counter()
                pack_cache.save_packed(key, packed, layout)
                self.timings['cache'] += time.perf_counter() - t0
        t0 = time.perf_counter()
        self._dataset = SummaryStatsDataset.from_packed(
            packed, layout, std_beta, n_per_snp, snp_table=snp_tables,
            device=device)
        if self._dataset.device.type == 'cuda':
            torch.cuda.synchronize(self._dataset.device)
        self.timings['upload'] = time.perf_counter() - t0
        return self._dataset

    # ------------------------------------------------------------- streaming
    def estimate_packed_bytes(self, block_size=None, quantize=None):
        """{chrom: packed LD bytes} without reading LD data: the block sizes
        come from the .npz member headers or the Zarr boundary metadata.
        Conservative: the store's own block sizes (harmonization only
        shrinks them). The streaming planner's input."""
        from ..ops.block_ld import estimate_packed_bytes
        block_size = block_size or self.block_size
        quantize = self.quantize_ld if quantize is None else quantize
        sizes = {}
        if self._ld_sources:
            for kind, store in self._ld_sources:
                if kind == 'native':
                    sizes.update(ld_store_mod.native_store_block_sizes(store))
                else:
                    sizes.update(ld_store_mod.magenpy_zarr_block_sizes(store))
        elif self._ld_blocks is not None:
            sizes = {c: [b.shape[0] for b in blks]
                     for c, blks in self._ld_blocks.items()}
        keep = set(self.ld_snp_tables or sizes)
        return {c: estimate_packed_bytes({c: s}, block_size=block_size,
                                         quantize=quantize)
                for c, s in sizes.items() if c in keep}

    def plan_chromosome_groups(self, budget_bytes, block_size=None,
                               quantize=None):
        """Group chromosomes so that each group's packed LD fits the budget
        (chromosomes are independent LD blocks, so a fit per group is exact
        per group: the reference's per-chromosome mode,
        bin/viprs_fit:232-238). Returns a list of chromosome lists."""
        per_chrom = self.estimate_packed_bytes(block_size, quantize)
        groups, cur, cur_bytes = [], [], 0
        for c in sorted(per_chrom, key=str):
            b = per_chrom[c]
            if b > budget_bytes:
                logger.warning(
                    "Chromosome %s alone packs to %.2f GB (> budget %.2f GB);"
                    " it forms its own group and may not fit on the device.",
                    c, b / 1e9, budget_bytes / 1e9)
            if cur and cur_bytes + b > budget_bytes:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(c)
            cur_bytes += b
        if cur:
            groups.append(cur)
        return groups

    def subset_loader(self, chromosomes):
        """A lazy view of this loader restricted to the given chromosomes
        (shares sources and masks; reads only that subset's LD)."""
        chroms = set(chromosomes)
        sub = GWADataLoader.__new__(GWADataLoader)
        sub.__dict__.update(self.__dict__)
        sub.timings = {}
        sub.ld_snp_tables = {c: t for c, t in
                             (self.ld_snp_tables or {}).items()
                             if c in chroms} or None
        sub.sumstats_table = ({c: t for c, t in self.sumstats_table.items()
                               if c in chroms}
                              if self.sumstats_table else None)
        if self._ld_blocks is not None:
            sub.ld_blocks = {c: b for c, b in self._ld_blocks.items()
                             if c in chroms}
        if self._ld_present is not None:
            sub._ld_present = {c: m for c, m in self._ld_present.items()
                               if c in chroms}
        sub._dataset = None
        return sub

    def iter_group_datasets(self, groups, block_size=None, quantize=None,
                            device='cuda'):
        """Yield (chromosome_group, SummaryStatsDataset) per planned group,
        reading (and then releasing) one group's LD at a time."""
        for group in groups:
            sub = self.subset_loader(group)
            ds = sub.to_summary_dataset(block_size=block_size,
                                        quantize=quantize, device=device)
            yield group, ds
            self.ld_data_reads = sub.ld_data_reads
            for k, v in sub.timings.items():
                self.timings[k] = self.timings.get(k, 0.0) + v
            sub.cleanup()
            del sub, ds

    def cleanup(self):
        self._dataset = None
        self._ld_blocks = None if self._ld_sources else self._ld_blocks


def _n_unique(values):
    """The count of distinct values, NaN not counted (pandas'
    ``nunique``)."""
    values = np.asarray(values)
    if values.dtype.kind == 'f':
        values = values[~np.isnan(values)]
    return len(np.unique(values))


def _resolve(device):
    import torch
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device
