"""The device-facing dataset: harmonized summary statistics + blocked LD.

Counterpart of viprs_tpu.data.dataset, built from files by the loader
(data/loader.py) or directly from arrays (simulations, tests, benchmarks).
The LD lives on the dataset's ``device``,
packed as float32 (the default, as in the JAX package) or as int8
(``quantize=True``); every model fits either, on the CPU or a CUDA device.
Under a mesh (parallel/mesh.py) each rank's models take the rank's shard of
it (``ld_for_mesh``): a dataset built on the host copies only that shard to
the rank's card.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.block_ld import BlockLD, BlockLayout, pack_banded, \
    pack_dense_blocks
from ..utils import trace


@dataclasses.dataclass
class SummaryStatsDataset:
    """Harmonized GWAS summary statistics with block-packed LD.

    :ivar ld: BlockLD operator on the dataset's device.
    :ivar layout: host-side block layout (chromosome <-> flat index mapping).
    :ivar std_beta: {chrom: (m_c,)} standardized marginal betas.
    :ivar n_per_snp: {chrom: (m_c,)} per-variant GWAS sample sizes.
    :ivar snp_table: optional {chrom: Table} variant metadata (CHR, SNP,
        POS, A1, A2, ...; ``utils/table.py``).
    :ivar ld_scores: optional {chrom: (m_c,)} LD scores (LDSC h2 init).
    :ivar phenotype_likelihood: 'gaussian' or 'binomial'.
    """
    ld: BlockLD
    layout: BlockLayout
    std_beta: Dict
    n_per_snp: Dict
    snp_table: Optional[Dict] = None
    ld_scores: Optional[Dict] = None
    phenotype_likelihood: str = 'gaussian'
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def device(self) -> torch.device:
        return self.ld.device

    @property
    def chromosomes(self):
        return list(self.layout.chromosomes)

    @property
    def shapes(self):
        return {c: s for c, s in zip(self.layout.chromosomes,
                                     self.layout.chrom_sizes)}

    @property
    def m(self) -> int:
        return self.layout.m

    @property
    def n_snps(self) -> int:
        return self.m

    @property
    def n(self) -> float:
        return float(max(np.max(v) for v in self.n_per_snp.values()))

    def _flat(self, per_chrom):
        lay = self.layout
        return torch.from_numpy(
            lay.to_flat(per_chrom).reshape(lay.nb, lay.block_size)
        ).to(self.device)

    def std_beta_flat(self):
        """The standardized marginal betas as an (NB, B) float32 tensor on
        the dataset's device (zero on padding lanes)."""
        return self._flat(self.std_beta)

    def n_per_snp_flat(self):
        """The per-variant sample sizes as an (NB, B) float32 tensor on the
        dataset's device (zero on padding lanes)."""
        return self._flat(self.n_per_snp)

    def device_inputs(self, mesh=None, device=None):
        """Cached (std_beta_flat, n_per_snp_flat), shared by every model
        over this dataset; under a mesh, the rank's rows of them (NB padded
        to the shards) on ``device`` (default the mesh's)."""
        if mesh is None:
            if 'inputs' not in self._cache:
                self._cache['inputs'] = (self.std_beta_flat(),
                                         self.n_per_snp_flat())
            return self._cache['inputs']
        device = mesh.device if device is None else torch.device(device)
        key = ('inputs', mesh, device)
        if key not in self._cache:
            from ..parallel.mesh import shard_flat
            lay = self.layout
            nb = self.ld_for_mesh(mesh, device).nb_padded
            self._cache[key] = tuple(
                shard_flat(mesh, torch.from_numpy(lay.to_flat(d).reshape(
                    lay.nb, lay.block_size)), nb, device)
                for d in (self.std_beta, self.n_per_snp))
        return self._cache[key]

    def ld_for_mesh(self, mesh, device=None):
        """The LD a model over ``mesh`` computes with: the dataset's own
        without a mesh, else this rank's shard of it on ``device`` (default
        the mesh's; ``parallel.mesh.shard_ld``: its range of the blocks,
        NB padded to the shards, and the coupling tiles that touch it).
        Cached per mesh and device, so the models of one run (e.g. the
        CLI's fit and grid search) share one copy on the card."""
        if mesh is None:
            return self.ld
        device = mesh.device if device is None else torch.device(device)
        key = ('ld', mesh, device)
        if key not in self._cache:
            from ..parallel.mesh import shard_ld
            self._cache[key] = shard_ld(mesh, self.ld, device)
        return self._cache[key]

    @classmethod
    @trace.entry('viprs.pack')
    def from_dense_blocks(cls, ld_blocks: Dict, std_beta: Dict,
                          n_per_snp: Dict, snp_table: Optional[Dict] = None,
                          block_size: int = 1024, quantize: bool = False, *,
                          device, **kwargs):
        """Build from per-chromosome lists of dense LD blocks."""
        packed, layout = pack_dense_blocks(ld_blocks, block_size=block_size,
                                           quantize=quantize)
        return cls.from_packed(packed, layout, std_beta, n_per_snp,
                               snp_table=snp_table, device=device, **kwargs)

    @classmethod
    def from_banded(cls, banded: Dict, std_beta: Dict, n_per_snp: Dict,
                    snp_table: Optional[Dict] = None,
                    block_size: int = 1024, quantize: bool = False, *,
                    device, **kwargs):
        """Build from per-chromosome banded LD arrays (the reference's
        on-disk layout: {chrom: (data, indptr, left_bound)}), packed by
        :func:`~viprs_tpu_torch.ops.block_ld.pack_banded`: the windowed
        stores whose band never pinches off into blocks."""
        packed, layout = pack_banded(banded, block_size=block_size,
                                     quantize=quantize)
        return cls.from_packed(packed, layout, std_beta, n_per_snp,
                               snp_table=snp_table, device=device, **kwargs)

    @classmethod
    def from_packed(cls, packed, layout, std_beta: Dict, n_per_snp: Dict,
                    snp_table: Optional[Dict] = None, *, device, **kwargs):
        """Upload a packer's (PackedLD, BlockLayout) to ``device``; the
        other fields (``ld_scores``, ``phenotype_likelihood``) by keyword."""
        ds = cls(ld=packed.to(device), layout=layout, std_beta=std_beta,
                 n_per_snp=n_per_snp, snp_table=snp_table, **kwargs)
        ds._check_shapes()
        return ds

    def _check_shapes(self):
        for c, sz in self.shapes.items():
            if len(self.std_beta[c]) != sz or len(self.n_per_snp[c]) != sz:
                raise ValueError(
                    f"summary statistics for chromosome {c} do not match the "
                    f"LD's {sz} variants")

    def default_snp_table(self):
        """The variant tables, or minimal synthetic ones (SNP ids
        ``rs_<chrom>_<i>``, alleles A/G) when the dataset has none."""
        if self.snp_table is not None:
            return self.snp_table
        from ..utils.table import Table
        return {c: Table({'CHR': c,
                          'SNP': [f'rs_{c}_{i}' for i in range(sz)],
                          'POS': np.arange(sz, dtype=np.int64),
                          'A1': 'A', 'A2': 'G'})
                for c, sz in self.shapes.items()}

    def compute_ld_scores(self, chunk_bytes=1.25e8):
        """LD scores l_j = sum_k r_jk^2 from the blocked LD (LDSC init).

        float32 on the device, a chunk of tiles at a time so the float32 view
        of the int8 tiles never exceeds ``chunk_bytes`` of int8 input.
        """
        if self.ld_scores is not None:
            return self.ld_scores
        ld = self.ld
        scale2 = torch.tensor(ld.scale, dtype=torch.float32,
                              device=ld.device) ** 2
        ch = max(1, int(chunk_bytes // (ld.block_size ** 2)))
        scores = torch.empty(ld.nb, ld.block_size, dtype=torch.float32,
                             device=ld.device)
        for i in range(0, ld.nb, ch):
            f = ld.diag[i:i + ch].float()
            scores[i:i + ch] = (f * f).sum(dim=2) * scale2
        for i in range(0, ld.n_off, ch):
            f = ld.off_data[i:i + ch].float()
            scores.index_add_(0, ld.off_src[i:i + ch].long(),
                              (f * f).sum(dim=2) * scale2)
            scores.index_add_(0, ld.off_dst[i:i + ch].long(),
                              (f * f).sum(dim=1) * scale2)
        self.ld_scores = self.layout.from_flat(scores.cpu().numpy().reshape(-1))
        return self.ld_scores
