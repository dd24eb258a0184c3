"""The device-facing dataset: harmonized summary statistics + blocked LD.

Counterpart of viprs_tpu.data.dataset, built from files by the loader
(data/loader.py) or directly from arrays (simulations, tests, benchmarks).
The LD lives on the dataset's ``device``,
packed as float32 (the default, as in the JAX package) or as int8
(``quantize=True``); every model fits either, on the CPU or a CUDA device.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.block_ld import BlockLD, BlockLayout, pack_dense_blocks


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
    """
    ld: BlockLD
    layout: BlockLayout
    std_beta: Dict
    n_per_snp: Dict
    snp_table: Optional[Dict] = None
    ld_scores: Optional[Dict] = None
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def device(self) -> torch.device:
        return self.ld.device

    @property
    def shapes(self):
        return {c: s for c, s in zip(self.layout.chromosomes,
                                     self.layout.chrom_sizes)}

    @property
    def m(self) -> int:
        return self.layout.m

    @property
    def n(self) -> float:
        return float(max(np.max(v) for v in self.n_per_snp.values()))

    def _flat(self, per_chrom):
        lay = self.layout
        return torch.from_numpy(
            lay.to_flat(per_chrom).reshape(lay.nb, lay.block_size)
        ).to(self.device)

    def device_inputs(self):
        """Cached (std_beta, n_per_snp) as (NB, B) float32 tensors on the
        dataset's device, shared by every model over this dataset."""
        if 'inputs' not in self._cache:
            self._cache['inputs'] = (self._flat(self.std_beta),
                                     self._flat(self.n_per_snp))
        return self._cache['inputs']

    @classmethod
    def from_dense_blocks(cls, ld_blocks: Dict, std_beta: Dict,
                          n_per_snp: Dict, snp_table: Optional[Dict] = None,
                          block_size: int = 1024, quantize: bool = False, *,
                          device):
        """Build from per-chromosome lists of dense LD blocks."""
        packed, layout = pack_dense_blocks(ld_blocks, block_size=block_size,
                                           quantize=quantize)
        return cls.from_packed(packed, layout, std_beta, n_per_snp,
                               snp_table=snp_table, device=device)

    @classmethod
    def from_packed(cls, packed, layout, std_beta: Dict, n_per_snp: Dict,
                    snp_table: Optional[Dict] = None, *, device):
        """Upload a packer's (PackedLD, BlockLayout) to ``device``."""
        ds = cls(ld=packed.to(device), layout=layout, std_beta=std_beta,
                 n_per_snp=n_per_snp, snp_table=snp_table)
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
