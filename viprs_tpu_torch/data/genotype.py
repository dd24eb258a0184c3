"""plink BED/BIM/FAM genotypes, decoded on the device (counterpart of
viprs_tpu.data.genotype).

The host reads the selected variants' rows of the ``.bed`` file as bytes
(a memory map: a cohort's fileset is gigabytes), uploads them, and the
device decodes them through the 2-bit code table, mean-imputes missing
calls over the kept samples, standardizes, and takes the products of
scoring (``X_std beta``) and of GWAS (``X_std' y / n``), all in float64.
The ``.bim`` and ``.fam`` tables are :class:`~viprs_tpu_torch.utils.table.
Table`s with the JAX package's column names. Genotypes live on the card
unless the caller asks for the CPU; a CUDA device without CUDA raises.
"""

import contextlib
import time

import numpy as np
import torch

from ..utils.table import Table, read_table

BIM_COLUMNS = ('CHR', 'SNP', 'CM', 'POS', 'A1', 'A2')
FAM_COLUMNS = ('FID', 'IID', 'father', 'mother', 'sex', 'PHENO')
#: plink1 BED 2-bit codes (variant-major): 00 -> 2 copies of A1,
#: 01 -> missing, 10 -> 1, 11 -> 0.
CODE_TO_DOSAGE = (2.0, np.nan, 1.0, 0.0)
BED_MAGIC = b'\x6c\x1b\x01'
F64 = torch.float64


def read_plink_table(path, names):
    """A headerless whitespace-separated plink table (.bim, .fam) with the
    given column names, typed as the JAX package's pandas reads it."""
    t = read_table(path, header=False)
    if len(t.columns) != len(names):
        raise ValueError(f"{path} has {len(t.columns)} columns; expected "
                         f"{len(names)} ({' '.join(names)})")
    return t.rename({str(i): name for i, name in enumerate(names)})


def genotype_device(device):
    """The torch device genotypes are decoded on: a CUDA device needs CUDA
    (genotypes never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "genotypes were asked for on a CUDA device, and "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "decode them on the CPU")
    return dev


class StageClock:
    """Seconds per stage. Host stages (reading, uploading) by the host
    clock; device stages (decoding, products) by CUDA events on a CUDA
    device, read once, when ``seconds()`` is asked for; by the host clock
    on the CPU."""

    def __init__(self, device):
        self._cuda = device.type == 'cuda'
        self._host = {}
        self._events = {}

    @contextlib.contextmanager
    def host(self, name):
        t0 = time.perf_counter()
        yield
        self._host[name] = self._host.get(name, 0.0) + \
            time.perf_counter() - t0

    @contextlib.contextmanager
    def device(self, name):
        if not self._cuda:
            with self.host(name):
                yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._events.setdefault(name, []).append((start, end))

    def seconds(self):
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize()
        for name, pairs in self._events.items():
            out[name] = out.get(name, 0.0) + sum(
                s.elapsed_time(e) for s, e in pairs) / 1e3
        return out


def _beta_matrix(beta, chromosomes, m):
    """(m, S) float64 effect sizes from a flat array or a {chrom: array}
    dict, concatenated in sorted-chromosome order (the JAX package's)."""
    if isinstance(beta, dict):
        parts = [np.asarray(beta[c], np.float64) for c in chromosomes]
        beta = np.concatenate([b.reshape(len(b), -1) for b in parts], axis=0)
    else:
        beta = np.asarray(beta, np.float64)
        beta = beta.reshape(len(beta), -1)
    if beta.shape[0] != m:
        raise ValueError(f"beta has {beta.shape[0]} rows; expected {m}")
    return beta


class GenotypeMatrix:
    """A plink BED fileset (samples x variants), decoded on ``device``.

    :ivar bim: variant Table (CHR SNP CM POS A1 A2).
    :ivar fam: sample Table (FID IID father mother sex PHENO).
    :ivar clock: the seconds of the stages run so far (``timings``).
    """

    def __init__(self, bed_prefix, keep_samples=None, extract_snps=None,
                 device='cuda'):
        prefix = bed_prefix[:-4] if bed_prefix.endswith('.bed') \
            else bed_prefix
        self.bed_path = prefix + '.bed'
        self.device = genotype_device(device)
        self.clock = StageClock(self.device)
        with self.clock.host('tables'):
            self.bim = read_plink_table(prefix + '.bim', BIM_COLUMNS)
            self.fam = read_plink_table(prefix + '.fam', FAM_COLUMNS)
        with open(self.bed_path, 'rb') as f:
            if f.read(3) != BED_MAGIC:
                raise ValueError(f"{self.bed_path} is not a variant-major "
                                 f"plink BED file.")

        self._sample_idx = np.arange(len(self.fam))
        if keep_samples is not None:
            keep_set = set(map(tuple, keep_samples)) \
                if not isinstance(keep_samples, (set, frozenset)) \
                else keep_samples
            mask = [(fid, iid) in keep_set or iid in keep_set
                    for fid, iid in zip(self.fam['FID'].tolist(),
                                        self.fam['IID'].tolist())]
            self._sample_idx = np.where(mask)[0]
            self.fam = self.fam.take(self._sample_idx)

        self._snp_idx = np.arange(len(self.bim))
        if extract_snps is not None:
            wanted = set(extract_snps)
            self._snp_idx = np.where(np.fromiter(
                (s in wanted for s in self.bim['SNP'].tolist()), bool,
                len(self.bim)))[0]
            self.bim = self.bim.take(self._snp_idx)

        # the full .fam's line count is the BED file's stride
        with open(prefix + '.fam') as f:
            self._n_total_samples = sum(1 for _ in f)
        self._stride = (self._n_total_samples + 3) // 4
        # sample s is the 2-bit code (byte s // 4) >> 2 (s % 4)
        self._byte_idx = torch.from_numpy(self._sample_idx // 4).to(
            self.device)
        self._shift = torch.from_numpy(
            (2 * (self._sample_idx % 4)).astype(np.uint8)).to(self.device)
        self._lut = torch.tensor(CODE_TO_DOSAGE, dtype=F64,
                                 device=self.device)

    @property
    def n(self):
        return len(self.fam)

    @property
    def m(self):
        return len(self.bim)

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def chromosomes(self):
        return sorted(np.unique(self.bim['CHR']).tolist())

    @property
    def timings(self):
        """{stage: seconds}: 'tables' (.bim/.fam), 'bed_read', 'upload',
        'decode' (decoding, imputation and standardization) and
        'product'."""
        return self.clock.seconds()

    # ------------------------------------------------------------ decode
    def _bed_rows(self, snp_sel):
        """The BED rows of file variants ``snp_sel`` as a (k, stride) uint8
        array (a slice of the memory map where they are consecutive)."""
        with self.clock.host('bed_read'):
            raw = np.memmap(self.bed_path, dtype=np.uint8, mode='r')
            body = raw[3:]
            if len(body) % self._stride:
                raise ValueError(f"{self.bed_path}: {len(body)} bytes after "
                                 f"the magic number is not a multiple of the "
                                 f"{self._stride}-byte variant row")
            body = body.reshape(-1, self._stride)
            if len(snp_sel) and snp_sel[-1] >= len(body):
                raise ValueError(f"{self.bed_path} holds {len(body)} "
                                 f"variants; the .bim names more")
            if len(snp_sel) and np.all(np.diff(snp_sel) == 1):
                rows = np.array(body[snp_sel[0]:snp_sel[-1] + 1])
            else:
                rows = np.array(body[snp_sel])
            del raw, body
        return rows

    def dosage_tensor(self, snp_indices=None, impute=True):
        """(k, n) float64 dosages of the selected variants (positions in
        ``bim``) on the device, variant-major; missing calls mean-imputed
        over the kept samples when ``impute`` (a variant with none called
        imputes to 0)."""
        sel = self._snp_idx if snp_indices is None \
            else self._snp_idx[np.asarray(snp_indices)]
        rows = self._bed_rows(np.asarray(sel))
        with self.clock.host('upload'):
            rows = torch.from_numpy(rows).to(self.device)
        with self.clock.device('decode'):
            codes = (rows[:, self._byte_idx] >> self._shift) & 3
            x = self._lut[codes.long()]
            if impute:
                miss = torch.isnan(x)
                called = (~miss).sum(1, keepdim=True)
                mean = torch.where(miss, 0.0, x).sum(1, keepdim=True) / called
                x = torch.where(miss, torch.nan_to_num(mean, nan=0.0), x)
        return x

    def standardized_tensor(self, snp_indices=None):
        """(k, n) float64 standardized genotypes on the device: dosages
        centred per variant and scaled by their standard deviation (ddof 0;
        a variant with none is only centred)."""
        x = self.dosage_tensor(snp_indices)
        with self.clock.device('decode'):
            x = x - x.mean(1, keepdim=True)
            sd = x.std(1, correction=0, keepdim=True)
            x = x / torch.where(sd == 0, 1.0, sd)
        return x

    def dosages(self, snp_indices=None, impute=True):
        """(n, k) float64 dosage matrix (numpy); missing calls mean-imputed
        when ``impute``."""
        return np.ascontiguousarray(
            self.dosage_tensor(snp_indices, impute).T.cpu().numpy())

    def standardized(self, snp_indices=None):
        """(n, k) float64 standardized genotypes (numpy)."""
        return np.ascontiguousarray(
            self.standardized_tensor(snp_indices).T.cpu().numpy())

    # ------------------------------------------------------------- score
    def score_tensor(self, beta, standardize=True, chunk=4096):
        """(n, S) float64 PRS on the device: the sum over chunks of
        ``chunk`` variants of X[:, chunk] @ beta[chunk]."""
        beta = _beta_matrix(beta, self.chromosomes, self.m)
        with self.clock.host('upload'):
            b = torch.from_numpy(beta).to(self.device)
        prs = torch.zeros((self.n, b.shape[1]), dtype=F64, device=self.device)
        for start in range(0, self.m, chunk):
            sel = np.arange(start, min(start + chunk, self.m))
            x = self.standardized_tensor(sel) if standardize \
                else self.dosage_tensor(sel)
            with self.clock.device('product'):
                prs += x.T @ b[start:start + len(sel)]
        return prs

    def score(self, beta, standardize=True, chunk=4096):
        """Linear PRS scoring, genotype . beta (numpy, squeezed).

        :param beta: {chrom: array} or an array aligned with ``bim``, (m,)
            or (m, S).
        """
        return self.score_tensor(beta, standardize, chunk).cpu().numpy() \
            .squeeze()

    predict = score

    # -------------------------------------------------------------- GWAS
    def perform_gwas(self, phenotype, chunk=4096):
        """Marginal standardized regression per variant: beta_j = x_j' y / n
        with x, y standardized (the products on the device). Returns a
        SumstatsTable."""
        from scipy.stats import norm

        from .sumstats import SumstatsTable
        y = np.asarray(phenotype, dtype=np.float64)
        y = (y - y.mean()) / y.std()
        n = self.n
        with self.clock.host('upload'):
            yd = torch.from_numpy(y).to(self.device)
        betas = torch.empty(self.m, dtype=F64, device=self.device)
        for start in range(0, self.m, chunk):
            sel = np.arange(start, min(start + chunk, self.m))
            x = self.standardized_tensor(sel)
            with self.clock.device('product'):
                betas[start:start + len(sel)] = x @ yd / n
        betas = betas.cpu().numpy()
        se = np.sqrt(np.maximum(1.0 - betas ** 2, 1e-12) / n)
        tab = Table({'CHR': self.bim['CHR'], 'SNP': self.bim['SNP'],
                     'POS': self.bim['POS'], 'A1': self.bim['A1'],
                     'A2': self.bim['A2'], 'N': n, 'BETA': betas, 'SE': se,
                     'Z': betas / se})
        tab['P'] = 2 * norm.sf(np.abs(tab['Z']))
        return SumstatsTable(tab)


class MultiGenotypeMatrix:
    """Several BED filesets (e.g. one per chromosome) over the same samples,
    presented with the single-fileset interface."""

    def __init__(self, bed_prefixes, keep_samples=None, extract_snps=None,
                 device='cuda'):
        self.parts = [GenotypeMatrix(p, keep_samples=keep_samples,
                                     extract_snps=extract_snps,
                                     device=device)
                      for p in bed_prefixes]
        base_iids = self.parts[0].fam['IID'].tolist()
        for p in self.parts[1:]:
            if p.fam['IID'].tolist() != base_iids:
                raise ValueError("All BED filesets must cover the same "
                                 "samples in the same order.")
        self.device = self.parts[0].device
        self.bim = Table.concat(p.bim for p in self.parts)
        self.fam = self.parts[0].fam

    @property
    def n(self):
        return self.parts[0].n

    @property
    def m(self):
        return len(self.bim)

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def chromosomes(self):
        return sorted(np.unique(self.bim['CHR']).tolist())

    @property
    def timings(self):
        out = {}
        for p in self.parts:
            for k, v in p.timings.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def score(self, beta, standardize=True, chunk=4096):
        beta = _beta_matrix(beta, self.chromosomes, self.m)
        prs = 0.0
        offset = 0
        for p in self.parts:
            prs = prs + p.score_tensor(beta[offset:offset + p.m],
                                       standardize=standardize, chunk=chunk)
            offset += p.m
        return prs.cpu().numpy().squeeze()

    predict = score

    def perform_gwas(self, phenotype, chunk=4096):
        from .sumstats import SumstatsTable
        return SumstatsTable(Table.concat(
            p.perform_gwas(phenotype, chunk=chunk).table for p in self.parts))

    def standardized(self, snp_indices=None):
        raise NotImplementedError(
            "Dense access across filesets is not supported; use the per-part "
            "GenotypeMatrix objects (.parts).")

    standardized_tensor = standardized


def open_genotypes(bed_files, keep_samples=None, extract_snps=None,
                   device='cuda'):
    """Open one or many BED filesets with a uniform interface."""
    if isinstance(bed_files, (list, tuple)) and len(bed_files) > 1:
        return MultiGenotypeMatrix(bed_files, keep_samples=keep_samples,
                                   extract_snps=extract_snps, device=device)
    prefix = bed_files[0] if isinstance(bed_files, (list, tuple)) \
        else bed_files
    return GenotypeMatrix(prefix, keep_samples=keep_samples,
                          extract_snps=extract_snps, device=device)
