"""The port's genotype layer (``viprs_tpu_torch.data.genotype``,
``ld_estimators``, the loader's genotype surface and ``simulate``) against
the JAX package's, on the CPU.

The same plink filesets (``tests/plink_utils.write_plink_bed``: n in {37,
200}, so the last byte of a variant's row holds padding codes; two
chromosomes; ~2% missing calls, a variant with none called and a
monomorphic one) go through both packages. Tolerances: dosages bit for bit
(mean imputation divides an exact integer sum once); standardized
genotypes within 1e-12; PRS within rtol 1e-10 (atol 1e-12 of the largest
score); GWAS BETA/SE/Z within rtol 1e-10 and P within rtol 1e-8; LD
within 1e-12 (the JAX package sums X'X in its native library's order);
``simulate`` bit for bit.
"""

import os.path as osp

import numpy as np
import pandas as pd
import pytest
import torch

from viprs_tpu.data import genotype as jax_genotype
from viprs_tpu.data import ld_estimators as jax_ld
from viprs_tpu.data import simulate as jax_simulate
from viprs_tpu.data.loader import GWADataLoader as JaxLoader

from viprs_tpu_torch.data import genotype, ld_estimators, simulate
from viprs_tpu_torch.data.loader import GWADataLoader
from viprs_tpu_torch.utils.table import Table

from plink_utils import write_plink_bed
from test_torch_data import assert_table_is_frame

CHROMS = (21, 22)
ALLELES = (('A', 'G'), ('C', 'T'), ('G', 'A'), ('T', 'C'), ('A', 'C'))


def plink_frames(dos, seed, chroms=CHROMS, pheno=None):
    """(bim, fam) DataFrames for a (n, m) dosage matrix: the variants split
    evenly over ``chroms``, positions 1,500 bp apart, PHENO at 9 digits
    (so that pandas reads it exactly)."""
    rng = np.random.default_rng(seed)
    n, m = dos.shape
    per = m // len(chroms)
    pick = rng.integers(0, len(ALLELES), m)
    bim = pd.DataFrame({
        'CHR': np.repeat(chroms, per), 'SNP': [f'rs{i}' for i in range(m)],
        'CM': 0.0, 'POS': np.tile(np.arange(1, per + 1) * 1500, len(chroms)),
        'A1': [ALLELES[i][0] for i in pick],
        'A2': [ALLELES[i][1] for i in pick]})
    if pheno is None:
        pheno = np.round(rng.standard_normal(n), 9)
    fam = pd.DataFrame({'FID': [f'F{i}' for i in range(n)],
                        'IID': [f'I{i}' for i in range(n)], 'father': 0,
                        'mother': 0, 'sex': 1, 'PHENO': pheno})
    return bim, fam


def make_dosages(n, m, seed, missing=0.02):
    rng = np.random.default_rng(seed)
    dos = simulate.simulate_dosages(n, m, rng=rng)
    dos[rng.random(dos.shape) < missing] = np.nan
    dos[:, 3] = np.nan      # no call at all: imputes to 0
    dos[:, 4] = 1.0         # monomorphic: sd 0
    return dos


@pytest.fixture(scope='module')
def filesets(tmp_path_factory):
    """{n: prefix} of one fileset per sample count (m = 300), plus 'split':
    the n = 200 fileset as one fileset per chromosome."""
    root = str(tmp_path_factory.mktemp('geno'))
    out = {}
    for n in (37, 200):
        dos = make_dosages(n, 300, seed=n)
        bim, fam = plink_frames(dos, seed=n)
        out[n] = write_plink_bed(osp.join(root, f'g{n}'), dos, bim, fam)
        if n == 200:
            for c in CHROMS:
                sel = (bim['CHR'] == c).values
                write_plink_bed(osp.join(root, f'split_chr{c}'), dos[:, sel],
                                bim[sel].reset_index(drop=True), fam)
    out['split'] = osp.join(root, 'split_chr*')
    out['root'] = root
    return out


def both(prefix, **kw):
    return (genotype.GenotypeMatrix(prefix, device='cpu', **kw),
            jax_genotype.GenotypeMatrix(prefix, **kw))


def assert_prs_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def assert_gwas_close(got, want):
    """SumstatsTables: the same variants; BETA/SE/Z within rtol 1e-10, P
    within rtol 1e-8."""
    t, j = got.table, want.table
    assert t.columns == list(j.columns)
    assert_table_is_frame(t.select(['CHR', 'SNP', 'POS', 'A1', 'A2', 'N']),
                          j[['CHR', 'SNP', 'POS', 'A1', 'A2', 'N']])
    for col in ('BETA', 'SE', 'Z'):
        np.testing.assert_allclose(t[col], j[col].values, rtol=1e-10,
                                   atol=1e-15, err_msg=col)
    np.testing.assert_allclose(t['P'], j['P'].values, rtol=1e-8)


# ------------------------------------------------------------- decoding
@pytest.mark.parametrize('select', ['all', 'pairs', 'iids', 'extract'])
@pytest.mark.parametrize('n', [37, 200])
def test_dosages_and_standardized_match_jax(filesets, n, select):
    """Decoding (the padding codes of the last byte of a row, missing
    calls), sample selection before imputation, ``keep_samples`` as (FID,
    IID) pairs or as IIDs, and ``extract_snps``."""
    rng = np.random.default_rng(n)
    kw = {}
    if select == 'pairs':
        kw['keep_samples'] = [(f'F{i}', f'I{i}') for i in range(n)
                              if rng.random() < 0.6]
    elif select == 'iids':
        kw['keep_samples'] = {f'I{i}' for i in range(n) if rng.random() < 0.6}
    elif select == 'extract':
        kw['extract_snps'] = [f'rs{i}' for i in range(300) if i % 3]
    p, j = both(filesets[n], **kw)
    assert p.shape == j.shape and p.chromosomes == j.chromosomes
    assert_table_is_frame(p.bim, j.bim)
    assert_table_is_frame(p.fam, j.fam)
    want = j.dosages()
    got = p.dosages()
    assert got.dtype == np.float64 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p.dosages(impute=False),
                                  j.dosages(impute=False))
    sel = np.arange(5, 200, 7)
    np.testing.assert_array_equal(p.dosages(sel), j.dosages(sel))
    np.testing.assert_allclose(p.standardized(), j.standardized(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p.standardized(sel), j.standardized(sel),
                               rtol=0, atol=1e-12)
    assert sum(genotype_launches().values()) == 0


def genotype_launches():
    from viprs_tpu_torch.ops import cavi_cuda
    return cavi_cuda.LAUNCHES


@pytest.mark.parametrize('n', [37, 200])
def test_score_and_gwas_match_jax(filesets, n):
    """``score`` with a {chrom: array} dict and with an (m, S) array
    (standardized and raw dosages, chunks smaller than m), and
    ``perform_gwas``."""
    p, j = both(filesets[n])
    rng = np.random.default_rng(1)
    beta = rng.standard_normal((p.m, 3))
    for chunk in (4096, 64):
        assert_prs_close(p.score(beta, chunk=chunk), j.score(beta))
        assert_prs_close(p.score(beta[:, 0], standardize=False, chunk=chunk),
                         j.score(beta[:, 0], standardize=False))
    as_dict = {c: beta[(p.bim['CHR'] == c), :1] for c in p.chromosomes}
    assert_prs_close(p.score(as_dict), j.score(as_dict))
    assert p.predict(beta[:, 1]).shape == (n,)
    y = np.asarray(p.fam['PHENO'], np.float64)
    assert_gwas_close(p.perform_gwas(y, chunk=64), j.perform_gwas(y))
    stages = p.timings
    assert set(stages) == {'tables', 'bed_read', 'upload', 'decode',
                           'product'}
    assert all(v >= 0 for v in stages.values())
    with pytest.raises(ValueError, match='rows'):
        p.score(beta[:-1])


def test_multi_genotype_matches_jax(filesets):
    """One fileset a chromosome: ``MultiGenotypeMatrix`` scores and runs
    GWAS as the JAX package's, and refuses dense access (so ``compute_ld``
    over several filesets raises in both packages)."""
    from viprs_tpu_torch.utils.system import get_filenames
    prefixes = [f[:-4] for f in get_filenames(filesets['split'] + '.bed')]
    p = genotype.open_genotypes(prefixes, device='cpu')
    j = jax_genotype.open_genotypes(prefixes)
    assert isinstance(p, genotype.MultiGenotypeMatrix)
    assert p.shape == j.shape and p.chromosomes == j.chromosomes
    assert_table_is_frame(p.bim, j.bim)
    beta = np.random.default_rng(2).standard_normal((p.m, 2))
    assert_prs_close(p.score(beta), j.score(beta))
    assert_prs_close(p.score(beta[:, 0]), j.score(beta[:, 0]))
    # the same variants in one fileset
    one = genotype.GenotypeMatrix(filesets[200], device='cpu')
    assert_prs_close(p.score(beta), one.score(beta))
    y = np.asarray(p.fam['PHENO'], np.float64)
    assert_gwas_close(p.perform_gwas(y), j.perform_gwas(y))
    assert set(p.timings) >= {'bed_read', 'decode', 'product'}
    for g in (p, j):
        with pytest.raises(NotImplementedError, match='across filesets'):
            g.standardized()
    for cls in (GWADataLoader, JaxLoader):
        kw = {'device': 'cpu'} if cls is GWADataLoader else {}
        loader = cls(bed_files=filesets['split'] + '.bed', **kw)
        with pytest.raises(NotImplementedError, match='across filesets'):
            loader.compute_ld('block')


def test_genotype_refusals(filesets, tmp_path):
    """A CUDA device without CUDA raises (genotypes never fall back to the
    CPU); a file that is not a variant-major BED, and a BED shorter than
    its .bim, raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            genotype.GenotypeMatrix(filesets[37])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GWADataLoader(bed_files=filesets[37])
    bad = str(tmp_path / 'bad')
    for ext in ('.bim', '.fam'):
        with open(filesets[37] + ext) as src, open(bad + ext, 'w') as dst:
            dst.write(src.read())
    with open(filesets[37] + '.bed', 'rb') as f:
        body = f.read()
    with open(bad + '.bed', 'wb') as f:
        f.write(b'\x6c\x1b\x00' + body[3:])
    with pytest.raises(ValueError, match='variant-major'):
        genotype.GenotypeMatrix(bad, device='cpu')
    with open(bad + '.bed', 'wb') as f:
        f.write(body[:3 + 10 * 10])
    g = genotype.GenotypeMatrix(bad, device='cpu')
    with pytest.raises(ValueError, match='holds 10 variants'):
        g.dosages()


# ----------------------------------------------------------- LD estimation
LD_CASES = {
    'sample': ('sample', {}),
    'block': ('block', {'max_block_size': 70}),
    'block-ldetect': ('block', {'block_file': True}),
    'windowed': ('windowed', {'window_kb': 40}),
    'shrinkage': ('shrinkage', {'max_block_size': 90}),
    'shrinkage-ldetect': ('shrinkage', {'block_file': True, 'cutoff': 0.05}),
}


def write_ldetect(root):
    """An LDetect boundary file (chr start stop, 'chr' prefixes): chromosome
    21 in three blocks, 22 in two."""
    path = osp.join(root, 'ldetect.bed')
    with open(path, 'w') as f:
        f.write('chr\tstart\tstop\n'
                'chr21\t1\t60000\nchr21\t60000\t150000\n'
                'chr21\t150000\t300000\nchr22\t1\t100000\n'
                'chr22\t100000\t300000\n')
    return path


@pytest.mark.parametrize('case', sorted(LD_CASES))
def test_ld_estimators_match_jax(filesets, case):
    """The loader's ``compute_ld`` with each estimator (and with an LDetect
    block file) against the JAX package's: the same blocks within 1e-12
    and the same variant tables."""
    estimator, kw = LD_CASES[case]
    kw = dict(kw)
    if kw.get('block_file'):
        kw['block_file'] = write_ldetect(filesets['root'])
    pl = GWADataLoader(bed_files=filesets[200], device='cpu')
    jl = JaxLoader(bed_files=filesets[200])
    assert pl.compute_ld(estimator, **kw) is pl
    jl.compute_ld(estimator, **kw)
    assert sorted(pl.ld_blocks) == sorted(jl.ld_blocks)
    for c in jl.ld_blocks:
        assert len(pl.ld_blocks[c]) == len(jl.ld_blocks[c])
        for a, b in zip(pl.ld_blocks[c], jl.ld_blocks[c]):
            assert a.dtype == np.float64 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert_table_is_frame(pl.ld_snp_tables[c], jl.ld_snp_tables[c])
    if kw.get('block_file'):
        got = ld_estimators.read_ldetect_blocks(kw['block_file'])
        want = jax_ld.read_ldetect_blocks(kw['block_file'])
        assert_table_is_frame(got, want)


# ------------------------------------------------------------ the loader
PHENO_CASES = ('fam', 'file-gaussian', 'file-12', 'file-01', 'binomial-asked')


@pytest.mark.parametrize('case', PHENO_CASES)
def test_loader_genotype_surface_matches_jax(filesets, tmp_path, case):
    """GWADataLoader(bed_files=, phenotype_file=): the phenotype (from the
    .fam's PHENO, or a file matched on FID/IID with rows missing and out of
    order; plink's 1/2 coding becomes 0/1; the likelihood inferred or
    asked for), the sample and phenotype tables, the views, ``score``, and
    ``perform_gwas`` with and without LD (harmonized when LD is present)."""
    prefix = filesets[200]
    rng = np.random.default_rng(5)
    kw = {}
    if case != 'fam':
        vals = {'file-gaussian': np.round(rng.standard_normal(200), 9),
                'file-12': rng.integers(1, 3, 200).astype(float),
                'file-01': rng.integers(0, 2, 200).astype(float),
                'binomial-asked': rng.integers(0, 2, 200).astype(float)}[case]
        order = rng.permutation(200)
        if case != 'file-gaussian':
            order = order[:180]             # 20 samples without a row
        path = str(tmp_path / 'pheno.txt')
        pd.DataFrame({'FID': [f'F{i}' for i in order],
                      'IID': [f'I{i}' for i in order],
                      'y': vals[order]}).to_csv(path, sep=' ', header=False,
                                                index=False)
        kw['phenotype_file'] = path
        if case == 'binomial-asked':
            kw['phenotype_likelihood'] = 'binomial'
    pl = GWADataLoader(bed_files=prefix, device='cpu', **kw)
    jl = JaxLoader(bed_files=prefix, **kw)
    np.testing.assert_array_equal(pl.phenotype, jl.phenotype)
    assert pl.phenotype_likelihood == jl.phenotype_likelihood
    assert pl.n == jl.n == 200
    assert pl.chromosomes == jl.chromosomes
    assert pl.shapes == jl.shapes
    assert_table_is_frame(pl.sample_table, jl.sample_table)
    np.testing.assert_array_equal(pl.sample_table.phenotype,
                                  jl.sample_table.phenotype)
    assert_table_is_frame(pl.to_individual_table(), jl.to_individual_table())
    assert_table_is_frame(pl.to_phenotype_table(), jl.to_phenotype_table())
    assert_table_is_frame(pl.to_snp_table(), jl.to_snp_table())
    for c, t in pl.to_snp_table(per_chromosome=True).items():
        assert_table_is_frame(t, jl.to_snp_table(per_chromosome=True)[c])
    beta = rng.standard_normal(pl.m)
    assert_prs_close(pl.score(beta), jl.score(beta))
    assert_prs_close(pl.predict({c: beta[:150] for c in CHROMS}),
                     jl.predict({c: beta[:150] for c in CHROMS}))
    if case != 'fam' and case != 'file-gaussian':
        # samples without a phenotype reach the GWAS unmasked, as in the
        # JAX package: every statistic is NaN in both
        got, want = pl.perform_gwas(), jl.perform_gwas()
        assert np.isnan(got.table['BETA']).all()
        assert np.isnan(want.table['BETA'].values).all()
        return
    assert_gwas_close(pl.perform_gwas(), jl.perform_gwas())
    assert pl.sumstats_table is None
    pl.compute_ld('block', max_block_size=80)
    jl.compute_ld('block', max_block_size=80)
    assert_gwas_close(pl.perform_gwas(), jl.perform_gwas())
    for c in jl.sumstats_table:
        got, want = pl.sumstats_table[c], jl.sumstats_table[c]
        for col in ('BETA', 'Z', 'N'):
            np.testing.assert_allclose(got.table[col], want.table[col].values,
                                       rtol=1e-10, atol=1e-15)
    ds = pl.to_summary_dataset(device='cpu')
    jds = jl.to_summary_dataset()
    for c in jds.std_beta:
        np.testing.assert_allclose(ds.std_beta[c], jds.std_beta[c],
                                   rtol=1e-10, atol=1e-15)
    with pytest.raises(ValueError, match='genotype'):
        GWADataLoader().compute_ld()
    with pytest.raises(ValueError, match='genotypes and a phenotype'):
        GWADataLoader().perform_gwas()


def test_phenotype_without_genotypes_matches_jax(tmp_path):
    """A phenotype file alone: its column, 1/2 coding made 0/1."""
    path = str(tmp_path / 'p.txt')
    with open(path, 'w') as f:
        f.write('F1 I1 1 7\nF2 I2 2 8\nF3 I3 2 9\n')
    for col in (2, 3):
        pl, jl = GWADataLoader(), JaxLoader()
        pl.read_phenotype(path, pheno_col=col)
        jl.read_phenotype(path, pheno_col=col)
        np.testing.assert_array_equal(pl.phenotype, jl.phenotype)
        assert pl.phenotype_likelihood == jl.phenotype_likelihood
    assert GWADataLoader().sample_table is None


# -------------------------------------------------------------- simulate
@pytest.mark.parametrize('seed', [0, 3])
def test_simulate_matches_jax(seed):
    """``simulate_sumstats_blocks`` and ``simulate_genotypes`` give the JAX
    package's arrays bit for bit; ``simulate_dosages`` is the 0/1/2 matrix
    that ``simulate_genotypes`` standardizes."""
    kw = dict(n=300, block_sizes=(40, 25), h2=0.4, prop_causal=0.1, seed=seed)
    got, want = simulate.simulate_sumstats_blocks(**kw), \
        jax_simulate.simulate_sumstats_blocks(**kw)
    assert sorted(got) == sorted(want)
    for k in ('genotypes', 'phenotype'):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ('std_beta', 'n_per_snp', 'beta_true'):
        np.testing.assert_array_equal(got[k][22], want[k][22])
    for a, b in zip(got['ld_blocks'][22], want['ld_blocks'][22]):
        np.testing.assert_array_equal(a, b)
    assert (got['h2'], got['n'], got['m']) == (want['h2'], want['n'],
                                               want['m'])
    x = simulate.simulate_genotypes(50, 30, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(x, jax_simulate.simulate_genotypes(
        50, 30, rng=np.random.default_rng(seed)))
    d = simulate.simulate_dosages(50, 30, rng=np.random.default_rng(seed))
    assert set(np.unique(d)) <= {0.0, 1.0, 2.0}
    np.testing.assert_array_equal(simulate._standardize(d), x)


def test_plink_table_reader(tmp_path):
    """.bim/.fam tables are typed as pandas types them (int CHR and POS,
    float CM, str alleles); a wrong column count raises."""
    path = str(tmp_path / 'x.bim')
    with open(path, 'w') as f:
        f.write('1\trs1\t0\t100\tA\tG\n1\trs2\t0.5\t200\tC\tT\n')
    t = genotype.read_plink_table(path, genotype.BIM_COLUMNS)
    want = pd.read_csv(path, sep=r'\s+', header=None,
                       names=list(genotype.BIM_COLUMNS))
    assert_table_is_frame(t, want)
    assert isinstance(t, Table) and t['CHR'].dtype == np.int64
    with pytest.raises(ValueError, match='columns'):
        genotype.read_plink_table(path, genotype.FAM_COLUMNS[:5])
