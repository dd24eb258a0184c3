"""Scoring and evaluation on the port against the JAX package, on the CPU:
``model.predict`` on a genotype loader, ``harmonize_data`` with flipped
alleles, the parameter files (``write_inferred_parameters`` /
``read_inferred_parameters``), ``viprs_score_torch`` and
``viprs_evaluate_torch`` against ``viprs_tpu.cli.score`` / ``evaluate`` on
the same files, the two run with jax, viprs_tpu, pandas and sklearn
blocked, and ``viprs_fit_torch --hyp-search GS --grid-metric validation``
against the JAX CLI.

The files: plink filesets of simulated AR(1) genotypes (the port's
``simulate_dosages``) on chromosomes 20 and 22, a training set with its
phenotype in the .fam, the JAX package's block LD of it and its GWAS
written at 12 digits; a validation set whose .bim swaps 10% of the
alleles (its dosages counted from the other allele), with a phenotype
file. Tolerances: PRS within rtol 1e-10 (atol 1e-12 of the largest
score); harmonized effects bit for bit; .eval values within 1e-9; the
validation-selected fit as ``tests/test_torch_cli.py`` holds a fit
(``assert_outputs_match``: Validation_R2 within rtol 1e-6 and the same
selected row), every JAX fit guarded by ``assert_clear_of_thresholds``.
"""

import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from viprs_tpu.cli import evaluate as jax_evaluate
from viprs_tpu.cli import fit as jax_fit
from viprs_tpu.cli import score as jax_score
from viprs_tpu.data import ld_store as jax_ld_store
from viprs_tpu.data.loader import GWADataLoader as JaxLoader
from viprs_tpu.model import VIPRS as JaxVIPRS

from viprs_tpu_torch.cli import evaluate, fit, score
from viprs_tpu_torch.data import pack_cache, simulate
from viprs_tpu_torch.data.loader import GWADataLoader
from viprs_tpu_torch.eval.continuous import r2
from viprs_tpu_torch.gridsearch import (GridSearch, HyperparameterGrid,
                                        select_best_model)
from viprs_tpu_torch.model import VIPRS, VIPRSGrid
from viprs_tpu_torch.ops import cavi_cuda
from viprs_tpu_torch.utils.table import read_table

from plink_utils import write_plink_bed
from test_torch_cli import MAX_ITER, assert_each_fit_clear, \
    assert_outputs_match
from test_torch_viprs import REPO, ladder_trace  # noqa: F401

CHROMS = (20, 22)
M_CHROM = 150
N_TRAIN, N_VAL = 1201, 301
ALLELES = (('A', 'G'), ('C', 'T'), ('G', 'A'), ('T', 'C'), ('A', 'C'))


@pytest.fixture(autouse=True)
def no_pack_cache(monkeypatch):
    monkeypatch.setenv('VIPRS_TPU_PACK_CACHE', 'off')
    monkeypatch.setenv(pack_cache.ENV, 'off')


def _frames(prefix_ids, n, rng, pheno=None):
    return pd.DataFrame({'FID': [f'{prefix_ids}F{i}' for i in range(n)],
                         'IID': [f'{prefix_ids}I{i}' for i in range(n)],
                         'father': 0, 'mother': 0, 'sex': 1,
                         'PHENO': -9 if pheno is None else pheno})


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('score'))
    rng = np.random.default_rng(0)
    n = N_TRAIN + N_VAL
    m = M_CHROM * len(CHROMS)
    dos = np.concatenate([simulate.simulate_dosages(n, 50, rho=0.7, rng=rng)
                          for _ in range(m // 50)], axis=1)
    x = (dos - dos.mean(0)) / dos.std(0)
    beta = np.where(rng.random(m) < 0.1, rng.standard_normal(m), 0.0)
    g = x @ beta
    y = np.round(g / g.std() * np.sqrt(0.5)
                 + rng.standard_normal(n) * np.sqrt(0.5), 9)
    dos[rng.random(dos.shape) < 0.01] = np.nan
    pick = rng.integers(0, len(ALLELES), m)
    bim = pd.DataFrame({
        'CHR': np.repeat(CHROMS, M_CHROM),
        'SNP': [f'rs{c}_{i}' for c in CHROMS for i in range(M_CHROM)],
        'CM': 0.0, 'POS': np.tile(np.arange(1, M_CHROM + 1) * 2000, 2),
        'A1': [ALLELES[i][0] for i in pick],
        'A2': [ALLELES[i][1] for i in pick]})
    train = write_plink_bed(osp.join(root, 'train'), dos[:N_TRAIN], bim,
                            _frames('t', N_TRAIN, rng, y[:N_TRAIN]))
    # the validation set: 10% of the alleles swapped, its dosages counting
    # the other allele
    swap = rng.random(m) < 0.1
    vbim = bim.copy()
    vbim.loc[swap, 'A1'], vbim.loc[swap, 'A2'] = bim['A2'][swap], \
        bim['A1'][swap]
    vdos = dos[N_TRAIN:].copy()
    vdos[:, swap] = 2.0 - vdos[:, swap]
    vfam = _frames('v', N_VAL, rng)
    val = write_plink_bed(osp.join(root, 'val'), vdos, vbim, vfam)
    for c in CHROMS:
        sel = (vbim['CHR'] == c).values
        write_plink_bed(osp.join(root, f'val_chr{c}'), vdos[:, sel],
                        vbim[sel].reset_index(drop=True), vfam)
    vp = pd.DataFrame({'FID': vfam['FID'], 'IID': vfam['IID'],
                       'y': y[N_TRAIN:]})
    vp.to_csv(osp.join(root, 'val_pheno.txt'), sep=' ', header=False,
              index=False)
    binary = vp.assign(y=np.where(vp['y'] > 0.3, 2, 1))
    binary.to_csv(osp.join(root, 'val_binary.txt'), sep=' ', header=False,
                  index=False)
    cov = pd.DataFrame({'FID': vfam['FID'], 'IID': vfam['IID'],
                        'c0': np.round(rng.standard_normal(N_VAL), 9),
                        'c1': rng.integers(0, 2, N_VAL)})
    cov.iloc[::-1].to_csv(osp.join(root, 'val_cov.txt'), sep=' ',
                          header=False, index=False)
    with open(osp.join(root, 'keep.txt'), 'w') as f:
        f.write('\n'.join(f'{a} {b}' for a, b in
                          zip(vfam['FID'][::3], vfam['IID'][::3])) + '\n')
    with open(osp.join(root, 'extract.txt'), 'w') as f:
        f.write('\n'.join(bim['SNP'][bim.index % 4 != 1]) + '\n')

    jl = JaxLoader(bed_files=train)
    jl.compute_ld('block', max_block_size=50)
    jax_ld_store.save_ld_store(osp.join(root, 'ld'), jl.ld_blocks,
                               jl.ld_snp_tables, quantize=True)
    ss = jl.perform_gwas().table
    ss.to_csv(osp.join(root, 'sumstats.txt'), sep='\t', index=False,
              float_format='%.12g')
    return root


@pytest.fixture(scope='module')
def fitted(files):
    """The port's VIPRS and 3-point VIPRSGrid fitted on the training LD and
    GWAS, the JAX dataset, and both packages' validation loaders."""
    args = dict(ld_store_files=osp.join(files, 'ld'),
                sumstats_files=osp.join(files, 'sumstats.txt'),
                block_size=128)
    ds = GWADataLoader(**args).to_summary_dataset(device='cpu')
    jds = JaxLoader(**args).to_summary_dataset()
    np.random.seed(4)
    m = VIPRS(ds, 'cpu').fit(max_iter=20, sweep_impl='xla')
    np.random.seed(4)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3,
                                         h2_est=0.5), 'cpu')
    g.fit(max_iter=20)
    vargs = dict(bed_files=osp.join(files, 'val'),
                 phenotype_file=osp.join(files, 'val_pheno.txt'))
    return dict(viprs=m, grid=g, jds=jds,
                vl=GWADataLoader(device='cpu', **vargs),
                jvl=JaxLoader(**vargs))


def assert_prs_close(got, want):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


# ------------------------------------------------------------- the models
@pytest.mark.parametrize('model', ['viprs', 'grid'])
def test_predict_and_harmonize_match_jax(fitted, model):
    """predict(test_gdl) of a fitted model, (n,) for one model and (n, S)
    for the grid's lanes, and harmonize_data onto the validation variants
    (10% of the alleles swapped), against the JAX package's harmonization
    of the same posterior table and its genotype scoring."""
    m, vl, jvl = fitted[model], fitted['vl'], fitted['jvl']
    table = m._posterior_tables()
    if model == 'grid':
        assert [c for c in table.columns if 'BETA' in c][:3] == \
            ['BETA_0', 'BETA_1', 'BETA_2']
    jm = JaxVIPRS(fitted['jds'], mesh='off')
    want = jm.harmonize_data(gdl=jvl, parameter_table=table.to_pandas())
    got = m.harmonize_data(gdl=vl)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for c in w:
            np.testing.assert_array_equal(g[c], w[c])
    prs = m.predict(test_gdl=vl)
    assert prs.shape == ((N_VAL,) if model == 'viprs' else (N_VAL, 3))
    assert_prs_close(prs, jvl.score(want[1]))
    with pytest.raises(ValueError, match='does not support scoring'):
        m.predict()
    assert m.harmonize_data() is None
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_parameter_files_round_trip_with_jax(fitted, tmp_path):
    """The port writes a .fit file (one file, and one a chromosome) that
    the JAX package reads into the same posterior, and reads the JAX
    package's back bit for bit; set_model_parameters with a table whose
    alleles are swapped flips the signs of BETA, as the JAX package's."""
    m, jds = fitted['viprs'], fitted['jds']
    ds = m.dataset
    path = str(tmp_path / 'port')
    m.write_inferred_parameters(path)
    assert osp.exists(path + '.fit')
    jm = JaxVIPRS(jds, mesh='off')
    jm.read_inferred_parameters(path + '.fit')
    # float32 values written as their shortest repr: read back as float64
    # they round to the same float32
    for c in m.chromosomes:
        for got, want in ((m.post_mean_beta, jm.post_mean_beta),
                          (m.pip, jm.pip), (m.post_var_beta,
                                            jm.post_var_beta)):
            np.testing.assert_array_equal(got[c], np.float32(want[c]))
    jpath = str(tmp_path / 'jax.fit')
    jm.write_inferred_parameters(jpath)
    back = VIPRS(ds, 'cpu')
    back.read_inferred_parameters(jpath)
    for c in m.chromosomes:
        np.testing.assert_array_equal(back.post_mean_beta[c],
                                      jm.post_mean_beta[c])
        np.testing.assert_array_equal(back.pip[c], jm.pip[c])
        np.testing.assert_array_equal(back.post_var_beta[c],
                                      jm.post_var_beta[c])
    per = tmp_path / 'per'
    per.mkdir()
    m.write_inferred_parameters(str(per), per_chromosome=True)
    assert sorted(os.listdir(per)) == ['chr_20.fit', 'chr_22.fit']
    both = VIPRS(ds, 'cpu')
    both.read_inferred_parameters([str(per / 'chr_20.fit'),
                                   str(per / 'chr_22.fit')])
    for c in m.chromosomes:
        np.testing.assert_array_equal(both.post_mean_beta[c],
                                      back.post_mean_beta[c])
    flipped = read_table(path + '.fit')
    flip = np.arange(len(flipped)) % 3 == 0
    a1 = flipped['A1'].copy()
    flipped['A1'] = np.where(flip, flipped['A2'], a1)
    flipped['A2'] = np.where(flip, a1, flipped['A2'])
    got = VIPRS(ds, 'cpu')
    got.set_model_parameters(flipped)
    jm.set_model_parameters(flipped.to_pandas())
    for c in m.chromosomes:
        np.testing.assert_array_equal(got.post_mean_beta[c],
                                      jm.post_mean_beta[c])
    flat = np.concatenate([got.post_mean_beta[c] for c in CHROMS])
    plain = np.concatenate([back.post_mean_beta[c] for c in CHROMS])
    np.testing.assert_array_equal(np.float32(flat[flip]),
                                  np.float32(-plain[flip]))
    np.testing.assert_array_equal(np.float32(flat[~flip]),
                                  np.float32(plain[~flip]))


def test_grid_search_validation_matches_select(fitted):
    """GridSearch(criterion='validation') scores each lane's PRS on the
    validation loader: its Validation_R2 are the R^2 of predict's
    columns, -inf where a lane did not terminate validly."""
    from viprs_tpu.eval.continuous import r2 as jax_r2
    vl = fitted['vl']
    g = fitted['grid']
    prs = g.predict(test_gdl=vl)
    want = np.array([jax_r2(vl.phenotype, prs[:, i]) for i in range(3)])
    want[~g.valid_terminated_models] = -np.inf
    ds = g.dataset
    np.random.seed(4)
    gs = GridSearch(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3,
                                           h2_est=0.5), 'cpu',
                    criterion='validation', validation_gdl=vl)
    best = gs.fit(max_iter=20)
    np.testing.assert_allclose(gs.validation_result['Validation_R2'], want,
                               rtol=1e-12)
    assert best.n_models == 1
    assert np.allclose(best.post_mean_beta[20], g.post_mean_beta[20][
        :, int(np.argmax(want))])
    np.random.seed(4)
    g2 = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3,
                                          h2_est=0.5), 'cpu')
    g2.fit(max_iter=20)
    select_best_model(g2, validation_gdl=vl, criterion='validation')
    np.testing.assert_array_equal(g2.validation_result['Validation_R2'],
                                  gs.validation_result['Validation_R2'])


class _StubGrid:
    """The surface select_best_model reads of a grid: three lanes, the
    last not validly terminated, its PRS constant (a lane whose fit ended
    in error can hold all-zero effects)."""

    def __init__(self, prs):
        self.n_models = 3
        self.valid_terminated_models = np.array([True, True, False])
        self.validation_std_beta = None
        self.validation_result = {}
        self._prs = prs
        self.collapsed = None

    def predict(self, test_gdl=None):
        return self._prs

    def collapse_to_model(self, idx):
        self.collapsed = idx


def test_validation_criterion_skips_invalid_lanes():
    """select_best_model('validation') scores only validly terminated
    lanes; the others score -inf unscored. The JAX package scores every
    lane first, so a constant PRS of an invalid lane raises there
    (ROADMAP.md, Queue 3); where it does not, both give the same scores."""
    from types import SimpleNamespace

    from viprs_tpu.eval.continuous import r2 as jax_r2
    from viprs_tpu.gridsearch import select_best_model as jax_select
    rng = np.random.default_rng(3)
    y = rng.standard_normal(50)
    prs = np.column_stack([y + rng.standard_normal(50),
                           y + 3 * rng.standard_normal(50), np.zeros(50)])
    vl = SimpleNamespace(phenotype=y)
    with pytest.raises(ValueError, match='identical'):
        jax_select(_StubGrid(prs), validation_gdl=vl, criterion='validation')
    got = select_best_model(_StubGrid(prs), validation_gdl=vl,
                            criterion='validation')
    want = [jax_r2(y, prs[:, 0]), jax_r2(y, prs[:, 1]), -np.inf]
    np.testing.assert_array_equal(got.validation_result['Validation_R2'],
                                  want)
    assert got.collapsed == 0
    prs[:, 2] = rng.standard_normal(50)
    j = jax_select(_StubGrid(prs), validation_gdl=vl, criterion='validation')
    p = select_best_model(_StubGrid(prs), validation_gdl=vl,
                          criterion='validation')
    np.testing.assert_array_equal(p.validation_result['Validation_R2'],
                                  j.validation_result['Validation_R2'])
    assert p.collapsed == j.collapsed == 0


# ----------------------------------------------------------- the CLIs
def _fit_file(files, tmp_path, two):
    """A .fit file of random effects on the training variants (two BETA
    columns when ``two``), 10% of the alleles swapped with BETA negated,
    and a variant the genotypes lack."""
    rng = np.random.default_rng(7)
    bim = pd.read_csv(osp.join(files, 'train.bim'), sep=r'\s+', header=None,
                      names=['CHR', 'SNP', 'CM', 'POS', 'A1', 'A2'])
    t = bim[['CHR', 'SNP', 'POS', 'A1', 'A2']].copy()
    cols = ['BETA_0', 'BETA_1'] if two else ['BETA']
    swap = rng.random(len(t)) < 0.1
    for c in cols:
        t[c] = np.round(rng.standard_normal(len(t)) * 0.05, 12)
        t.loc[swap, c] = -t.loc[swap, c]
    t.loc[swap, 'A1'], t.loc[swap, 'A2'] = bim['A2'][swap], bim['A1'][swap]
    t['PIP'] = 0.5
    t['VAR_BETA'] = 1e-4
    t.loc[len(t)] = [22, 'rsX', 1, 'A', 'G', *[0.1] * len(cols), 0.5, 1e-4]
    path = str(tmp_path / ('two.fit' if two else 'one.fit.gz'))
    t.to_csv(path, sep='\t', index=False)
    return path


SCORE_MODES = {
    'one': [],
    'per-chromosome': ['--bed-files', '{root}/val_chr*.bed'],
    'keep': ['--keep', '{root}/keep.txt'],
    'extract': ['--extract', '{root}/extract.txt'],
    'compress': ['--compress'],
    'two-betas': [],
}


@pytest.mark.parametrize('mode', sorted(SCORE_MODES))
def test_score_cli_matches_jax(files, tmp_path, mode):
    fit_path = _fit_file(files, tmp_path, two=mode == 'two-betas')
    extra = [a.format(root=files) for a in SCORE_MODES[mode]]
    base = ['-f', fit_path]
    if '--bed-files' not in extra:
        base += ['--bed-files', osp.join(files, 'val')]
    jp, tp = str(tmp_path / 'jax'), str(tmp_path / 'port')
    assert jax_score.main(base + extra + ['--output-file', jp]) == 0
    rec = score.run(base + extra + ['--output-file', tp, '--device', 'cpu'])
    suffix = '.prs.gz' if mode == 'compress' else '.prs'
    assert rec['output'] == tp + suffix and rec['device'] == 'cpu'
    j, t = (pd.read_csv(p + suffix, sep='\t') for p in (jp, tp))
    assert list(t.columns) == list(j.columns)
    assert list(t['IID']) == list(j['IID']) and list(t['FID']) == \
        list(j['FID'])
    prs = [c for c in j.columns if c.startswith('PRS')]
    assert prs == (['PRS_0', 'PRS_1'] if mode == 'two-betas' else ['PRS'])
    assert_prs_close(t[prs].values, j[prs].values)
    assert rec['n'] == len(j) and rec['matched'] == \
        (225 if mode == 'extract' else 300)
    assert set(rec['seconds']) >= {'tables', 'fit_read', 'harmonize',
                                   'bed_read', 'upload', 'decode', 'product',
                                   'write', 'total'}


def test_score_cli_refusals(files, tmp_path):
    """A CUDA device without CUDA is an error (never the CPU); a .fit file
    without BETA columns, or none of whose variants the genotypes have,
    is refused as by the JAX package."""
    import torch
    base = ['--bed-files', osp.join(files, 'val'), '--output-file',
            str(tmp_path / 'o')]
    fit_path = _fit_file(files, tmp_path, two=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='--device cpu'):
            score.main(['-f', fit_path] + base)
    t = pd.read_csv(fit_path, sep='\t')
    no_beta = str(tmp_path / 'nobeta.fit')
    t.drop(columns=['BETA']).to_csv(no_beta, sep='\t', index=False)
    other = str(tmp_path / 'other.fit')
    t.assign(SNP='x' + t['SNP']).to_csv(other, sep='\t', index=False)
    for path, msg in ((no_beta, 'BETA columns'), (other, 'matched')):
        with pytest.raises(AssertionError if path == no_beta else ValueError,
                           match=None if path == no_beta else msg):
            jax_score.main(['-f', path] + base)
        with pytest.raises(ValueError, match=msg):
            score.main(['-f', path] + base + ['--device', 'cpu'])
    assert not osp.exists(str(tmp_path / 'o.prs'))


EVAL_MODES = {
    'gaussian': [],
    'binary': ['--phenotype-file', '{root}/val_binary.txt'],
    'covariates': ['--covariates-file', '{root}/val_cov.txt'],
    'binary-covariates': ['--phenotype-file', '{root}/val_binary.txt',
                          '--covariates-file', '{root}/val_cov.txt'],
    'keep': ['--keep', '{root}/keep.txt'],
    'every-metric': ['--metrics', 'Pearson_R', 'Spearman_R', 'MSE', 'R2',
                     'R2_residualized_target', 'Incremental_R2',
                     'Partial_Correlation', 'Nope',
                     '--covariates-file', '{root}/val_cov.txt'],
    'every-binary-metric': [
        '--phenotype-file', '{root}/val_binary.txt', '--metrics', 'AUROC',
        'AUPRC', 'Avg_Precision', 'F1_Score', 'Liability_R2',
        'Liability_Probit_R2', 'Liability_Logit_R2', 'Nagelkerke_R2',
        'CoxSnell_R2', 'McFadden_R2'],
}


@pytest.fixture(scope='module')
def prs_files(files, tmp_path_factory):
    """The validation set's PRS (one column, and two) from the port's
    score CLI."""
    root = tmp_path_factory.mktemp('prs')
    out = {}
    for two in (False, True):
        fit_path = _fit_file(files, root, two)
        out[two] = score.run(['-f', fit_path, '--bed-files',
                              osp.join(files, 'val'), '--output-file',
                              str(root / f'prs{int(two)}'), '--device',
                              'cpu'])['output']
    return out


@pytest.mark.parametrize('two', [False, True])
@pytest.mark.parametrize('mode', sorted(EVAL_MODES))
def test_evaluate_cli_matches_jax(files, prs_files, tmp_path, mode, two):
    extra = [a.format(root=files) for a in EVAL_MODES[mode]]
    base = ['--prs-file', prs_files[two]]
    if '--phenotype-file' not in extra:
        base += ['--phenotype-file', osp.join(files, 'val_pheno.txt')]
    jp, tp = str(tmp_path / 'jax'), str(tmp_path / 'port.eval')
    assert jax_evaluate.main(base + extra + ['--output-file', jp]) == 0
    assert evaluate.main(base + extra + ['--output-file', tp]) == 0
    j, t = (pd.read_csv(p, sep='\t') for p in (jp + '.eval', tp))
    assert list(t.columns) == list(j.columns)
    assert list(t['PRS']) == list(j['PRS'])
    assert list(t['Metric']) == list(j['Metric'])
    for col in ('Value', 'SE', 'P_Value'):
        if col in j:
            np.testing.assert_allclose(t[col], j[col], rtol=0, atol=1e-9,
                                       err_msg=col)
    assert len(j) == len(t) > 0


def test_score_and_evaluate_run_without_jax_pandas_sklearn(files, tmp_path):
    """``python -m viprs_tpu_torch.cli.score`` (on the CPU) and ``.evaluate``
    with jax, viprs_tpu, pandas and sklearn blocked from import."""
    fit_path = _fit_file(files, tmp_path, two=False)
    out = str(tmp_path / 'out')
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ('pandas', 'jax', 'viprs_tpu', 'sklearn'):
            sys.modules[name] = None
        for mod, argv in (
                ('score', ['-f', {fit_path!r}, '--bed-files',
                           {osp.join(files, 'val')!r}, '--output-file',
                           {out!r}, '--device', 'cpu']),
                ('evaluate', ['--prs-file', {out + '.prs'!r},
                              '--phenotype-file',
                              {osp.join(files, 'val_binary.txt')!r},
                              '--output-file', {out!r}, '--metrics',
                              'AUROC', 'AUPRC', 'Avg_Precision',
                              'F1_Score', 'McFadden_R2'])):
            sys.argv = ['viprs_' + mod + '_torch'] + argv
            try:
                runpy.run_module('viprs_tpu_torch.cli.' + mod,
                                 run_name='__main__')
            except SystemExit as e:
                assert e.code == 0, e.code
        print('ok')
    """)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith('ok')
    ev = read_table(out + '.eval', sep='\t')
    assert ev['Metric'].tolist() == ['AUROC', 'AUPRC', 'Avg_Precision',
                                     'F1_Score', 'McFadden_R2']


# ----------------------------------------- viprs_fit --grid-metric validation
FIT_MODES = {
    'validation': [],
    'validation-keep': ['--validation-keep', '{root}/keep.txt'],
}


@pytest.mark.parametrize('mode', sorted(FIT_MODES))
def test_fit_grid_metric_validation_matches_jax(files, tmp_path, mode,
                                                ladder_trace):  # noqa: F811
    """viprs_fit --hyp-search GS --grid-metric validation (the lanes scored
    on the validation genotypes against --validation-pheno) against the
    JAX CLI, run to MAX_ITER: the same outputs, Validation_R2 within rtol
    1e-6 and the same selected row."""
    extra = [a.format(root=files) for a in FIT_MODES[mode]]
    args = ['-l', osp.join(files, 'ld'), '-s',
            osp.join(files, 'sumstats.txt'), '--block-size', '128', '--seed',
            '1', '--sweep-impl', 'xla', '--max-iter', str(MAX_ITER),
            '--output-profiler-metrics', '--hyp-search', 'GS',
            '--grid-metric', 'validation', '--pi-steps', '4',
            '--validation-bed', osp.join(files, 'val'), '--validation-pheno',
            osp.join(files, 'val_pheno.txt'), *extra]
    jp, tp = str(tmp_path / 'jax' / 'out'), str(tmp_path / 'port' / 'out')
    assert jax_fit.main(args + ['--output-file', jp, '--mesh', 'off']) == 0
    assert_each_fit_clear(ladder_trace)
    rec = fit.run(args + ['--output-file', tp, '--device', 'cpu'])
    assert rec['device'] == 'cpu'
    assert_outputs_match(jp, tp)
    v = pd.read_csv(tp + '.validation', sep='\t')
    assert 'Validation_R2' in v and np.isfinite(v['Validation_R2']).any()
    # the selected lane's PRS, scored from the written .fit.gz on the
    # validation samples, has the selected row's R^2
    keep = ['--keep', osp.join(files, 'keep.txt')] \
        if mode == 'validation-keep' else []
    out = score.run(['-f', tp + '.fit.gz', '--bed-files',
                     osp.join(files, 'val'), '--output-file',
                     str(tmp_path / 'sel'), '--device', 'cpu'] + keep)
    prs = pd.read_csv(out['output'], sep='\t')
    assert len(prs) == (N_VAL if not keep else (N_VAL + 2) // 3)
    pheno = pd.read_csv(osp.join(files, 'val_pheno.txt'), sep=' ',
                        header=None, names=['FID', 'IID', 'y'])
    y = prs.merge(pheno, on=['FID', 'IID'])['y'].values
    # (the file holds the float32 BETA as its shortest decimal repr, which
    # reads back within 1e-7 of it)
    best = v['Validation_R2'].max()
    assert r2(y, prs['PRS'].values) == pytest.approx(best, rel=1e-6)
