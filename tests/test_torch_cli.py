"""The port's ``viprs_fit`` (``viprs_tpu_torch.cli.fit``, ``--device cpu``)
against the JAX package's (``viprs_tpu.cli.fit``) on the same files, and the
model pieces the CLI writes through: ``to_table``, ``to_theta_table``,
``to_validation_table``, ``set_validation_sumstats`` given a table,
``pseudo_validate(test_gdl=...)``, ``pseudo_r2``/``pseudo_pearson_r`` and
``lambda_min='infer'``.

Both CLIs run the all-active sweep (``--sweep-impl xla``, the JAX package's
rule on the CPU) on one device (``--mesh off``). Tolerances: the same
headers and SNP order; BETA, VAR_BETA and PIP within 1e-5 (absolute); the
.hyp ELBO within rtol 1e-6 and its other values within rtol 1e-5 (a
mixture's small pi_k carry the float32 state's rounding); the .validation
rows with the same grid values, the ELBOs and pseudo-R^2 within rtol 1e-6
and the same selected row; the same total iterations. The guard
``assert_clear_of_thresholds`` (tests/test_torch_viprs.py) holds each JAX
fit clear of its stopping thresholds. On these problems a fit that runs to
convergence at the CLI's tolerances passes within a factor 2 of one
threshold or another, so most modes stop at an iteration limit the ladder
is clear of (the fit's convergence is held in tests/test_torch_viprs.py
and test_torch_grid.py); the two modes that converge are clear.
"""

import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from viprs_tpu.cli import fit as jax_fit
from viprs_tpu.data.loader import GWADataLoader as JaxLoader
from viprs_tpu.data.sumstats import read_sumstats as jax_read_sumstats
from viprs_tpu.eval import pseudo as jax_pseudo
from viprs_tpu.model import VIPRS as JaxVIPRS

from viprs_tpu_torch.cli import fit
from viprs_tpu_torch.data import pack_cache
from viprs_tpu_torch.data.loader import GWADataLoader
from viprs_tpu_torch.data.sumstats import read_sumstats
from viprs_tpu_torch.eval import pseudo
from viprs_tpu_torch.model import VIPRS, VIPRSMix
from viprs_tpu_torch.utils.table import Table, read_table

from test_torch_data import assert_table_is_frame, write_fixture
from test_torch_viprs import (REPO, LadderTrace, assert_clear_of_thresholds,
                              ladder_trace)  # noqa: F401

#: Iterations of a CLI run: the fits stop at the iteration limit, clear of
#: every convergence threshold on this fixture (the guard holds the JAX
#: run to that), except where a mode sets its own.
MAX_ITER = 5
#: JAX_PLATFORMS=cpu gives the JAX package 8 virtual CPU devices
#: (tests/conftest.py), and its streaming budget is per device; the port
#: has one.
JAX_DEVICES = 8


@pytest.fixture(autouse=True)
def no_pack_cache(monkeypatch):
    monkeypatch.setenv('VIPRS_TPU_PACK_CACHE', 'off')
    monkeypatch.setenv(pack_cache.ENV, 'off')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cli'))
    write_fixture(root, n=2000, rho=(0.2, 0.6))
    write_fixture(root, n=2000, rho=(0.2, 0.6), seed=7, native=False,
                  zarr=False,
                  sumstats_name='validation.txt')
    with open(osp.join(root, 'extract.txt'), 'w') as f:
        f.write('\n'.join(f'rs{c}_{i}' for c, m in ((20, 310), (22, 260))
                          for i in range(m) if i % 5) + '\n')
    return root


def assert_each_fit_clear(trace):
    """The guard on every fit of a CLI run in turn (a grid's fit and the
    refit of its selected point are two fits): a fit starts with a loop
    call that continues no earlier one."""
    fits = []
    for c in trace.calls:
        kw = c['kw']
        if not fits or (int(kw.get('i0', 0)) == 0
                        and kw.get('init_elbo') is None):
            fits.append([])
        fits[-1].append(c)
    for calls in fits:
        one = LadderTrace()
        one.calls = calls
        assert_clear_of_thresholds(one)


def _args(root, store, extra):
    ld = osp.join(root, 'native') if store == 'native' else \
        osp.join(root, 'zarr', 'chr_*')
    return ['-l', ld, '-s', osp.join(root, 'sumstats.txt'), '--block-size',
            '128', '--seed', '1', '--sweep-impl', 'xla', '--max-iter',
            str(MAX_ITER), '--output-profiler-metrics', *extra]


def _read(prefix, name):
    path = f'{prefix}.{name}'
    return pd.read_csv(path, sep='\t') if osp.exists(path) else None


def assert_outputs_match(jp, tp):
    """The port's output files against the JAX package's."""
    jt, tt = _read(jp, 'fit.gz'), _read(tp, 'fit.gz')
    assert list(tt.columns) == list(jt.columns)
    assert list(tt['SNP']) == list(jt['SNP'])
    assert list(tt['CHR']) == list(jt['CHR'])
    for col in ('BETA', 'VAR_BETA', 'PIP'):
        np.testing.assert_allclose(tt[col], jt[col], atol=1e-5, rtol=0,
                                   err_msg=col)
    jh, th = _read(jp, 'hyp'), _read(tp, 'hyp')
    assert list(th.columns) == list(jh.columns)
    assert list(th['Parameter']) == list(jh['Parameter'])
    elbo = (jh['Parameter'] == 'ELBO').values
    np.testing.assert_allclose(th['Value'][elbo], jh['Value'][elbo],
                               rtol=1e-6)
    np.testing.assert_allclose(th['Value'][~elbo], jh['Value'][~elbo],
                               rtol=1e-5, atol=1e-12)
    if 'Chromosomes' in jh:
        assert list(th['Chromosomes']) == list(jh['Chromosomes'])
    jv, tv = _read(jp, 'validation'), _read(tp, 'validation')
    assert (jv is None) == (tv is None)
    if jv is not None:
        assert list(tv.columns) == list(jv.columns)
        for col in jv.columns:
            if col in ('ELBO', 'Pseudo_Validation_R2', 'Validation_R2'):
                np.testing.assert_allclose(tv[col], jv[col], rtol=1e-6)
            elif col != 'Optimization_message':
                assert list(tv[col]) == list(jv[col]), col
        for col in ('Pseudo_Validation_R2', 'Validation_R2'):
            if col in jv:
                assert np.argmax(tv[col].values) == np.argmax(jv[col].values)
    jf, tf = _read(jp, 'prof'), _read(tp, 'prof')
    assert list(tf.columns) == list(jf.columns)
    assert tf['Total_Iterations'][0] == jf['Total_Iterations'][0]


#: viprs_fit's modes (D0 of chip_smoke.py runs the same on the card).
MODES = {
    'VIPRS': ['--max-iter', '30'],
    'VIPRSMix': ['-m', 'VIPRSMix', '--n-components', '3'],
    'GS-PUMAS': ['--hyp-search', 'GS', '--grid-metric', 'pseudo_validation',
                 '--pi-steps', '6'],
    'BMA': ['--hyp-search', 'BMA', '--pi-steps', '6'],
    'validation-sumstats': ['--hyp-search', 'GS', '--grid-metric',
                            'pseudo_validation', '--pi-steps', '6',
                            '--validation-sumstats', '{root}/validation.txt'],
    'extract-lrld': ['--extract', '{root}/extract.txt', '--exclude-lrld',
                     '--max-iter', '30'],
    'streamed': ['--device-memory-gb', '{gb}'],
    'zarr-int8': ['--dequantize-on-the-fly', '--lambda-min', 'infer'],
}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_cli_matches_jax(tmp_path, files, mode, ladder_trace):  # noqa: F811
    root = files
    store = 'zarr' if mode == 'zarr-int8' else 'native'
    extra = [a.format(root=root, gb=2e-4) for a in MODES[mode]]
    jextra = [a.format(root=root, gb=2e-4 / JAX_DEVICES) for a in MODES[mode]]
    jp, tp = str(tmp_path / 'jax' / 'out'), str(tmp_path / 'port' / 'out')
    assert jax_fit.main(_args(root, store, jextra)
                        + ['--output-file', jp, '--mesh', 'off']) == 0
    assert_each_fit_clear(ladder_trace)
    rec = fit.run(_args(root, store, extra)
                  + ['--output-file', tp, '--device', 'cpu'])
    assert rec['device'] == 'cpu'
    assert (rec['groups'] is not None) == (mode == 'streamed')
    if mode == 'streamed':
        assert rec['groups'] == [[20], [22]]
    assert_outputs_match(jp, tp)


def test_cli_refusals(tmp_path, files):
    """A mesh that is not the number of processes (``--mesh 2x1`` in one
    process) or not a mesh spec raises before any data is read, as the JAX
    package's make_mesh refuses it; a CUDA device without CUDA is an
    error, never the CPU. ``--grid-metric validation`` without validation genotypes fails
    with the JAX package's message before any data is read, and a
    ``--validation-bed`` fileset that does not exist as it does there.
    (``--float-precision float64`` runs: test_cli_float64_matches_jax.)"""
    base = _args(files, 'native', []) + ['--output-file',
                                         str(tmp_path / 'o')]
    for extra, item in ((['--mesh', '2x1'], '2x1 != 1 processes'),
                        (['--mesh', 'bogus'], 'mesh spec')):
        with pytest.raises(ValueError, match=item):
            fit.main(base + extra + ['--device', 'cpu'])
    need = 'requires --validation-bed and --validation-pheno'
    for extra in (['--grid-metric', 'validation'],
                  ['--grid-metric', 'validation', '--validation-bed', 'x']):
        with pytest.raises(AssertionError, match=need):
            jax_fit.main(base + extra)
        with pytest.raises(ValueError, match=need):
            fit.main(base + extra + ['--device', 'cpu'])
    missing = ['--validation-bed', str(tmp_path / 'x'), '--validation-pheno',
               str(tmp_path / 'p')]
    with pytest.raises(FileNotFoundError, match='x.bim'):
        jax_fit.main(base + missing + ['--mesh', 'off'])
    with pytest.raises(FileNotFoundError, match='x.bim'):
        fit.main(base + missing + ['--device', 'cpu'])
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='--device cpu'):
            fit.main(base)
    with pytest.raises(ValueError, match='cuda or cpu'):
        fit.main(base + ['--device', 'meta'])
    assert not osp.exists(str(tmp_path / 'o.fit.gz'))


def test_cli_float64_matches_jax(tmp_path, files, ladder_trace):  # noqa: F811
    """``--float-precision float64`` as in the JAX CLI: it reaches the
    models (their float_eps) and the state stays float32; the outputs match
    the JAX CLI's at the file's iteration limit (MAX_ITER)."""
    extra = ['--float-precision', 'float64']
    jp, tp = str(tmp_path / 'jax' / 'out'), str(tmp_path / 'port' / 'out')
    assert jax_fit.main(_args(files, 'native', extra)
                        + ['--output-file', jp, '--mesh', 'off']) == 0
    assert_each_fit_clear(ladder_trace)
    rec = fit.run(_args(files, 'native', extra)
                  + ['--output-file', tp, '--device', 'cpu'])
    assert rec['nit'] == MAX_ITER
    assert_outputs_match(jp, tp)


def _gut_native(path):
    """Cut every array of a native store's .npz files down to its header:
    block sizes stay readable, LD data does not."""
    import glob
    import zipfile
    from numpy.lib import format as npf
    for f in glob.glob(osp.join(path, 'chr_*.npz')):
        heads = {}
        with zipfile.ZipFile(f) as zf:
            for name in zf.namelist():
                with zf.open(name) as member:
                    read = npf.read_array_header_1_0 \
                        if npf.read_magic(member) == (1, 0) \
                        else npf.read_array_header_2_0
                    read(member)
                    n = member.tell()
                with zf.open(name) as member:
                    heads[name] = member.read(n)
        with zipfile.ZipFile(f, 'w') as zf:
            for name, head in heads.items():
                zf.writestr(name, head)
        with np.load(f) as z, pytest.raises(ValueError):
            z[next(iter(heads))[:-4]]


def _gut_zarr(path):
    """Delete a magenpy Zarr store's LD chunk files (matrix/data)."""
    data = osp.join(path, 'matrix', 'data')
    chunks = [c for c in os.listdir(data) if not c.startswith('.')]
    assert chunks
    for c in chunks:
        os.remove(osp.join(data, c))


@pytest.mark.parametrize('store', ['native', 'zarr'])
def test_warmup_reads_only_block_boundaries(tmp_path, files, store):
    """``viprs_warmup_torch --device cpu`` on a store whose LD data is gone
    (a native store's arrays cut to their headers, a Zarr store's chunk
    files deleted) exits 0 with the JAX package's packed shapes
    (``_shape_dataset``'s M, NB, B), warms S = 1 and the grid widths, and
    leaves np.random as it was; without CUDA the default device is an
    error."""
    import shutil
    from viprs_tpu.cli.warmup import _shape_dataset
    from viprs_tpu_torch.cli import warmup
    src = osp.join(files, 'native') if store == 'native' else \
        osp.join(files, 'zarr', 'chr_20')
    path = str(tmp_path / store)
    shutil.copytree(src, path)
    want = _shape_dataset(path, 128)
    (_gut_native if store == 'native' else _gut_zarr)(path)
    argv = ['-l', path, '--block-size', '128', '--grid-widths', '4', '12',
            '--device', 'cpu']
    np.random.seed(1)
    before = np.random.get_state()[1].copy()
    assert warmup.main(argv) == 0
    rec = warmup.run(argv)
    assert np.array_equal(np.random.get_state()[1], before)
    assert (rec['m'], rec['nb'], rec['block_size']) == \
        (want.m, want.layout.nb, want.layout.block_size)
    assert rec['widths'] == [1, 4, 12] and rec['library'] is None
    got = _shape_dataset(path, 128)      # the JAX warmup reads no data either
    assert (got.m, got.layout.nb) == (want.m, want.layout.nb)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='--device cpu'):
            warmup.main(argv[:-2])


def test_cli_runs_without_pandas_or_jax(tmp_path, files):
    """``python -m viprs_tpu_torch.cli.fit`` on the CPU with pandas and jax
    blocked from import: the whole path, from the files to the outputs."""
    out = str(tmp_path / 'out')
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules['pandas'] = sys.modules['jax'] = None
        sys.argv = ['viprs_fit_torch'] + {_args(files, 'zarr', ['--hyp-search', 'GS', '--grid-metric', 'pseudo_validation', '--pi-steps', '3', '--max-iter', '50'])!r} + ['--output-file', {out!r}, '--device', 'cpu']
        try:
            runpy.run_module('viprs_tpu_torch.cli.fit', run_name='__main__')
        except SystemExit as e:
            assert e.code == 0, e.code
        assert 'viprs_tpu' not in sys.modules
        print('ok')
    """)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(PYTHONPATH=REPO, VIPRS_TPU_TORCH_PACK_CACHE='off')
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith('ok')
    for name in ('fit.gz', 'hyp', 'validation', 'prof', 'log'):
        assert osp.exists(f'{out}.{name}'), name
    m = GWADataLoader(ld_store_files=osp.join(files, 'zarr', 'chr_*'),
                      sumstats_files=osp.join(files, 'sumstats.txt')).m
    assert len(read_table(f'{out}.fit.gz')) == m


# ------------------------------------------------------------- the models
@pytest.fixture(scope='module')
def loaders(files):
    args = dict(ld_store_files=osp.join(files, 'native'),
                sumstats_files=osp.join(files, 'sumstats.txt'),
                block_size=128)
    return GWADataLoader(**args), JaxLoader(**args)


def test_tables_match_jax(loaders, ladder_trace):  # noqa: F811
    """to_table and to_theta_table of fitted VIPRS and VIPRSMix models, and
    lambda_min='infer', against the JAX package's."""
    pl, jl = loaders
    ds, jds = pl.to_summary_dataset(device='cpu'), jl.to_summary_dataset()
    for model, jmodel in ((VIPRS, JaxVIPRS), (VIPRSMix, None)):
        from viprs_tpu.model import VIPRSMix as JaxVIPRSMix
        jmodel = jmodel or JaxVIPRSMix
        kw = {} if model is VIPRS else dict(K=3)
        np.random.seed(3)
        jm = jmodel(jds, mesh='off', **kw).fit(max_iter=MAX_ITER)
        assert_clear_of_thresholds(ladder_trace)
        ladder_trace.calls.clear()
        np.random.seed(3)
        tm = model(ds, 'cpu', **kw).fit(max_iter=MAX_ITER, sweep_impl='xla')
        assert tm.optim_result.nit == jm.optim_result.nit
        t, j = tm.to_table(), jm.to_table()
        assert t.columns == list(j.columns) == ['CHR', 'SNP', 'POS', 'A1',
                                                'A2', 'BETA', 'PIP',
                                                'VAR_BETA']
        assert_table_is_frame(t.select(['CHR', 'SNP', 'POS', 'A1', 'A2']),
                              j[['CHR', 'SNP', 'POS', 'A1', 'A2']])
        for col in ('BETA', 'PIP', 'VAR_BETA'):
            np.testing.assert_allclose(t[col], j[col].values, atol=1e-5,
                                       rtol=0)
        per = tm.to_table(col_subset=('SNP', 'A1'), per_chromosome=True)
        assert sorted(per) == [20, 22] and per[20].columns == [
            'CHR', 'SNP', 'A1', 'BETA', 'PIP', 'VAR_BETA']
        th, jh = tm.to_theta_table(), jm.to_theta_table()
        assert list(th['Parameter']) == list(jh['Parameter'])
        np.testing.assert_allclose(th['Value'], jh['Value'].astype(float),
                                   rtol=1e-5)
    lam = VIPRS(ds, 'cpu', lambda_min='infer')
    assert lam.lambda_min == VIPRS(ds, 'cpu').infer_lambda_min() == \
        JaxVIPRS(jds, mesh='off', lambda_min='infer').lambda_min


def test_validation_sumstats_and_pseudo_r2_match_jax(files, loaders):
    """set_validation_sumstats given a SumstatsTable (harmonized by allele,
    missing variants 0) gives the JAX package's betas bit for bit;
    pseudo_validate(test_gdl=loader), pseudo_r2 and pseudo_pearson_r of
    the same PRS table match the JAX package's."""
    pl, jl = loaders
    ds, jds = pl.to_summary_dataset(device='cpu'), jl.to_summary_dataset()
    vfile = osp.join(files, 'validation.txt')
    np.random.seed(2)
    tm = VIPRS(ds, 'cpu').fit(max_iter=30, sweep_impl='xla')
    jm = JaxVIPRS(jds, mesh='off')
    tm.set_validation_sumstats(read_sumstats(vfile))
    jm.set_validation_sumstats(jax_read_sumstats(vfile))
    for c in tm.chromosomes:
        np.testing.assert_array_equal(tm.validation_std_beta[c],
                                      jm.validation_std_beta[c])
    with pytest.raises(TypeError, match='SumstatsTable'):
        tm.set_validation_sumstats(object())
    tab = Table({'STD_BETA': np.zeros(3), 'SNP': ['a', 'b', 'c'],
                 'A1': 'A', 'A2': 'G'})
    tm.set_validation_sumstats(tab)
    assert all((v == 0).all() for v in tm.validation_std_beta.values())

    vargs = dict(ld_store_files=osp.join(files, 'native'),
                 sumstats_files=vfile, block_size=128)
    vl, jvl = GWADataLoader(**vargs), JaxLoader(**vargs)
    vds, jvds = vl.to_summary_dataset(device='cpu'), jvl.to_summary_dataset()
    prs = tm.to_table()
    rng = np.random.default_rng(0)
    prs['BETA_0'] = prs['BETA']
    prs['BETA_1'] = rng.standard_normal(len(prs)) * 1e-3
    two = prs.drop(['BETA'])
    for cols in (['CHR', 'SNP', 'A1', 'A2', 'BETA'], two.columns):
        t = (prs if 'BETA' in cols else two).select(cols)
        got = pseudo.pseudo_pearson_r(vds, t)
        want = jax_pseudo.pseudo_pearson_r(jvds, t.to_pandas())
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(pseudo.pseudo_r2(vds, t),
                                   jax_pseudo.pseudo_r2(jvds, t.to_pandas()),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        tm.pseudo_validate(test_gdl=vl),
        jax_pseudo.pseudo_r2(jvds, prs.select(
            ['CHR', 'SNP', 'A1', 'A2', 'BETA']).to_pandas()), rtol=1e-6)
