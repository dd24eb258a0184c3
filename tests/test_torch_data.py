"""The port's data layer against the JAX package's, on the CPU: the Zarr
arrays, both LD store formats, the banded-to-block cut, the summary
statistics formats, allele harmonization, the loader (lazy and eager, with
and without ``--extract`` and the long-range LD filter), the packed-LD
cache, the streaming planner, the column table and the file-name expansion.

Every comparison is bit for bit. The summary-statistics files carry their
reals at 12 significant digits: pandas' parser (the JAX package reads with
it) rounds some decimals of 14 or more digits an ulp away from the nearest
float64, which the port's parser, and Python's ``float``, do not
(``test_table_parses_floats_exactly`` holds the port to ``float`` on
17-digit values).
"""

import os
import os.path as osp

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.linalg import toeplitz

from viprs_tpu.data import harmonize as jax_harmonize
from viprs_tpu.data import ld_store as jax_ld_store
from viprs_tpu.data import loader as jax_loader
from viprs_tpu.data import pack_cache as jax_pack_cache
from viprs_tpu.data import sumstats as jax_sumstats
from viprs_tpu.data import zarr_v2 as jax_zarr
from viprs_tpu.data.dataset import SummaryStatsDataset as JaxDataset
from viprs_tpu.ops import block_ld as jax_block_ld

from viprs_tpu_torch.data import (harmonize, ld_store, loader, pack_cache,
                                  sumstats, zarr_v2)
from viprs_tpu_torch.data.dataset import SummaryStatsDataset
from viprs_tpu_torch.ops import block_ld
from viprs_tpu_torch.utils import system
from viprs_tpu_torch.utils.table import Table, read_table

PAIRS = [('A', 'G'), ('C', 'T'), ('G', 'A'), ('T', 'C'), ('A', 'C'),
         ('G', 'T'), ('A', 'T'), ('C', 'G'), ('AT', 'A'), ('G', 'GCA')]
COMP = str.maketrans('ATCG', 'TAGC')
#: The fixture's chromosomes and LD block sizes: blocks wider than B = 128
#: give coupling tiles; chromosome 20 spans a long-range LD region.
CHROMS = {20: (90, 150, 70), 22: (200, 60)}


def write_fixture(root, chroms=CHROMS, n=20000, h2=0.3, rho=(0.3, 0.9),
                  seed=0, native=True, zarr=True, triangular=True, drop=0.02,
                  sumstats_name='sumstats.txt'):
    """Write an int8 native store (``root/native``), one magenpy Zarr store
    a chromosome (``root/zarr/chr_<c>``) and a magenpy-format summary
    statistics file with ~10% of the variants' alleles swapped (Z negated),
    ~10% strand-complemented (not palindromic ones), ``drop`` of them
    absent and five variants the LD lacks. AR(1) LD blocks (their
    parameter uniform in ``rho``), 5% of the
    variants causal with effects of variance ``h2`` over their number,
    seeded numpy.

    :returns: dict of the blocks, tables, std_beta and the masks applied.
    """
    rng = np.random.default_rng(seed)
    blocks, tables, sb = {}, {}, {}
    sd = np.sqrt(h2 / (0.05 * sum(sum(v) for v in chroms.values())))
    for c, sizes in chroms.items():
        bl, parts = [], []
        for s in sizes:
            R = toeplitz(rng.uniform(*rho) ** np.arange(s))
            beta = np.where(rng.random(s) < 0.05,
                            rng.standard_normal(s) * sd, 0.0)
            parts.append(R @ beta + rng.standard_normal(s) / np.sqrt(n))
            bl.append(R)
        m = sum(sizes)
        pr = [PAIRS[i] for i in rng.integers(0, len(PAIRS), m)]
        pos = (31_000_000 if c == 20 else 1_000_000) + np.arange(m) * 20000
        tables[c] = Table({'CHR': c, 'SNP': [f'rs{c}_{i}' for i in range(m)],
                           'POS': pos, 'A1': [p[0] for p in pr],
                           'A2': [p[1] for p in pr]})
        blocks[c] = bl
        sb[c] = np.concatenate(parts)
    if native:
        ld_store.save_ld_store(osp.join(root, 'native'), blocks, tables,
                               quantize=True)
    if zarr:
        for c in chroms:
            d, ip, lb = ld_store.dense_blocks_to_banded(blocks[c])
            ld_store.save_magenpy_zarr(osp.join(root, f'zarr/chr_{c}'), d, ip,
                                       lb, snp_table=tables[c], chrom=c,
                                       triangular=triangular)
    allc = Table.concat(tables[c] for c in sorted(tables))
    b = np.concatenate([sb[c] for c in sorted(sb)])
    z = b * np.sqrt(n / (1 - b ** 2))
    a1, a2 = allc['A1'], allc['A2']
    M = len(allc)
    swap = rng.random(M) < 0.1
    pal = np.array([x.translate(COMP) == y for x, y in zip(a1, a2)])
    comp = (rng.random(M) < 0.1) & ~pal & ~swap
    a1s, a2s = np.where(swap, a2, a1), np.where(swap, a1, a2)
    a1s = np.where(comp, [x.translate(COMP) for x in a1s], a1s)
    a2s = np.where(comp, [x.translate(COMP) for x in a2s], a2s)
    zs = np.array([float(f'{v:.12g}') for v in np.where(swap, -z, z)])
    keep = rng.random(M) >= drop
    ss = Table({'CHR': allc['CHR'], 'SNP': allc['SNP'], 'POS': allc['POS'],
                'A1': a1s, 'A2': a2s, 'N': np.full(M, float(n)),
                'Z': zs}).take(keep)
    extra = Table({'CHR': 22, 'SNP': [f'rsX{i}' for i in range(5)],
                   'POS': np.arange(5), 'A1': 'A', 'A2': 'G',
                   'N': float(n), 'Z': np.round(rng.standard_normal(5), 9)})
    Table.concat([ss, extra]).write(osp.join(root, sumstats_name))
    return dict(blocks=blocks, tables=tables, std_beta=sb, keep=keep,
                swap=swap, comp=comp)


# ------------------------------------------------------------------ helpers
def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def as_str(values):
    return ['' if (isinstance(v, float) and np.isnan(v)) else str(v)
            for v in np.asarray(values, dtype=object).tolist()]


def assert_table_is_frame(t, df):
    """A port Table equal to a JAX package DataFrame: the same columns in
    the same order, numbers of the same kind and bits, strings equal (a
    missing string: pandas' NaN, the port's '')."""
    assert isinstance(t, Table)
    assert t.columns == [str(c) for c in df.columns], (t.columns,
                                                       list(df.columns))
    assert len(t) == len(df)
    for k in t.columns:
        a, b = t[k], df[k].to_numpy()
        if b.dtype.kind in 'iufb':
            assert a.dtype.kind == b.dtype.kind, (k, a.dtype, b.dtype)
            assert same_bits(a, b.astype(a.dtype)), k
        else:
            assert as_str(a) == as_str(b), k


def jax_tables(tables):
    return {c: t.to_pandas() for c, t in tables.items()}


@pytest.fixture(scope='module')
def fixture_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('data'))
    fx = write_fixture(root)
    return root, fx


@pytest.fixture(autouse=True)
def no_pack_cache(monkeypatch):
    """Neither package writes a pack cache under HOME in these tests."""
    monkeypatch.setenv('VIPRS_TPU_PACK_CACHE', 'off')
    monkeypatch.setenv(pack_cache.ENV, 'off')


# ------------------------------------------------------------------- zarr
ZARR_COMPRESSORS = [
    {'id': 'zlib', 'level': 1},
    pytest.param({'id': 'blosc', 'cname': 'lz4', 'clevel': 5, 'shuffle': 1},
                 marks=pytest.mark.skipif(
                     not zarr_v2.blosc_available(),
                     reason='no libblosc on this machine: blosc chunks cannot '
                            'be written or read')),
]


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('compressor', ZARR_COMPRESSORS)
def test_zarr_arrays_cross_read(tmp_path, writer, compressor):
    """Arrays written by one package read back bit for bit by the other,
    and both writers write the same bytes."""
    rng = np.random.default_rng(0)
    arrays = {
        'i8': rng.integers(-127, 128, 1000).astype(np.int8),
        'f4': rng.standard_normal(1000).astype(np.float32),
        'f8': rng.standard_normal(1000),
        'i64': rng.integers(0, 1 << 40, 1000),
        'mat': rng.standard_normal((37, 53)).astype(np.float32),
        'snps': np.asarray([f'rs{i}' * (1 + i % 3) for i in range(300)],
                           dtype=object)}
    mods = {'jax': jax_zarr, 'port': zarr_v2}
    w, r = mods[writer], mods['port' if writer == 'jax' else 'jax']
    for name, arr in arrays.items():
        chunks = (16, 20) if arr.ndim == 2 else (256,)
        for store, mod in (('a', w), ('b', r)):
            mod.write_array(str(tmp_path / store), f'g/{name}', arr,
                            chunks=chunks, compressor=compressor)
        out = r.open_group(str(tmp_path / 'a'))[f'g/{name}'][...]
        if arr.dtype == object:
            assert list(out) == list(arr)
        else:
            assert same_bits(out, arr)
        for f in os.listdir(tmp_path / 'a' / 'g' / name):
            assert open(tmp_path / 'a' / 'g' / name / f, 'rb').read() == \
                open(tmp_path / 'b' / 'g' / name / f, 'rb').read()


@pytest.mark.skipif(not zarr_v2.blosc_available(),
                    reason='no libblosc on this machine: blosc chunks cannot '
                           'be written or read')
def test_zarr_blosc_first_read_threaded(tmp_path):
    """A fresh interpreter whose first read of a blosc store is a threaded
    one (more than 4 chunks) binds libblosc once for every thread."""
    import subprocess
    import sys
    arr = np.arange(10000, dtype=np.int64)
    zarr_v2.write_array(str(tmp_path / 's'), 'x', arr, chunks=(100,),
                        compressor={'id': 'blosc', 'cname': 'lz4',
                                    'clevel': 5, 'shuffle': 1})
    code = ("import sys, numpy as np\n"
            "from viprs_tpu_torch.data import zarr_v2\n"
            f"x = zarr_v2.open_group({str(tmp_path / 's')!r})['x'][...]\n"
            "assert (x == np.arange(10000)).all()\n")
    for _ in range(3):
        r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                           text=True, cwd=osp.dirname(osp.dirname(
                               osp.abspath(__file__))), timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            out[osp.relpath(p, root)] = open(p, 'rb').read()
    return out


@pytest.mark.parametrize('triangular', [False, True])
@pytest.mark.parametrize('quantize', [True, False])
def test_magenpy_zarr_store_matches_jax(tmp_path, fixture_dir, triangular,
                                        quantize):
    """save_magenpy_zarr writes the JAX package's bytes (the triangular cut
    vectorized); each package's store loads in the other to the same
    banded arrays, tables and block sizes."""
    _, fx = fixture_dir
    c = 22
    data, indptr, left = ld_store.dense_blocks_to_banded(fx['blocks'][c],
                                                         quantize=quantize)
    tab = fx['tables'][c]
    ld_store.save_magenpy_zarr(str(tmp_path / 'port'), data, indptr, left,
                               snp_table=tab, chrom=c, triangular=triangular)
    jax_ld_store.save_magenpy_zarr(str(tmp_path / 'jax'), data, indptr, left,
                                   snp_table=tab.to_pandas(), chrom=c,
                                   triangular=triangular)
    assert _tree_bytes(tmp_path / 'port') == _tree_bytes(tmp_path / 'jax')
    for store in ('port', 'jax'):
        p = str(tmp_path / store)
        (bp, tp), (bj, tj) = ld_store.load_magenpy_zarr(p), \
            jax_ld_store.load_magenpy_zarr(p)
        assert list(bp) == list(bj) == [c]
        for x, y in zip(bp[c], bj[c]):
            assert same_bits(x, y)
        assert_table_is_frame(tp[c], tj[c])
        assert_table_is_frame(ld_store.load_magenpy_zarr_tables(p)[c],
                              jax_ld_store.load_magenpy_zarr_tables(p)[c])
        assert ld_store.magenpy_zarr_block_sizes(p) == \
            jax_ld_store.magenpy_zarr_block_sizes(p)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_native_store_matches_jax(tmp_path, fixture_dir, writer):
    """A native store written by either package: blocks (int8 as stored,
    and dequantized), tables and block sizes read the same in both."""
    _, fx = fixture_dir
    path = str(tmp_path / 'store')
    if writer == 'jax':
        jax_ld_store.save_ld_store(path, fx['blocks'],
                                   jax_tables(fx['tables']), quantize=True)
    else:
        ld_store.save_ld_store(path, fx['blocks'], fx['tables'],
                               quantize=True)
    for deq in (False, True):
        bp, tp = ld_store.load_ld_store(path, dequantize=deq)
        bj, tj = jax_ld_store.load_ld_store(path, dequantize=deq)
        assert sorted(bp) == sorted(bj) == sorted(CHROMS)
        for c in bj:
            for x, y in zip(bp[c], bj[c]):
                assert same_bits(x, y)
            assert_table_is_frame(tp[c], tj[c])
    none, tp = ld_store.load_ld_store(path, tables_only=True,
                                      chromosomes=[22])
    assert none is None and list(tp) == [22]
    assert ld_store.native_store_block_sizes(path) == \
        jax_ld_store.native_store_block_sizes(path)


def _partial_band(blocks, k, quantize):
    """Symmetric rows holding only the entries within ``k`` of the
    diagonal, inside each block (a band that pinches off at every block
    edge, but whose rows are not whole block rows)."""
    data, indptr, left = [], [0], []
    off = 0
    for blk in blocks:
        s = blk.shape[0]
        for j in range(s):
            a, b = max(0, j - k), min(s, j + k + 1)
            data.extend(blk[j, a:b])
            indptr.append(len(data))
            left.append(off + a)
        off += s
    data = np.asarray(data)
    if quantize:
        data = block_ld.quantize_int8(data)
    return data, np.asarray(indptr, np.int64), np.asarray(left, np.int64)


@pytest.mark.parametrize('rows', ['whole', 'triangular', 'partial'])
@pytest.mark.parametrize('case', ['int8_keep', 'int8_inflate', 'float'])
def test_banded_to_blocks_matches_jax(tmp_path, fixture_dir, case, rows):
    """The cut of a banded matrix into dense blocks, int8 kept as int8 or
    inflated, and float, as the JAX package cuts it: rows holding whole
    block rows, rows from the diagonal on (a triangular store as loaded),
    and rows holding only a band within each block; the guard on a band
    that never pinches off raises in both."""
    _, fx = fixture_dir
    quantize = case != 'float'
    if rows == 'partial':
        data, indptr, left = _partial_band(fx['blocks'][20], 30, quantize)
    else:
        data, indptr, left = ld_store.dense_blocks_to_banded(
            fx['blocks'][20], quantize=quantize)
    if rows == 'triangular':
        path = str(tmp_path / 'tri')
        ld_store.save_magenpy_zarr(path, data, indptr, left, chrom=20,
                                   triangular=True)
        data, indptr, left = ld_store.load_magenpy_zarr(path)[0][20]
    kw = dict(keep_quantized=case == 'int8_keep')
    got = ld_store.banded_to_blocks(data, indptr, left, **kw)
    want = jax_ld_store.banded_to_blocks(data, indptr, left, **kw)
    assert len(got) == len(want) == 3
    for x, y in zip(got, want):
        assert same_bits(x, y)
    for mod in (ld_store, jax_ld_store):
        with pytest.raises(ValueError, match='pinches off'):
            mod.banded_to_blocks(data, indptr, left, max_dense_block=100,
                                 **kw)


def test_pack_of_int8_blocks_matches_jax(fixture_dir):
    """int8 blocks (a quantized store) pack as the JAX package packs them:
    verbatim into int8 tiles, int8 * float32(1/127) into float32 tiles."""
    _, fx = fixture_dir
    blocks = {c: [block_ld.quantize_int8(b) for b in bl]
              for c, bl in fx['blocks'].items()}
    for quantize in (True, False):
        p, lay = block_ld.pack_dense_blocks(blocks, block_size=128,
                                            quantize=quantize)
        j, jlay = jax_block_ld.pack_dense_blocks(blocks, block_size=128,
                                                 quantize=quantize)
        assert same_bits(p.diag, np.asarray(j.diag))
        assert same_bits(p.off_data.reshape(-1),
                         np.asarray(j.off_data).reshape(-1))
        assert same_bits(lay.flat_index, jlay.flat_index)
    q, _ = block_ld.pack_dense_blocks(fx['blocks'], block_size=128,
                                      quantize=True)
    p, _ = block_ld.pack_dense_blocks(blocks, block_size=128, quantize=True)
    assert same_bits(p.diag, q.diag) and same_bits(p.off_data, q.off_data)


# --------------------------------------------------------------- sumstats
#: Each format's file columns (canonical name -> file name) as
#: viprs_tpu.data.sumstats._FORMAT_MAPS names them.
FORMATS = {
    'magenpy': dict(CHR='CHR', SNP='SNP', POS='POS', A1='A1', A2='A2',
                    MAF='MAF', N='N', BETA='BETA', SE='SE', Z='Z', P='P'),
    'fastgwa': dict(CHR='CHR', SNP='SNP', POS='POS', A1='A1', A2='A2',
                    N='N', MAF='AF1', BETA='BETA', SE='SE', P='P'),
    'plink1.9': dict(CHR='CHR', SNP='SNP', POS='BP', A1='A1', A2='A2',
                     N='NMISS', OR='OR', SE='SE', Z='STAT', T='T', P='P'),
    'plink2': dict(CHR='#CHROM', SNP='ID', POS='POS', REF='REF', ALT='ALT',
                   A1='A1', N='OBS_CT', BETA='BETA', SE='SE', Z='T_STAT',
                   Z2='Z_STAT', P='P', MAF='A1_FREQ'),
    'cojo': dict(SNP='SNP', A1='A1', A2='A2', MAF='freq', BETA='b', SE='se',
                 P='p', N='N'),
    'ssf': dict(CHR='chromosome', SNP='variant_id', POS='base_pair_location',
                A1='effect_allele', A2='other_allele', BETA='beta',
                SE='standard_error', MAF='effect_allele_frequency',
                P='p_value', N='n'),
    'gwas-ssf': dict(CHR='chromosome', SNP='rsid', POS='base_pair_location',
                     A1='effect_allele', A2='other_allele', BETA='beta',
                     SE='standard_error', P='p_value'),
    'gwascatalog': dict(CHR='hm_chrom', SNP='hm_rsid', POS='hm_pos',
                        A1='hm_effect_allele', A2='hm_other_allele',
                        BETA='hm_beta', MAF='hm_effect_allele_frequency',
                        SE='standard_error', P='p_value', N='n'),
    'saige': dict(CHR='CHR', SNP='MarkerID', POS='POS', A1='Allele2',
                  A2='Allele1', MAF='AF_Allele2', N='N', BETA='BETA', SE='SE',
                  P='p.value'),
    'custom': dict(SNP='marker', A1='eff', A2='ref', Z='zscore', N='samples',
                   CHR='chrom'),
}


def _sumstats_file(path, fmt, m=60, seed=1):
    rng = np.random.default_rng(seed)
    a1 = rng.choice(['A', 'C', 'G', 'T'], m)
    a2 = np.where(np.isin(a1, ['A', 'T']), 'G', 'A')

    def r12(x):
        return np.array([float(f'{v:.12g}') for v in x])
    vals = dict(CHR=rng.choice([1, 2, 22], m), SNP=[f'rs{i}' for i in range(m)],
                POS=rng.integers(1, 10 ** 8, m), A1=a1, A2=a2,
                MAF=r12(rng.uniform(0.01, 0.5, m)),
                N=rng.integers(5000, 9000, m),
                BETA=r12(rng.standard_normal(m) * 0.01),
                SE=r12(rng.uniform(0.005, 0.02, m)),
                Z=r12(rng.standard_normal(m) * 2),
                Z2=r12(rng.standard_normal(m) * 2),
                T=r12(rng.standard_normal(m) * 2),
                P=r12(rng.uniform(0, 1, m)),
                OR=r12(np.exp(rng.standard_normal(m) * 0.05)),
                REF=a2, ALT=a1.copy())
    # plink2: A1 is ALT on some rows, REF on others
    vals['REF'] = np.where(np.arange(m) % 3 == 0, a1, a2)
    vals['ALT'] = np.where(np.arange(m) % 3 == 0, a2, a1)
    cols = {fname: vals[canon] for canon, fname in FORMATS[fmt].items()}
    if fmt == 'magenpy':                 # NA Z on some rows
        cols['Z'] = np.where(np.arange(m) % 7 == 0, 'NA',
                             [repr(float(v)) for v in cols['Z']])
    t = Table(cols)
    sep = {'custom': ',', 'cojo': ' '}.get(fmt, '\t')
    t.write(str(path), sep=sep)
    return sep


@pytest.mark.parametrize('fmt', sorted(FORMATS))
def test_read_sumstats_matches_jax(tmp_path, fmt):
    """Every format (and custom with its mapping and separator) parses to
    the JAX package's table bit for bit, with the same Z, N and
    standardized betas; plink2 takes A2 from REF/ALT, plink1.9 the log of
    OR, a repeated canonical column keeps its first; N from ``n=`` where
    the file has none."""
    f = tmp_path / ('ss.txt.gz' if fmt == 'magenpy' else 'ss.txt')
    sep = _sumstats_file(f, fmt)
    kw = {}
    if fmt == 'custom':
        kw = dict(column_map={v: k for k, v in FORMATS[fmt].items()},
                  sep=sep)
    if fmt == 'gwas-ssf':
        kw['n'] = 7000.0
    got = sumstats.read_sumstats(str(f), fmt, **kw)
    want = jax_sumstats.read_sumstats(str(f), fmt, **kw)
    assert_table_is_frame(got.table, want.table)
    for attr in ('z_score', 'n_per_snp', 'marginal_beta'):
        assert same_bits(getattr(got, attr), getattr(want, attr)), attr
    assert same_bits(got.get_snp_pseudo_corr(), want.get_snp_pseudo_corr())
    for c, sub in got.split_by_chromosome().items():
        assert_table_is_frame(sub.table, want.split_by_chromosome()[c].table)
    sub = got.to_table(col_subset=['SNP', 'A1', 'STD_BETA'])
    assert_table_is_frame(sub, want.to_table(col_subset=['SNP', 'A1',
                                                         'STD_BETA']))
    keep = [f'rs{i}' for i in range(0, 60, 4)]
    assert_table_is_frame(got.filter_snps(keep).table,
                          want.filter_snps(keep).table)


def test_read_sumstats_refusals(tmp_path):
    f = tmp_path / 'ss.txt'
    _sumstats_file(f, 'gwas-ssf')
    for mod in (sumstats, jax_sumstats):
        with pytest.raises(ValueError, match='sample-size'):
            mod.read_sumstats(str(f), 'gwas-ssf')
    # the JAX package asserts what the port raises as ValueError
    for err, mod in ((ValueError, sumstats), (AssertionError, jax_sumstats)):
        with pytest.raises(err, match='Unknown'):
            mod.read_sumstats(str(f), 'vcf')
        with pytest.raises(err, match='column_map'):
            mod.read_sumstats(str(f), 'custom')


# ------------------------------------------------------------ harmonization
def _allele_cases():
    """Reference and other tables covering every allele case: the same
    alleles, swapped, strand-complemented, complemented and swapped,
    palindromic (A/T, C/G, where an exact swap wins over a complement),
    multi-letter alleles, no match, a variant the other table lacks, one
    only it has, and a repeated id in the other table."""
    ref = Table({'SNP': [f'rs{i}' for i in range(12)],
                 'A1': ['A', 'C', 'A', 'A', 'A', 'C', 'AT', 'AT', 'A', 'G',
                        'A', 'C'],
                 'A2': ['G', 'T', 'G', 'G', 'T', 'G', 'A', 'A', 'C', 'T',
                        'G', 'A'],
                 'CHR': 1, 'POS': np.arange(12) * 10})
    other = Table({'SNP': ['rs0', 'rs1', 'rs2', 'rs3', 'rs4', 'rs5', 'rs6',
                           'rs7', 'rs8', 'rs10', 'rs11', 'rs11', 'rsZ'],
                   'A1': ['A', 'T', 'T', 'C', 'T', 'G', 'AT', 'TA', 'G',
                          'A', 'C', 'A', 'A'],
                   'A2': ['G', 'C', 'C', 'T', 'A', 'C', 'A', 'T', 'T', 'G',
                          'A', 'C', 'G'],
                   'CHR': 1, 'POS': 0,
                   'BETA': np.linspace(-0.6, 0.6, 13),
                   'Z': np.linspace(2, -2, 13), 'N': np.arange(13) + 1000})
    return ref, other


@pytest.mark.parametrize('how', ['left', 'inner'])
@pytest.mark.parametrize('drop_pos', [False, True])
def test_merge_snp_tables_matches_jax(how, drop_pos):
    """Every allele case, left and inner, with and without the reference's
    CHR/POS (the other table's are dropped where the reference has them),
    as the JAX package merges them; the palindromic test too."""
    ref, other = _allele_cases()
    if drop_pos:
        ref = ref.select(['SNP', 'A1', 'A2'])
    got = harmonize.merge_snp_tables(ref, other, how=how,
                                     signed_statistics=['BETA', 'Z'])
    want = jax_harmonize.merge_snp_tables(
        ref.to_pandas(), other.to_pandas(), how=how,
        signed_statistics=['BETA', 'Z'])
    assert_table_is_frame(got, want.reset_index(drop=True))
    assert same_bits(harmonize.is_palindromic(ref['A1'], ref['A2']),
                     jax_harmonize.is_palindromic(ref['A1'], ref['A2']))


# ------------------------------------------------------------------ loader
def _loaders(root, store, **kw):
    paths = {'native': osp.join(root, 'native'),
             'zarr': osp.join(root, 'zarr', 'chr_*')}
    args = dict(ld_store_files=paths[store],
                sumstats_files=osp.join(root, 'sumstats.txt'),
                block_size=128, **kw)
    return loader.GWADataLoader(**args), jax_loader.GWADataLoader(**args)


def _filters(pl, jl, filt, fx):
    if filt in ('extract', 'both'):
        ids = [f'rs{c}_{i}' for c, bl in CHROMS.items()
               for i in range(0, sum(bl), 3)]
        pl.filter_snps(ids)
        jl.filter_snps(ids)
    if filt in ('lrld', 'both'):
        pl.filter_long_range_ld_regions()
        jl.filter_long_range_ld_regions()


def assert_loaders_match(pl, jl):
    assert pl.chromosomes == jl.chromosomes and pl.shapes == jl.shapes
    assert pl.m == jl.m and pl.n == jl.n
    for c in jl.chromosomes:
        assert_table_is_frame(pl.ld_snp_tables[c], jl.ld_snp_tables[c])
        assert_table_is_frame(pl.sumstats_table[c].table,
                              jl.sumstats_table[c].table)
        assert same_bits(pl.sumstats_table[c].get_snp_pseudo_corr(),
                         jl.sumstats_table[c].get_snp_pseudo_corr())
        assert same_bits(pl.sumstats_table[c].n_per_snp,
                         jl.sumstats_table[c].n_per_snp)


@pytest.mark.parametrize('store', ['native', 'zarr'])
@pytest.mark.parametrize('filt', ['none', 'extract', 'lrld', 'both'])
def test_loader_matches_jax(fixture_dir, store, filt):
    """The lazy loader (variant tables first, LD on packing) against the
    JAX package's on each store format, with --extract's and the
    long-range LD filter: harmonized tables, standardized betas, sample
    sizes, the dense blocks and the packed tiles bit for bit."""
    root, fx = fixture_dir
    pl, jl = _loaders(root, store, quantize_ld=True)
    assert pl.ld_data_reads == 0 and pl._ld_blocks is None
    _filters(pl, jl, filt, fx)
    assert_loaders_match(pl, jl)
    ds = pl.to_summary_dataset(device='cpu')
    jds = jl.to_summary_dataset()
    for c in jl.chromosomes:
        for x, y in zip(pl.ld_blocks[c], jl.ld_blocks[c]):
            assert same_bits(x, y)
        assert same_bits(ds.std_beta[c], jds.std_beta[c])
        assert same_bits(ds.n_per_snp[c], jds.n_per_snp[c])
        assert_table_is_frame(ds.snp_table[c], jds.snp_table[c])
    assert same_bits(ds.ld.diag.numpy(), np.asarray(jds.ld.diag))
    assert same_bits(ds.layout.flat_index, jds.layout.flat_index)
    assert ds.n == jds.n and ds.m == jds.m
    assert pl.ld_data_reads == (1 if store == 'native' else len(CHROMS))
    if filt == 'none':
        # the flips undone: the LD's orientation of the statistics
        for c in jl.chromosomes:
            idx = np.isin(fx['tables'][c]['SNP'], pl.ld_snp_tables[c]['SNP'])
            np.testing.assert_allclose(ds.std_beta[c],
                                       fx['std_beta'][c][idx], rtol=1e-10)


def test_loader_eager_path_matches_jax(tmp_path, fixture_dir):
    """A store without variant tables beside one with them: every block is
    read at construction (the eager path) and sliced by harmonization, as
    in the JAX package."""
    _, fx = fixture_dir
    root = str(tmp_path)
    ld_store.save_ld_store(osp.join(root, 'tabled'),
                           {20: fx['blocks'][20]}, {20: fx['tables'][20]})
    d, ip, lb = ld_store.dense_blocks_to_banded(fx['blocks'][22])
    ld_store.save_magenpy_zarr(osp.join(root, 'bare'), d, ip, lb, chrom=22)
    write_fixture(root, native=False, zarr=False)
    args = dict(ld_store_files=[osp.join(root, 'tabled'),
                                osp.join(root, 'bare')],
                sumstats_files=osp.join(root, 'sumstats.txt'), block_size=128)
    pl, jl = loader.GWADataLoader(**args), jax_loader.GWADataLoader(**args)
    assert pl._ld_blocks is not None and not pl._ld_sources
    assert_loaders_match(pl, jl)
    for c in jl.chromosomes:
        for x, y in zip(pl.ld_blocks[c], jl.ld_blocks[c]):
            assert same_bits(x, y)
    ds, jds = pl.to_summary_dataset(device='cpu'), jl.to_summary_dataset()
    assert same_bits(ds.ld.diag.numpy(), np.asarray(jds.ld.diag))


def test_loader_views_and_refusals(fixture_dir):
    root, _ = fixture_dir
    pl, jl = _loaders(root, 'native')
    for c in jl.chromosomes:
        assert same_bits(pl.snps[c], jl.snps[c].astype(pl.snps[c].dtype))
    assert_table_is_frame(pl.to_snp_table(), jl.to_snp_table())
    assert_table_is_frame(
        pl.to_summary_statistics_table(col_subset=['SNP', 'Z', 'STD_BETA']),
        jl.to_summary_statistics_table(col_subset=['SNP', 'Z', 'STD_BETA']))
    # the genotype surface without genotypes: the JAX package's assertions
    # are the port's ValueErrors; a BED fileset that does not exist
    for pfn, jfn, jmsg, pmsg in (
            (pl.compute_ld, jl.compute_ld, 'No genotype', 'No genotype'),
            (pl.perform_gwas, jl.perform_gwas, None, 'genotypes and a '),
            (lambda: pl.score(np.zeros(3)), lambda: jl.score(np.zeros(3)),
             'No genotype', 'No genotype')):
        with pytest.raises(AssertionError, match=jmsg):
            jfn()
        with pytest.raises(ValueError, match=pmsg):
            pfn()
    missing = osp.join(root, 'x')
    with pytest.raises(FileNotFoundError, match='x.bim'):
        jax_loader.GWADataLoader(bed_files=missing)
    with pytest.raises(FileNotFoundError, match='x.bim'):
        loader.GWADataLoader(bed_files=missing, device='cpu')
    ds = pl.to_summary_dataset(device='cpu')
    ds_tab = SummaryStatsDataset(ld=ds.ld, layout=ds.layout,
                                 std_beta=ds.std_beta, n_per_snp=ds.n_per_snp)
    jds = JaxDataset.from_dense_blocks(
        {c: [np.eye(s)] for c, s in ds.shapes.items()}, ds.std_beta,
        ds.n_per_snp, block_size=128)
    for c, t in ds_tab.default_snp_table().items():
        assert_table_is_frame(t, jds.default_snp_table()[c])


def test_pack_cache_hit_equals_miss(tmp_path, fixture_dir, monkeypatch):
    """The second loader on the same panel hits the cache: the same tiles,
    layout and flags bit for bit, and no LD data read. The key changes with
    the block size, the packing, the variant subset and a touched store;
    'off' disables the cache; the key is never the JAX package's."""
    root, _ = fixture_dir
    monkeypatch.setenv(pack_cache.ENV, str(tmp_path / 'cache'))
    for quantize in (True, False):
        p1, _ = _loaders(root, 'zarr', quantize_ld=quantize)
        d1 = p1.to_summary_dataset(device='cpu')
        assert p1.ld_data_reads == len(CHROMS)
        p2, _ = _loaders(root, 'zarr', quantize_ld=quantize)
        with monkeypatch.context() as mp:
            mp.setattr(loader.GWADataLoader, '_ensure_ld_blocks',
                       lambda self: pytest.fail("a cache hit read LD data"))
            d2 = p2.to_summary_dataset(device='cpu')
        assert p2.ld_data_reads == 0
        for f in ('diag', 'off_data', 'off_src', 'off_dst', 'mask', 'inc_ptr',
                  'inc_tile', 'off_nz', 'cpl_slabs', 'diag_nz'):
            assert same_bits(getattr(d1.ld, f).numpy(),
                             getattr(d2.ld, f).numpy()), f
        assert d1.ld.scale == d2.ld.scale
        for f in ('chromosomes', 'chrom_sizes', 'chrom_block_range',
                  'block_size', 'nb'):
            assert getattr(d1.layout, f) == getattr(d2.layout, f), f
        assert same_bits(d1.layout.flat_index, d2.layout.flat_index)
    store = osp.join(root, 'native')
    snps = {22: np.array([f'rs22_{i}' for i in range(50)])}
    k1 = pack_cache.compute_key([store], snps, 128, True)
    assert k1 == pack_cache.compute_key([store], snps, 128, True)
    assert k1 != jax_pack_cache.compute_key([store], snps, 128, True)
    for other in (pack_cache.compute_key([store], snps, 256, True),
                  pack_cache.compute_key([store], snps, 128, False),
                  pack_cache.compute_key([store], {22: snps[22][:-1]}, 128,
                                         True)):
        assert other != k1
    st = os.stat(osp.join(store, 'metadata.json'))
    os.utime(osp.join(store, 'metadata.json'),
             ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    assert pack_cache.compute_key([store], snps, 128, True) != k1
    for off in ('0', 'off', 'false', 'none', ''):
        monkeypatch.setenv(pack_cache.ENV, off)
        assert pack_cache.cache_root() is None
        assert pack_cache.load_packed(k1) is None
    monkeypatch.delenv(pack_cache.ENV)
    assert pack_cache.cache_root().endswith(
        osp.join('.cache', 'viprs_tpu_torch', 'pack'))


@pytest.mark.parametrize('quantize', [True, False])
def test_streaming_planner_matches_jax(fixture_dir, quantize):
    """The packed bytes by chromosome from the stores' metadata alone, the
    chromosome groups under a budget and the group datasets, as in the JAX
    package; without harmonization losses the estimate is the packing's
    own size."""
    root, fx = fixture_dir
    for store in ('native', 'zarr'):
        pl, jl = _loaders(root, store, quantize_ld=quantize)
        est = pl.estimate_packed_bytes()
        assert est == jl.estimate_packed_bytes()
        size = 1 if quantize else 4
        for c, bl in fx['blocks'].items():
            p, _ = block_ld.pack_dense_blocks({c: bl}, block_size=128,
                                              quantize=quantize)
            assert est[c] == (p.diag.size + p.off_data.size) * size
        budget = max(est.values()) + 1
        groups = pl.plan_chromosome_groups(budget)
        assert groups == jl.plan_chromosome_groups(budget) == [[20], [22]]
        assert pl.plan_chromosome_groups(sum(est.values())) == [[20, 22]]
        got = list(pl.iter_group_datasets(groups, device='cpu'))
        want = list(jl.iter_group_datasets(groups))
        for (g, ds), (jg, jds) in zip(got, want):
            assert g == jg and ds.m == jds.m
            assert same_bits(ds.ld.diag.numpy(), np.asarray(jds.ld.diag))
        assert pl.ld_data_reads == (2 if store == 'native' else 2)


# ------------------------------------------------------------------ tables
def test_table_round_trip(tmp_path):
    """Delimited text written and read back: float64 to the same bits,
    float32 to its shortest repr, NaN as an empty field, ints, bools and
    strings (quoted where they hold the separator); gzip output the same
    bytes on every write; pandas reads the same values."""
    rng = np.random.default_rng(0)
    f64 = rng.standard_normal(500) * np.exp(rng.uniform(-30, 30, 500))
    f64[[3, 7]] = np.nan
    f64[9] = -0.0
    t = Table({'CHR': rng.integers(1, 23, 500), 'SNP': [f'rs{i}' for i in
                                                       range(500)],
               'F64': f64, 'F32': rng.standard_normal(500).astype(np.float32),
               'OK': rng.random(500) < 0.5,
               'MSG': np.where(np.arange(500) % 50 == 0, 'a, "b"\tc', 'x')})
    for name, sep in (('t.tsv.gz', '\t'), ('t.csv', ',')):
        path = str(tmp_path / name)
        t.write(path, sep=sep)
        r = read_table(path, sep=sep)
        assert r.columns == t.columns and len(r) == 500
        assert same_bits(r['F64'][~np.isnan(f64)], f64[~np.isnan(f64)])
        assert np.isnan(r['F64'][[3, 7]]).all()
        assert same_bits(r['F32'].astype(np.float32), t['F32'])
        assert same_bits(r['CHR'], t['CHR']) and list(r['SNP']) == list(
            t['SNP'])
        assert list(r['MSG']) == list(t['MSG'])
        assert list(r['OK']) == [str(v) for v in t['OK']]
        df = pd.read_csv(path, sep=sep)
        assert list(df['MSG']) == list(t['MSG'])
    first = open(tmp_path / 't.tsv.gz', 'rb').read()
    t.write(str(tmp_path / 't.tsv.gz'))
    assert open(tmp_path / 't.tsv.gz', 'rb').read() == first
    # whitespace-separated input, repeated names, ragged lines
    (tmp_path / 'w.txt').write_text('A  B A\n1 2.5 x\n  3 NA y\n')
    w = read_table(str(tmp_path / 'w.txt'))
    assert w.columns == ['A', 'B', 'A.1'] and w['A'].dtype == np.int64
    assert np.isnan(w['B'][1]) and list(w['A.1']) == ['x', 'y']
    (tmp_path / 'bad.txt').write_text('A B\n1 2\n3\n')
    with pytest.raises(ValueError, match='line 3'):
        read_table(str(tmp_path / 'bad.txt'))
    sub = t.select(['SNP', 'CHR']).take(np.arange(5)[::-1])
    assert sub.columns == ['SNP', 'CHR'] and list(sub['SNP'])[0] == 'rs4'
    assert t.rename({'SNP': 'ID'}).columns[1] == 'ID'
    both = Table.concat([t.select(['SNP']), t.select(['SNP', 'CHR'])])
    assert len(both) == 1000 and np.isnan(both['CHR'][:500]).all()
    assert_table_is_frame(t.select(['CHR', 'SNP', 'F64']),
                          t.select(['CHR', 'SNP', 'F64']).to_pandas())


def test_table_parses_floats_exactly(tmp_path):
    """The shortest repr of any float64 reads back to the same bits (Python's
    ``float`` on each field), also where pandas' parser is an ulp off."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000))
    Table({'X': x}).write(str(tmp_path / 'x.txt'))
    got = read_table(str(tmp_path / 'x.txt'))['X']
    assert same_bits(got, x)
    py = np.array([float(v) for v in
                   (tmp_path / 'x.txt').read_text().split()[1:]])
    assert same_bits(got, py)


def test_get_filenames_matches_jax(tmp_path):
    for name in ('chr_1', 'chr_2', 'chr_10', 'other'):
        (tmp_path / name).mkdir()
    for pat in (str(tmp_path / 'chr_*'), str(tmp_path / 'other'),
                str(tmp_path / 'missing_*'),
                [str(tmp_path / 'chr_1'), str(tmp_path / 'chr_2*')], None):
        assert system.get_filenames(pat) == jax_loader.get_filenames(pat)
    system.makedir([str(tmp_path / 'a' / 'b')])
    assert osp.isdir(tmp_path / 'a' / 'b')


def test_dataset_from_loader_runs_on_cpu_tensors(fixture_dir):
    """The loader's dataset is on the device asked for, with float32 or
    int8 tiles as packed."""
    root, _ = fixture_dir
    for quantize, dtype in ((True, torch.int8), (False, torch.float32)):
        pl, _ = _loaders(root, 'native', quantize_ld=quantize)
        ds = pl.to_summary_dataset(device='cpu')
        assert ds.device.type == 'cpu' and ds.ld.diag.dtype == dtype
        assert pl.to_summary_dataset(device='cpu') is ds
