"""The port's multi-process fits (viprs_tpu_torch/parallel/) on the CPU.

The counterpart of tests/test_parallel.py and tests/test_multihost.py. The
ranks are CPU processes of this file run as a script (the worker at the
bottom), joined in a ``torch.distributed`` group over gloo on localhost;
each runs a list of cases and writes its results as JSON. The tests hold
them against each other (every rank takes the same decisions), against
the port's fits in one process, and against the JAX package's sharded
fits on its 8 virtual devices. Every problem has LD blocks wider than
B = 128, and a coupling tile crosses a rank boundary of each mesh used.

    python tests/test_torch_parallel.py <cases> <rank> <world> <port> <out>
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)

#: LD block sizes of the problems, B = 128: NB = 8, coupling tiles between
#: blocks (0, 1), (0, 2), (1, 2), (3, 4) and (5, 6), so (3, 4) crosses the
#: boundary of 2 ranks and four tiles those of 4.
SIZES = (300, 100, 90, 200, 130, 60)
B = 128
#: The CLI fixture's chromosomes for the run over 2 ranks: NB = 6, and the
#: tile between the two tiles of chromosome 22's 200 variants crosses the
#: boundary.
CLI_CHROMS = {20: (150, 90), 22: (200, 70, 130)}
#: Seconds a rank may take (each runs several cases).
RANK_TIMEOUT = 240


def _sim(seed=3, n=2000, h2=0.3, prop=0.05, sizes=SIZES, jax=False):
    if jax:
        from viprs_tpu.data.simulate import simulate_sumstats_blocks
    else:
        from viprs_tpu_torch.data.simulate import simulate_sumstats_blocks
    return simulate_sumstats_blocks(n=n, block_sizes=sizes, h2=h2,
                                    prop_causal=prop, seed=seed)


def _em_problem(jax=False, seed=1):
    """The raw em_fit problem (tests/multihost_worker.py's two lanes, on
    SIZES): (packed LD, layout, flat std_beta, flat n, logits, hyper,
    fix)."""
    sim = _sim(seed=seed, jax=jax)
    if jax:
        from viprs_tpu.ops.block_ld import pack_dense_blocks
    else:
        from viprs_tpu_torch.ops.block_ld import pack_dense_blocks
    packed, lay = pack_dense_blocks(sim['ld_blocks'], block_size=B)
    nb = lay.nb
    sb = lay.to_flat(sim['std_beta']).reshape(nb, B)
    nf = lay.to_flat(sim['n_per_snp']).reshape(nb, B)
    pis = np.array([0.01, 0.1])
    logits = np.tile((np.log(pis) - np.log1p(-pis))[:, None, None],
                     (1, nb, B)).astype(np.float32)
    hyper = (np.full(2, 0.8), np.full(2, 100.0), pis, np.zeros(2))
    fix = (np.zeros(2, bool), np.zeros(2, bool), np.ones(2, bool))
    return packed, lay, sb, nf, logits, hyper, fix


#: em_fit's settings: its stops clear of their thresholds (the guard).
EM_KW = dict(n_sample=2000.0, max_iter=60, f_abs_tol=2e-3, min_iter=5)


def _dataset(device='cpu', seed=21, scale=1.0, **kw):
    from viprs_tpu_torch.data.dataset import SummaryStatsDataset
    sim = _sim(seed=seed, **kw)
    return SummaryStatsDataset.from_dense_blocks(
        sim['ld_blocks'], {c: scale * v for c, v in sim['std_beta'].items()},
        sim['n_per_snp'], block_size=B, device=device)


def _grid(ds, pi_steps, se_steps=None, h2=0.3, se=0.05):
    from viprs_tpu_torch.gridsearch import HyperparameterGrid
    return HyperparameterGrid(pi_steps=pi_steps, sigma_epsilon_steps=se_steps,
                              n_snps=ds.m, h2_est=h2, h2_se=se)


def _cat(d):
    return [float(v) for v in np.concatenate(
        [np.asarray(d[c]).reshape(-1) for c in sorted(d)])]


# ------------------------------------------------------------ the cases
# Each runs on every rank (the same calls, in lockstep) and in one process
# (``mesh`` 'off'); it returns a JSON-able dict.

def case_em(mesh):
    """em_fit on the raw problem: the rank's shard, or the whole LD."""
    import torch
    from viprs_tpu_torch.ops import em_loop
    from viprs_tpu_torch.ops.cavi_torch import CaviState
    from viprs_tpu_torch.parallel.distributed import fetch
    from viprs_tpu_torch.parallel.mesh import resolve_mesh, shard_problem
    packed, lay, sb, nf, logits, hyper, fix = _em_problem()
    ld = packed.to('cpu')
    z = np.zeros_like(logits)
    state = CaviState(*(torch.from_numpy(x.copy())
                        for x in (logits, z, z, z)))
    sb, nf = torch.from_numpy(sb), torch.from_numpy(nf)
    mesh = resolve_mesh(mesh)
    out = {}
    if mesh is not None:
        ld, state, sb, nf = shard_problem(mesh, ld, state, sb, nf, 'cpu')
        out['cross'] = int(ld.halo_rows)
    res = em_loop.em_fit(ld, state, sb, nf, hyper, fix, m_total=lay.m,
                         **EM_KW)
    eta = fetch(res.state.eta, mesh)[:, :lay.nb]
    out.update(elbo=res.final_elbo.tolist(), nit=res.nit.tolist(),
               status=res.status.tolist(), eta=eta.reshape(-1).tolist())
    return out


def case_viprs(mesh):
    """VIPRS, the default sweep rule (the hybrid), with a warm start."""
    from viprs_tpu_torch.model import VIPRS
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(1)
    m = VIPRS(ds, 'cpu', mesh=mesh).fit(max_iter=200)
    out = dict(mesh=None if m.mesh is None else m.mesh.shape,
               h2=float(m.get_heritability()), elbo=m.history['ELBO'],
               nit=int(m.optim_result.nit), msg=m.optim_result.message,
               beta=_cat(m.post_mean_beta), pip=_cat(m.pip),
               n_skip=int(m._n_skip), act=[int(a) for a in m._act_trace])
    w = VIPRS(ds, 'cpu', mesh=mesh)
    np.random.seed(2)
    w.fit(max_iter=20, param_0={'gamma': m.pip, 'mu': m.var_mu})
    out['warm_elbo'] = w.history['ELBO']
    # two manual EM steps, then a checkpoint (rank 0 writes) continued
    m.e_step().m_step().e_step().m_step()
    out['stepped'] = [float(m.elbo()), float(m.mse()), float(m.sigma_g)]
    path = os.path.join(os.environ['CASE_TMP'], 'ckpt.npz')
    m.save_checkpoint(path)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
    c = VIPRS(ds, 'cpu', mesh=mesh).load_checkpoint(path)
    c.fit(continued=True, max_iter=5)
    out['continued'] = c.history['ELBO'][-5:]
    return out


def case_grid_bma(mesh):
    """VIPRSGrid then BMA (a 4 x 2 grid, the lanes split over a grid axis
    of 2)."""
    from viprs_tpu_torch.gridsearch import bayesian_model_average
    from viprs_tpu_torch.model import VIPRSGrid
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(2)
    g = VIPRSGrid(ds, _grid(ds, 4, 2), 'cpu', mesh=mesh)
    g.fit(max_iter=150)
    out = dict(elbo=[float(e) for e in g.validation_result['ELBO']],
               trace=[list(map(int, t)) for t in g._chunk_trace],
               nit=[int(r.nit) for r in g.optim_results],
               pv=None)
    bayesian_model_average(g)
    out.update(bma_h2=float(g.get_heritability()),
               bma_beta=_cat(g.post_mean_beta))
    return out


def case_grid_select(mesh):
    """S = 3 (replicated over a grid axis of 2), pseudo-validation on a
    PUMAS split, select_best_model and the S = 1 refit."""
    from viprs_tpu_torch.gridsearch import select_best_model
    from viprs_tpu_torch.model import VIPRSGrid
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(4)
    g = VIPRSGrid(ds, _grid(ds, 3), 'cpu', mesh=mesh)
    g.split_gwas_sumstats(0.8, seed=5)
    g.fit(max_iter=100)
    out = dict(elbo=[float(e) for e in g.validation_result['ELBO']],
               pv=[float(v) for v in g.pseudo_validate()])
    select_best_model(g, criterion='pseudo_validation')
    g.restore_full_sumstats()
    g.fit(max_iter=100)
    out.update(h2=float(g.get_heritability()), nit=int(g.optim_result.nit),
               elbo_refit=float(g.history['ELBO'][-1]))
    return out


def case_pathwise(mesh):
    """The pathwise grid (S = 4 at S = 1 each; every rank holds every
    lane) on the blocks of a 2 x 2 mesh."""
    from viprs_tpu_torch.model import VIPRSGrid
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(6)
    g = VIPRSGrid(ds, _grid(ds, 4), 'cpu', mesh=mesh)
    g.fit(pathwise=True, max_iter=50)
    return dict(elbo=[float(e) for e in g.validation_result['ELBO']],
                beta=_cat(g.post_mean_beta))


def case_mix(mesh):
    """VIPRSMix(K=2) (the blocks split; its activity-gated sweep) and the
    host-stepped loop."""
    from viprs_tpu_torch.model import VIPRSMix
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(3)
    x = VIPRSMix(ds, 'cpu', K=2, mesh=mesh).fit(max_iter=100)
    np.random.seed(3)
    y = VIPRSMix(ds, 'cpu', K=2, mesh=mesh).fit(max_iter=30, fused=False)
    return dict(h2=float(x.get_heritability()), elbo=x.history['ELBO'],
                nit=int(x.optim_result.nit), beta=_cat(x.post_mean_beta),
                host_elbo=[float(e) for e in y.history['ELBO']])


def case_mix_grid(mesh):
    """VIPRSMixGrid(K=2) over 4 grid points (the blocks split)."""
    from viprs_tpu_torch.model import VIPRSMixGrid
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    np.random.seed(5)
    g = VIPRSMixGrid(ds, _grid(ds, 4), 'cpu', K=2, mesh=mesh)
    g.fit(max_iter=80)
    return dict(elbo=[float(e) for e in g.validation_result['ELBO']],
                h2=[float(h) for h in g.get_heritability()])


def case_deploy(mesh):
    """tests/test_multihost.py's deployment shape scaled to the port: an
    S = 16 grid whose staggered convergence compacts its lanes, BMA, and a
    VIPRS fit on inflated betas whose MSE turns negative (a restart)."""
    from viprs_tpu_torch.gridsearch import bayesian_model_average
    from viprs_tpu_torch.model import VIPRS, VIPRSGrid
    kw = dict(n=800, h2=0.6, prop=0.2, seed=1)
    ds = _dataset(**kw)
    np.random.seed(0)
    g = VIPRSGrid(ds, _grid(ds, 8, 2, h2=0.6, se=0.2), 'cpu', mesh=mesh)
    g.fit(max_iter=80, min_iter=1, chunk_iters=10, f_abs_tol=1e-9,
          x_abs_tol=1e-9)
    out = dict(grid_elbos=[float(e) for e in g.validation_result['ELBO']],
               chunk_trace=[list(map(int, t)) for t in g._chunk_trace],
               nit=[int(r.nit) for r in g.optim_results])
    bayesian_model_average(g)
    out['bma_h2'] = float(g.get_heritability())
    np.random.seed(0)
    r = VIPRS(_dataset(scale=3.0, **kw), 'cpu', mesh=mesh)
    r.fit(max_iter=40, min_iter=1, chunk_iters=10)
    out.update(restart_fired=r.fix_params.get('sigma_epsilon') == 0.95,
               restart_elbo=float(r.history['ELBO'][-1]),
               restart_nit=int(r.optim_result.nit))
    return out


def case_errors(mesh):
    """The mesh specs the models refuse, as the JAX package refuses them."""
    from viprs_tpu_torch.model import VIPRS, VIPRSMix
    import torch.distributed as dist
    ds = _dataset(h2=0.35, n=3000, prop=0.04)
    world = dist.get_world_size() if dist.is_initialized() else 1
    out = {}
    for name, make in (
            ('bogus', lambda: VIPRS(ds, 'cpu', mesh='bogus')),
            ('mix_grid_axis', lambda: VIPRSMix(ds, 'cpu', K=2,
                                               mesh=f'1x{world}')),
            ('world', lambda: VIPRS(ds, 'cpu', mesh=f'{world + 1}x1'))):
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_warmup(mesh, root):
    """viprs_warmup_torch on the CLI fixture's store."""
    from viprs_tpu_torch.cli import warmup
    rec = warmup.run(['-l', os.path.join(root, 'native'), '--block-size',
                      str(B), '--grid-widths', '4', '--device', 'cpu',
                      '--mesh', mesh])
    return dict(mesh=rec['mesh'], nb=rec['nb'], widths=rec['widths'])


def case_cli(mesh, root):
    """viprs_fit_torch on a CLI fixture: every rank loads the data, only
    rank 0 writes."""
    from viprs_tpu_torch.cli import fit
    prefix = os.path.join(root, 'mesh' if mesh else 'off', 'out')
    rec = fit.run(['-l', os.path.join(root, 'native'), '-s',
                   os.path.join(root, 'sumstats.txt'), '--block-size',
                   str(B), '--seed', '1', '--max-iter', '50',
                   '--device', 'cpu', '--mesh', mesh or 'off',
                   '--output-file', prefix])
    return dict(nit=rec['nit'], output=rec['output'],
                cross=rec['halo_rows'])


CASES = {'em': case_em, 'viprs': case_viprs, 'grid_bma': case_grid_bma,
         'grid_select': case_grid_select, 'pathwise': case_pathwise,
         'mix': case_mix,
         'mix_grid': case_mix_grid, 'deploy': case_deploy,
         'errors': case_errors}


def worker(cases, rank, world, port, out):
    """One rank: join the group, run each ``name:mesh`` case, write JSON."""
    from datetime import timedelta
    import torch
    torch.set_num_threads(1)
    os.environ['VIPRS_TPU_TORCH_PACK_CACHE'] = 'off'
    from viprs_tpu_torch.parallel import init_distributed
    assert init_distributed(f'127.0.0.1:{port}', world, rank,
                            timeout=timedelta(seconds=60)) == rank
    res = {}
    for spec in cases.split(','):
        name, mesh = spec.split(':')
        if name in ('cli', 'warmup'):
            res[spec] = (case_cli if name == 'cli' else case_warmup)(
                mesh, os.environ['CLI_ROOT'])
        else:
            res[spec] = CASES[name](mesh)
    res['modules'] = sorted(m for m in ('jax', 'viprs_tpu')
                            if m in sys.modules)
    with open(out, 'w') as f:
        json.dump(res, f)


# ------------------------------------------------------------ the tests
if __name__ != '__main__':
    # the ranks run this file as a script and import none of the JAX
    # package's test helpers
    from test_torch_viprs import (assert_clear_of_thresholds,  # noqa: F401
                                  ladder_trace)

TWO = ('em:2x1', 'viprs:auto', 'grid_bma:auto', 'mix:auto', 'mix_grid:auto',
       'errors:auto', 'cli:2x1', 'warmup:2x1')
FOUR = ('em:4x1', 'grid_bma:2x2', 'grid_select:2x2', 'pathwise:2x2',
        'deploy:2x2')
_ONE = {}


def one(name):
    """A case in this process, without a mesh (cached)."""
    if name not in _ONE:
        import tempfile
        os.environ.setdefault('CASE_TMP', tempfile.mkdtemp())
        _ONE[name] = CASES[name]('off')
    return _ONE[name]


def same_on_ranks(ranks, spec):
    """Every rank's result of ``spec``, which must be the same bits."""
    r = ranks[0][spec]
    for i, x in enumerate(ranks[1:], 1):
        assert x[spec] == r, f"rank {i} differs from rank 0 in {spec}"
    return r


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(world, cases, tmp, env=None):
    """Run ``cases`` on ``world`` ranks; returns each rank's results."""
    port = _free_port()
    outs = [os.path.join(tmp, f'rank{r}.json') for r in range(world)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               CASE_TMP=tmp, **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, HERE, ','.join(cases), str(r), str(world),
         str(port), outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} (exit {p.returncode}):\n{so}\n{se[-3000:]}"
              for r, (p, (so, se)) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, '\n'.join(failed)
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope='module')
def cli_root(tmp_path_factory):
    from test_torch_data import write_fixture
    root = str(tmp_path_factory.mktemp('cli'))
    write_fixture(root, chroms=CLI_CHROMS, n=2000, rho=(0.2, 0.6),
                  zarr=False)
    return root


@pytest.fixture(scope='module')
def two(tmp_path_factory, cli_root):
    return run_ranks(2, TWO, str(tmp_path_factory.mktemp('two')),
                     env={'CLI_ROOT': cli_root})


@pytest.fixture(scope='module')
def four(tmp_path_factory):
    return run_ranks(4, FOUR, str(tmp_path_factory.mktemp('four')))


def test_ranks_import_no_jax(two, four):
    assert all(r['modules'] == [] for r in (*two, *four))


@pytest.mark.parametrize('n', [2, 3, 4])
def test_shard_view_coupling_pass(n):
    """The coupling pass of each shard's view, its ghost slots filled from
    the whole eta change, gives the whole pass's rows of its blocks."""
    import torch
    from viprs_tpu_torch.ops import cavi_torch
    from viprs_tpu_torch.ops.block_ld import halo_plan, shard_blocks
    packed, lay, *_ = _em_problem()
    ld = packed.to('cpu')
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, ld.nb, B)).astype(
        np.float32))
    d = torch.from_numpy(rng.standard_normal((2, ld.nb, B)).astype(
        np.float32))
    blk = torch.from_numpy(rng.random(ld.nb) < 0.6).to(torch.int32)
    want = cavi_torch.coupling_pass(ld, q, d, blk)
    per = -(-ld.nb // n)
    bounds = [i * per for i in range(n + 1)]
    plans = halo_plan(ld.off_src.numpy(), ld.off_dst.numpy(), bounds)
    assert sum(len(p[0]) for p in plans) > 0, "no tile crosses a boundary"
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        view = shard_blocks(ld, lo, hi, 'cpu', plans[i])
        rows = [min(b, ld.nb - 1) for b in range(lo, hi)]
        real = torch.tensor([b < ld.nb for b in range(lo, hi)])
        ql, dl = q[:, rows] * real[:, None], d[:, rows] * real[:, None]
        ml = blk[rows] * real
        if view.cpl is None:
            got = ql
        else:
            g = torch.from_numpy(view.ghosts)
            got = cavi_torch.coupling_pass(
                view.cpl, torch.cat([ql, q[:, g]], 1),
                torch.cat([dl, d[:, g]], 1), torch.cat([ml, blk[g]]))
            got = got[:, :hi - lo]
        k = min(hi, ld.nb) - lo
        np.testing.assert_allclose(got[:, :k].numpy(),
                                   want[:, lo:lo + k].numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(view.ld.diag[:k], ld.diag[lo:lo + k])
        assert not view.ld.mask[k:].any()


@pytest.mark.parametrize('multiple', [3, 8])
def test_pad_blocks_matches_jax(multiple):
    """pad_blocks appends empty blocks (zero tiles, mask and flags) as the
    JAX package's does, the coupling tiles and their incidence kept."""
    import torch
    from viprs_tpu.parallel.mesh import pad_blocks as jax_pad
    from viprs_tpu_torch.parallel import pad_blocks
    packed, *_ = _em_problem()
    jpacked, *_ = _em_problem(jax=True)
    ld = packed.to('cpu')
    got, want = pad_blocks(ld, multiple), jax_pad(jpacked, multiple)
    assert got.nb % multiple == 0 and got.nb == want.nb
    for f in ('diag', 'mask', 'off_data', 'off_src', 'off_dst'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert not got.diag_nz[ld.nb:].any()
    assert torch.equal(got.inc_ptr[:ld.nb + 1], ld.inc_ptr)
    assert got.inc_ptr.shape[0] == got.nb + 1


@pytest.mark.parametrize('world', [2, 4])
def test_em_fit_over_ranks_matches_one_process(world, two, four,
                                               ladder_trace):
    """em_fit over 2 and 4 ranks on 'blocks' against the port's em_fit in
    one process; the stops against the JAX loop's, behind the guard."""
    import jax.numpy as jnp
    from viprs_tpu.ops import em_loop as jem, updates as jup
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper
    r = same_on_ranks(two if world == 2 else four, f'em:{world}x1')
    assert r['cross'] >= 1, "no coupling tile crosses a rank boundary"
    o = one('em')
    np.testing.assert_allclose(r['elbo'], o['elbo'], rtol=1e-6)
    eta, eta1 = np.asarray(r['eta']), np.asarray(o['eta'])
    np.testing.assert_allclose(eta, eta1, rtol=0,
                               atol=1e-6 * np.abs(eta1).max())
    packed, lay, sb, nf, logits, hyper, fix = _em_problem(jax=True)
    z = jnp.zeros(logits.shape, jnp.float32)
    res = jem.em_fit(packed, CaviState(jnp.asarray(logits), z, z, z),
                     jnp.asarray(sb), jnp.asarray(nf),
                     Hyper(*(jnp.asarray(x, jnp.float32) for x in hyper)),
                     jup.FixMask(*(jnp.asarray(x) for x in fix)),
                     m_total=float(lay.m), init_elbo=jnp.zeros(2),
                     active0=jnp.ones(2, bool), **EM_KW)
    assert_clear_of_thresholds(ladder_trace)
    assert r['nit'] == o['nit'] == np.asarray(res.nit).tolist()
    assert r['status'] == o['status'] == np.asarray(res.status).tolist()


@pytest.mark.parametrize('world', [2, 4])
def test_em_fit_over_ranks_matches_jax_sharded(world, two, four):
    """... and against the JAX package's shard_problem + em_fit over its 8
    virtual devices (the blocks axis)."""
    import jax
    import jax.numpy as jnp
    from viprs_tpu.ops import em_loop as jem, updates as jup
    from viprs_tpu.ops.cavi_jax import CaviState, Hyper
    from viprs_tpu.parallel.mesh import make_mesh, shard_problem
    r = same_on_ranks(two if world == 2 else four, f'em:{world}x1')
    packed, lay, sb, nf, logits, hyper, fix = _em_problem(jax=True)
    z = jnp.zeros(logits.shape, jnp.float32)
    ld, st, sbj, nfj = shard_problem(
        make_mesh(len(jax.devices()), 1), packed,
        CaviState(jnp.asarray(logits), z, z, z), jnp.asarray(sb),
        jnp.asarray(nf))
    res = jem.em_fit(ld, st, sbj, nfj,
                     Hyper(*(jnp.asarray(x, jnp.float32) for x in hyper)),
                     jup.FixMask(*(jnp.asarray(x) for x in fix)),
                     m_total=float(lay.m), init_elbo=jnp.zeros(2),
                     active0=jnp.ones(2, bool), **EM_KW)
    np.testing.assert_allclose(r['elbo'], np.asarray(res.final_elbo),
                               rtol=1e-6)
    eta = np.asarray(res.state.eta)[:, :lay.nb].reshape(-1)
    np.testing.assert_allclose(r['eta'], eta, rtol=0,
                               atol=1e-6 * np.abs(eta).max())
    assert r['nit'] == np.asarray(res.nit).tolist()


def _close(a, b, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol)


def _beta_close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_viprs_auto_mesh_matches_one_process(two):
    """VIPRS('auto') over 2 ranks (the hybrid gate over every rank's
    blocks) and a warm start, against 'off'."""
    r, o = same_on_ranks(two, 'viprs:auto'), one('viprs')
    assert r['mesh'] == {'blocks': 2, 'grid': 1} and o['mesh'] is None
    assert (r['nit'], r['msg'], r['n_skip'], r['act']) == \
        (o['nit'], o['msg'], o['n_skip'], o['act'])
    assert r['n_skip'] >= 1
    _close(r['elbo'], o['elbo'])
    _close(r['h2'], o['h2'])
    _beta_close(r['beta'], o['beta'])
    _beta_close(r['pip'], o['pip'])
    _close(r['warm_elbo'], o['warm_elbo'])
    _close(r['stepped'], o['stepped'])
    _close(r['continued'], o['continued'])


def test_pathwise_grid_over_ranks(four):
    """The pathwise grid on a 2 x 2 mesh: every rank holds every lane, the
    blocks split over two."""
    r, o = same_on_ranks(four, 'pathwise:2x2'), one('pathwise')
    _close(r['elbo'], o['elbo'])
    _beta_close(r['beta'], o['beta'])


def test_warmup_over_ranks(two, cli_root):
    """viprs_warmup_torch --mesh 2x1 over 2 ranks: each rank warms the fits
    of its shard (on the CPU there is nothing to build)."""
    r = same_on_ranks(two, 'warmup:2x1')
    assert r['mesh'] == {'blocks': 2, 'grid': 1}
    assert r['widths'] == [1, 4] and r['nb'] == 6


@pytest.mark.parametrize('spec', ['grid_bma:auto', 'grid_bma:2x2'])
def test_grid_and_bma_match_one_process(spec, two, four):
    """VIPRSGrid (S = 8) over the blocks of 2 ranks, and over a 2 x 2 mesh
    with its lanes split (the JAX tests' '4x2'), then BMA."""
    r = same_on_ranks(two if spec.endswith('auto') else four, spec)
    o = one('grid_bma')
    _close(r['elbo'], o['elbo'])
    assert all(t[0] % 2 == 0 for t in r['trace']), r['trace']
    _close(r['bma_h2'], o['bma_h2'])
    _beta_close(r['bma_beta'], o['bma_beta'])


def test_grid_indivisible_lanes_and_refit(four):
    """S = 3 on a 2 x 2 mesh (lanes replicated over the grid axis),
    pseudo-validation, select_best_model and its S = 1 refit."""
    r, o = same_on_ranks(four, 'grid_select:2x2'), one('grid_select')
    _close(r['elbo'], o['elbo'])
    _close(r['pv'], o['pv'])
    assert r['nit'] == o['nit']
    _close(r['h2'], o['h2'])
    _close(r['elbo_refit'], o['elbo_refit'])


@pytest.mark.parametrize('spec', ['mix:auto', 'mix_grid:auto'])
def test_mixtures_match_one_process(spec, two):
    r, o = same_on_ranks(two, spec), one(spec.split(':')[0])
    _close(r['elbo'], o['elbo'])
    _close(r['h2'], o['h2'])
    if 'beta' in r:
        assert r['nit'] == o['nit']
        _beta_close(r['beta'], o['beta'])
        _close(r['host_elbo'], o['host_elbo'])


def test_mesh_validation(two):
    """'bogus' and a mesh that is not the world size raise ValueError; a
    mixture refuses a grid axis, naming 'blocks'."""
    r = same_on_ranks(two, 'errors:auto')
    assert 'mesh' in r['bogus']
    assert 'blocks' in r['mix_grid_axis']
    assert '3x1 != 2 processes' in r['world']


def test_deployment_shape_grid_with_compaction_and_restart(four):
    """4 ranks on a 2 x 2 mesh: an S = 16 grid whose lanes are compacted
    (widths multiples of the grid axis), BMA, and a restart on negative
    MSE; the same bits on every rank, and the one-process fit's numbers."""
    r, o = same_on_ranks(four, 'deploy:2x2'), one('deploy')
    widths = [t[0] for t in r['chunk_trace']]
    assert any(w < 16 for w in widths), widths
    assert all(w % 2 == 0 for w in widths), widths
    assert r['restart_fired'] and o['restart_fired']
    _close(r['grid_elbos'], o['grid_elbos'])
    _close(r['bma_h2'], o['bma_h2'])
    _close(r['restart_elbo'], o['restart_elbo'])
    assert r['restart_nit'] == o['restart_nit']


def test_cli_mesh_matches_off(two, cli_root):
    """viprs_fit_torch --mesh 2x1 over 2 ranks against --mesh off in one
    process: h2 and PIP within 1e-6, and only rank 0 writes."""
    from viprs_tpu_torch.cli import fit
    from viprs_tpu_torch.utils.table import read_table
    r0, r1 = two[0]['cli:2x1'], two[1]['cli:2x1']
    assert r0['output'] and r1['output'] is None
    assert r0['cross'] >= 1, "no coupling tile crosses the rank boundary"
    os.environ['VIPRS_TPU_TORCH_PACK_CACHE'] = 'off'
    rec = fit.run(['-l', os.path.join(cli_root, 'native'), '-s',
                   os.path.join(cli_root, 'sumstats.txt'), '--block-size',
                   str(B), '--seed', '1', '--max-iter', '50', '--device',
                   'cpu', '--mesh', 'off', '--output-file',
                   os.path.join(cli_root, 'off', 'out')])
    assert r0['nit'] == rec['nit']
    mesh_fit = read_table(r0['output'] + '.fit.gz')
    off_fit = read_table(rec['output'] + '.fit.gz')
    np.testing.assert_allclose(np.asarray(mesh_fit['PIP'], float),
                               np.asarray(off_fit['PIP'], float),
                               rtol=0, atol=1e-6)
    h = [read_table(p + '.hyp') for p in (r0['output'], rec['output'])]
    h2 = [float(np.asarray(t['Value'], float)[
        list(t['Parameter']).index('Heritability')]) for t in h]
    assert abs(h2[0] - h2[1]) <= 1e-6
    assert not os.path.exists(os.path.join(cli_root, 'mesh', 'out.log.1'))


def test_init_distributed_is_a_no_op_in_one_process(monkeypatch):
    import torch.distributed as dist
    from viprs_tpu_torch.parallel import global_mesh, init_distributed
    for k in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 0
    assert not dist.is_initialized()
    m = global_mesh()
    assert m.shape == {'blocks': 1, 'grid': 1}


if __name__ == '__main__':
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5])
