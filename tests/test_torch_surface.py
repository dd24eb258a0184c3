"""The rest of the port's model surface against the JAX package's, on the
CPU: the public names and arguments of the model classes, the manual EM
API, the ELBO's terms and the variational views, tracked and progress-
chunked fits, warm starts, checkpoints and continued fits, ``plot_history``
and ``fit(compile_only=True)``.

The port runs the plain versions of the kernels (``device='cpu'``); the
JAX package runs on the CPU with its all-active XLA sweep (``mesh='off'``),
so the port's fits use ``sweep_impl='xla'``. Both take the same numpy
inputs and the same np.random stream.

Tolerances: the ELBO's terms and the views on one carried state within
rtol 1e-6 (float32 statistics summed in another order); the manual EM
steps at the sweep tests' bounds (tests/test_torch_cavi.py: atol 1e-5 on
eta, mu and gamma, 1e-4 on q) and the hyperparameters within rtol 1e-5
after five steps; fits as in tests/test_torch_viprs.py (iterations and
statuses equal behind the guard ``assert_clear_of_thresholds``, the ELBO
within rtol 1e-6 plus atol 1e-3, h2 within 1e-6, PIP within 1e-5) and
each tracked quantity within rtol 1e-6 plus the ELBO's atol scaled to its
size, max |d eta| (a float32 maximum) within 1e-8 absolute; the port's
chunked fits equal to its one-chunk fit within rtol 1e-12; checkpoints bit
for bit.
"""

import inspect
import re
import types

import matplotlib
import numpy as np
import pytest
import torch

from viprs_tpu.data.simulate import simulate_sumstats_blocks
from viprs_tpu.gridsearch import HyperparameterGrid as JaxGrid
from viprs_tpu.model import VIPRS as JaxVIPRS
from viprs_tpu.model import VIPRSGrid as JaxVIPRSGrid
from viprs_tpu.model import VIPRSMix as JaxVIPRSMix
from viprs_tpu.model.ldpred_inf import LDPredInf as JaxLDPredInf
from viprs_tpu.model.mix_grid import VIPRSMixGrid as JaxVIPRSMixGrid
from viprs_tpu.utils import optimize as jopt

from viprs_tpu_torch.gridsearch import HyperparameterGrid
from viprs_tpu_torch.model import VIPRS, VIPRSGrid, VIPRSMix, VIPRSMixGrid
from viprs_tpu_torch.model.ldpred_inf import LDPredInf
from viprs_tpu_torch.ops import cavi_cuda
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper
from viprs_tpu_torch.ops.updates import FixMask
from viprs_tpu_torch.utils import optimize as opt
from viprs_tpu_torch.utils.optimize import summarize_statuses

from test_torch_viprs import (assert_clear_of_thresholds,  # noqa: F401
                              assert_fits_match, both_datasets, flat,
                              ladder_trace)

matplotlib.use('Agg')

#: test_torch_viprs.test_fit_matches_jax's problem: clear of every
#: threshold at FIT_KW, and at scale 3 its MSE goes negative (a restart).
SIM = dict(n=1500, block_sizes=(96, 80), h2=0.3, prop_causal=0.05, seed=0)
FIT_KW = dict(max_iter=60, min_iter=5, f_abs_tol=5e-4)
#: A problem with coupling tiles (an LD block of 250 variants spans two
#: tiles of 128), for the manual steps and the grid.
COUPLED = dict(n=3000, block_sizes=(250, 200), h2=0.35, prop_causal=0.04,
               seed=21)
GRID_12 = dict(pi_steps=4, sigma_epsilon_steps=3, h2_est=0.3, h2_se=0.05)
#: Every tracked quantity, and a callable.
TRACKED = ['pi', 'pis', 'heritability', 'sigma_epsilon', 'tau_beta',
           'sigma_g', 'entropy', 'loglikelihood', 'log_prior', 'mse',
           'max_eta_diff']
ATOL = {'eta': 1e-5, 'mu': 1e-5, 'gamma': 1e-5, 'q': 1e-4}


def twice_h2(model):
    return 2.0 * model.get_heritability()


@pytest.fixture(scope='module')
def nominal():
    return both_datasets(simulate_sumstats_blocks(**SIM))


@pytest.fixture(scope='module')
def restarting():
    return both_datasets(simulate_sumstats_blocks(**SIM), scale=3.0)


@pytest.fixture(scope='module')
def coupled():
    jds, ds = both_datasets(simulate_sumstats_blocks(**COUPLED))
    assert ds.ld.n_off > 0
    return jds, ds


def carry(jm, tm):
    """The JAX model's state, hyperparameters, sigma_g and fix mask into
    the port's model, on the same bytes."""
    tm._S = jm._S
    tm._state = CaviState.from_numpy(*(np.asarray(x) for x in jm._state),
                                     device='cpu')
    tm._hyper = Hyper(*(np.array(x, np.float64) for x in jm._hyper))
    tm._sigma_g = np.array(jm._sigma_g, np.float64)
    tm._fix_mask = FixMask(*(np.asarray(x) for x in jm._fix_mask))
    tm._clear_posterior()


def assert_state_close(tm, jm, atol=ATOL):
    got = {k: getattr(tm._state, k).numpy() for k in ('eta', 'mu', 'q')}
    got['gamma'] = tm._state.gamma.numpy()
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jm._state, k)),
                                   atol=atol[k], rtol=0, err_msg=k)


# ------------------------------------------------------------- the surface
#: The five classes: the JAX package's and the port's.
CLASSES = {'VIPRS': (JaxVIPRS, VIPRS), 'VIPRSGrid': (JaxVIPRSGrid, VIPRSGrid),
           'VIPRSMix': (JaxVIPRSMix, VIPRSMix),
           'VIPRSMixGrid': (JaxVIPRSMixGrid, VIPRSMixGrid),
           'LDPredInf': (JaxLDPredInf, LDPredInf)}
#: JAX parameters the port does not name, with the reason.
EXCEPTIONS = {
    ('LDPredInf', 'fit', 'solver_kwargs'):
        "jax.scipy's cg keywords (x0, M, atol): the port's CG is its own "
        "and names the one it takes, atol",
}


def _kwarg_options(fn):
    """The options a JAX method reads out of its ``**kwargs``."""
    return set(re.findall(r"kwargs\.pop\('(\w+)'", inspect.getsource(fn)))


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_public_surface_matches_jax(name):
    """Every public name of the JAX class exists on the port's, and every
    parameter of its ``__init__`` and ``fit``: a ``**kwargs`` of the JAX
    method is matched by the port's own ``**kwargs`` or by a named
    parameter for each option the JAX method reads from it. The port's
    ``device`` is its own. Exceptions are listed in EXCEPTIONS."""
    jcls, tcls = CLASSES[name]

    def public(c):
        return {n for n in dir(c) if not n.startswith('_')}
    assert not public(jcls) - public(tcls), sorted(public(jcls) - public(tcls))
    for meth in ('__init__', 'fit'):
        jp = inspect.signature(getattr(jcls, meth)).parameters
        tp = inspect.signature(getattr(tcls, meth)).parameters
        t_var = any(p.kind == p.VAR_KEYWORD for p in tp.values())
        for pname, p in jp.items():
            if (name, meth, pname) in EXCEPTIONS:
                assert pname not in tp
                continue
            if p.kind == p.VAR_KEYWORD:
                missing = {o for o in _kwarg_options(getattr(jcls, meth))
                           if o not in tp}
                assert t_var or not missing, (name, meth, missing)
                continue
            assert pname in tp, (name, meth, pname)
        assert 'device' in inspect.signature(tcls.__init__).parameters


# ----------------------------------------------------- every shared module
#: JAX modules the port has no counterpart of, with the reason.
MODULE_EXCEPTIONS = {
    'data.native': "the ctypes bridge to the host C++ BED decoder, LD "
                   "accumulator and quantizer: the port decodes and "
                   "accumulates on the card (data/genotype.py, "
                   "ld_estimators.py) and quantizes to the same bytes in "
                   "ops/block_ld.quantize_int8",
    'ops.cavi_jax': "the XLA sweeps: the port's plain versions are "
                    "ops/cavi_torch.py",
    'ops.cavi_pallas': "the Pallas kernels: the port's are ops/cavi_cuda.py "
                       "(csrc/*.cu)",
}
_TPU = "a TPU workaround (ROADMAP.md's ground rules): not ported"
#: (module, name) or (module, class, name) the port does not have, with
#: the reason.
NAME_EXCEPTIONS = {
    ('ops.block_ld', 'LD_LAYOUT_THRESHOLD_BYTES'): _TPU,
    ('ops.block_ld', 'XLA_DIAG_LAYOUT'): _TPU,
    ('data.dataset', 'SummaryStatsDataset', 'ld_skip_view'): _TPU,
    ('model._dispatch', 'HYBRID_MAX_LD_BYTES'): _TPU,
    ('model._dispatch', 'hybrid_ld_fits'): _TPU,
    ('model._dispatch', 'pallas_allowed'): _TPU,
    ('model._dispatch', 'TPU_BACKENDS'):
        "the backends pallas_allowed admits: " + _TPU,
    ('model._dispatch', 'MIN_PALLAS_LANES'):
        "the lane count below which pallas_allowed's policy keeps the XLA "
        "loop (a TPU measurement); on the card every S >= 2 takes the lane "
        "kernels: " + _TPU,
    ('model._dispatch', 'S1_HYBRID_DEFAULT'):
        "whether pallas_allowed's policy takes the hybrid at S = 1 (a TPU "
        "measurement); on the card S = 1 always does: " + _TPU,
    ('ops.cavi_mix', 'cavi_sweep_mixture'):
        "the XLA/Pallas dispatch of a single-model mixture sweep; the "
        "port's are cavi_cuda.cavi_sweep_mix_s1 (K5) and, plain, "
        "cavi_mix.mix_block_sweep + cavi_torch.refresh_q",
    ('ops.cavi_mix', 'cavi_sweep_mixture_batch'):
        "the XLA/Pallas dispatch of a lane mixture sweep; the port's are "
        "cavi_cuda.cavi_sweep_mix_s (K7) and, plain, "
        "cavi_mix.mix_block_sweep + cavi_torch.refresh_q",
    ('ops.updates', 'collect_stats_jit'):
        "the jitted (one XLA launch) form of collect_stats; the port's "
        "collect_stats is the same function, eager",
    ('ops.em_loop', 'EMCarry'): "the JAX while_loop's carry; the port's "
                                "loop is a host loop",
    ('ops.mix_em_loop', 'MixEMBatchResult'):
        "the port's batch and single mixture loops share MixEMResult",
}
_CONSTANT = (bool, int, float, str, bytes, tuple, list, dict, frozenset)


def _modules(pkg_name):
    """The modules of a package, as names relative to it ('' for the
    package itself)."""
    import importlib
    import pkgutil
    pkg = importlib.import_module(pkg_name)
    return {''} | {m.name[len(pkg_name) + 1:] for m in
                   pkgutil.walk_packages(pkg.__path__, pkg_name + '.')}


def test_modules_only_in_jax_are_listed():
    only = _modules('viprs_tpu') - _modules('viprs_tpu_torch')
    assert only == set(MODULE_EXCEPTIONS), sorted(only)


def _public(mod):
    """The names a module offers: the classes and functions it defines (a
    package: those it exports) and its constants; not what it imports
    from outside the package (typing, functools, numpy dtypes, loggers)."""
    import inspect
    is_pkg = hasattr(mod, '__path__')
    out = set()
    for n in dir(mod):
        if n.startswith('_'):
            continue
        v = getattr(mod, n)
        if inspect.ismodule(v):
            continue
        if inspect.isclass(v) or callable(v):
            home = getattr(v, '__module__', '') or ''
            if home == mod.__name__ or (is_pkg and home.startswith(
                    'viprs_tpu.')):
                out.add(n)
        elif isinstance(v, _CONSTANT):
            out.add(n)
    return out


@pytest.mark.parametrize('name', sorted(_modules('viprs_tpu')
                                         & _modules('viprs_tpu_torch')))
def test_module_surface_matches_jax(name):
    """Every public name of every module both packages have exists in the
    port's module, and every public attribute of each class the JAX
    module defines exists on the port's class of that name (exceptions in
    MODULE_EXCEPTIONS and NAME_EXCEPTIONS)."""
    import importlib
    import inspect
    jmod = importlib.import_module('viprs_tpu' + ('.' + name if name else ''))
    tmod = importlib.import_module(
        'viprs_tpu_torch' + ('.' + name if name else ''))
    missing = []
    for n in sorted(_public(jmod)):
        if (name, n) in NAME_EXCEPTIONS:
            assert not hasattr(tmod, n), (name, n)
            continue
        if not hasattr(tmod, n):
            missing.append(n)
            continue
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if not (inspect.isclass(jv) and jv.__module__ == jmod.__name__):
            continue
        assert inspect.isclass(tv), (name, n)
        for a in sorted(x for x in dir(jv) if not x.startswith('_')):
            if (name, n, a) in NAME_EXCEPTIONS:
                assert not hasattr(tv, a), (name, n, a)
            elif not hasattr(tv, a):
                missing.append(f'{n}.{a}')
    assert not missing, (name, missing)


def test_sampler_parameters_match_jax():
    from viprs_tpu.model import sampler as jsm
    from viprs_tpu_torch.model import sampler as tsm
    for fn in ('smc_over_grid', 'hmc_refine'):
        assert inspect.signature(getattr(tsm, fn)) == \
            inspect.signature(getattr(jsm, fn)), fn
    for meth in ('__init__', 'init_state', 'run'):
        jp = inspect.signature(getattr(jsm.GibbsSampler, meth)).parameters
        tp = inspect.signature(getattr(tsm.GibbsSampler, meth)).parameters
        assert list(tp) == list(jp), meth
        assert [p.default for p in tp.values()] == \
            [p.default for p in jp.values()], meth
    assert tsm.GibbsState._fields == jsm.GibbsState._fields


@pytest.mark.parametrize('grid', [False, True])
def test_em_result_final_mse_matches_jax(grid, nominal, coupled,
                                         ladder_trace, monkeypatch):
    """EMResult.final_mse (the MSE of the last loop call's final state with
    its final hyperparameters) against the JAX package's em_fit, on the
    tracked-fit tests' problems and settings, within the ELBO's rtol
    1e-6."""
    from viprs_tpu_torch.ops import em_loop
    got = []
    orig = em_loop.em_fit
    monkeypatch.setattr(em_loop, 'em_fit',
                        lambda *a, **kw: got.append(orig(*a, **kw))
                        or got[-1])
    if grid:
        jds, ds = coupled
        spec = dict(pi_steps=4, h2_est=0.3, h2_se=0.05)
        kw = dict(max_iter=40, min_iter=8, f_abs_tol=2e-3)
        np.random.seed(9)
        JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **spec), mesh='off').fit(**kw)
        np.random.seed(9)
        VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **spec), 'cpu').fit(
            **kw)
    else:
        jds, ds = nominal
        np.random.seed(7)
        JaxVIPRS(jds, mesh='off').fit(**FIT_KW)
        np.random.seed(7)
        VIPRS(ds, 'cpu').fit(sweep_impl='xla', **FIT_KW)
    assert_clear_of_thresholds(ladder_trace)
    want = np.asarray(ladder_trace.calls[-1]['res'].final_mse)
    assert got[-1].final_mse.shape == want.shape
    assert np.all(want > 0)
    np.testing.assert_allclose(got[-1].final_mse, want, rtol=1e-6)


def test_float_precision_sets_float_eps_only(nominal):
    """float_precision sets float_eps as in the JAX package; the state
    stays float32."""
    jds, ds = nominal
    for fp in ('float32', 'float64'):
        want = JaxVIPRS(jds, mesh='off', float_precision=fp).float_eps
        for m in (VIPRS(ds, 'cpu', float_precision=fp),
                  VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=2),
                            'cpu', float_precision=fp),
                  VIPRSMix(ds, 'cpu', float_precision=fp),
                  LDPredInf(ds, 'cpu', float_precision=fp)):
            assert m.float_precision == fp and m.float_eps == want
    np.random.seed(0)
    m = VIPRS(ds, 'cpu', float_precision='float64').fit(max_iter=3)
    assert all(x.dtype == torch.float32 for x in m._state)


def test_tile_and_mesh_arguments(nominal):
    _, ds = nominal
    for cls in (VIPRS, VIPRSMix):
        for mesh in ('auto', 'off', None):
            assert cls(ds, 'cpu', mesh=mesh).mesh is None
        with pytest.raises(ValueError, match='2x1 != 1 processes'):
            cls(ds, 'cpu', mesh='2x1')
        with pytest.raises(ValueError, match='T = 128'):
            cls(ds, 'cpu', tile=256)
    assert VIPRS(ds, 'cpu', threads=4, order='C', low_memory=False,
                 dequantize_on_the_fly=True).threads == 4
    m = VIPRS(ds, 'cpu')
    assert m.gdl is ds
    m.std_beta = {c: v * 0 for c, v in m.std_beta.items()}
    m.initialize_input_data_arrays()
    assert all(m.std_beta[c] is ds.std_beta[c] or
               np.array_equal(m.std_beta[c], ds.std_beta[c])
               for c in ds.std_beta)
    assert m._std_beta_flat is ds.device_inputs()[0]


# ------------------------------------------- diagnostics and the views
def _jax_stepped(make, steps=3):
    """A JAX model initialized and stepped by hand (e_step, m_step)."""
    np.random.seed(4)
    jm = make()
    jm.initialize()
    for _ in range(steps):
        jm.e_step().m_step()
    return jm


def _jax_fit5(make):
    """A JAX model after five iterations (tolerances that never stop it)."""
    np.random.seed(4)
    jm = make()
    jm.fit(max_iter=5, f_abs_tol=1e-12, x_abs_tol=1e-12)
    return jm


DIAGNOSTICS = ('entropy', 'log_prior', 'loglikelihood',
               'complete_loglikelihood', 'mse', 'elbo')


def assert_diagnostics_match(jm, tm):
    for name in DIAGNOSTICS:
        np.testing.assert_allclose(getattr(tm, name)(),
                                   getattr(jm, name)(), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize('kind', ['VIPRS', 'VIPRSGrid'])
def test_diagnostics_and_views_on_carried_state(kind, coupled):
    """The five diagnostics, the ELBO's decomposition identity
    (tests/test_diagnostics.py), var_tau, zeta, q_dict and the other views
    on the JAX fit's state carried to the port; and a grid's
    models_to_keep / terminated_models."""
    jds, ds = coupled
    if kind == 'VIPRS':
        jm = _jax_stepped(lambda: JaxVIPRS(jds, mesh='off'))
        tm = VIPRS(ds, 'cpu')
    else:
        jm = _jax_stepped(lambda: JaxVIPRSGrid(
            jds, JaxGrid(n_snps=jds.m, **GRID_12), mesh='off'))
        tm = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_12), 'cpu')
    carry(jm, tm)
    assert_diagnostics_match(jm, tm)
    # ELBO = loglik + log_prior + entropy - (M - sum gamma) / 2
    sum_gamma = sum(np.sum(v, axis=0) for v in tm.var_gamma.values())
    np.testing.assert_allclose(
        tm.elbo() - (tm.loglikelihood() + tm.log_prior() + tm.entropy()),
        -0.5 * (tm.m - sum_gamma), rtol=1e-4)
    views = ('var_gamma', 'var_mu', 'var_tau', 'eta', 'zeta', 'q')
    for v in views:
        got, want = getattr(tm, v), getattr(jm, v)
        for c in tm.chromosomes:
            assert got[c].shape == np.shape(want[c]), v
            np.testing.assert_allclose(got[c], want[c], rtol=1e-6,
                                       atol=1e-12, err_msg=v)
    for a, b in ((tm.q_dict(), jm.q_dict()), (tm.compute_pip(), jm.compute_pip()),
                 (tm.compute_eta(), jm.compute_eta()),
                 (tm.compute_zeta(), jm.compute_zeta())):
        np.testing.assert_allclose(flat(a, tm.chromosomes),
                                   flat(b, tm.chromosomes), rtol=1e-6,
                                   atol=1e-12)
    tm.update_posterior_moments()
    jm.update_posterior_moments()
    # the posterior variance zeta - eta^2 cancels in float32: held against
    # the largest zeta as well
    zeta = np.abs(flat(jm.zeta, tm.chromosomes)).max()
    for v in ('pip', 'post_mean_beta', 'post_var_beta'):
        np.testing.assert_allclose(flat(getattr(tm, v), tm.chromosomes),
                                   flat(getattr(jm, v), tm.chromosomes),
                                   rtol=1e-6, atol=1e-6 * zeta, err_msg=v)
    np.testing.assert_allclose(tm.get_null_pi(), jm.get_null_pi(),
                               rtol=1e-15)
    if kind == 'VIPRSGrid':
        codes = np.arange(12) % 10        # every status, RUNNING included
        for m, s in ((jm, jopt), (tm, opt)):
            m.optim_results = s.summarize_statuses(codes, np.zeros(12),
                                                   np.ones(12, int))
        for v in ('models_to_keep', 'terminated_models', 'converged_models'):
            np.testing.assert_array_equal(getattr(tm, v), getattr(jm, v), v)
        assert 0 < tm.models_to_keep.sum() < 12


def test_mixture_diagnostics_and_views_on_carried_state(coupled):
    """VIPRSMix(K=3): the five diagnostics and the views on the JAX fit's
    state carried over (``set_state``); a mixture grid's lane views,
    per-lane posterior moments and statuses."""
    jds, ds = coupled
    jm = _jax_fit5(lambda: JaxVIPRSMix(jds, K=3, mesh='off'))
    tm = VIPRSMix(ds, 'cpu', K=3)
    tm.set_state([np.asarray(x) for x in jm._state],
                 [np.asarray(x) for x in jm._hyper], jm._sigma_g)
    assert_diagnostics_match(jm, tm)
    for v in ('var_gamma', 'var_mu', 'eta', 'q'):
        got, want = getattr(tm, v), getattr(jm, v)
        for c in tm.chromosomes:
            assert got[c].shape == want[c].shape, v
            np.testing.assert_array_equal(got[c], want[c], err_msg=v)
    np.testing.assert_allclose(flat(tm.compute_pip(), tm.chromosomes),
                               flat(jm.compute_pip(), tm.chromosomes),
                               rtol=1e-6)
    spec = dict(pi_steps=3, h2_est=0.3, h2_se=0.05)
    np.random.seed(4)
    jg = JaxVIPRSMixGrid(jds, JaxGrid(n_snps=jds.m, **spec), K=2, mesh='off')
    jg.initialize()
    tg = VIPRSMixGrid(ds, HyperparameterGrid(n_snps=ds.m, **spec), 'cpu', K=2)
    tg.set_state([np.asarray(x) for x in jg._state],
                 [np.asarray(x) for x in jg._hyper], jg._sigma_g)
    tg.update_posterior_moments()
    jg.update_posterior_moments()
    for v in ('pip', 'post_mean_beta', 'post_var_beta'):
        for c in tg.chromosomes:
            want = getattr(jg, v)[c]
            assert getattr(tg, v)[c].shape == (tg.shapes[c], 3)
            np.testing.assert_allclose(getattr(tg, v)[c], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=v)
    assert tg.q[tg.chromosomes[0]].shape == (tg.shapes[tg.chromosomes[0]], 3)
    codes = np.array([1, 2, 4, 9, 0, 8])
    for m, s in ((jg, jopt), (tg, opt)):
        m.optim_results = s.summarize_statuses(codes, np.zeros(6),
                                               np.ones(6, int))
    for v in ('models_to_keep', 'terminated_models'):
        np.testing.assert_array_equal(getattr(tg, v), getattr(jg, v), v)


def test_mixture_sweeps_match_jax(coupled):
    """ops.cavi_mix's plain full sweeps (mix_block_sweep, then refresh_q
    for the coupling tiles), single model and S lanes (with a frozen and a
    damped lane), against the JAX package's cavi_sweep_mixture and
    cavi_sweep_mixture_batch from the same state, at the sweep tests'
    bounds."""
    import jax.numpy as jnp
    from viprs_tpu.ops import cavi_mix as jmix
    from viprs_tpu_torch.ops import cavi_mix
    from viprs_tpu_torch.ops.cavi_torch import refresh_q

    def sweep(state, hyper, active=None):
        new, d = cavi_mix.mix_block_sweep(ds.ld, state, sb, nf, hyper,
                                          active=active)
        return new._replace(q=refresh_q(ds.ld, new.q, d)), d
    jds, ds = coupled
    sb, nf = ds.device_inputs()
    jsb, jnf = jnp.asarray(sb.numpy()), jnp.asarray(nf.numpy())
    jm = _jax_fit5(lambda: JaxVIPRSMix(jds, K=3, mesh='off'))
    h = [np.asarray(x, np.float32) for x in jm._hyper_f32()]
    want, wd = jmix.cavi_sweep_mixture(jds.ld, jm._state, jsb, jnf,
                                       jmix.MixHyper(*map(jnp.asarray, h)))
    got, gd = sweep(
        cavi_mix.MixState(*(x[None] for x in cavi_mix.MixState.from_numpy(
            *(np.asarray(x) for x in jm._state), device='cpu'))),
        cavi_mix.MixHyper.from_numpy(*h, device='cpu').lanes())
    got, gd = cavi_mix.MixState(*(x[0] for x in got)), gd[0]
    atol = dict(ATOL, mu=1e-4)
    for k, v in zip(('gamma', 'mu', 'eta', 'q'), got):
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(want, k)),
                                   atol=atol[k], rtol=0, err_msg=k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5, rtol=0)

    spec = dict(pi_steps=3, h2_est=0.3, h2_se=0.05)
    np.random.seed(4)
    jg = JaxVIPRSMixGrid(jds, JaxGrid(n_snps=jds.m, **spec), K=2, mesh='off')
    jg.initialize()
    h = [np.asarray(x, np.float32) for x in jg._hyper]
    active = np.array([1.0, 0.0, 0.5], np.float32)
    want, _ = jmix.cavi_sweep_mixture_batch(
        jds.ld, jg._state, jsb, jnf, jmix.MixHyper(*map(jnp.asarray, h)),
        jnp.asarray(active))
    got, _ = sweep(
        cavi_mix.MixState.from_numpy(*(np.asarray(x) for x in jg._state),
                                     device='cpu'),
        cavi_mix.MixHyper.from_numpy(*h, device='cpu'),
        torch.from_numpy(active))
    for k, v in zip(('gamma', 'mu', 'eta', 'q'), got):
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(want, k)),
                                   atol=atol[k], rtol=0, err_msg=k)
    np.testing.assert_array_equal(got.eta[1].numpy(),
                                  np.asarray(jg._state.eta)[1])


def test_ported_helpers_match_jax(nominal, tmp_path):
    """utils.compute's dict algebra and coefficient tables, utils.system's
    checks and memory profiler, updates.collect_stats (against the JAX
    package's collect_stats_jit), the hybrid's threshold and the abstract
    model methods, against the JAX package's."""
    import pandas as pd
    from viprs_tpu.model.base import BayesPRSModel as JaxBase
    from viprs_tpu.model import _dispatch as jdispatch
    from viprs_tpu.ops import updates as jup
    from viprs_tpu.utils import compute as jcompute, system as jsystem
    from viprs_tpu_torch.model import _dispatch
    from viprs_tpu_torch.model.base import BayesPRSModel
    from viprs_tpu_torch.ops import em_loop, updates
    from viprs_tpu_torch.utils import compute, system
    from viprs_tpu_torch.utils.table import Table
    rng = np.random.default_rng(0)
    d1 = {1: rng.standard_normal(5), 2: rng.standard_normal(3)}
    d2 = {1: rng.standard_normal(5), 2: rng.standard_normal(3)}
    for fn in ('dict_mean', 'dict_sum', 'dict_max', 'dict_concat'):
        assert getattr(compute, fn)(d1) == pytest.approx(
            getattr(jcompute, fn)(d1), rel=1e-15), fn
    assert compute.dict_sum(d1, transform=np.abs) == \
        jcompute.dict_sum(d1, transform=np.abs)
    assert compute.dict_dot(d1, d2) == jcompute.dict_dot(d1, d2)
    for fn, args in (('dict_elementwise_dot', (d1, d2)),
                     ('dict_elementwise_transform', (d1, np.tanh)),
                     ('dict_repeat', (0.5, {1: (5,), 2: (3, 2)})),
                     ('dict_set', ({c: v.copy() for c, v in d1.items()},
                                   2.0))):
        got, want = getattr(compute, fn)(*args), getattr(jcompute, fn)(*args)
        assert sorted(got) == sorted(want), fn
        for c in got:
            np.testing.assert_array_equal(got[c], want[c], err_msg=fn)
    for shape in ((4,), (4, 1), (4, 3)):
        assert compute.expand_column_names('BETA', shape) == \
            jcompute.expand_column_names('BETA', shape)
    assert compute.fits_in_memory(1.0) and not compute.fits_in_memory(1e12)
    cols = [dict(SNP=['a', 'b'], A1=['A', 'C'], BETA=rng.standard_normal(2))
            for _ in range(3)]
    got = compute.combine_coefficient_tables([Table(c) for c in cols])
    want = jcompute.combine_coefficient_tables([pd.DataFrame(c)
                                                for c in cols])
    assert isinstance(got, Table) and got.columns == list(want.columns)
    for k in got.columns[2:]:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())
    with pytest.raises(ValueError, match='same number of rows'):
        compute.combine_coefficient_tables([Table(cols[0]),
                                            Table(cols[1]).take([0])])
    for x in (3, '2.5', 'x', None, '1e3'):
        assert system.is_numeric(x) == jsystem.is_numeric(x)
    for path in (str(tmp_path / 'a' / 'b.txt'), str(tmp_path)):
        assert system.is_path_writable(path) == \
            jsystem.is_path_writable(path) is True
    with system.PeakMemoryProfiler(interval=0.01) as prof:
        block = np.ones(1 << 22)
    assert prof.get_peak_memory() > block.nbytes / 2 ** 20
    assert prof.get_peak_memory('GB') == prof.get_peak_memory() / 1024
    _, ds = nominal
    st = tuple(torch.from_numpy(rng.standard_normal(
        (2, ds.ld.nb, ds.ld.block_size)).astype(np.float32))
        for _ in range(4))
    vt = torch.full((2, ds.ld.nb, ds.ld.block_size), 700.0)
    sb = ds.device_inputs()[0]
    got = updates.collect_stats(CaviState(*st), vt, sb, ds.ld.mask)
    from viprs_tpu.ops.cavi_jax import CaviState as JaxState
    want = jup.collect_stats_jit(JaxState(*(np.asarray(x) for x in st)),
                                 np.asarray(vt), np.asarray(sb),
                                 np.asarray(ds.ld.mask))
    # float32 sums of signed random terms in another order: 6e-8 apart
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert _dispatch.HYBRID_FRAC == jdispatch.HYBRID_FRAC \
        == em_loop.HYBRID_FRAC
    for cls in (BayesPRSModel, JaxBase):
        for meth in ('fit', 'get_heritability', 'get_proportion_causal'):
            with pytest.raises(NotImplementedError):
                getattr(cls, meth)(None)


# ------------------------------------------------------ manual EM steps
@pytest.mark.parametrize('kind', ['VIPRS', 'VIPRSGrid'])
def test_manual_em_steps_match_jax(kind, coupled):
    """initialize, then five times e_step + m_step from the same start
    (the sweep at full step over every lane and block: K1 with the
    coupling pass at S = 1, K3 at S = 12 on the card), against the JAX
    package's e_step/m_step; then update_pi, update_tau_beta,
    update_sigma_epsilon and _update_sigma_g on one carried state."""
    jds, ds = coupled
    if kind == 'VIPRS':
        jm, tm = JaxVIPRS(jds, mesh='off'), VIPRS(ds, 'cpu')
    else:
        jm = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **GRID_12), mesh='off')
        tm = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_12), 'cpu')
    np.random.seed(6)
    jm.initialize()
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(6)
    tm.initialize()
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert_state_close(tm, jm, atol=dict(ATOL, eta=0.0, mu=0.0, q=0.0,
                                         gamma=1e-7))
    for _ in range(5):
        jm.e_step().m_step()
        assert tm.e_step().m_step() is tm
    assert_state_close(tm, jm)
    np.testing.assert_allclose(tm._last_eta_diff.numpy(),
                               np.asarray(jm._last_eta_diff), atol=1e-5,
                               rtol=0)
    for f in Hyper._fields:
        np.testing.assert_allclose(getattr(tm._hyper, f),
                                   np.asarray(getattr(jm._hyper, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(tm._sigma_g, np.asarray(jm._sigma_g),
                               rtol=1e-5)
    carry(jm, tm)
    for step in ('update_pi', 'update_tau_beta', 'update_sigma_epsilon'):
        getattr(jm, step)()
        assert getattr(tm, step)() is tm
        for f in Hyper._fields:
            np.testing.assert_allclose(getattr(tm._hyper, f),
                                       np.asarray(getattr(jm._hyper, f)),
                                       rtol=1e-6, err_msg=(step, f))
    np.testing.assert_allclose(tm._update_sigma_g(), jm._update_sigma_g(),
                               rtol=1e-6)
    tm.tracked_params = jm.tracked_params = ['pi', 'mse']
    jm.init_optim_meta()
    tm.init_optim_meta()
    jm.update_theta_history()
    tm.update_theta_history()
    assert list(tm.history) == list(jm.history)
    for k in ('pi', 'mse'):
        np.testing.assert_allclose(tm.history[k], jm.history[k], rtol=1e-6)


# ------------------------------------------------------------ checkpoints
def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_files(a, b):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        assert za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize('kind', ['VIPRS', 'VIPRSGrid'])
def test_checkpoints_cross_packages(kind, coupled, tmp_path):
    """A JAX checkpoint loaded by the port and written again is the same
    file (keys, shapes, dtypes, bytes), and a port checkpoint loaded by the
    JAX package and written again likewise; ``_S`` comes from the file."""
    jds, ds = coupled

    def models():
        if kind == 'VIPRS':
            return JaxVIPRS(jds, mesh='off'), VIPRS(ds, 'cpu')
        return (JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **GRID_12),
                             mesh='off'),
                VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **GRID_12),
                          'cpu'))
    jm = _jax_stepped(lambda: models()[0])
    jm.history['ELBO'] = [jm.elbo(), jm.elbo()]
    jf, tf = str(tmp_path / 'jax.npz'), str(tmp_path / 'port.npz')
    jm.save_checkpoint(jf)
    tm = models()[1]
    tm._S = 1
    assert tm.load_checkpoint(jf) is tm
    assert tm._S == jm._S
    tm.save_checkpoint(tf)
    assert_same_files(jf, tf)
    np.testing.assert_allclose(tm.elbo(), jm.elbo(), rtol=1e-6)
    # the other way: the port's own stepped model, loaded by the JAX package
    tm2 = models()[1]
    np.random.seed(8)
    tm2.initialize()
    tm2.e_step().m_step()
    tm2.history['ELBO'] = [tm2.elbo()]
    tm2.save_checkpoint(str(tmp_path / 'port2'))
    jm2 = models()[0].load_checkpoint(str(tmp_path / 'port2'))
    jm2.save_checkpoint(str(tmp_path / 'jax2.npz'))
    assert_same_files(str(tmp_path / 'port2.npz'), str(tmp_path / 'jax2.npz'))


# ------------------------------------------------------------ warm starts
def _param_0(ds, seed=3):
    rng = np.random.default_rng(seed)
    return {'gamma': {c: rng.uniform(0.0, 1.0, n) for c, n in
                      ds.shapes.items()},
            'mu': {c: rng.standard_normal(n) * 0.02 for c, n in
                   ds.shapes.items()}}


@pytest.mark.parametrize('keys', [('gamma',), ('mu',), ('gamma', 'mu')])
def test_warm_start_matches_jax(keys, coupled):
    """param_0 (gamma, mu or both; gamma 0 and 1 included, clipped) gives
    the JAX package's initial state, q by compute_q on the LD's device."""
    jds, ds = coupled
    p0 = {k: v for k, v in _param_0(ds).items() if k in keys}
    for c in p0.get('gamma', {}):
        p0['gamma'][c][:2] = (0.0, 1.0)
    jm, tm = JaxVIPRS(jds, mesh='off'), VIPRS(ds, 'cpu')
    np.random.seed(1)
    jm.initialize(param_0=p0)
    np.random.seed(1)
    tm.initialize(param_0=p0)
    for k in ('logits', 'mu'):
        np.testing.assert_array_equal(getattr(tm._state, k).numpy(),
                                      np.asarray(getattr(jm._state, k)), k)
    # gamma * mu: the two sigmoids may differ in the last bit
    np.testing.assert_allclose(tm._state.eta.numpy(),
                               np.asarray(jm._state.eta), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tm._state.q.numpy(), np.asarray(jm._state.q),
                               atol=1e-6, rtol=0)


# ------------------------------------------------- tracked and progress
#: Tracked quantities of the ELBO's size (~1e3): held as the ELBO is.
ELBO_SIZED = ('ELBO', 'entropy', 'loglikelihood', 'log_prior')


def _history_match(jm, tm, rtol=1e-6):
    """The same keys and lengths; each value within ``rtol`` (plus the
    ELBO's atol 1e-3 for the quantities of its size); max |d eta| within
    1e-7 absolute: a float32 maximum of eta changes whose rounding is
    eta's (an ulp of an eta of 0.05 is 4e-9)."""
    assert list(tm.history) == list(jm.history)
    for k, jv in jm.history.items():
        tv = tm.history[k]
        assert len(tv) == len(jv), k
        jv = np.asarray(jv, np.float64)
        tv = np.asarray(tv, np.float64)
        if k == 'max_eta_diff':
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(
                tv, jv, rtol=rtol, atol=1e-3 if k in ELBO_SIZED else 1e-12,
                equal_nan=True, err_msg=k)


@pytest.mark.parametrize('data', ['nominal', 'restarting'])
def test_tracked_fit_matches_jax(data, request, ladder_trace):
    """A fit tracking every quantity (and a callable), one iteration a
    chunk, against the JAX package's: the same history keys and lengths,
    the values, iterations, status and np.random stream. The restarting
    problem's MSE goes negative: both restart between chunks. Its
    iteration with the negative MSE has h2 of 5.8 (sigma_g + sigma_eps
    near 0), which takes the float32 rounding to 2e-6 relative: the
    tracked values there are held within rtol 1e-5."""
    jds, ds = request.getfixturevalue(data)
    tracked = TRACKED + [twice_h2]
    np.random.seed(7)
    jm = JaxVIPRS(jds, mesh='off', tracked_params=tracked).fit(**FIT_KW)
    assert_clear_of_thresholds(ladder_trace)
    j_rng = np.random.get_state()[1].copy()
    np.random.seed(7)
    tm = VIPRS(ds, 'cpu', tracked_params=tracked).fit(sweep_impl='xla',
                                                       **FIT_KW)
    assert np.array_equal(np.random.get_state()[1], j_rng)
    assert (tm.fix_params.get('sigma_epsilon') == 0.95) == \
        (data == 'restarting')
    assert set(tm.history) == {'ELBO', 'twice_h2', *TRACKED}
    assert len(tm.history['max_eta_diff']) == tm.optim_result.nit
    assert len(tm.history['pi']) == len(tm.history['ELBO'])
    assert_fits_match(jm, tm)
    _history_match(jm, tm, rtol=1e-6 if data == 'nominal' else 1e-5)
    # max |d eta| has one entry fewer (none for the initial state), so
    # neither package makes a table of this history
    for m in (jm, tm):
        with pytest.raises(ValueError):
            m.to_history_table()
        m.history.pop('max_eta_diff')
    jt, tt = jm.to_history_table(), tm.to_history_table()
    assert tt.columns == list(jt.columns)
    for c in tt.columns:
        np.testing.assert_allclose(tt[c], jt[c].values.astype(float),
                                   rtol=1e-6, atol=1e-3, equal_nan=True,
                                   err_msg=c)


def test_progress_callback_fit_matches_jax(ladder_trace):
    """``progress_callback`` (chunks of 25) against the JAX package's: the
    same calls (iterations done, statuses) and the same fit, on
    test_torch_viprs.test_fit_with_coupling_tiles_matches_jax's problem and
    settings (a stop on the ELBO after 29 iterations or more, clear of
    every threshold)."""
    jds, ds = both_datasets(simulate_sumstats_blocks(
        n=3000, block_sizes=(300, 150, 100, 60), h2=0.4, prop_causal=0.05,
        seed=9))
    calls = {'jax': [], 'port': []}

    def record(key):
        return lambda m, it, st: calls[key].append((it, np.array(st).tolist()))
    kw = dict(max_iter=200, min_iter=29, f_abs_tol=6e-5)
    np.random.seed(3)
    jm = JaxVIPRS(jds, mesh='off').fit(progress_callback=record('jax'), **kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(3)
    tm = VIPRS(ds, 'cpu').fit(progress_callback=record('port'),
                              sweep_impl='xla', **kw)
    assert len(calls['port']) >= 2
    assert calls['port'] == calls['jax']
    assert calls['port'][-1][0] == tm.optim_result.nit
    assert_fits_match(jm, tm)


def test_grid_tracked_fit_matches_jax(coupled, ladder_trace):
    """A 4-point grid tracking pi, h2 and the MSE: history rows of shape
    (S,), as the JAX package keeps them, and the per-lane stops."""
    jds, ds = coupled
    spec = dict(pi_steps=4, h2_est=0.3, h2_se=0.05)
    tracked = ['pi', 'heritability', 'mse']
    kw = dict(max_iter=40, min_iter=8, f_abs_tol=2e-3)
    np.random.seed(9)
    jm = JaxVIPRSGrid(jds, JaxGrid(n_snps=jds.m, **spec), mesh='off',
                      tracked_params=tracked).fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(9)
    tm = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, **spec), 'cpu',
                   tracked_params=tracked).fit(**kw)
    np.testing.assert_array_equal(tm._last_result.nit,
                                  np.asarray(jm._last_result.nit))
    np.testing.assert_array_equal(tm._last_result.status,
                                  np.asarray(jm._last_result.status))
    assert all(np.shape(r) == (4,) for k in tracked
               for r in tm.history[k])
    _history_match(jm, tm)
    assert tm.to_history_table().columns[:4] == [f'ELBO_{s}'
                                                 for s in range(4)]


@pytest.mark.parametrize('data', ['nominal', 'restarting'])
def test_chunked_fit_equals_one_chunk(data, request):
    """The port's fit in chunks of 1 and 7 and with tracking equals its
    one-chunk fit (the ladder's counters carry across chunks; the
    restarting problem restarts inside the loop in one chunk, on the host
    between chunks): ELBO history within rtol 1e-12, nit and message
    equal, the same np.random stream."""
    _, ds = request.getfixturevalue(data)
    runs = []
    for kw in (dict(), dict(chunk_iters=1), dict(chunk_iters=7),
               dict(tracked=True)):
        np.random.seed(7)
        tracked = ['pi'] if kw.pop('tracked', False) else None
        m = VIPRS(ds, 'cpu', tracked_params=tracked).fit(
            sweep_impl='xla', **FIT_KW, **kw)
        runs.append((m, np.random.get_state()[1].copy()))
    (m1, rng1), rest = runs[0], runs[1:]
    assert (m1.fix_params.get('sigma_epsilon') == 0.95) == \
        (data == 'restarting')
    for m, rng in rest:
        np.testing.assert_allclose(m.history['ELBO'], m1.history['ELBO'],
                                   rtol=1e-12)
        assert m.optim_result.nit == m1.optim_result.nit
        assert m.optim_result.message == m1.optim_result.message
        assert np.array_equal(rng, rng1)


def test_progress_bar_without_tqdm(nominal, monkeypatch, caplog):
    """disable_pbar=False runs chunks of 25 and, where tqdm is not
    installed (as on the card's machine), logs a line a chunk."""
    import logging
    import sys
    _, ds = nominal
    monkeypatch.setitem(sys.modules, 'tqdm', None)
    np.random.seed(7)
    with caplog.at_level(logging.INFO, logger='viprs_tpu_torch.model.viprs'):
        m = VIPRS(ds, 'cpu').fit(disable_pbar=False, sweep_impl='xla',
                                 **dict(FIT_KW, max_iter=30, min_iter=30))
    assert [w for w, *_ in m._chunk_trace] == [1, 1]
    assert sum('iteration 25/30' in r.message or 'iteration 30/30'
               in r.message for r in caplog.records) == 2


def test_warm_started_fit_matches_jax(nominal, ladder_trace):
    jds, ds = nominal
    p0 = _param_0(ds)
    np.random.seed(7)
    jm = JaxVIPRS(jds, mesh='off').fit(param_0=p0, **FIT_KW)
    assert_clear_of_thresholds(ladder_trace)
    np.random.seed(7)
    tm = VIPRS(ds, 'cpu').fit(param_0=p0, sweep_impl='xla', **FIT_KW)
    assert_fits_match(jm, tm)
    # the mixture takes param_0 and ignores it, as the JAX package does
    np.random.seed(5)
    a = VIPRSMix(ds, 'cpu', K=2).fit(max_iter=3, param_0=p0)
    np.random.seed(5)
    b = VIPRSMix(ds, 'cpu', K=2).fit(max_iter=3)
    assert a.history['ELBO'] == b.history['ELBO']


def test_continued_fit_from_checkpoint_matches_jax(nominal, tmp_path,
                                                   ladder_trace):
    """Both packages load the JAX fit's checkpoint and continue the fit
    (``fit(continued=True)``: the ELBO history goes on from the file's)."""
    jds, ds = nominal
    np.random.seed(7)
    jm = JaxVIPRS(jds, mesh='off').fit(max_iter=4, f_abs_tol=1e-12,
                                       x_abs_tol=1e-12)
    path = str(tmp_path / 'fit.npz')
    jm.save_checkpoint(path)
    jm = JaxVIPRS(jds, mesh='off').load_checkpoint(path)
    tm = VIPRS(ds, 'cpu').load_checkpoint(path)
    ladder_trace.calls.clear()
    kw = dict(FIT_KW, continued=True, min_iter=1)
    jm.fit(**kw)
    assert_clear_of_thresholds(ladder_trace)
    tm.fit(sweep_impl='xla', **kw)
    assert_fits_match(jm, tm)
    assert len(tm.history['ELBO']) == 5 + tm.optim_result.nit


# ------------------------------------------------------------ plot_history
def test_plot_history_matches_jax():
    """The same panels (titles) and lines (data) as the JAX package's, on
    one model's and on a grid's history."""
    import matplotlib.pyplot as plt
    from viprs_tpu.plot import plot_history as jax_plot
    from viprs_tpu_torch.plot import plot_history
    rng = np.random.default_rng(0)
    one = {'ELBO': list(rng.standard_normal(6)), 'pi': list(rng.random(6)),
           'mse': list(rng.random(6))}
    grid = {'ELBO': list(rng.standard_normal((5, 2))),
            'heritability': list(rng.random((5, 2)))}
    for hist, quantities in ((one, ['ELBO', 'mse']), (grid, ['ELBO'])):
        model = types.SimpleNamespace(history=hist)
        got, want = (f(model, quantities=quantities, col_wrap=2)
                     for f in (plot_history, jax_plot))
        ga, wa = list(got.axes.flat), list(want.axes.flat)
        assert [a.get_title() for a in ga] == [a.get_title() for a in wa]
        for a, b in zip(ga, wa):
            la, lb = a.get_lines(), b.get_lines()
            assert len(la) == len(lb) > 0
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x.get_xydata(), y.get_xydata())
        plt.close('all')


# ------------------------------------------------------------ compile_only
def test_compile_only_changes_nothing(nominal):
    """fit(compile_only=True) on a fitted model (and on a fresh one) leaves
    the state, the history and np.random's stream as they were (on the
    CPU there is no library to build); a refused inner_steps raises before
    anything runs."""
    _, ds = nominal
    spec = dict(pi_steps=2, h2_est=0.3, h2_se=0.05)
    grid = HyperparameterGrid(n_snps=ds.m, **spec)
    for make in (lambda: VIPRS(ds, 'cpu', tracked_params=['pi']),
                 lambda: VIPRSGrid(ds, grid, 'cpu'),
                 lambda: VIPRSMix(ds, 'cpu', K=2),
                 lambda: VIPRSMixGrid(ds, grid, 'cpu', K=2)):
        fresh = make()
        np.random.seed(3)
        before = np.random.get_state()[1].copy()
        assert fresh.fit(compile_only=True) is fresh
        assert fresh._state is None and fresh.history == {}
        m = make().fit(max_iter=3)
        state = [x.clone() for x in m._state]
        hist = {k: list(v) for k, v in m.history.items()}
        before = np.random.get_state()[1].copy()
        m.fit(compile_only=True, max_iter=50)
        with pytest.raises(ValueError, match='inner steps'):
            m.fit(inner_steps=4)
        assert np.array_equal(np.random.get_state()[1], before)
        assert all(torch.equal(a, b) for a, b in zip(state, m._state))
        assert {k: list(v) for k, v in m.history.items()} == hist
    assert cavi_cuda.build_for(ds.ld) is None
    assert not any(cavi_cuda.LAUNCHES.values())


def test_grid_status_views_follow_the_fit(nominal):
    """models_to_keep / terminated_models of a port grid fit from its own
    per-lane statuses."""
    _, ds = nominal
    np.random.seed(2)
    g = VIPRSGrid(ds, HyperparameterGrid(n_snps=ds.m, pi_steps=3, h2_est=0.3,
                                         h2_se=0.05), 'cpu').fit(max_iter=200)
    r = summarize_statuses(g._last_result.status, g._last_result.final_elbo,
                           g._last_result.nit)
    np.testing.assert_array_equal(g.terminated_models,
                                  [x.stop_iteration for x in r])
    np.testing.assert_array_equal(
        g.models_to_keep, [(not x.stop_iteration) or x.success for x in r])
