"""The port's M-step and objectives against viprs_tpu.ops.updates.

Inputs (S = 3 lanes, one frozen, mixed fixed hyperparameters) come from a
numpy seed and go to both packages. Tolerance rtol 1e-6: the float64 results
differ only through the order of the float32 per-block sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.ops import cavi_jax
from viprs_tpu.ops import updates as jax_updates

from viprs_tpu_torch.ops import updates
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

RTOL = 1e-6
S, NB, B = 3, 4, 128


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(4)
    shape = (S, NB, B)
    mask = np.ones((NB, B), np.float32)
    mask[-1, 100:] = 0.0
    logits = (-3.0 + rng.standard_normal(shape)).astype(np.float32)
    mu = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    eta = (1 / (1 + np.exp(-logits)) * mu * mask).astype(np.float32)
    q = (0.02 * rng.standard_normal(shape) * mask).astype(np.float32)
    sb = (0.03 * rng.standard_normal((NB, B)) * mask).astype(np.float32)
    nf = np.full((NB, B), 5000.0, np.float32)
    hy = dict(sigma_eps=np.array([0.7, 0.8, 0.9], np.float32),
              tau_beta=np.array([400., 800., 1600.], np.float32),
              pi=np.array([0.01, 0.05, 0.1], np.float32),
              lambda_min=np.array([0.0, 0.0, 0.1], np.float32))
    fix = dict(sigma_eps=np.array([False, True, False]),
               tau_beta=np.array([False, False, True]),
               pi=np.array([True, False, False]))
    return dict(state=(logits, mu, eta, q), sb=sb, nf=nf, mask=mask, hy=hy,
                fix=fix, active=np.array([True, True, False]),
                sigma_g=np.array([0.2, 0.3, 0.1]))


def both_stats(x):
    jst = cavi_jax.CaviState(*(jnp.asarray(a) for a in x['state']))
    jh = cavi_jax.Hyper(**{k: jnp.asarray(v) for k, v in x['hy'].items()})
    jvt = jax_updates.compute_var_tau(jnp.asarray(x['nf']), jh)
    want = jax_updates.collect_stats(jst, jvt, jnp.asarray(x['sb']),
                                     jnp.asarray(x['mask']))
    st = CaviState.from_numpy(*x['state'], device='cpu')
    h = Hyper.from_numpy(**x['hy'], device='cpu')
    vt = updates.compute_var_tau(torch.from_numpy(x['nf']), h)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=RTOL)
    got = updates.collect_stats(st, vt, torch.from_numpy(x['sb']),
                                torch.from_numpy(x['mask']))
    return got, want


def test_collect_stats(inputs):
    got, want = both_stats(inputs)
    for name, g, w in zip(updates.SweepStats._fields, got, want):
        assert g.dtype == torch.float64 and g.shape == (S,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   err_msg=name)


def test_m_step_elbo_mse_heritability(inputs):
    got_st, want_st = both_stats(inputs)
    # feed both the same (JAX) statistics, so only the formulas are compared
    st = updates.SweepStats(*(torch.tensor(np.asarray(w))
                              for w in want_st))
    hy64 = {k: v.astype(np.float64) for k, v in inputs['hy'].items()}
    h = Hyper.from_numpy(**hy64, device='cpu')
    jh = cavi_jax.Hyper(**{k: jnp.asarray(v) for k, v in hy64.items()})
    fix = updates.FixMask(*(torch.from_numpy(inputs['fix'][k])
                            for k in ('sigma_eps', 'tau_beta', 'pi')))
    jfix = jax_updates.FixMask(*(jnp.asarray(inputs['fix'][k])
                                 for k in ('sigma_eps', 'tau_beta', 'pi')))
    act = inputs['active']
    m_total, n = 480.0, 5000.0

    new_h, sg = updates.m_step(st, h, fix, m_total, torch.from_numpy(act))
    jnew_h, jsg = jax_updates.m_step(want_st, jh, jfix, m_total,
                                     jnp.asarray(act))
    np.testing.assert_allclose(sg.numpy(), np.asarray(jsg), rtol=RTOL)
    for name, a, b in zip(Hyper._fields, new_h, jnew_h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   err_msg=name)
    # frozen lane keeps its values:
    assert float(new_h.pi[2]) == float(h.pi[2])

    sigma_g = torch.from_numpy(inputs['sigma_g'])
    e = updates.elbo(st, new_h, fix.sigma_eps, sigma_g, n, m_total)
    je = jax_updates.elbo(want_st, jnew_h, jfix.sigma_eps,
                          jnp.asarray(inputs['sigma_g']), n, m_total)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=RTOL)
    np.testing.assert_allclose(
        updates.mse(st, sigma_g).numpy(),
        np.asarray(jax_updates.mse(want_st, jnp.asarray(inputs['sigma_g']))),
        rtol=RTOL)
    np.testing.assert_allclose(
        updates.heritability(sigma_g, new_h.sigma_eps).numpy(),
        np.asarray(jax_updates.heritability(jnp.asarray(inputs['sigma_g']),
                                            jnew_h.sigma_eps)),
        rtol=RTOL)


def test_entropy_terms_stable_for_large_logits():
    """Softplus is exact beyond torch's linear threshold (|u| > 20), as
    jax.nn.softplus is."""
    u = torch.tensor([[[30.0, -30.0, 0.0, 25.0]]])
    st = CaviState(logits=u, mu=torch.zeros_like(u), eta=torch.zeros_like(u),
                   q=torch.zeros_like(u))
    vt = torch.ones_like(u)
    got = updates.collect_stats(st, vt, torch.zeros(1, 4), torch.ones(1, 4))
    ju = jnp.asarray(u.numpy())
    want = jax_updates.collect_stats(
        cavi_jax.CaviState(ju, ju * 0, ju * 0, ju * 0), jnp.asarray(vt.numpy()),
        jnp.zeros((1, 4)), jnp.ones((1, 4)))
    for name, g, w in zip(updates.SweepStats._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-30, err_msg=name)
