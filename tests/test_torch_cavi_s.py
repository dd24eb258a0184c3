"""The port's S-lane sweeps (the plain versions of TPU kernels K3 and K4)
against the JAX package's Pallas kernels, on the same bytes.

The problem has five LD tiles of B = 128 with four coupling tiles (one LD
block of 300 variants spans three tiles); its LD, state and per-lane
hyperparameters are made with numpy and handed to both packages. The Pallas
kernels run in interpret mode, as tests/test_pallas.py runs them.

Tolerances: atol 1e-5 on eta, mu, gamma and eta_diff and 1e-4 on q (exp,
log and the order of float32 sums differ between XLA and PyTorch; the
bounds the JAX package holds its own kernels to). Frozen lanes and
quiescent blocks must pass through bit-exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viprs_tpu.ops import cavi_jax, cavi_pallas

from viprs_tpu_torch.model import _dispatch
from viprs_tpu_torch.ops import cavi_cuda, cavi_torch
from viprs_tpu_torch.ops.block_ld import BlockLD
from viprs_tpu_torch.ops.cavi_torch import CaviState, Hyper

from test_torch_cavi import (assert_close, interpret, jax_args,  # noqa: F401
                             make_state, problem, torch_args)


def _active(S, frozen):
    act = np.ones(S, np.float32)
    if frozen:
        act[1::2] = 0.0           # every other lane frozen
    return act


def _assert_frozen_exact(got, st, act):
    off = act == 0
    for k in ('logits', 'mu', 'eta', 'q'):
        np.testing.assert_array_equal(
            getattr(got[0], k).numpy()[off],
            st[CaviState._fields.index(k)][off], err_msg=k)
    np.testing.assert_array_equal(got[1].numpy()[off], 0.0)


@pytest.mark.parametrize('S', [2, 9])
@pytest.mark.parametrize('frozen', [False, True])
def test_plain_k3_matches_pallas(problem, interpret, S, frozen):
    """cavi_sweep_s on CPU tensors (the plain K3) against
    cavi_sweep_pallas at S > 1 (the TPU kernel plus its refresh_q)."""
    st, hy = make_state(problem, S, seed=20 + S)
    act = _active(S, frozen)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    got = cavi_cuda.cavi_sweep_s(problem['ld'], state, sb, nf, hyper,
                                 torch.from_numpy(act))
    want = cavi_pallas.cavi_sweep_pallas.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.asarray(act))
    assert_close(got, want)
    if frozen:
        _assert_frozen_exact(got, st, act)
    # all blocks flagged is the plain all-active sweep, bit for bit
    full = cavi_torch.cavi_sweep(problem['ld'], state, sb, nf, hyper,
                                 torch.from_numpy(act))
    for a, b in zip((*got[0], got[1]), (*full[0], full[1])):
        assert torch.equal(a, b)
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def _half_union_mask(problem, state, sb, nf, hyper, act):
    """K4's gate: the union over the live lanes of the proposal masks, at
    the gate epsilon that flags closest to half of the blocks."""
    nb = problem['nb']
    best = None
    for eps in np.geomspace(1e-8, 1.0, 49):
        blk = cavi_torch.union_block_mask(
            cavi_cuda.block_proposal_mask(problem['ld'], state, sb, nf, hyper,
                                          eps=float(eps)),
            torch.from_numpy(act)).numpy()
        if best is None or abs(blk.sum() - nb / 2) < abs(best.sum() - nb / 2):
            best = blk
    assert 0 < best.sum() < nb
    return best


@pytest.mark.parametrize('S', [2, 9])
@pytest.mark.parametrize('which', ['all', 'union'])
def test_plain_k4_matches_pallas_skip_s(problem, interpret, S, which):
    """cavi_sweep_s_skip on CPU tensors (the plain K4) against
    cavi_sweep_pallas_skip_s, all blocks flagged or the union mask of the
    live lanes at about half of them: quiescent blocks and frozen lanes
    pass through bit-exactly."""
    nb = problem['nb']
    st, hy = make_state(problem, S, seed=30 + S)
    act = _active(S, frozen=True)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    blk = np.ones(nb, bool) if which == 'all' else \
        _half_union_mask(problem, state, sb, nf, hyper, act)
    got = cavi_cuda.cavi_sweep_s_skip(problem['ld'], state, sb, nf, hyper,
                                      torch.from_numpy(act),
                                      torch.from_numpy(blk))
    want = cavi_pallas.cavi_sweep_pallas_skip_s.__wrapped__(
        problem['jld'], *jax_args(problem, st, hy), jnp.asarray(act),
        jnp.asarray(blk))
    assert_close(got, want)
    _assert_frozen_exact(got, st, act)
    for k in ('logits', 'mu', 'eta'):
        np.testing.assert_array_equal(
            getattr(got[0], k).numpy()[:, ~blk],
            st[CaviState._fields.index(k)][:, ~blk], err_msg=k)
    np.testing.assert_array_equal(got[1].numpy()[:, ~blk], 0.0)


def test_union_block_mask_matches_jax(problem):
    """K4's gate: a block is swept iff any live lane proposes a step on it
    (viprs_tpu/ops/em_loop.py:296-297), on a state where the lanes' masks
    differ; a frozen lane's proposals do not count."""
    S = 4
    st, hy = make_state(problem, S, seed=5)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    jstate, jsb, jnf, jhyper = jax_args(problem, st, hy)
    for _ in range(6):
        jstate, _ = cavi_jax.cavi_sweep(problem['jld'], jstate, jsb, jnf,
                                        jhyper, jnp.ones(S))
    state = CaviState.from_numpy(*(np.asarray(x) for x in jstate),
                                 device='cpu')
    seen = set()
    for eps in (1e-8, 1e-6, 1e-5, 1e-4):
        pm = cavi_cuda.block_proposal_mask(problem['ld'], state, sb, nf,
                                           hyper, eps=eps)
        jpm = cavi_pallas.block_proposal_mask(problem['jld'], jstate, jsb,
                                              jnf, jhyper, eps=eps)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
        for act in (np.ones(S, np.float32),
                    np.array([1, 0, 0.5, 0], np.float32),
                    np.array([1, 1, 0, 0], np.float32)):
            got = cavi_torch.union_block_mask(pm, torch.from_numpy(act))
            want = jnp.any(jpm & (jnp.asarray(act)[:, None] > 0.0), axis=0)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            seen.add(tuple(got.tolist()))
    assert len(seen) > 2


@pytest.mark.parametrize('S,impl,expect', [
    (1, None, (False, True)), (1, 'hybrid', (False, True)),
    (1, 'xla', (False, False)), (1, 'pallas', (False, False)),
    (1, 'skip', (True, False)),
    (2, None, (False, False)), (8, None, (False, False)),
    (100, None, (False, False)), (100, 'xla', (False, False)),
    (100, 'pallas', (False, False)), (3, 'skip', (True, False)),
    (100, 'skip', (True, False)),
    (2, 'hybrid', ValueError), (100, 'hybrid', ValueError),
    (1, 'triton', ValueError), (100, 'bogus', ValueError)])
def test_select_sweep_impl_decision_table(S, impl, expect):
    """Every S >= 2 takes a lane kernel (no S < 8 threshold); the hybrid is
    the S = 1 rule."""
    if expect is ValueError:
        with pytest.raises(ValueError):
            _dispatch.select_sweep_impl(S, impl)
    else:
        assert _dispatch.select_sweep_impl(S, impl) == expect


def test_lane_wrappers_never_take_the_plain_version_off_cpu(monkeypatch,
                                                          tmp_path):
    """A tensor that is not on the CPU goes to the lane kernels or raises:
    with the CUDA toolkit made unavailable, the build raises."""
    from viprs_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found (made unavailable by the test)")

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    _build.build.cache_clear()
    ld = BlockLD.from_numpy(np.zeros((2, 128, 128), np.int8),
                            np.zeros((1, 128, 128), np.int8), [0], [1],
                            np.ones((2, 128), np.float32), 1 / 127,
                            device='meta')
    z = torch.zeros(3, 2, 128, device='meta')
    state = CaviState(z, z, z, z)
    hyper = Hyper(*(torch.ones(3, device='meta'),) * 4)
    blk = torch.ones(2, dtype=torch.int32, device='meta')
    try:
        with pytest.raises(RuntimeError, match='nvcc'):
            cavi_cuda.cavi_sweep_s(ld, state, z[0], z[0], hyper,
                                   torch.ones(3, device='meta'))
        with pytest.raises(RuntimeError, match='nvcc'):
            cavi_cuda.coupling_pass_s(ld, z, z, blk)
    finally:
        _build.build.cache_clear()
