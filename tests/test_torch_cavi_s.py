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

import dataclasses

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
    cavi_sweep_pallas at S > 1 (the TPU kernel plus its refresh_q), with
    the LD's diag_nz present (flagging both zero and nonzero blocks)."""
    assert (problem['ld'].diag_nz == 0).any() and problem['ld'].diag_nz.any()
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


def _expected_coupling_slabs(off, off_src, off_dst, nb):
    """numpy enumeration of coupling_pass_s's launch plan from the tiles
    themselves: the slabs of 128 coordinates of a tile's src block (in its
    rows) and dst block (in its columns) that hold a nonzero, as
    b * (B / 128) + slab, most such tiles first, ties ascending."""
    ns = off.shape[1] // 128
    count = np.zeros(nb * ns, np.int64)
    for o, (s, d) in enumerate(zip(off_src, off_dst)):
        for x in range(ns):
            count[s * ns + x] += off[o, 128 * x:128 * (x + 1), :].any()
            count[d * ns + x] += off[o, :, 128 * x:128 * (x + 1)].any()
    return np.array([e for e in sorted(range(nb * ns),
                                       key=lambda e: (-count[e], e))
                     if count[e] > 0], np.int32)


@pytest.mark.parametrize('case', ['problem', 'chain', 'sparse'])
def test_coupling_launch_plan_matches_numpy_enumeration(problem, case):
    """The launch plan of coupling_pass_s, ``BlockLD.cpl_slabs``: the
    (block, slab) pairs some coupling tile can change, built on the device
    side once per LD; in 'sparse' most tiles are zero but for a corner and
    one is all zero, so only a few slabs are listed. (Which of them a mask
    reaches is decided inside the kernel, which G1 of chip_smoke.py checks
    on the card.)"""
    rng = np.random.default_rng(7)
    if case == 'problem':
        ld = problem['ld']
    else:
        nb, B = (9, 128) if case == 'chain' else (40, 256)
        pairs = [(0, 1), (0, 2), (1, 2), (4, 5), (6, 7), (6, 8), (7, 8)] \
            if case == 'chain' else [(3, 4), (10, 11), (20, 22), (21, 22)]
        off = rng.integers(-127, 128, (len(pairs), B, B)).astype(np.int8)
        if case == 'sparse':
            off[:, :200, :] = 0
            off[:, :, 40:] = 0
            off[2] = 0
        ld = BlockLD.from_numpy(np.zeros((nb, B, B), np.int8), off,
                                [p[0] for p in pairs], [p[1] for p in pairs],
                                np.ones((nb, B), np.float32), 1 / 127,
                                device='cpu')
    got = ld.cpl_slabs
    assert got.dtype == torch.int32 and got.is_contiguous()
    want = _expected_coupling_slabs(ld.off_data.numpy(), ld.off_src.numpy(),
                                    ld.off_dst.numpy(), ld.nb)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 'sparse':
        # three nonzero tiles: src slab 1 (rows 200..), dst slab 0 (..40)
        assert len(want) == 6


def test_coupling_lane_tile_matches_enumeration():
    """The lane tile by S: the smallest instance that holds S, else 100 with
    ceil(S / 100) lane tiles; every lane is covered exactly once."""
    tiles = (4, 16, 32, 100)
    assert cavi_cuda.COUPLING_LANE_TILES == tiles
    for S in range(1, 260):
        want = min([L for L in tiles if L >= S] or [100])
        L = cavi_cuda.coupling_lane_tile(S)
        assert L == want, S
        n_tiles = -(-S // L)
        assert (n_tiles - 1) * L < S <= n_tiles * L
    assert [cavi_cuda.coupling_lane_tile(S) for S in (2, 8, 16, 20, 100)] \
        == [4, 16, 16, 32, 100]


@pytest.mark.parametrize('mask', ['all', 'one', 'none'])
def test_coupling_pass_s_leaves_its_input_untouched_on_cpu(problem, mask):
    """coupling_pass_s returns a new q and never writes its input (the CPU
    takes the plain version; the card runs the kernel on a clone), and
    equals the JAX package's refresh_q / coupling restriction."""
    nb = problem['nb']
    st, _ = make_state(problem, 5, seed=3)
    rng = np.random.default_rng(4)
    diff = (1e-2 * rng.standard_normal(st[2].shape) * problem['mask']
            ).astype(np.float32)
    blk = {'all': np.ones(nb, np.int32), 'none': np.zeros(nb, np.int32),
           'one': np.eye(nb, dtype=np.int32)[int(problem['ld'].off_dst[0])]
           }[mask]
    q = torch.from_numpy(st[3].copy())
    got = cavi_cuda.coupling_pass_s(problem['ld'], q, torch.from_numpy(diff),
                                    torch.from_numpy(blk))
    np.testing.assert_array_equal(q.numpy(), st[3])
    want = cavi_torch.coupling_pass(problem['ld'], torch.from_numpy(st[3]),
                                    torch.from_numpy(diff),
                                    torch.from_numpy(blk))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if mask == 'all':
        assert got is not q
        np.testing.assert_allclose(
            got.numpy(), np.asarray(cavi_jax.refresh_q(
                problem['jld'], jnp.asarray(st[3]), jnp.asarray(diff))),
            atol=1e-5, rtol=0)
    if mask == 'none':
        np.testing.assert_array_equal(got.numpy(), st[3])
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


def test_coupling_pass_s_inplace_refuses_cpu_tensors(problem):
    """The in-place launcher is the kernel's alone: CPU tensors raise (the
    plain version is coupling_pass_s's)."""
    st, _ = make_state(problem, 2, seed=1)
    q = torch.from_numpy(st[3].copy())
    with pytest.raises(ValueError, match='card'):
        cavi_cuda.coupling_pass_s_inplace(
            problem['ld'], q, torch.zeros_like(q),
            torch.ones(problem['nb'], dtype=torch.int32))
    np.testing.assert_array_equal(q.numpy(), st[3])


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


#: The lane wrappers and compositions (K3/K4, the coupling pass, K7/K8) as
#: (name, call(ld, args)), and the kernel launchers each one reaches.
LANE_CALLS = {
    'block_sweep_s': (
        lambda ld, a: cavi_cuda.block_sweep_s(ld, a['state'], a['z'], a['z'],
                                              a['hyper'], a['act'], a['blk']),
        {'cavi_block_sweep_s'}),
    'cavi_sweep_s': (
        lambda ld, a: cavi_cuda.cavi_sweep_s(ld, a['state'], a['z'], a['z'],
                                             a['hyper'], a['act']),
        {'cavi_block_sweep_s', 'coupling_pass_s'}),
    'cavi_sweep_s_skip': (
        lambda ld, a: cavi_cuda.cavi_sweep_s_skip(
            ld, a['state'], a['z'], a['z'], a['hyper'], a['act'], a['blk']),
        {'cavi_block_sweep_s', 'coupling_pass_s'}),
    'coupling_pass_s_inplace': (
        lambda ld, a: cavi_cuda.coupling_pass_s_inplace(ld, a['q'], a['q'],
                                                        a['blk']),
        {'coupling_pass_s'}),
    'coupling_pass_s': (
        lambda ld, a: cavi_cuda.coupling_pass_s(ld, a['q'], a['q'], a['blk']),
        {'coupling_pass_s'}),
    'block_sweep_mix': (
        lambda ld, a: cavi_cuda.block_sweep_mix(
            ld, a['mix'], a['z'], a['z'], a['mh'], a['act'], a['blk'], False,
            'cavi_sweep_mix_s'),
        {'cavi_block_sweep_mix_s'}),
    'cavi_sweep_mix_s': (
        lambda ld, a: cavi_cuda.cavi_sweep_mix_s(ld, a['mix'], a['z'], a['z'],
                                                 a['mh'], a['act']),
        {'cavi_block_sweep_mix_s', 'coupling_pass_s'}),
    'cavi_sweep_mix_s_skip': (
        lambda ld, a: cavi_cuda.cavi_sweep_mix_s_skip(
            ld, a['mix'], a['z'], a['z'], a['mh'], a['act'], a['blk']),
        {'cavi_block_sweep_mix_s', 'coupling_pass_s'})}


def _meta_lane_args(S, K, nb, B):
    """State, inputs, hyperparameters, step scales and an all-blocks mask of
    S lanes (K mixture components) on the meta device."""
    from viprs_tpu_torch.ops.cavi_mix import MixHyper, MixState
    z = torch.zeros(S, nb, B, device='meta')
    zk = torch.zeros(S, K, nb, B, device='meta')
    act = torch.ones(S, device='meta')
    return dict(state=CaviState(z, z, z, z), z=z[0], q=z,
                hyper=Hyper(*(torch.ones(S, device='meta'),) * 4), act=act,
                blk=torch.ones(nb, dtype=torch.int32, device='meta'),
                mix=MixState(zk, zk, z, z),
                mh=MixHyper(act, torch.ones(S, K, device='meta'),
                            torch.ones(S, K, device='meta'), act))


@pytest.mark.parametrize('call', list(LANE_CALLS))
def test_lane_wrappers_launch_the_float32_instances(monkeypatch, call):
    """Float32 LD tiles go to the float32 instances of the lane kernels
    (cavi_block_sweep_s_f32_launch, coupling_pass_s_f32_launch,
    cavi_block_sweep_mix_s_f32_launch) with scale 1.0, counted under their
    names with _f32 appended; the same call on int8 tiles launches the int8
    instances with the int8 scale and no float32 one (a stand-in library
    records the launches; meta tensors take the place of the card's)."""
    from test_torch_cavi import _meta_ld, _stand_in_lib
    fn, launchers = LANE_CALLS[call]
    S, K, nb, B, n_off = 5, 2, 3, 256, 2
    args = _meta_lane_args(S, K, nb, B)
    for dtype, sfx, scale in ((np.float32, '_f32', 1.0),
                              (np.int8, '', np.float32(1 / 127))):
        calls = {}
        _stand_in_lib(monkeypatch, calls)
        ld = _meta_ld(nb, B, n_off, dtype)
        fn(ld, args)
        assert set(calls) == {k + sfx + '_launch' for k in launchers}
        # the scale follows the pointers: (S, [K,] nb, B, scale, ...) for
        # the sweeps, (n_slabs, S, nb, B, scale, L) for the coupling pass
        for name, launches in calls.items():
            at = 14 if name.startswith('coupling') else (
                20 if 'mix' in name else 19)
            assert [a[at] for a in launches] == [scale] * len(launches), name
        counted = {k: v for k, v in cavi_cuda.LAUNCHES.items() if v}
        assert all(k.endswith('_f32') == (sfx == '_f32') for k in counted)
        assert sum(counted.values()) == sum(map(len, calls.values()))


@pytest.mark.parametrize('diag,off,msg', [
    (torch.float64, torch.float64, 'int8 or float32'),
    (torch.float16, torch.float16, 'int8 or float32'),
    (torch.int8, torch.float32, 'share one dtype'),
    (torch.float32, torch.int8, 'share one dtype')])
def test_lane_wrappers_refuse_other_tile_dtypes_up_front(monkeypatch, diag,
                                                         off, msg):
    """Off the CPU, the lane wrappers take int8 or float32 tiles, diag and
    off_data alike: float64 or float16 tiles and mixed int8/float32 tiles
    raise a ValueError through every lane wrapper and composition before
    anything is launched."""
    from test_torch_cavi import _meta_ld, _retyped, _stand_in_lib
    calls = {}
    _stand_in_lib(monkeypatch, calls)
    nb, B = 2, 128
    ld = _retyped(_meta_ld(nb, B, 1), diag, off)
    args = _meta_lane_args(3, 2, nb, B)
    for fn, _ in LANE_CALLS.values():
        with pytest.raises(ValueError, match=msg):
            fn(ld, args)
    assert not calls
    assert sum(cavi_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize('bad', [None, 'shape', 'dtype', 'layout'])
def test_block_sweep_s_checks_diag_nz_before_launching(monkeypatch, bad):
    """Off the CPU, block_sweep_s checks BlockLD.diag_nz (dtype, shape,
    contiguity) before it launches, and hands the kernel the flags and the
    lane tile picked by S (a stand-in library records the launch; meta
    tensors take the place of the card's)."""
    from viprs_tpu_torch.ops import _build
    calls = []

    class Lib:
        def cavi_block_sweep_s_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, 'build', lambda: (Lib(), {}))
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev: type('Stream', (), {'cuda_stream': 0}))
    monkeypatch.setitem(cavi_cuda.LAUNCHES, 'cavi_block_sweep_s', 0)
    S, nb, B = 9, 2, 256
    ld = BlockLD.from_numpy(np.zeros((nb, B, B), np.int8),
                            np.zeros((0, B, B), np.int8), [], [],
                            np.ones((nb, B), np.float32), 1 / 127,
                            device='meta')
    assert ld.diag_nz.shape == (nb, 8, 8) and ld.diag_nz.dtype == torch.uint8
    nz = {'shape': torch.ones(nb, 4, 4, dtype=torch.uint8, device='meta'),
          'dtype': torch.ones(nb, 8, 8, dtype=torch.int32, device='meta'),
          'layout': torch.ones(nb, 8, 8, dtype=torch.uint8,
                               device='meta').transpose(1, 2)}
    if bad is not None:
        ld = dataclasses.replace(ld, diag_nz=nz[bad])
    z = torch.zeros(S, nb, B, device='meta')
    args = (ld, CaviState(z, z, z, z), z[0], z[0],
            Hyper(*(torch.ones(S, device='meta'),) * 4),
            torch.ones(S, device='meta'),
            torch.ones(nb, dtype=torch.int32, device='meta'))
    if bad is None:
        out, eta_diff = cavi_cuda.block_sweep_s(*args)
        assert eta_diff.shape == (S, nb, B)
        assert len(calls) == 1
        assert calls[0][-2] == cavi_cuda.sweep_lane_tile(S) == 16
        assert cavi_cuda.LAUNCHES['cavi_block_sweep_s'] == 1
    else:
        with pytest.raises(ValueError, match='diag_nz'):
            cavi_cuda.block_sweep_s(*args)
        assert not calls
        assert cavi_cuda.LAUNCHES['cavi_block_sweep_s'] == 0


def test_sweep_lane_tile_matches_enumeration():
    """The lane tile of cavi_block_sweep_s by S: the smallest instance that
    holds S, else 20 with ceil(S / 20) lane tiles; every lane is covered
    exactly once."""
    tiles = (4, 8, 16, 20)
    assert cavi_cuda.SWEEP_LANE_TILES == tiles
    for S in range(1, 260):
        want = min([L for L in tiles if L >= S] or [20])
        L = cavi_cuda.sweep_lane_tile(S)
        assert L == want, S
        n_tiles = -(-S // L)
        assert (n_tiles - 1) * L < S <= n_tiles * L
    assert [cavi_cuda.sweep_lane_tile(S) for S in (2, 16, 100)] == [4, 16, 20]


def test_block_sweep_s_takes_the_inner_steps_probe_on_the_card_only(problem):
    """Fewer inner steps are a timing probe of the kernel; the plain version
    on the CPU runs INNER_STEPS and refuses any other count."""
    st, hy = make_state(problem, 2, seed=2)
    state, sb, nf, hyper = torch_args(problem, st, hy)
    blk = torch.ones(problem['nb'], dtype=torch.int32)
    act = torch.ones(2)
    with pytest.raises(ValueError, match='inner steps'):
        cavi_cuda.block_sweep_s(problem['ld'], state, sb, nf, hyper, act, blk,
                                inner_steps=0)
    got = cavi_cuda.block_sweep_s(problem['ld'], state, sb, nf, hyper, act,
                                  blk, inner_steps=cavi_torch.INNER_STEPS)
    want = cavi_torch.block_sweep(problem['ld'], state, sb, nf, hyper, act,
                                  blk_mask=blk)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
