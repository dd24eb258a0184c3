"""The judge: the reference against the port's plain path at a tiny size,
its control (the port's plain sweeps in TF32 in the kernels' place), and
whole runs with the timed path broken underneath (the harness's look for a
chip skipped: the port runs its plain versions on the CPU)."""

import numpy as np
import pytest
import torch

from portbench import control, reference
from portbench.panel import make_panel
from portbench.run import run_cell

TRAITS = [0, 1, 2]


def test_reference_ld_is_the_packed_ld():
    from viprs_tpu_torch.ops.block_ld import blockld_to_dense, \
        pack_dense_blocks
    for quantize in (True, False):
        p = make_panel({'m_target': 6000, 'n_gwas': 350000,
                        'panel_seed': 0, 'quantize': quantize})
        packed, layout = pack_dense_blocks(p.blocks, block_size=256,
                                           quantize=quantize)
        dense = blockld_to_dense(packed.to('cpu'))
        idx = layout.flat_index
        R = dense[np.ix_(idx, idx)].astype(np.float64)
        ref = reference.RefLD(p, quantize, 'cpu')
        x = torch.randn(p.m, 3, dtype=torch.float64)
        got = ref.matvec(x).numpy()
        np.testing.assert_allclose(got, R @ x.numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize('cell', ['tiny8.tgrid', 'tiny8.tmix',
                                  'tiny32.tgrid'])
def test_sound_fits_pass_and_the_control_fails(tiny_bench, cell):
    limits = tiny_bench.checks(cell)
    recs = control.readings(tiny_bench, cell, TRAITS, device='cpu')
    for r in recs:
        for k, lim in limits.items():
            assert r['program'][k] <= lim['limit'], (r['trait'], k)
        assert any(not r['control'][k] <= lim['limit']
                   for k, lim in limits.items()), r['trait']


def test_the_control_at_full_precision_passes(tiny_bench):
    limits = tiny_bench.checks('tiny8.tgrid')
    for r in control.readings(tiny_bench, 'tiny8.tgrid', TRAITS[:2],
                              program=False, device='cpu', tf32=False):
        for k, lim in limits.items():
            assert r['control'][k] <= lim['limit'], (r['trait'], k)


def test_the_control_routes_every_lane_sweep_to_the_plain_path():
    from viprs_tpu_torch.ops import cavi_cuda
    names = ('block_sweep_s', 'block_sweep_s1', 'block_sweep_mix',
             'coupling_pass_s_inplace', 'coupling_pass_s1_inplace')
    before = {k: getattr(cavi_cuda, k) for k in names}
    einsum = torch.einsum
    with control.plain_tf32():
        assert all(getattr(cavi_cuda, k) is not before[k] for k in names)
        x = torch.tensor([[1.0 + 2.0 ** -12]])
        assert torch.einsum('ij,jk->ik', x, torch.ones(1, 1)).item() == 1.0
    assert torch.einsum is einsum
    assert all(getattr(cavi_cuda, k) is before[k] for k in names)


def test_an_unknown_entry_raises():
    from portbench import entries
    with pytest.raises(KeyError):
        entries.load('no_such_entry')
    with pytest.raises(KeyError):
        entries.load('../run')
    with pytest.raises(KeyError):
        entries.load('__init__')


def _run(bench, cell, seed=5):
    return run_cell(bench, cell, seed, 2.0, False, device='cpu')


def test_a_sound_run_is_correct(tiny_bench):
    for cell in ('tiny8.tgrid', 'tiny8.tmix'):
        res, lines = _run(tiny_bench, cell)
        assert res['correct'], lines
        assert list(res)[-1] == 'checks'
        assert res['metrics']['fit_s']['value'] > 0


def _unchanged(sweep):
    def f(ld, state, *args, **kw):
        return state, torch.zeros_like(state.eta)
    return f


def _half(sweep):
    def f(ld, state, std_beta, n_per_snp, hyper, active, *args, **kw):
        active = active.clone()
        active[active.shape[0] // 2:] = 0.0
        return sweep(ld, state, std_beta, n_per_snp, hyper, active, *args,
                     **kw)
    return f


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
@pytest.mark.parametrize('cell', ['tiny8.tgrid', 'tiny8.tmix'])
def test_a_broken_path_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    from viprs_tpu_torch.ops import em_loop, mix_em_loop
    from viprs_tpu_torch.model import VIPRSGrid, VIPRSMixGrid
    mod, name = (em_loop, 'cavi_sweep_s') if cell.endswith('tgrid') else \
        (mix_em_loop, 'cavi_sweep_mix_s')
    cls = VIPRSGrid if cell.endswith('tgrid') else VIPRSMixGrid
    if fault == 'unchanged':
        monkeypatch.setattr(mod, name, _unchanged(getattr(mod, name)))
    elif fault == 'half':
        monkeypatch.setattr(mod, name, _half(getattr(mod, name)))
    else:
        fit = cls.fit

        def altered(self, *a, **kw):
            out = fit(self, *a, **kw)
            self._state.eta.mul_(1.05)        # the fit's answer
            return out
        monkeypatch.setattr(cls, 'fit', altered)
    res, lines = _run(tiny_bench, cell)
    assert not res['correct'], lines


def test_one_grid_lane_altered_is_not_correct(tiny_bench, monkeypatch):
    from viprs_tpu_torch.model import VIPRSGrid
    fit = VIPRSGrid.fit

    def altered(self, *a, **kw):
        out = fit(self, *a, **kw)
        self._state.eta[0].mul_(1.05)
        return out
    monkeypatch.setattr(VIPRSGrid, 'fit', altered)
    res, lines = _run(tiny_bench, 'tiny8.tgrid')
    assert not res['correct'], lines


def test_a_wrong_grid_m_step_is_not_correct(tiny_bench, monkeypatch):
    """tau_beta updated half again too large on every lane: eta, the ELBO
    and the model average are consistent with the program's own tau_beta,
    and the judge's fixed point, taken at the M-step of the state, is not."""
    from viprs_tpu_torch.ops import updates
    m_step = updates.m_step

    def wrong(stats, hyper, fix, m_total, active):
        new, sg = m_step(stats, hyper, fix, m_total, active)
        tau = torch.where(active.to(torch.bool), new.tau_beta * 1.5,
                          new.tau_beta)
        return new._replace(tau_beta=tau), sg
    monkeypatch.setattr(updates, 'm_step', wrong)
    res, lines = _run(tiny_bench, 'tiny8.tgrid')
    assert not res['correct'], lines
