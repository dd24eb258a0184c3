"""The harness is driven by data: a configuration, a traffic mix, a
metric and a lane-kernel pattern are taken up from new files; and the
check for JAX compares whole top-level module names."""

import json
import os
import subprocess
import sys

import pytest

from portbench.run import Bench, RunRecord, forbidden_modules, run_cell

from .conftest import ROOT, make_tiny_bench


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {'jax.numpy': 1, 'jaxlib': 1, 'viprs_tpu': 1,
            'viprs_tpu.ops.em_loop': 1, 'viprs_tpu_torch': 1,
            'viprs_tpu_torch.ops': 1, 'jaxtyping': 1, 'flax.linen': 1,
            'torch': 1}
    assert forbidden_modules(mods) == ['flax.linen', 'jax.numpy', 'jaxlib',
                                       'viprs_tpu', 'viprs_tpu.ops.em_loop']


def test_new_files_are_taken_up_without_an_edit(tmp_path):
    bench = make_tiny_bench(str(tmp_path))
    here = bench.here
    # a new configuration, traffic mix, metric and lane-kernel pattern
    with open(os.path.join(here, 'configs', 'tiny8.json')) as f:
        cfg = json.load(f)
    cfg.update(name='tinyb', panel_seed=4)
    with open(os.path.join(here, 'configs', 'tinyb.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(here, 'traffic', 'tgrid.json')) as f:
        t = json.load(f)
    t['grid'] = {'pi_steps': 2, 'sigma_epsilon_steps': 2, 'h2_est': 0.3,
                 'h2_se': 0.05}
    # a new kind of entry, found by its name
    with open(os.path.join(here, 'entries', 'viprs_grid_bma.py')) as f:
        src = f.read()
    with open(os.path.join(here, 'entries', 'viprs_grid_copy.py'),
              'w') as f:
        f.write(src)
    t['entry'] = 'viprs_grid_copy'
    with open(os.path.join(here, 'traffic', 'tgrid2.json'), 'w') as f:
        json.dump(t, f)
    with open(os.path.join(here, 'checks', 'tiny8.tgrid.json')) as f:
        checks = f.read()
    with open(os.path.join(here, 'checks', 'tinyb.tgrid2.json'), 'w') as f:
        f.write(checks)
    with open(os.path.join(here, 'metrics', 'fits_in_window.py'), 'w') as f:
        f.write("UNIT = 'fits'\n\n\ndef read(run):\n"
                "    return len(run.fits)\n")
    with open(os.path.join(here, 'metrics', 'estep_roofline_pct',
                           'new_kernel.txt'), 'w') as f:
        f.write('# a renamed sweep\ncavi_lane_sweep_v2\n')
    spec = bench.spec
    spec['configs'].append({'name': 'tinyb', 'source': 'a tiny panel',
                            'file': 'portbench/configs/tinyb.json',
                            'reduced': [], 'why': 'test'})
    spec['workloads'].append({'name': 'tinyb.tgrid2', 'config': 'tinyb',
                              'traffic': 'tgrid2', 'chips': 1,
                              'why': 'test'})
    spec['end_to_end'].append({'name': 'fits_in_window', 'unit': 'fits',
                               'better': 'higher', 'bound': 0.01,
                               'source': 'host_clock'})
    with open(os.path.join(str(tmp_path), 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    bench = Bench(root=str(tmp_path), here=here)
    res, lines = run_cell(bench, 'tinyb.tgrid2', 9, 1.0, False,
                          device='cpu')
    assert res['correct'], lines
    assert res['metrics']['fits_in_window']['value'] >= 1
    rec = RunRecord.__new__(RunRecord)
    rec.metrics_dir = os.path.join(here, 'metrics')
    pats = [p.pattern for p in rec.lane_kernel_patterns()]
    assert 'cavi_lane_sweep_v2' in pats and 'cavi_block_sweep_' in pats


def test_a_traced_run_reads_the_per_layer_metrics(tiny_bench):
    res, lines = run_cell(tiny_bench, 'tiny8.tgrid', 4, 1.0, True,
                          device='cpu')
    assert res['correct'], lines
    m = res['metrics']
    assert {'pack_s', 'solver_nit_max', 'bma_ms'} <= set(m)
    # no device on the CPU: the device-trace metrics have nothing to read
    assert 'estep_roofline_pct' not in m
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, '-m', 'portbench.run',
                           '--workload', 'hm3_int8.grid100', '--seed', '1',
                           '--seconds', '1', '--trace', '0'], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ''


@pytest.mark.card
def test_on_the_card_a_tiny_cell_is_correct(card, tiny_bench):
    res, lines = run_cell(tiny_bench, 'tiny8.tgrid', 6, 2.0, True,
                          device='cuda')
    assert res['correct'], lines
    assert res['device']['kind'] and res['device']['busy_s'] > 0


def test_each_metric_file_declares_what_benchmark_json_says():
    bench = Bench()
    for key in ('end_to_end', 'per_layer'):
        for m in bench.spec[key]:
            mod = bench.metric(m['name'])
            assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
                m['unit'], m['better'], m['source']), m['name']
            assert mod.KIND == key, m['name']
            if key == 'per_layer':
                assert (mod.LAYER, mod.MOVES) == (m['layer'], m['moves'])


@pytest.mark.parametrize('config', ['tiny8', 'tiny32'])
def test_the_setup_probe_sums_the_whole_panel(tiny_bench, config):
    from portbench.setup import probe
    out = probe(tiny_bench, config, 1, 'cpu')
    assert out['fits'] and out['sums_equal'] and out['traits'] == 1
    plan = out['reckoned']
    assert (plan['nb'], plan['n_off'], plan['ld_tile_bytes']) == (
        out['nb'], out['n_off'], out['ld_tile_bytes'])
    assert plan['ref_ld_bytes'] == out['ref_ld_device_bytes']
    assert out['m'] > 0 and out['ref_ld_device_bytes'] > 0
    assert out['nb'] > 0 and out['n_off'] > 0
    assert out['ld_tile_bytes'] == (out['nb'] + out['n_off']) * 256 ** 2 \
        * (1 if config == 'tiny8' else 4)
    assert out['ld_device_bytes'] > out['ld_tile_bytes']
    assert out['host_peak_rss_bytes'] > 0
    assert {'reckon', 'panel', 'traits', 'pack', 'build', 'ref_ld'} <= \
        set(out['steps_s'])


def test_the_setup_probe_stops_where_the_panel_does_not_fit(tiny_bench,
                                                            monkeypatch):
    from portbench import setup
    need = setup.probe(tiny_bench, 'tiny8', 1, 'cpu')['reckoned'][
        'host_need_bytes']
    monkeypatch.setattr(setup, 'host_bytes', lambda: need)
    out = setup.probe(tiny_bench, 'tiny8', 1, 'cpu')
    assert not out['fits'] and out['short_of'] == ['host']
    assert 'pack' not in out['steps_s'] and 'traits' not in out

    def refuse(*a, **k):
        raise AssertionError('packed a panel that does not fit')
    monkeypatch.setattr(setup, 'host_bytes', lambda: 1 << 30)
    monkeypatch.setattr('portbench.run.set_up', refuse)
    plan = setup.probe(tiny_bench, 'eur18m_int8', 1, 'cpu')
    assert not plan['fits'] and plan['m'] == 17_999_523
    assert plan['reckoned']['nb'] == 18_431
    assert plan['reckoned']['n_off'] == 120_361
