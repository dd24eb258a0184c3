"""CPU tests of the benchmark harness (``python -m pytest portbench/tests``).

Tests marked ``card`` need a CUDA device; the ``card`` fixture decides at
run time and skips them here. ``tiny_bench`` builds a benchmark of small
cells (a 6,000-variant panel in tiles of 256, a 3 x 2 grid, a pool of
three traits) in a temporary directory, from copies of the harness's files,
with the real cells' limits (``eta_gap``'s set for this size).
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device('cuda')


#: eta_gap's limit at the tiny size, set as the real cells' are, between
#: the sound fits' largest reading (3.2e-6, traits 0-2 of each tiny cell)
#: and the TF32 control's smallest (1.5e-4); the grids' elbo_gap limit
#: holds at this size too (0.0094 against 2.2 nats)
TINY_ETA_GAP = 2e-5

TINY_CELLS = {
    # cell: (config, traffic, the real cell whose limits it takes)
    'tiny8.tgrid': ('tiny8', 'tgrid', 'hm3_int8.grid100'),
    'tiny8.tmix': ('tiny8', 'tmix', 'hm3_int8.mixgrid20'),
    'tiny32.tgrid': ('tiny32', 'tgrid', 'hm3_f32.grid100'),
}


def make_tiny_bench(dst):
    """A benchmark root at ``dst``: BENCHMARK.json with the tiny cells and a
    copy of the harness's files under ``dst/portbench``."""
    from portbench.run import Bench
    here = os.path.join(dst, 'portbench')
    shutil.copytree(PKG, here, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for name, quantize in (('tiny8', True), ('tiny32', False)):
        with open(os.path.join(here, 'configs', 'hm3_int8.json')) as f:
            cfg = json.load(f)
        cfg.update(name=name, m_target=6000, block_size=256,
                   quantize=quantize)
        with open(os.path.join(here, 'configs', f'{name}.json'), 'w') as f:
            json.dump(cfg, f)
        spec['configs'].append({
            'name': name, 'source': 'a tiny panel for the CPU tests',
            'file': f'portbench/configs/{name}.json',
            'reduced': ['m_target', 'block_size'], 'why': 'CPU tests'})
    for name, src, grid in (
            ('tgrid', 'grid100', {'pi_steps': 3, 'sigma_epsilon_steps': 2,
                                  'h2_est': 0.25, 'h2_se': 0.05}),
            ('tmix', 'mixgrid20', {'pi_steps': 3, 'h2_est': 0.25,
                                   'h2_se': 0.05})):
        with open(os.path.join(here, 'traffic', f'{src}.json')) as f:
            t = json.load(f)
        t.update(grid=grid, pool={'size': 3, 'seed': 1})
        with open(os.path.join(here, 'traffic', f'{name}.json'), 'w') as f:
            json.dump(t, f)
    for cell, (cfg, tr, real) in TINY_CELLS.items():
        spec['workloads'].append({'name': cell, 'config': cfg, 'traffic': tr,
                                  'chips': 1, 'why': 'CPU tests'})
        with open(os.path.join(here, 'checks', f'{real}.json')) as f:
            checks = json.load(f)
        checks['eta_gap']['limit'] = TINY_ETA_GAP
        with open(os.path.join(here, 'checks', f'{cell}.json'), 'w') as f:
            json.dump(checks, f)
    for m in spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] += [c for c, v in TINY_CELLS.items()
                               if v[1] == 'tgrid']
    with open(os.path.join(dst, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    return Bench(root=str(dst), here=here)


@pytest.fixture(scope='session')
def tiny_bench(tmp_path_factory):
    return make_tiny_bench(str(tmp_path_factory.mktemp('bench')))
