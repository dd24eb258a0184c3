"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

The library is compiled at first use, for Hopper (``sm_90a``), one nvcc
per source run in parallel and one link, into
``viprs_tpu_torch/_build/`` (git-ignored), named by a hash of the sources so
an edited kernel is never served from a stale build. The sources expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

P, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: argtypes of every exported launcher: each pointer (and the stream) as
#: c_void_p, so ctypes never truncates a 64-bit address.
SIGNATURES = {
    # diag, diag_nz, beta, n, mask, logits, mu, eta, q (in), logits, mu,
    # eta, q, eta_diff (out), blk_mask, hyper, nb, B, scale, inner_steps,
    # stream
    'cavi_block_sweep_s1_launch': [P] * 16 + [I32, I32, F32, I32, P],
    # off, off_src, off_dst, inc_ptr, inc_tile, blk_mask, off_nz, slabs,
    # eta_diff, q (updated in place), n_slabs, nb, B, scale, stream
    'coupling_pass_s1_launch': [P] * 10 + [I32, I32, I32, F32, P],
    # the same two kernels' instances for float32 LD tiles
    'cavi_block_sweep_s1_f32_launch': [P] * 16 + [I32, I32, F32, I32, P],
    'coupling_pass_s1_f32_launch': [P] * 10 + [I32, I32, I32, F32, P],
    # the S-lane kernels (csrc/cavi_s.cu): diag, diag_nz, then the same
    # pointers, then S, nb, B, scale, inner_steps, lane tile, stream
    'cavi_block_sweep_s_launch': [P] * 16 + [I32, I32, I32, F32, I32, I32,
                                             P],
    # off, off_src, off_dst, inc_ptr, inc_tile, blk_mask, off_nz, slabs,
    # eta_diff, q (updated in place), n_slabs, S, nb, B, scale, lane tile,
    # stream
    'coupling_pass_s_launch': [P] * 10 + [I32, I32, I32, I32, F32, I32, P],
    # the same two kernels' instances for float32 LD tiles
    'cavi_block_sweep_s_f32_launch': [P] * 16 + [I32, I32, I32, F32, I32,
                                                 I32, P],
    'coupling_pass_s_f32_launch': [P] * 10 + [I32, I32, I32, I32, F32, I32,
                                              P],
    # the mixture block sweeps (csrc/cavi_mix.cu): diag, diag_nz, beta, n,
    # mask, gamma, mu, eta, q (in), gamma, mu, eta, q, eta_diff (out),
    # blk_mask, hyper, [S,] K, nb, B, scale, inner_steps, unit_diag, [lane
    # tile,] stream
    'cavi_block_sweep_mix_s1_launch': [P] * 16 + [I32, I32, I32, F32, I32,
                                                  I32, P],
    'cavi_block_sweep_mix_s1_f32_launch': [P] * 16 + [I32, I32, I32, F32,
                                                      I32, I32, P],
    'cavi_block_sweep_mix_s_launch': [P] * 16 + [I32, I32, I32, I32, F32,
                                                 I32, I32, I32, P],
    # its float32-tile instances (csrc/cavi_mix_s_f32.cu)
    'cavi_block_sweep_mix_s_f32_launch': [P] * 16 + [I32, I32, I32, I32,
                                                     F32, I32, I32, I32, P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(('.cu', '.cuh')))


def _nvcc():
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return nvcc


@functools.lru_cache(maxsize=None)
def build():
    """Compile (if needed) and load the kernel library.

    :returns: (ctypes.CDLL, info) where info holds the library path, the
        build seconds (0.0 when a build of the same sources existed), each
        source's nvcc seconds (``source_seconds``; they run side by side)
        and the compiler's ``-Xptxas -v`` report.
    """
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs:
        with open(s, 'rb') as f:
            h.update(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f'libviprs_cuda_{h.hexdigest()[:16]}.so')
    info = {'path': lib_path, 'seconds': 0.0, 'source_seconds': {},
            'ptxas': ''}
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{lib_path}.{os.getpid()}.tmp'
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once (each writing its report to a
        # file, so none blocks on a full pipe), then one link
        jobs = []
        for s in (s for s in srcs if s.endswith('.cu')):
            obj = f'{tmp}.{os.path.basename(s)}.o'
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, s]
            with open(f'{obj}.log', 'w') as log:
                jobs.append((s, obj, cmd, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
        done = {}
        while len(done) < len(jobs):
            for s, _, _, proc in jobs:
                if s not in done and proc.poll() is not None:
                    done[s] = time.perf_counter() - t0
            time.sleep(0.05)
        logs = []
        for s, obj, cmd, proc in jobs:
            with open(f'{obj}.log') as log:
                logs.append(log.read())
            os.remove(f'{obj}.log')
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{logs[-1]}")
        objs = [obj for _, obj, _, _ in jobs]
        cmd = [nvcc, '-shared', *NVCC_FLAGS[:2], '-o', tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info['seconds'] = time.perf_counter() - t0
        info['source_seconds'] = {os.path.basename(s): t
                                  for s, t in done.items()}
        info['ptxas'] = ''.join(logs) + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{info['ptxas']}")
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def _main(argv):
    """``python -m viprs_tpu_torch.ops._build [CSRC]``: build the sources
    in CSRC (default this package's csrc/) into a fresh directory under
    this package's _build/, and print each source's nvcc seconds and the
    registers and spills ptxas reports for each kernel instance."""
    global CSRC, BUILD_DIR
    import tempfile
    if argv:
        CSRC = os.path.abspath(argv[0])
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        BUILD_DIR = d
        _, info = build()
    print(f"{CSRC}: {info['seconds']:.1f} s; by source: " + ', '.join(
        f"{k} {v:.1f} s" for k, v in sorted(info['source_seconds'].items())))
    for line in info['ptxas'].splitlines():
        if 'Compiling entry' in line or 'registers' in line or \
                'spill' in line:
            print(line.strip())


if __name__ == '__main__':
    import sys
    _main(sys.argv[1:])
