"""On-disk cache of the port's packed LD.

Reading an LD store (Zarr decompression, the banded-to-block cut, the
harmonization slices) and packing it take tens of seconds at genome scale,
more than the fit they feed. The packed result is a function of (the store
files, the kept variants in store order, the block size, int8 or float32),
so a repeated ``viprs_fit`` on the same panel can skip all of it: the tiles
come back from ``.npy`` files (memory-mapped) and go straight to the device.

Layout: ``<root>/<key>/`` with the :class:`~viprs_tpu_torch.ops.block_ld.
PackedLD` arrays (``diag.npy``, ``off_data.npy``, ``off_src.npy``,
``off_dst.npy``, ``mask.npy``), the layout's ``flat_index.npy`` and
``layout.json``. The root is ``~/.cache/viprs_tpu_torch/pack``, or
``VIPRS_TPU_TORCH_PACK_CACHE`` (``0``/``off``/``false``/``none`` or empty
disable the cache). It is the port's own: it never reads the JAX package's
cache, whose entries hold that package's tile layout.

The key hashes file signatures (path, size, mtime), not contents, as the
JAX package's does: a touched but identical store packs again; a store
edited in place with its mtime preserved would hit a stale entry.
"""

import hashlib
import json
import logging
import os
import os.path as osp
import shutil

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
ENV = 'VIPRS_TPU_TORCH_PACK_CACHE'
_ARRAYS = ('diag', 'off_data', 'off_src', 'off_dst', 'mask')


def cache_root():
    """Cache directory, or None when caching is disabled."""
    env = os.environ.get(ENV)
    if env is not None:
        if env.strip().lower() in ('0', 'off', 'false', 'none', ''):
            return None
        return env
    return osp.join(osp.expanduser('~'), '.cache', 'viprs_tpu_torch', 'pack')


def file_signature(path):
    """(relname, size, mtime_ns) triples for a file or directory tree."""
    sigs = []
    if osp.isdir(path):
        for dirpath, _, files in sorted(os.walk(path)):
            for f in sorted(files):
                fp = osp.join(dirpath, f)
                st = os.stat(fp)
                sigs.append((osp.relpath(fp, path), st.st_size,
                             st.st_mtime_ns))
    else:
        st = os.stat(path)
        sigs.append((osp.basename(path), st.st_size, st.st_mtime_ns))
    return sigs


def compute_key(store_paths, kept_snps, block_size, quantize):
    """Cache key of a packed LD.

    :param store_paths: LD store files/directories feeding the pack.
    :param kept_snps: {chrom: array of SNP ids}, the harmonized and
        filtered variants in store order (the tiles depend on exactly this
        subset and order).
    """
    h = hashlib.sha256()
    h.update(f'torch-v{_FORMAT_VERSION};B={block_size};'
             f'q={bool(quantize)}'.encode())
    for p in sorted(str(s) for s in store_paths):
        h.update(p.encode())
        for sig in file_signature(p):
            h.update(repr(sig).encode())
    for c in sorted(kept_snps, key=str):
        h.update(f'chr={c};'.encode())
        arr = np.asarray(kept_snps[c]).astype(str)
        h.update(str(len(arr)).encode())
        h.update('\x00'.join(arr.tolist()).encode())
    return h.hexdigest()


def save_packed(key, packed, layout, root=None):
    """Write a (PackedLD, BlockLayout) under the key; returns its directory
    (None when caching is disabled or the write failed: the cache only
    saves time)."""
    root = root if root is not None else cache_root()
    if root is None:
        return None
    d = osp.join(root, key)
    tmp = d + f'.tmp{os.getpid()}'
    try:
        os.makedirs(tmp, exist_ok=True)
        for name in _ARRAYS:
            np.save(osp.join(tmp, f'{name}.npy'), getattr(packed, name))
        np.save(osp.join(tmp, 'flat_index.npy'), layout.flat_index)
        meta = {
            'scale': float(packed.scale),
            'chromosomes': [[('i' if isinstance(c, (int, np.integer))
                              else 's'), str(c)]
                            for c in layout.chromosomes],
            'chrom_sizes': [int(s) for s in layout.chrom_sizes],
            'chrom_block_range': [[int(a), int(b)]
                                  for a, b in layout.chrom_block_range],
            'block_size': int(layout.block_size),
            'nb': int(layout.nb),
        }
        with open(osp.join(tmp, 'layout.json'), 'w') as f:
            json.dump(meta, f)
        if osp.exists(d):               # another process published it first
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, d)          # atomic publish
        return d
    except OSError as e:
        logger.warning("pack cache write failed: %s", e)
        shutil.rmtree(tmp, ignore_errors=True)
        return None


def load_packed(key, root=None):
    """The (PackedLD, BlockLayout) stored under the key (the tiles memory-
    mapped), or None on a miss."""
    from ..ops.block_ld import BlockLayout, PackedLD

    root = root if root is not None else cache_root()
    if root is None:
        return None
    d = osp.join(root, key)
    if not osp.exists(osp.join(d, 'layout.json')):
        return None
    try:
        with open(osp.join(d, 'layout.json')) as f:
            meta = json.load(f)
        arrays = {name: np.load(osp.join(d, f'{name}.npy'), mmap_mode='r')
                  for name in _ARRAYS}
        packed = PackedLD(scale=meta['scale'], **arrays)
        layout = BlockLayout(
            chromosomes=[int(v) if k == 'i' else v
                         for k, v in meta['chromosomes']],
            chrom_sizes=meta['chrom_sizes'],
            chrom_block_range=[tuple(t) for t in meta['chrom_block_range']],
            flat_index=np.load(osp.join(d, 'flat_index.npy')),
            block_size=meta['block_size'],
            nb=meta['nb'])
        return packed, layout
    except (OSError, KeyError, ValueError) as e:
        logger.warning("pack cache read failed for %s: %s", d, e)
        return None
