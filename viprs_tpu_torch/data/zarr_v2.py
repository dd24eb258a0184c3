"""Minimal dependency-free Zarr v2 reader/writer (a copy of
viprs_tpu.data.zarr_v2: numpy, zlib and the system libblosc by ctypes;
the copy binds libblosc under a lock, see ``_load_blosc``).

The published UKB LD panels consumed by the reference ecosystem are magenpy
LDMatrix objects stored as Zarr v2 groups (reference use-site:
viprs/model/VIPRS.py:147-207; download docs: docs/download_ld.md). Zarr v2 on
disk is just directories of JSON metadata (``.zgroup`` / ``.zarray`` /
``.zattrs``) plus per-chunk compressed binary files — no reason to require the
``zarr`` package (absent in this environment) to ingest them.

Supported surface (everything magenpy-produced stores need):

- compressors: ``null`` (raw), ``blosc`` (any internal codec — decoded by the
  system ``libblosc`` via ctypes), ``zlib``, ``gzip``, ``zstd``, ``bz2``,
  ``lzma``;
- dtypes: all fixed-width numeric types, fixed-width bytes/unicode, and
  object-dtype string arrays via the numcodecs ``vlen-utf8`` / ``vlen-bytes``
  filter encoding;
- C and F order, ``.`` and ``/`` dimension separators, missing chunks filled
  with ``fill_value``, edge-chunk cropping;
- stores: plain directories and **zip archives** (the layout of the published
  chromosome-level UKB LD zips, reference docs/download_ld.md:20-55 — a Zarr
  group either at the archive root or under one top-level directory).

The writer exists so tests can build byte-real fixtures with the exact default
zarr compressor (blosc/lz4/shuffle) and so native stores can be exported back
into the magenpy ecosystem.
"""

import ctypes
import ctypes.util
import json
import os
import os.path as osp
import struct
import threading
import zlib

import numpy as np

__all__ = ['open_group', 'read_array', 'write_array', 'write_group_attrs',
           'ZarrGroup', 'ZarrArray', 'blosc_available']


# --------------------------------------------------------------------- blosc
_BLOSC = None
_BLOSC_TRIED = False
_BLOSC_LOCK = threading.Lock()


def _load_blosc():
    """Bind the system libblosc (1.x) via ctypes. Returns None if absent.

    The chunk readers run in threads: the first call binds under a lock,
    so no thread sees "tried" before the library is bound (the JAX
    package's copy sets the flag first, and a store whose first read is
    threaded can fail there as if libblosc were absent)."""
    global _BLOSC, _BLOSC_TRIED
    with _BLOSC_LOCK:
        if not _BLOSC_TRIED:
            _BLOSC = _bind_blosc()
            _BLOSC_TRIED = True
    return _BLOSC


def _bind_blosc():
    candidates = []
    found = ctypes.util.find_library('blosc')
    if found:
        candidates.append(found)
    candidates += ['libblosc.so.1', 'libblosc.so', 'libblosc.dylib']
    for name in candidates:
        try:
            lib = ctypes.CDLL(name)
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
            lib.blosc_cbuffer_sizes.restype = None
            lib.blosc_cbuffer_sizes.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
            return lib
        except OSError:
            continue
    return None


def blosc_available() -> bool:
    return _load_blosc() is not None


def _blosc_decompress(buf: bytes) -> bytes:
    lib = _load_blosc()
    if lib is None:
        raise RuntimeError(
            "This Zarr chunk is blosc-compressed but no libblosc shared "
            "library was found on the system. Install libblosc (or the "
            "python `blosc` package) to read this store.")
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    src = ctypes.create_string_buffer(buf, len(buf))
    lib.blosc_cbuffer_sizes(src, ctypes.byref(nbytes), ctypes.byref(cbytes),
                            ctypes.byref(blocksize))
    out = ctypes.create_string_buffer(nbytes.value)
    n_threads = max(1, (os.cpu_count() or 2) // 2)
    rc = lib.blosc_decompress_ctx(src, out, nbytes.value, n_threads)
    if rc < 0 or rc != nbytes.value:
        raise ValueError(f"blosc decompression failed (rc={rc}, "
                         f"expected {nbytes.value} bytes)")
    return out.raw


def _blosc_compress(data: bytes, typesize: int, cname: str = 'lz4',
                    clevel: int = 5, shuffle: int = 1) -> bytes:
    lib = _load_blosc()
    if lib is None:
        raise RuntimeError("libblosc not available for compression.")
    src = ctypes.create_string_buffer(data, len(data))
    destsize = len(data) + 16 + 64
    out = ctypes.create_string_buffer(destsize)
    rc = lib.blosc_compress_ctx(clevel, shuffle, max(typesize, 1), len(data),
                                src, out, destsize, cname.encode(), 0, 1)
    if rc <= 0:
        raise ValueError(f"blosc compression failed (rc={rc})")
    return out.raw[:rc]


# ------------------------------------------------------------------- codecs
def _decompress(buf: bytes, compressor) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get('id')
    if cid == 'blosc':
        return _blosc_decompress(buf)
    if cid == 'zlib':
        return zlib.decompress(buf)
    if cid == 'gzip':
        import gzip as _gz
        return _gz.decompress(buf)
    if cid == 'zstd':
        import zstandard
        return zstandard.ZstdDecompressor().decompress(buf)
    if cid == 'bz2':
        import bz2
        return bz2.decompress(buf)
    if cid == 'lzma':
        import lzma
        return lzma.decompress(buf)
    raise ValueError(f"Unsupported Zarr compressor: {cid!r}")


def _compress(data: bytes, compressor, typesize: int) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get('id')
    if cid == 'blosc':
        return _blosc_compress(data, typesize,
                               cname=compressor.get('cname', 'lz4'),
                               clevel=int(compressor.get('clevel', 5)),
                               shuffle=int(compressor.get('shuffle', 1)))
    if cid == 'zlib':
        return zlib.compress(data, int(compressor.get('level', 1)))
    if cid == 'zstd':
        import zstandard
        return zstandard.ZstdCompressor(
            level=int(compressor.get('level', 3))).compress(data)
    raise ValueError(f"Unsupported Zarr compressor for writing: {cid!r}")


# ------------------------------------------------------------------ filters
def _vlen_decode(buf: bytes, utf8: bool) -> np.ndarray:
    """numcodecs VLenUTF8/VLenBytes layout: uint32 item count, then per item a
    uint32 byte length + payload."""
    (n_items,) = struct.unpack_from('<I', buf, 0)
    out = np.empty(n_items, dtype=object)
    pos = 4
    for i in range(n_items):
        (ln,) = struct.unpack_from('<I', buf, pos)
        pos += 4
        payload = buf[pos:pos + ln]
        pos += ln
        out[i] = payload.decode('utf-8') if utf8 else payload
    return out


def _vlen_encode(items, utf8: bool) -> bytes:
    parts = [struct.pack('<I', len(items))]
    for it in items:
        payload = it.encode('utf-8') if utf8 else bytes(it)
        parts.append(struct.pack('<I', len(payload)))
        parts.append(payload)
    return b''.join(parts)


# ------------------------------------------------------------------- stores
class _FSStore:
    """Key/value view of a plain directory (keys use ``/`` separators)."""

    def __init__(self, root):
        self.root = root

    def _fp(self, key):
        return osp.join(self.root, *key.split('/')) if key else self.root

    def exists(self, key):
        return osp.exists(self._fp(key))

    def read(self, key):
        fp = self._fp(key)
        if not osp.exists(fp):
            return None
        with open(fp, 'rb') as f:
            return f.read()

    def children(self, prefix):
        d = self._fp(prefix)
        return sorted(os.listdir(d)) if osp.isdir(d) else []

    def describe(self, key):
        return self._fp(key)


class _ZipStore:
    """Key/value view of a Zarr group inside a zip archive (read-only).

    The published UKB LD panels ship as chromosome-level zips of the
    per-chromosome Zarr group (reference docs/download_ld.md). The group may
    sit at the archive root or under a single top-level directory — detected
    from the shallowest ``.zgroup``/``.zattrs``/``.zarray`` entry.
    ``zipfile.ZipFile`` read handles are not thread-safe, so each reader
    thread gets its own handle (the chunk reader fans out across threads).
    """

    def __init__(self, zip_path, prefix=None):
        import zipfile
        self.zip_path = zip_path
        self._local = threading.local()
        names = self._zf().namelist()
        self._names = set(names)
        if prefix is None:
            markers = [n for n in names
                       if n.rsplit('/', 1)[-1] in ('.zgroup', '.zattrs',
                                                   '.zarray')]
            if not markers:
                raise ValueError(f"{zip_path}: no Zarr v2 metadata "
                                 f"(.zgroup/.zattrs/.zarray) in the archive")
            shallowest = min(markers, key=lambda n: n.count('/'))
            prefix = shallowest.rsplit('/', 1)[0] if '/' in shallowest else ''
        self.prefix = prefix
        # directory index: parent key -> child names
        self._dirs = {}
        plen = len(prefix) + 1 if prefix else 0
        for n in names:
            rel = n[plen:] if prefix and n.startswith(prefix + '/') else \
                (n if not prefix else None)
            if not rel:
                continue
            parts = rel.rstrip('/').split('/')
            for i in range(len(parts)):
                self._dirs.setdefault('/'.join(parts[:i]), set()).add(parts[i])

    def _zf(self):
        import zipfile
        zf = getattr(self._local, 'zf', None)
        if zf is None:
            zf = zipfile.ZipFile(self.zip_path, 'r')
            self._local.zf = zf
        return zf

    def _full(self, key):
        return f"{self.prefix}/{key}" if self.prefix else key

    def exists(self, key):
        full = self._full(key)
        return full in self._names or full + '/' in self._names \
            or key in self._dirs

    def read(self, key):
        full = self._full(key)
        if full not in self._names:
            return None
        return self._zf().read(full)

    def children(self, prefix):
        return sorted(self._dirs.get(prefix, ()))

    def describe(self, key):
        return f"{self.zip_path}!{self._full(key)}"


def _as_store(path_or_store):
    if isinstance(path_or_store, (_FSStore, _ZipStore)):
        return path_or_store
    p = str(path_or_store)
    if osp.isfile(p) and p.endswith('.zip'):
        return _ZipStore(p)
    return _FSStore(p)


def _join(key, name):
    return f"{key}/{name}" if key else str(name)


# ------------------------------------------------------------------- arrays
class ZarrArray:
    """Read-only view of one Zarr v2 array (directory or zip member)."""

    def __init__(self, path, key=None):
        if key is None:
            self.store, self.key = _as_store(path), ''
        else:
            self.store, self.key = path, key
        self.path = self.store.describe(self.key)
        raw = self.store.read(_join(self.key, '.zarray'))
        if raw is None:
            raise FileNotFoundError(f"{self.path}: no .zarray metadata")
        meta = json.loads(raw)
        if meta.get('zarr_format') != 2:
            raise ValueError(f"{path}: not a Zarr v2 array "
                             f"(zarr_format={meta.get('zarr_format')!r})")
        self.meta = meta
        self.shape = tuple(meta['shape'])
        self.chunks = tuple(meta['chunks'])
        self.order = meta.get('order', 'C')
        self.fill_value = meta.get('fill_value')
        self.compressor = meta.get('compressor')
        self.filters = meta.get('filters') or []
        self.sep = meta.get('dimension_separator', '.')
        dt = meta['dtype']
        if isinstance(dt, list):
            raise ValueError(f"{path}: structured dtypes are not supported")
        self._vlen = None
        for flt in self.filters:
            fid = flt.get('id')
            if fid in ('vlen-utf8', 'vlen-bytes'):
                self._vlen = fid
            else:
                raise ValueError(f"{path}: unsupported Zarr filter {fid!r}")
        self.dtype = np.dtype(object) if dt == '|O' else np.dtype(dt)
        self.attrs = {}
        zattrs = self.store.read(_join(self.key, '.zattrs'))
        if zattrs is not None:
            self.attrs = json.loads(zattrs)

    @property
    def ndim(self):
        return len(self.shape)

    def _chunk_grid(self):
        return [max(1, -(-s // c)) for s, c in zip(self.shape, self.chunks)] \
            or [1]

    def _read_chunk(self, idx):
        ck = self.sep.join(str(i) for i in idx) if idx else '0'
        raw = self.store.read(_join(self.key, ck))
        if raw is None:
            return None
        return _decompress(raw, self.compressor)

    def __getitem__(self, key):
        if key is not Ellipsis and key != slice(None):
            return self[...][key]
        return self._read_all()

    def _read_all(self) -> np.ndarray:
        if self.ndim == 0:
            buf = self._read_chunk(())
            if buf is None:
                return np.asarray(self.fill_value, dtype=self.dtype)
            return np.frombuffer(buf, dtype=self.dtype, count=1)[0]

        grid = self._chunk_grid()
        if self._vlen is not None:
            # variable-length chunks concatenate along the (single) axis:
            if self.ndim != 1:
                raise ValueError("vlen arrays must be 1-D")
            parts = []
            for gi in range(grid[0]):
                buf = self._read_chunk((gi,))
                n_here = min(self.chunks[0], self.shape[0] - gi * self.chunks[0])
                if buf is None:
                    part = np.full(n_here, self.fill_value, dtype=object)
                else:
                    part = _vlen_decode(buf, utf8=(self._vlen == 'vlen-utf8'))[:n_here]
                parts.append(part)
            return np.concatenate(parts) if parts else np.empty(0, object)

        out = np.empty(self.shape, dtype=self.dtype)
        if self.fill_value is not None:
            out[...] = self.fill_value
        import itertools

        def _fill(idx):
            buf = self._read_chunk(idx)
            if buf is None:
                return
            chunk = np.frombuffer(buf, dtype=self.dtype)
            chunk = chunk.reshape(self.chunks, order=self.order)
            sel = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(idx, self.chunks, self.shape))
            crop = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[crop]

        indices = list(itertools.product(*(range(g) for g in grid)))
        if len(indices) > 4:
            # IO + decompression release the GIL; thread across chunks
            # (matters at the 18M-variant scale of the published stores):
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(8, len(indices))) as pool:
                list(pool.map(_fill, indices))
        else:
            for idx in indices:
                _fill(idx)
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self._read_all()
        return arr.astype(dtype) if dtype is not None else arr


class ZarrGroup:
    """Read-only view of a Zarr v2 group (``'a/b'`` path access) backed by a
    directory or a zip archive."""

    def __init__(self, path, key=None):
        if key is None:
            self.store, self.key = _as_store(path), ''
        else:
            self.store, self.key = path, key
        self.path = self.store.describe(self.key)
        self.attrs = {}
        zattrs = self.store.read(_join(self.key, '.zattrs'))
        if zattrs is not None:
            self.attrs = json.loads(zattrs)

    def _child(self, name):
        return _join(self.key, '/'.join(str(name).split('/')))

    def __contains__(self, name):
        k = self._child(name)
        return self.store.exists(_join(k, '.zarray')) \
            or self.store.exists(_join(k, '.zgroup'))

    def __getitem__(self, name):
        k = self._child(name)
        if self.store.exists(_join(k, '.zarray')):
            return ZarrArray(self.store, k)
        if self.store.exists(_join(k, '.zgroup')):
            return ZarrGroup(self.store, k)
        raise KeyError(f"No Zarr array/group named {name!r} under {self.path}")

    def array_keys(self):
        return [n for n in self.store.children(self.key)
                if self.store.exists(_join(_join(self.key, n), '.zarray'))]

    def group_keys(self):
        return [n for n in self.store.children(self.key)
                if self.store.exists(_join(_join(self.key, n), '.zgroup'))]


def open_group(path) -> ZarrGroup:
    p = str(path)
    if osp.isfile(p) and p.endswith('.zip'):
        return ZarrGroup(_ZipStore(p), '')
    if not osp.isdir(p):
        raise FileNotFoundError(f"Zarr store not found: {path}")
    if not (osp.exists(osp.join(p, '.zgroup'))
            or osp.exists(osp.join(p, '.zattrs'))
            or osp.exists(osp.join(p, '.zarray'))):
        raise ValueError(f"{path} does not look like a Zarr v2 store "
                         f"(no .zgroup/.zattrs/.zarray)")
    return ZarrGroup(path)


def read_array(path) -> np.ndarray:
    return ZarrArray(path)[...]


# ------------------------------------------------------------------- writer
DEFAULT_COMPRESSOR = {'id': 'blosc', 'cname': 'lz4', 'clevel': 5, 'shuffle': 1,
                      'blocksize': 0}


def _ensure_group(path):
    os.makedirs(path, exist_ok=True)
    zg = osp.join(path, '.zgroup')
    if not osp.exists(zg):
        with open(zg, 'w') as f:
            json.dump({'zarr_format': 2}, f)


def write_group_attrs(path, attrs: dict):
    _ensure_group(path)
    with open(osp.join(path, '.zattrs'), 'w') as f:
        json.dump(attrs, f)


def write_array(store_path, name, data, chunks=None, compressor='default',
                order='C'):
    """Write a numpy array as a Zarr v2 array under ``store_path/name``.

    Parent groups get ``.zgroup`` files. Object-dtype 1-D string arrays are
    written with the numcodecs ``vlen-utf8`` filter encoding.
    """
    if compressor == 'default':
        compressor = dict(DEFAULT_COMPRESSOR)
        if not blosc_available():
            compressor = {'id': 'zlib', 'level': 1}
    data = np.asarray(data)

    parts = str(name).split('/')
    cur = store_path
    _ensure_group(cur)
    for p in parts[:-1]:
        cur = osp.join(cur, p)
        _ensure_group(cur)
    apath = osp.join(cur, parts[-1])
    os.makedirs(apath, exist_ok=True)

    filters = None
    if data.dtype == object:
        if data.ndim != 1:
            raise ValueError("vlen arrays must be 1-D")
        filters = [{'id': 'vlen-utf8'}]
        dtype_str = '|O'
        itemsize = 1
    else:
        dtype_str = data.dtype.str
        itemsize = data.dtype.itemsize

    if chunks is None:
        chunks = data.shape if data.ndim else ()
    chunks = tuple(int(c) for c in chunks)

    meta = {'zarr_format': 2, 'shape': list(data.shape),
            'chunks': list(chunks) or [1], 'dtype': dtype_str,
            'compressor': compressor, 'fill_value': None, 'order': order,
            'filters': filters}
    with open(osp.join(apath, '.zarray'), 'w') as f:
        json.dump(meta, f)

    import itertools
    grid = [max(1, -(-s // c)) for s, c in zip(data.shape, chunks)] or [1]
    for idx in itertools.product(*(range(g) for g in grid)):
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, data.shape))
        piece = data[sel]
        if data.dtype == object:
            payload = _vlen_encode(list(piece), utf8=True)
        else:
            # edge chunks are stored full-size (zarr pads with fill/garbage):
            if piece.shape != chunks:
                full = np.zeros(chunks, dtype=data.dtype)
                full[tuple(slice(0, s) for s in piece.shape)] = piece
                piece = full
            payload = np.ascontiguousarray(
                piece if order == 'C' else piece.T).tobytes()
        key = '.'.join(str(i) for i in idx) if data.ndim else '0'
        with open(osp.join(apath, key), 'wb') as f:
            f.write(_compress(payload, compressor, itemsize))
    return apath
