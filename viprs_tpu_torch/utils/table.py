"""A column table on numpy: the port's tables, from reading a summary
statistics file to writing ``<prefix>.fit.gz``, without pandas.

A :class:`Table` is an ordered mapping of column name to a 1-D numpy array,
every column of the same length. Strings are numpy unicode arrays (never
bytes, never object arrays), integers int64, reals float64 (or the float32
of a model's posterior). Delimited text is read by :func:`read_table` and
written by :meth:`Table.write`; a ``.gz``, ``.bz2`` or ``.xz`` suffix means
compressed. ``to_pandas`` converts for users who have pandas; nothing in
the package calls it.
"""

import bz2
import contextlib
import csv
import gzip
import io
import lzma

import numpy as np

#: Fields read as NaN in a float column (pandas' default ``na_values``).
NA_VALUES = frozenset({
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'})


def _column(values, n=None):
    """A 1-D numpy column from a scalar (broadcast to ``n`` rows), a list
    or an array; strings become a unicode array."""
    if np.ndim(values) == 0:
        if n is None:
            raise ValueError("a scalar column needs another column to give "
                             "the table its length")
        v = np.asarray(values)
        if v.dtype.kind in 'OSU':
            return np.full(n, str(values))
        return np.full(n, values, dtype=v.dtype)
    arr = np.asarray(values)
    if arr.ndim != 1:
        raise ValueError(f"a column must be 1-D, got shape {arr.shape}")
    if arr.dtype.kind in 'OS':
        arr = arr.astype(str)
    return arr


class Table:
    """An ordered mapping of column name to equal-length numpy arrays."""

    def __init__(self, columns=None):
        cols = dict(columns or {})
        n = None
        for v in cols.values():
            if np.ndim(v) != 0:
                n = len(v)
                break
        self._cols = {}
        for k, v in cols.items():
            self._cols[str(k)] = _column(v, n)
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths: {sorted(lengths)}")

    # ---------------------------------------------------------------- access
    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name):
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        return self.select(key)

    def __setitem__(self, name, values):
        col = _column(values, len(self) if self._cols else None)
        if self._cols and len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = col

    def items(self):
        return self._cols.items()

    def __repr__(self):
        return f"Table({len(self)} rows: {', '.join(self._cols)})"

    # ------------------------------------------------------------ operations
    def copy(self):
        return Table({k: v.copy() for k, v in self._cols.items()})

    def select(self, names):
        """A table of the named columns, in that order (missing names
        raise)."""
        return Table({k: self._cols[k] for k in names})

    def rename(self, mapping):
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    def drop(self, names):
        names = set(names)
        return Table({k: v for k, v in self._cols.items() if k not in names})

    def insert(self, pos, name, values):
        """Insert a column at position ``pos`` (in place)."""
        items = list(self._cols.items())
        items.insert(pos, (name, _column(values, len(self))))
        self._cols = dict(items)

    def take(self, rows):
        """The rows given by an index array or a boolean mask, in that
        order."""
        rows = np.asarray(rows)
        if rows.dtype != bool:
            rows = rows.astype(np.int64, copy=False)
        return Table({k: v[rows] for k, v in self._cols.items()})

    def group_rows(self, name):
        """{value: row indices} of a column, keys sorted, rows in table
        order."""
        keys, inv = np.unique(self._cols[name], return_inverse=True)
        return {k.item(): np.nonzero(inv == i)[0] for i, k in enumerate(keys)}

    @staticmethod
    def concat(tables):
        """Stack tables row-wise. Columns are the union in order of first
        appearance; a column a table lacks is NaN (numbers) or '' there."""
        tables = list(tables)
        names = []
        for t in tables:
            names.extend(k for k in t.columns if k not in names)
        out = {}
        for k in names:
            parts = [t._cols.get(k) for t in tables]
            kinds = {p.dtype.kind for p in parts if p is not None}
            fill = '' if kinds & {'U'} else np.nan
            out[k] = np.concatenate([
                p if p is not None else np.full(len(t), fill)
                for p, t in zip(parts, tables)]) if parts else np.zeros(0)
        return Table(out)

    def to_pandas(self):
        """The same table as a pandas DataFrame (imports pandas)."""
        import pandas as pd
        return pd.DataFrame({k: v for k, v in self._cols.items()})

    # --------------------------------------------------------------- writing
    def write(self, path, sep='\t'):
        """Write delimited text with a header line (compressed by the
        suffix). Every float64 is written as its shortest repr, which
        reads back to the same float64; float32 as the shortest repr of the
        float32; NaN as an empty field. gzip output carries no time stamp,
        so equal tables give equal files."""
        cols = [_format(v, sep) for v in self._cols.values()]
        header = sep.join(_quote(k, sep) for k in self._cols)
        body = '\n'.join(map(sep.join, zip(*cols)))
        text = header + '\n' + (body + '\n' if len(self) else '')
        with _open(path, 'wb') as f:
            f.write(text.encode())


def _quote(s, sep):
    if sep in s or '"' in s or '\n' in s:
        return '"' + s.replace('"', '""') + '"'
    return s


def _format(col, sep):
    kind = col.dtype.kind
    if kind == 'f':
        out = col.astype(str)
        nan = np.isnan(col)
        if nan.any():
            out[nan] = ''
        return out.tolist()
    if kind in 'iub':
        return col.astype(str).tolist()
    return [_quote(s, sep) for s in col.astype(str).tolist()]


@contextlib.contextmanager
def _open(path, mode):
    """A binary file, compressed by the suffix; gzip output carries no name
    and no time stamp."""
    path = str(path)
    if path.endswith('.gz'):
        with open(path, mode) as raw, gzip.GzipFile(
                filename='', mode=mode, fileobj=raw, compresslevel=1,
                mtime=0) as f:
            yield f
        return
    opener = {'.bz2': bz2.open, '.xz': lzma.open}.get(
        path[path.rfind('.'):], open)
    with opener(path, mode) as f:
        yield f


# ------------------------------------------------------------------ reading
def _infer(values):
    """A typed column from strings: int64 where every field is an integer,
    else float64 where every field is a number or NA (NaN), else str."""
    arr = np.asarray(values, dtype=str)
    try:
        return arr.astype(np.int64)
    except (ValueError, OverflowError):
        pass
    try:
        return arr.astype(np.float64)
    except ValueError:
        pass
    na = np.fromiter((v in NA_VALUES for v in values), bool, len(arr))
    if na.any():
        filled = arr.copy()
        filled[na] = 'nan'
        try:
            return filled.astype(np.float64)
        except ValueError:
            pass
    return arr


def read_table(path, sep=None, header=True):
    """Read delimited text into a :class:`Table` (compressed by suffix).

    :param sep: None (default) splits on runs of whitespace, as the JAX
        package's ``sep=r'\\s+'``; otherwise the literal separator (tab,
        comma, ...), with fields quoted as the ``csv`` module quotes them.
    :param header: whether the first line names the columns; without one
        (plink's .bim and .fam, phenotype and covariate files) the columns
        are named '0', '1', ... as pandas' ``header=None`` numbers them.
    """
    with _open(path, 'rb') as f:
        text = f.read().decode()
    whitespace = sep in (None, r'\s+')
    if not whitespace and '"' in text:
        return _table_from_rows(
            path, [r for r in csv.reader(io.StringIO(text), delimiter=sep)
                   if r], header)
    lines = text.splitlines()
    if whitespace:
        widths = [len(line.split()) for line in lines]
    else:
        widths = [line.count(sep) + 1 if line else 0 for line in lines]
    rows = [w for w in widths if w]
    if not rows:
        raise ValueError(f"{path} is empty")
    if min(rows) != max(rows):
        # a ragged file: split it line by line to name the bad line
        return _table_from_rows(
            path, [line.split() if whitespace else line.split(sep)
                   for line, w in zip(lines, widths) if w], header)
    # every line has the same number of fields: split the text once
    if whitespace:
        tokens = text.split()
    else:
        tokens = sep.join(line for line in lines if line).split(sep)
    k = rows[0]
    cols = [tokens[j::k] for j in range(k)]
    if not header:
        return _typed([str(j) for j in range(k)], cols)
    return _typed([c[0] for c in cols], [c[1:] for c in cols])


def _table_from_rows(path, rows, header=True):
    if not rows:
        raise ValueError(f"{path} is empty")
    if header:
        names, body = list(rows[0]), rows[1:]
    else:
        names, body = [str(j) for j in range(len(rows[0]))], rows
    bad = [i for i, r in enumerate(body) if len(r) != len(names)]
    if bad:
        raise ValueError(f"{path}: line {bad[0] + 2} has "
                         f"{len(body[bad[0]])} fields, the header "
                         f"{len(names)}")
    return _typed(names, list(zip(*body)) if body else [[]] * len(names))


def _typed(names, cols):
    """A Table of inferred columns; a repeated name gets pandas' suffix."""
    seen, out = {}, {}
    for k, v in zip(names, cols):
        if k in seen:
            seen[k] += 1
            k = f'{k}.{seen[k]}'
        else:
            seen[k] = 0
        out[k] = _infer(v) if len(v) else np.zeros(0)
    return Table(out)
