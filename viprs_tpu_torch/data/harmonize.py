"""Variant harmonization: allele-aware merging of SNP/effect tables
(counterpart of viprs_tpu.data.harmonize, on numpy tables).

- match variants by SNP id (every match of a left row, in the right table's
  order, as a relational join);
- if the A1/A2 alleles in the right table match the reference table -> keep;
- if they are swapped (A1<->A2) -> flip the sign of every signed statistic;
- strand flips (A<->T, C<->G complements, letter by letter) are resolved the
  same way after complementing; exact matches take precedence over strand
  complements, which matters for palindromic variants (A/T, C/G);
- variants that match neither orientation get NaN signed statistics
  (``how='left'``) or are dropped (``how='inner'``).
"""

import numpy as np

from ..utils.table import Table

_COMPLEMENT = str.maketrans('ATCG', 'TAGC')


def _complement(alleles):
    """The strand complement of each allele string, letter by letter
    (letters other than A, C, G, T are kept)."""
    a = np.asarray(alleles, dtype=str)
    return np.asarray([s.translate(_COMPLEMENT) for s in a.tolist()],
                      dtype=a.dtype if a.size else str)


def is_palindromic(a1, a2):
    return np.asarray(a1, dtype=str) == _complement(a2)


def _join_rows(left_keys, right_keys, how):
    """(left row, right row or -1) pairs of the join on equal keys: for each
    left row in order, its matches in right-table order; a left row without
    one appears once with -1 under ``how='left'``."""
    left_keys = np.asarray(left_keys).astype(str)
    right_keys = np.asarray(right_keys).astype(str)
    first = dict(zip(right_keys.tolist(), range(len(right_keys))))
    if len(first) == len(right_keys):          # unique right keys
        r = np.fromiter((first.get(k, -1) for k in left_keys.tolist()),
                        np.int64, len(left_keys))
        l_idx = np.arange(len(left_keys))
        hit = r >= 0
        return (l_idx, r) if how == 'left' else (l_idx[hit], r[hit])
    order = np.argsort(right_keys, kind='stable')
    srt = right_keys[order]
    lo = np.searchsorted(srt, left_keys, 'left')
    hi = np.searchsorted(srt, left_keys, 'right')
    cnt = hi - lo
    reps = np.maximum(cnt, 1) if how == 'left' else cnt
    l_idx = np.repeat(np.arange(len(left_keys)), reps)
    start = np.repeat(lo, reps)
    within = np.arange(len(l_idx)) - np.repeat(np.cumsum(reps) - reps, reps)
    r = order[np.minimum(start + within, len(order) - 1)] if len(order) \
        else np.zeros(len(l_idx), np.int64)
    r = np.where(np.repeat(cnt, reps) > 0, r, -1)
    return l_idx, r


def _take_fill(col, rows):
    """col[rows] with rows of -1 filled (NaN for numbers, '' for str)."""
    miss = rows < 0
    if not miss.any():
        return col[rows]
    if col.dtype.kind in 'fiub':
        out = col.astype(np.float64)[np.where(miss, 0, rows)]
        out[miss] = np.nan
        return out
    out = col[np.where(miss, 0, rows)] if len(col) else \
        np.full(len(rows), '', dtype=col.dtype)
    out[miss] = ''
    return out


def merge_snp_tables(ref_table: Table, other_table: Table, how: str = 'inner',
                     on: str = 'SNP', signed_statistics=('BETA',)) -> Table:
    """Merge ``other_table`` onto ``ref_table``, flipping the sign of
    ``signed_statistics`` where the effect allele orientation is reversed.

    :param ref_table: Table with at least [on, 'A1', 'A2'].
    :param other_table: Table with [on, 'A1', 'A2'] + statistics columns.
    :returns: the merged Table in ref_table's variant order: ref_table's
        columns, then other_table's (its CHR/POS dropped where ref_table
        has them; a name in both gets the suffixes _x and _y), with
        harmonized signed statistics and ref_table's A1/A2.
    """
    if how not in ('inner', 'left'):
        raise ValueError(f"how must be 'inner' or 'left'; got {how!r}")
    for name, t in (('reference', ref_table), ('other', other_table)):
        missing = [col for col in (on, 'A1', 'A2') if col not in t]
        if missing:
            raise ValueError(f"{name} table missing columns {missing}")

    right = other_table.rename({'A1': '_A1_r', 'A2': '_A2_r'})
    right = right.drop([c for c in ('CHR', 'POS')
                        if c in right and c in ref_table])
    l_idx, r_idx = _join_rows(ref_table[on], right[on], how)
    both = {k for k in right.columns if k != on and k in ref_table}
    cols = {}
    for k, v in ref_table.items():
        cols[k + '_x' if k in both else k] = v[l_idx]
    for k, v in right.items():
        if k != on:
            cols[k + '_y' if k in both else k] = _take_fill(v, r_idx)
    present = r_idx >= 0

    a1, a2 = (np.asarray(cols[k]).astype(str) for k in ('A1', 'A2'))
    r1, r2 = (np.asarray(cols[k]).astype(str) for k in ('_A1_r', '_A2_r'))
    c1, c2 = _complement(r1), _complement(r2)

    # Precedence matters for palindromic (A/T, C/G) variants, where exact-swap
    # and complement-same coincide: exact matches win over strand-complement
    # interpretations.
    same_exact = (a1 == r1) & (a2 == r2)
    flip_exact = (a1 == r2) & (a2 == r1) & ~same_exact
    same_comp = (a1 == c1) & (a2 == c2) & ~same_exact & ~flip_exact
    flip_comp = (a1 == c2) & (a2 == c1) & ~same_exact & ~flip_exact & ~same_comp
    flipped = flip_exact | flip_comp
    unmatched = ~(same_exact | same_comp | flipped) & present

    sign = np.where(flipped, -1.0, 1.0)
    for col in signed_statistics:
        if col in cols:
            v = cols[col] * sign
            if unmatched.any():
                v = v.astype(np.float64)
                v[unmatched] = np.nan
            cols[col] = v

    merged = Table(cols).drop(['_A1_r', '_A2_r'])
    if how == 'inner' and unmatched.any():
        merged = merged.take(~unmatched)
    return merged
