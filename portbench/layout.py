"""The benchmark's own tiling of its panel, and the hyperparameter grids.

``plan_layout`` is a frozen copy of the best-fit-decreasing packing plan
that LD tiles follow (B-wide tiles; an LD block wider than B spans
ceil(m / B) fresh tiles, whose last tile stays open to smaller blocks).
The work counts (``work.py``) count on this tiling of the benchmark's own
panel. ``grid_rows`` is a frozen copy of the grid math (h2-informed
sigma_epsilon from normal percentiles, log-spaced pi), so the reference
knows every lane's pinned hyperparameters by itself.
"""

import numpy as np


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def plan_layout(chrom_block_sizes, block_size=1024):
    """{chrom: [m_b, ...]} -> (nb, placements, flat_index): placements a list
    of (tile, offset, chrom, block_idx, m_b); flat_index (M,) the padded flat
    position of each variant in chromosome-sorted variant order."""
    B = block_size
    chroms = sorted(chrom_block_sizes)
    placements, flat_by_block = [], {}
    tile_cursor = 0
    for c in chroms:
        sizes = chrom_block_sizes[c]
        order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
        open_tiles = []
        for bi in order:
            m_i = int(sizes[bi])
            ntiles = _round_up(max(m_i, 1), B) // B
            if ntiles > 1:
                t0 = tile_cursor
                placements.append((t0, 0, c, bi, m_i))
                base = t0 * B
                tile_cursor += ntiles
                if m_i % B:
                    open_tiles.append([t0 + ntiles - 1, m_i % B])
            else:
                best = None
                for slot in open_tiles:
                    rem = B - slot[1]
                    if m_i <= rem and (best is None or rem < B - best[1]):
                        best = slot
                if best is None:
                    best = [tile_cursor, 0]
                    open_tiles.append(best)
                    tile_cursor += 1
                placements.append((best[0], best[1], c, bi, m_i))
                base = best[0] * B + best[1]
                best[1] += m_i
            flat_by_block[(c, bi)] = np.arange(base, base + m_i,
                                               dtype=np.int64)
    parts = [flat_by_block[(c, bi)] for c in chroms
             for bi in range(len(chrom_block_sizes[c]))]
    flat_index = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return tile_cursor, placements, flat_index


def h2_percentile_values(h2_est, h2_se, steps):
    from scipy.stats import norm
    dist = norm(loc=h2_est, scale=h2_se)
    lo = max(0.1, dist.cdf(1e-5))
    hi = min(0.9, dist.cdf(1.0 - 1e-5))
    return dist.ppf(np.linspace(lo, hi, steps))


def grid_rows(spec, n_snps):
    """The grid's columns {name: (S,) float64} in lane order (the Cartesian
    product in sigma_epsilon, tau_beta, pi order, the last varying fastest),
    from a traffic file's ``grid`` spec."""
    h2_est, h2_se = float(spec['h2_est']), float(spec['h2_se'])
    cols = {}
    if 'sigma_epsilon_steps' in spec:
        cols['sigma_epsilon'] = 1.0 - h2_percentile_values(
            h2_est, h2_se, int(spec['sigma_epsilon_steps']))
    if 'pi_steps' in spec:
        lo = max(10.0 / n_snps, 1e-5)
        hi = min(1e4 / n_snps, 0.2)
        cols['pi'] = np.logspace(np.log10(lo), np.log10(hi),
                                 int(spec['pi_steps']))
    names = list(cols)
    mesh = np.meshgrid(*(cols[n] for n in names), indexing='ij')
    return {n: m.reshape(-1) for n, m in zip(names, mesh)}
