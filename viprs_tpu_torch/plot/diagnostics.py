"""Optimization diagnostics plotting (counterpart of
viprs_tpu.plot.diagnostics). pandas and seaborn are imported inside the
call, so importing this module needs neither."""

import numpy as np


def plot_history(viprs_model, quantities=None, col_wrap=3):
    """Plot tracked quantities against the iteration as a seaborn FacetGrid,
    a panel per quantity (per quantity and lane for a grid's (S,) rows).

    :param viprs_model: a fitted model with a populated ``history`` dict
        (``tracked_params``).
    :param quantities: the history keys to plot (default: all).
    :returns: the seaborn FacetGrid.
    """
    import pandas as pd
    import seaborn as sns

    history = viprs_model.history
    quantities = quantities or list(history.keys())

    rows = []
    for key in quantities:
        for i, v in enumerate(history.get(key, [])):
            v = np.asarray(v)
            if v.ndim == 0:
                rows.append({'Iteration': i, 'Quantity': key,
                             'Value': float(v)})
            else:
                for s, vs in enumerate(np.ravel(v)):
                    rows.append({'Iteration': i, 'Quantity': f'{key}_{s}',
                                 'Value': float(vs)})

    g = sns.FacetGrid(pd.DataFrame(rows), col='Quantity', col_wrap=col_wrap,
                      sharey=False)
    g.map(sns.lineplot, 'Iteration', 'Value')
    return g
