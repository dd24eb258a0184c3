"""Post-fit model selection and combination over a fitted grid.

Counterpart of viprs_tpu.gridsearch.search: ``select_best_model`` over the
ELBO criterion, ELBO-softmax Bayesian model averaging (reference
grid_utils.py:121-193), and ``GridSearch`` for VIPRSGrid. The validation and
pseudo-validation criteria need the evaluation code and the loaders, which
are not ported yet (ROADMAP.md, Queue 1).
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

F64 = torch.float64

_NOT_PORTED = ("the {} criterion needs the evaluation code and the loaders, "
               "which are not ported yet; see ROADMAP.md, Queue 1")


def _check_criterion(criterion):
    if criterion in ('validation', 'pseudo_validation'):
        raise NotImplementedError(_NOT_PORTED.format(criterion))
    if criterion != 'ELBO':
        raise ValueError(f"criterion must be 'ELBO', 'validation' or "
                         f"'pseudo_validation'; got {criterion!r}")


def select_best_model(viprs_grid_model, validation_gdl=None, criterion='ELBO'):
    """Select the grid point with the highest ELBO among the validly
    terminated ones and collapse the model to it."""
    _check_criterion(criterion)
    valid = viprs_grid_model.valid_terminated_models
    if np.sum(valid) < 2:
        raise ValueError("Less than two models converged successfully. "
                         "Cannot perform model selection.")
    scores = np.array(viprs_grid_model.elbo(), dtype=np.float64)
    scores[~valid] = -np.inf
    best_idx = int(np.argmax(scores))
    logger.info("> Based on the %s criterion, selected model: %d", criterion,
                best_idx)
    viprs_grid_model.collapse_to_model(best_idx)
    return viprs_grid_model


def bayesian_model_average(viprs_grid_model, normalization='softmax'):
    """ELBO-weighted averaging of the variational parameters across the
    validly terminated grid points, followed by an unconstrained M-step
    refresh of the hyperparameters (reference grid_utils.py:121-193). The
    weights are normalized over the kept lanes only; the averaging runs in
    torch on the model's device, and only the collapsed state's four
    scalars come to the host."""
    if viprs_grid_model.n_models < 2:
        return viprs_grid_model
    valid = viprs_grid_model.valid_terminated_models
    if np.sum(valid) < 1:
        raise ValueError("No models converged successfully. Cannot average "
                         "models.")
    keep = np.where(valid)[0]
    elbos = np.asarray(viprs_grid_model.elbo(), dtype=np.float64)
    if normalization == 'softmax':
        from scipy.special import softmax
        weights_keep = softmax(elbos[keep])
    elif normalization == 'sum':
        weights_keep = elbos[keep] - elbos[keep].min() + 1.
        weights_keep /= weights_keep.sum()
    else:
        raise KeyError("Normalization scheme not recognized. Valid options "
                       "are: `softmax`, `sum`. Got: {}".format(normalization))
    logger.info("Averaging PRS models with weights: %s", weights_keep)

    from ..ops import updates
    from ..ops.cavi_torch import CaviState, Hyper
    m = viprs_grid_model
    dev = m.device
    w_full = np.zeros(len(elbos))
    w_full[keep] = weights_keep
    w = torch.from_numpy(w_full.astype(np.float32)).to(dev)[:, None, None]
    lam = float(np.asarray(m._hyper.lambda_min)[keep[0]])
    st = m._state
    mask, sb = m.dataset.ld.mask, m._std_beta_flat
    var_tau = updates.compute_var_tau(m._n_flat, m._hyper_dev())

    gamma_avg = (st.gamma * w).sum(dim=0)
    mu_avg = (st.mu * w).sum(dim=0)
    q_avg = (st.q * w).sum(dim=0)
    var_tau_avg = (var_tau * w).sum(dim=0)
    eta_avg = gamma_avg * mu_avg
    zeta_avg = gamma_avg * (mu_avg ** 2 + 1.0 / var_tau_avg)

    m_total = mask.sum().to(F64)
    pi_new = (gamma_avg * mask).sum().to(F64) / m_total
    tau_new = pi_new * m_total / (zeta_avg * mask).sum().to(F64)
    sigma_g = (((1.0 + lam) * zeta_avg + q_avg * eta_avg) * mask).sum().to(F64)
    sig_e = 1.0 - 2.0 * (sb * eta_avg * mask).sum().to(F64) + sigma_g
    g_clip = gamma_avg.clamp(1e-8, 1.0 - 1e-8)
    logits = torch.log(g_clip) - torch.log1p(-g_clip)
    pi_new, tau_new, sigma_g, sig_e = (
        float(x) for x in torch.stack([pi_new, tau_new, sigma_g, sig_e]).cpu())

    m._state = CaviState(logits=logits[None], mu=mu_avg[None],
                         eta=eta_avg[None], q=q_avg[None])
    m._hyper = Hyper(sigma_eps=np.array([sig_e]), tau_beta=np.array([tau_new]),
                     pi=np.array([pi_new]), lambda_min=np.array([lam]))
    m._sigma_g = np.array([sigma_g])
    m._collapse()
    m._update_fix_mask()
    return m


class GridSearch:
    """Facade over the simultaneous grid fit: ``VIPRSGrid`` over the grid,
    then ``select_best_model`` by the criterion (viprs_tpu.gridsearch.
    GridSearch for VIPRSGrid; the other model classes are not ported yet)."""

    def __init__(self, dataset, grid, device, criterion='ELBO',
                 **model_kwargs):
        from ..model.grid import VIPRSGrid
        self.criterion = 'ELBO' if criterion == 'training_objective' \
            else criterion
        _check_criterion(self.criterion)
        self.model = VIPRSGrid(dataset, grid, device, **model_kwargs)
        self.validation_result = None

    def fit(self, **fit_kwargs):
        self.model.fit(**fit_kwargs)
        self.validation_result = self.model.validation_result
        return select_best_model(self.model, criterion=self.criterion)
