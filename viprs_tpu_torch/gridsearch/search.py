"""Post-fit model selection and combination over a fitted grid.

Counterpart of viprs_tpu.gridsearch.search: ``select_best_model`` over the
ELBO, validation and pseudo-validation criteria, ELBO-softmax Bayesian
model averaging (reference grid_utils.py:121-193), and ``GridSearch``,
which fits VIPRS grids as one VIPRSGrid, VIPRSMix grids as one
VIPRSMixGrid and any other model class one grid row at a time. The
``validation`` criterion scores each model on individual-level validation
data (a GWADataLoader with genotypes and a phenotype; the products on its
genotype's device) and takes the R^2 of the PRS against the phenotype.
"""

import logging

import numpy as np
import torch

from ..utils import trace

logger = logging.getLogger(__name__)

F64 = torch.float64

CRITERIA = ('ELBO', 'validation', 'pseudo_validation')


def _check_criterion(criterion):
    if criterion not in CRITERIA:
        raise ValueError(f"criterion must be one of {CRITERIA}; got "
                         f"{criterion!r}")


def select_best_model(viprs_grid_model, validation_gdl=None, criterion='ELBO'):
    """Select the best grid point among the validly terminated ones and
    collapse the model to it: the highest ELBO; the highest R^2 of the
    lanes' PRS on the samples of ``validation_gdl`` against its phenotype
    (written into ``validation_result['Validation_R2']``); or the highest
    pseudo-R^2 on the held-out statistics of a PUMAS split (written into
    ``validation_result['Pseudo_Validation_R2']``; a NaN or infinite score
    counts as 0 in the choice)."""
    _check_criterion(criterion)
    if criterion == 'validation' and validation_gdl is None:
        raise ValueError("A validation dataset must be provided for the "
                         "validation criterion.")
    if (criterion == 'pseudo_validation' and validation_gdl is None
            and viprs_grid_model.validation_std_beta is None):
        raise ValueError("A validation dataset or validation standardized "
                         "betas are required for the pseudo_validation "
                         "criterion.")
    valid = viprs_grid_model.valid_terminated_models
    if np.sum(valid) < 2:
        raise ValueError("Less than two models converged successfully. "
                         "Cannot perform model selection.")
    if criterion == 'ELBO':
        scores = np.array(viprs_grid_model.elbo(), dtype=np.float64)
        scores[~valid] = -np.inf
        best_idx = int(np.argmax(scores))
    elif criterion == 'validation':
        from ..eval.continuous import r2
        prs = viprs_grid_model.predict(test_gdl=validation_gdl)
        phenotype = validation_gdl.phenotype
        # a lane that did not terminate validly scores -inf unscored (its
        # PRS may be constant, where R^2 raises)
        scores = np.full(viprs_grid_model.n_models, -np.inf)
        for i in np.where(valid)[0]:
            scores[i] = r2(phenotype, prs[:, i])
        viprs_grid_model.validation_result['Validation_R2'] = scores
        best_idx = int(np.argmax(scores))
    else:
        scores = np.array(viprs_grid_model.pseudo_validate(validation_gdl),
                          dtype=np.float64)
        scores[~valid] = -np.inf
        viprs_grid_model.validation_result['Pseudo_Validation_R2'] = scores
        best_idx = int(np.argmax(np.nan_to_num(scores, nan=0., neginf=0.,
                                               posinf=0.)))
    logger.info("> Based on the %s criterion, selected model: %d", criterion,
                best_idx)
    viprs_grid_model.collapse_to_model(best_idx)
    return viprs_grid_model


@trace.entry('viprs.bma')
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
    l0, l1 = m._lane_range()
    w = torch.from_numpy(w_full[l0:l1].astype(np.float32)).to(dev)[
        :, None, None]
    lam = float(np.asarray(m._hyper.lambda_min)[keep[0]])
    st = m._state
    mask, sb = m._ld.mask, m._std_beta_flat
    var_tau = updates.compute_var_tau(m._n_flat, m._hyper_dev())
    split = m._lanes_split()

    def lane_sum(x):
        # under a mesh that splits the lanes, the grid ranks' partial sums
        # are added in rank order (the same bits on every rank)
        s = x.sum(dim=0)
        if not split:
            return s
        return torch.stack(m.mesh.gather(s.cpu(), 'grid')).sum(dim=0).to(dev)

    gamma_avg = lane_sum(st.gamma * w)
    mu_avg = lane_sum(st.mu * w)
    q_avg = lane_sum(st.q * w)
    var_tau_avg = lane_sum(var_tau * w)
    eta_avg = gamma_avg * mu_avg
    zeta_avg = gamma_avg * (mu_avg ** 2 + 1.0 / var_tau_avg)

    sums = torch.stack([mask.sum(), (gamma_avg * mask).sum(),
                        (zeta_avg * mask).sum(),
                        (((1.0 + lam) * zeta_avg + q_avg * eta_avg)
                         * mask).sum(),
                        (sb * eta_avg * mask).sum()]).to(F64)
    if m.mesh is not None:     # over every rank's blocks
        sums = torch.from_numpy(m._reduce(sums.cpu().numpy()[:, None],
                                          lanes=False)[:, 0])
    m_total, s_gamma, s_zeta, sigma_g, s_beta_eta = sums
    pi_new = s_gamma / m_total
    tau_new = pi_new * m_total / s_zeta
    sig_e = 1.0 - 2.0 * s_beta_eta + sigma_g
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
    """Fit a hyperparameter grid and select its best point by the criterion
    (viprs_tpu.gridsearch.GridSearch; reference HyperparameterSearch.py:
    197-351). VIPRS grids are fitted simultaneously as one VIPRSGrid,
    VIPRSMix grids as one VIPRSMixGrid; any other model class falls back to
    one fit per grid row with the row pinned through ``fix_params``, scored
    under the same criterion.
    """

    def __init__(self, dataset, grid, device, criterion='ELBO',
                 validation_gdl=None, model_class=None, **model_kwargs):
        from ..model.grid import VIPRSGrid
        from ..model.mix import VIPRSMix
        from ..model.mix_grid import VIPRSMixGrid
        self.criterion = 'ELBO' if criterion == 'training_objective' \
            else criterion
        _check_criterion(self.criterion)
        self.validation_gdl = validation_gdl
        cls = model_class or VIPRSGrid
        if isinstance(cls, type) and issubclass(cls, VIPRSMix) \
                and not issubclass(cls, VIPRSMixGrid):
            cls = VIPRSMixGrid
        self._simultaneous = isinstance(cls, type) and \
            issubclass(cls, (VIPRSGrid, VIPRSMixGrid))
        if self._simultaneous:
            self.model = cls(dataset, grid, device, **model_kwargs)
        else:
            self.model = None
            self._dataset, self._grid, self._device = dataset, grid, device
            self._model_class = cls
            self._model_kwargs = model_kwargs
        self.validation_result = None

    def _score(self, model):
        if self.criterion == 'ELBO':
            return float(model.objective())
        if self.criterion == 'validation':
            from ..eval.continuous import r2
            prs = np.asarray(model.predict(test_gdl=self.validation_gdl))
            return float(r2(self.validation_gdl.phenotype, prs.reshape(-1)))
        return float(model.pseudo_validate(self.validation_gdl))

    def _fit_per_row(self, **fit_kwargs):
        """One fit per grid row, the row pinned in ``fix_params``; a row
        whose fit or score raises scores -inf (the reference worker's skip
        on failure, HyperparameterSearch.py:50-53). On the card a
        RuntimeError is not a row's failure but the device's (a CUDA error,
        or a kernel that could not be built or launched) and is raised."""
        from ..model.grid import grid_columns
        rows = self._grid.combine_grids() \
            if hasattr(self._grid, 'combine_grids') else list(self._grid)
        on_card = torch.device(self._device).type == 'cuda'
        fitted, scores = [], []
        for i, row in enumerate(rows):
            m = self._model_class(self._dataset, self._device,
                                  fix_params=dict(row), **self._model_kwargs)
            try:
                m.fit(**fit_kwargs)
                score = self._score(m)
            except Exception as e:
                if on_card and isinstance(e, RuntimeError):
                    raise
                logger.warning("Grid row %d failed: %s", i, e)
                m, score = None, -np.inf
            fitted.append(m)
            scores.append(score)
        if not any(m is not None for m in fitted):
            raise ValueError("No grid row produced a successfully fitted "
                             "model.")
        self.validation_result = dict(grid_columns(rows))
        column = {'ELBO': 'ELBO', 'validation': 'Validation_R2',
                  'pseudo_validation': 'Pseudo_Validation_R2'}[self.criterion]
        self.validation_result[column] = np.asarray(scores, np.float64)
        best_idx = int(np.argmax(np.nan_to_num(scores, nan=-np.inf)))
        logger.info("> Based on the %s criterion, selected model: %d",
                    self.criterion, best_idx)
        self.model = fitted[best_idx]
        return self.model

    def fit(self, **fit_kwargs):
        if not self._simultaneous:
            return self._fit_per_row(**fit_kwargs)
        self.model.fit(**fit_kwargs)
        best = select_best_model(self.model, validation_gdl=self.validation_gdl,
                                 criterion=self.criterion)
        self.validation_result = self.model.validation_result
        return best
