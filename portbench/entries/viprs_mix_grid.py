"""``VIPRSMixGrid(ds, HyperparameterGrid(...), K=...).fit(max_iter)``: a
grid of sparse Gaussian-mixture priors fitted at once."""

import time
from dataclasses import dataclass

import numpy as np

from portbench import reference
from portbench.entries import BaseEntry, FitRecord, concat, sync
from portbench.layout import grid_rows


@dataclass
class MixOutputs:
    eta: np.ndarray          # (M, S)
    gamma: np.ndarray        # (M, S, K) responsibilities of the slabs
    mu: np.ndarray           # (M, S, K)
    valid: np.ndarray
    pi: np.ndarray           # (S, K)
    tau_beta: np.ndarray     # (S, K)
    sigma_eps: np.ndarray    # (S,)
    elbo: np.ndarray
    sigma_eps_pinned: bool = False   # a lane restarted: sigma_eps fixed


class Entry(BaseEntry):

    def __init__(self, traffic, m, device):
        super().__init__(traffic, m, device)
        from viprs_tpu_torch.gridsearch import HyperparameterGrid
        self.grid = HyperparameterGrid(n_snps=m, **traffic['grid'])
        self.rows = grid_rows(traffic['grid'], m)
        self.K = int(traffic['K'])
        self.planes = (2 * self.K + 2, 2 * self.K + 3)
        # the slabs' prior-variance multipliers
        self.d = 2.0 ** np.linspace(-min(self.K - 1, 7), 0, self.K)

    def _model(self, ds):
        from viprs_tpu_torch.model import VIPRSMixGrid
        return VIPRSMixGrid(ds, self.grid, self.device, K=self.K)

    def warm_up(self, ds):
        model = self._model(ds)
        model.fit(max_iter=int(self.traffic['warmup_iters']))
        sync(self.device)

    def run(self, ds, span):
        t0 = time.perf_counter()
        model = self._model(ds)
        with span('portbench.fit'):
            model.fit(max_iter=self.max_iter)
        nit = np.array([r.nit for r in model.optim_results], np.int64)
        sync(self.device)
        return FitRecord(seconds=time.perf_counter() - t0, nit=nit), \
            (model,)

    @staticmethod
    def answers(handle):
        model, = handle
        # the lanes' sigma_epsilon has no public per-lane getter
        return MixOutputs(
            eta=concat(model.eta), gamma=concat(model.var_gamma),
            mu=concat(model.var_mu),
            valid=np.asarray(model.valid_terminated_models, bool),
            pi=np.asarray(model.pi, np.float64),
            tau_beta=np.asarray(model.tau_beta, np.float64),
            sigma_eps=np.asarray(model._hyper.sigma_eps,
                                 np.float64).reshape(-1),
            elbo=np.asarray(model.validation_result['ELBO'], np.float64),
            sigma_eps_pinned='sigma_epsilon' in model.fix_params)

    def judge(self, ld, out, beta, n, lanes=None):
        return reference.judge_mix_grid(ld, out, beta, n, self.rows, self.d,
                                        lanes)
