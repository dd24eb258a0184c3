"""``VIPRSGrid(ds, HyperparameterGrid(...)).fit(max_iter)``, then
``bayesian_model_average``: a geneticist's grid fit of one trait.

The handle keeps the fitted lanes as they were before the model average (a
shallow copy of the model, which shares the lanes' tensors until the average
replaces them on the model), so reading them costs the window nothing.
"""

import copy
import time
from dataclasses import dataclass

import numpy as np

from portbench import reference
from portbench.entries import BaseEntry, FitRecord, concat, sync
from portbench.layout import grid_rows


@dataclass
class GridOutputs:
    eta: np.ndarray          # (M, S) posterior means per lane
    gamma: np.ndarray        # (M, S) PIPs per lane
    mu: np.ndarray           # (M, S) slab means per lane
    valid: np.ndarray        # (S,) bool (validly terminated)
    tau_beta: np.ndarray     # (S,)
    elbo: np.ndarray         # (S,) the reported final ELBO
    bma_pip: np.ndarray = None   # (M,) after the model average
    bma_eta: np.ndarray = None   # (M,)
    bma_h2: float = None


class Entry(BaseEntry):
    planes = (4, 5)      # state planes a lane sweep reads and writes

    def __init__(self, traffic, m, device):
        super().__init__(traffic, m, device)
        from viprs_tpu_torch.gridsearch import HyperparameterGrid
        self.grid = HyperparameterGrid(n_snps=m, **traffic['grid'])
        self.rows = grid_rows(traffic['grid'], m)

    def _model(self, ds):
        from viprs_tpu_torch.model import VIPRSGrid
        return VIPRSGrid(ds, self.grid, device=self.device)

    def warm_up(self, ds):
        from viprs_tpu_torch.gridsearch import bayesian_model_average
        model = self._model(ds)
        model.fit(max_iter=int(self.traffic['warmup_iters']))
        bayesian_model_average(model)
        model.get_heritability()
        sync(self.device)

    def run(self, ds, span):
        from viprs_tpu_torch.gridsearch import bayesian_model_average
        t0 = time.perf_counter()
        model = self._model(ds)
        with span('portbench.fit'):
            model.fit(max_iter=self.max_iter)
        nit = np.array([r.nit for r in model.optim_results], np.int64)
        lanes = copy.copy(model)
        sync(self.device)
        t1 = time.perf_counter()
        with span('portbench.bma'):
            bayesian_model_average(model)
            model.get_heritability()
        bma_s = time.perf_counter() - t1
        sync(self.device)
        rec = FitRecord(seconds=time.perf_counter() - t0, nit=nit,
                        bma_s=bma_s)
        return rec, (lanes, model)

    @staticmethod
    def answers(handle):
        lanes, model = handle
        return GridOutputs(
            eta=concat(lanes.eta), gamma=concat(lanes.var_gamma),
            mu=concat(lanes.var_mu),
            valid=np.asarray(lanes.valid_terminated_models, bool),
            tau_beta=np.asarray(lanes.tau_beta, np.float64),
            elbo=np.asarray(lanes.validation_result['ELBO'], np.float64),
            bma_pip=concat(model.get_pip()),
            bma_eta=concat(model.get_posterior_mean_beta()),
            bma_h2=float(model.get_heritability()))

    def judge(self, ld, out, beta, n, lanes=None):
        return reference.judge_grid(ld, out, beta, n, self.rows, lanes)
