"""The plain reference that judges a fit's answers (float64 PyTorch).

It imports nothing of the program. It builds the LD itself from the panel,
stored as the configuration says (int8: round-half-even of 127 R, clipped,
times float32(1/127); float32: R rounded to float32), and reads the
program's answers only to judge them:

- every validly terminated lane's posterior mean eta (the lanes the model
  average takes: converged, or stopped at the iteration cap) must be a
  fixed point of the CAVI update (a frozen copy of the update's
  arithmetic): from q = (R - I) eta the update gives gamma*, mu* and
  eta* = gamma* mu* (for the mixture prior the softmax over K slabs and
  the null). The update takes the hyperparameters that the lane learns
  from the M-step of its state (the grid's tau_beta = pi M / sum(zeta);
  the mixture's pi_k, tau_k and sigma_epsilon), not the program's, so a
  wrong M-step moves eta* too. ``eta_gap`` is the median over those lanes
  of ||eta* - eta|| / ||eta*|| (``eta_gap_max`` their largest: a lane whose
  steps the convergence ladder has damped stops with a looser fixed point,
  so the largest swings from trait to trait).
  The PIPs are not held to gamma*: the sweep keeps a coordinate whose
  eta would move by less than 1e-8 where it was, so the gamma of a
  variant with a tiny mu stays behind its fixed point by design;
- the fitted hyperparameters must be the M-step of the lane's state
  (gamma, mu, eta; q of eta) (``tau_gap``: the grid's largest relative
  gap of tau_beta; ``hyper_gap``: the mixture's renormalised pi_k, tau_k
  and sigma_epsilon, a lane's largest relative gap, the median over the
  lanes and ``hyper_gap_max`` their largest);
- the reported ELBO of each of those lanes must be the objective of that
  state (``elbo_gap``, nats);
- the averaged model (grid traffic) must be the ELBO-softmax average of the
  lanes' states with the unconstrained M-step refresh (``bma_pip_gap``, the
  largest |PIP| gap; ``bma_eta_gap``, relative; ``bma_h2_gap``, relative).

Which of these a cell compares, and the limits, are in ``checks/<cell>``.
Lanes are judged in groups (``LANE_CHUNK``) so that the float64 work fits
beside whatever the card still holds.
"""

import math

import numpy as np
import torch

F64 = torch.float64
INT8_SCALE = float(np.float32(1.0 / 127.0))
LANE_CHUNK = 20


class RefLD:
    """The panel's blocks as the configuration stores them, on ``device``
    (int8 or float32 storage), applied in float64. The panel hands over
    each block in the stored type; each is made contiguous and moved, one
    block at a time."""

    def __init__(self, panel, quantize, device):
        self.quantize = bool(quantize)
        self.device = torch.device(device)
        self.starts = [int(s) for s in panel.starts]
        self.sizes = [int(m) for m in panel.sizes]
        self.m = panel.m
        stored = np.int8 if self.quantize else np.float32
        self.blocks = []
        for blk in panel.flat_blocks():
            if blk.dtype != stored:
                raise ValueError(f"a {blk.dtype} block where the "
                                 f"configuration stores {np.dtype(stored)}")
            self.blocks.append(torch.from_numpy(
                np.ascontiguousarray(blk)).to(self.device))

    def dense(self, i):
        b = self.blocks[i].to(F64)
        return b * INT8_SCALE if self.quantize else b

    def matvec(self, x):
        """R x for x (M, S) float64 on the device."""
        out = torch.empty_like(x)
        for i, (s, m) in enumerate(zip(self.starts, self.sizes)):
            out[s:s + m] = self.dense(i) @ x[s:s + m]
        return out


def _sum0(x):
    return x.sum(dim=0)


def spike_slab_update(q, beta, n, sigma_eps, tau, pi, lam=0.0):
    """The CAVI update of every coordinate from q = (R - I) eta: per lane
    hyperparameters (S,) float64 tensors; q (M, S), beta and n (M,).
    Returns (gamma*, mu*, var_tau)."""
    n_ = n[:, None]
    var_tau = n_ * (1.0 + lam) / sigma_eps[None] + tau[None]
    mu_mult = n_ / (var_tau * sigma_eps[None])
    mu = mu_mult * (beta[:, None] - q)
    u = (torch.log(pi) - torch.log1p(-pi) + 0.5 * torch.log(tau))[None] \
        - 0.5 * torch.log(var_tau) + 0.5 * var_tau * mu * mu
    return torch.sigmoid(u), mu, var_tau


def spike_slab_elbo(gamma, mu, var_tau, eta, q, beta, sigma_eps, tau, pi, n,
                    lam=0.0, sigma_eps_fixed=True):
    """The ELBO (float64, (S,)) of the state (gamma, mu, eta, q) under the
    hyperparameters: the objective's terms as the spike-and-slab model
    defines them (entropy, log prior, expected log-likelihood). Also
    returns sum(zeta), the M-step's input."""
    M = gamma.shape[0]
    zeta = gamma * (mu * mu + 1.0 / var_tau)
    s_gamma = _sum0(gamma)
    s_zeta = _sum0(zeta)
    sigma_g = (1.0 + lam) * s_zeta + _sum0(q * eta)
    s_beta_eta = _sum0(beta[:, None] * eta)
    s_g_logg = _sum0(torch.xlogy(gamma, gamma))
    s_ng_logng = _sum0(torch.xlogy(1.0 - gamma, 1.0 - gamma))
    s_g_logvt = _sum0(gamma * torch.log(var_tau))
    quad = (1.0 - 2.0 * s_beta_eta + sigma_g) / sigma_eps
    fit = quad if sigma_eps_fixed else torch.ones_like(quad)
    nn = float(n.max())
    e = 0.5 * nn * (-torch.log(2.0 * math.pi * sigma_eps) - fit)
    e = e - (s_g_logg - s_gamma * torch.log(pi))
    e = e - (s_ng_logng - (M - s_gamma) * torch.log1p(-pi))
    e = e + 0.5 * (s_gamma * (1.0 + torch.log(tau)) - s_g_logvt)
    return e - 0.5 * tau * s_zeta, s_zeta


def _rel(a, b):
    return torch.abs(a - b) / torch.abs(b)


def _median_max(gaps):
    """(median, largest) of the lanes' eta gaps; NaN reads as infinite,
    no lane as infinite."""
    if not gaps:
        return math.inf, math.inf
    g = torch.sort(torch.nan_to_num(torch.cat(gaps), nan=math.inf)).values
    k = g.numel()
    # the mean of the two middle lanes where their count is even
    med = g[k // 2] if k % 2 else 0.5 * (g[k // 2 - 1] + g[k // 2])
    return float(med), float(g[-1])


def _lane_record(lanes, on, **per_lane):
    """Append each per-lane tensor to ``lanes[name]`` (NaN where ``on`` is
    False)."""
    if lanes is None:
        return
    for name, x in per_lane.items():
        lanes.setdefault(name, []).extend(
            torch.where(on, x, math.nan).tolist())


def _worst(acc, x):
    """The larger of acc and the tensor x's largest entry; any NaN in x
    reads as infinite."""
    x = torch.nan_to_num(x.to(F64), nan=math.inf)
    return max(acc, float(x.max()))


def judge_grid(ld, out, beta, n, grid, lanes=None):
    """Judge one VIPRSGrid fit and its model average.

    :param out: the program's answers (``entries.viprs_grid_bma``'s
        ``GridOutputs``).
    :param grid: {'pi': (S,), 'sigma_epsilon': (S,)} the lanes' pinned
        hyperparameters, from the reference's own grid math.
    :param lanes: a dict that, where given, receives each lane's numbers
        (NaN for a lane not judged).
    :returns: {number: value}.
    """
    dev = ld.device
    beta = torch.as_tensor(beta, dtype=F64, device=dev)
    n = torch.as_tensor(n, dtype=F64, device=dev)
    S = out.eta.shape[1]
    M = ld.m
    valid = np.asarray(out.valid, bool)
    pi_all = torch.as_tensor(grid['pi'], dtype=F64, device=dev)
    se_all = torch.as_tensor(grid['sigma_epsilon'], dtype=F64, device=dev)
    tau_all = torch.as_tensor(out.tau_beta, dtype=F64, device=dev)
    elbo_prog = torch.as_tensor(out.elbo, dtype=F64, device=dev)
    w = np.zeros(S)
    if valid.any():
        e = np.asarray(out.elbo, np.float64)[valid]
        ex = np.exp(e - e.max())
        w[valid] = ex / ex.sum()
    w_t = torch.as_tensor(w, dtype=F64, device=dev)

    gaps = []
    tau_gap = elbo_gap = 0.0
    acc = {k: torch.zeros(M, dtype=F64, device=dev)
           for k in ('gamma', 'mu', 'q', 'var_tau')}
    for c0 in range(0, S, LANE_CHUNK):
        sl = slice(c0, min(S, c0 + LANE_CHUNK))
        eta = torch.as_tensor(out.eta[:, sl], dtype=F64, device=dev)
        gamma = torch.as_tensor(out.gamma[:, sl], dtype=F64, device=dev)
        mu = torch.as_tensor(out.mu[:, sl], dtype=F64, device=dev)
        q = ld.matvec(eta) - eta
        pi, se, tau = pi_all[sl], se_all[sl], tau_all[sl]
        var_tau = n[:, None] / se[None] + tau[None]
        elbo, s_zeta = spike_slab_elbo(gamma, mu, var_tau, eta, q, beta,
                                       se, tau, pi, n)
        tau_ref = pi * M / s_zeta
        g_star, mu_star, _ = spike_slab_update(q, beta, n, se, tau_ref, pi)
        eta_star = g_star * mu_star
        norm = torch.linalg.vector_norm(eta_star, dim=0)
        gap = torch.linalg.vector_norm(eta_star - eta, dim=0) / norm
        del g_star, mu_star, eta_star
        on = torch.as_tensor(valid[sl], device=dev)
        _lane_record(lanes, on, eta_gap=gap, eta_norm=norm,
                     tau_gap=_rel(tau, tau_ref))
        if on.any():
            gaps.append(gap[on])
            tau_gap = _worst(tau_gap, _rel(tau, tau_ref)[on])
            elbo_gap = _worst(elbo_gap, torch.abs(elbo - elbo_prog[sl])[on])
        ws = w_t[sl][None]
        acc['gamma'] += (gamma * ws).sum(dim=1)
        acc['mu'] += (mu * ws).sum(dim=1)
        acc['q'] += (q * ws).sum(dim=1)
        acc['var_tau'] += (var_tau * ws).sum(dim=1)
        del eta, gamma, mu, q, var_tau
    if not valid.any():
        tau_gap = elbo_gap = math.inf
    eta_gap, eta_gap_max = _median_max(gaps)

    # the model average: ELBO-softmax weights over the validly terminated
    # lanes (the reported ELBOs, judged above), the averaged gamma, mu, q
    # and var_tau, then the unconstrained M-step refresh
    g, mu, q, vt = acc['gamma'], acc['mu'], acc['q'], acc['var_tau']
    eta_avg = g * mu
    zeta = g * (mu * mu + 1.0 / vt)
    sigma_g = (zeta + q * eta_avg).sum()
    se_new = 1.0 - 2.0 * (beta * eta_avg).sum() + sigma_g
    h2 = float(sigma_g / (sigma_g + se_new))
    pip_p = torch.as_tensor(out.bma_pip, dtype=F64, device=dev)
    eta_p = torch.as_tensor(out.bma_eta, dtype=F64, device=dev)
    return {
        'eta_gap': eta_gap,
        'eta_gap_max': eta_gap_max,
        'tau_gap': tau_gap,
        'elbo_gap': elbo_gap,
        'bma_pip_gap': _worst(0.0, torch.abs(pip_p - g)),
        'bma_eta_gap': _worst(0.0, torch.linalg.vector_norm(eta_p - eta_avg)
                              / torch.linalg.vector_norm(eta_avg)),
        'bma_h2_gap': _worst(0.0, torch.tensor(abs(float(out.bma_h2) - h2)
                                               / abs(h2))),
    }


def mixture_update(q, beta, n, sigma_eps, tau, pi, lam=0.0):
    """The mixture prior's CAVI update from q = (R - I) eta: sigma_eps (S,),
    tau and pi (S, K). Returns (gamma* (M, S, K), mu* (M, S, K),
    var_tau (M, S, K))."""
    n_ = n[:, None, None]
    var_tau = n_ * (1.0 + lam) / sigma_eps[None, :, None] + tau[None]
    mu_mult = n_ / (var_tau * sigma_eps[None, :, None])
    mu = mu_mult * (beta[:, None, None] - q[:, :, None])
    u = (torch.log(pi) - torch.log1p(-pi) + 0.5 * torch.log(tau))[None] \
        - 0.5 * torch.log(var_tau) + 0.5 * var_tau * mu * mu
    lnp = torch.log1p(-pi.sum(dim=-1))
    u_max = torch.maximum(u.amax(dim=2), lnp[None])
    ex = torch.exp(u - u_max[..., None])
    denom = ex.sum(dim=2) + torch.exp(lnp[None] - u_max)
    return ex / denom[..., None], mu, var_tau


def mixture_elbo(gamma, mu, var_tau, eta, q, beta, sigma_eps, tau, pi, n,
                 lam=0.0, se_fixed=None):
    """The mixture ELBO (S,) of a state, with its per-component sums; the
    entropy's gamma clipped at 1e-12 as the model defines it. Where
    sigma_epsilon is pinned (``se_fixed``, (S,) bool) the fit term is the
    quadratic form, else 1."""
    M = gamma.shape[0]
    zeta = gamma * (mu * mu + 1.0 / var_tau)
    eps = 1e-12
    null_g = 1.0 - gamma.sum(dim=2).clamp(eps, 1.0 - eps)
    gc = gamma.clamp(eps, 1.0 - eps)
    ngc = null_g.clamp(eps, 1.0 - eps)
    s_gamma_k = gamma.sum(dim=0)
    s_zeta_k = zeta.sum(dim=0)
    sigma_g = (1.0 + lam) * s_zeta_k.sum(dim=1) + (q * eta).sum(dim=0)
    s_beta_eta = (beta[:, None] * eta).sum(dim=0)
    s_g_logg = (gc * torch.log(gc)).sum(dim=(0, 2))
    s_ng_logng = (ngc * torch.log(ngc)).sum(dim=0)
    s_null_g = null_g.sum(dim=0)
    s_g_logvt = (gamma * torch.log(var_tau)).sum(dim=0)
    nn = float(n.max())
    fit = torch.ones_like(sigma_eps)
    if se_fixed is not None:
        quad = (1.0 - 2.0 * s_beta_eta + sigma_g) / sigma_eps
        fit = torch.where(se_fixed, quad, fit)
    e = 0.5 * nn * (-torch.log(2.0 * math.pi * sigma_eps) - fit)
    e = e - (s_g_logg - (s_gamma_k * torch.log(pi)).sum(-1))
    null_pi = torch.clamp(1.0 - pi.sum(-1), min=1e-12)
    e = e - (s_ng_logng - s_null_g * torch.log(null_pi))
    e = e + 0.5 * ((s_gamma_k * (1.0 + torch.log(tau))).sum(-1)
                   - s_g_logvt.sum(-1))
    e = e - 0.5 * (tau * s_zeta_k).sum(-1)
    return e, s_gamma_k, s_zeta_k, sigma_g, s_beta_eta, M


#: sigma_epsilon of a lane restarted on a negative MSE, pinned from then on
#: (the reference behaviour); a lane within RESTART_TOL of it is taken as
#: pinned
RESTART_SIGMA_EPS = 0.95
RESTART_TOL = 1e-6


def judge_mix_grid(ld, out, beta, n, grid, d, lanes=None):
    """Judge one VIPRSMixGrid fit: every validly terminated lane's eta a
    fixed point of the mixture update at the M-step of its state, its pi_k
    (renormalised to the lane's grid pi), tau_k and (where it is learned)
    sigma_epsilon the M-step of that state, its reported ELBO the state's
    objective. A lane restarted on a negative MSE runs on with
    sigma_epsilon pinned at 0.95, and from that restart on the model pins
    every running lane's sigma_epsilon (``out.sigma_eps_pinned``). ``d``: the prior-variance multipliers."""
    dev = ld.device
    beta = torch.as_tensor(beta, dtype=F64, device=dev)
    n = torch.as_tensor(n, dtype=F64, device=dev)
    d = torch.as_tensor(d, dtype=F64, device=dev)
    S = out.eta.shape[1]
    valid = np.asarray(out.valid, bool)
    total_pi = torch.as_tensor(grid['pi'], dtype=F64, device=dev)
    pi_all = torch.as_tensor(out.pi, dtype=F64, device=dev)
    tau_all = torch.as_tensor(out.tau_beta, dtype=F64, device=dev)
    se_all = torch.as_tensor(out.sigma_eps, dtype=F64, device=dev)
    elbo_prog = torch.as_tensor(out.elbo, dtype=F64, device=dev)
    gaps, hgaps = [], []
    elbo_gap = 0.0
    for c0 in range(0, S, LANE_CHUNK):
        sl = slice(c0, min(S, c0 + LANE_CHUNK))
        on = torch.as_tensor(valid[sl], device=dev)
        if not on.any():
            nan = torch.full((sl.stop - sl.start,), math.nan, device=dev)
            _lane_record(lanes, on, eta_gap=nan, eta_norm=nan,
                         hyper_gap=nan)
            continue
        eta = torch.as_tensor(out.eta[:, sl], dtype=F64, device=dev)
        gamma = torch.as_tensor(out.gamma[:, sl], dtype=F64, device=dev)
        mu = torch.as_tensor(out.mu[:, sl], dtype=F64, device=dev)
        q = ld.matvec(eta) - eta
        se, tau, pi = se_all[sl], tau_all[sl], pi_all[sl]
        var_tau = n[:, None, None] / se[None, :, None] + tau[None]
        restarted = torch.abs(se - RESTART_SIGMA_EPS) <= RESTART_TOL
        elbo, s_gamma_k, s_zeta_k, sigma_g, s_beta_eta, M = mixture_elbo(
            gamma, mu, var_tau, eta, q, beta, se, tau, pi, n,
            se_fixed=restarted)
        e_gap = torch.abs(elbo - elbo_prog[sl])
        if out.sigma_eps_pinned:
            # after a restart every lane still running took sigma_eps as
            # fixed (its value then) and the quadratic fit term; a lane
            # that had stopped before kept the learned form
            pinned = torch.ones_like(restarted)
            e_gap = torch.minimum(e_gap, torch.abs(mixture_elbo(
                gamma, mu, var_tau, eta, q, beta, se, tau, pi, n,
                se_fixed=pinned)[0] - elbo_prog[sl]))
        else:
            pinned = restarted
        tp = total_pi[sl][:, None]
        pi_ref = tp * s_gamma_k / s_gamma_k.sum(dim=1, keepdim=True)
        tau_est = pi_ref.sum(dim=1) * M / (s_zeta_k @ d)
        tau_ref = torch.clamp(d[None] * tau_est[:, None], min=1.0)
        se_ref = torch.where(pinned, se, 1.0 - 2.0 * s_beta_eta + sigma_g)
        hg = torch.maximum(torch.maximum(_rel(pi, pi_ref).amax(dim=1),
                                         _rel(tau, tau_ref).amax(dim=1)),
                           _rel(se, se_ref))
        # the update at the M-step of the state, not at the program's
        # hyperparameters
        g_star, mu_star, _ = mixture_update(q, beta, n, se_ref, tau_ref,
                                            pi_ref)
        eta_star = (g_star * mu_star).sum(dim=2)
        norm = torch.linalg.vector_norm(eta_star, dim=0)
        gap = torch.linalg.vector_norm(eta_star - eta, dim=0) / norm
        del g_star, mu_star
        gaps.append(gap[on])
        hgaps.append(hg[on])
        _lane_record(lanes, on, eta_gap=gap, eta_norm=norm, hyper_gap=hg)
        elbo_gap = _worst(elbo_gap, e_gap[on])
        del eta, q, gamma, mu, var_tau, eta_star
    if not valid.any():
        elbo_gap = math.inf
    eta_gap, eta_gap_max = _median_max(gaps)
    hyper_gap, hyper_gap_max = _median_max(hgaps)
    return {'eta_gap': eta_gap, 'eta_gap_max': eta_gap_max,
            'hyper_gap': hyper_gap, 'hyper_gap_max': hyper_gap_max,
            'elbo_gap': elbo_gap}
