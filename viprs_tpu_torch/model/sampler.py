"""Posterior-check samplers: blocked Gibbs, SMC over the hyperparameter grid,
and HMC refinement — the exact-inference counterpart used to validate the
variational posteriors (counterpart of viprs_tpu.model.sampler, in plain
PyTorch on the dataset's device).

- :class:`GibbsSampler` — collapsed spike-and-slab Gibbs. Per coordinate j,
  given all other effects, the conditional is available in closed form (the
  sampling twin of the CAVI update):

      v_j = n_j (1+lambda_min)/sigma_eps + tau_beta
      m_j = (n_j/(v_j sigma_eps)) (beta_hat_j - q_j)
      P(gamma_j=1 | ...) = sigmoid(logit(pi) + (log tau_beta - log v_j)/2
                                   + v_j m_j^2 / 2)
      beta_j | gamma_j=1 ~ N(m_j, 1/v_j);  beta_j | gamma_j=0 = 0

  Coordinates are sampled sequentially within a tile (valid MCMC), tiles
  and chains advance together: the loop runs over the B coordinates of a
  tile, each step vectorized over chains x tiles. As in the JAX package,
  the sweep reads only the diagonal tiles: q misses the coupling tiles'
  terms on LD blocks wider than B (exact for block-diagonal LD).

- :func:`smc_over_grid` — tempered SMC where the particles are grid points:
  the likelihood is annealed (n -> lambda_t n), particles are reweighted by
  tempered-likelihood increments estimated from their Gibbs states and
  resampled systematically; Gibbs sweeps are the mutation kernel.

- :func:`hmc_refine` — HMC on the slab coefficients given a fixed
  configuration gamma, on the energy
  n/(2 sigma_eps) (beta' R beta - 2 beta_hat' beta) + tau_beta/2 ||beta||^2
  (gradients by ``compute_q``, the coupling tiles included).

Randomness: every draw comes from a draw source held in the state's
``key``: by default torch generators on the dataset's device seeded from
``seed`` (the JAX package draws from ``jax.random`` keys instead, so the
two packages' chains differ draw for draw). A Gibbs sweep takes uniforms,
then normals, both (C, NB, B) float32; an HMC step a (C, NB, B) float32
normal, the trajectory length L (from a CPU generator: no device read) and
(C,) float64 uniforms.
"""

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cavi_torch import compute_q

logger = logging.getLogger(__name__)

F32 = torch.float32
F64 = torch.float64


class _Draws:
    """The default draw source: a torch generator on the device (uniforms
    and normals) and one on the CPU (trajectory lengths)."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.cpu = torch.Generator()
        self.cpu.manual_seed(int(seed))

    def gibbs(self, shape):
        """A sweep's uniforms and normals, ``shape`` float32 each."""
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=F32)
        z = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=F32)
        return u, z

    def hmc(self, shape, n_lo, n_hi):
        """An HMC step's momentum normal (``shape`` float32), trajectory
        length in [n_lo, n_hi] and (shape[0],) float64 uniforms."""
        z = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=F32)
        L = int(torch.randint(n_lo, n_hi + 1, (), generator=self.cpu))
        u = torch.rand(shape[0], generator=self.gen, device=self.device,
                       dtype=F64)
        return z, L, u

    def clone(self):
        """An independent source in the same state (the same future
        draws)."""
        new = _Draws.__new__(_Draws)
        new.device = self.device
        new.gen = torch.Generator(device=self.device)
        new.gen.set_state(self.gen.get_state())
        new.cpu = torch.Generator()
        new.cpu.set_state(self.cpu.get_state())
        return new


def _draw_source(key, device):
    """The draw source of ``key``: a seed (int) or a torch generator on
    ``device`` (its state is taken over; the trajectory lengths' CPU
    generator is seeded from its initial seed)."""
    if isinstance(key, torch.Generator):
        src = _Draws(key.initial_seed(), device)
        src.gen.set_state(key.get_state())
        return src
    return _Draws(key, device)


class GibbsState(NamedTuple):
    beta: torch.Tensor    # (C, NB, B) current effect sizes (0 when excluded)
    gamma: torch.Tensor   # (C, NB, B) current inclusion indicators (0/1)
    q: torch.Tensor       # (C, NB, B) q = (R_diag - I) beta
    key: object           # the draw source (the JAX package's PRNG key)

    def clone(self):
        """A copy that shares nothing with this state: its tensors and its
        draw source's state are copied."""
        return GibbsState(self.beta.clone(), self.gamma.clone(),
                          self.q.clone(), self.key.clone())


def _tile_chunk(ld):
    """Tiles whose float32 view one pass of the sweep holds: all of them,
    unless on a CUDA device that view would take more than a quarter of
    the free memory."""
    if ld.device.type != 'cuda' or ld.diag.dtype == F32:
        return ld.nb
    free = torch.cuda.mem_get_info(ld.device)[0]
    return int(max(1, min(ld.nb, free // 4 // (4 * ld.block_size ** 2))))


def _gibbs_sweep(ld, state: GibbsState, std_beta, n_per_snp, sigma_eps,
                 tau_beta, pi, lambda_min, temper):
    """One full Gibbs sweep (all coordinates once), C chains together.

    ``temper`` in (0, 1] anneals the likelihood (n -> temper * n). The
    hyperparameters are float32 scalars (numpy); the arithmetic per
    coordinate is the JAX package's, in float32: the terms that do not
    depend on q are formed for all coordinates at once, elementwise as the
    reference forms them one coordinate at a time. Each coordinate adds
    ``d`` times the whole row j of its tile to q, then subtracts ``d`` at j,
    in the reference's order: the dequantized diagonal is not assumed to be
    1, and (q + d) - d need not be q in float32.
    """
    C, NB, B = state.beta.shape
    u_unif, z_norm = state.key.gibbs((C, NB, B))
    f32 = np.float32
    sig, tau, lam = f32(sigma_eps), f32(tau_beta), f32(lambda_min)
    pi = f32(pi)
    logit_pi = np.log(pi) - np.log1p(-pi)
    log_tau = np.log(tau)

    # the per-coordinate terms that do not depend on q, (NB, B) float32:
    n_s = n_per_snp * f32(temper)
    v = n_s * (f32(1.0) + lam) / sig + tau
    c_m = n_s / (v * sig)
    a_u = logit_pi + f32(0.5) * (log_tau - torch.log(v))
    h_v = f32(0.5) * v
    z_s = z_norm / torch.sqrt(v)                      # (C, NB, B)
    # a padding lane's uniform is 2, never below p: its gamma is 0
    u_keep = torch.where(ld.mask != 0, u_unif, 2.0)

    beta = state.beta.clone()
    gamma = state.gamma.clone()
    q = state.q.clone()
    chunk = _tile_chunk(ld)
    scale = float(f32(ld.scale))
    for b0 in range(0, NB, chunk):
        sl = slice(b0, b0 + chunk)
        D = ld.diag[sl].to(F32)
        if ld.scale != 1.0:
            D = D * scale
        qq = q[:, sl]
        # per-coordinate views, made once: (C, nb) columns of the state and
        # the draws, (nb,) of the inputs, (nb, B) rows of the tiles
        be, ga, qc, uu, zz = (x.unbind(2) for x in (
            beta[:, sl], gamma[:, sl], qq, u_keep[:, sl], z_s[:, sl]))
        bh, cm, au, hv = (x.unbind(1) for x in (
            std_beta[sl], c_m[sl], a_u[sl], h_v[sl]))
        rows = D.unbind(1)
        for j in range(B):
            m = cm[j] * (bh[j] - qc[j])                     # (C, nb)
            p = torch.sigmoid(au[j] + hv[j] * m * m)
            ga[j].copy_(uu[j] < p)                          # 1.0 or 0.0
            b = ga[j] * (m + zz[j])
            d = b - be[j]
            qq += d[:, :, None] * rows[j]
            qc[j].sub_(d)
            be[j].copy_(b)
    return GibbsState(beta=beta, gamma=gamma, q=q, key=state.key)


def _loglik(state: GibbsState, std_beta, sigma_eps, n):
    """Summary-statistics log-likelihood term per chain (up to constants):
    -n/(2 sigma_eps) (1 - 2 beta_hat' beta + beta' R beta), float32."""
    bRb = ((state.q + state.beta) * state.beta).sum(dim=(1, 2))
    bhb = (std_beta[None] * state.beta).sum(dim=(1, 2))
    return -0.5 * n / sigma_eps * (1.0 - 2.0 * bhb + bRb)


class GibbsSampler:
    """Blocked spike-and-slab Gibbs sampler over a SummaryStatsDataset, on
    the dataset's device."""

    def __init__(self, dataset, pi=0.01, tau_beta=None, sigma_eps=0.9,
                 lambda_min=0.0, n_chains=4, seed=0):
        self.dataset = dataset
        lay = dataset.layout
        self.pi = float(pi)
        self.tau_beta = float(tau_beta if tau_beta is not None
                              else pi * lay.m / 0.1)
        self.sigma_eps = float(sigma_eps)
        self.lambda_min = float(lambda_min)
        self.n_chains = n_chains
        self.seed = seed
        self._sb, self._nf = dataset.device_inputs()

    def init_state(self, key=None):
        """A state of zeros; ``key`` a seed or a torch generator on the
        dataset's device (default: ``seed``)."""
        lay = self.dataset.layout
        dev = self.dataset.device
        shape = (self.n_chains, lay.nb, lay.block_size)
        key = self.seed if key is None else key
        return GibbsState(beta=torch.zeros(shape, dtype=F32, device=dev),
                          gamma=torch.zeros(shape, dtype=F32, device=dev),
                          q=torch.zeros(shape, dtype=F32, device=dev),
                          key=_draw_source(key, dev))

    def _args(self, temper):
        return (self._sb, self._nf, self.sigma_eps, self.tau_beta, self.pi,
                self.lambda_min, temper)

    def run(self, n_iter=500, burn_in=200, thin=1, temper=1.0, state=None):
        """Run the sampler; returns posterior summaries averaged over
        chains and retained sweeps (float32 sums, read once at the end):
        pip, post_mean_beta, post_var_beta ({chrom: array}) and the final
        ``state``."""
        if state is None:
            state = self.init_state()
        sums = None
        kept = 0
        args = self._args(temper)
        for it in range(n_iter):
            state = _gibbs_sweep(self.dataset.ld, state, *args)
            if it >= burn_in and (it - burn_in) % thin == 0:
                kept += 1
                b = state.beta
                cur = (state.gamma.sum(0), b.sum(0), (b * b).sum(0))
                sums = cur if sums is None else \
                    tuple(a + c for a, c in zip(sums, cur))
        total = kept * self.n_chains
        lay = self.dataset.layout
        pip, mean, second = (x.cpu().numpy().reshape(-1) for x in
                             torch.stack(sums) / total)
        return dict(
            pip=lay.from_flat(pip),
            post_mean_beta=lay.from_flat(mean),
            post_var_beta=lay.from_flat(second - mean ** 2),
            state=state,
        )


def _grid_rows(grid_table):
    """The rows of a grid given as the port's Table, a dict of columns or a
    pandas DataFrame, as {column: value} dicts."""
    if isinstance(grid_table, dict):
        cols = dict(grid_table)
    else:
        cols = {c: grid_table[c] for c in grid_table.columns}
    cols = {str(k): np.asarray(v) for k, v in cols.items()}
    n = len(next(iter(cols.values()))) if cols else 0
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def smc_over_grid(dataset, grid_table, n_chains_per_particle=1,
                  n_stages=8, sweeps_per_stage=5, seed=0,
                  sigma_eps_default=0.9):
    """Tempered SMC with hyperparameter grid points as particles.

    :param grid_table: the port's Table (``HyperparameterGrid.to_table()``),
        a dict of columns or a pandas DataFrame, with columns among
        (pi, tau_beta, sigma_epsilon, lambda_min); one particle per row.
    :returns: dict with the final weights, the best particle and its
        hyperparameters, and the posterior summaries of its chains after 50
        further sweeps.
    """
    lay = dataset.layout
    n = float(dataset.n)
    particles = []
    for row in _grid_rows(grid_table):
        pi = float(row.get('pi', 0.01))
        tau = float(row.get('tau_beta', pi * lay.m / 0.1))
        sig = float(row.get('sigma_epsilon', sigma_eps_default))
        lam = float(row.get('lambda_min', 0.0))
        particles.append(GibbsSampler(dataset, pi=pi, tau_beta=tau,
                                      sigma_eps=sig, lambda_min=lam,
                                      n_chains=n_chains_per_particle,
                                      seed=seed))
    states = [s.init_state(seed + 17 * i) for i, s in enumerate(particles)]

    P = len(particles)
    log_w = np.zeros(P)
    lambdas = np.linspace(0.0, 1.0, n_stages + 1)[1:]
    prev_lambda = 0.0

    for t, lam_t in enumerate(lambdas):
        # mutate under the stage's temperature, then reweight by the
        # increment (one host read per particle and stage):
        for i, (s, st) in enumerate(zip(particles, states)):
            args = s._args(max(lam_t, 1e-3))
            for _ in range(sweeps_per_stage):
                st = _gibbs_sweep(dataset.ld, st, *args)
            states[i] = st
            ll = float(np.mean(_loglik(st, s._sb, s.sigma_eps, n)
                               .cpu().numpy()))
            log_w[i] += (lam_t - prev_lambda) * ll
        prev_lambda = lam_t

        # systematic resampling when the effective sample size collapses;
        # a duplicated particle gets its own copy of the state and of the
        # draw source, so duplicates draw alike but share no tensor:
        w = np.exp(log_w - log_w.max())
        w /= w.sum()
        ess = 1.0 / np.sum(w ** 2)
        if ess < P / 2 and t < len(lambdas) - 1:
            pos = (np.arange(P) + np.random.default_rng(seed + t).random()) / P
            idx = np.searchsorted(np.cumsum(w), pos)
            states = [states[j].clone() for j in idx]
            particles = [particles[j] for j in idx]
            log_w[:] = 0.0

    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    best = int(np.argmax(w))
    summary = particles[best].run(n_iter=50, burn_in=0, state=states[best])
    return dict(weights=w, best_particle=best,
                best_hyper=dict(pi=particles[best].pi,
                                tau_beta=particles[best].tau_beta,
                                sigma_eps=particles[best].sigma_eps),
                posterior=summary)


class _HMCTarget:
    """The conditional Gaussian target of :func:`hmc_refine` on the
    dataset's device: the energy, its gradient and the diagonal mass
    matrix (n/sigma_eps + tau_beta on the mask, 1 off it), for C chains."""

    def __init__(self, dataset, gamma_mask, tau_beta, sigma_eps, n_chains):
        lay = dataset.layout
        ld = self.ld = dataset.ld
        dev = dataset.device
        sb0, nf0 = dataset.device_inputs()
        nf = nf0[None]
        gmask = torch.from_numpy(lay.to_flat(gamma_mask).reshape(
            1, lay.nb, lay.block_size)).to(dev) * ld.mask[None]
        self.tau64 = float(tau_beta)
        sig, self.tau = np.float32(sigma_eps), np.float32(tau_beta)
        # the mass matrix preconditions the target so that the leapfrog
        # sees the LD correlations' spectrum, not the raw precision's
        m_diag = (nf / sig + self.tau) * gmask + (1.0 - gmask)
        self.inv_m = gmask / m_diag
        self.sqrt_m = torch.sqrt(m_diag)
        self.shape = (n_chains, lay.nb, lay.block_size)
        self.gmask, self.sb, nf = (x.expand(self.shape)
                                   for x in (gmask, sb0[None], nf))
        self.n_over_sig = nf / sig

    @staticmethod
    def sum64(x):
        # per-tile float32 sums, float64 across tiles: the Metropolis test
        # compares energies of ~1e6, where one float32 sum carries O(1)
        # noise
        return x.sum(dim=2).to(F64).sum(dim=1)

    def grad_energy(self, beta):
        Rb = compute_q(self.ld, beta) + beta
        return (self.n_over_sig * (Rb - self.sb) + self.tau * beta) \
            * self.gmask

    def energy(self, beta):
        Rb = compute_q(self.ld, beta) + beta
        quad = 0.5 * self.sum64(self.n_over_sig * beta * (Rb - 2.0 * self.sb))
        prior = 0.5 * self.tau64 * self.sum64(beta * beta)
        return quad + prior


def _hmc_step(tgt: _HMCTarget, beta, e_pot, eps, draws, n_lo, n_hi):
    """One proposal per chain, with a trajectory of L ~ U{n_lo, ..., n_hi}
    leapfrog steps of size ``eps`` (a float32 device scalar). The current
    state's potential energy is carried (e_pot): only the proposal pays an
    energy evaluation, and the leapfrog reuses endpoint gradients (L + 2
    LD products).

    :returns: (beta, e_pot, alpha): the next state, its energy and the
        (C,) float64 acceptance probabilities (0 for a divergent
        trajectory).
    """
    z, L, u = draws.hmc(tgt.shape, n_lo, n_hi)
    inv_m = tgt.inv_m
    p0 = z * tgt.sqrt_m * tgt.gmask
    h0 = e_pot + 0.5 * tgt.sum64(p0 * p0 * inv_m)
    b1, p1 = beta, p0 - 0.5 * eps * tgt.grad_energy(beta)
    for _ in range(L - 1):
        b1 = b1 + eps * p1 * inv_m
        p1 = p1 - eps * tgt.grad_energy(b1)
    b1 = b1 + eps * p1 * inv_m
    p1 = p1 - 0.5 * eps * tgt.grad_energy(b1)

    e1 = tgt.energy(b1)
    h1 = e1 + 0.5 * tgt.sum64(p1 * p1 * inv_m)
    zero = torch.zeros((), dtype=F64, device=e1.device)
    log_alpha = torch.minimum(h0 - h1, zero)
    alpha = torch.where(torch.isfinite(log_alpha), torch.exp(log_alpha), zero)
    accept = u < alpha
    return (torch.where(accept[:, None, None], b1, beta),
            torch.where(accept, e1, e_pot), alpha)


def hmc_refine(dataset, gamma_mask, pi=0.01, tau_beta=1000.0, sigma_eps=0.9,
               n_samples=100, n_leapfrog=10, step_size=None, seed=0,
               n_chains=4):
    """HMC on the slab coefficients given a fixed inclusion configuration.

    The conditional target is Gaussian:
        E(beta) = n/(2 sigma_eps) (beta' R beta - 2 beta_hat' beta)
                  + tau_beta/2 ||beta||^2,  restricted to gamma_mask == 1.

    A diagonal mass matrix, jittered trajectory lengths L ~
    U{ceil(n_leapfrog/2), ..., n_leapfrog} (fixed lengths resonate with a
    near-Gaussian target) and Nesterov dual averaging of the step size over
    the first half of the samples, towards an acceptance of 0.78. Energies
    are float32 sums within a tile and float64 across tiles; the dual
    averaging runs in float64. Everything stays on the dataset's device
    until the end.

    :returns: posterior mean/var of beta over the kept samples ({chrom:
        array}), the mean acceptance probability of the sampling and of the
        warm-up half, and the adapted step size.
    """
    lay = dataset.layout
    dev = dataset.device
    tgt = _HMCTarget(dataset, gamma_mask, tau_beta, sigma_eps, n_chains)
    eps0 = float(0.1 if step_size is None else step_size)
    n_lo = max(1, (n_leapfrog + 1) // 2)
    draws = _draw_source(seed, dev)

    n_warm = n_samples // 2
    delta = 0.78
    mu = np.log(10.0 * eps0)
    gamma_da, t0_da, kappa_da = 0.05, 10.0, 0.75

    beta = torch.zeros(tgt.shape, dtype=F32, device=dev)
    e_pot = tgt.energy(beta)
    log_eps = torch.full((), np.log(eps0), dtype=F64, device=dev)
    log_eps_bar = log_eps.clone()
    h_bar = torch.zeros((), dtype=F64, device=dev)
    alphas = []
    for it in range(n_warm):
        beta, e_pot, alpha = _hmc_step(tgt, beta, e_pot,
                                       torch.exp(log_eps).to(F32), draws,
                                       n_lo, n_leapfrog)
        alpha = alpha.mean()
        alphas.append(alpha)
        t = it + 1.0
        h_bar = (1.0 - 1.0 / (t + t0_da)) * h_bar \
            + (delta - alpha) / (t + t0_da)
        log_eps = mu - np.sqrt(t) / gamma_da * h_bar
        w = t ** (-kappa_da)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    eps_fin = torch.exp(log_eps_bar).to(F32)

    s1 = torch.zeros(tgt.shape[1:], dtype=F32, device=dev)
    s2 = torch.zeros(tgt.shape[1:], dtype=F32, device=dev)
    for _ in range(n_samples - n_warm):
        beta, e_pot, alpha = _hmc_step(tgt, beta, e_pot, eps_fin, draws,
                                       n_lo, n_leapfrog)
        alphas.append(alpha.mean())
        s1 = s1 + beta.sum(0)
        s2 = s2 + (beta * beta).sum(0)

    # one read: the sums, the acceptance probabilities and the step size
    kept = (n_samples - n_warm) * n_chains
    host = torch.cat([s1.reshape(-1).to(F64), s2.reshape(-1).to(F64),
                      torch.stack(alphas + [eps_fin.to(F64)])]).cpu().numpy()
    m = s1.numel()
    mean = host[:m] / kept
    second = host[m:2 * m] / kept
    alphas = host[2 * m:-1]
    return dict(post_mean_beta=lay.from_flat(mean),
                post_var_beta=lay.from_flat(second - mean ** 2),
                accept_rate=float(np.mean(alphas[n_warm:])),
                warmup_accept_rate=float(np.mean(alphas[:n_warm])),
                step_size=float(np.float32(host[-1])))
