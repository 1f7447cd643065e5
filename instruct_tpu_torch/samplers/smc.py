"""Tempered sequential Monte Carlo with systematic resampling.

Counterpart of ``instruct_tpu/samplers/smc.py``.  The particles are the
batch axis of the target.  The marginalized posterior p(theta)^beta is
annealed from the prior (beta = 0) to the posterior (beta = 1) on a fixed
ladder, with a few random-walk MH steps per temperature.  No gradient.

The JAX package evaluates the current particles' terms again at every MH
step; here each particle's log-prior and log-likelihood are carried with
it (through the resampling gather and the accepts), so a temperature
evaluates the target once an MH step, on the proposals.  The numbers are
the same: a particle's terms do not depend on the batch it is evaluated in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from instruct_tpu_torch.samplers import tree as tr


@dataclasses.dataclass
class SmcConfig:
    n_particles: int = 128
    n_temps: int = 20
    n_mh_steps: int = 5
    rw_scale: float = 0.02


def _systematic_resample(u, log_w, n: int) -> torch.Tensor:
    """Systematic resampling: one uniform ``u``, stratified positions,
    inverse CDF by ``searchsorted``; indices int64[n]."""
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    pos = (u + torch.arange(n, dtype=torch.float32, device=log_w.device)) / n
    return torch.clamp(torch.searchsorted(cum, pos), 0, n - 1)


def run_smc(log_joint: Callable, log_prior: Callable, init_particles,
            noise, config: SmcConfig):
    """``init_particles``: a tree with leaves [n_particles, ...] (drawn
    from the prior).  Returns (final particles, log marginal-likelihood
    estimate f32[], effective sample size per temperature f32[n_temps])."""
    n = config.n_particles
    dev = tr.leaves(init_particles)[0].device
    betas = torch.linspace(0.0, 1.0, config.n_temps + 1, device=dev)[1:]
    prev = torch.cat([torch.zeros(1, device=dev), betas[:-1]])

    def terms(theta):
        lp = log_prior(theta)
        tr.counts["evals"] += 1
        return lp, log_joint(theta) - lp

    def mutate(temp, particles, lp, ll, beta):
        """Random-walk MH targeting prior * like^beta."""
        for k in range(config.n_mh_steps):
            z, u = noise.smc_mutation(temp, k, tr.leaves(particles))
            prop = tr.tmap(lambda x, e: x + config.rw_scale * e, particles,
                           tr.rebuild(particles, z))
            lp_p, ll_p = terms(prop)
            acc = torch.log(u) < (lp_p + beta * ll_p) - (lp + beta * ll)
            particles = tr.where(acc, prop, particles)
            lp = torch.where(acc, lp_p, lp)
            ll = torch.where(acc, ll_p, ll)
        return particles, lp, ll

    with torch.no_grad():
        particles = init_particles
        lp, ll = terms(particles)
        logz = torch.zeros((), device=dev)
        esses = []
        for i in range(config.n_temps):
            beta = betas[i]
            incr = (beta - prev[i]) * ll
            lse = torch.logsumexp(incr, dim=0)
            logz = logz + lse - math.log(float(n))
            log_w = incr - lse
            esses.append(torch.exp(-torch.logsumexp(2.0 * log_w, dim=0)))
            idx = _systematic_resample(noise.smc_resample(i), log_w, n)
            particles = tr.tmap(lambda x: x[idx], particles)
            particles, lp, ll = mutate(i, particles, lp[idx], ll[idx], beta)
    return particles, logz, torch.stack(esses)
