"""HMC over the marginalized continuous block, batched over chains.

Counterpart of ``instruct_tpu/samplers/hmc.py``.  The chains are the
leading axis of every leaf of the position (the JAX package vmaps a
single-chain sampler).  Warm-up runs dual-averaging step-size adaptation
(target accept 0.8) and diagonal mass estimation from the warm-up draws
(Welford) in two windows, Stan-style: window 1 adapts the step under the
identity mass, then the mass is set from window 1's variances and the step
re-adapted under it.  ``jitter_steps`` draws each trajectory's length
uniformly in 1..2 n_leapfrog (ChEES-style).

Batching: a transition runs the leapfrog loop to the longest chain's
length and freezes the chains that are done, so a chain's numbers do not
depend on the others (JAX's batched-predicate semantics).  Each leapfrog
step evaluates the gradient once: the gradient at the end of one step is
the start of the next, and the potential and gradient at the accepted
position carry into the next transition (the JAX package evaluates them
again; the numbers are the same).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from instruct_tpu_torch.samplers import tree as tr


class HmcState(NamedTuple):
    position: object          # tree, leaves [B, ...]
    log_step: torch.Tensor    # [B]
    inv_mass: object          # tree, diagonal
    # dual averaging state
    da_mu: torch.Tensor       # shrink target log(10 * eps0) per window
    da_h: torch.Tensor
    da_logeps_bar: torch.Tensor
    da_count: torch.Tensor
    # running moments for mass adaptation
    wf_mean: object
    wf_m2: object
    wf_n: torch.Tensor
    # potential and gradient at the position
    u: torch.Tensor
    grad: object


@dataclasses.dataclass
class HmcConfig:
    n_warmup: int = 200
    n_samples: int = 200
    n_leapfrog: int = 16
    target_accept: float = 0.8
    init_step: float = 0.05
    jitter_steps: bool = True   # ChEES-style random trajectory lengths


def kinetic(inv_mass, mom) -> torch.Tensor:
    return 0.5 * tr.dot(tr.tmap(lambda m, im: m * im, mom, inv_mass), mom)


def leapfrog(potential_grad, position, momentum, grad, u, inv_mass, step,
             n_steps):
    """``n_steps`` [B] leapfrog steps of size ``step`` [B] from (position,
    momentum) with the gradient ``grad`` and potential ``u`` there; the
    chains past their own count stay where they are.  Returns (position,
    momentum, u, grad) at the end."""
    n_min, n_max = (int(v) for v in torch.aminmax(n_steps))
    for i in range(n_max):
        half = 0.5 * step
        mom = tr.tmap(lambda m, g: m - tr.rows(half, g) * g, momentum, grad)
        pos = tr.tmap(lambda p, m, im: p + tr.rows(step, m) * im * m,
                      position, mom, inv_mass)
        u_new, g_new = potential_grad(pos)
        mom = tr.tmap(lambda m, g: m - tr.rows(half, g) * g, mom, g_new)
        if i >= n_min:
            active = i < n_steps
            pos, mom, g_new = (tr.where(active, pos, position),
                               tr.where(active, mom, momentum),
                               tr.where(active, g_new, grad))
            u_new = torch.where(active, u_new, u)
        position, momentum, grad, u = pos, mom, g_new, u_new
    return position, momentum, u, grad


def run_hmc(potential: Callable, init_position, noise, config: HmcConfig,
            collect: Callable = lambda p: p):
    """HMC on every chain of ``init_position`` (leaves [B, ...]) with the
    draws of ``noise`` (``samplers/noise.py``).  ``potential`` maps a
    position to f32[B].

    Returns (samples: ``collect``'s tree with leaves [B, n_samples, ...],
    accept_rate f32[B], final HmcState)."""
    potential_grad = tr.value_and_grad(potential)
    pos0 = init_position
    b = tr.leaves(pos0)[0].shape[0]
    dev = tr.leaves(pos0)[0].device
    zeros = tr.tmap(torch.zeros_like, pos0)
    ones = tr.tmap(torch.ones_like, pos0)

    def full(v):
        return torch.full((b,), v, dtype=torch.float32, device=dev)

    log_eps0 = torch.log(full(config.init_step))
    log10 = torch.log(torch.tensor(10.0, device=dev))
    u0, g0 = potential_grad(pos0)
    state = HmcState(
        position=pos0, log_step=log_eps0, inv_mass=ones,
        da_mu=log10 + log_eps0, da_h=full(0.0), da_logeps_bar=log_eps0,
        da_count=full(0.0), wf_mean=zeros, wf_m2=zeros, wf_n=full(0.0),
        u=u0, grad=g0)

    def transition(state: HmcState, phase: int, i: int, adapt: bool):
        mom_std, u_acc, jit = noise.hmc(phase, i, tr.leaves(state.position),
                                        2 * config.n_leapfrog)
        mom_std = tr.rebuild(state.position, mom_std)
        step = torch.exp(state.log_step)
        if config.jitter_steps:
            n_steps = 1 + jit
        else:
            n_steps = torch.full((b,), config.n_leapfrog, device=dev)
        sqrt_mass = tr.tmap(lambda im: 1.0 / torch.sqrt(im), state.inv_mass)
        mom = tr.tmap(lambda r, sm: r * sm, mom_std, sqrt_mass)
        h0 = state.u + kinetic(state.inv_mass, mom)
        new_pos, new_mom, u1, g1 = leapfrog(
            potential_grad, state.position, mom, state.grad, state.u,
            state.inv_mass, step, n_steps)
        h1 = u1 + kinetic(state.inv_mass, new_mom)
        log_accept = torch.clamp_max(h0 - h1, 0.0)
        log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                                 torch.full_like(log_accept, -math.inf))
        accept = torch.log(u_acc) < log_accept
        position = tr.where(accept, new_pos, state.position)
        u = torch.where(accept, u1, state.u)
        grad = tr.where(accept, g1, state.grad)
        p_accept = torch.exp(log_accept)

        # dual averaging (Hoffman & Gelman 2014, eqs. 6-7)
        count = state.da_count + 1.0
        h = ((1.0 - 1.0 / (count + 10.0)) * state.da_h
             + (config.target_accept - p_accept) / (count + 10.0))
        log_eps = state.da_mu - torch.sqrt(count) / 0.05 * h
        eta = count ** -0.75
        logeps_bar = eta * log_eps + (1 - eta) * state.da_logeps_bar
        log_step = log_eps if adapt else state.da_logeps_bar

        # Welford moments of the position for the diagonal mass
        wf_n = state.wf_n + 1.0
        delta = tr.tmap(lambda p, m: p - m, position, state.wf_mean)
        wf_mean = tr.tmap(lambda m, d: m + d / tr.rows(wf_n, d),
                          state.wf_mean, delta)
        delta2 = tr.tmap(lambda p, m: p - m, position, wf_mean)
        wf_m2 = tr.tmap(lambda m2, d, d2: m2 + d * d2, state.wf_m2, delta,
                        delta2)
        return HmcState(
            position=position, log_step=log_step, inv_mass=state.inv_mass,
            da_mu=state.da_mu, da_h=h if adapt else state.da_h,
            da_logeps_bar=logeps_bar if adapt else state.da_logeps_bar,
            da_count=count if adapt else state.da_count,
            wf_mean=wf_mean, wf_m2=wf_m2, wf_n=wf_n, u=u,
            grad=grad), p_accept

    # Window 1: adapt the step size under the identity mass.
    n1 = config.n_warmup // 2
    for i in range(n1):
        state, _ = transition(state, 0, i, True)

    # Set the diagonal mass from window 1's variances, then RE-ADAPT the
    # step size under the new metric (Stan's windowed scheme).
    var = tr.tmap(lambda m2: m2 / tr.rows(
        torch.clamp_min(state.wf_n - 1.0, 1.0), m2), state.wf_m2)
    inv_mass = tr.tmap(lambda v: torch.clamp_min(v, 1e-6), var)
    state = state._replace(
        inv_mass=inv_mass, da_mu=log10 + state.da_logeps_bar,
        da_h=full(0.0), da_count=full(0.0), wf_mean=zeros, wf_m2=zeros,
        wf_n=full(0.0))
    for i in range(config.n_warmup - n1):
        state, _ = transition(state, 1, i, True)
    state = state._replace(log_step=state.da_logeps_bar)

    samples, pas = [], []
    for i in range(config.n_samples):
        state, pa = transition(state, 2, i, False)
        samples.append(collect(state.position))
        pas.append(pa)
    stacked = tr.tmap(lambda *xs: torch.stack(xs, dim=1), *samples) \
        if samples else None
    accept = (torch.stack(pas, dim=1).mean(dim=1) if pas
              else torch.full((b,), math.nan, device=dev))
    return stacked, accept, state
