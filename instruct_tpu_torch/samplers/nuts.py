"""Iterative NUTS (No-U-Turn Sampler) with multinomial trajectory
sampling, batched over chains.

Counterpart of ``instruct_tpu/samplers/nuts.py``: the iterative variant
(Phan et al. 2019, as in numpyro/blackjax).  The trajectory doubles up to
``max_depth``; each new subtree is built one leapfrog step at a time;
U-turns within a subtree are detected with checkpoint stacks, and the
proposal is drawn by progressive biased-multinomial sampling across
subtrees.

Checkpoint scheme (from the balanced-subtree structure): a leaf with even
index ``i`` starts every balanced interval closing later and is stored at
slot ``popcount(i >> 1)``; at an odd leaf ``b``, ``ctz(b+1)`` intervals
close, occupying the slots ``[idx_max - ctz(b+1) + 1, idx_max]`` with
``idx_max = popcount((b-1) >> 1)``.  For each, the segment momentum sum is
``msum_now - msum_ckpt + mom_ckpt`` and Betancourt's generalized U-turn
criterion is applied.

Batching: depth j and leaf i run in lockstep over the chains, so the
checkpoint slots are plain integers; a chain whose trajectory (or subtree)
has turned or diverged is frozen while the others go on, as JAX's
batched ``while_loop`` does.  A leapfrog step evaluates the gradient once
(the trajectory's ends and the proposal carry theirs), where the JAX
package evaluates it twice; the numbers are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.hmc import kinetic

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _ctz(x: int) -> int:
    """Count of trailing zeros of x > 0."""
    return (x & -x).bit_length() - 1


class _State(NamedTuple):
    """A point of phase space with its potential and gradient."""

    pos: object
    mom: object
    u: torch.Tensor
    grad: object


class _Traj(NamedTuple):
    """A trajectory's summary; every field per chain."""

    left: _State
    right: _State
    proposal: _State         # current multinomial sample (momentum unused)
    log_w: torch.Tensor      # logsumexp of -(H - H0) over the states
    sum_mom: object          # sum of momenta over the states
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor  # sum of min(1, exp(H0 - H)) for adaptation
    n_states: torch.Tensor


def _select(mask, a, b):
    """Row-wise select of two nested summaries; ``mask`` None: all rows of
    ``a``."""
    if mask is None:
        return a
    if isinstance(a, torch.Tensor):
        return torch.where(tr.rows(mask, a), a, b)
    return type(a)(*[_select(mask, x, y) for x, y in zip(a, b)])


def _partial(mask: torch.Tensor):
    """``mask`` when some row is False, None when all are True (then a
    select is the identity), False when none is True."""
    n = int(mask.sum())
    if n == 0:
        return False
    return None if n == mask.shape[0] else mask


def _is_turning(inv_mass, mom_sum, mom_first, mom_last):
    """Generalized U-turn criterion (Betancourt 2017): the metric
    projection of the segment momentum sum on both end momenta must stay
    positive."""
    v = tr.tmap(lambda im, m: im * m, inv_mass, mom_sum)
    return (tr.dot(v, mom_first) <= 0) | (tr.dot(v, mom_last) <= 0)


def _leapfrog(potential_grad, inv_mass, eps, s: _State) -> _State:
    half = 0.5 * eps
    mom = tr.tmap(lambda m, g: m - tr.rows(half, g) * g, s.mom, s.grad)
    pos = tr.tmap(lambda p, m, im: p + tr.rows(eps, m) * im * m, s.pos, mom,
                  inv_mass)
    u, g = potential_grad(pos)
    mom = tr.tmap(lambda m, gg: m - tr.rows(half, gg) * gg, mom, g)
    return _State(pos, mom, u, g)


class _Sub(NamedTuple):
    """A subtree being built: its newest state and its summary."""

    end: _State
    proposal: _State
    log_w: torch.Tensor
    sum_mom: object
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_states: torch.Tensor


def _build_subtree(potential_grad, inv_mass, step, max_depth, h0, j, traj,
                   direction, alive, u_leaf) -> _Sub:
    """Extend the trajectory's end in ``direction`` [B] (+-1) by a subtree
    of up to 2^j leapfrog steps, on the chains ``alive`` [B]; returns the
    subtree (not yet merged)."""
    fwd = direction > 0
    start = _select(fwd, traj.right, traj.left)
    b = direction.shape[0]
    dev = direction.device
    false = torch.zeros((b,), dtype=torch.bool, device=dev)
    sub = _Sub(end=start, proposal=start,
               log_w=torch.full((b,), -math.inf, device=dev),
               sum_mom=tr.tmap(torch.zeros_like, start.mom), turning=false,
               diverging=false, sum_accept=torch.zeros((b,), device=dev),
               n_states=torch.zeros((b,), dtype=torch.int64, device=dev))
    ck_mom = [None] * (max_depth + 1)
    ck_msum = [None] * (max_depth + 1)
    eps = step * direction
    for i in range(2 ** j):
        act = _partial(alive & ~sub.turning & ~sub.diverging)
        if act is False:
            break
        new = _leapfrog(potential_grad, inv_mass, eps, sub.end)
        h = new.u + kinetic(inv_mass, new.mom)
        delta = h - h0
        diverging = ~torch.isfinite(delta) | (delta > _MAX_DELTA_ENERGY)
        neg_inf = torch.full_like(delta, -math.inf)
        log_w_state = torch.where(diverging, neg_inf, -delta)
        accept_p = torch.where(diverging, torch.zeros_like(delta),
                               torch.clamp_max(torch.exp(-delta), 1.0))
        new_log_w = torch.logaddexp(sub.log_w, log_w_state)
        take = (torch.log(u_leaf[:, 2 ** j - 1 + i])
                < log_w_state - new_log_w)
        proposal = _select(take, new, sub.proposal)
        sum_mom = tr.tmap(lambda s, m: s + m, sub.sum_mom, new.mom)

        turning = sub.turning
        if i % 2 == 0:
            slot = _popcount(i >> 1)
            ck_mom[slot], ck_msum[slot] = new.mom, sum_mom
        else:
            # odd leaf: ctz(i+1) intervals close at slots
            # [idx_max - ctz(i+1) + 1, idx_max]
            idx_max = _popcount(max(i - 1, 0) >> 1)
            idx_min = idx_max - _ctz(i + 1) + 1
            for kk in range(max(idx_min, 0), min(idx_max, max_depth) + 1):
                seg = tr.tmap(lambda s, s0, m0: s - s0 + m0, sum_mom,
                              ck_msum[kk], ck_mom[kk])
                turning = turning | _is_turning(inv_mass, seg, ck_mom[kk],
                                                new.mom)
        sub = _select(act, _Sub(
            end=new, proposal=proposal, log_w=new_log_w, sum_mom=sum_mom,
            turning=turning, diverging=sub.diverging | diverging,
            sum_accept=sub.sum_accept + accept_p,
            n_states=sub.n_states + 1), sub)
    return sub


def nuts_transition(potential_grad, inv_mass, step, max_depth, position,
                    draws, start=None):
    """One NUTS draw of every chain.  ``step`` f32[B]; ``draws`` is what
    ``noise.nuts`` returns; ``start`` the (potential, gradient) at
    ``position`` when known.  Returns (new_position, mean_accept_prob f32[B],
    (potential, gradient) at the new position)."""
    mom_std, forward, u_sub, u_leaf = draws
    if start is None:
        start = potential_grad(position)
    u0, g0 = start
    sqrt_mass = tr.tmap(lambda im: 1.0 / torch.sqrt(im), inv_mass)
    mom0 = tr.tmap(lambda r, sm: r * sm,
                   tr.rebuild(position, mom_std), sqrt_mass)
    h0 = u0 + kinetic(inv_mass, mom0)
    b = u0.shape[0]
    dev = u0.device
    s0 = _State(position, mom0, u0, g0)
    traj = _Traj(left=s0, right=s0, proposal=s0,
                 log_w=torch.zeros((b,), device=dev), sum_mom=mom0,
                 turning=torch.zeros((b,), dtype=torch.bool, device=dev),
                 diverging=torch.zeros((b,), dtype=torch.bool, device=dev),
                 sum_accept=torch.zeros((b,), device=dev),
                 n_states=torch.ones((b,), dtype=torch.int64, device=dev))
    for j in range(max_depth):
        alive = ~traj.turning & ~traj.diverging
        act = _partial(alive)
        if act is False:
            break
        direction = torch.where(forward[:, j], 1.0, -1.0)
        sub = _build_subtree(potential_grad, inv_mass, step, max_depth, h0,
                             j, traj, direction, alive, u_leaf)
        # biased progressive sampling between old trajectory and subtree
        take = (torch.log(u_sub[:, j])
                < torch.clamp_max(sub.log_w - traj.log_w, 0.0))
        take = take & ~sub.turning & ~sub.diverging
        fwd = direction > 0
        left = _select(fwd, traj.left, sub.end)
        right = _select(fwd, sub.end, traj.right)
        sum_mom = tr.tmap(lambda x, y: x + y, traj.sum_mom, sub.sum_mom)
        turning = sub.turning | _is_turning(inv_mass, sum_mom, left.mom,
                                            right.mom)
        merged = _Traj(left=left, right=right,
                       proposal=_select(take, sub.proposal, traj.proposal),
                       log_w=torch.logaddexp(traj.log_w, sub.log_w),
                       sum_mom=sum_mom, turning=turning,
                       diverging=traj.diverging | sub.diverging,
                       sum_accept=traj.sum_accept + sub.sum_accept,
                       n_states=traj.n_states + sub.n_states)
        traj = _select(act, merged, traj)
    mean_accept = traj.sum_accept / torch.clamp_min(
        traj.n_states.to(torch.float32) - 1.0, 1.0)
    prop = traj.proposal
    return prop.pos, torch.clamp(mean_accept, 0.0, 1.0), (prop.u, prop.grad)


@dataclasses.dataclass
class NutsConfig:
    n_warmup: int = 300
    n_samples: int = 300
    max_depth: int = 8
    target_accept: float = 0.8
    init_step: float = 0.05


def run_nuts(potential: Callable, init_position, noise, config: NutsConfig,
             collect: Callable = lambda p: p):
    """NUTS on every chain of ``init_position`` (leaves [B, ...]) with
    Stan-style windowed warm-up (dual-averaging step size, then diagonal
    mass re-estimation and step re-adaptation, as in ``samplers/hmc.py``).
    Returns (samples: leaves [B, n_samples, ...], mean_accept f32[B],
    final_position)."""
    potential_grad = tr.value_and_grad(potential)
    b = tr.leaves(init_position)[0].shape[0]
    dev = tr.leaves(init_position)[0].device
    zeros = tr.tmap(torch.zeros_like, init_position)
    ones = tr.tmap(torch.ones_like, init_position)
    log10 = torch.log(torch.tensor(10.0, device=dev))

    def transition(pos, start, inv_mass, step, phase, i):
        draws = noise.nuts(phase, i, tr.leaves(pos), config.max_depth)
        return nuts_transition(potential_grad, inv_mass, step,
                               config.max_depth, pos, draws, start)

    def warmup_phase(pos, start, inv_mass, log_eps0, phase, n):
        mu = log10 + log_eps0
        log_eps, h, logeps_bar = log_eps0, torch.zeros_like(log_eps0), \
            log_eps0
        wmean, wm2 = zeros, zeros
        for i in range(n):
            pos, pa, start = transition(pos, start, inv_mass,
                                        torch.exp(log_eps), phase, i)
            cnt = torch.tensor(i + 1.0, device=dev)
            h = ((1.0 - 1.0 / (cnt + 10.0)) * h
                 + (config.target_accept - pa) / (cnt + 10.0))
            log_eps = mu - torch.sqrt(cnt) / 0.05 * h
            eta = cnt ** -0.75
            logeps_bar = eta * log_eps + (1 - eta) * logeps_bar
            delta = tr.tmap(lambda p, m: p - m, pos, wmean)
            wmean = tr.tmap(lambda m, d: m + d / cnt, wmean, delta)
            delta2 = tr.tmap(lambda p, m: p - m, pos, wmean)
            wm2 = tr.tmap(lambda m2, d, d2: m2 + d * d2, wm2, delta, delta2)
        var = tr.tmap(lambda m2: m2 / max(n - 1.0, 1.0), wm2)
        return pos, start, logeps_bar, var

    n1 = config.n_warmup // 2
    log_eps0 = torch.log(torch.full((b,), config.init_step, device=dev))
    start = potential_grad(init_position)
    pos, start, logeps_bar, var = warmup_phase(init_position, start, ones,
                                               log_eps0, 0, n1)
    inv_mass = tr.tmap(lambda v: torch.clamp_min(v, 1e-6), var)
    pos, start, logeps_bar, _ = warmup_phase(pos, start, inv_mass,
                                             logeps_bar, 1,
                                             config.n_warmup - n1)
    step = torch.exp(logeps_bar)
    samples, pas = [], []
    for i in range(config.n_samples):
        pos, pa, start = transition(pos, start, inv_mass, step, 2, i)
        samples.append(collect(pos))
        pas.append(pa)
    stacked = tr.tmap(lambda *xs: torch.stack(xs, dim=1), *samples) \
        if samples else None
    accept = (torch.stack(pas, dim=1).mean(dim=1) if pas
              else torch.full((b,), math.nan, device=dev))
    return stacked, accept, pos
