"""Stochastic variational inference (ADVI) over the marginalized model.

Counterpart of ``instruct_tpu/samplers/svi.py``: a mean-field Gaussian in
unconstrained space, reparameterized ELBO gradients, Adam (optax's
``adam`` there, ``torch.optim.Adam`` here with the same b1, b2 and eps).
The ``n_elbo_samples`` draws are the batch axis of the target.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from instruct_tpu_torch.samplers import tree as tr

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class SviConfig:
    n_steps: int = 500
    n_elbo_samples: int = 4
    learning_rate: float = 0.02


def run_svi(log_joint: Callable, init_position, noise, config: SviConfig):
    """Fit the Gaussian to ``log_joint`` (which maps a position with leaves
    [S, ...] to f32[S]) from ``init_position`` (leaves without a batch
    axis), with the draws of ``noise.svi``.  Returns (variational mean tree,
    log-std tree, ELBO trace f32[n_steps])."""
    mu = [x.detach().clone().requires_grad_(True)
          for x in tr.leaves(init_position)]
    log_sigma = [torch.full_like(m, -3.0).requires_grad_(True) for m in mu]
    opt = torch.optim.Adam(mu + log_sigma, lr=config.learning_rate,
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    trace = []
    for i in range(config.n_steps):
        eps = noise.svi(i, mu, config.n_elbo_samples)
        with torch.enable_grad():
            z = [m[None] + torch.exp(ls)[None] * e
                 for m, ls, e in zip(mu, log_sigma, eps)]
            # entropy of the Gaussian: sum(log_sigma) + const
            ent = sum(ls.sum() for ls in log_sigma)
            loss = -torch.mean(
                log_joint(tr.rebuild(init_position, z)) + ent)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        tr.counts["grad_evals"] += 1
        opt.step()
        trace.append(loss.detach())
    elbo = -torch.stack(trace) if trace else torch.zeros(0)
    return (tr.rebuild(init_position, [m.detach() for m in mu]),
            tr.rebuild(init_position, [ls.detach() for ls in log_sigma]),
            elbo)
