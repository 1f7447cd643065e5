"""High-level entry for the alternative inference engines (HMC / NUTS / SVI
/ SMC) over the marginalized model, with ``run_mcmc``'s call shape so the
command line can swap engines with one flag.

Counterpart of ``instruct_tpu/samplers/run.py``: the same schedule mapping
and the same report writer; the run's randomness is ``seed`` through
:class:`~instruct_tpu_torch.samplers.noise.PhiloxNoise` (its sub-runs told
apart by salt) instead of a JAX key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.hmc import HmcConfig, run_hmc
from instruct_tpu_torch.samplers.noise import PhiloxNoise
from instruct_tpu_torch.samplers.nuts import NutsConfig, run_nuts
from instruct_tpu_torch.samplers.potential import MarginalModel
from instruct_tpu_torch.samplers.smc import SmcConfig, run_smc
from instruct_tpu_torch.samplers.svi import SviConfig, run_svi

# salts of the sub-runs of one run_sampler call
SALT_RUN, SALT_INIT, SALT_WARM = 0, 1, 2


@dataclasses.dataclass
class SamplerResult:
    method: str
    s_mean: np.ndarray       # [K] (mode 2) or [0]
    s_var: np.ndarray
    q_mean: np.ndarray       # [N, K]
    q_var: np.ndarray
    extra: dict


def _svi_warm_start(model: MarginalModel, noise, n_chains: int):
    """Per-chain initial positions for the gradient samplers: one short
    SVI fit to locate the dominant posterior basin, then small per-chain
    jitter.  Mixture posteriors are multimodal (label permutations and
    genuine local modes -- e.g. the mode-4 F posterior traps cold-started
    trajectories at a spurious interior mode); a few hundred variational
    steps land in the main basin, and NUTS/HMC then agree with the Gibbs
    engine."""
    init = tr.tmap(lambda x: x[0], model.init(noise.child(SALT_INIT), 1))
    mu, _, _ = run_svi(model.log_joint, init, noise.child(SALT_WARM),
                       SviConfig(n_steps=400, learning_rate=0.05))
    jit = noise.jitter(tr.leaves(mu), n_chains)
    return tr.rebuild(mu, [m[None] + 0.02 * z
                           for m, z in zip(tr.leaves(mu), jit)])


def _moments(draws: torch.Tensor, *tail):
    """Mean and variance over every draw (chains and samples) of draws
    [..., *tail]; ``tail`` may hold a 0 (mode 1 has no rates)."""
    d = draws.detach().cpu().numpy()
    lead = d.ndim - len(tail)
    d = d.reshape((int(np.prod(d.shape[:lead])),) + tuple(tail))
    return d.mean(0), d.var(0)


def _schedule_config(method: str, sched: Schedule):
    """The engine's configuration for a Gibbs schedule (the JAX package's
    mapping)."""
    n_warmup = min(500, max(50, sched.burnin))
    n_samples = min(1000, max(100, sched.n_stored))
    if method == "hmc":
        return HmcConfig(n_warmup=n_warmup, n_samples=n_samples,
                         n_leapfrog=16, init_step=0.02)
    if method == "nuts":
        return NutsConfig(n_warmup=n_warmup, n_samples=n_samples,
                          max_depth=8, init_step=0.02)
    if method == "svi":
        return SviConfig(n_steps=min(2000, max(300, sched.n_iter)),
                         learning_rate=0.02)
    if method == "smc":
        return SmcConfig(n_particles=max(64, max(1, sched.n_chains) * 32),
                         n_temps=20, n_mh_steps=5, rw_scale=0.05)
    raise ValueError(f"unknown sampler {method}")


def run_sampler(method: str, data: Dataset, spec: ModelSpec,
                sched: Schedule, seed: int, *, device="cuda",
                config=None) -> SamplerResult:
    """Run ``method`` (hmc, nuts, svi or smc) on the panel with the Philox
    draws of ``seed``.  ``config`` replaces the engine's configuration
    that the schedule maps to (a short run)."""
    cfg = _schedule_config(method, sched) if config is None else config
    device = torch.device(device)
    model = MarginalModel(spec, data.to(device))
    noise = PhiloxNoise(seed, device)
    n_chains = max(1, sched.n_chains)
    r, n, k = model.n_rates, data.n_indv, spec.n_pops

    def collect(p):
        return model.selfing_rates(p), model.admixture(p)

    if method in ("hmc", "nuts"):
        inits = _svi_warm_start(model, noise, n_chains)
        run = run_hmc if method == "hmc" else run_nuts
        (s_draws, q_draws), accept, _ = run(
            model.potential, inits, noise.child(SALT_RUN), cfg,
            collect=collect)
        s_mean, s_var = _moments(s_draws, r)
        q_mean, q_var = _moments(q_draws, n, k)
        return SamplerResult(method, s_mean, s_var, q_mean, q_var,
                             {"accept_rate": accept.cpu().numpy().tolist()})

    if method == "svi":
        init = tr.tmap(lambda x: x[0], model.init(noise.child(SALT_INIT), 1))
        mu, log_sigma, elbo = run_svi(model.log_joint, init,
                                      noise.child(SALT_RUN), cfg)
        # posterior moments by sampling the variational distribution
        eps = noise.draws(tr.leaves(mu), 256)
        z = tr.rebuild(mu, [m[None] + torch.exp(ls)[None] * e for m, ls, e
                            in zip(tr.leaves(mu), tr.leaves(log_sigma),
                                   eps)])
        s_mean, s_var = _moments(model.selfing_rates(z), r)
        q_mean, q_var = _moments(model.admixture(z), n, k)
        return SamplerResult("svi", s_mean, s_var, q_mean, q_var,
                             {"final_elbo": float(elbo[-1])})

    if method == "smc":
        init = model.init(noise.child(SALT_INIT), cfg.n_particles)
        parts, logz, ess = run_smc(model.log_joint, model.log_prior, init,
                                   noise.child(SALT_RUN), cfg)
        s_mean, s_var = _moments(model.selfing_rates(parts), r)
        q_mean, q_var = _moments(model.admixture(parts), n, k)
        return SamplerResult("smc", s_mean, s_var, q_mean, q_var,
                             {"log_evidence": float(logz),
                              "min_ess": float(ess.min())})

    raise ValueError(f"unknown sampler {method}")


def write_sampler_report(path: str, panel, spec: ModelSpec,
                         result: SamplerResult, argv=None) -> None:
    """The JAX package's sampler report, byte for byte."""
    with open(path, "w") as fh:
        fh.write(f"instruct_tpu {result.method.upper()} inference "
                 f"(marginalized model, mode {spec.mode})\n")
        if argv:
            fh.write("Command line arguments:\n    " + " ".join(argv)
                     + "\n")
        for k, v in result.extra.items():
            fh.write(f"{k} = {v}\n")
        if result.s_mean.size:
            fh.write("\nThe Posterior distribution of Selfing Rates:\n")
            fh.write("\t\tMean\tVar\n")
            for j in range(result.s_mean.size):
                fh.write(f"Cluster {j + 1}\t{result.s_mean[j]:.3f}\t"
                         f"{result.s_var[j]:.3f}\n")
        fh.write("\nInferred ancestry of individuals:\n")
        for i in range(result.q_mean.shape[0]):
            name = (panel.indv_names[i] if panel.indv_names else str(i + 1))
            fh.write(f"{i + 1}\t{name}\t: "
                     + " ".join(f"{v:.3f}" for v in result.q_mean[i])
                     + "\n")
