"""Chain driver: all chains in lockstep, a Python step loop that never
synchronises with the host, and a keyed retry of unhealthy chains.

Counterpart of ``instruct_tpu/mcmc/driver.py`` (``RunResult`` :36,
``unhealthy_flags`` :156, ``_chain_runner`` :168, ``run_mcmc`` :252,
``_plugin_loglik`` :671).  The JAX package ``vmap``s one chain's
``lax.scan`` over chains; here the chain axis is written out on every state
tensor, so each kernel launch serves all chains.

Whether a step is stored, and whether the marginal log-lik is due, is
integer arithmetic on the step index; every accept and the empty-cluster
latch are ``torch.where`` on device tensors.  The only reads of device
values are at the end of a run (:func:`unhealthy_flags`).  A chain flagged
by the empty-cluster guard or by a non-finite log-lik is rerun with a fresh
chain key, mirroring the ``chn--`` retry (InStruct.c:185-190); unflagged
chains replay their own keys, so the retry is deterministic.

Still to be ported: device meshes, checkpoint/resume, progress and JSONL
reporting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.mcmc.accumulators import (ChainAccum, accum_update,
                                                  extract_stats, init_accum,
                                                  variance)
from instruct_tpu_torch.mcmc.state import McmcState, init_state
from instruct_tpu_torch.mcmc.step import (build_marg_loglik,
                                          build_step_parts, check_supported,
                                          nopop_marginal)
from instruct_tpu_torch.model import likelihood as lk
from instruct_tpu_torch.tetra import engine as te


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class RunResult:
    """Posterior summaries for all chains (leading axis = chain)."""

    accum: ChainAccum          # streaming moments per chain
    final_state: McmcState     # last draw per chain
    n_retries: int
    plugin_ll: Optional[np.ndarray] = None  # per-chain Z-marginalized
    #   log-lik at the posterior means (the plug-in term of the corrected
    #   DIC); filled when the run tracked P (track_freq)

    @property
    def posterior_mean(self):
        return self.accum.mean

    @property
    def posterior_var(self):
        return variance(self.accum)

    def dic_reference(self) -> np.ndarray:
        """Per-chain DIC exactly as the reference computes it
        (print_lkh_to_file, result_analysis.c:403-411):
        -4 E[logL] + 2 sum_j E[logL_j], which degenerates to -2 E[logL]."""
        mean_total = _np(self.accum.mean.total_ll)
        mean_indv = _np(self.accum.mean.indv_ll).sum(axis=-1)
        return -4.0 * mean_total + 2.0 * mean_indv

    def _dbar_dplug(self):
        dbar = -2.0 * _np(self.accum.mean.ll_marg).sum(axis=-1)
        return dbar, -2.0 * np.asarray(self.plugin_ll)

    def dic(self) -> np.ndarray:
        """Per-chain corrected DIC = Dbar + pD = -4 E[logL] + 2
        logL(theta_bar), both terms on the Z-marginalized focus; falls
        back to the reference-compatible formula when the plug-in is
        unavailable (the run did not track P)."""
        if self.plugin_ll is None:
            return self.dic_reference()
        dbar, dplug = self._dbar_dplug()
        return 2.0 * dbar - dplug

    def p_d(self) -> Optional[np.ndarray]:
        """Effective number of parameters pD = Dbar - D(theta_bar)
        (Spiegelhalter et al. 2002); None when no plug-in is available."""
        if self.plugin_ll is None:
            return None
        dbar, dplug = self._dbar_dplug()
        return dbar - dplug

    def _waic_terms(self):
        """(lppd_i, pwaic_i) per chain and individual, or None when the
        log-mean-exp accumulator is empty or non-finite."""
        lme = _np(self.accum.lme_indv)
        if lme.size == 0 or not np.isfinite(lme).all():
            return None
        count = np.maximum(_np(self.accum.count).astype(np.float64), 1.0)
        return lme, _np(self.accum.m2_ll_marg) / count[..., None]

    def waic(self) -> Optional[np.ndarray]:
        """Per-chain WAIC (Watanabe 2010):
        -2 sum_i ( log E[p(y_i|theta)] - Var[log p(y_i|theta)] )."""
        t = self._waic_terms()
        return None if t is None else (-2.0 * t[0].sum(axis=-1)
                                       + 2.0 * t[1].sum(axis=-1))

    def p_waic(self) -> Optional[np.ndarray]:
        """pwaic_2 = sum_i Var[log p(y_i|theta)]."""
        t = self._waic_terms()
        return None if t is None else t[1].sum(axis=-1)

    def waic_indv(self) -> Optional[np.ndarray]:
        """Per-chain, per-individual WAIC contributions
        -2 (lppd_i - pwaic_i)."""
        t = self._waic_terms()
        return None if t is None else -2.0 * (t[0] - t[1])

    def waic_se(self) -> Optional[float]:
        """Standard error of WAIC: sqrt(N) * sd over individuals of the
        chain-averaged per-individual contributions."""
        wi = self.waic_indv()
        if wi is None:
            return None
        return float(np.sqrt(wi.shape[-1]) * wi.mean(axis=0).std())


def unhealthy_flags(state: McmcState, accum: ChainAccum) -> np.ndarray:
    """Per-chain failure flags: the reference's empty-cluster guard
    (mcmc.c:1944-1974) plus numeric health -- a chain whose stored log-lik
    moments or final state went NaN/Inf is discarded and rerun.  This is
    the run's one read of device values."""
    bad = (accum.empty_cluster
           | ~torch.isfinite(accum.mean.total_ll)
           | ~torch.isfinite(state.loglik_total))
    return _np(bad)


def _run_chains(data: Dataset, spec: ModelSpec, sched: Schedule, seed: int,
                chain_key, init_rates, track_freq: bool, device,
                tetra_tables=None, active=None):
    """One attempt: initialise all chains and run the whole schedule."""
    n_chains = sched.n_chains
    keys = px.make_keys(seed, n_chains, device, chain_key=chain_key)
    state = init_state(seed, spec, data, n_chains, init_rates, device,
                       chain_key=chain_key, tetra_tables=tetra_tables,
                       active=active)
    accum = init_accum(spec, sched, data, track_freq, n_chains, device)
    step_core, add_loglik = build_step_parts(spec, data, tetra_tables)
    add_marg = build_marg_loglik(spec, data, tetra_tables)
    # diploid mode 0 has no Q to run empty: the guard never latches
    # (mcmc.c:111-115); the tetraploid engine always has one
    check_at = (-1 if (spec.mode == 0 and spec.ploid == 2)
                else sched.nstep_check_empty_cluster)
    last = sched.n_iter - 1
    for i in range(sched.n_iter):
        state = step_core(state, keys, i)
        stored = (i >= sched.burnin
                  and (i + 1 - sched.burnin) % sched.thinning == 0)
        # cal_lkh only when the draw is consumed (stored) or reported
        # (run end): it is an observable, no update conditions on it
        if stored or i == last:
            state = add_loglik(state)
        if stored:
            nth = (i + 1 - sched.burnin) // sched.thinning - 1
            if nth % sched.dic_every == 0:
                state = add_marg(state)
            stats = extract_stats(spec, state, track_freq)
            accum = accum_update(accum, stats, 1,
                                 up.empty_cluster_flag(stats.q, state.active),
                                 check_at)
    return state, accum


def active_mask(active_pops, spec: ModelSpec, n_chains: int,
                device) -> torch.Tensor:
    """The K grid's active-pop mask f32[C, K] from ``active_pops``, checked:
    diploid only (the tetraploid engine runs its K values one by one, as the
    JAX package does), 0/1 values, each chain's active slots leading and at
    least one of them."""
    if spec.ploid != 2:
        raise ValueError("active_pops (the padded K-selection grid) supports "
                         "the diploid modes 0-5 only; the tetraploid sweep "
                         "runs per K")
    act = np.asarray(active_pops, np.float32)
    if act.shape != (n_chains, spec.n_pops):
        raise ValueError(f"active_pops: expected shape "
                         f"{(n_chains, spec.n_pops)}, got {act.shape}")
    n_act = act.sum(axis=1)
    leading = np.arange(spec.n_pops)[None] < n_act[:, None]
    if not np.isin(act, (0.0, 1.0)).all() or not (
            (act > 0) == leading).all() or (n_act < 1).any():
        raise ValueError("active_pops: each chain's row must be 1.0 on its "
                         "leading active slots (at least one) and 0.0 after")
    return torch.as_tensor(act, device=device)


def run_mcmc(data: Dataset, spec: ModelSpec, sched: Schedule, seed: int,
             init_rates=None, track_freq: bool = False,
             max_retries: int = 10, device="cuda",
             active_pops=None) -> RunResult:
    """Run ``sched.n_chains`` chains on ``device`` and return streaming
    posterior moments.

    ``seed`` is the run's 64-bit integer seed: together with a chain's key
    and the step index it determines every draw, so two runs from one seed
    are bitwise equal.  ``init_rates`` optionally gives per-chain initial S
    or F vectors [n_chains, R], R = ``spec.n_rates(N)`` (the role of the
    ``-i`` initial file, initial.c:38-126); otherwise each chain draws
    U(0, 1) starts.  ``spec.ploid == 4`` runs the tetraploid engine
    (``tetra/engine.py``) on a panel with ``distinct`` / ``n_distinct``.

    ``active_pops`` optionally gives a per-chain active-pop mask
    [n_chains, K] (1.0 = slot in use, the active slots leading): the padded
    (chain x K) K-selection grid (``kselect.py``) runs every K value's
    chains as replicas of ONE run at K_max shapes, each Gibbs-sampling only
    its active slots (q and z put exactly zero mass on the others).
    Diploid modes 0-5.
    """
    check_supported(spec, data)
    dev = torch.device(device)
    n_chains = sched.n_chains
    active = (None if active_pops is None
              else active_mask(active_pops, spec, n_chains, dev))
    data = data.to(dev)
    if init_rates is not None:
        init_rates = np.asarray(init_rates, np.float32).reshape(n_chains, -1)

    # the tetraploid engine's data-only tables, built once per run
    tables = te.build_tables(spec, data) if spec.ploid == 4 else None
    chain_key = list(range(n_chains))
    state, accum = _run_chains(data, spec, sched, seed, chain_key,
                               init_rates, track_freq, dev, tables, active)
    retries = 0
    flags = unhealthy_flags(state, accum)
    while flags.any() and retries < max_retries:
        retries += 1
        # flagged chains get a fresh key; the others replay theirs
        chain_key = [10_000 * retries + c if flags[c] else chain_key[c]
                     for c in range(n_chains)]
        state, accum = _run_chains(data, spec, sched, seed, chain_key,
                                   init_rates, track_freq, dev, tables,
                                   active)
        flags = unhealthy_flags(state, accum)
    if flags.any():
        print(f"[instruct_tpu_torch] WARNING: {int(flags.sum())} chain(s) "
              f"still unhealthy after {retries} retries (empty cluster or "
              "non-finite log-likelihood); results include them",
              flush=True)

    plugin_ll = None
    if track_freq and spec.ploid == 4:
        plugin_ll = _np(te.plugin_loglik(spec, data, accum.mean, state,
                                         tables))
    elif track_freq:
        plugin_ll = _plugin_loglik(spec, data, accum, active)
    return RunResult(accum=accum, final_state=state, n_retries=retries,
                     plugin_ll=plugin_ll)


def _plugin_loglik(spec: ModelSpec, data: Dataset, accum: ChainAccum,
                   active=None) -> np.ndarray:
    """Per-chain Z-marginalized log-lik at the posterior means: the
    D(theta_bar) pass of the corrected DIC (means of Dirichlet draws are
    simplex-valid by linearity, and genofreq's closed form accepts the
    real-valued posterior-mean generations).  Under the K grid's mask
    ``active`` mode 0 mixes over the active slots; in modes 1-5 inactive
    slots carry no q mass, so the marginal needs no mask."""
    m = accum.mean
    if spec.mode == 0:
        # the uniform mixture over the (active) single-pop log-liks
        return _np(nopop_marginal(spec, data, m.freq, active).sum(dim=-1))
    return _np(lk.marginal_indv_loglik(spec, data, m.freq, m.q, m.gen,
                                       m.rates).sum(dim=-1))
