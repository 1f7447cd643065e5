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

With ``checkpoint_dir``, ``progress_every`` or ``jsonl_log`` the run is
segmented (JAX ``driver.py:500-646``): segments end at multiples of
``min(checkpoint_every, progress_every, n_iter)``, and only there does the
host read device values -- to print the progress block, append the JSONL
record and save the (states, accums, chain keys) payload
(``checkpoint.py``) at every multiple of ``checkpoint_every`` and at the
end.  A fresh call with the same arguments resumes from the latest
checkpoint bitwise: Philox draws are keyed on (seed, chain key, step), and
the carried ``zcounts`` are recounted from the restored z by K4.  A retry
of a checkpointed run saves under its own ``retry-<n>`` namespace.

With ``mesh`` (``parallel/mesh.py``: one process a rank over
``torch.distributed``) the chains are split over the mesh's chain axis and
the loci over its data axis (JAX ``driver.py:303-496``): each rank runs its
chain rows under their global chain keys on its own loci block
(``parallel/loci_shard.py:shard_panel``), the sweeps add the per-individual
sums over the rank's data group, and at the end every rank gathers the
whole ``RunResult`` in the unsharded layout.  ``mesh_mode="gspmd"`` has no
counterpart and is refused; the unsharded run gives its result.

Under a ``torch.profiler`` session a call records its phases as spans
(``spans.py``): ``mcmc.run`` the whole call, ``mcmc.init`` an attempt's
initial draws, ``mcmc.sweep`` a sweep, ``mcmc.stored`` a stored step with
its ``mcmc.marg_loglik`` refresh, ``mcmc.loglik`` a segment end's pass,
``mcmc.segment_end`` the checkpoint and progress, ``mcmc.finish`` the
flags, the retries, the gather and the plug-in pass.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from instruct_tpu_torch import checkpoint as ckpt
from instruct_tpu_torch import spans
from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import marg_loglik as mk
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.mcmc.accumulators import (ChainAccum, accum_update,
                                                  extract_stats, init_accum,
                                                  variance)
from instruct_tpu_torch.mcmc.state import McmcState, init_state
from instruct_tpu_torch.mcmc.step import (build_marg_loglik,
                                          build_step_parts, check_supported,
                                          nopop_marginal)
from instruct_tpu_torch.parallel import loci_shard as ls
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


def _chain_runner(data: Dataset, spec: ModelSpec, sched: Schedule,
                  track_freq: bool, tetra_tables=None, mesh=None):
    """``run_segment(state, accum, keys, start, stop)``: sweeps ``start`` to
    ``stop - 1`` of all chains, the unit of both the single-shot and the
    segmented run.  The log-lik is evaluated on stored steps and at the
    segment's last step (JAX ``driver.py:225-233``): it is an observable,
    so where segments end changes no draw and no moment.  Spans
    (``spans.py``): ``mcmc.sweep`` a sweep, ``mcmc.stored`` a stored step's
    passes and moments, ``mcmc.marg_loglik`` within it the Z-marginalized
    refresh, ``mcmc.loglik`` the pass at a segment end that is not stored."""
    step_core, add_loglik = build_step_parts(spec, data, tetra_tables, mesh)
    add_marg = build_marg_loglik(spec, data, tetra_tables, mesh)
    # diploid mode 0 has no Q to run empty: the guard never latches
    # (mcmc.c:111-115); the tetraploid engine always has one
    check_at = (-1 if (spec.mode == 0 and spec.ploid == 2)
                else sched.nstep_check_empty_cluster)

    def run_segment(state, accum, keys, start: int, stop: int):
        dev = keys.chain_key.device
        for i in range(start, stop):
            with spans.span("mcmc.sweep", dev):
                state = step_core(state, keys, i)
            stored = (i >= sched.burnin
                      and (i + 1 - sched.burnin) % sched.thinning == 0)
            # cal_lkh only when the draw is consumed (stored) or reported
            # (segment end)
            if not stored:
                if i == stop - 1:
                    with spans.span("mcmc.loglik", dev):
                        state = add_loglik(state)
                continue
            with spans.span("mcmc.stored", dev):
                state = add_loglik(state)
                nth = (i + 1 - sched.burnin) // sched.thinning - 1
                if nth % sched.dic_every == 0:
                    with spans.span("mcmc.marg_loglik", dev):
                        state = add_marg(state)
                stats = extract_stats(spec, state, track_freq)
                accum = accum_update(
                    accum, stats, 1,
                    up.empty_cluster_flag(stats.q, state.active), check_at)
        return state, accum

    return run_segment


MESH_MODES = ("auto", "shard_map")


def check_mesh(mesh, mesh_mode: str, n_chains: int, active_pops) -> None:
    """JAX's rules for a mesh (``driver.py:318-384``) as far as the port
    has their paths: "auto" and "shard_map" are the explicit per-rank
    path; "gspmd" has no counterpart (its result is the unsharded run's);
    the chains must split evenly over the chain axis (else JAX takes GSPMD);
    the K grid's ``active_pops`` does not combine with loci sharding."""
    if mesh_mode == "gspmd":
        raise ValueError(
            "mesh_mode='gspmd' has no counterpart in the PyTorch port: "
            "GSPMD partitioning of the unsharded program gives the "
            "unsharded result, which mesh=None computes")
    if mesh_mode not in MESH_MODES:
        raise ValueError(f"unknown mesh_mode {mesh_mode!r}")
    if mesh is None:
        return
    mesh.chain_rows(n_chains)
    if active_pops is not None and mesh.n_data_shards > 1:
        raise ValueError("active_pops (the padded K grid) does not combine "
                         "with loci sharding; use a chain-parallel mesh for "
                         "the K grid")


def _by_chain_block(mesh, parts):
    """One entry a chain block: the data-index-0 rank's of ``parts`` (one
    per rank)."""
    d = mesh.n_data_shards
    return [parts[ci * d] for ci in range(mesh.n_chain_shards)]


def gather_flags(mesh, flags: np.ndarray) -> np.ndarray:
    """All chains' flags from every rank's own: each rank of a chain block
    holds the same flags (they are computed from replicated state), which
    is checked."""
    if mesh is None:
        return flags
    parts = mesh.gather(flags)
    d = mesh.n_data_shards
    for r, f in enumerate(parts):
        if not np.array_equal(f, parts[r - r % d]):
            raise RuntimeError(f"rank {r}'s chain flags differ from its "
                               "chain block's: the replicated state of the "
                               "loci shards diverged")
    return np.concatenate(_by_chain_block(mesh, parts))


# per-locus fields: [C, K, L, A] frequencies and counts, [C, N, ploid * L]
# copy-major sites
_LOCI_FIELDS = ("freq", "freq2", "zcounts")
_SITE_FIELDS = ("z", "geno")


def _host(x):
    """A NamedTuple of tensors (nested) with every tensor on the CPU."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu()
    return type(x)(*[_host(t) for t in x])


def gather_result(mesh, data: Dataset, state: McmcState, accum: ChainAccum,
                  device):
    """(state, accum) of every chain, on every rank and on ``device``, in
    the unsharded layout: chain blocks in order, the loci shards' per-locus
    tensors put back into the input's loci order (padding dropped,
    the tetraploid plan undone, ``loci_shard.gather_loci``)."""
    if mesh is None or mesh.world_size == 1:
        return state, accum
    parts = mesh.gather((_host(state), _host(accum)))
    d = mesh.n_data_shards
    src = ls.loci_plan(data, d) if d > 1 else None

    def combine(xs, name):
        if xs[0] is None:
            return None
        if d == 1 or xs[0].numel() == 0:
            blocks = xs[::d]
        elif name in _LOCI_FIELDS:
            blocks = [ls.gather_loci(xs[i:i + d], src, axis=2)
                      for i in range(0, len(xs), d)]
        elif name in _SITE_FIELDS:
            blocks = [ls.gather_sites(xs[i:i + d], src, data.ploid)
                      for i in range(0, len(xs), d)]
        else:
            blocks = xs[::d]
        return torch.cat(blocks).to(device)

    def stats(getter):
        return type(accum.mean)(*[
            combine([getter(p)[i] for p in parts], name)
            for i, name in enumerate(accum.mean._fields)])

    new_state = McmcState(*[combine([p[0][i] for p in parts], name)
                            for i, name in enumerate(McmcState._fields)])
    fields = {}
    for i, name in enumerate(ChainAccum._fields):
        if name in ("mean", "mean_sq"):
            fields[name] = stats(lambda p, i=i: p[1][i])
        else:
            fields[name] = combine([p[1][i] for p in parts], name)
    return new_state, ChainAccum(**fields)


def recount_zcounts(spec: ModelSpec, data: Dataset,
                    state: McmcState) -> McmcState:
    """The carried allele-pop counts recounted from the state's z by K4
    (``kernels/fused_step.py:allele_counts``).  ``zcounts`` is derived
    state: a resumed run recomputes it rather than trusting the saved value
    (JAX ``driver.py:573-600``).  A state without carried counts (mode 0,
    the tetraploid engine) is returned as it is."""
    if state.zcounts is None or state.z.numel() == 0:
        return state
    return state._replace(zcounts=fs.allele_counts(
        state.z, data.geno, data.site_valid, n_pops=spec.n_pops,
        max_alleles=data.max_alleles, bits2=data.bits2))


def progress_lines(spec: ModelSpec, step: int, loglik: np.ndarray,
                   rates: np.ndarray, ais_state: Optional[np.ndarray]) -> str:
    """print_info's block (mcmc.c:1267-1316) for all chains, as the JAX
    driver prints it (``driver.py:510-560``): per chain a ``Step=`` line and
    a line of its S (``s_i=``) or F (``f_i=``) values, with the adaptive
    sampler's ``st_i=`` states under ``back_refl=0`` where S/F is per pop
    (``ais_state`` given), at most 512 values and a summary of the rest."""
    prefix = "f" if (spec.ploid == 2 and spec.mode in (4, 5)) else "s"
    lines = []
    for ci in range(loglik.shape[0]):
        lines.append(f"\nStep={step}\tchain={ci}"
                     f"\tlog_likelihood={loglik[ci]:f}")
        if rates.size:
            shown = min(rates.shape[-1], 512)
            parts = []
            for i, v in enumerate(rates[ci][:shown]):
                parts.append(f"{prefix}_{i}={v:f}")
                if ais_state is not None:
                    parts.append(f"st_{i}={int(ais_state[ci, i])}")
            if shown < rates.shape[-1]:
                row = rates[ci]
                parts.append(
                    f"... [{rates.shape[-1] - shown} more; "
                    f"min={row.min():f} mean={row.mean():f} "
                    f"max={row.max():f}; full values in the JSONL log]")
            lines.append(" ".join(parts))
    return "\n".join(lines)


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
             active_pops=None, checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 100_000,
             progress_every: Optional[int] = None, progress_fn=None,
             jsonl_log: Optional[str] = None, mesh=None,
             mesh_mode: str = "auto") -> RunResult:
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

    ``checkpoint_dir`` saves the run every ``checkpoint_every`` sweeps and
    at its end, and resumes from the latest checkpoint there (bitwise the
    uninterrupted run).  ``progress_every`` prints the progress block (or
    calls ``progress_fn(step, states, accums)``) every that many sweeps;
    ``jsonl_log`` appends one JSON record a segment (step, per-chain
    log-lik, the full rates matrix, stored count).

    ``mesh`` (``parallel.mesh.make_mesh``; every rank calls ``run_mcmc``
    with the same arguments) runs this rank's chain rows, under their
    global chain keys, on its loci block (``mesh.device``; ``device`` is
    not read); the pop counts, the MH log-ratio columns and the
    per-individual log-liks are summed over the data group, and the site
    draws (P, z, the tetraploid orderings) read the shard's site seed
    (``kernels/philox.py:fold_seed``), so a loci-sharded trajectory
    differs from the unsharded one by design.  A chain-only mesh, and a
    world of one, is bitwise the unsharded run.  The retry decision is
    made on every chain's flags, on every rank alike; each rank saves its
    own checkpoint part (``checkpoint.rank_dir``), and resuming under
    another mesh is refused; progress and the JSONL log come from rank 0
    (``progress_fn`` gets this rank's chains).  Every rank returns the
    whole result in the unsharded layout (:func:`gather_result`).
    ``mesh_mode`` "auto" or "shard_map" (the same path); "gspmd" raises.
    """
    dev = torch.device(device) if mesh is None else mesh.device
    with spans.span(spans.RUN, dev):
        check_supported(spec, data)
        n_chains = sched.n_chains
        check_mesh(mesh, mesh_mode, n_chains, active_pops)
        full_data = data
        if mesh is None:
            rows = range(n_chains)
            data = data.to(dev)
        else:
            rows = mesh.chain_rows(n_chains)
            data = ls.shard_panel(data, mesh)
        sharded = mesh is not None and mesh.world_size > 1
        shard = None if mesh is None else mesh.shard
        n_local = len(rows)
        active_all = (None if active_pops is None
                      else active_mask(active_pops, spec, n_chains, dev))
        active = (None if active_all is None
                  else active_all[rows.start:rows.stop])
        if init_rates is not None:
            init_rates = np.asarray(init_rates, np.float32).reshape(
                n_chains, -1)[rows.start:rows.stop]

        # the tetraploid engine's data-only tables, built once per run
        tables = te.build_tables(spec, data) if spec.ploid == 4 else None
        run_segment = _chain_runner(data, spec, sched, track_freq, tables,
                                    mesh)
        segmented = (checkpoint_dir is not None or progress_every is not None
                     or jsonl_log is not None)
        seg_len = (min(x for x in (checkpoint_every, progress_every,
                                   sched.n_iter) if x is not None)
                   if segmented else sched.n_iter)

        def report(step, state, accum):
            ll, rates, ais = (_np(state.loglik_total), _np(state.rates),
                              _np(state.ais_state))
            if progress_fn is not None:
                progress_fn(step, state, accum)
                if not jsonl_log:
                    return
            if mesh is not None and mesh.world_size > 1:
                parts = _by_chain_block(mesh, mesh.gather((ll, rates, ais)))
                ll, rates, ais = [np.concatenate(x) for x in zip(*parts)]
                if mesh.rank != 0:
                    return
            if progress_fn is None and progress_every is not None:
                show_st = (spec.back_refl == 0
                           and (spec.rates_are_per_pop or spec.ploid == 4))
                print(progress_lines(spec, step, ll, rates,
                                     ais if show_st else None),
                      flush=True)
            if jsonl_log:
                with open(jsonl_log, "a") as fh:
                    fh.write(json.dumps({
                        "step": int(step),
                        "loglik": ll.tolist(),
                        "rates": rates.tolist() if rates.size else None,
                        "stored": int(_np(accum.count)[0]),
                    }) + "\n")

        mesh_shape = ((1, 1) if mesh is None
                      else (mesh.n_chain_shards, mesh.n_data_shards))
        rank = 0 if mesh is None else mesh.rank

        def resume_step(ckpt_dir):
            """The step to resume from: the latest step saved (by every
            rank, on a sharded mesh), after refusing a checkpoint of another
            mesh."""
            if ckpt_dir is None:
                return None
            found = ckpt.saved_mesh(ckpt_dir)
            if found is not None and found != mesh_shape:
                raise ValueError(
                    f"{ckpt_dir} holds a checkpoint of a "
                    f"{found[0]}x{found[1]} mesh; this run's mesh is "
                    f"{mesh_shape[0]}x{mesh_shape[1]}")
            latest = ckpt.latest_step(ckpt.rank_dir(ckpt_dir, rank)
                                      if sharded else ckpt_dir)
            if sharded:
                steps = mesh.gather(latest)
                latest = None if None in steps else min(steps)
            return latest

        def attempt(chain_key, ckpt_dir):
            """One attempt: initialise this rank's chains (or resume them
            from ``ckpt_dir``) and run the rest of the schedule."""
            state = init_state(seed, spec, data, n_local, init_rates, dev,
                               chain_key=chain_key, tetra_tables=tables,
                               active=active, mesh=mesh)
            accum = init_accum(spec, sched, data, track_freq, n_local, dev)
            start = 0
            latest = resume_step(ckpt_dir)
            if sharded and ckpt_dir is not None:
                ckpt_dir = ckpt.rank_dir(ckpt_dir, rank)
            if latest is not None and 0 < latest <= sched.n_iter:
                got = ckpt.restore_checkpoint(
                    ckpt_dir, latest, {"states": state, "accums": accum,
                                       "chain_key": list(chain_key)})
                state = recount_zcounts(spec, data, got["states"])
                accum, chain_key = got["accums"], got["chain_key"]
                start = latest
            keys = px.make_keys(seed, n_local, dev, chain_key=chain_key,
                                shard=shard)
            while start < sched.n_iter:
                stop = min(start + seg_len, sched.n_iter)
                state, accum = run_segment(state, accum, keys, start, stop)
                start = stop
                save = ckpt_dir is not None and (
                    start % checkpoint_every == 0 or start == sched.n_iter)
                tell = progress_every is not None or jsonl_log
                if not (save or tell):
                    continue
                with spans.span("mcmc.segment_end", dev):
                    if save:
                        ckpt.save_checkpoint(
                            ckpt_dir, start,
                            {"states": state, "accums": accum,
                             "chain_key": list(chain_key)},
                            mesh=mesh_shape, rank=rank)
                    if tell:
                        report(start, state, accum)
            return state, accum

        chain_key = list(rows)
        state, accum = attempt(chain_key, checkpoint_dir)
        retries = 0
        # the flags, a retry's attempts, the gather and the plug-in pass
        with spans.span("mcmc.finish", dev):
            flags = gather_flags(mesh, unhealthy_flags(state, accum))
            while flags.any() and retries < max_retries:
                retries += 1
                if checkpoint_dir is not None and rank == 0:
                    # a retry gets its own checkpoint namespace: the main
                    # run has saved its final step, so resuming from it
                    # would skip the rerun
                    print(f"[instruct_tpu_torch] retrying "
                          f"{int(flags.sum())} unhealthy chain(s) (attempt "
                          f"{retries}/{max_retries})", flush=True)
                # flagged chains get a fresh key; the others replay theirs
                chain_key = [10_000 * retries + c if flags[c]
                             else chain_key[c - rows.start] for c in rows]
                state, accum = attempt(
                    chain_key, None if checkpoint_dir is None else
                    os.path.join(checkpoint_dir, f"retry-{retries}"))
                flags = gather_flags(mesh, unhealthy_flags(state, accum))
            if flags.any() and rank == 0:
                print(f"[instruct_tpu_torch] WARNING: {int(flags.sum())} "
                      f"chain(s) still unhealthy after {retries} retries "
                      "(empty cluster or non-finite log-likelihood); results "
                      "include them", flush=True)

            state, accum = gather_result(mesh, full_data, state, accum, dev)
            if sharded:
                # the plug-in pass of an unsharded run, on the gathered means
                data, tables, active = full_data.to(dev), None, active_all
            plugin_ll = None
            if track_freq and spec.ploid == 4:
                plugin_ll = _np(te.plugin_loglik(spec, data, accum.mean,
                                                 state, tables))
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
    return _np(mk.marg_indv_loglik(spec, data, m.freq, m.q, m.gen,
                                   m.rates).sum(dim=-1))
