"""Composition of the update kernels into one MCMC sweep (modes 0-5, and
the tetraploid engine's sweep, ``tetra/engine.py``).

Counterpart of ``instruct_tpu/mcmc/step.py``: ``_use_fused`` (:102 there),
``_build_fused_parts`` (:122-356), the unfused step and ``_cal_lkh``
(:23-35, :411-477), ``build_marg_loglik`` (:480, diploid branches) and
``build_step`` (:549).  One call of ``step`` is one full sweep for ALL
chains (leading axis ``C``).  There are two sweeps, and the spec's
``use_pallas`` chooses between them (never whether a hand kernel runs: on
the card both launch kernels, on the CPU both run the plain versions).

The **fused** sweep (``use_pallas`` None or True, modes 1-5, K*A <= 64, the
JAX step's gate) draws Z and evaluates the G or F MH log-ratio at the fresh
z in one pass over the sites ("Z, then G | z" / "Z, then F | z"):

    P | Z        Dirichlet(zcounts + 1)              kernels/dirichlet.py
    S or F tail  mode 2: J*K MH subsweeps + G proposal, one kernel
                 (K <= 8)                            kernels/s_pop.py
                 (plain updates under the adaptive-independence proposal
                 or at K > 8, as in JAX)
                 mode 3: J elementwise MH subsweeps + G proposal
                 modes 4/5: the F proposal           mcmc/updates.py
                 DPM prior (modes 3/5): the CRP or
                 stick-breaking sweep sets S or F    mcmc/dpm.py,
                 (mode 5: the F pass then runs with  kernels/crp.py
                 the identity pair, a no-op accept)
                 marginalize_g (modes 2/3): the G    mcmc/marg_g.py
                 curves, S on the G-marginal target
                 (or the DPM sweep), the exact G draw;
                 then the sampling-only site pass
    Z, G|z, F|z  site pass: z draw, counts, MH ratio kernels/fused_step.py
    Q | Z        Dirichlet(qqnum + alpha)            kernels/dirichlet.py
    alpha        MH                                  mcmc/updates.py

The **unfused** sweep (everything else: mode 0, K*A > 64, or
``use_pallas=False``) keeps the reference's order, G or F first and then Z
(mcmc.c:111-115, 150-155, 208-215, 334-348, 263-269, 420-434):

    mode 0: P, Z
    mode 1: P, ZQ, alpha
    mode 2: P, S_pop, G, ZQ, alpha
    mode 3: P, S_ind | DPM, G, ZQ, alpha
    mode 4: P, F_pop, ZQ, alpha
    mode 5: P, F_ind | DPM, ZQ, alpha
    (marginalize_g: P, the G curves, S | DPM on the G-marginal target, the
    exact G draw, ZQ, alpha)

    P | Z        counts, then Dirichlet(counts + 1)  kernels/fused_step.py
                                                     (allele_counts),
                                                     kernels/dirichlet.py
    S, F, G      MH at the carried z                 mcmc/updates.py
    Z, counts    z ~ Cat(q_k P[k, l, a]), any K*A    kernels/zq.py
    Q | Z, alpha as above

With the padded K grid's mask ``state.active`` (``kselect.py``) every Q draw
zeroes the inactive columns and renormalizes, mode 0's z weighs them 0, and
alpha's density, the empty-cluster check and mode 0's marginal log-lik run
over the active slots (JAX ``step.py:163-178``, ``:526-531``).

The two orders have the same invariant distribution but draw different
trajectories, so a fused and an unfused run agree only statistically.

Neither sweep synchronises with the host: every accept is a ``torch.where``
on device tensors.  Randomness is counter-based (``kernels/philox.py``):
``step(state, keys, step_idx)`` draws from the (chain key, step index)
counter space, so a trajectory is a function of the seed alone.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from instruct_tpu_torch.config import ModelSpec, PriorFamily
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import marg_loglik as mk
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import s_pop as sp
from instruct_tpu_torch.mcmc import dpm
from instruct_tpu_torch.mcmc import marg_g as mg
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.mcmc.state import McmcState
from instruct_tpu_torch.model import likelihood as lk
from instruct_tpu_torch.tetra import engine as te


class StepDraws(NamedTuple):
    """Injected uniforms of one sweep, in the layouts of the kernels'
    ``test_draws`` / ``u`` arguments (tests feed the JAX functions the same
    numbers).  ``None`` fields draw from Philox."""

    p: Optional[torch.Tensor] = None      # f32[C, n_test_draws, K*A, L]
    s: Optional[tuple] = None             # the S or F update's uniforms:
    #   mode 2  (u_prop, u_acc f32[C, J*K], ug, ul f32[C, N])
    #   mode 3  (u_prop, u_acc f32[C, J, N], ug, ul f32[C, N])
    #   modes 4/5  (u_prop, u_acc f32[C, R])
    #   under the adaptive-independence proposal (modes 2, 4) one more,
    #   the fresh values, shaped like u_prop
    z: Optional[torch.Tensor] = None      # f32[C, N, 2L]
    q: Optional[torch.Tensor] = None      # f32[C, n_test_draws, K, N]
    alpha: Optional[tuple] = None         # (normal f32[C], uniform f32[C])
    hyper: Optional[torch.Tensor] = None  # f32[C, n_hyper_draws()], the
    #   normal prior's (mu, sigma^2) draw (modes 3/5)
    zz: Optional[torch.Tensor] = None     # f32[C, N], mode 0's z draw
    # the tetraploid engine (tetra/engine.py) also reads p (system 1, or
    # every slot when autopoly), s = (u_prop, u_acc[, fresh]) f32[C, J, K],
    # z f32[C, N, 4L] (copy-major), q, alpha and:
    p2: Optional[torch.Tensor] = None     # f32[C, n_test_draws, K*A, L],
    #   the allotetraploid second system's P draw
    geno: Optional[torch.Tensor] = None   # f32[C, n_cand, N, L] Gumbel noise
    #   of the latent-genotype move
    # the DPM prior (modes 3/5, mcmc/dpm.py): the CRP sweep's (seat noise
    # f32[C, N, N+1], new values f32[C, N] (mode 3) or new grid indices
    # i32[C, N] (mode 5)); the stick-breaking sweep's (sticks f32[C, T],
    # values f32[C, T] (mode 3) or their grid noise f32[C, T, M] (mode 5),
    # seat noise f32[C, N, T])
    dpm: Optional[tuple] = None
    marg: Optional[torch.Tensor] = None   # f32[C, N, gen_cap] Gumbel noise
    #   of the exact G draw under marginalize_g (its S update reads s)


class _Tail(NamedTuple):
    """The uniforms of one sweep's S/F/G updates that are plain tensor
    code."""

    u_prop: torch.Tensor                  # [C, J, R] (modes 2/3), [C, R]
    u_acc: torch.Tensor
    ug: Optional[torch.Tensor] = None     # [C, N] G proposal (modes 2/3)
    ul: Optional[torch.Tensor] = None     # [C, N] G accept
    fresh: Optional[torch.Tensor] = None  # shaped like u_prop
    hyper: Optional[torch.Tensor] = None  # [C, n_hyper_draws()]


def check_supported(spec: ModelSpec, data: Dataset) -> None:
    """Raise the JAX package's ``ValueError`` for a model it does not run
    either (``instruct_tpu/mcmc/step.py:386-407``, ``mcmc/dpm.py:395-402``).
    Where JAX ignores an option -- the DPM prior outside diploid modes 3/5
    -- the port ignores it too."""
    if spec.ploid not in (2, 4):
        raise ValueError(f"ploidy {spec.ploid}: the models are diploid or "
                         "tetraploid")
    if spec.mode not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"unknown mode {spec.mode}")
    if spec.marginalize_g and (spec.mode not in (2, 3) or spec.ploid != 2):
        raise ValueError("marginalize_g applies to the diploid selfing "
                         "modes 2/3 (the only modes with generation "
                         "latents)")
    if spec.marginalize_g and spec.type_freq != 1:
        raise ValueError(
            "marginalize_g requires the structure-way genotype formulation "
            "(type_freq=1): the expectation way's Q-mixture probability "
            "does not factorize through the (pop, allele) one-hot the "
            "curve tables need")
    if dpm.uses_dpm(spec):
        dpm.check_truncation(spec.priors.dp_truncation, data.n_indv)
    if spec.ploid == 4 and (data.distinct is None
                            or data.n_distinct is None):
        raise ValueError("the tetraploid engine needs Dataset.distinct / "
                         "n_distinct (build the panel with ploid 4)")


def _is_marg(spec: ModelSpec) -> bool:
    """``marginalize_g`` (diploid modes 2/3; check_supported refuses it
    elsewhere)."""
    return spec.marginalize_g and spec.mode in (2, 3)


def use_fused(spec: ModelSpec, data: Dataset) -> bool:
    """Whether the spec runs the fused sweep: diploid modes 1-5 within the
    site pass's bound K*A <= 64 (exactly the JAX gate,
    ``instruct_tpu/mcmc/step.py:111-117``) unless ``use_pallas`` is False.
    Everything else runs the unfused sweep.  The tetraploid engine has its
    own gate (``tetra/engine.py:tetra_use_fused``: K <= 8, K*A <= 64)."""
    if spec.ploid == 4:
        return te.tetra_use_fused(spec, data)
    return (spec.use_pallas is not False and spec.ploid == 2
            and spec.mode in (1, 2, 3, 4, 5)
            and fs.site_pass_fits(spec.n_pops, data.max_alleles))


def _is_normal(spec: ModelSpec) -> bool:
    """The normal prior applies to the per-individual rates only; the other
    modes ignore it."""
    return spec.priors.family == PriorFamily.NORMAL and spec.mode in (3, 5)


def _is_adaptive(spec: ModelSpec) -> bool:
    """The adaptive-independence proposal applies to the per-pop rates
    only; the per-individual updates always walk with back-reflection."""
    return spec.back_refl != 1 and spec.mode in (2, 4)


def _tail_draws(spec: ModelSpec, keys, step_idx: int, d: StepDraws,
                n: int) -> _Tail:
    """The uniforms of the sweep's plain S/F/G updates, injected (``d.s``,
    ``d.hyper``) or from one launch over the consecutive tail streams."""
    with_g = spec.mode in (2, 3)
    adaptive, normal = _is_adaptive(spec), _is_normal(spec)
    sweeps = max(1, spec.s_subsweeps) if with_g else 1
    m = sweeps * spec.n_rates(n)
    if d.s is not None:
        s = tuple(d.s)
        u_prop, u_acc = s[0], s[1]
        ug, ul = (s[2], s[3]) if with_g else (None, None)
        fresh = s[4 if with_g else 2] if adaptive else None
        hyper = d.hyper if normal else None
    else:
        n_hyper = up.n_hyper_draws() if normal else 0
        n_streams = 6 if normal else 5 if adaptive else 4 if with_g else 2
        w = up.tail_uniforms(keys, step_idx, n_streams,
                             max(m, n if with_g else 0, n_hyper))
        u_prop, u_acc = w[:, 0, :m], w[:, 1, :m]
        ug, ul = (w[:, 2, :n], w[:, 3, :n]) if with_g else (None, None)
        fresh = w[:, 4, :m] if adaptive else None
        hyper = w[:, 5, :n_hyper] if normal else None
    if with_g:
        shape = (u_prop.shape[0], sweeps, -1)
        u_prop, u_acc = u_prop.reshape(shape), u_acc.reshape(shape)
        fresh = None if fresh is None else fresh.reshape(shape)
    return _Tail(u_prop, u_acc, ug, ul, fresh, hyper)


def _prior_args(spec: ModelSpec, state: McmcState):
    """(prior_mu, prior_sigma2) of the per-individual S/F updates: the
    state's hyperparameters under the normal prior, else none."""
    if _is_normal(spec):
        return state.prior_mu, state.prior_sigma2
    return None, None


def _hyper_update(spec: ModelSpec, state: McmcState, tail: _Tail, rates):
    """The state's fields after the S/F update of modes 3/5: the new rates
    and, under the normal prior, the conjugate (mu, sigma^2) draw given
    them."""
    changed = dict(rates=rates)
    if _is_normal(spec):
        mu, s2 = up.update_normal_hyper(tail.hyper, rates, spec.priors)
        changed.update(prior_mu=mu, prior_sigma2=s2)
    return changed


def _dpm_fields(state: McmcState) -> dict:
    """The fields the DPM sweep sets: the rates and the table."""
    return dict(rates=state.rates, dpm_values=state.dpm_values,
                dpm_counts=state.dpm_counts, dpm_assign=state.dpm_assign)


def _marg_s_and_gen(spec: ModelSpec, data: Dataset, state: McmcState,
                    keys, step_idx: int, d: StepDraws, dpm_update,
                    mesh=None) -> dict:
    """The ``marginalize_g`` tail of modes 2/3, both sweeps (JAX
    ``step.py:69-99``): the G curves at the state's freq and z, S on the
    G-marginal target (mode 2 per pop, mode 3 per individual or the DPM
    sweep), then the exact G draw.  Returns the changed fields."""
    n = data.n_indv
    gtable = up.psum(mg.selfing_gtable(data, state.freq, state.z,
                                       spec.gen_cap), mesh)
    if dpm_update is not None:
        changed = _dpm_fields(dpm_update(state, keys, step_idx, d.dpm))
        sbar = changed["rates"]
    else:
        tail = _tail_draws(spec, keys, step_idx, d, n)
        if spec.mode == 2:
            rates, ais = mg.update_s_pop_marginal(
                tail.u_prop, tail.u_acc, spec, state.q, gtable, state.rates,
                state.ais_state, tail.fresh)
            changed = dict(rates=rates, ais_state=ais)
            sbar = up.mix_rates(state.q, rates)
        else:
            rates = mg.update_s_ind_marginal(
                tail.u_prop, tail.u_acc, spec, gtable, state.rates,
                *_prior_args(spec, state))
            changed = _hyper_update(spec, state, tail, rates)
            sbar = rates
    noise = (d.marg if d.marg is not None
             else mg.gen_noise(keys, step_idx, n, spec.gen_cap))
    changed["gen"] = mg.sample_gen_marginal(noise, gtable, sbar,
                                            spec.gen_cap)
    return changed


def _build_fused_parts(spec: ModelSpec, data: Dataset, mesh=None):
    """``(step_core, add_loglik)`` of the fused sweep; with a loci-sharded
    ``mesh`` the pop counts, the G or F log-ratio columns and the
    per-individual log-liks are summed over the shards, and P and z draw
    from the site keys."""
    n = data.n_indv
    structure = spec.type_freq == 1
    marg = _is_marg(spec)
    # mode 2's S tail as one kernel: back-reflection and K <= 8, the JAX
    # gate (instruct_tpu/mcmc/step.py:146-150), and not under
    # marginalize_g; else the plain updates
    s_tail_kernel = (spec.mode == 2 and spec.back_refl == 1
                     and spec.n_pops <= sp.MAX_POPS and not marg)
    dpm_update = (dpm.build_dpm_update(spec, data, mesh)
                  if dpm.uses_dpm(spec) else None)
    skeys = px.site_keys

    def finish(state, keys, step_idx, d, z, qqnum, zcounts, **changed):
        """Q | Z ~ Dirichlet(counts + alpha), one draw per (chain,
        individual), masked to the active slots; then the alpha MH step.
        The sampling pass returns the allele-pop counts of the fresh z,
        which the next sweep's P update reads."""
        conc = up.psum(qqnum, mesh) + state.alpha[:, None, None]
        q_new = up.mask_active(
            dk.dirichlet_nk(keys, step_idx, conc, test_draws=d.q),
            state.active)
        alpha = up.update_alpha(keys, step_idx, spec, q_new, state.alpha,
                                state.active, test_draws=d.alpha)
        return state._replace(z=z, q=q_new, alpha=alpha, zcounts=zcounts,
                              **changed)

    def s_tail(state, keys, step_idx, d):
        """The S updates that are plain tensor code -- mode 3's J
        elementwise MH subsweeps (update_S_IND) with the normal prior's
        hyper draw, or mode 2's J sweeps over the pops under the
        adaptive-independence proposal (update_S_POP) -- then the G
        proposal g' ~ Geom(1 - sbar_i), the generation weights 2^(1-g) and
        the accept log-uniforms."""
        tail = _tail_draws(spec, keys, step_idx, d, n)
        if spec.mode == 2:
            rates, ais = up.update_s_pop(tail.u_prop, tail.u_acc, spec,
                                         state.q, state.gen, state.rates,
                                         state.ais_state, tail.fresh)
            changed = dict(rates=rates, ais_state=ais)
            sbar = up.mix_rates(state.q, rates)
        elif dpm_update is not None:
            # the CRP / stick sweep conditions on gen only (JAX
            # step.py:203-207)
            changed = _dpm_fields(dpm_update(state, keys, step_idx, d.dpm))
            sbar = changed["rates"]
        else:
            rates = up.update_s_ind(tail.u_prop, tail.u_acc, spec, state.gen,
                                    state.rates, *_prior_args(spec, state))
            changed = _hyper_update(spec, state, tail, rates)
            sbar = rates
        gen_prop = up.sample_geometric(tail.ug, sbar, spec.gen_cap)
        wg_pair = torch.exp2(1.0 - torch.stack(
            [state.gen, gen_prop], dim=-1).to(torch.float32))
        return changed, gen_prop, wg_pair, torch.log(tail.ul)

    def f_sweep(state, keys, step_idx, d, freq):
        """Modes 4/5: the F proposal, the fused Z-Gibbs + F-MH pass, the
        accept (mcmc_POP_inbreedcoff / mcmc_INDV_inbreedcoff,
        mcmc.c:242-293, 386-468).  Under the DPM prior the sweep on the
        fresh P and the carried z sets F, and the pass runs with the
        identity pair (JAX ``_f_tail``, :284-299): its accept is a no-op,
        so none is drawn."""
        if dpm_update is not None:
            changed = _dpm_fields(dpm_update(state._replace(freq=freq), keys,
                                             step_idx, d.dpm))
            f = changed["rates"]
            z, qqnum, _, zcounts = fs.zq_f_pass(
                skeys(keys), step_idx, state.q, freq, data,
                torch.stack([f, f], dim=-1), pop=False, u=d.z)
            return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                          freq=freq, **changed)
        tail = _tail_draws(spec, keys, step_idx, d, n)
        if _is_adaptive(spec):
            prop, prop_states, log_hast = up.propose_adaptive_independence(
                tail.u_prop, tail.fresh, state.rates, state.ais_state)
        else:
            prop = up.propose_back_reflection(tail.u_prop, state.rates,
                                              spec.mh_step_s)
            prop_states, log_hast = state.ais_state, None
        f_pair = torch.stack([state.rates, prop], dim=-1)     # [C, R, 2]
        z, qqnum, ll, zcounts = fs.zq_f_pass(
            skeys(keys), step_idx, state.q, freq, data, f_pair,
            pop=(spec.mode == 4), u=d.z)
        ll = up.psum(ll, mesh)
        # mode 4: the per-individual sums of each pop add up over N
        log_ratio = ll.sum(dim=1) if spec.mode == 4 else ll
        if log_hast is not None:
            log_ratio = log_ratio + log_hast
        pm, ps2 = _prior_args(spec, state)
        if pm is not None:
            log_ratio = log_ratio + (
                up.normal_prior(prop, pm, ps2)
                - up.normal_prior(state.rates, pm, ps2))
        accept = torch.log(tail.u_acc) < log_ratio
        rates = torch.where(accept, prop, state.rates)
        changed = _hyper_update(spec, state, tail, rates)
        if log_hast is not None:
            changed["ais_state"] = torch.where(accept, prop_states,
                                               state.ais_state)
        return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                      freq=freq, **changed)

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws: Optional[StepDraws] = None) -> McmcState:
        d = draws if draws is not None else StepDraws()
        # P | Z from the counts carried out of the previous site pass
        # (update_P, mcmc.c:799-861)
        freq = dk.dirichlet_kla(skeys(keys), step_idx, state.zcounts + 1.0,
                                data.allele_valid, test_draws=d.p)
        if spec.mode in (4, 5):
            return f_sweep(state, keys, step_idx, d, freq)
        if marg:
            # the G curves feed S and an exact G draw; the Z pass then
            # needs no G inputs (JAX _marg_tail, step.py:265-282)
            changed = _marg_s_and_gen(spec, data, state._replace(freq=freq),
                                      keys, step_idx, d, dpm_update, mesh)
            z, qqnum, zcounts = fs.zq_sample_pass(
                skeys(keys), step_idx, state.q, freq, data, u=d.z)
            return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                          freq=freq, **changed)
        if spec.mode == 1:
            # sampling only; cal_lkh is deferred to stored steps
            z, qqnum, zcounts = fs.zq_sample_pass(
                skeys(keys), step_idx, state.q, freq, data, u=d.z)
            return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                          freq=freq)
        # modes 2/3: S subsweeps + G proposal + generation weights + accept
        # uniforms, then the fused Z-Gibbs + G-MH pass and the G accept
        if s_tail_kernel:
            rates, gen_prop, wg_pair, logu = sp.s_pop_tail(
                keys, step_idx, state.q, state.gen, state.rates,
                subsweeps=spec.s_subsweeps, delta0=spec.mh_step_s,
                gen_cap=spec.gen_cap, test_draws=d.s)
            changed = dict(rates=rates)
        else:
            changed, gen_prop, wg_pair, logu = s_tail(state, keys, step_idx,
                                                      d)
        z, qqnum, ll_diff, zcounts = fs.zq_gendiff_pass(
            skeys(keys), step_idx, state.q, freq, data, wg_pair,
            structure=structure, u=d.z)
        gen = torch.where(logu < up.psum(ll_diff, mesh), gen_prop,
                          state.gen)
        return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                      freq=freq, gen=gen, **changed)

    def add_loglik(state: McmcState) -> McmcState:
        if spec.mode == 1:
            ll_indv = fs.panel_loglik_mode1_pass(state.freq, state.q, data,
                                                 state.z)
        elif spec.mode in (4, 5):
            ll_indv = fs.panel_loglik_f_pass(state.freq, data, state.z,
                                             state.rates,
                                             pop=(spec.mode == 4))
        else:
            wg = torch.exp2(1.0 - state.gen.to(torch.float32))
            ll_indv = fs.panel_loglik_pass(state.freq, state.q, data,
                                           state.z, wg, structure=structure)
        ll_indv = up.psum(ll_indv, mesh)
        return state._replace(loglik_indv=ll_indv,
                              loglik_total=ll_indv.sum(dim=-1))

    return step, add_loglik


def _build_unfused_parts(spec: ModelSpec, data: Dataset, mesh=None):
    """``(step_core, add_loglik)`` of the unfused sweep, in the reference's
    order: P, then S or F, then G, then Z and Q, then alpha; ``mesh`` as in
    :func:`_build_fused_parts`."""
    n = data.n_indv
    marg = _is_marg(spec)
    dpm_update = (dpm.build_dpm_update(spec, data, mesh)
                  if dpm.uses_dpm(spec) else None)

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws: Optional[StepDraws] = None) -> McmcState:
        d = draws if draws is not None else StepDraws()
        freq = up.update_freq(keys, step_idx, spec, data, state.z, state.zz,
                              test_draws=d.p)
        if spec.mode == 0:
            u = d.zz
            if u is None:
                u = px.u01_open(px.random_words(keys, step_idx, px.STREAM_ZZ,
                                                n))
            return state._replace(freq=freq,
                                  zz=up.update_z_noadmix(u, data, freq,
                                                         state.active, mesh))
        changed = dict(freq=freq)
        if marg:
            changed.update(_marg_s_and_gen(
                spec, data, state._replace(freq=freq), keys, step_idx, d,
                dpm_update, mesh))
        elif spec.mode != 1:
            tail = _tail_draws(spec, keys, step_idx, d, n)
            if dpm_update is not None:
                changed.update(_dpm_fields(dpm_update(
                    state._replace(freq=freq), keys, step_idx, d.dpm)))
            elif spec.mode == 2:
                rates, ais = up.update_s_pop(tail.u_prop, tail.u_acc, spec,
                                             state.q, state.gen, state.rates,
                                             state.ais_state, tail.fresh)
                changed.update(rates=rates, ais_state=ais)
            elif spec.mode == 3:
                rates = up.update_s_ind(tail.u_prop, tail.u_acc, spec,
                                        state.gen, state.rates,
                                        *_prior_args(spec, state))
                changed.update(_hyper_update(spec, state, tail, rates))
            elif spec.mode == 4:
                rates, ais = up.update_f_pop(tail.u_prop, tail.u_acc, spec,
                                             data, freq, state.z, state.rates,
                                             state.ais_state, tail.fresh,
                                             mesh)
                changed.update(rates=rates, ais_state=ais)
            else:
                rates = up.update_f_ind(tail.u_prop, tail.u_acc, spec, data,
                                        freq, state.z, state.rates,
                                        *_prior_args(spec, state), mesh=mesh)
                changed.update(_hyper_update(spec, state, tail, rates))
            if spec.has_selfing:
                changed["gen"] = up.update_gen(
                    tail.ug, tail.ul, spec, data, freq, state.z, state.q,
                    changed["rates"], state.gen, mesh)
        z, q, _ = up.update_zq(keys, step_idx, spec, data, freq, state.q,
                               state.alpha, u=d.z, q_draws=d.q,
                               active=state.active, mesh=mesh)
        alpha = up.update_alpha(keys, step_idx, spec, q, state.alpha,
                                state.active, test_draws=d.alpha)
        return state._replace(z=z, q=q, alpha=alpha, **changed)

    def add_loglik(state: McmcState) -> McmcState:
        """cal_lkh (mcmc.c:1916-1942) in plain tensor code, for any K."""
        if spec.mode == 0:
            ll = up.psum(lk.loglik_matrix_nopop_admix(data, state.freq), mesh)
            ll_indv = torch.gather(
                ll, 2, state.zz.to(torch.int64)[:, :, None])[:, :, 0]
        else:
            ll_indv = up.psum(lk.per_indv_loglik(
                spec, data, state.freq, state.z, state.q, state.gen,
                state.rates), mesh)
        return state._replace(loglik_indv=ll_indv,
                              loglik_total=ll_indv.sum(dim=-1))

    return step, add_loglik


def build_step_parts(spec: ModelSpec, data: Dataset, tetra_tables=None,
                     mesh=None):
    """Return ``(step_core, add_loglik)`` for the sweep the spec selects
    (:func:`use_fused`; ploidy 4: ``tetra/engine.py:build_tetra_step``,
    with the run's ``tetra_tables`` when given).

    ``step_core(state, keys, step_idx, draws=None)`` runs the full
    parameter sweep of all chains; ``add_loglik(state)`` fills
    ``loglik_indv`` / ``loglik_total`` (cal_lkh, mcmc.c:1916-1942).  The
    split lets ``run_mcmc`` evaluate the log-likelihood only on stored or
    reported steps: it is an observable, not an input to any update.
    ``data`` must live on the device of the state.  With a
    ``parallel.mesh.Mesh`` whose loci are split, ``data`` is this rank's
    block (``parallel/loci_shard.py:shard_panel``) and the sweep sums its
    per-individual quantities over the shards (``updates.psum``).
    """
    check_supported(spec, data)
    if spec.ploid == 4:
        return te.build_tetra_step(spec, data, tetra_tables, mesh)
    if use_fused(spec, data):
        return _build_fused_parts(spec, data, mesh)
    return _build_unfused_parts(spec, data, mesh)


def nopop_marginal(spec: ModelSpec, data: Dataset, freq, active=None,
                   mesh=None):
    """Mode 0's per-individual marginal log-lik f32[C, N]: the uniform
    mixture over the K single-pop log-liks, or, under the K grid's mask
    ``active`` f32[C, K], over each chain's active slots only (inactive
    slots' P is Dirichlet(1) noise; JAX ``step.py:526-531``)."""
    ll = up.psum(lk.loglik_matrix_nopop_admix(data, freq), mesh)  # [C, N, K]
    if active is None:
        return torch.logsumexp(ll, dim=2) - math.log(spec.n_pops)
    ll = torch.where(active[:, None, :] > 0, ll,
                     torch.full_like(ll, float("-inf")))
    n_act = torch.clamp_min(active.sum(-1), 1.0)
    return torch.logsumexp(ll, dim=2) - torch.log(n_act)[:, None]


def build_marg_loglik(spec: ModelSpec, data: Dataset, tetra_tables=None,
                      mesh=None):
    """``add_marg(state) -> state`` filling ``state.loglik_marg`` with the
    Z-marginalized per-individual log-likelihood that feeds WAIC and the
    corrected DIC: in modes 1-5 ``kernels/marg_loglik.py:
    marg_indv_loglik`` (on the card one pass of ``csrc/marg_loglik.cu``
    over the panel; on the CPU the plain ``model/likelihood.py:
    marginal_indv_loglik``; inactive K-grid slots carry no q mass and need
    no mask), the
    uniform mixture over the K single-pop log-liks in mode 0 (over the
    active slots under the K grid's mask), the (z, geno)-conditional log-lik
    of the tetraploid engine
    (``tetra/engine.py:build_marg_loglik``).  ``run_mcmc`` calls it only
    every ``Schedule.dic_every``-th stored step.  ``mesh`` as in
    :func:`build_step_parts`: the per-individual sums (mode 0: the [N, K]
    log-liks) are summed over the loci shards."""
    check_supported(spec, data)
    if spec.ploid == 4:
        return te.build_marg_loglik(spec, data, tetra_tables, mesh)

    def add_marg(state: McmcState) -> McmcState:
        if spec.mode == 0:
            indv = nopop_marginal(spec, data, state.freq, state.active, mesh)
        else:
            indv = up.psum(mk.marg_indv_loglik(
                spec, data, state.freq, state.q, state.gen, state.rates),
                mesh)
        return state._replace(loglik_marg=indv)

    return add_marg


def build_step(spec: ModelSpec, data: Dataset) -> Callable:
    """``step(state, keys, step_idx) -> state`` with the log-likelihood
    always filled: the composition of :func:`build_step_parts`."""
    core, add_ll = build_step_parts(spec, data)

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws: Optional[StepDraws] = None) -> McmcState:
        return add_ll(core(state, keys, step_idx, draws))

    return step
