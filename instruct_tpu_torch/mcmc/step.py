"""Composition of the update kernels into one fused MCMC sweep (modes 1-5).

Counterpart of ``instruct_tpu/mcmc/step.py``: ``_build_fused_parts``
(:122-356 there), ``build_marg_loglik`` (:480, diploid branch) and
``build_step`` (:549).  One call of ``step`` is one full sweep for ALL
chains (leading axis ``C``):

    P | Z        Dirichlet(zcounts + 1)              kernels/dirichlet.py
    S or F tail  mode 2: J*K MH subsweeps + G proposal, one kernel
                                                     kernels/s_pop.py
                 mode 3: J elementwise MH subsweeps + G proposal
                 modes 4/5: the F random-walk proposal
                                                     mcmc/updates.py
    Z, G|z, F|z  site pass: z draw, counts, MH ratio kernels/fused_step.py
    Q | Z        Dirichlet(qqnum + alpha)            kernels/dirichlet.py
    alpha        MH                                  mcmc/updates.py

Update order per mode (the reference loops, mcmc.c:150-155, 208-215,
334-348, 263-269, 420-434):

    mode 1: P, Z, Q, alpha
    mode 2: P, S_pop, (Z, then G | z), Q, alpha
    mode 3: P, S_ind, (Z, then G | z), Q, alpha
    mode 4: P, (Z, then F_pop | z), Q, alpha
    mode 5: P, (Z, then F_ind | z), Q, alpha

Sweep order: the site pass evaluates the G or F MH log-ratio at the z it
has just drawn ("Z, then G | z" / "Z, then F | z"), a permutation of the
reference's G/F-then-Z order with the same invariant distribution.

The sweep never synchronises with the host: every accept is a
``torch.where`` on device tensors.  Randomness is counter-based
(``kernels/philox.py``): ``step(state, keys, step_idx)`` draws from the
(chain key, step index) counter space, so a trajectory is a function of the
seed alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from instruct_tpu_torch.config import ModelSpec, PriorFamily
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.s_pop import s_pop_tail
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.mcmc.state import McmcState
from instruct_tpu_torch.model import likelihood as lk


class StepDraws(NamedTuple):
    """Injected uniforms of one sweep, in the layouts of the kernels'
    ``test_draws`` / ``u`` arguments (tests feed the JAX kernels the same
    numbers).  ``None`` fields draw from Philox."""

    p: Optional[torch.Tensor] = None      # f32[C, n_test_draws, K*A, L]
    s: Optional[tuple] = None             # the S or F tail's uniforms:
    #   mode 2  (u_prop, u_acc f32[C, J*K], ug, ul f32[C, N])
    #   mode 3  (u_prop, u_acc f32[C, J, N], ug, ul f32[C, N])
    #   modes 4/5  (u_prop, u_acc f32[C, R])
    z: Optional[torch.Tensor] = None      # f32[C, N, 2L]
    q: Optional[torch.Tensor] = None      # f32[C, n_test_draws, K, N]
    alpha: Optional[tuple] = None         # (normal f32[C], uniform f32[C])


def check_supported(spec: ModelSpec, data: Dataset) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for every
    model outside the ported slices -- never a silent other path."""
    def no(what, item):
        raise NotImplementedError(
            f"instruct_tpu_torch: {what} is still to be ported "
            f"(ROADMAP: {item})")
    if spec.ploid != 2:
        no(f"ploidy {spec.ploid}", "K5-K7 with the tetraploid engine")
    if spec.mode not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"unknown mode {spec.mode}")
    if spec.mode == 0:
        no("mode 0", "K8, the unfused sweep and mode 0")
    if spec.priors.family != PriorFamily.UNIFORM:
        no(f"the {spec.priors.family.value} prior", "normal and DPM priors")
    if spec.marginalize_g:
        no("marginalize_g", "marg_g")
    if spec.back_refl != 1:
        no("the adaptive-independence proposal (back_refl=0)",
           "adaptive-independence proposal")
    if spec.use_pallas is False:
        no("the unfused sweep (use_pallas=False)",
           "K8, the unfused sweep and mode 0")
    if spec.n_pops * data.max_alleles > 64:
        no("a panel with n_pops * max_alleles > 64",
           "K8, the unfused sweep and mode 0")
    if spec.n_pops > fs.MAX_POPS:
        no(f"n_pops > {fs.MAX_POPS}", "wide-K site pass and S tail")


def build_step_parts(spec: ModelSpec, data: Dataset):
    """Return ``(step_core, add_loglik)`` for the fused sweep of the spec's
    mode.

    ``step_core(state, keys, step_idx, draws=None)`` runs the full
    parameter sweep of all chains; ``add_loglik(state)`` fills
    ``loglik_indv`` / ``loglik_total`` (cal_lkh, mcmc.c:1916-1942).  The
    split lets ``run_mcmc`` evaluate the log-likelihood only on stored or
    reported steps: it is an observable, not an input to any update.
    ``data`` must live on the device of the state.
    """
    check_supported(spec, data)
    k = spec.n_pops
    a = data.max_alleles
    n = data.n_indv
    structure = spec.type_freq == 1
    sweeps = max(1, spec.s_subsweeps)

    def finish(state, keys, step_idx, d, z, qqnum, zcounts, **changed):
        """Q | Z ~ Dirichlet(counts + alpha), one draw per (chain,
        individual); then the alpha MH step.  The sampling pass returns
        the allele-pop counts of the fresh z; where it did not (generic
        path) they are recounted with the ``allele_counts`` kernel."""
        q_new = dk.dirichlet_nk(keys, step_idx,
                                qqnum + state.alpha[:, None, None],
                                test_draws=d.q)
        alpha = up.update_alpha(keys, step_idx, spec, q_new, state.alpha,
                                test_draws=d.alpha)
        if zcounts is None:
            zcounts = fs.allele_counts(z, data.geno, data.site_valid,
                                       n_pops=k, max_alleles=a,
                                       bits2=data.bits2)
        return state._replace(z=z, q=q_new, alpha=alpha, zcounts=zcounts,
                              **changed)

    def s_ind_tail(state, keys, step_idx, d):
        """Mode 3: J elementwise MH subsweeps on the per-individual S
        (update_S_IND), then the G proposal g' ~ Geom(1 - s_i), the
        generation weights 2^(1-g) and the accept log-uniforms."""
        if d.s is None:
            w = up.tail_uniforms(keys, step_idx, 4, sweeps * n)
            u_prop, u_acc = (w[:, i].reshape(-1, sweeps, n) for i in (0, 1))
            ug, ul = w[:, 2, :n], w[:, 3, :n]
        else:
            u_prop, u_acc, ug, ul = d.s
        rates = up.update_s_ind(u_prop, u_acc, spec, state.gen, state.rates)
        gen_prop = up.sample_geometric(ug, rates, spec.gen_cap)
        wg_pair = torch.exp2(1.0 - torch.stack(
            [state.gen, gen_prop], dim=-1).to(torch.float32))
        return rates, gen_prop, wg_pair, torch.log(ul)

    def f_sweep(state, keys, step_idx, d, freq):
        """Modes 4/5: the F random-walk proposal, the fused Z-Gibbs + F-MH
        pass, the accept (mcmc_POP_inbreedcoff / mcmc_INDV_inbreedcoff,
        mcmc.c:242-293, 386-468)."""
        r = state.rates.shape[1]
        if d.s is None:
            w = up.tail_uniforms(keys, step_idx, 2, r)
            u_prop, u_acc = w[:, 0], w[:, 1]
        else:
            u_prop, u_acc = d.s
        prop = up.propose_back_reflection(u_prop, state.rates,
                                          spec.mh_step_s)
        f_pair = torch.stack([state.rates, prop], dim=-1)     # [C, R, 2]
        z, qqnum, ll, zcounts = fs.zq_f_pass(
            keys, step_idx, state.q, freq, data, f_pair,
            pop=(spec.mode == 4), u=d.z)
        # mode 4: the per-individual sums of each pop add up over N
        log_ratio = ll.sum(dim=1) if spec.mode == 4 else ll
        rates = torch.where(torch.log(u_acc) < log_ratio, prop, state.rates)
        return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                      freq=freq, rates=rates)

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws: Optional[StepDraws] = None) -> McmcState:
        d = draws if draws is not None else StepDraws()
        # P | Z from the counts carried out of the previous site pass
        # (update_P, mcmc.c:799-861)
        freq = dk.dirichlet_kla(keys, step_idx, state.zcounts + 1.0,
                                data.allele_valid, test_draws=d.p)
        if spec.mode in (4, 5):
            return f_sweep(state, keys, step_idx, d, freq)
        if spec.mode == 1:
            # sampling only; cal_lkh is deferred to stored steps
            z, qqnum, zcounts = fs.zq_sample_pass(
                keys, step_idx, state.q, freq, data, u=d.z)
            return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                          freq=freq)
        # modes 2/3: S subsweeps + G proposal + generation weights + accept
        # uniforms, then the fused Z-Gibbs + G-MH pass and the G accept
        if spec.mode == 2:
            rates, gen_prop, wg_pair, logu = s_pop_tail(
                keys, step_idx, state.q, state.gen, state.rates,
                subsweeps=spec.s_subsweeps, delta0=spec.mh_step_s,
                gen_cap=spec.gen_cap, test_draws=d.s)
        else:
            rates, gen_prop, wg_pair, logu = s_ind_tail(state, keys,
                                                        step_idx, d)
        z, qqnum, ll_diff, zcounts = fs.zq_gendiff_pass(
            keys, step_idx, state.q, freq, data, wg_pair,
            structure=structure, u=d.z)
        gen = torch.where(logu < ll_diff, gen_prop, state.gen)
        return finish(state, keys, step_idx, d, z, qqnum, zcounts,
                      freq=freq, rates=rates, gen=gen)

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
        return state._replace(loglik_indv=ll_indv,
                              loglik_total=ll_indv.sum(dim=-1))

    return step, add_loglik


def build_marg_loglik(spec: ModelSpec, data: Dataset):
    """``add_marg(state) -> state`` filling ``state.loglik_marg`` with the
    Z-marginalized per-individual log-likelihood
    (``model/likelihood.py:marginal_site_loglik``) that feeds WAIC and the
    corrected DIC.  ``run_mcmc`` calls it only every
    ``Schedule.dic_every``-th stored step."""
    check_supported(spec, data)

    def add_marg(state: McmcState) -> McmcState:
        indv = lk.marginal_indv_loglik(spec, data, state.freq, state.q,
                                       state.gen, state.rates)
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
