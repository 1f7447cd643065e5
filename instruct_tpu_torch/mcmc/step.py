"""Composition of the update kernels into one fused MCMC sweep (mode 2).

Counterpart of ``instruct_tpu/mcmc/step.py``: ``_build_fused_parts``
(:122-356 there, mode-2 branch), ``build_marg_loglik`` (:480, diploid
branch) and ``build_step`` (:549).  One call of ``step`` is one full sweep
for ALL chains (leading axis ``C``):

    P | Z      Dirichlet(zcounts + 1)              kernels/dirichlet.py
    S, G'      J*K MH subsweeps + G proposal       kernels/s_pop.py
    Z, G | z   site pass: z draw, counts, MH ratio kernels/fused_step.py
    Q | Z      Dirichlet(qqnum + alpha)            kernels/dirichlet.py
    alpha      MH                                  mcmc/updates.py

Sweep order: the site pass evaluates the G MH log-ratio at the z it has
just drawn ("Z, then G | z"), a permutation of the reference's G-then-Z
order (mcmc.c:208-215) with the same invariant distribution.

The sweep never synchronises with the host: the G accept, the alpha accept
and everything else are ``torch.where`` on device tensors.  Randomness is
counter-based (``kernels/philox.py``): ``step(state, keys, step_idx)``
draws from the (chain key, step index) counter space, so a trajectory is a
function of the seed alone.
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
    s: Optional[tuple] = None             # (u_prop, u_acc, ug, ul)
    z: Optional[torch.Tensor] = None      # f32[C, N, 2L]
    q: Optional[torch.Tensor] = None      # f32[C, n_test_draws, K, N]
    alpha: Optional[tuple] = None         # (normal f32[C], uniform f32[C])


def check_supported(spec: ModelSpec, data: Dataset) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for every
    model outside the ported slice -- never a silent other path."""
    def no(what, item):
        raise NotImplementedError(
            f"instruct_tpu_torch: {what} is still to be ported "
            f"(ROADMAP: {item})")
    if spec.ploid != 2:
        no(f"ploidy {spec.ploid}", "K5-K7 with the tetraploid engine")
    if spec.mode not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"unknown mode {spec.mode}")
    if spec.mode != 2:
        no(f"mode {spec.mode}", "modes 1/3/4/5/0")
    if spec.priors.family != PriorFamily.UNIFORM:
        no(f"the {spec.priors.family.value} prior", "normal and DPM priors")
    if spec.marginalize_g:
        no("marginalize_g", "marg_g")
    if spec.back_refl != 1:
        no("the adaptive-independence proposal (back_refl=0)",
           "adaptive-independence proposal")
    if spec.use_pallas is False:
        no("the unfused sweep (use_pallas=False)", "unfused XLA-order sweep")
    if data.bits2 is None or data.max_alleles != 2:
        no("the generic A > 2 site path", "remaining K1 variants")
    if spec.n_pops > fs.MAX_POPS:
        no(f"n_pops > {fs.MAX_POPS}", "wide-K site pass and S tail")


def build_step_parts(spec: ModelSpec, data: Dataset):
    """Return ``(step_core, add_loglik)`` for the mode-2 fused sweep.

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
    structure = spec.type_freq == 1

    def draw_q(keys, step_idx, qqnum, alpha, test_draws=None):
        """Q | Z ~ Dirichlet(counts + alpha), one draw per (chain,
        individual)."""
        return dk.dirichlet_nk(keys, step_idx, qqnum + alpha[:, None, None],
                               test_draws=test_draws)

    def _recount(z, zcounts):
        """The sampling pass returns the allele-pop counts of the fresh z;
        recount with the ``allele_counts`` kernel where it did not."""
        if zcounts is not None:
            return zcounts
        return fs.allele_counts(z, data.geno, data.site_valid, n_pops=k,
                                max_alleles=a, bits2=data.bits2)

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws: Optional[StepDraws] = None) -> McmcState:
        d = draws if draws is not None else StepDraws()
        # P | Z from the counts carried out of the previous site pass
        # (update_P, mcmc.c:799-861)
        freq = dk.dirichlet_kla(keys, step_idx, state.zcounts + 1.0,
                                data.allele_valid, test_draws=d.p)
        # S subsweeps + G proposal + generation weights + accept uniforms
        rates, gen_prop, wg_pair, logu = s_pop_tail(
            keys, step_idx, state.q, state.gen, state.rates,
            subsweeps=spec.s_subsweeps, delta0=spec.mh_step_s,
            gen_cap=spec.gen_cap, test_draws=d.s)
        z, qqnum, ll_diff, zcounts = fs.zq_gendiff_pass(
            keys, step_idx, state.q, freq, data.bits2, wg_pair,
            structure=structure, u=d.z)
        gen = torch.where(logu < ll_diff, gen_prop, state.gen)
        q_new = draw_q(keys, step_idx, qqnum, state.alpha, d.q)
        alpha = up.update_alpha(keys, step_idx, spec, q_new, state.alpha,
                                test_draws=d.alpha)
        return state._replace(freq=freq, rates=rates, z=z, q=q_new,
                              alpha=alpha, gen=gen,
                              zcounts=_recount(z, zcounts))

    def add_loglik(state: McmcState) -> McmcState:
        wg = torch.exp2(1.0 - state.gen.to(torch.float32))
        ll_indv = fs.panel_loglik_pass(state.freq, state.q, data.bits2,
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
                                       state.gen.to(torch.float32),
                                       state.rates)
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
