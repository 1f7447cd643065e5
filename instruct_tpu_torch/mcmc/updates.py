"""Update helpers of the fused sweeps (modes 1-5) that run outside the hand
kernels.

Counterpart of ``instruct_tpu/mcmc/updates.py`` for what the fused step and
``run_mcmc`` use: :func:`allele_pop_counts` (:82 there),
:func:`update_alpha` (:233), :func:`back_reflect` (:272),
:func:`propose_back_reflection` (:278), :func:`update_s_ind` (:377, uniform
prior), :func:`sample_geometric` (:426), :func:`empty_cluster_flag` (:541)
and :func:`dirichlet_from_counts` (:66, initialisation only); and the
unfused inbreeding updates :func:`update_f_pop` (:478) and
:func:`update_f_ind` (:514), the plain functions the fused F passes are held
against.  Chains are a written-out leading axis, and every function takes
its uniforms as arguments (the step draws them from Philox,
:func:`tail_uniforms`).  The other unfused updates (``update_zq``,
``update_gen``, ``update_s_pop`` ...), the normal prior's terms and the
adaptive-independence proposal wait for their slices.
"""

from __future__ import annotations

import math

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.model import likelihood as lk

_EPS = 1e-30


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


def dirichlet_from_counts(generator: torch.Generator, conc, valid=None):
    """Sample Dirichlet(conc) rows (last axis) by gamma-normalisation,
    respecting a padding mask (replaces rdirich, random.c).  Exact gamma
    draws from ``generator``; used at initialisation only -- the sweep
    draws through ``kernels/dirichlet.py``."""
    safe = torch.clamp_min(conc, 1e-6)
    if valid is not None:
        safe = torch.where(valid, safe, torch.ones_like(safe))
    g = torch._standard_gamma(safe, generator=generator)
    if valid is not None:
        g = torch.where(valid, g, torch.zeros_like(g))
    return g / torch.clamp_min(g.sum(-1, keepdim=True), _EPS)


def allele_pop_counts(spec: ModelSpec, data: Dataset, z, zz=None):
    """seqpop f32[C, K, L, A]: valid allele copies per (chain, pop, locus,
    allele) in plain tensor code (the counting loops of update_P,
    mcmc.c:815-845) -- the reference of the ``allele_counts`` kernel."""
    if spec.mode == 0:
        raise NotImplementedError(
            "allele_pop_counts: mode 0 is still to be ported (ROADMAP)")
    l, p = data.n_loci, data.ploid
    a = data.allele_valid.shape[1]
    geno_c = lk.split_copies(data.geno[None], p)
    z_c = lk.split_copies(z, p)
    valid = data.site_valid[None]
    out = []
    for kk in range(spec.n_pops):
        per_allele = []
        for ai in range(a):
            acc = torch.zeros((z.shape[0], l), dtype=torch.float32,
                              device=z.device)
            for c in range(p):
                m = valid & (z_c[c] == kk) & (geno_c[c] == ai)
                acc = acc + m.sum(dim=1).to(torch.float32)
            per_allele.append(acc)
        out.append(torch.stack(per_allele, dim=-1))          # [C, L, A]
    return torch.stack(out, dim=1)                           # [C, K, L, A]


def alpha_draws(keys: px.RngKeys, step: int):
    """(normal f32[C], uniform f32[C]) of the alpha MH step: a Box-Muller
    normal from Philox words 0, 1 and the accept uniform from word 2 of the
    (chain, step, ``STREAM_ALPHA``) block."""
    u = px.u01_open(px.random_words(keys, step, px.STREAM_ALPHA, 3))
    normal = (torch.sqrt(-2.0 * torch.log(u[:, 0]))
              * torch.cos((2.0 * math.pi) * u[:, 1]))
    return normal, u[:, 2]


def update_alpha(keys: px.RngKeys, step: int, spec: ModelSpec, q, alpha,
                 active=None, test_draws=None):
    """MH on alpha with a Normal(alpha, alpha_sd) proposal (update_alpha,
    mcmc.c:1244-1263), all chains at once: q f32[C, N, K], alpha f32[C].

    Target: prod_i Dirichlet(q_i | alpha * 1_K), with the correct density
    ratio including the Gamma normalisers
        N [lnG(K a') - K lnG(a')] - N [lnG(K a) - K lnG(a)]
        + (a' - a) sum_{i,m} log q_im.
    Proposals <= 0 are rejected outright, as in the reference.
    ``test_draws`` = (normal f32[C], uniform f32[C]) injects the draws.
    """
    if active is not None:
        raise NotImplementedError(
            "update_alpha: the padded K-selection grid (active) is still "
            "to be ported (ROADMAP: kselect)")
    normal, u = alpha_draws(keys, step) if test_draws is None else test_draws
    prop = alpha + spec.alpha_sd * normal
    n, k = q.shape[1], spec.n_pops
    sum_log_q = _slog(q).sum(dim=(1, 2))

    def norm_term(a):
        return n * (torch.lgamma(k * a) - k * torch.lgamma(a))

    safe_prop = torch.clamp_min(prop, 1e-6)
    log_ratio = (norm_term(safe_prop) - norm_term(alpha)
                 + (safe_prop - alpha) * sum_log_q)
    accept = (prop > 0) & (torch.log(torch.clamp_min(u, _EPS)) < log_ratio)
    return torch.where(accept, safe_prop, alpha)


def back_reflect(x):
    """Reflective bounds on [0,1] (mcmc.c:942-945)."""
    x = torch.abs(x)
    return torch.where(x >= 1.0, 2.0 - x, x)


def tail_uniforms(keys: px.RngKeys, step: int, n_streams: int,
                  n_words: int):
    """f32[C, n_streams, n_words] in (0, 1): the first ``n_streams`` of the
    tail streams (``STREAM_R_PROP``, ``STREAM_R_ACC``, ``STREAM_G_PROP``,
    ``STREAM_G_ACC``), one launch."""
    return px.u01_open(px.random_streams(keys, step, px.STREAM_R_PROP,
                                         n_streams, n_words))


def propose_back_reflection(u, rates, delta0: float):
    """Random walk +-delta0 with reflection (mcmc.c:939-945) from uniforms
    ``u`` of the shape of ``rates``."""
    return back_reflect(rates + (u * 2.0 * delta0 - delta0))


def update_s_ind(u_prop, u_acc, spec: ModelSpec, gen, rates):
    """Mode 3: per-individual MH random walk on S with the geometric
    likelihood of G (update_S_IND, mcmc.c:864-886), uniform prior.
    Individuals are conditionally independent, so all C x N proposals run
    at once.  ``gen`` i32[C, N], ``rates`` f32[C, N]; ``u_prop``, ``u_acc``
    f32[C, J, N] drive J such updates in turn (the step's subsweeps).  What
    does not change between subsweeps (the proposal steps, the accept
    log-uniforms, the current state's log-target) is computed once, so a
    subsweep is a dozen and a half elementwise launches."""
    g1 = (gen - 1).to(rates.dtype)
    # gen == 1 contributes no s term even when s == 0
    g1 = torch.where(g1 > 0, g1, torch.zeros_like(g1))

    def lp(s):
        return g1 * _slog(s) + _slog(1.0 - s)

    steps = u_prop * 2.0 * spec.mh_step_s - spec.mh_step_s
    logu = _slog(u_acc)
    lp_cur = lp(rates)
    for j in range(u_prop.shape[1]):
        prop = back_reflect(rates + steps[:, j])
        lp_prop = lp(prop)
        accept = logu[:, j] < lp_prop - lp_cur
        rates = torch.where(accept, prop, rates)
        lp_cur = torch.where(accept, lp_prop, lp_cur)
    return rates


def _f_site_terms(data: Dataset, freq, z):
    """Shared per-site quantities of the unfused F updates: per-copy probs
    and the mask of valid sites whose copies share one pop -- only those
    depend on F (log_ld_F_*, mcmc.c:1789-1805)."""
    p0, p1 = lk.split_copies(lk.gather_freq_at_z(freq, data, z), data.ploid)
    z0, z1 = lk.split_copies(z, data.ploid)
    return p0, p1, z0, (z0 == z1) & data.site_valid[None]


def update_f_pop(u_prop, u_acc, spec: ModelSpec, data: Dataset, freq, z,
                 rates):
    """Mode 4: MH on the per-subpop inbreeding coefficients at the carried
    z (update_inbreedcoff_POP, mcmc.c:986-1050, with a standard MH accept),
    back-reflection proposal.  F_j only affects sites with both copies in
    pop j, so the K decisions decouple.  ``rates``, ``u_prop``, ``u_acc``
    f32[C, K].  The fused sweep runs :func:`zq_f_pass` instead, at the
    fresh z."""
    p0, p1, z0, mask = _f_site_terms(data, freq, z)
    prop = propose_back_reflection(u_prop, rates, spec.mh_step_s)
    hom = data.hom[None]
    idx = z0.to(torch.int64).flatten(1)

    def ll(f):
        f_site = torch.gather(f, 1, idx).reshape(z0.shape)
        return _slog(lk.genofreq_inbreeding(p0, p1, hom, f_site))

    diff = torch.where(mask, ll(prop) - ll(rates), torch.zeros_like(p0))
    delta = torch.stack([torch.where(z0 == kk, diff, torch.zeros_like(diff))
                         .sum(dim=(1, 2)) for kk in range(spec.n_pops)],
                        dim=1)
    return torch.where(_slog(u_acc) < delta, prop, rates)


def update_f_ind(u_prop, u_acc, spec: ModelSpec, data: Dataset, freq, z,
                 rates):
    """Mode 5: per-individual MH random walk on F at the carried z
    (update_F_IND, mcmc.c:888-910), uniform prior; ``rates``, ``u_prop``,
    ``u_acc`` f32[C, N].  The fused sweep runs :func:`zq_f_pass` instead,
    at the fresh z."""
    p0, p1, _, mask = _f_site_terms(data, freq, z)
    prop = propose_back_reflection(u_prop, rates, spec.mh_step_s)
    hom = data.hom[None]

    def lp(f):
        site = _slog(lk.genofreq_inbreeding(p0, p1, hom, f[:, :, None]))
        return torch.where(mask, site, torch.zeros_like(site)).sum(dim=2)

    return torch.where(_slog(u_acc) < lp(prop) - lp(rates), prop, rates)


def sample_geometric(u, sbar, cap: int):
    """g ~ Geom(1 - sbar) on {1, 2, ...} from uniforms ``u``, clipped to
    [1, cap] with the boundary-state overrides of update_G
    (mcmc.c:1071-1084): sbar ~= 0 -> g = 1, sbar ~= 1 -> g = cap."""
    eps = 1e-3
    s = torch.clamp(sbar, 1e-6, 1.0 - 1e-6)
    x = torch.floor(torch.log(u) / torch.log(s))
    g = 1 + torch.clamp(x, 0.0, float(cap)).to(torch.int32)
    g = torch.clamp(g, 1, cap)
    g = torch.where(sbar <= eps, torch.ones_like(g), g)
    return torch.where(sbar >= 1.0 - eps, torch.full_like(g, cap), g)


def empty_cluster_flag(q, active=None) -> torch.Tensor:
    """bool[C]: any cluster's total occupancy sum_i q_ik < 0.01
    (check_empty_cluster, mcmc.c:1944-1974)."""
    if active is not None:
        raise NotImplementedError(
            "empty_cluster_flag: the padded K-selection grid (active) is "
            "still to be ported (ROADMAP: kselect)")
    if q.numel() == 0:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    return (q.sum(dim=1) < 0.01).any(dim=-1)
