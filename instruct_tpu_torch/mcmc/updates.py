"""The update functions of the sweeps that run outside the hand kernels,
and the unfused updates that launch them.

Counterpart of ``instruct_tpu/mcmc/updates.py``, function by function:
:func:`allele_pop_counts` (:82 there), :func:`update_freq` (:115),
:func:`update_zq` (:130), :func:`update_z_noadmix` (:187),
:func:`update_alpha` (:233), :func:`back_reflect` (:272),
:func:`propose_back_reflection` (:278),
:func:`propose_adaptive_independence` (:284), :func:`update_s_pop` (:333),
:func:`update_s_ind` (:377), :func:`update_normal_hyper` (:402),
:func:`sample_geometric` (:426), :func:`update_gen` (:440),
:func:`update_f_pop` (:478), :func:`update_f_ind` (:514),
:func:`empty_cluster_flag` (:541) and :func:`dirichlet_from_counts` (:66,
initialisation only).  Chains are a written-out leading axis, and every
function takes its uniforms as arguments (the step draws them from Philox,
:func:`tail_uniforms`), so a test can feed it the numbers that the JAX
function draws from its key.  ``active`` f32[C, K] is the padded K grid's
active-pop mask (``kselect.py``; 1.0 for a slot in use, the active slots
leading): q puts exactly zero mass on the other slots, and z never selects
one.  ``update_freq`` and ``update_zq`` draw inside
their kernels (``kernels/dirichlet.py``, ``kernels/fused_step.py``,
``kernels/zq.py``) and take injected uniforms as optional arguments.
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.config import ModelSpec, Priors
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.zq import zq_sample_counts
from instruct_tpu_torch.model import likelihood as lk

_EPS = 1e-30


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


def psum(x, mesh=None):
    """The sum of ``x`` over the loci shards of the mesh's data axis
    (``parallel/mesh.py:Mesh.all_reduce_``); the identity without a mesh
    or when the loci are whole.  Its calls are the only communication of
    a sharded sweep: the pop counts before the Q draw, the MH log-ratio
    columns and the per-individual log-liks (JAX ``_psum``, :47)."""
    return x if mesh is None else mesh.all_reduce_(x)


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
    mcmc.c:815-845) -- the reference of the ``allele_counts`` kernel.
    Mode 0: the per-individual count matrix contracted with one-hot(zz),
    ``zz`` i32[C, N]."""
    if spec.mode == 0:
        cnt = lk.allele_count_matrix(data)                   # [N, A, L]
        n, a, l = cnt.shape
        onehot = torch.stack([(zz == kk).to(torch.float32)
                              for kk in range(spec.n_pops)], dim=1)
        out = torch.matmul(onehot, cnt.reshape(1, n, a * l))  # [C, K, A*L]
        return out.reshape(-1, spec.n_pops, a, l).transpose(2, 3).contiguous()
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


def update_freq(keys: px.RngKeys, step: int, spec: ModelSpec, data: Dataset,
                z, zz=None, test_draws=None):
    """P | Z ~ Dirichlet(counts + 1) per (chain, pop, locus), padded alleles
    masked (update_P, mcmc.c:846-857; the +1 pseudocount is lambda = 1.0 at
    mcmc.c:805).  The counts come from the ``allele_counts`` kernel (mode 0:
    one matrix product, :func:`allele_pop_counts`), the draw from the
    Dirichlet kernel; ``test_draws`` as in ``dirichlet_kla``."""
    if spec.mode == 0:
        counts = allele_pop_counts(spec, data, None, zz)
    else:
        counts = fs.allele_counts(z, data.geno, data.site_valid,
                                  n_pops=spec.n_pops,
                                  max_alleles=data.max_alleles,
                                  bits2=data.bits2)
    return dk.dirichlet_kla(px.site_keys(keys), step, counts + 1.0,
                            data.allele_valid, test_draws=test_draws)


def mask_active(q, active=None):
    """Q rows restricted to the active slots: the Dirichlet draw's inactive
    columns zeroed and each row renormalized -- exactly a Dirichlet over the
    active slots, whose normalization the padded components leave (JAX
    ``step.py:draw_q``, :163-178).  ``active`` None: all slots, q as is."""
    if active is None:
        return q
    q = q * active[:, None, :]
    return q / torch.clamp_min(q.sum(-1, keepdim=True), _EPS)


def update_zq(keys: px.RngKeys, step: int, spec: ModelSpec, data: Dataset,
              freq, q, alpha, u=None, q_draws=None, active=None, mesh=None):
    """Gibbs z per allele copy, then Q | Z ~ Dirichlet(counts + alpha)
    (update_ZQ, mcmc.c:1122-1199): z[n, s] ~ Cat_k(q[n, k] * freq[k, l,
    a_ns]), mcmc.c:1146.  The z draw and the counts are one launch of
    ``zq_sample_counts``, the Q draw one of ``dirichlet_nk``.  ``u``
    f32[C, N, S] and ``q_draws`` (as ``dirichlet_nk``'s ``test_draws``)
    inject the uniforms; with ``active`` the Q draw is masked
    (:func:`mask_active`).  Returns (z int8[C, N, S], q f32[C, N, K], qqnum
    f32[C, N, K]; the counts summed over the loci shards of ``mesh``).
    z draws from the site keys, Q from the run's."""
    z, qqnum = zq_sample_counts(px.site_keys(keys), step, q, freq,
                                data.geno, data.site_valid,
                                n_pops=spec.n_pops, u=u)
    qqnum = psum(qqnum, mesh)
    q_new = dk.dirichlet_nk(keys, step, qqnum + alpha[:, None, None],
                            test_draws=q_draws)
    return z, mask_active(q_new, active), qqnum


def update_z_noadmix(u, data: Dataset, freq, active=None, mesh=None):
    """Mode 0: one z per individual, Gibbs over K with full-genome log-liks
    (update_Z, mcmc.c:1094-1119 via log_ld_indv_K), by inverse CDF on the
    normalised weights exp(ll - max ll) from the uniforms ``u`` f32[C, N];
    with ``active`` the inactive slots weigh 0 (log-lik -inf), so the
    draw never selects one.  Returns zz i32[C, N]."""
    ll = psum(lk.loglik_matrix_nopop_admix(data, freq), mesh)  # [C, N, K]
    if active is not None:
        ll = torch.where(active[:, None, :] > 0, ll,
                         torch.full_like(ll, float("-inf")))
    w = torch.exp(ll - ll.max(dim=-1, keepdim=True).values)
    cum = torch.cumsum(w, dim=-1)
    ut = u * cum[:, :, -1]
    return (ut[:, :, None] > cum[:, :, :-1]).sum(dim=-1).to(torch.int32)


def alpha_draws(keys: px.RngKeys, step: int):
    """(normal f32[C], uniform f32[C]) of the alpha MH step: a Box-Muller
    normal from Philox words 0, 1 and the accept uniform from word 2 of the
    (chain, step, ``STREAM_ALPHA``) block."""
    u = px.u01_open(px.random_words(keys, step, px.STREAM_ALPHA, 3))
    return dk.box_muller(u[:, 0], u[:, 1]), u[:, 2]


def update_alpha(keys: px.RngKeys, step: int, spec: ModelSpec, q, alpha,
                 active=None, test_draws=None):
    """MH on alpha with a Normal(alpha, alpha_sd) proposal (update_alpha,
    mcmc.c:1244-1263), all chains at once: q f32[C, N, K], alpha f32[C].

    Target: prod_i Dirichlet(q_i | alpha * 1_K), with the correct density
    ratio including the Gamma normalisers
        N [lnG(K a') - K lnG(a')] - N [lnG(K a) - K lnG(a)]
        + (a' - a) sum_{i,m} log q_im.
    Proposals <= 0 are rejected outright, as in the reference.
    With ``active`` the density is over each chain's active slots: K is its
    active count and the log-q sum is masked (inactive columns hold exact
    zeros).  ``test_draws`` = (normal f32[C], uniform f32[C]) injects the
    draws.
    """
    normal, u = alpha_draws(keys, step) if test_draws is None else test_draws
    prop = alpha + spec.alpha_sd * normal
    n = q.shape[1]
    if active is None:
        k = spec.n_pops
        sum_log_q = _slog(q).sum(dim=(1, 2))
    else:
        k = torch.clamp_min(active.sum(-1), 1.0)
        sum_log_q = (_slog(q) * active[:, None, :]).sum(dim=(1, 2))

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
    ``STREAM_G_ACC``, ``STREAM_R_FRESH``, ``STREAM_HYPER``), one launch."""
    return px.u01_open(px.random_streams(keys, step, px.STREAM_R_PROP,
                                         n_streams, n_words))


def propose_back_reflection(u, rates, delta0: float):
    """Random walk +-delta0 with reflection (mcmc.c:939-945) from uniforms
    ``u`` of the shape of ``rates``."""
    return back_reflect(rates + (u * 2.0 * delta0 - delta0))


def propose_adaptive_independence(u, fresh, rates, ais_state):
    """3-state adaptive independence sampler (adpt_indp, mcmc.c:1461-1519)
    from the uniforms ``u`` (state transition) and ``fresh`` (the new value
    inside (0, 1)), both of the shape of ``rates``.

    States: 0 -> {0}, 1 -> (0,1), 2 -> {1}.  Transition kernel:
      from 0: 0.5 stay at 0.0, 0.5 draw U(0,1)
      from 2: 0.5 stay at 1.0, 0.5 draw U(0,1)
      from 1: 0.05 -> 0.0, 0.05 -> 1.0, 0.90 draw U(0,1)
    Returns (proposed_rates, proposed_state, log_hastings) with
    log_hastings = log q(prev|new) - log q(new|prev) per coordinate
    (hastings_stat, mcmc.c:1550-1593)."""
    zero, one, two = (torch.full_like(ais_state, v) for v in (0, 1, 2))
    st0 = torch.where(u < 0.5, zero, one)
    st2 = torch.where(u < 0.5, two, one)
    st1 = torch.where(u <= 0.05, zero, torch.where(u >= 0.95, two, one))
    new_state = torch.where(ais_state == 0, st0,
                            torch.where(ais_state == 2, st2, st1))
    new_rates = torch.where(new_state == 0, torch.zeros_like(fresh),
                            torch.where(new_state == 2,
                                        torch.ones_like(fresh), fresh))

    def q_trans(a, b):
        # q(a -> b) as in q() (mcmc.c:1566-1593)
        f = torch.zeros_like(fresh)
        from0 = torch.where(b == 2, f, f + 0.5)
        from2 = torch.where(b == 0, f, f + 0.5)
        from1 = torch.where(b == 1, f + 0.90, f + 0.05)
        return torch.where(a == 0, from0, torch.where(a == 2, from2, from1))

    log_hastings = (_slog(q_trans(new_state, ais_state))
                    - _slog(q_trans(ais_state, new_state)))
    return new_rates, new_state, log_hastings


def _propose(spec: ModelSpec, u_prop, u_fresh, rates, ais_state):
    """The spec's S/F proposal: (proposed rates, proposed 3-state flags,
    log Hastings ratio).  Back-reflection is symmetric and carries the
    flags along unchanged."""
    if spec.back_refl == 1:
        return (propose_back_reflection(u_prop, rates, spec.mh_step_s),
                ais_state, torch.zeros_like(rates))
    return propose_adaptive_independence(u_prop, u_fresh, rates, ais_state)


def mix_rates(q, rates):
    """sbar f32[C, N] = sum_k q[c, n, k] * rates[c, k], added in the order
    of k so that the card and the CPU round alike (update_S_POP's expected
    per-individual selfing rate, mcmc.c:1063-1066)."""
    sbar = rates[:, 0, None] * q[:, :, 0]
    for kk in range(1, q.shape[2]):
        sbar = sbar + rates[:, kk, None] * q[:, :, kk]
    return sbar


def update_s_pop(u_prop, u_acc, spec: ModelSpec, q, gen, rates, ais_state,
                 u_fresh=None):
    """Mode 2: MH per subpopulation on S (update_S_POP, mcmc.c:913-983).

    Target is the likelihood of the generation latents given the expected
    per-individual selfing rate sbar_i = sum_k q_ik s_k (proposal(),
    mcmc.c:1630-1648).  Pops are updated one at a time (the target couples
    them through sbar); each evaluation is O(N) thanks to the rank-1 update
    sbar' = sbar + q[:, j] (s'_j - s_j), and the current state's target is
    carried from one decision to the next.  ``u_prop``, ``u_acc`` (and
    ``u_fresh`` under the adaptive-independence proposal) f32[C, J, K] drive
    J such sweeps over the pops in turn; ``rates`` f32[C, K], ``ais_state``
    i32[C, K].  Returns (rates, ais_state)."""
    k = spec.n_pops
    g1 = (gen - 1).to(rates.dtype)
    has_g = g1 > 0
    logu = _slog(u_acc)

    def target(sbar):
        # gen == 1 contributes no sbar term even when sbar == 0
        t = (torch.where(has_g, g1 * _slog(sbar), torch.zeros_like(sbar))
             + _slog(1.0 - sbar))
        return t.sum(dim=1)

    sbar = mix_rates(q, rates)
    f_cur = target(sbar)
    for j in range(u_prop.shape[1]):
        prop, prop_states, log_hast = _propose(
            spec, u_prop[:, j], None if u_fresh is None else u_fresh[:, j],
            rates, ais_state)
        r = [rates[:, kk] for kk in range(k)]
        accepts = []
        for kk in range(k):
            s_new = prop[:, kk]
            sbar_new = sbar + q[:, :, kk] * (s_new - r[kk])[:, None]
            f_new = target(sbar_new)
            accept = logu[:, j, kk] < f_new - f_cur + log_hast[:, kk]
            accepts.append(accept)
            r[kk] = torch.where(accept, s_new, r[kk])
            sbar = torch.where(accept[:, None], sbar_new, sbar)
            f_cur = torch.where(accept, f_new, f_cur)
        rates = torch.stack(r, dim=1)
        if spec.back_refl != 1:
            ais_state = torch.where(torch.stack(accepts, dim=1), prop_states,
                                    ais_state)
    return rates, ais_state


def normal_prior(x, prior_mu, prior_sigma2):
    """Log N(mu, sigma^2) density of ``x`` f32[C, R] up to a constant, per
    chain hyperparameters f32[C]."""
    return -0.5 * (x - prior_mu[:, None]) ** 2 / prior_sigma2[:, None]


def update_s_ind(u_prop, u_acc, spec: ModelSpec, gen, rates, prior_mu=None,
                 prior_sigma2=None):
    """Mode 3: per-individual MH random walk on S with the geometric
    likelihood of G (update_S_IND, mcmc.c:864-886).  Individuals are
    conditionally independent, so all C x N proposals run at once.  ``gen``
    i32[C, N], ``rates`` f32[C, N]; ``u_prop``, ``u_acc`` f32[C, J, N] drive
    J such updates in turn (the step's subsweeps).  With the normal prior
    (``prior_mu``, ``prior_sigma2`` f32[C]) the target carries its
    N(mu, sigma^2) terms.  What does not change between subsweeps (the
    proposal steps, the accept log-uniforms, the current state's
    log-target) is computed once, so a subsweep is a dozen and a half
    elementwise launches."""
    g1 = (gen - 1).to(rates.dtype)
    # gen == 1 contributes no s term even when s == 0
    g1 = torch.where(g1 > 0, g1, torch.zeros_like(g1))

    def lp(s):
        out = g1 * _slog(s) + _slog(1.0 - s)
        if prior_mu is not None:
            out = out + normal_prior(s, prior_mu, prior_sigma2)
        return out

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
                 rates, ais_state, u_fresh=None, mesh=None):
    """Mode 4: MH on the per-subpop inbreeding coefficients at the carried
    z (update_inbreedcoff_POP, mcmc.c:986-1050, with a standard MH accept).
    F_j only affects sites with both copies in pop j, so the K decisions
    decouple.  ``rates``, ``u_prop``, ``u_acc`` f32[C, K], ``ais_state``
    i32[C, K]; the adaptive-independence proposal (``spec.back_refl == 0``)
    also takes ``u_fresh`` f32[C, K].  Returns (rates, ais_state).  The fused sweep runs :func:`zq_f_pass` instead, at the
    fresh z."""
    p0, p1, z0, mask = _f_site_terms(data, freq, z)
    prop, prop_states, log_hast = _propose(spec, u_prop, u_fresh, rates,
                                           ais_state)
    hom = data.hom[None]
    idx = z0.to(torch.int64).flatten(1)

    def ll(f):
        f_site = torch.gather(f, 1, idx).reshape(z0.shape)
        return _slog(lk.genofreq_inbreeding(p0, p1, hom, f_site))

    diff = torch.where(mask, ll(prop) - ll(rates), torch.zeros_like(p0))
    delta = torch.stack([torch.where(z0 == kk, diff, torch.zeros_like(diff))
                         .sum(dim=(1, 2)) for kk in range(spec.n_pops)],
                        dim=1)
    accept = _slog(u_acc) < psum(delta, mesh) + log_hast
    return (torch.where(accept, prop, rates),
            torch.where(accept, prop_states, ais_state))


def update_f_ind(u_prop, u_acc, spec: ModelSpec, data: Dataset, freq, z,
                 rates, prior_mu=None, prior_sigma2=None, mesh=None):
    """Mode 5: per-individual MH random walk on F at the carried z
    (update_F_IND, mcmc.c:888-910); ``rates``, ``u_prop``, ``u_acc``
    f32[C, N]; with the normal prior (``prior_mu``, ``prior_sigma2``
    f32[C]) the ratio carries its N(mu, sigma^2) terms.  The fused sweep
    runs :func:`zq_f_pass` instead, at the fresh z."""
    p0, p1, _, mask = _f_site_terms(data, freq, z)
    prop = propose_back_reflection(u_prop, rates, spec.mh_step_s)
    hom = data.hom[None]

    def lp(f):
        site = _slog(lk.genofreq_inbreeding(p0, p1, hom, f[:, :, None]))
        return torch.where(mask, site, torch.zeros_like(site)).sum(dim=2)

    log_ratio = psum(lp(prop) - lp(rates), mesh)
    if prior_mu is not None:
        log_ratio = log_ratio - (
            0.5 * (prop - prior_mu[:, None]) ** 2
            - 0.5 * (rates - prior_mu[:, None]) ** 2) / prior_sigma2[:, None]
    return torch.where(_slog(u_acc) < log_ratio, prop, rates)


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


def n_hyper_draws() -> int:
    """Uniforms per chain of :func:`update_normal_hyper`: the gamma's
    planes, then two for the Box-Muller normal."""
    return dk.n_test_draws() + 2


def update_normal_hyper(u, rates, priors: Priors):
    """Gibbs update of the normal prior's (mu, sigma^2) given the current
    S/F vector ``rates`` f32[C, N] -- the conjugate draws of sample_mu2
    (mcmc.c:1607-1626): sigma^2 ~ scaled-inv-chi^2(nu_n, sigmasqr_n),
    mu ~ N(mu_n, sigma^2 / kappa_n).  ``u`` f32[C, n_hyper_draws()]: the
    gamma variate comes from the fixed-round sampler of
    ``kernels/dirichlet.py`` and the normal from Box-Muller, so the draw is
    a function of the run's Philox words.  Returns (mu f32[C], sigma2
    f32[C])."""
    n = rates.shape[1]
    ave = rates.mean(dim=1)
    kappa_n = priors.normal_kappa0 + n
    nu_n = priors.normal_nu0 + n
    ss = ((ave[:, None] - rates) ** 2).sum(dim=1)
    sigmasqr_n = (priors.normal_nu0 * priors.normal_sigmasqr0
                  + priors.normal_kappa0 * (ave - priors.normal_mu0) ** 2
                  + ss)
    nd = dk.n_test_draws()
    gam = dk.gamma_cells(torch.full_like(ave, nu_n * 0.5), None,
                         u[:, :nd].transpose(0, 1))
    sigma2 = sigmasqr_n / (2.0 * gam)
    mu_n = (priors.normal_kappa0 * priors.normal_mu0 + n * ave) / kappa_n
    normal = dk.box_muller(u[:, nd], u[:, nd + 1])
    return mu_n + torch.sqrt(sigma2 / kappa_n) * normal, sigma2


def update_gen(ug, u_acc, spec: ModelSpec, data: Dataset, freq, z, q, rates,
               gen, mesh=None):
    """Modes 2/3: MH on the per-individual selfing-generation counts
    (update_G, mcmc.c:1053-1091), ``ug``, ``u_acc`` f32[C, N].

    The proposal g' ~ Geom(1 - sbar_i) equals the conditional prior, so the
    acceptance ratio reduces to the genotype-likelihood ratio
    exp(log_ld_indv(g') - log_ld_indv(g)), mcmc.c:1085.  All individuals
    are independent given (P, Z, Q, S): one parallel sweep."""
    sbar = mix_rates(q, rates) if spec.mode == 2 else rates
    prop = sample_geometric(ug, sbar, spec.gen_cap)
    ll_prop = lk.per_indv_loglik(spec, data, freq, z, q, prop, rates)
    ll_cur = lk.per_indv_loglik(spec, data, freq, z, q, gen, rates)
    return torch.where(_slog(u_acc) < psum(ll_prop - ll_cur, mesh), prop,
                       gen)


def empty_cluster_flag(q, active=None) -> torch.Tensor:
    """bool[C]: any cluster's total occupancy sum_i q_ik < 0.01
    (check_empty_cluster, mcmc.c:1944-1974).  Inactive padded slots (the K
    grid's ``active`` f32[C, K]) always have zero occupancy and are
    exempt."""
    if q.numel() == 0:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    low = q.sum(dim=1) < 0.01
    if active is not None:
        low = low & (active > 0)
    return low.any(dim=-1)
