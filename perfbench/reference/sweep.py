"""A plain reference of one Gibbs/MH sweep of the admixture models with and
without population selfing (InStruct modes 1 and 2, diploid, biallelic),
written from the model and from the draw layout the program documents,
in any floating type (float64 for the reference, bfloat16 for the check's
control).

Each function computes one stage from given inputs:

  P | Z        Dirichlet(counts + 1) per (pop, locus)
  S | G, Q     J sweeps of a reflected random walk per pop, MH on
               sum_i (g_i - 1) log sbar_i + log(1 - sbar_i)
  G proposal   g' = 1 + floor(log u / log sbar), capped, with the
               boundary overrides at sbar ~ 0 and ~ 1
  Z            per copy, inverse CDF of q_ik P[k, l, allele]
  G accept     log u < log-lik(g') - log-lik(g) at the fresh z
  Q | Z        Dirichlet(copies per pop + alpha) per individual
  alpha        MH with a normal proposal on the Dirichlet(alpha) density
  log-liks     the z-conditioned and the Z-marginalized per-individual
               log-likelihood (cal_lkh and the deviance focus)

Gamma variates follow Marsaglia and Tsang (2000) with a fixed number of
rejection rounds and a Wilson-Hilferty fallback, normals Box-Muller, and
shapes below 1 the Gamma(a + 1) U^(1/a) boost: the sampler whose uniform
layout the program documents, so that the same words give the same draw.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import philox as px

EPS = 1e-30
LOG2 = math.log(2.0)
ROUNDS = 3
N_PLANES = 3 * ROUNDS + 3    # uniforms a gamma variate consumes


def unpack(bits2: torch.Tensor):
    """(g0, g1 int64[N, L] allele bits, valid bool[N, L], hom bool[N, L])
    of the packed site plane (bit 0 copy 0's allele, bit 1 copy 1's,
    bit 2 observed and polymorphic)."""
    s = bits2.to(torch.int64)
    g0, g1 = s & 1, (s >> 1) & 1
    return g0, g1, (s & 4) != 0, g0 == g1


def slog(x):
    return torch.log(torch.clamp_min(x, EPS))


def box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def gamma(conc, u, flips: bool = False):
    """Gamma(conc) from ``u`` [N_PLANES, *conc.shape].

    With ``flips`` also (alts, costs), each [ROUNDS + 1, *conc.shape]: the
    variate where round r is the first accepted one (the fallback at r =
    ROUNDS), and how far the accept tests would have to be decided the
    other way for that: the widest ``|rhs - log u|`` among the tests
    flipped, in units of 2^-24 of the magnitude of their terms (0 for the
    reference's own outcome, infinite where a round cannot accept)."""
    small = conc < 1.0
    a = conc + small.to(conc.dtype)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    vals, oks, ulps = [], [], []
    for r in range(ROUNDS):
        z = box_muller(u[3 * r], u[3 * r + 1])
        v = (1.0 + c * z) ** 3
        lu = torch.log(u[3 * r + 2])
        rhs = 0.5 * z * z + d - d * v + d * slog(v)
        vals.append(d * v)
        oks.append((v > 0) & (lu < rhs))
        if flips:
            mag = (0.5 * z * z + d + torch.abs(d * v)
                   + torch.abs(d * slog(v)) + torch.abs(lu))
            ulps.append(torch.where(v > 0, torch.abs(rhs - lu)
                                    / (mag * 2.0 ** -24), math.inf))
    zf = box_muller(u[3 * ROUNDS], u[3 * ROUNDS + 1])
    wh = torch.clamp_min(
        a * (1.0 - 1.0 / (9.0 * a) + zf / torch.sqrt(9.0 * a)) ** 3, EPS)
    # the variate from round r on: round r's value where it accepts, else
    # the next round's, else the fallback
    from_r = [wh]
    for r in reversed(range(ROUNDS)):
        from_r.insert(0, torch.where(oks[r], vals[r], from_r[0]))
    boost = torch.where(small, torch.exp(torch.log(u[3 * ROUNDS + 2])
                                         / torch.clamp_min(conc, 1e-6)),
                        torch.ones_like(a))
    g = from_r[0] * boost
    if not flips:
        return g
    costs, flipped = [], torch.zeros_like(a)   # the accepted rounds before
    for r in range(ROUNDS):
        costs.append(torch.maximum(flipped, torch.where(oks[r], 0.0,
                                                        ulps[r])))
        flipped = torch.maximum(flipped, torch.where(oks[r], ulps[r], 0.0))
    costs.append(flipped)
    return g, torch.stack(vals + [wh]) * boost, torch.stack(costs)


def dirichlet_p(seed, chain_key, step, counts, dtype, flips=False):
    """P f[K, L, A] ~ Dirichlet(counts + 1) over the alleles of each (pop,
    locus); plane d of cell (k, l, a) is word d*K*A*L + (k*A + a)*L + l.
    With ``flips`` the variates and their flips (:func:`gamma`) instead."""
    k, l, a = counts.shape
    w = px.words(seed, chain_key, step, px.STREAM_P, 0, N_PLANES * k * a * l,
                 counts.device)
    u = px.u01_open(w, dtype).reshape(N_PLANES, k, a, l).transpose(2, 3)
    g = gamma((counts + 1.0).to(dtype), u, flips)
    if flips:
        return g
    return g / torch.clamp_min(g.sum(-1, keepdim=True), EPS)


def dirichlet_q(seed, chain_key, step, conc, active, dtype, flips=False):
    """Q f[N, K] ~ Dirichlet(conc) per individual over its active pops;
    plane d of cell (n, k) is word d*K*N + k*N + n.  With ``flips`` the
    variates and their flips (:func:`gamma`) instead."""
    n, k = conc.shape
    w = px.words(seed, chain_key, step, px.STREAM_Q, 0, N_PLANES * k * n,
                 conc.device)
    u = px.u01_open(w, dtype).reshape(N_PLANES, k, n).transpose(1, 2)
    g = gamma(conc.to(dtype), u, flips)
    if flips:
        return g
    return normalize(g, active)


def normalize(g, active=None):
    """Rows of variates to a Dirichlet draw, over the active pops."""
    q = g / torch.clamp_min(g.sum(-1, keepdim=True), EPS)
    if active is not None:
        q = q * active.to(g.dtype)
        q = q / torch.clamp_min(q.sum(-1, keepdim=True), EPS)
    return q


def selfing_target(sbar, gen):
    g1 = (gen - 1).to(sbar.dtype)
    return (torch.where(g1 > 0, g1 * slog(sbar), torch.zeros_like(sbar))
            + slog(1.0 - sbar)).sum(-1)


def s_sweeps(q, gen, rates, u_prop, u_acc, delta0: float):
    """The selfing rates after J sweeps over the pops: ``u_prop``,
    ``u_acc`` [J, K], pop k of sweep j in turn."""
    r = rates.clone()
    sbar = q @ r
    cur = selfing_target(sbar, gen)
    for j in range(u_prop.shape[0]):
        for k in range(q.shape[1]):
            step = torch.abs(r[k] + (2.0 * u_prop[j, k] - 1.0) * delta0)
            new = torch.where(step >= 1.0, 2.0 - step, step)
            sbar_new = sbar + q[:, k] * (new - r[k])
            f_new = selfing_target(sbar_new, gen)
            if torch.log(u_acc[j, k]) < f_new - cur:
                r[k], sbar, cur = new, sbar_new, f_new
    return r


def s_tail_uniforms(seed, chain_key, step, n_sweeps, k, n, fused, dtype,
                    device):
    """(u_prop, u_acc [J, K], ug, ul [N]) of the selfing tail: the fused
    tail's streams (K <= 8) or the plain updates' (word j*K + k)."""
    streams = ((px.STREAM_S_PROP, px.STREAM_S_ACC, px.STREAM_S_GEN,
                px.STREAM_S_LOGU) if fused else
               (px.STREAM_R_PROP, px.STREAM_R_ACC, px.STREAM_G_PROP,
                px.STREAM_G_ACC))
    out = []
    for s, count in zip(streams, (n_sweeps * k, n_sweeps * k, n, n)):
        out.append(px.u01_open(px.words(seed, chain_key, step, s, 0, count,
                                        device), dtype))
    return (out[0].reshape(n_sweeps, k), out[1].reshape(n_sweeps, k),
            out[2], out[3])


def gen_proposal(ug, sbar, cap: int):
    s = torch.clamp(sbar, 1e-6, 1.0 - 1e-6)
    x = torch.floor(torch.log(ug) / torch.log(s))
    g = torch.clamp(1 + torch.clamp(x, 0.0, float(cap)).to(torch.int64),
                    1, cap)
    g = torch.where(sbar <= 1e-3, torch.ones_like(g), g)
    return torch.where(sbar >= 1.0 - 1e-3, torch.full_like(g, cap), g)


def alpha_step(seed, chain_key, step, q, alpha, active, alpha_sd, dtype):
    """alpha after one MH step on prod_i Dirichlet(q_i | alpha) over the
    active pops, from words 0-2 of the alpha stream."""
    u = px.u01_open(px.words(seed, chain_key, step, px.STREAM_ALPHA, 0, 3,
                             q.device), dtype)
    prop = alpha + alpha_sd * box_muller(u[0], u[1])
    n = q.shape[0]
    logq = slog(q)
    if active is None:
        k = float(q.shape[1])
        slq = logq.sum()
    else:
        k = torch.clamp_min(active.sum(), 1.0).to(dtype)
        slq = (logq * active.to(dtype)).sum()

    def norm(a):
        return n * (torch.lgamma(k * a) - k * torch.lgamma(a))

    safe = torch.clamp_min(prop, 1e-6)
    ratio = norm(safe) - norm(alpha) + (safe - alpha) * slq
    if prop > 0 and torch.log(u[2]) < ratio:
        return safe
    return alpha


def copy_probs(freq, g):
    """f[K, B, L]: each pop's frequency of the allele that a copy carries,
    ``freq`` [K, L, 2], ``g`` int64[B, L]."""
    return torch.where(g[None] == 1, freq[:, None, :, 1], freq[:, None, :, 0])


def z_draw(q, w, u, against=None):
    """Ancestry of each copy by inverse CDF: ``q`` [B, K], ``w`` [K, B, L]
    its pops' probabilities of the copy's allele, ``u`` [B, L] in [0, 1).

    With ``against`` (int64[B, L], another draw of the same copies) also
    how close to the CDF's boundaries that draw's departures lie: over the
    copies where it differs, the widest ``|u total - cum_m|`` of the
    boundaries m between the two ancestries, in units of 2^-24 of the
    total (0 where none differs, infinite where an ancestry is out of
    range)."""
    cum = torch.cumsum(q.t()[:, :, None] * w, dim=0)
    ut = u * cum[-1]
    z = (ut[None] > cum[:-1]).sum(0)
    if against is None:
        return z
    off = against != z
    if not bool(off.any()):
        return z, 0.0
    k = cum.shape[0]
    za, zr = against[off], z[off]
    if bool(((za < 0) | (za >= k)).any()):
        return z, math.inf
    ks = torch.arange(k - 1, device=z.device)[:, None]
    between = (ks >= torch.minimum(za, zr)) & (ks < torch.maximum(za, zr))
    gap = torch.where(between, torch.abs(ut[off][None] - cum[:-1][:, off]),
                      0.0).amax(0)
    return z, float((gap / (cum[-1][off] * 2.0 ** -24)).max())


def at_z(w, z):
    """w[z[b, l], b, l]."""
    return torch.gather(w, 0, z[None]).squeeze(0)


def gen_loglik_ratio(w0, w1, z0, z1, valid, hom, wc, wp):
    """log-lik(g') - log-lik(g) per individual at z (structure way):
    same-pop homozygous sites log((1 - (1 - p) w')/(1 - (1 - p) w)),
    same-pop heterozygous ones log(w'/w)."""
    p0 = at_z(w0, z0)
    same = (z0 == z1) & valid
    q1 = 1.0 - p0
    hs = (same & hom).to(p0.dtype)
    ratio = (torch.clamp_min(1.0 - q1 * wp[:, None], EPS)
             / torch.clamp_min(1.0 - q1 * wc[:, None], EPS))
    n_het = (same & ~hom).to(p0.dtype).sum(-1)
    return (torch.log(ratio) * hs).sum(-1) + (slog(wp) - slog(wc)) * n_het


def zcond_loglik(mode, w0, w1, z0, z1, valid, hom, wg):
    """The z-conditioned per-individual log-lik (cal_lkh): mode 1 the
    product of the copies' probabilities; mode 2 the selfing genotype
    frequency where both copies share a pop, with ``wg`` = 2^(1 - g)."""
    p0, p1 = at_z(w0, z0), at_z(w1, z1)
    het = (~hom).to(p0.dtype)
    indep = slog(p0) + slog(p1) + het * LOG2
    if mode == 1:
        site = indep
    else:
        w = wg[:, None]
        joint = slog(torch.where(hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - w),
                                 2.0 * p0 * p1 * w))
        site = torch.where(z0 == z1, joint, indep)
    return (site * valid.to(p0.dtype)).sum(-1)


def marginal_loglik(mode, q, w0, w1, valid, hom, wg):
    """The per-individual log-lik with both copies' ancestries summed out:
    sum_k q_k^2 joint_k + (m0 m1 - sum_k q_k^2 p_k0 p_k1) mult, m_c the
    Q-mixture probability of copy c's allele, mult 2 at heterozygous
    sites."""
    qk = q.t()[:, :, None]
    m0, m1 = (qk * w0).sum(0), (qk * w1).sum(0)
    mult = 1.0 + (~hom).to(q.dtype)
    if mode == 1:
        prob = mult * m0 * m1
    else:
        same = (qk * qk * w0 * w1).sum(0)
        w = wg[None, :, None]
        joint = (qk * qk * torch.where(
            hom[None], w0 * w0 + w0 * (1.0 - w0) * (1.0 - w),
            2.0 * w0 * w1 * w)).sum(0)
        prob = joint + (m0 * m1 - same) * mult
    return (slog(prob) * valid.to(q.dtype)).sum(-1)


def moments_update(acc: dict, stats: dict, check_at: int, ckrep: int,
                   empty_flag: bool) -> dict:
    """One stored draw folded into one chain's running moments: Welford
    means of x and x^2, the convergence trace, the empty-cluster latch at
    the ``check_at``-th draw, the running log-mean-exp and the centred sum
    of squares of the marginal log-lik."""
    n_old = int(acc["count"])
    n = n_old + 1
    out = {"count": n}
    for name, x in stats.items():
        m = acc["mean." + name]
        out["mean." + name] = m + (x - m) / n
        ms = acc["mean_sq." + name]
        out["mean_sq." + name] = ms + (x * x - ms) / n
    conv = acc["convg_ld"].clone()
    if n_old < ckrep:
        conv[n_old] = stats["total_ll"]
    out["convg_ld"] = conv
    out["empty_cluster"] = bool(acc["empty_cluster"]) or (
        n == check_at and empty_flag)
    x = stats["ll_marg"]
    if n_old > 0:
        prev = acc["lme_indv"] + math.log(n_old)
        out["lme_indv"] = torch.logaddexp(prev, x) - math.log(n)
    else:
        out["lme_indv"] = x - math.log(n)
    out["m2_ll_marg"] = acc["m2_ll_marg"] + (
        (x - acc["mean.ll_marg"]) * (x - out["mean.ll_marg"]))
    return out
