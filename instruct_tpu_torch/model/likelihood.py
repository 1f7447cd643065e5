"""Genotype-likelihood math of the diploid modes (0-5), in plain PyTorch.

Counterpart of ``instruct_tpu/model/likelihood.py`` (the JAX package
computes these outside any Pallas kernel, so they stay plain tensor code
here).  Chains are a written-out leading axis: ``freq`` f32[C, K, L, A],
``z`` int8[C, N, S], ``q`` f32[C, N, K], ``gen`` [C, N], ``rates`` f32[C, R];
the panel tensors carry no chain axis.  The per-copy site axis is flat,
S = L * ploid, copy major (``s = copy * L + l``).

Ported: :func:`genofreq_selfing`, :func:`genofreq_inbreeding`,
:func:`per_pop_copy_probs`, :func:`gather_freq_at_z`,
:func:`mixture_copy_probs`, :func:`split_copies`, :func:`site_loglik` /
:func:`per_indv_loglik` and :func:`marginal_site_loglik` /
:func:`marginal_indv_loglik`, and mode 0's :func:`allele_count_matrix` /
:func:`loglik_matrix_nopop_admix`.
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset

_LOG2 = 0.6931471805599453
_EPS = 1e-30  # guards log(0) for Dirichlet draws that underflow
# The Z-marginalized log-lik runs a chunk of chains at a time, so that each
# of its [chains, N, L] float temporaries holds at most this many bytes
# (at 40 chains of the 1000 x 10 000 headline panel, one-shot, they are
# 1.6 GB each).
MARG_CHUNK_BYTES = 1 << 28


def _need_admixture(spec: ModelSpec, what: str) -> None:
    if spec.ploid != 2 or spec.mode not in (1, 2, 3, 4, 5):
        raise ValueError(
            f"{what} is the log-lik of the diploid modes 1-5 (got mode "
            f"{spec.mode}, ploid {spec.ploid}); mode 0 has its own matrix, "
            "loglik_matrix_nopop_admix, and the tetraploid engine its own "
            "site log-lik, tetra/engine.py:site_indv_loglik")


def genofreq_selfing(p0, p1, hom, gen):
    """Genotype frequency after ``gen`` generations of selfing
    (genofreq(), mcmc.c:1683-1703):

    Homozygote:   p0^2 + p0 (1 - p0) (1 - 2^{1-gen})
    Heterozygote: 2 p0 p1 2^{1-gen}

    ``gen`` may be real-valued (posterior means)."""
    w = torch.exp2(1.0 - torch.as_tensor(gen, dtype=p0.dtype,
                                         device=p0.device))
    hom_freq = p0 * p0 + p0 * (1.0 - p0) * (1.0 - w)
    het_freq = 2.0 * p0 * p1 * w
    return torch.where(hom, hom_freq, het_freq)


def genofreq_inbreeding(p0, p1, hom, f):
    """Genotype frequency under inbreeding coefficient F
    (genofreq_inbreedcoff, mcmc.c:1707-1723):
    hom p^2 (1 - F) + p F ; het 2 p0 p1 (1 - F)."""
    hom_freq = p0 * p0 * (1.0 - f) + p0 * f
    het_freq = 2.0 * p0 * p1 * (1.0 - f)
    return torch.where(hom, hom_freq, het_freq)


def _safe_log(x):
    return torch.log(torch.clamp_min(x, _EPS))


def per_pop_copy_probs(freq, data: Dataset):
    """Generator over k of p_k f32[C, N, S] = freq[c, k, l, a_{nlc}]: the
    per-copy allele probability under pop k (the inner quantity of the
    Z-Gibbs update, mcmc.c:1146), as a select over the allele axis."""
    p = data.ploid
    a = data.allele_valid.shape[1]
    geno = data.geno[None]                                   # [1, N, S]
    for kk in range(freq.shape[1]):
        out = freq[:, kk, :, 0].repeat(1, p)[:, None, :] * (geno == 0)
        for ai in range(1, a):
            vals = freq[:, kk, :, ai].repeat(1, p)[:, None, :]
            out = torch.where(geno == ai, vals, out)
        yield out


def split_copies(flat, p):
    """[..., S] -> tuple of per-copy [..., L] planes (contiguous slices in
    the copy-major layout s = c * L + l)."""
    l = flat.shape[-1] // p
    return tuple(flat[..., c * l:(c + 1) * l] for c in range(p))


def gather_freq_at_z(freq, data: Dataset, z):
    """p f32[C, N, S]: freq[c, z, l, geno] in flat layout, for any A -- the
    ubiquitous ``ptr->freq[z...][j][seqdata...]`` gather (mcmc.c:1756), as
    a select over the (pop, allele) grid."""
    out = None
    for kk, pk in enumerate(per_pop_copy_probs(freq, data)):
        out = pk if out is None else torch.where(z == kk, pk, out)
    return out


def mixture_copy_probs(freq, data: Dataset, q):
    """Expectation-way per-copy probability f32[C, N, S]:
    p = sum_m q[n, m] freq[m, l, a] (mcmc.c:1741-1745)."""
    out = None
    for k, pk in enumerate(per_pop_copy_probs(freq, data)):
        term = q[:, :, k][:, :, None] * pk
        out = term if out is None else out + term
    return out


def _joint_freq(spec: ModelSpec, p0, p1, hom, gen, f):
    """Same-pop genotype probability of the spec's model: genofreq under
    selfing (modes 2/3) or the inbreeding form (modes 4/5)."""
    if spec.mode in (2, 3):
        return genofreq_selfing(p0, p1, hom,
                                gen[:, :, None].to(torch.float32))
    return genofreq_inbreeding(p0, p1, hom, f)


def site_loglik(spec: ModelSpec, data: Dataset, freq, z, q, gen,
                rates=None):
    """Per-site log-likelihood f32[C, N, L] of the admixture modes (1-5).

    Dispatches like cal_lkh (mcmc.c:1916-1942):
      mode 1     log_ld_noselfing_indv body (mcmc.c:1869-1890)
      modes 2/3  log_ld_indv body (mcmc.c:1726-1773), honouring
                 ``spec.type_freq`` (expectation vs structure way)
      modes 4/5  log_ld_F_pop / log_ld_F_indv bodies (mcmc.c:1776-1847)
    Invalid sites are 0; callers sum over L."""
    _need_admixture(spec, "site_loglik")
    p = data.ploid
    hom = data.hom[None]
    valid = data.site_valid[None]
    if spec.mode in (2, 3) and spec.type_freq == 0:
        # expectation way: mixture per-copy probs, no dependence on z
        p0, p1 = split_copies(mixture_copy_probs(freq, data, q), p)
        site = _safe_log(_joint_freq(spec, p0, p1, hom, gen, None))
        return torch.where(valid, site, torch.zeros_like(site))
    p0, p1 = split_copies(gather_freq_at_z(freq, data, z), p)
    site = (_safe_log(p0) + _safe_log(p1)
            + (~hom).to(torch.float32) * _LOG2)
    if spec.mode != 1:
        z0, z1 = split_copies(z, p)
        f = None
        if spec.mode == 4:
            # F of pop z[..., 0] (log_ld_F_pop, mcmc.c:1795)
            f = torch.gather(rates, 1, z0.to(torch.int64).flatten(1)
                             ).reshape(z0.shape)
        elif spec.mode == 5:
            f = rates[:, :, None]
        joint = _safe_log(_joint_freq(spec, p0, p1, hom, gen, f))
        site = torch.where(z0 == z1, joint, site)
    return torch.where(valid, site, torch.zeros_like(site))


def per_indv_loglik(spec, data, freq, z, q, gen, rates=None):
    """f32[C, N] per-individual log-lik (the ``indvlkh`` of cal_lkh,
    mcmc.c:1916-1942)."""
    return site_loglik(spec, data, freq, z, q, gen, rates).sum(dim=-1)


def marginal_site_loglik(spec: ModelSpec, data: Dataset, freq, q, gen,
                         rates=None):
    """Per-site log-likelihood f32[C, N, L] with the per-copy ancestries Z
    summed out exactly (modes 1-5, diploid).

    Given (P, Q, G/F) the two copies' assignments are iid Cat(q_i), so the
    per-locus marginal is the 2-copy mixture

        sum_k q_ik^2 * joint_k  +  (m0 m1 - sum_k q_ik^2 p_k0 p_k1) * mult

    with joint_k the same-pop genotype probability (genofreq under selfing
    for modes 2/3, the inbreeding form for modes 4/5, the plain product for
    mode 1), m_c = sum_k q_ik p_kc the mixture per-copy probability and
    mult = 2 for heterozygotes, 1 for homozygotes.  This is the deviance
    focus of the corrected DIC and of WAIC.  ``gen`` may be real-valued
    (posterior means)."""
    _need_admixture(spec, "marginal_site_loglik")
    p = data.ploid
    hom = data.hom[None]
    mult = torch.where(hom, 1.0, 2.0)
    m0 = m1 = same = joint = 0.0
    for k, pk in enumerate(per_pop_copy_probs(freq, data)):
        pk0, pk1 = split_copies(pk, p)
        qk = q[:, :, k][:, :, None]
        m0 = m0 + qk * pk0
        m1 = m1 + qk * pk1
        same = same + (qk * qk) * (pk0 * pk1)
        if spec.mode == 1:
            jk = pk0 * pk1          # mult applied uniformly below
        else:
            f = None
            if spec.mode == 4:
                f = rates[:, k][:, None, None]
            elif spec.mode == 5:
                f = rates[:, :, None]
            jk = _joint_freq(spec, pk0, pk1, hom, gen, f)
        joint = joint + (qk * qk) * jk
    cross = m0 * m1 - same
    if spec.mode == 1:
        prob = (joint + cross) * mult          # = mult * m0 * m1
    else:
        # genofreq_* already carries the het factor 2 in joint_k
        prob = joint + cross * mult
    site = _safe_log(prob)
    return torch.where(data.site_valid[None], site, torch.zeros_like(site))


def marginal_indv_loglik(spec, data, freq, q, gen, rates=None):
    """f32[C, N] Z-marginalized per-individual log-lik, evaluated a chunk
    of chains at a time (:data:`MARG_CHUNK_BYTES`).  The chains are
    independent and each one's sums run over its own rows, so the chunks
    joined are the one-shot evaluation."""
    c = freq.shape[0]
    step = max(1, MARG_CHUNK_BYTES // (4 * data.n_indv * data.n_loci))

    def rows(t, lo):
        return None if t is None else t[lo:lo + step]

    return torch.cat([
        marginal_site_loglik(spec, data, rows(freq, lo), rows(q, lo),
                             rows(gen, lo), rows(rates, lo)).sum(dim=-1)
        for lo in range(0, c, step)])


def allele_count_matrix(data: Dataset):
    """cnt f32[N, A, L]: per individual and (allele, locus), the number of
    valid copies carrying that allele.  Shared by the mode-0 likelihood and
    the no-admixture P counts (update_P's mode == 0 branch,
    mcmc.c:825-831)."""
    valid = data.site_valid
    cols = []
    for ai in range(data.max_alleles):
        cnt = torch.zeros(valid.shape, dtype=torch.float32,
                          device=valid.device)
        for gc in split_copies(data.geno, data.ploid):
            cnt = cnt + (valid & (gc == ai)).to(torch.float32)
        cols.append(cnt)
    return torch.stack(cols, dim=1)


def loglik_matrix_nopop_admix(data: Dataset, freq):
    """ll f32[C, N, K]: log-lik of each individual under a single-pop
    assignment to every k -- log_ld_indv_K (mcmc.c:1893-1914) for all (i, k)
    as one matrix product: ll = cnt @ log(freq)^T + het bonus."""
    c, k, l, a = freq.shape
    cnt = allele_count_matrix(data).reshape(-1, a * l)       # [N, A*L]
    logf = _safe_log(torch.clamp_min(freq, 0.0))
    logf = torch.where(data.allele_valid[None, None], logf,
                       torch.zeros_like(logf))
    logf = logf.transpose(2, 3).reshape(c, k, a * l)         # [C, K, A*L]
    ll = torch.matmul(cnt[None], logf.transpose(1, 2))       # [C, N, K]
    het_bonus = ((~data.hom).to(torch.float32) * _LOG2
                 * data.site_valid).sum(dim=1)
    return ll + het_bonus[None, :, None]
