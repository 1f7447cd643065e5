"""Genotype-likelihood math for the mode-2 slice, in plain PyTorch.

Counterpart of ``instruct_tpu/model/likelihood.py`` (the JAX package
computes these outside any Pallas kernel, so they stay plain tensor code
here).  Chains are a written-out leading axis: ``freq`` f32[C, K, L, A],
``z`` int8[C, N, S], ``q`` f32[C, N, K], ``gen`` [C, N]; the panel tensors
carry no chain axis.  The per-copy site axis is flat, S = L * ploid, copy
major (``s = copy * L + l``).

Ported: :func:`genofreq_selfing`, :func:`per_pop_copy_probs`,
:func:`split_copies`, :func:`site_loglik` / :func:`per_indv_loglik` and
:func:`marginal_site_loglik` / :func:`marginal_indv_loglik` for the
selfing mode 2.  The inbreeding forms (modes 4/5), mode 1 and the mode-0
matrix wait for their modes.
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset

_LOG2 = 0.6931471805599453
_EPS = 1e-30  # guards log(0) for Dirichlet draws that underflow


def _need_mode2(spec: ModelSpec, what: str) -> None:
    if spec.ploid != 2 or spec.mode != 2:
        raise NotImplementedError(
            f"{what} is ported for diploid mode 2 only (got mode "
            f"{spec.mode}, ploid {spec.ploid}); see ROADMAP: modes "
            "1/3/4/5/0 and the tetraploid engine are still to be ported")


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


def _freq_at_z(freq, data: Dataset, z):
    """p f32[C, N, S]: freq[c, z, l, geno] in flat layout."""
    out = None
    for kk, pk in enumerate(per_pop_copy_probs(freq, data)):
        out = pk if out is None else torch.where(z == kk, pk, out)
    return out


def site_loglik(spec: ModelSpec, data: Dataset, freq, z, q, gen,
                rates=None):
    """Per-site log-likelihood f32[C, N, L] of the selfing mode 2
    (log_ld_indv body, mcmc.c:1726-1773), honouring ``spec.type_freq``
    (expectation vs structure way).  Invalid sites are 0."""
    _need_mode2(spec, "site_loglik")
    p = data.ploid
    hom = data.hom[None]
    g = gen[:, :, None].to(torch.float32)
    if spec.type_freq == 0:
        pm = None
        for k, pk in enumerate(per_pop_copy_probs(freq, data)):
            term = q[:, :, k][:, :, None] * pk
            pm = term if pm is None else pm + term
        p0, p1 = split_copies(pm, p)
        site = _safe_log(genofreq_selfing(p0, p1, hom, g))
        return torch.where(data.site_valid[None], site,
                           torch.zeros_like(site))
    pz = _freq_at_z(freq, data, z)
    p0, p1 = split_copies(pz, p)
    indep = (_safe_log(p0) + _safe_log(p1)
             + (~hom).to(torch.float32) * _LOG2)
    z0, z1 = split_copies(z, p)
    joint = _safe_log(genofreq_selfing(p0, p1, hom, g))
    site = torch.where(z0 == z1, joint, indep)
    return torch.where(data.site_valid[None], site, torch.zeros_like(site))


def per_indv_loglik(spec, data, freq, z, q, gen, rates=None):
    """f32[C, N] per-individual log-lik (the ``indvlkh`` of cal_lkh,
    mcmc.c:1916-1942)."""
    return site_loglik(spec, data, freq, z, q, gen, rates).sum(dim=-1)


def marginal_site_loglik(spec: ModelSpec, data: Dataset, freq, q, gen,
                         rates=None):
    """Per-site log-likelihood f32[C, N, L] with the per-copy ancestries Z
    summed out exactly (mode 2, diploid).

    Given (P, Q, G) the two copies' assignments are iid Cat(q_i), so the
    per-locus marginal is the 2-copy mixture

        sum_k q_ik^2 * joint_k  +  (m0 m1 - sum_k q_ik^2 p_k0 p_k1) * mult

    with joint_k the same-pop genotype probability (genofreq under
    selfing), m_c = sum_k q_ik p_kc the mixture per-copy probability and
    mult = 2 for heterozygotes, 1 for homozygotes.  This is the deviance
    focus of the corrected DIC and of WAIC."""
    _need_mode2(spec, "marginal_site_loglik")
    p = data.ploid
    hom = data.hom[None]
    mult = torch.where(hom, 1.0, 2.0)
    g = gen[:, :, None].to(torch.float32)
    m0 = m1 = same = joint = 0.0
    for k, pk in enumerate(per_pop_copy_probs(freq, data)):
        pk0, pk1 = split_copies(pk, p)
        qk = q[:, :, k][:, :, None]
        m0 = m0 + qk * pk0
        m1 = m1 + qk * pk1
        same = same + (qk * qk) * (pk0 * pk1)
        joint = joint + (qk * qk) * genofreq_selfing(pk0, pk1, hom, g)
    cross = m0 * m1 - same
    # genofreq_selfing already carries the het factor 2 in joint_k
    site = _safe_log(joint + cross * mult)
    return torch.where(data.site_valid[None], site, torch.zeros_like(site))


def marginal_indv_loglik(spec, data, freq, q, gen, rates=None):
    """f32[C, N] Z-marginalized per-individual log-lik."""
    return marginal_site_loglik(spec, data, freq, q, gen, rates).sum(dim=-1)
