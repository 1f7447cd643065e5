"""The per-site passes of the diploid mode-2 sweep.

Counterpart of ``instruct_tpu/kernels/fused_step.py`` for the entry points
the mode-2 fused step runs:

  * :func:`allele_counts` (:87 there) — counts [K, L, A] of valid allele
    copies from (z, panel);
  * :func:`zq_gendiff_pass` (:748) — one read of the site plane: per-copy
    ``z ~ Cat(q_k * P[k, l, a])`` by inverse CDF, per-individual pop counts,
    the allele-pop counts of the fresh z, and the G-update MH log-ratio
    evaluated at that fresh z (the sweep order is "Z, then G | z", so the
    sampling pass never reads the old z);
  * :func:`panel_loglik_pass` (:803) — cal_lkh per individual at the
    carried z.

Chains are a written-out leading axis ``C`` on every state tensor; the panel
tensors carry none.  On CUDA tensors the wrappers launch
``csrc/site_pass.cu`` / ``csrc/allele_counts.cu``; on CPU tensors they run
the plain versions below.  Only the packed diploid-biallelic panel
(``Dataset.bits2``) is ported for the site pass; the generic A > 2 path and
the other wrappers of the JAX module (``zq_gen_pass``, ``zq_sample_pass``,
``zq_mode1_pass``, ``panel_loglik_mode1_pass``, ``zq_f_pass``,
``panel_loglik_f_pass``) are still to be ported.

z-draw uniforms: site ``(n, s)``, ``s = copy * L + l``, takes Philox word
``n * 2L + s`` of the (chain, step, ``STREAM_Z``) counter space through the
``[0, 1)`` conversion, or ``u[c, n, s]`` when uniforms are injected.
"""

from __future__ import annotations

from typing import Optional

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

_LOG2 = 0.6931471805599453
_EPS = 1e-30
MAX_POPS = 8       # the site kernels are instantiated for K = 1..8


def _log(x):
    return torch.log(torch.clamp_min(x, _EPS))


def unpack_bits2(bits2: torch.Tensor):
    """(g0, g1 int64[N, L] allele bits, valid bool[N, L], hom bool[N, L])
    from the packed site plane (bit0 copy-0 allele, bit1 copy-1 allele,
    bit2 valid; hom is bit0 == bit1)."""
    si = bits2.to(torch.int64)
    g0 = si & 1
    g1 = (si >> 1) & 1
    return g0, g1, (si & 4) != 0, g0 == g1


def _need_bits2(bits2):
    if bits2 is None:
        raise NotImplementedError(
            "the site pass is ported for the packed diploid-biallelic panel "
            "(Dataset.bits2) only; the generic A > 2 path is still to be "
            "ported (ROADMAP: remaining K1 variants)")


# ---------------------------------------------------------------------------
# allele counts
# ---------------------------------------------------------------------------

def allele_counts_reference(z, geno, site_valid, *, n_pops: int,
                            max_alleles: int, bits2=None):
    """Plain PyTorch version of :func:`allele_counts` (same signature)."""
    c, n, s = z.shape
    l = s // 2
    valid = site_valid[None]
    out = z.new_zeros((c, n_pops, l, max_alleles), dtype=torch.float32)
    for copy in range(2):
        zc = z[:, :, copy * l:(copy + 1) * l]
        gc = geno[None, :, copy * l:(copy + 1) * l]
        for k in range(n_pops):
            zm = valid & (zc == k)
            for a in range(max_alleles):
                out[:, k, :, a] += (zm & (gc == a)).sum(dim=1).to(
                    torch.float32)
    return out


def allele_counts(z: torch.Tensor, geno: torch.Tensor,
                  site_valid: torch.Tensor, *, n_pops: int, max_alleles: int,
                  bits2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """counts f32[C, K, L, A] of valid allele copies per (chain, pop, locus,
    allele).

    z int8[C, N, 2L] copy-major; geno int8[N, 2L]; site_valid bool[N, L];
    ``bits2`` int8[N, L], when given (packed biallelic panel), is read in
    place of geno and site_valid by the kernel.
    """
    if z.dim() != 3:
        raise ValueError("z must be [C, N, 2L]")
    if not z.is_cuda:
        return allele_counts_reference(z, geno, site_valid, n_pops=n_pops,
                                       max_alleles=max_alleles, bits2=bits2)
    c, n, s = z.shape
    l = s // 2
    if n_pops * max_alleles > 64:
        raise ValueError("allele_counts supports n_pops * max_alleles <= 64")
    _build.check(z, "z", torch.int8, (c, n, 2 * l))
    if bits2 is not None and max_alleles == 2:
        _build.check(bits2, "bits2", torch.int8, (n, l))
        geno = site_valid = None
    else:
        bits2 = None
        _build.check(geno, "geno", torch.int8, (n, 2 * l))
        _build.check(site_valid, "site_valid", torch.bool, (n, l))
    counts = torch.empty((c, n_pops, l, max_alleles), dtype=torch.float32,
                         device=z.device)
    p = _build.ptr
    _build.launch("allele_counts", "allele_counts_launch", p(z), p(bits2),
                  p(geno), p(site_valid), p(counts), c, n, l, n_pops,
                  max_alleles)
    return counts


# ---------------------------------------------------------------------------
# the site pass
# ---------------------------------------------------------------------------

def _site_uniforms(keys, step, c, n, l, u, device):
    """f32[C, N, 2L] z-draw uniforms, injected or from Philox."""
    if u is not None:
        if tuple(u.shape) != (c, n, 2 * l):
            raise ValueError(f"u: expected {(c, n, 2 * l)}, got "
                             f"{tuple(u.shape)}")
        return u.to(torch.float32)
    words = px.random_words(keys, step, px.STREAM_Z, n * 2 * l)
    return px.u01_closed(words).reshape(c, n, 2 * l)


def _prefix_planes(q, freq):
    """CDF prefixes of the z draw, affine in the allele indicator g:
    ``cum_j(g) = A[j] + B[j] * g`` with f32[C, N, L] planes (the biallelic
    fast path of the JAX kernel, ``fused_step.py:258-286``)."""
    k = q.shape[-1]
    f0 = [freq[:, kk, :, 0][:, None, :] for kk in range(k)]
    d = [freq[:, kk, :, 1][:, None, :] - f0[kk] for kk in range(k)]
    qc = [q[:, :, kk][:, :, None] for kk in range(k)]
    cum_a, cum_b = qc[0] * f0[0], qc[0] * d[0]
    a, b = [cum_a], [cum_b]
    for kk in range(1, k):
        cum_a = cum_a + qc[kk] * f0[kk]
        cum_b = cum_b + qc[kk] * d[kk]
        a.append(cum_a)
        b.append(cum_b)
    return f0, d, a, b


def _at_z(rows, zc):
    out = rows[0].expand_as(zc)
    for kk in range(1, len(rows)):
        out = torch.where(zc == kk, rows[kk], out)
    return out


def zq_gendiff_pass_reference(keys, step: int, q, freq, bits2, wg_pair, *,
                              structure: bool, u=None):
    """Plain PyTorch version of :func:`zq_gendiff_pass` (same signature)."""
    _need_bits2(bits2)
    c, n, k = q.shape
    l = bits2.shape[1]
    g0, g1, valid, hom = unpack_bits2(bits2)
    g0f = g0.to(torch.float32)[None]
    g1f = g1.to(torch.float32)[None]
    valid, hom = valid[None], hom[None]
    uu = _site_uniforms(keys, step, c, n, l, u, q.device)
    f0, d, a, b = _prefix_planes(q, freq)

    def draw(gf, u01):
        tot = a[-1] + b[-1] * gf
        ut = u01 * tot
        zc = torch.zeros(tot.shape, dtype=torch.int64, device=q.device)
        for jj in range(k - 1):
            zc = zc + (ut > a[jj] + b[jj] * gf)
        return zc, tot

    z0, tot0 = draw(g0f, uu[:, :, :l])
    z1, _ = draw(g1f, uu[:, :, l:])
    z = torch.cat([z0, z1], dim=2).to(torch.int8)

    vf = valid.to(torch.float32)
    qqnum = torch.stack(
        [(((z0 == kk).to(torch.float32) + (z1 == kk).to(torch.float32))
          * vf).sum(dim=2) for kk in range(k)], dim=2)
    zcounts = torch.stack([torch.stack(
        [(((z0 == kk) & (g0[None] == ai)).to(torch.float32)
          + ((z1 == kk) & (g1[None] == ai)).to(torch.float32))
         .mul(vf).sum(dim=1) for ai in range(2)], dim=2)
        for kk in range(k)], dim=1)

    # G-update MH log-ratio at the fresh z (update_G): only hom sites take
    # a log; het sites add the row constant log(w_p / w_c)
    if structure:
        p0 = _at_z(f0, z0) + _at_z(d, z0) * g0f
        m = (z0 == z1) & valid
    else:
        p0 = tot0
        m = valid.expand_as(z0)
    wc = wg_pair[:, :, 0][:, :, None]
    wp = wg_pair[:, :, 1][:, :, None]
    q1 = 1.0 - p0
    ratio = (torch.clamp_min(1.0 - q1 * wp, _EPS)
             / torch.clamp_min(1.0 - q1 * wc, _EPS))
    mh = (m & hom).to(torch.float32)
    mt = (m & ~hom).to(torch.float32)
    dh = _log(wg_pair[:, :, 1]) - _log(wg_pair[:, :, 0])
    ll_diff = (torch.log(ratio) * mh).sum(dim=2) + dh * mt.sum(dim=2)
    return z, qqnum, ll_diff, zcounts


def _check_site_inputs(q, freq, bits2):
    c, n, k = q.shape
    if k > MAX_POPS:
        raise ValueError(f"the site pass supports n_pops <= {MAX_POPS}, "
                         f"got {k}")
    l = bits2.shape[1]
    if n * 2 * l >= 1 << 34:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    _build.check(q, "q", torch.float32, (c, n, k))
    _build.check(freq, "freq", torch.float32, (c, k, l, 2))
    _build.check(bits2, "bits2", torch.int8, (n, l))
    return c, n, l, k


def zq_gendiff_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                    bits2: torch.Tensor, wg_pair: torch.Tensor, *,
                    structure: bool, u: Optional[torch.Tensor] = None):
    """Sample z, count per-individual pops and the allele-pop counts of the
    fresh z, and emit the G-update MH log-ratio.

    keys     RngKeys (seed + per-chain keys); step  the step index
    q        f32[C, N, K]      admixture proportions
    freq     f32[C, K, L, 2]   allele frequencies
    bits2    int8[N, L]        packed site plane (Dataset.bits2)
    wg_pair  f32[C, N, 2]      2^(1-g) at (current, proposed) g
    u        f32[C, N, 2L]     optional injected z-draw uniforms

    Returns (z int8[C, N, 2L], qqnum f32[C, N, K], ll_diff f32[C, N],
    zcounts f32[C, K, L, 2]).  ``structure`` picks the structure way
    (z-conditioned copy probabilities) over the expectation way.
    """
    _need_bits2(bits2)
    if q.dim() != 3:
        raise ValueError("q must be [C, N, K]")
    if not q.is_cuda:
        return zq_gendiff_pass_reference(keys, step, q, freq, bits2, wg_pair,
                                         structure=structure, u=u)
    c, n, l, k = _check_site_inputs(q, freq, bits2)
    _build.check(wg_pair, "wg_pair", torch.float32, (c, n, 2))
    _build.check(keys.chain_key, "chain_key", torch.int32, (c,))
    if u is not None:
        _build.check(u, "u", torch.float32, (c, n, 2 * l))
    dev = q.device
    t = _build.library().site_pass_tiles(l)
    z = torch.empty((c, n, 2 * l), dtype=torch.int8, device=dev)
    qqnum = torch.empty((c, n, k), dtype=torch.float32, device=dev)
    zcounts = torch.empty((c, k, l, 2), dtype=torch.float32, device=dev)
    ll = torch.empty((c, n), dtype=torch.float32, device=dev)
    ll_part = torch.empty((c, n, t), dtype=torch.float32, device=dev)
    qq_part = torch.empty((c, n, t, k), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch("site_pass_gendiff", "site_gendiff_launch", p(q), p(freq),
                  p(bits2), p(wg_pair), p(u), p(z), p(qqnum), p(zcounts),
                  p(ll), p(ll_part), p(qq_part), c, n, l, k, int(structure),
                  keys.k0, keys.k1, p(keys.chain_key), step)
    return z, qqnum, ll, zcounts


def panel_loglik_pass_reference(freq, q, bits2, z, wg, *, structure: bool):
    """Plain PyTorch version of :func:`panel_loglik_pass` (same
    signature)."""
    _need_bits2(bits2)
    l = bits2.shape[1]
    g0, g1, valid, hom = unpack_bits2(bits2)
    g0f = g0.to(torch.float32)[None]
    g1f = g1.to(torch.float32)[None]
    valid, hom = valid[None], hom[None]
    f0, d, a, b = _prefix_planes(q, freq)
    z0 = z[:, :, :l].to(torch.int64)
    z1 = z[:, :, l:].to(torch.int64)
    if structure:
        p0 = _at_z(f0, z0) + _at_z(d, z0) * g0f
        p1 = _at_z(f0, z1) + _at_z(d, z1) * g1f
    else:
        p0 = a[-1] + b[-1] * g0f
        p1 = a[-1] + b[-1] * g1f
    w = wg[:, :, None]
    gf = torch.where(hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - w),
                     2.0 * p0 * p1 * w)
    site = _log(gf)
    if structure:
        indep = _log(p0) + _log(p1) + (~hom).to(torch.float32) * _LOG2
        site = torch.where(z0 == z1, site, indep)
    return (site * valid.to(torch.float32)).sum(dim=2)


def panel_loglik_pass(freq: torch.Tensor, q: torch.Tensor,
                      bits2: torch.Tensor, z: torch.Tensor,
                      wg: torch.Tensor, *, structure: bool) -> torch.Tensor:
    """cal_lkh for mode 2: per-individual log-lik f32[C, N] at the carried
    (q, gen, z).  freq f32[C, K, L, 2]; q f32[C, N, K]; bits2 int8[N, L];
    z int8[C, N, 2L]; wg f32[C, N] = 2^(1-g)."""
    _need_bits2(bits2)
    if q.dim() != 3:
        raise ValueError("q must be [C, N, K]")
    if not q.is_cuda:
        return panel_loglik_pass_reference(freq, q, bits2, z, wg,
                                           structure=structure)
    c, n, l, k = _check_site_inputs(q, freq, bits2)
    _build.check(z, "z", torch.int8, (c, n, 2 * l))
    _build.check(wg, "wg", torch.float32, (c, n))
    dev = q.device
    t = _build.library().site_pass_tiles(l)
    ll = torch.empty((c, n), dtype=torch.float32, device=dev)
    ll_part = torch.empty((c, n, t), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch("site_pass_loglik", "site_loglik_launch", p(q), p(freq),
                  p(bits2), p(z), p(wg), p(ll), p(ll_part), c, n, l, k,
                  int(structure))
    return ll
