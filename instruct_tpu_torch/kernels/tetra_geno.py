"""The site passes of the tetraploid engine: K5, K6 and K7.

Counterpart of ``instruct_tpu/kernels/tetra_geno_pallas.py``:

  * :func:`geno_choice_pass` (``geno_choice_pass`` :340 there) -- the
    latent-genotype Gibbs move: per site and candidate ordering c the weight
    ``table[z0, l, cls_c]`` at a same-z site, else ``log mult_c + sum_m log
    mix_sys(m)[allele_m]`` with the Q-mixture ``mix_sys[a] = sum_k q_k
    freq_sys[k, l, a]``; then a Gumbel-argmax over the site's valid
    candidates -> the chosen candidate;
  * :func:`s_delta_pass` (:168) -- the per-pop MH log-ratio of the S update,
    ``sum over valid same-z sites with z0 = k of (tab_prop - tab_cur)(z0, l,
    class(geno))``;
  * :func:`site_ll_pass` (:279) -- the per-individual log-lik (cal_lkd):
    same-z sites read the class table, mixed-z sites add the per-slot log
    frequencies to the ordering's log multiplicity.

Chains are a written-out leading axis.  On CUDA tensors the wrappers launch
``csrc/tetra_geno.cu``; on CPU tensors they run the plain versions
(``*_reference``, same signature) below.  The engine (``tetra/engine.py``)
calls the wrappers on both of its sweeps; it uses the lookups here only to
build its data-only tables.  Every lookup is a gather on a flat index
(``table_at``, ``site_class``): the JAX package's select chains exist for the
TPU only and give the same values.  The kernels take any K up to 127 (z is
int8) and any number of classes G: the JAX package runs its kernels only
while a site's table row fits the TPU's vector memory (K * G <= 1024).

Gumbel noise of the move: site ``(n, l)`` owns ``bps = ceil(n_cand / 4)``
Philox blocks of the (chain, step, ``STREAM_GENO``) counter space, block
``(n * L + l) * bps + j``; candidate ``c`` takes word ``c % 4`` of block
``c // 4`` through the ``(0, 1)`` conversion, ``-log(-log(u))``.  ``gumbel``
f32[C, n_cand, N, L] injects the noise instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

MAX_POPS = 127     # z is int8
MAX_CAND = 12      # candidate orderings per site (allotetraploid)
_EPS = 1e-30
_NEG = -1e30


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


# ---------------------------------------------------------------------------
# lookups shared by the plain versions and the engine
# ---------------------------------------------------------------------------

def split4(flat: torch.Tensor):
    """The four slot planes [..., L] of a copy-major tetraploid tensor
    [..., 4L] (slot m at columns [m L, (m+1) L)), as int64."""
    l = flat.shape[-1] // 4
    return tuple(flat[..., m * l:(m + 1) * l].to(torch.int64)
                 for m in range(4))


def same_z(zc) -> torch.Tensor:
    """bool: all four copies of the site in one pop."""
    return (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])


def site_class(lookup_l: torch.Tensor, geno: torch.Tensor) -> torch.Tensor:
    """Class index int64[..., L] of the ordered genotypes ``geno``
    [..., 4L]: the per-locus lookup ``lookup_l`` i32[L, V] (V = n_max^4) at
    the base-n_max packed code (get_index_auto/allo,
    poly_geno.c:1289-1311, 1374-1394)."""
    l, v = lookup_l.shape
    nm = round(v ** 0.25)
    g0, g1, g2, g3 = split4(geno)
    packed = ((g0 * nm + g1) * nm + g2) * nm + g3
    loc = torch.arange(l, device=geno.device)
    return torch.take(lookup_l, loc * v + packed).to(torch.int64)


def table_at(table: torch.Tensor, z0: torch.Tensor,
             cls: torch.Tensor) -> torch.Tensor:
    """f32[C, N, L] = table[c, z0, l, cls] for table f32[C, K, L, G], z0 and
    cls int[C, N, L] (or [N, L], shared by the chains)."""
    c, k, l, g = table.shape
    loc = torch.arange(l, device=table.device)
    idx = (z0.to(torch.int64) * l + loc) * g + cls.to(torch.int64)
    n = idx.shape[-2]
    idx = idx.expand(c, n, l).reshape(c, n * l)
    return torch.gather(table.reshape(c, k * l * g), 1, idx).reshape(c, n, l)


def at_locus(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[l, idx] for rows [L, X] and idx int[..., L]."""
    l, x = rows.shape
    loc = torch.arange(l, device=rows.device)
    return torch.take(rows, loc * x + idx.to(torch.int64))


def freq_at(freq: torch.Tensor, zc: torch.Tensor,
            gc: torch.Tensor) -> torch.Tensor:
    """f32[C, N, L] = freq[c, z, l, g] for freq f32[C, K, L, A]."""
    c, k, l, a = freq.shape
    loc = torch.arange(l, device=freq.device)
    idx = (zc * l + loc) * a + gc
    n = idx.shape[-2]
    return torch.gather(freq.reshape(c, k * l * a), 1,
                        idx.reshape(c, n * l)).reshape(c, n, l)


def mix_per_allele(freq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """m f32[C, A, N, L] = sum_k q[c, n, k] freq[c, k, l, a], added in the
    order of k (the Q-mixture of the mixed-z ordering weights,
    poly_geno.c:879-891; a matmul or ``sum`` would round otherwise on the
    card and on the CPU)."""
    acc = q[:, None, :, 0, None] * freq[:, 0].transpose(1, 2)[:, :, None, :]
    for kk in range(1, freq.shape[1]):
        acc = acc + (q[:, None, :, kk, None]
                     * freq[:, kk].transpose(1, 2)[:, :, None, :])
    return acc


def site_loglik(table, lookup_l, log_mult_l, freq, freq2, z, geno,
                site_valid, *, autopoly: bool) -> torch.Tensor:
    """Per-site log-lik f32[C, N, L] (cal_lkd via calc_genofq,
    poly_geno.c:715-735, 1235-1286): ``table[z0, l, cls]`` at same-z sites,
    ``log_mult[l, cls] + sum_m log freq_sys(m)[z_m, l, g_m]`` (slot order)
    elsewhere, 0 at invalid sites."""
    cls = site_class(lookup_l, geno)
    zc, gc = split4(z), split4(geno)
    ll_same = table_at(table, zc[0], cls)
    ll_mix = at_locus(log_mult_l, cls)
    for m in range(4):
        f_sys = freq if (autopoly or m < 2) else freq2
        ll_mix = ll_mix + _slog(freq_at(f_sys, zc[m], gc[m]))
    site = torch.where(same_z(zc), ll_same, ll_mix)
    return torch.where(site_valid[None], site, torch.zeros_like(site))


def gumbel_planes(keys: px.RngKeys, step: int, n_cand: int, n: int,
                  l: int) -> torch.Tensor:
    """f32[C, n_cand, N, L] Gumbel noise of the move from Philox (see the
    module docstring)."""
    bps = -(-n_cand // 4)
    words = px.random_words(keys, step, px.STREAM_GENO, n * l * bps * 4)
    u = px.u01_open(words).reshape(-1, n, l, bps * 4)[..., :n_cand]
    return (-torch.log(-torch.log(u))).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# K5: the latent-genotype move
# ---------------------------------------------------------------------------

def geno_choice_pass_reference(keys, step: int, table, z, dist, nc, q, freq,
                               freq2, cand_sel, cand_cls, cand_mult, *,
                               autopoly: bool, gumbel=None):
    """Plain PyTorch version of :func:`geno_choice_pass` (same signature):
    the streaming Gumbel-argmax of ``engine._sample_geno``."""
    c = z.shape[0]
    n_cand, n, l = cand_sel.shape
    if gumbel is None:
        gumbel = gumbel_planes(keys, step, n_cand, n, l)
    zc = split4(z)
    same = same_z(zc)
    mix1 = mix_per_allele(freq, q)
    mix2 = mix1 if autopoly else mix_per_allele(freq2, q)
    dist4 = torch.stack(split4(dist))                        # [4, N, L]
    ncl = nc.to(torch.int64)
    best = torch.full((c, n, l), _NEG, dtype=torch.float32, device=z.device)
    choice = torch.zeros((c, n, l), dtype=torch.int64, device=z.device)
    for cc in range(n_cand):
        w_same = table_at(table, zc[0], cand_cls[cc])
        w_mix = torch.log(cand_mult[cc].to(torch.float32))
        sel8 = cand_sel[cc].to(torch.int64)
        for m in range(4):
            av = dist4.gather(0, ((sel8 >> (2 * m)) & 3)[None])  # [1, N, L]
            mix = mix1 if (autopoly or m < 2) else mix2
            val = mix.gather(1, av[None].expand(c, 1, n, l))[:, 0]
            w_mix = w_mix + _slog(val)
        w = torch.where(same, w_same, w_mix)
        v = torch.where(cc < ncl, w + gumbel[:, cc],
                        torch.full_like(w, _NEG))
        take = v > best
        best = torch.where(take, v, best)
        choice = torch.where(take, torch.full_like(choice, cc), choice)
    return choice.to(torch.int8)


def geno_choice_pass(keys: px.RngKeys, step: int, table: torch.Tensor,
                     z: torch.Tensor, dist: torch.Tensor, nc: torch.Tensor,
                     q: torch.Tensor, freq: torch.Tensor,
                     freq2: Optional[torch.Tensor], cand_sel: torch.Tensor,
                     cand_cls: torch.Tensor, cand_mult: torch.Tensor, *,
                     autopoly: bool, gumbel: Optional[torch.Tensor] = None):
    """Chosen candidate ordering i8[C, N, L] of the latent-genotype move.

    table      f32[C, K, L, G]  log genotype-class frequencies (selfing
                                equilibrium)
    z          i8[C, N, 4L]     per-copy pops, copy-major
    dist       i8[N, 4L]        the site's distinct alleles, copy-major
    nc         u8[N, L]         valid candidates per site
    q          f32[C, N, K]
    freq       f32[C, K, L, A]  system 1 (every slot when ``autopoly``)
    freq2      f32[C, K, L, A]  system 2 (slots 2-3, allo); ignored (may be
                                None) when ``autopoly``
    cand_sel   u8[n_cand, N, L] packed 2-bit distinct-slot selectors
    cand_cls   i16[n_cand, N, L] class of each candidate
    cand_mult  u8[n_cand, N, L] ordering multiplicity
    gumbel     optional f32[C, n_cand, N, L] injected noise
    """
    if z.dim() != 3 or table.dim() != 4:
        raise ValueError("z must be [C, N, 4L] and table [C, K, L, G]")
    if freq2 is None or autopoly:
        freq2 = freq
    if not z.is_cuda:
        return geno_choice_pass_reference(
            keys, step, table, z, dist, nc, q, freq, freq2, cand_sel,
            cand_cls, cand_mult, autopoly=autopoly, gumbel=gumbel)
    c, k, l, g = table.shape
    n_cand, n = cand_sel.shape[:2]
    a = freq.shape[3]
    if not 1 <= k <= MAX_POPS or not 1 <= n_cand <= MAX_CAND:
        raise ValueError(f"geno_choice_pass: K = {k} (<= {MAX_POPS}) and "
                         f"{n_cand} candidates (<= {MAX_CAND}) expected")
    bps = -(-n_cand // 4)
    if n * l * bps >= 1 << 32:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    chk = _build.check
    chk(table, "table", torch.float32, (c, k, l, g))
    chk(z, "z", torch.int8, (c, n, 4 * l))
    chk(dist, "dist", torch.int8, (n, 4 * l))
    chk(nc, "nc", torch.uint8, (n, l))
    chk(q, "q", torch.float32, (c, n, k))
    chk(freq, "freq", torch.float32, (c, k, l, a))
    chk(freq2, "freq2", torch.float32, (c, k, l, a))
    chk(cand_sel, "cand_sel", torch.uint8, (n_cand, n, l))
    chk(cand_cls, "cand_cls", torch.int16, (n_cand, n, l))
    chk(cand_mult, "cand_mult", torch.uint8, (n_cand, n, l))
    chk(keys.chain_key, "chain_key", torch.int32, (c,))
    if gumbel is not None:
        chk(gumbel, "gumbel", torch.float32, (c, n_cand, n, l))
    choice = torch.empty((c, n, l), dtype=torch.int8, device=z.device)
    p = _build.ptr
    _build.launch("geno_choice_pass_" + ("auto" if autopoly else "allo"),
                  "geno_choice_launch", p(table), p(z), p(dist), p(nc), p(q),
                  p(freq), p(freq2), p(cand_sel), p(cand_cls), p(cand_mult),
                  p(gumbel), p(choice), c, n, l, k, a, g, n_cand,
                  int(autopoly), keys.k0, keys.k1, p(keys.chain_key), step)
    return choice


# ---------------------------------------------------------------------------
# K6: the S update's per-pop log-ratio
# ---------------------------------------------------------------------------

def s_delta_pass_reference(tab_cur, tab_prop, lookup_l, z, geno,
                           site_valid):
    """Plain PyTorch version of :func:`s_delta_pass` (same signature)."""
    k = tab_cur.shape[1]
    cls = site_class(lookup_l, geno)
    zc = split4(z)
    mask = same_z(zc) & site_valid[None]
    d = table_at(tab_prop, zc[0], cls) - table_at(tab_cur, zc[0], cls)
    d = torch.where(mask, d, torch.zeros_like(d))
    return torch.stack([torch.where(zc[0] == kk, d, torch.zeros_like(d))
                        .sum(dim=(1, 2)) for kk in range(k)], dim=1)


def s_delta_pass(tab_cur: torch.Tensor, tab_prop: torch.Tensor,
                 lookup_l: torch.Tensor, z: torch.Tensor, geno: torch.Tensor,
                 site_valid: torch.Tensor) -> torch.Tensor:
    """delta f32[C, K]: per chain and pop, the sum over the valid sites whose
    four copies sit in pop k of ``tab_prop - tab_cur`` at (k, l,
    class(geno)).  tab_* f32[C, K, L, G]; lookup_l i32[L, V] (packed code ->
    class per locus); z, geno i8[C, N, 4L]; site_valid bool[N, L]."""
    if not z.is_cuda:
        return s_delta_pass_reference(tab_cur, tab_prop, lookup_l, z, geno,
                                      site_valid)
    c, k, l, g = tab_cur.shape
    n = site_valid.shape[0]
    v = lookup_l.shape[1]
    if not 1 <= k <= MAX_POPS:
        raise ValueError(f"s_delta_pass: K = {k}, at most {MAX_POPS}")
    chk = _build.check
    chk(tab_cur, "tab_cur", torch.float32, (c, k, l, g))
    chk(tab_prop, "tab_prop", torch.float32, (c, k, l, g))
    chk(lookup_l, "lookup_l", torch.int32, (l, v))
    chk(z, "z", torch.int8, (c, n, 4 * l))
    chk(geno, "geno", torch.int8, (c, n, 4 * l))
    chk(site_valid, "site_valid", torch.bool, (n, l))
    part = torch.empty((c, n, k), dtype=torch.float32, device=z.device)
    delta = torch.empty((c, k), dtype=torch.float32, device=z.device)
    p = _build.ptr
    _build.launch("s_delta_pass", "s_delta_launch", p(tab_cur), p(tab_prop),
                  p(lookup_l), p(z), p(geno), p(site_valid), p(part),
                  p(delta), c, n, l, k, g, v, round(v ** 0.25))
    return delta


# ---------------------------------------------------------------------------
# K7: the per-individual log-lik
# ---------------------------------------------------------------------------

def site_ll_pass_reference(table, lookup_l, log_mult_l, freq, freq2, z, geno,
                           site_valid, *, autopoly: bool):
    """Plain PyTorch version of :func:`site_ll_pass` (same signature)."""
    return site_loglik(table, lookup_l, log_mult_l, freq, freq2, z, geno,
                       site_valid, autopoly=autopoly).sum(dim=2)


def site_ll_pass(table: torch.Tensor, lookup_l: torch.Tensor,
                 log_mult_l: torch.Tensor, freq: torch.Tensor,
                 freq2: Optional[torch.Tensor], z: torch.Tensor,
                 geno: torch.Tensor, site_valid: torch.Tensor, *,
                 autopoly: bool) -> torch.Tensor:
    """Per-individual log-lik f32[C, N]: :func:`site_loglik` summed over
    loci.  table f32[C, K, L, G]; lookup_l i32[L, V]; log_mult_l f32[L, G]
    (the log multiplicity of each class at each locus); freq, freq2
    f32[C, K, L, A] (freq2 ignored, may be None, when ``autopoly``); z, geno
    i8[C, N, 4L]; site_valid bool[N, L]."""
    if freq2 is None or autopoly:
        freq2 = freq
    if not z.is_cuda:
        return site_ll_pass_reference(table, lookup_l, log_mult_l, freq,
                                      freq2, z, geno, site_valid,
                                      autopoly=autopoly)
    c, k, l, g = table.shape
    n = site_valid.shape[0]
    a, v = freq.shape[3], lookup_l.shape[1]
    chk = _build.check
    chk(table, "table", torch.float32, (c, k, l, g))
    chk(lookup_l, "lookup_l", torch.int32, (l, v))
    chk(log_mult_l, "log_mult_l", torch.float32, (l, g))
    chk(freq, "freq", torch.float32, (c, k, l, a))
    chk(freq2, "freq2", torch.float32, (c, k, l, a))
    chk(z, "z", torch.int8, (c, n, 4 * l))
    chk(geno, "geno", torch.int8, (c, n, 4 * l))
    chk(site_valid, "site_valid", torch.bool, (n, l))
    ll = torch.empty((c, n), dtype=torch.float32, device=z.device)
    p = _build.ptr
    _build.launch("site_ll_pass_" + ("auto" if autopoly else "allo"),
                  "site_ll_launch", p(table), p(lookup_l), p(log_mult_l),
                  p(freq), p(freq2), p(z), p(geno), p(site_valid), p(ll), c,
                  n, l, k, a, g, v, round(v ** 0.25), int(autopoly))
    return ll
