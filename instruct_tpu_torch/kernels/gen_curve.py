"""The G-marginalized site log-likelihood curve of the gradient samplers,
forward and backward, as a differentiable function.

Counterpart of ``instruct_tpu/samplers/potential.py:119-128``
(``MarginalModel.log_lik`` in modes 2 and 3).  Not a Pallas kernel there:
XLA fuses the dense ``[N, L, G]`` expression under ``jax.value_and_grad``
and ``vmap``; eager PyTorch would write it to memory (8 GB a temporary at 4
chains of the 1000 x 10 000 panel, G = 50) and keep several for autograd.
For each batch row b (a chain, an ELBO sample or an SMC particle),
individual n and selfing generation g = 1..G:

    per_gen[b, n, g] = sum over valid sites l of log(max(gf_g, 1e-30))
    m_c  = sum_k q[b, n, k] P[b, k, l, x_c]        (x_c the copy's allele)
    w_g  = 2^(1-g)
    gf_g = m0^2 + m0 (1 - m0)(1 - w_g)   at a homozygous site
           2 m0 m1 w_g                   at a heterozygous one

:func:`gen_curve` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches ``csrc/gen_curve.cu:gen_curve_fwd_kernel`` and its backward
``gen_curve_bwd_launch`` (each row's coefficients, then ``dm_c``, ``dq``'s
and ``dP``'s partials by tiles of 16 individuals x 256 sites held in
shared memory, then the partials summed in order; the scratch comes from
:func:`bwd_plan`); on CPU tensors they run the plain versions
:func:`gen_curve_reference` and :func:`gen_curve_backward_reference`, which
take the valid sites only and a chunk of g at a time (one g at full
width), JAX's form at homozygous sites and ``log(2 m0 m1) + (1 - g) log 2``
at heterozygous ones (one logarithm a site instead of G).  The kernel
takes the homozygous sites with ``m0 >= 1e-14`` in an equal form whose
work a site does not grow with G: ``log m0 + log(1 - (1 - m0) w_g)``, the
generation indices 1..7 exact (a logarithm of a product of 8 sites'
factors), from index 8 on the series of ``log(1 - x)`` to ``x^4`` summed
over the sites through the power sums of ``1 - m0``; backward, the
series' sum over g is a cubic in ``1 - m0`` whose coefficients are
computed once a row (see ``csrc/gen_curve.cu``).  Both are JAX's curve
within float32 rounding.
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.model.likelihood import per_pop_copy_probs

# pops: the backward block's q rows (BWD_INDV x K floats) beside its
# fixed 66 560 bytes fit a block's 232 448 (csrc/gen_curve.cu:check_shapes;
# any number of generations)
MAX_POPS = 2592
MAX_ALLELES = 127   # alleles a locus (kMaxA)
MAX_ROWS = 65535    # batch rows, a grid dimension of both passes
TILE = 256       # sites of a chunk (kTile)
BWD_INDV = 16    # individuals of a backward tile (kBwdIndv)
SEGMENT = 4      # chunks a backward block walks (kSegment)
STAGE_CELLS = 32  # P staged in shared memory when K * A <= this
COEF = 16        # floats of a row's backward coefficients (kCoef)
_EPS = 1e-30
_LN2 = 0.6931471805599453
# elements of a [B, sites, g] temporary of the plain versions
_CHUNK_ELEMS = 1 << 22


def gen_weights(gen_cap: int, device) -> torch.Tensor:
    """w_g = 2^(1-g), g = 1..gen_cap, f32[G]."""
    gens = torch.arange(1, gen_cap + 1, dtype=torch.float32, device=device)
    return torch.exp2(1.0 - gens)


def _copy_probs(q, p, data: Dataset):
    """The per-copy mixture probabilities m0, m1 f32[B, N, L] and the
    per-pop allele probabilities [(pk0, pk1)] in pop order."""
    l = data.n_loci
    m0 = m1 = None
    per_pop = []
    for k, pk in enumerate(per_pop_copy_probs(p, data)):
        pk0, pk1 = pk[..., :l], pk[..., l:]
        per_pop.append((pk0, pk1))
        qk = q[:, :, k, None]
        m0 = qk * pk0 if m0 is None else m0 + qk * pk0
        m1 = qk * pk1 if m1 is None else m1 + qk * pk1
    return m0, m1, per_pop


def _g_chunks(n_sites: int, gen_cap: int):
    """Ranges of g whose [B, sites, g] float temporaries hold at most
    ``_CHUNK_ELEMS`` elements (one g at a time at full width)."""
    step = max(1, _CHUNK_ELEMS // max(1, n_sites))
    return [(lo, min(gen_cap, lo + step)) for lo in range(0, gen_cap, step)]


def _sites(data: Dataset):
    """Flat indices (n * L + l) of the valid homozygous and heterozygous
    sites, and their individuals."""
    l = data.n_loci
    hom = (data.site_valid & data.hom).flatten().nonzero().squeeze(1)
    het = (data.site_valid & ~data.hom).flatten().nonzero().squeeze(1)
    return hom, het, hom // l, het // l


def gen_curve_reference(q, p, data: Dataset, gen_cap: int) -> torch.Tensor:
    """Plain version of the forward pass: per_gen f32[B, N, G] from ``q``
    f32[B, N, K] and ``p`` f32[B, K, L, A], the kernel's arithmetic on the
    valid sites only (homozygous: JAX's float32 gf_g and its log;
    heterozygous: log(2 m0 m1) + (1 - g) log 2 where 2 m0 m1 w_g is not
    clipped), a chunk of g at a time, summed per individual in site
    order."""
    m0, m1, _ = _copy_probs(q, p, data)
    b, n, _l = m0.shape
    hom, het, n_hom, n_het = _sites(data)
    m0f, m1f = m0.reshape(b, -1), m1.reshape(b, -1)
    mh = m0f[:, hom, None]
    a, c = mh * mh, mh * (1 - mh)
    t = (2.0 * m0f[:, het] * m1f[:, het])[..., None]
    lt = torch.log(t)
    w = gen_weights(gen_cap, q.device).to(m0.dtype)
    shift = torch.arange(gen_cap, dtype=m0.dtype, device=q.device) * _LN2
    log_eps = torch.log(torch.tensor(_EPS, dtype=m0.dtype))
    out = torch.zeros((b, n, gen_cap), dtype=m0.dtype, device=m0.device)
    for lo, hi in _g_chunks(b * max(hom.numel(), het.numel()), gen_cap):
        wg = w[lo:hi]
        site = torch.log(torch.clamp_min(a + c * (1 - wg), _EPS))
        out[..., lo:hi].index_add_(1, n_hom, site)
        site = torch.where(t * wg >= _EPS, lt - shift[lo:hi],
                           log_eps.to(m0.device))
        out[..., lo:hi].index_add_(1, n_het, site)
    return out


def gen_curve_backward_reference(q, p, data: Dataset, gen_cap: int,
                                 dper_gen):
    """Plain version of the backward pass: (dq f32[B, N, K], dp f32[B, K, L,
    A]) given ``dper_gen`` f32[B, N, G].  Where the clip binds (gf_g <=
    1e-30) the term's gradient is zero."""
    m0, m1, per_pop = _copy_probs(q, p, data)
    b, n, l = m0.shape
    hom, het, n_hom, n_het = _sites(data)
    m0f, m1f = m0.reshape(b, -1), m1.reshape(b, -1)
    mh = m0f[:, hom, None]
    a, c = mh * mh, mh * (1 - mh)
    me0, me1 = m0f[:, het], m1f[:, het]
    t = (2.0 * me0 * me1)[..., None]
    w = gen_weights(gen_cap, q.device).to(m0.dtype)
    zero = torch.zeros((), dtype=m0.dtype, device=m0.device)
    dm_hom = torch.zeros_like(mh[..., 0])
    s_het = torch.zeros_like(me0)
    for lo, hi in _g_chunks(b * max(hom.numel(), het.numel()), gen_cap):
        wg = w[lo:hi]
        d = dper_gen[..., lo:hi]
        gf = a + c * (1 - wg)
        num = 2.0 * mh * wg + (1 - wg)
        dm_hom = dm_hom + torch.where(gf > _EPS, (d[:, n_hom] * num) / gf,
                                      zero).sum(-1)
        s_het = s_het + torch.where(t * wg > _EPS, d[:, n_het],
                                    zero).sum(-1)
    live = s_het != 0
    dm0 = torch.zeros_like(m0f)
    dm1 = torch.zeros_like(m0f)
    dm0[:, hom] = dm_hom
    dm0[:, het] = torch.where(live, s_het / me0, zero)
    dm1[:, het] = torch.where(live, s_het / me1, zero)
    dm0, dm1 = dm0.reshape(b, n, l), dm1.reshape(b, n, l)
    dq = torch.stack([(dm0 * pk0 + dm1 * pk1).sum(-1)
                      for pk0, pk1 in per_pop], dim=-1)
    x0, x1 = data.geno[:, :l], data.geno[:, l:]
    k_pops, a_max = p.shape[1], p.shape[3]
    dp = torch.zeros_like(p)
    for al in range(a_max):
        contrib = (torch.where(x0 == al, dm0, zero)
                   + torch.where(x1 == al, dm1, zero))
        for k in range(k_pops):
            dp[:, k, :, al] = (q[:, :, k, None] * contrib).sum(1)
    return dq, dp


def bwd_plan(n: int, l: int, k: int, a: int) -> dict:
    """The backward pass's launch plan (``csrc/gen_curve.cu:
    gen_curve_bwd_plan``, which the card checks): tiles of ``BWD_INDV``
    individuals x ``SEGMENT`` chunks of ``TILE`` sites a block, the chunks
    walked in order with the next one's P and codes in flight; P staged
    in shared memory when ``k * a <= STAGE_CELLS``; the block's dynamic
    shared memory (bytes).  The scratch: the rows' coefficients [B, N,
    COEF], dq's partials [chunks, B, N, K] and dP's [tiles, B, K, L,
    A]."""
    tiles, chunks = -(-n // BWD_INDV), -(-l // TILE)
    stage = k * a <= STAGE_CELLS
    floats = ((k * a * TILE if stage else 0) + 2 * BWD_INDV * TILE
              + BWD_INDV * COEF + BWD_INDV * k)
    return dict(indv=BWD_INDV, tiles=tiles, chunks=chunks, segment=SEGMENT,
                stage=stage, smem=4 * floats + 2 * BWD_INDV * 4 * TILE)


def _check(q, p, data: Dataset, gen_cap: int):
    b, n, k = q.shape
    l, a = data.n_loci, data.max_alleles
    if data.ploid != 2:
        raise ValueError("the G curve is the diploid modes' (2 and 3)")
    if gen_cap < 1:
        raise ValueError(f"gen_cap {gen_cap}: the kernel takes 1 or more "
                         "generations")
    if k > MAX_POPS:
        raise ValueError(f"K = {k}: the kernel takes at most {MAX_POPS} "
                         "pops")
    if a > MAX_ALLELES:
        raise ValueError(f"{a} alleles: the kernel takes at most "
                         f"{MAX_ALLELES}")
    if b > MAX_ROWS:
        raise ValueError(f"{b} batch rows: the kernel takes at most "
                         f"{MAX_ROWS}")
    chk = _build.check
    chk(q, "q", torch.float32, (b, n, k))
    chk(p, "p", torch.float32, (b, k, l, a))
    chk(data.geno, "geno", torch.int8, (n, 2 * l))
    chk(data.hom, "hom", torch.bool, (n, l))
    chk(data.site_valid, "site_valid", torch.bool, (n, l))
    return b, n, l, k, a


def _forward(q, p, data: Dataset, gen_cap: int) -> torch.Tensor:
    if not q.is_cuda:
        return gen_curve_reference(q, p, data, gen_cap)
    b, n, l, k, a = _check(q, p, data, gen_cap)
    out = torch.empty((b, n, gen_cap), dtype=torch.float32, device=q.device)
    ptr = _build.ptr
    _build.launch("gen_curve_fwd", "gen_curve_fwd_launch", ptr(q), ptr(p),
                  ptr(data.geno), ptr(data.hom), ptr(data.site_valid),
                  ptr(out), b, n, l, k, a, gen_cap)
    return out


def _backward(q, p, data: Dataset, gen_cap: int, dper_gen):
    if not q.is_cuda:
        return gen_curve_backward_reference(q, p, data, gen_cap, dper_gen)
    b, n, l, k, a = _check(q, p, data, gen_cap)
    dper_gen = dper_gen.contiguous()
    _build.check(dper_gen, "dper_gen", torch.float32, (b, n, gen_cap))
    dev = q.device
    plan = bwd_plan(n, l, k, a)
    coef = torch.empty((b, n, COEF), dtype=torch.float32, device=dev)
    dq_part = torch.empty((plan["chunks"], b, n, k), dtype=torch.float32,
                          device=dev)
    dp_part = torch.empty((plan["tiles"],) + tuple(p.shape),
                          dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dp = torch.empty_like(p)
    ptr = _build.ptr
    _build.launch("gen_curve_bwd", "gen_curve_bwd_launch", ptr(q), ptr(p),
                  ptr(data.geno), ptr(data.hom), ptr(data.site_valid),
                  ptr(dper_gen), ptr(coef), ptr(dq_part), ptr(dp_part),
                  ptr(dq), ptr(dp), b, n, l, k, a, gen_cap)
    return dq, dp


class _GenCurve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, p, data, gen_cap):
        ctx.save_for_backward(q, p)
        ctx.data, ctx.gen_cap = data, gen_cap
        return _forward(q, p, data, gen_cap)

    @staticmethod
    def backward(ctx, dper_gen):
        q, p = ctx.saved_tensors
        dq, dp = _backward(q, p, ctx.data, ctx.gen_cap, dper_gen)
        return dq, dp, None, None


def gen_curve(q: torch.Tensor, p: torch.Tensor, data: Dataset,
              gen_cap: int) -> torch.Tensor:
    """per_gen f32[B, N, G] from ``q`` f32[B, N, K] (rows on the simplex)
    and ``p`` f32[B, K, L, A] (the masked-softmax allele frequencies), on
    the panel ``data`` (diploid; copy codes, ``hom``, ``site_valid``),
    differentiable in ``q`` and ``p``.  No ``[B, N, L, G]`` or
    ``[B, N, L]`` tensor is made; the backward pass's scratch is its
    partials (:func:`bwd_plan`)."""
    return _GenCurve.apply(q.contiguous(), p.contiguous(), data, gen_cap)
