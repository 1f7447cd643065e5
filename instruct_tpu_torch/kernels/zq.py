"""The Z-Gibbs draw of the unfused sweep, for any K, A and ploidy.

Counterpart of ``instruct_tpu/kernels/zq_pallas.py`` (``zq_sample_counts``
:91).  Per allele copy ``z ~ Cat_k(q[n, k] * P[k, l, a])`` by inverse CDF, and
``qqnum[n, k]`` = the valid copies of individual n drawn to pop k.  The same
function of the uniforms as the JAX kernel, in the same order of float
operations:

    terms[k] = q[n, k] * w_k,  w_k = P[k, l, code], 0 for a code outside
                               [0, A) (a missing copy: total 0, z = 0)
    total    = terms[0] + terms[1] + ... + terms[K-1]
    ut       = u01 * total
    z        = #{k < K-1 : ut > terms[0] + ... + terms[k]}

z is written for every site and counted only where ``site_valid``.  For
K <= 8 on a diploid panel this is also what the generic path of the site
pass draws (``fused_step.zq_sample_pass`` with ``data.bits2`` absent): both
form the prefixes ``cum += q_k * P[k, l, a]`` in the order of k and read
the same Philox words.

Chains are a written-out leading axis.  On CUDA tensors the wrapper launches
``csrc/zq_sample.cu`` with the launch plan :func:`zq_plan`: a pop-bucket
body (one per K <= 8, padded ones for K <= 16 and K <= 32) that stages a
tile of P in shared memory, or the generic run-time-K body (K > 32, or a
tile of P beyond shared memory) on a pop-minor copy of P; on CPU tensors it
runs the plain version below.  A pop past K, zero in q, changes neither z
nor the counts (``u * total <= total``), which is why a padded bucket draws
as the plain version does.

Uniforms: copy ``(n, s)``, ``s = copy * L + l``, takes Philox word
``n * S + s`` of the (chain, step, ``STREAM_Z``) counter space through the
``[0, 1)`` conversion, or ``u[c, n, s]`` when uniforms are injected.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

MAX_POPS = 127     # z is int8
MAX_ALLELES = 127  # allele codes are int8
MAX_PLOID = 4

# The bucket bodies' launch shape (csrc/zq_sample.cu): 256 threads over a
# tile of 128 loci, each warp drawing its own rows of the block's strip;
# strips as long as leaves at least BLOCKS_TARGET blocks (4 an SM), so that
# the staged P serves many rows, and short enough for the block's shared
# memory (SMEM_MAX) and the grid.
THREADS, TILE = 256, 128
ROWS = (128, 64, 32, 16, 8, 4, 2, 1)
SMEM_MAX = 232_448
BLOCKS_TARGET = 528
GRID_MAX = 65_535
GENERIC_ROWS = 16  # the generic body's rows a block


class ZqPlan(NamedTuple):
    """Launch plan of one K8 call: ``bucket`` the pop bucket (K itself for
    K <= 8, 16, 32; 0 for the generic body), ``rows`` the individuals of a
    bucket block (0: the generic body, GENERIC_ROWS a block), the grid, and
    the dynamic shared memory of a block."""
    bucket: int
    rows: int
    grid: tuple
    dyn_smem: int


def zq_bucket(k: int) -> int:
    """The pop bucket of K: K for K <= 8, then 16 and 32; 0 beyond."""
    return k if k <= 8 else (16 if k <= 16 else (32 if k <= 32 else 0))


def _bucket_smem(k: int, a: int, rows: int) -> int:
    # the tile's P, [K][4][32][A | 1] floats, and the strip's q rows and
    # counters, [rows][K] each
    return 4 * (k * TILE * (a | 1) + 2 * rows * k)


def zq_plan(c: int, n: int, l: int, k: int, a: int) -> ZqPlan:
    """The launch plan of K8 for C = c chains of an n x l panel at K = k
    pops and A = a alleles (any ploidy: a copy's row is one of the tile's
    rows), as ``csrc/zq_sample.cu`` takes it.  Pure arithmetic: the CPU
    tests check that it fits the card for every K and A the wrapper takes;
    the card checks its shared memory against the kernel's
    ``zq_sample_launch_dyn_smem``."""
    bucket = zq_bucket(k)
    least = max(1, -(-n // GRID_MAX))            # rows the grid needs
    if bucket:
        tiles = -(-l // TILE)
        rows = next((r for r in ROWS
                     if c * tiles * -(-n // r) >= BLOCKS_TARGET), ROWS[-1])
        # the strip's rows share the block's memory with the tile's P
        room = (SMEM_MAX - _bucket_smem(k, a, 0)) // (8 * k)
        rows = min(max(rows, least), room)
        if rows >= least:
            strips = max(1, -(-n // rows))
            rows = max(1, -(-n // strips))            # balanced strips
            return ZqPlan(bucket, rows, (tiles, strips, c),
                          _bucket_smem(k, a, rows))
    return ZqPlan(0, 0, (-(-l // (THREADS * 4)), -(-n // GENERIC_ROWS), c),
                  4 * 2 * GENERIC_ROWS * k)


def _shapes(q, freq, geno, site_valid, n_pops, u):
    if q.dim() != 3 or freq.dim() != 4:
        raise ValueError("q must be [C, N, K] and freq [C, K, L, A]")
    c, k, l, a = freq.shape
    n, s = geno.shape[-2:]
    if geno.dim() == 3 and geno.shape[0] != c:
        raise ValueError(f"geno {tuple(geno.shape)}: one plane per chain "
                         f"expected, C = {c}")
    if k != n_pops or tuple(q.shape) != (c, n, k):
        raise ValueError(f"q {tuple(q.shape)} and freq {tuple(freq.shape)} "
                         f"do not fit n_pops = {n_pops} and N = {n}")
    if tuple(site_valid.shape) != (n, l) or s % l or not (
            1 <= s // l <= MAX_PLOID):
        raise ValueError(f"geno {tuple(geno.shape)} is not 1..{MAX_PLOID} "
                         f"copy-major copies of the {tuple(site_valid.shape)} "
                         "site grid")
    if not 1 <= k <= MAX_POPS:
        raise ValueError(f"n_pops must be in [1, {MAX_POPS}], got {k}")
    if not 1 <= a <= MAX_ALLELES:
        raise ValueError(f"freq: A must be in [1, {MAX_ALLELES}], got {a}")
    if u is not None and tuple(u.shape) != (c, n, s):
        raise ValueError(f"u: expected {(c, n, s)}, got {tuple(u.shape)}")
    return c, n, s, l, k, a


def zq_sample_counts_reference(keys, step: int, q, freq, geno, site_valid, *,
                               n_pops: int, u=None):
    """Plain PyTorch version of :func:`zq_sample_counts` (same signature)."""
    c, n, s, l, k, a = _shapes(q, freq, geno, site_valid, n_pops, u)
    p = s // l
    if u is None:
        u = px.u01_closed(px.random_words(keys, step, px.STREAM_Z, n * s)
                          ).reshape(c, n, s)
    u = u.to(torch.float32)
    valid = site_valid[None]
    qc = [q[:, :, kk][:, :, None] for kk in range(k)]
    geno = geno if geno.dim() == 3 else geno[None]
    zs = []
    qqnum = torch.zeros((c, n, k), dtype=torch.float32, device=freq.device)
    for copy in range(p):
        code = geno[:, :, copy * l:(copy + 1) * l].to(torch.int64)
        ok = (code >= 0) & (code < a)
        idx = code.clamp(0, a - 1)[:, :, :, None].expand(c, n, l, 1)
        terms = []
        for kk in range(k):
            w = torch.gather(freq[:, kk][:, None].expand(c, n, l, a), 3,
                             idx)[..., 0]
            terms.append(qc[kk] * torch.where(ok, w, torch.zeros_like(w)))
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        ut = u[:, :, copy * l:(copy + 1) * l] * total
        zc = torch.zeros((c, n, l), dtype=torch.int64, device=freq.device)
        cum = torch.zeros_like(total)
        for kk in range(k - 1):
            cum = cum + terms[kk]
            zc = zc + (ut > cum)
        zs.append(zc)
        for kk in range(k):
            qqnum[:, :, kk] += (valid & (zc == kk)).sum(dim=2).to(
                torch.float32)
    return torch.cat(zs, dim=2).to(torch.int8), qqnum


def zq_sample_counts(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                     geno: torch.Tensor, site_valid: torch.Tensor, *,
                     n_pops: int, u: Optional[torch.Tensor] = None):
    """Z sample + per-individual pop counts.

    keys        RngKeys (seed + per-chain keys); step  the step index
    q           f32[C, N, K]     admixture proportions
    freq        f32[C, K, L, A]  allele frequencies
    geno        int8[N, S]       allele codes, copy-major, S = ploidy * L,
                                 or int8[C, N, S], one plane per chain
    site_valid  bool[N, L]
    u           optional f32[C, N, S] injected uniforms

    Returns (z int8[C, N, S], qqnum f32[C, N, K]).
    """
    c, n, s, l, k, a = _shapes(q, freq, geno, site_valid, n_pops, u)
    if not freq.is_cuda:
        return zq_sample_counts_reference(keys, step, q, freq, geno,
                                          site_valid, n_pops=n_pops, u=u)
    if n * s >= 1 << 34:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    if s >= 1 << 24:
        raise ValueError("more than 2^24 copies per individual: the float "
                         "counts would no longer be exact")
    chk = _build.check
    chk(q, "q", torch.float32, (c, n, k))
    chk(freq, "freq", torch.float32, (c, k, l, a))
    geno_cs = _build.plane_stride(geno, "geno", c, n, s, torch.int8)
    chk(site_valid, "site_valid", torch.bool, (n, l))
    chk(keys.chain_key, "chain_key", torch.int32, (c,))
    if u is not None:
        chk(u, "u", torch.float32, (c, n, s))
    z = torch.empty((c, n, s), dtype=torch.int8, device=freq.device)
    qqnum = torch.empty((c, n, k), dtype=torch.float32, device=freq.device)
    plan = zq_plan(c, n, l, k, a)
    if max(plan.grid[1:]) > GRID_MAX:
        raise ValueError(f"zq_sample_counts: grid {plan.grid} beyond the "
                         f"card's {GRID_MAX} in y or z")
    # the generic body gathers from a pop-minor copy, [C, L, A, K]
    src = freq if plan.bucket else freq.permute(0, 2, 3, 1).contiguous()
    p = _build.ptr
    _build.launch("zq_sample_counts", "zq_sample_launch", p(q), p(src),
                  p(geno), p(site_valid), p(u), p(z), p(qqnum), c, n, l, k, a,
                  s // l, plan.rows, geno_cs, keys.k0, keys.k1,
                  p(keys.chain_key), step)
    return z, qqnum
