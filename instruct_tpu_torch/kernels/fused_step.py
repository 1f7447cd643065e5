"""The per-site passes of the diploid sweep (modes 1-5).

Counterpart of ``instruct_tpu/kernels/fused_step.py``:

  * :func:`allele_counts` (:87 there) -- counts [K, L, A] of valid allele
    copies from (z, panel);
  * the entry points of the per-site pass ``_site_pass`` (:612), one read of
    the site planes each.  A *sampling* pass draws per copy
    ``z ~ Cat(q_k * P[k, l, a])`` by inverse CDF, counts each individual's
    copies per pop (``qqnum``) and the allele-pop counts of the fresh z
    (``zcounts``), and evaluates one log-lik family at that fresh z (the
    sweep order is "Z, then G | z" / "Z, then F | z", so a sampling pass
    never reads the old z and takes no ``z_old`` argument); a *stored-step*
    pass evaluates cal_lkh per individual at the carried z.  The pass runs
    any K with K * A <= 64 (:func:`site_pass_fits`, the JAX step's gate):

      ==================  ==========================  =======================
      family              sampling pass               stored-step pass
      ==================  ==========================  =======================
      none                :func:`zq_sample_pass`
      mode1 (no selfing)  :func:`zq_mode1_pass`       :func:`panel_loglik_mode1_pass`
      gen (two columns)   :func:`zq_gen_pass`         :func:`panel_loglik_pass`
      gendiff (G MH)      :func:`zq_gendiff_pass`
      find (F per indv)   :func:`zq_f_pass` pop=False  :func:`panel_loglik_f_pass`
      fpop (F per pop)    :func:`zq_f_pass` pop=True   :func:`panel_loglik_f_pass`
      ==================  ==========================  =======================

Every entry point takes the panel as a :class:`Dataset`.  A packed
diploid-biallelic panel (``data.bits2`` present, A = 2) runs the affine
path: the CDF prefixes are ``A_j + B_j * g`` in the allele bit g (the JAX
kernel's biallelic fast path, ``fused_step.py:258-286``).  Any other panel
runs the generic path: ``cum += q_k * w_k`` with ``w_k = P[k, l, a]`` picked
by the allele code (:288-299, :374-390).  The two round differently, so
each path is its own plain version; ``data._replace(bits2=None)`` sends a
biallelic panel down the generic path.  The panel planes (``bits2`` or
``geno``) are shared by the chains, or one per chain ([C, N, ...]: the
tetraploid engine's latent genotype, ``tetra/engine.py``).  Every sampling
pass, on both paths, carries the allele-pop counts of its fresh z
(``zcounts`` f32[C, K, L, A], equal to :func:`allele_counts`'s): the card has
no VMEM budget to drop them under, so the step never recounts.

Chains are a written-out leading axis ``C`` on every state tensor; the panel
tensors carry none.  On CUDA tensors the wrappers launch the kernels of
``csrc/site_pass.cuh`` (one launch per call; its scratch, kept per device
and shape, is allocated at the first call; K <= 8 and 8 < K <= 32 are two
bodies, counted apart with the suffix ``_wide``) / ``csrc/allele_counts.cu``; on
CPU tensors they run the plain versions (``*_reference``, same signature)
below.

z-draw uniforms: site ``(n, s)``, ``s = copy * L + l``, takes Philox word
``n * 2L + s`` of the (chain, step, ``STREAM_Z``) counter space through the
``[0, 1)`` conversion, or ``u[c, n, s]`` when uniforms are injected.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

_LOG2 = 0.6931471805599453
_EPS = 1e-30
MAX_CELLS = 64     # the site pass runs K * A <= 64 (K <= 32 at A = 2)
WIDE_POPS = 8      # K above this runs the kernel's run-time-K body ...
WIDE_BUCKETS = (16, 32)    # ... instantiated for these pop buckets
# The kernel's launch shape (csrc/site_pass.cuh): threads a block, loci a
# thread, and the shared memory a block may take on the H100.
SITE_THREADS, SITE_QUAD = 128, 4
SMEM_LIMIT = 232_448
# The wide body's row strips: at most WIDE_STRIP_ROWS rows where it stages
# the tile's P (it reuses it over them), down to MIN_STRIP_ROWS while a call
# has fewer than WIDE_BLOCKS blocks, and MIN_STRIP_ROWS where it does not;
# its byte counts take at most 127 rows.  Per bucket, its rows staged at a
# time (packed, generic; 4 in fpop's sampling pass) and the pops a run of
# its prefix loops (K padded to a multiple of it).
WIDE_STRIP_ROWS, MIN_STRIP_ROWS, WIDE_BLOCKS = 64, 16, 2048
WIDE_STAGE_ROWS = {16: (8, 4), 32: (4, 4)}
WIDE_RUN = {16: 2, 32: 4}

# log-lik families; the values are those of csrc/site_pass.cuh
_FAMILY = dict(none=0, mode1=1, gen=2, gendiff=3, find=4, fpop=5)


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


def is_packed(data: Dataset) -> bool:
    """Whether the site pass reads ``data.bits2`` (the affine biallelic
    path) rather than the allele codes (the generic path)."""
    return data.bits2 is not None and data.max_alleles == 2


def site_pass_fits(n_pops: int, n_alleles: int) -> bool:
    """Whether the site pass runs a model of ``n_pops`` pops and
    ``n_alleles`` alleles: K * A <= 64, the gate of the JAX fused step
    (``instruct_tpu/mcmc/step.py:111-117``).  The plain versions run any
    K."""
    return n_pops * n_alleles <= MAX_CELLS


# ---------------------------------------------------------------------------
# allele counts
# ---------------------------------------------------------------------------

# The counting kernel's launch shape (csrc/allele_counts.cu): 8 warps over a
# tile of 128 loci (4 a lane) and a strip of rows.  The packed plane runs
# the packed body (one instantiation per pop bucket), the allele codes the
# codes body up to COUNTS_CODES_CELLS cells and the table body beyond; the
# register bodies count in 8-bit fields and flush them every
# COUNTS_FIELD_ROWS rows a lane; the table body's pop windows hold as many
# pops as 48 KB of table (at least one).  Strips: a tile's are one cluster
# (at most COUNTS_MAX_STRIPS, at least COUNTS_MIN_ROWS rows each): where the
# chains' tiles fill at most half a wave of resident blocks (COUNTS_SMS SMs
# times the blocks an SM of the body holds; twice that for the table body),
# as many as fill one; up to two waves, COUNTS_MID_STRIPS (long tiles
# balance over the SMs); beyond, one.
COUNTS_TILE = 128
COUNTS_POP_BUCKETS = (4, 8, 16, 32)
COUNTS_CODES_CELLS = 8
COUNTS_FIELD_BITS, COUNTS_FIELD_ROWS = 8, 127
COUNTS_MIN_ROWS, COUNTS_MAX_STRIPS, COUNTS_SMS = 32, 8, 132
COUNTS_MID_STRIPS = 2
COUNTS_TABLE_SMEM = 48 * 1024


class CountsPlan(NamedTuple):
    """Launch plan of one K4 call (``csrc/allele_counts.cu:plan``): ``body``
    ``packed``, ``codes`` or ``table``, ``bucket`` the packed body's pop
    bucket (0 for the others), ``grid`` (locus tiles x pop windows,
    strips: a cluster, chains), ``rows`` a strip, ``pops_per_window`` the
    pops of a block's table, ``dyn_smem`` its bytes."""
    body: str
    bucket: int
    grid: tuple
    rows: int
    pops_per_window: int
    dyn_smem: int


def counts_plan(c: int, n: int, l: int, k: int, a: int,
                packed: bool = False) -> CountsPlan:
    """The launch plan of K4 for C = c chains of an n x l panel at K = k
    pops and A = a alleles, read from the packed plane (``packed``, taken
    where A = 2 and K * A <= 64) or the allele codes.  Pure arithmetic, the
    kernel's own: the CPU tests check it for every K and A up to 127, the
    card against ``allele_counts_launch_plan``."""
    tiles = -(-l // COUNTS_TILE)
    cells = k * a
    bucket = 0
    if packed and a == 2 and cells <= MAX_CELLS:
        body = "packed"
        bucket = next(b for b in COUNTS_POP_BUCKETS if k <= b)
        per_sm = 4 if bucket <= 4 else (3 if bucket <= 8 else 2)
    elif cells <= COUNTS_CODES_CELLS:
        body, per_sm = "codes", 3
    else:
        body, per_sm = "table", 6
    kw = k if body != "table" else min(k, max(
        1, COUNTS_TABLE_SMEM // (a * COUNTS_TILE * 4)))
    windows = -(-k // kw)
    cols = c * tiles * windows
    wave = COUNTS_SMS * per_sm
    strips = (wave // cols if 2 * cols <= wave
              else COUNTS_MID_STRIPS if cols < 2 * wave else 1)
    strips = max(1, min(strips, n // COUNTS_MIN_ROWS, COUNTS_MAX_STRIPS))
    rows = -(-n // strips)
    strips = -(-n // rows)
    return CountsPlan(body, bucket, (tiles * windows, strips, c), rows, kw,
                      kw * a * COUNTS_TILE * 4)


def allele_counts_reference(z, geno, site_valid, *, n_pops: int,
                            max_alleles: int, bits2=None):
    """Plain PyTorch version of :func:`allele_counts` (same signature)."""
    c, n, s = z.shape
    l = s // 2
    valid = site_valid[None]
    out = z.new_zeros((c, n_pops, l, max_alleles), dtype=torch.float32)
    geno = geno if geno.dim() == 3 else geno[None]
    for copy in range(2):
        zc = z[:, :, copy * l:(copy + 1) * l]
        gc = geno[:, :, copy * l:(copy + 1) * l]
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

    z int8[C, N, 2L] copy-major; geno int8[N, 2L] (or [C, N, 2L], one per
    chain); site_valid bool[N, L]; ``bits2`` int8[N, L] (or [C, N, L]), when
    given (packed biallelic panel, K * A <= 64), is read in place of geno
    and site_valid by the kernel's packed body; otherwise it reads the
    allele codes, into register fields up to K * A = 8 and a shared-memory
    table beyond.  Launch plan: :func:`counts_plan`.
    """
    if z.dim() != 3:
        raise ValueError("z must be [C, N, 2L]")
    if not z.is_cuda:
        return allele_counts_reference(z, geno, site_valid, n_pops=n_pops,
                                       max_alleles=max_alleles, bits2=bits2)
    c, n, s = z.shape
    l = s // 2
    _build.check(z, "z", torch.int8, (c, n, 2 * l))
    wide = n_pops * max_alleles > 64
    if bits2 is not None and max_alleles == 2 and not wide:
        plane_cs = _build.plane_stride(bits2, "bits2", c, n, l, torch.int8)
        geno = site_valid = None
    else:
        bits2 = None
        plane_cs = _build.plane_stride(geno, "geno", c, n, 2 * l, torch.int8)
        _build.check(site_valid, "site_valid", torch.bool, (n, l))
    counts = torch.empty((c, n_pops, l, max_alleles), dtype=torch.float32,
                         device=z.device)
    p = _build.ptr
    # the wide table is another kernel of the source: counted apart
    _build.launch("allele_counts_wide" if wide else "allele_counts",
                  "allele_counts_launch", p(z), p(bits2), p(geno),
                  p(site_valid), p(counts), c, n, l, n_pops, max_alleles,
                  plane_cs)
    return counts


# ---------------------------------------------------------------------------
# the site pass: plain version
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


def _at_z(rows, zc):
    out = rows[0].expand_as(zc)
    for kk in range(1, len(rows)):
        out = torch.where(zc == kk, rows[kk], out)
    return out


def _site_pass_reference(keys, step, q, freq, data: Dataset, z_in, colv,
                         fvals, u, *, sample: bool, ll_kind: str,
                         structure: bool = True):
    """Plain PyTorch version of the whole per-site pass (every family, both
    paths), the function ``_site_kernel`` of the JAX package computes:
    dict with ``z``, ``qqnum``, ``zcounts`` (sampling) and ``ll``
    f32[C, N, n_out] (families other than none)."""
    c, k, l, a = freq.shape
    n = data.n_indv
    dev = freq.device
    packed = is_packed(data)
    if packed:
        g0, g1, valid, hom = unpack_bits2(data.bits2)
    else:
        g0 = data.geno[..., :l].to(torch.int64)
        g1 = data.geno[..., l:].to(torch.int64)
        valid, hom = data.site_valid, data.hom
    # a shared panel plane gets the chain axis; a per-chain one has it
    g0, g1, valid, hom = [t if t.dim() == 3 else t[None]
                          for t in (g0, g1, valid, hom)]
    vf = valid.to(torch.float32)
    gen_fam = ll_kind in ("gen", "gendiff")
    mix = gen_fam and not structure      # expectation way: the Q mixture

    # per-pop probability of each copy's allele, w_c[k] f32[C, N, L]
    if packed:
        g0f, g1f = g0.to(torch.float32), g1.to(torch.float32)
        f0 = [freq[:, kk, :, 0][:, None, :] for kk in range(k)]
        d = [freq[:, kk, :, 1][:, None, :] - f0[kk] for kk in range(k)]
        w0 = [f0[kk] + d[kk] * g0f for kk in range(k)]
        w1 = [f0[kk] + d[kk] * g1f for kk in range(k)]
    else:
        def w_of(gc):
            ws = []
            for kk in range(k):
                w = torch.zeros((c, n, l), dtype=torch.float32, device=dev)
                for ai in range(a):
                    w = torch.where(gc == ai, freq[:, kk, :, ai][:, None, :],
                                    w)
                ws.append(w)
            return ws
        w0, w1 = w_of(g0), w_of(g1)

    # CDF prefixes of the z draw; the last is the Q-mixture probability
    cum0 = cum1 = None
    if sample or mix:
        qc = [q[:, :, kk][:, :, None] for kk in range(k)]
        if packed:
            ca, cb = qc[0] * f0[0], qc[0] * d[0]
            cum0, cum1 = [ca + cb * g0f], [ca + cb * g1f]
            for kk in range(1, k):
                ca = ca + qc[kk] * f0[kk]
                cb = cb + qc[kk] * d[kk]
                cum0.append(ca + cb * g0f)
                cum1.append(ca + cb * g1f)
        else:
            def prefixes(ws):
                cc = qc[0] * ws[0]
                out = [cc]
                for kk in range(1, k):
                    cc = cc + qc[kk] * ws[kk]
                    out.append(cc)
                return out
            cum0, cum1 = prefixes(w0), prefixes(w1)

    res = {}
    if sample:
        uu = _site_uniforms(keys, step, c, n, l, u, dev)

        def draw(cum, u01):
            ut = u01 * cum[-1]
            zc = torch.zeros((c, n, l), dtype=torch.int64, device=dev)
            for jj in range(k - 1):
                zc = zc + (ut > cum[jj])
            return zc

        z0, z1 = draw(cum0, uu[:, :, :l]), draw(cum1, uu[:, :, l:])
        res["z"] = torch.cat([z0, z1], dim=2).to(torch.int8)
        res["qqnum"] = torch.stack(
            [(((z0 == kk).to(torch.float32) + (z1 == kk).to(torch.float32))
              * vf).sum(dim=2) for kk in range(k)], dim=2)
        # the allele-pop counts of the fresh z (a code outside [0, A)
        # counts nowhere, as in allele_counts)
        res["zcounts"] = torch.stack([torch.stack(
            [(((z0 == kk) & (g0 == ai)).to(torch.float32)
              + ((z1 == kk) & (g1 == ai)).to(torch.float32))
             .mul(vf).sum(dim=1) for ai in range(a)], dim=2)
            for kk in range(k)], dim=1)
    else:
        z0 = z_in[:, :, :l].to(torch.int64)
        z1 = z_in[:, :, l:].to(torch.int64)
    if ll_kind == "none":
        return res

    p0 = cum0[-1] if mix else _at_z(w0, z0)
    p1 = cum1[-1] if mix else _at_z(w1, z1)
    same = z0 == z1
    hom_f = hom.to(torch.float32)

    def col(t, i):
        return t[:, :, i][:, :, None]

    if ll_kind == "mode1":
        # cal_lkh of the no-selfing model (log_ld_noselfing_indv)
        site = _log(p0) + _log(p1) + (g0 != g1).to(torch.float32) * _LOG2
        cols = [(site * vf).sum(dim=2)]
    elif ll_kind == "gen":
        # selfing-generation columns (log_ld_indv); colv = 2^(1-g)
        indep = _log(p0) + _log(p1) + (1.0 - hom_f) * _LOG2
        cols = []
        for i in range(colv.shape[2]):
            wg = col(colv, i)
            site = _log(torch.where(
                hom, p0 * p0 + p0 * (1.0 - p0) * (1.0 - wg),
                2.0 * p0 * p1 * wg))
            if structure:
                site = torch.where(same, site, indep)
            cols.append((site * vf).sum(dim=2))
    elif ll_kind == "gendiff":
        # G-update MH log-ratio (update_G): only hom sites take a log; het
        # sites add the row constant log(w_p / w_c)
        m = (same & valid) if structure else valid.expand_as(same)
        wc, wp = col(colv, 0), col(colv, 1)
        q1 = 1.0 - p0
        ratio = (torch.clamp_min(1.0 - q1 * wp, _EPS)
                 / torch.clamp_min(1.0 - q1 * wc, _EPS))
        mh = (m & hom).to(torch.float32)
        mt = (m & ~hom).to(torch.float32)
        dh = _log(colv[:, :, 1]) - _log(colv[:, :, 0])
        cols = [(torch.log(ratio) * mh).sum(dim=2) + dh * mt.sum(dim=2)]
    else:
        # inbreeding families: f per individual (find) or of pop z0 (fpop)
        def f_col(i):
            if ll_kind == "find":
                return col(colv, i)
            return _at_z([fvals[:, kk, i][:, None, None] for kk in range(k)],
                         z0)

        if sample:
            # MH terms over the F-dependent same-z sites: one log of a
            # quotient, the common p0 / 2 p0 p1 factors cancelled
            fa, fb = f_col(0), f_col(1)
            num = torch.where(hom, p0 * (1.0 - fb) + fb, 1.0 - fb)
            den = torch.where(hom, p0 * (1.0 - fa) + fa, 1.0 - fa)
            dl = (torch.log(torch.clamp_min(num, _EPS)
                            / torch.clamp_min(den, _EPS))
                  * (same.to(torch.float32) * vf))
            if ll_kind == "find":
                cols = [dl.sum(dim=2)]
            else:
                cols = [(dl * (z0 == kk).to(torch.float32)).sum(dim=2)
                        for kk in range(k)]
        else:
            # cal_lkh (log_ld_F_indv / log_ld_F_pop)
            f = f_col(0)
            joint = _log(torch.where(hom, p0 * p0 * (1.0 - f) + p0 * f,
                                     2.0 * p0 * p1 * (1.0 - f)))
            indep = _log(p0) + _log(p1) + (1.0 - hom_f) * _LOG2
            cols = [(torch.where(same, joint, indep) * vf).sum(dim=2)]
    res["ll"] = torch.stack(cols, dim=2)
    return res


# ---------------------------------------------------------------------------
# the site pass: kernel launch
# ---------------------------------------------------------------------------

# (device, C, N, L, K, partial columns, counts, strips) -> the site pass's
# scratch
_SCRATCH: dict = {}


def _site_scratch(dev, c, n, l, k, cols, counts, strips=None):
    """(part, cnt_part, tickets, strips) of a site-pass call: the tile
    partials f32[C, N, T, cols], the counts' scratch (sampling pass; else
    None) and the tickets i32[C*S + C*T].  ``counts`` is None (no counts),
    ``"strips"`` (packed, K <= 8: the strips' i32[C, S, K, L], two
    half-word counts a cell) or the table's cells a locus, K * A (their
    total i32[C, K*A, L]).  ``strips`` is S (None: the kernel's
    ``site_pass_strips``).  Allocated once per device and shape and kept:
    the tickets and the total are zeroed once, and every call leaves them
    zero.  Calls that share them run in stream order."""
    key = (dev, c, n, l, k, cols, counts, strips)
    hit = _SCRATCH.get(key)
    if hit is None:
        lib = _build.library()
        t = lib.site_pass_tiles(l)
        s = lib.site_pass_strips(n) if strips is None else strips
        cnt = None
        if counts == "strips":
            cnt = torch.empty((c, s, k, l), dtype=torch.int32, device=dev)
        elif counts:
            cnt = torch.zeros((c, counts, l), dtype=torch.int32, device=dev)
        hit = (torch.empty((c, n, t, max(cols, 1)), dtype=torch.float32,
                           device=dev), cnt,
               torch.zeros(c * s + c * t, dtype=torch.int32, device=dev), s)
        _SCRATCH[key] = hit
    return hit


class SitePlan(NamedTuple):
    """Launch plan of the site pass's wide body (8 < K <= 32)."""
    bucket: int         # the instantiation's pop bucket (K rounded up)
    strips: int         # row strips S of the grid (T, S, C)
    strip_rows: int     # rows of a strip: ceil(N / S)
    dyn_smem: int       # dynamic shared memory of a block, bytes
    static_smem: int    # its static shared memory, bytes


def site_plan(c: int, n: int, l: int, k: int, a: int, *, packed: bool,
              sample: bool, ll_kind: str, structure: bool = True
              ) -> SitePlan:
    """The wide body's launch plan for a call of ``C = c`` chains over an
    ``n x l`` panel at K = k pops of A = a alleles (``packed``: the bits2
    plane, A = 2): the pop bucket, the row strips and the shared memory of
    a block, as ``csrc/site_pass.cuh`` takes them (its ``dyn_bytes`` and
    the static arrays of ``site_kernel``; a stored-step pass that reads P
    only at z, generic or at K > 16, stages none).  Pure arithmetic: the
    CPU tests check it for every 8 < K <= 32 with K * A <= 64."""
    if not (WIDE_POPS < k <= WIDE_BUCKETS[-1] and site_pass_fits(k, a)):
        raise ValueError(f"the wide body runs 8 < K <= 32 with K * A <= "
                         f"{MAX_CELLS}, got {k} x {a}")
    bucket = next(b for b in WIDE_BUCKETS if k <= b)
    plane = SITE_QUAD * SITE_THREADS             # one pop plane of a tile
    run = WIDE_RUN[bucket]
    k_run = -(-k // run) * run                   # pops staged
    stage_p = (sample or (packed and bucket == WIDE_BUCKETS[0])
               or (ll_kind == "gen" and not structure))
    dyn = k_run * plane * (8 if packed else 4 * a) if stage_p else 0
    if sample:
        dyn += k * plane * (2 if packed else a)  # the strip's byte counts
    # static: the staged site words, rows' q and columns, warp partials
    fam = _FAMILY[ll_kind]
    n_in = 2 if sample else 1
    stage_rows = (4 if ll_kind == "fpop" and sample
                  else WIDE_STAGE_ROWS[bucket][0 if packed else 1])
    words = (1 if packed else (4 if fam >= _FAMILY["gen"] else 3)) + (
        0 if sample else 2)
    acc = {"none": 0, "gendiff": 2, "gen": n_in,
           "fpop": bucket if sample else 1}.get(ll_kind, 1)
    cols = (bucket if sample else 0) + acc
    static = 4 * (2 * words * stage_rows * SITE_THREADS
                  + 2 * stage_rows * (bucket + 2)
                  + 2 * stage_rows * (SITE_THREADS // 32) * max(cols, 1) + 1)
    tiles = -(-l // plane)
    strips = max(-(-n // (WIDE_STRIP_ROWS if stage_p else MIN_STRIP_ROWS)),
                 min(-(-WIDE_BLOCKS // (c * tiles)),
                     -(-n // MIN_STRIP_ROWS)))
    strips = max(1, min(strips, n))
    rows = -(-n // strips)
    return SitePlan(bucket, -(-n // rows), rows, dyn, static)


def site_counter(name: str, data: Dataset, n_pops: int) -> str:
    """The launch-counter name of an entry point's kernel: ``name`` on the
    packed plane, ``name + "_generic"`` on the allele codes, with
    ``"_wide"`` added for the run-time-K body (K > 8)."""
    return (name + ("" if is_packed(data) else "_generic")
            + ("_wide" if n_pops > WIDE_POPS else ""))


def _site_pass(name: str, keys, step, q, freq, data: Dataset, z_in, colv,
               fvals, u, *, sample: bool, ll_kind: str,
               structure: bool = True):
    """Run one per-site pass: the plain version on CPU tensors, the kernel
    (counted under :func:`site_counter`) on CUDA tensors.  Same result dict
    as :func:`_site_pass_reference`."""
    if freq.dim() != 4:
        raise ValueError("freq must be [C, K, L, A]")
    c, k, l, a = freq.shape
    n = data.n_indv
    if not site_pass_fits(k, a):
        raise ValueError(f"the site pass runs n_pops * n_alleles <= "
                         f"{MAX_CELLS}, got {k} x {a}")
    if (data.n_loci, data.max_alleles, data.ploid) != (l, a, 2):
        raise ValueError(f"freq {tuple(freq.shape)} does not fit a diploid "
                         f"panel of {data.n_loci} loci x "
                         f"{data.max_alleles} alleles")
    if not freq.is_cuda:
        return _site_pass_reference(keys, step, q, freq, data, z_in, colv,
                                    fvals, u, sample=sample, ll_kind=ll_kind,
                                    structure=structure)
    if n * 2 * l >= 1 << 34:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    packed = is_packed(data)
    n_in = 2 if sample else 1
    n_out = {"none": 0, "gendiff": 1, "gen": n_in,
             "fpop": k if sample else 1}.get(ll_kind, 1)
    chk = _build.check
    chk(freq, "freq", torch.float32, (c, k, l, a))
    if q is not None:
        chk(q, "q", torch.float32, (c, n, k))
    if packed:
        plane_cs = _build.plane_stride(data.bits2, "bits2", c, n, l,
                                       torch.int8)
        planes = (data.bits2, None, None, None)
    else:
        plane_cs = _build.plane_stride(data.geno, "geno", c, n, 2 * l,
                                       torch.int8)
        chk(data.site_valid, "site_valid", torch.bool, (n, l))
        chk(data.hom, "hom", torch.bool, (n, l))
        planes = (None, data.geno, data.site_valid, data.hom)
    if z_in is not None:
        chk(z_in, "z", torch.int8, (c, n, 2 * l))
    if colv is not None:
        chk(colv, "colv", torch.float32, (c, n, n_in))
    if fvals is not None:
        chk(fvals, "fvals", torch.float32, (c, k, n_in))
    if u is not None:
        chk(u, "u", torch.float32, (c, n, 2 * l))
    dev = freq.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_acc = 2 if ll_kind == "gendiff" else n_out
    counts = None
    if sample:
        counts = "strips" if packed and k <= WIDE_POPS else k * a
    strips = None
    if k > WIDE_POPS:
        strips = site_plan(c, n, l, k, a, packed=packed, sample=sample,
                           ll_kind=ll_kind, structure=structure).strips
    part, cnt_part, tickets, strips = _site_scratch(
        dev, c, n, l, k, (k if sample else 0) + n_acc, counts, strips)
    res = {}
    z = qqnum = zcounts = ll = chain_key = None
    if sample:
        chain_key = keys.chain_key
        chk(chain_key, "chain_key", torch.int32, (c,))
        z = torch.empty((c, n, 2 * l), dtype=torch.int8, device=dev)
        qqnum = torch.empty((c, n, k), **f32)
        zcounts = torch.empty((c, k, l, a), **f32)
        res.update(z=z, qqnum=qqnum, zcounts=zcounts)
    if n_out:
        ll = torch.empty((c, n, n_out), **f32)
        res["ll"] = ll
    p = _build.ptr
    fn = (f"site_{'packed' if packed else 'generic'}_"
          f"{'sample' if sample else 'eval'}_launch")
    _build.launch(site_counter(name, data, k), fn, p(q), p(freq),
                  *[p(x) for x in planes], p(z_in), p(colv), p(fvals), p(u),
                  p(z), p(qqnum), p(zcounts), p(ll), p(part), p(cnt_part),
                  p(tickets), c, n, l, k, a, _FAMILY[ll_kind], int(structure),
                  strips, plane_cs,
                  keys.k0 if sample else 0, keys.k1 if sample else 0,
                  p(chain_key), step if sample else 0)
    return res


def _need_q(q):
    if q is None or q.dim() != 3:
        raise ValueError("q must be [C, N, K]")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
# Shared argument conventions:
#   keys     RngKeys (seed + per-chain keys); step  the step index
#   q        f32[C, N, K]      admixture proportions
#   freq     f32[C, K, L, A]   allele frequencies
#   data     Dataset           the panel (see the module docstring)
#   z        int8[C, N, 2L]    carried per-copy assignments, copy-major
#   u        f32[C, N, 2L]     optional injected z-draw uniforms
# A sampling pass returns z int8[C, N, 2L], qqnum f32[C, N, K] and zcounts
# f32[C, K, L, A].

def zq_sample_pass_reference(keys, step: int, q, freq, data, *, u=None):
    """Plain PyTorch version of :func:`zq_sample_pass` (same signature)."""
    r = _site_pass_reference(keys, step, q, freq, data, None, None, None, u,
                             sample=True, ll_kind="none")
    return r["z"], r["qqnum"], r["zcounts"]


def zq_sample_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                   data: Dataset, *, u: Optional[torch.Tensor] = None):
    """Sampling only (the mode-1 sweep; its cal_lkh is deferred to stored
    steps, :func:`panel_loglik_mode1_pass`).  Returns (z, qqnum, zcounts)."""
    _need_q(q)
    r = _site_pass("site_pass_sample", keys, step, q, freq, data, None, None,
                   None, u, sample=True, ll_kind="none")
    return r["z"], r["qqnum"], r["zcounts"]


def zq_mode1_pass_reference(keys, step: int, q, freq, data, *, u=None):
    """Plain PyTorch version of :func:`zq_mode1_pass` (same signature)."""
    r = _site_pass_reference(keys, step, q, freq, data, None, None, None, u,
                             sample=True, ll_kind="mode1")
    return r["z"], r["qqnum"], r["ll"][:, :, 0], r["zcounts"]


def zq_mode1_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                  data: Dataset, *, u: Optional[torch.Tensor] = None):
    """Mode 1 (no selfing) in one pass: sample z, count, and cal_lkh at the
    fresh z.  Returns (z, qqnum, ll f32[C, N], zcounts)."""
    _need_q(q)
    r = _site_pass("site_pass_mode1", keys, step, q, freq, data, None, None,
                   None, u, sample=True, ll_kind="mode1")
    return r["z"], r["qqnum"], r["ll"][:, :, 0], r["zcounts"]


def panel_loglik_mode1_pass_reference(freq, q, data, z):
    """Plain PyTorch version of :func:`panel_loglik_mode1_pass` (same
    signature)."""
    r = _site_pass_reference(None, 0, q, freq, data, z, None, None, None,
                             sample=False, ll_kind="mode1")
    return r["ll"][:, :, 0]


def panel_loglik_mode1_pass(freq: torch.Tensor, q: Optional[torch.Tensor],
                            data: Dataset, z: torch.Tensor) -> torch.Tensor:
    """cal_lkh for mode 1 (log_ld_noselfing_indv) at the carried z:
    f32[C, N].  ``q`` is not read (the family is z-conditioned); it keeps
    its place from the JAX signature and may be ``None``."""
    r = _site_pass("site_pass_loglik_mode1", None, 0, None, freq, data, z,
                   None, None, None, sample=False, ll_kind="mode1")
    return r["ll"][:, :, 0]


def zq_gen_pass_reference(keys, step: int, q, freq, data, wg_pair, *,
                          structure: bool, u=None):
    """Plain PyTorch version of :func:`zq_gen_pass` (same signature)."""
    r = _site_pass_reference(keys, step, q, freq, data, None, wg_pair, None,
                             u, sample=True, ll_kind="gen",
                             structure=structure)
    return r["z"], r["qqnum"], r["ll"], r["zcounts"]


def zq_gen_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                data: Dataset, wg_pair: torch.Tensor, *, structure: bool,
                u: Optional[torch.Tensor] = None):
    """Sample z, count, and the selfing log-lik at the current and the
    proposed generation counts: ``wg_pair`` f32[C, N, 2] = 2^(1-g) at
    (current, proposed) g.  Returns (z, qqnum, ll f32[C, N, 2], zcounts).
    ``structure`` picks the structure way (z-conditioned copy
    probabilities) over the expectation way."""
    _need_q(q)
    r = _site_pass("site_pass_gen", keys, step, q, freq, data, None, wg_pair,
                   None, u, sample=True, ll_kind="gen", structure=structure)
    return r["z"], r["qqnum"], r["ll"], r["zcounts"]


def zq_gendiff_pass_reference(keys, step: int, q, freq, data, wg_pair, *,
                              structure: bool, u=None):
    """Plain PyTorch version of :func:`zq_gendiff_pass` (same signature)."""
    r = _site_pass_reference(keys, step, q, freq, data, None, wg_pair, None,
                             u, sample=True, ll_kind="gendiff",
                             structure=structure)
    return r["z"], r["qqnum"], r["ll"][:, :, 0], r["zcounts"]


def zq_gendiff_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
                    data: Dataset, wg_pair: torch.Tensor, *, structure: bool,
                    u: Optional[torch.Tensor] = None):
    """The production form of :func:`zq_gen_pass` (modes 2/3): the G-update
    MH log-ratio as one column, the difference of the two ``gen`` columns
    with the common factors cancelled (about 4x fewer logs).  Returns
    (z, qqnum, ll_diff f32[C, N], zcounts)."""
    _need_q(q)
    r = _site_pass("site_pass_gendiff", keys, step, q, freq, data, None,
                   wg_pair, None, u, sample=True, ll_kind="gendiff",
                   structure=structure)
    return r["z"], r["qqnum"], r["ll"][:, :, 0], r["zcounts"]


def panel_loglik_pass_reference(freq, q, data, z, wg, *, structure: bool):
    """Plain PyTorch version of :func:`panel_loglik_pass` (same
    signature)."""
    r = _site_pass_reference(None, 0, q, freq, data, z, wg[:, :, None], None,
                             None, sample=False, ll_kind="gen",
                             structure=structure)
    return r["ll"][:, :, 0]


def panel_loglik_pass(freq: torch.Tensor, q: torch.Tensor, data: Dataset,
                      z: torch.Tensor, wg: torch.Tensor, *,
                      structure: bool) -> torch.Tensor:
    """cal_lkh for modes 2/3: per-individual log-lik f32[C, N] at the
    carried (q, gen, z); ``wg`` f32[C, N] = 2^(1-g)."""
    _need_q(q)
    r = _site_pass("site_pass_loglik", None, 0, q, freq, data, z,
                   wg[:, :, None].contiguous(), None, None, sample=False,
                   ll_kind="gen", structure=structure)
    return r["ll"][:, :, 0]


def zq_f_pass_reference(keys, step: int, q, freq, data, f_pair, *, pop: bool,
                        u=None):
    """Plain PyTorch version of :func:`zq_f_pass` (same signature)."""
    r = _site_pass_reference(keys, step, q, freq, data, None,
                             None if pop else f_pair, f_pair if pop else None,
                             u, sample=True,
                             ll_kind="fpop" if pop else "find")
    return (r["z"], r["qqnum"], r["ll"] if pop else r["ll"][:, :, 0],
            r["zcounts"])


def zq_f_pass(keys, step: int, q: torch.Tensor, freq: torch.Tensor,
              data: Dataset, f_pair: torch.Tensor, *, pop: bool,
              u: Optional[torch.Tensor] = None):
    """The inbreeding modes' sampling pass: sample z, count, and the
    F-dependent terms of the MH update at the fresh z.

    ``pop=True`` (mode 4): ``f_pair`` f32[C, K, 2] = (current, proposed) F
    per pop; the third return is fdiff f32[C, N, K], column k summing
    ``log L(f'_k) - log L(f_k)`` over the individual's valid same-z sites
    whose copies sit in pop k (its sum over N is the MH log-ratio of
    update_inbreedcoff_POP).  ``pop=False`` (mode 5): ``f_pair``
    f32[C, N, 2]; the third return is lldiff f32[C, N], the per-individual
    MH log-ratio of update_F_IND.  Returns (z, qqnum, fdiff or lldiff,
    zcounts)."""
    _need_q(q)
    r = _site_pass("site_pass_fpop" if pop else "site_pass_find", keys, step,
                   q, freq, data, None, None if pop else f_pair,
                   f_pair if pop else None, u, sample=True,
                   ll_kind="fpop" if pop else "find")
    return (r["z"], r["qqnum"], r["ll"] if pop else r["ll"][:, :, 0],
            r["zcounts"])


def panel_loglik_f_pass_reference(freq, data, z, f, *, pop: bool):
    """Plain PyTorch version of :func:`panel_loglik_f_pass` (same
    signature)."""
    f = f[:, :, None]
    r = _site_pass_reference(None, 0, None, freq, data, z,
                             None if pop else f, f if pop else None, None,
                             sample=False, ll_kind="fpop" if pop else "find")
    return r["ll"][:, :, 0]


def panel_loglik_f_pass(freq: torch.Tensor, data: Dataset, z: torch.Tensor,
                        f: torch.Tensor, *, pop: bool) -> torch.Tensor:
    """cal_lkh for modes 4/5 (log_ld_F_pop / log_ld_F_indv) at the carried
    (P, F, Z): f32[C, N].  ``f`` is f32[C, K] (``pop=True``) or
    f32[C, N]."""
    f = f[:, :, None].contiguous()
    r = _site_pass("site_pass_loglik_fpop" if pop else
                   "site_pass_loglik_find", None, 0, None, freq, data, z,
                   None if pop else f, f if pop else None, None,
                   sample=False, ll_kind="fpop" if pop else "find")
    return r["ll"][:, :, 0]
