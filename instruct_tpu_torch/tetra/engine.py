"""The tetraploid (auto / allo) engine: mcmc_POP_tetra_selfing
(poly_geno.c:75-140 and callees).

Counterpart of ``instruct_tpu/tetra/engine.py``: ``TetraTables`` and
``build_tables`` (:56-147 there), ``log_hwe_table`` (:203),
``selfing_equilibrium`` (:225), the site lookups (:248-301), the P updates
(:308-380), the Z/Q updates (:383-458), the latent-genotype move
(:461-619), ``init_tetra_state`` (:626) and ``build_tetra_step`` (:712).
Chains are a written-out leading axis on every state tensor.

One sweep, for all chains:

    P (+ P2 allo) | z, geno  counts on the diploid views  kernels/fused_step.py
                             (allele_counts, K4), Dirichlet kernels/dirichlet.py
                             (K3)
    class tables             log HWE table, selfing equilibrium: one batched
                             float64 solve per allele-count class
    S                        per-pop MH, the K decisions in parallel: the
                             log-ratio of each subsweep from s_delta_pass (K6)
    Z, Q                     the per-copy z draw on the diploid view (K1
                             zq_sample_pass, fused; K8 zq_sample_counts,
                             unfused), Q | Z (K3)
    geno                     the latent-ordering move: geno_choice_pass (K5)
    alpha                    MH                          mcmc/updates.py
    (stored steps) log-lik   site_ll_pass (K7)

Both sweeps run K5, K6 and K7; they differ in the Z draw only.  The JAX
package runs its geno and log-lik kernels only while a site's table row
(K * G floats) fits the TPU's vector memory; the CUDA kernels read the table
from device memory and take any K and G.

**Diploid views.**  The copy-major [N, 4L] layout makes slots 0-1 and 2-3
each a diploid [N, 2L] panel.  Auto runs ONE diploid pass over [N, 2(2L)]
(copy 0 = slots 0, 1 at loci l' < 2L; copy 1 = slots 2, 3) with the
frequencies repeated, [K, 2L, A].  Allo needs freq on slots 0-1 and freq2 on
slots 2-3: its view is the columns reordered to slots (0, 2, 1, 3), so that
loci l' < L are system 1 and l' >= L system 2, with [freq | freq2] -- one
pass too, where the JAX package makes two.  The views' planes are per chain
(the latent genotype is), which the kernels take as a chain stride.  On a
biallelic panel the JAX site kernel takes its affine path for any A = 2
panel; the port's site pass takes it from a packed ``bits2`` plane, so the
view's plane is packed from the current genotype each sweep.

**Tables.**  Everything that depends only on the data -- the class tables,
their per-locus rows (``lookup_l``, ``log_mult_l``, ``digits_l``) and the
[n_cand, N, L] candidate planes -- is built once per run on the device
(``build_tables``; ~4 bytes x n_cand x N x L, 120 MB for allo at 500 x
5000).  The JAX package rebuilds the planes in-trace instead.

**Randomness.**  Philox words of the (chain, step) counter space: P from
``STREAM_P`` (allo's freq2 from ``STREAM_P2``), the S update's uniforms from
the tail streams (``STREAM_R_PROP``, ``STREAM_R_ACC``, ``STREAM_R_FRESH``),
z from ``STREAM_Z`` (word n * 4L + column of the copy-major layout), Q from
``STREAM_Q``, the move's Gumbel noise from ``STREAM_GENO``, alpha from
``STREAM_ALPHA``; the initial state draws from the same streams at step
``INIT_STEP``.  ``StepDraws`` injects them instead (tests).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.kernels.zq import zq_sample_counts
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.mcmc.state import (McmcState, _dt_stat,
                                           masked_z_counts)
from instruct_tpu_torch.tetra.combinatorics import (ALLO_PATTERNS,
                                                    AUTO_PATTERNS,
                                                    build_class_tables)

_EPS = 1e-30
_NEG = -1e30


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


class TetraTables(NamedTuple):
    """The data-only tables of a run, on the panel's device (+ host
    metadata)."""

    self_mat: torch.Tensor     # f32[Cc, G, G] selfing transition A of each
    #   allele-count class
    patterns_np: np.ndarray    # host [5, P_max, 4] candidate orderings
    n_patterns_np: np.ndarray  # host [5]
    n_max: int
    g_max: int
    class_loci: tuple          # ((class index, i64 loci tensor, G), ...)
    lookup_l: torch.Tensor     # i32[L, V] packed code -> class, per locus
    log_mult_l: torch.Tensor   # f32[L, G] log multiplicity, per locus
    digits_l: torch.Tensor     # i64[L, G, 4] canonical alleles, per locus
    gvalid_l: torch.Tensor     # bool[L, G]
    # the candidate planes of the latent-genotype move (with_candidates):
    cand_sel: Optional[torch.Tensor] = None   # u8[n_cand, N, L] 2-bit
    #   distinct-slot selectors, slot m at bits [2m, 2m + 2)
    cand_cls: Optional[torch.Tensor] = None   # i16[n_cand, N, L] class
    cand_mult: Optional[torch.Tensor] = None  # u8[n_cand, N, L]
    #   ordering multiplicity
    cand_nc: Optional[torch.Tensor] = None    # u8[N, L] valid candidates
    dist8: Optional[torch.Tensor] = None      # i8[N, 4L] Dataset.distinct
    # the class rows that lookup_l repeats and each locus's row (K6 and K7
    # stage the rows in shared memory)
    class_map: Optional[tg.ClassMap] = None

    @property
    def n_cand(self) -> int:
        return int(self.n_patterns_np.max())


def build_tables(spec: ModelSpec, data: Dataset,
                 with_candidates: bool = True) -> TetraTables:
    """The tables of ``data`` on its device; ``with_candidates=False``
    skips the [n_cand, N, L] planes (the log-lik passes need none)."""
    dev = data.site_valid.device
    n_alleles = data.allele_valid.sum(-1).cpu().numpy().astype(np.int32)
    ct = build_class_tables(n_alleles, spec.autopoly)
    cls = ct.class_of_locus(n_alleles)
    pat_bank = AUTO_PATTERNS if spec.autopoly else ALLO_PATTERNS
    p_max = max(p.shape[0] for p in pat_bank.values())
    patterns = np.zeros((5, p_max, 4), np.int32)
    n_patterns = np.zeros(5, np.int32)
    for cnt, pats in pat_bank.items():
        patterns[cnt, :pats.shape[0]] = pats
        n_patterns[cnt] = pats.shape[0]

    def dev_t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    class_loci = tuple(
        (ci, dev_t(np.nonzero(cls == ci)[0], torch.int64),
         int(ct.g_count[ci]))
        for ci in range(len(ct.allele_counts)) if (cls == ci).any())
    tab = TetraTables(
        self_mat=dev_t(ct.self_mat, torch.float32),
        patterns_np=patterns, n_patterns_np=n_patterns,
        n_max=ct.n_max, g_max=ct.g_max, class_loci=class_loci,
        lookup_l=dev_t(ct.lookup[cls], torch.int32),
        log_mult_l=dev_t(ct.log_mult[cls], torch.float32),
        digits_l=dev_t(ct.digits[cls], torch.int64),
        gvalid_l=dev_t(ct.valid[cls], torch.bool),
        class_map=tg.ClassMap(dev_t(cls, torch.uint8),
                              dev_t(ct.lookup, torch.int32)))
    if not with_candidates:
        return tab
    if data.distinct is None or data.n_distinct is None:
        raise ValueError("the tetraploid engine needs Dataset.distinct / "
                         "n_distinct (build the panel with ploid 4)")
    sel, cls_p, mult = _candidate_planes(tab, data)
    cnt = data.n_distinct.clamp(1, 4).to(torch.int64)
    nc = dev_t(n_patterns, torch.int64)[cnt].to(torch.uint8)
    return tab._replace(cand_sel=sel, cand_cls=cls_p, cand_mult=mult,
                        cand_nc=nc, dist8=data.distinct.to(torch.int8))


def _candidate_planes(tables: TetraTables, data: Dataset):
    """The static per-candidate site planes: for candidate c the pattern
    bank routes the site's distinct alleles into four slots (the
    two/tri/tetra_allele_* tables, poly_geno.c:2440-2638); its class and
    ordering multiplicity follow from the lookup."""
    dev = data.site_valid.device
    cnt = data.n_distinct.clamp(1, 4).to(torch.int64)            # [N, L]
    pats = torch.as_tensor(tables.patterns_np, dtype=torch.int64,
                           device=dev)                           # [5, P, 4]
    dist4 = torch.stack(tg.split4(data.distinct))               # [4, N, L]
    nm = tables.n_max
    sel_pl, cls_pl, mult_pl = [], [], []
    for c in range(tables.n_cand):
        sels = [pats[:, c, m][cnt] for m in range(4)]
        slots = [dist4.gather(0, s[None])[0] for s in sels]
        packed = ((slots[0] * nm + slots[1]) * nm + slots[2]) * nm + slots[3]
        cls_idx = tg.at_locus(tables.lookup_l, packed).to(torch.int64)
        lmult = tg.at_locus(tables.log_mult_l, cls_idx)
        sel_pl.append((sels[0] | (sels[1] << 2) | (sels[2] << 4)
                       | (sels[3] << 6)).to(torch.uint8))
        cls_pl.append(cls_idx.to(torch.int16))
        mult_pl.append(torch.round(torch.exp(lmult)).to(torch.uint8))
    return torch.stack(sel_pl), torch.stack(cls_pl), torch.stack(mult_pl)


# The tetraploid fused sweep's pop limit: the JAX engine's gate
# (``instruct_tpu/tetra/engine.py:352``), kept although the diploid site pass
# now runs any K with K*A <= 64.
TETRA_FUSED_MAX_POPS = 8


def tetra_use_fused(spec: ModelSpec, data: Dataset) -> bool:
    """Whether the tetraploid sweep is the fused one (the site kernels K1,
    K4 on the diploid views; ``_tetra_use_pallas``, JAX engine.py:344):
    K <= 8 and K*A <= 64 unless ``use_pallas`` is False."""
    return (spec.use_pallas is not False
            and spec.n_pops <= TETRA_FUSED_MAX_POPS
            and fs.site_pass_fits(spec.n_pops, data.max_alleles))


# ---------------------------------------------------------------------------
# genotype-class frequency tables
# ---------------------------------------------------------------------------

def log_hwe_table(tables: TetraTables, spec: ModelSpec, freq, freq2):
    """R: log expected (HWE) genotype-class frequencies f32[C, K, L, G]
    (calc_exfreq_auto/allo, poly_geno.c:1515-1670): the class's log
    multiplicity plus the log frequency of each slot's canonical allele, in
    slot order; -1e30 beyond a locus's classes."""
    c, k, l, a = freq.shape
    g = tables.g_max
    lf1 = _slog(freq)
    lf2 = lf1 if spec.autopoly else _slog(freq2)
    acc = tables.log_mult_l[None, None].expand(c, k, l, g)
    for slot in range(4):
        lf = lf1 if (spec.autopoly or slot < 2) else lf2
        idx = tables.digits_l[None, None, :, :, slot].expand(c, k, l, g)
        acc = acc + torch.gather(lf, 3, idx)
    return torch.where(tables.gvalid_l, acc, torch.full_like(acc, _NEG))


def selfing_equilibrium(tables: TetraTables, log_hwe, s):
    """log genotype-class frequencies under selfing rate s[c, k] per chain
    and pop: solve (I - s A_c) P = (1 - s) R for the loci of each
    allele-count class (replaces auto_genfreq/allo_genfreq,
    poly_geno.c:1803-2304).  The solve runs in float64, one batched call per
    class over (chain, pop) with the loci as right-hand sides, so the card
    (batched LU) and the CPU (LAPACK) give float32 tables that agree to the
    last bit or two.  A rate of exactly 1 makes I - A singular: the table is
    then NaN and the MH step rejects that proposal, as in the JAX package."""
    c, k, l, g_max = log_hwe.shape
    out = torch.full_like(log_hwe, _NEG)
    s64 = s.to(torch.float64)[:, :, None, None]
    for ci, loci, g in tables.class_loci:
        a = tables.self_mat[ci, :g, :g].to(torch.float64)
        eye = torch.eye(g, dtype=torch.float64, device=log_hwe.device)
        mats = eye - s64 * a                                 # [C, K, g, g]
        r = torch.exp(log_hwe[:, :, loci, :g])               # [C, K, Lc, g]
        sol, _ = torch.linalg.solve_ex(
            mats, r.to(torch.float64).transpose(2, 3), check_errors=False)
        p = (1.0 - s)[:, :, None, None] * sol.transpose(2, 3).to(
            torch.float32)
        out[:, :, loci, :g] = _slog(p)
    return out


def class_table(tables, spec, freq, freq2, rates):
    """The selfing-equilibrium log class table f32[C, K, L, G] of (P, P2,
    S)."""
    return selfing_equilibrium(tables, log_hwe_table(tables, spec, freq,
                                                     freq2), rates)


def site_indv_loglik(tables: TetraTables, spec: ModelSpec, data: Dataset,
                     freq, freq2, z, geno, table) -> torch.Tensor:
    """Per-individual conditional log-lik f32[C, N] (cal_lkd summed over
    loci): the ``site_ll_pass`` kernel (K7)."""
    return tg.site_ll_pass(table, tables.lookup_l, tables.log_mult_l, freq,
                           freq2, z, geno, data.site_valid,
                           autopoly=bool(spec.autopoly),
                           classes=tables.class_map)


# ---------------------------------------------------------------------------
# P, Z and Q on the diploid views
# ---------------------------------------------------------------------------

def sys_view(x: torch.Tensor) -> torch.Tensor:
    """[..., 4L] copy-major -> the slots in the order (0, 2, 1, 3): as a
    diploid [..., 2(2L)] panel, loci l' < L then carry the system-1 slots and
    l' >= L the system-2 slots (allo).  The reorder is its own inverse."""
    s0, s1, s2, s3 = x.chunk(4, dim=-1)
    return torch.cat([s0, s2, s1, s3], dim=-1)


def diploid_view(spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """The [..., 4L] copy-major tensor as the diploid view's [..., 2(2L)]
    (see the module docstring)."""
    return x if spec.autopoly else sys_view(x)


def p_counts(spec: ModelSpec, data: Dataset, z, geno):
    """Allele-pop counts f32[C, K, L, A] of the latent genotype: of all four
    slots (auto), or (system 1, system 2) of slots 0-1 and 2-3 (allo) -- one
    ``allele_counts`` launch over the diploid view."""
    l = data.n_loci
    cnt = fs.allele_counts(diploid_view(spec, z), diploid_view(spec, geno),
                           data.site_valid.repeat(1, 2), n_pops=spec.n_pops,
                           max_alleles=data.max_alleles)     # [C, K, 2L, A]
    if spec.autopoly:
        return cnt[:, :, :l] + cnt[:, :, l:], None
    return cnt[:, :, :l].contiguous(), cnt[:, :, l:].contiguous()


def update_p(keys, step: int, spec: ModelSpec, data: Dataset, z, geno,
             test_draws=None, test_draws2=None):
    """P | (z, geno) ~ Dirichlet(counts + 1) per (chain, pop, locus), and
    for allo the second system's freq2 likewise from slots 2-3
    (update_P_auto/allo, poly_geno.c:390-517).  Returns (freq, freq2 or
    None).  Both sweeps run it: the counts are exact either way, and the
    port's P draw is always the Dirichlet kernel."""
    c1, c2 = p_counts(spec, data, z, geno)
    keys = px.site_keys(keys)
    f = dk.dirichlet_kla(keys, step, c1 + 1.0, data.allele_valid,
                         test_draws=test_draws)
    if spec.autopoly:
        return f, None
    return f, dk.dirichlet_kla(keys, step, c2 + 1.0, data.allele_valid,
                               test_draws=test_draws2, stream=px.STREAM_P2)


def freq_2l(spec, freq, freq2):
    """[C, K, 2L, A]: the frequencies of the diploid view's loci."""
    return torch.cat([freq, freq if spec.autopoly else freq2], dim=2)


def view_dataset(spec: ModelSpec, data: Dataset, geno) -> Dataset:
    """The diploid view of the latent genotype geno i8[C, N, 4L] as a panel
    of 2L loci with one geno plane per chain; on a biallelic panel with the
    packed plane of the site pass's affine path."""
    gv = diploid_view(spec, geno)
    l2 = 2 * data.n_loci
    v2 = data.site_valid.repeat(1, 2)
    bits2 = None
    if data.max_alleles == 2:
        bits2 = (gv[..., :l2] | (gv[..., l2:] << 1)
                 | (v2.to(torch.int8) << 2)).to(torch.int8)
    return Dataset(geno=gv, site_valid=v2,
                   allele_valid=data.allele_valid.repeat(2, 1),
                   hom=torch.zeros_like(v2), bits2=bits2)


def update_zq(keys, step: int, spec: ModelSpec, data: Dataset, freq, freq2,
              q, alpha, geno, fused: bool, u=None, q_draws=None, mesh=None):
    """Per-copy Z Gibbs z ~ Cat(q_k f_sys[k, l, a]) with the system-correct
    frequency per slot (update_ZQ, poly_geno.c:750-836), then Q | Z ~
    Dirichlet(qqnum + alpha).  Fused: the site pass's ``zq_sample_pass``
    (K1) on the diploid view; unfused: ``zq_sample_counts`` (K8) -- ploidy 4
    over the panel (auto), ploidy 2 over the view (allo).  ``u`` f32[C, N,
    4L] (copy-major) and ``q_draws`` inject the uniforms.  z draws from
    the site keys; the counts are summed over the loci shards of ``mesh``
    before the Q draw.  Returns (z i8[C, N, 4L], q f32[C, N, K])."""
    uv = None if u is None else diploid_view(spec, u).contiguous()
    kz = px.site_keys(keys)
    if fused:
        z, qqnum, _ = fs.zq_sample_pass(kz, step, q,
                                        freq_2l(spec, freq, freq2),
                                        view_dataset(spec, data, geno), u=uv)
        z = diploid_view(spec, z)
    elif spec.autopoly:
        z, qqnum = zq_sample_counts(kz, step, q, freq, geno,
                                    data.site_valid, n_pops=spec.n_pops, u=u)
    else:
        z, qqnum = zq_sample_counts(kz, step, q,
                                    freq_2l(spec, freq, freq2),
                                    sys_view(geno),
                                    data.site_valid.repeat(1, 2),
                                    n_pops=spec.n_pops, u=uv)
        z = sys_view(z)
    q_new = dk.dirichlet_nk(keys, step,
                            up.psum(qqnum, mesh) + alpha[:, None, None],
                            test_draws=q_draws)
    return z, q_new


# ---------------------------------------------------------------------------
# the latent-genotype move
# ---------------------------------------------------------------------------

def reconstruct_geno(tables: TetraTables, choice) -> torch.Tensor:
    """Chosen candidate i8[C, N, L] -> ordered genotype i8[C, N, 4L]: the
    chosen candidate's selectors, then the distinct alleles they pick."""
    c = choice.shape[0]
    n_cand, n, l = tables.cand_sel.shape
    idx = choice.to(torch.int64)[:, None]
    sel = torch.gather(tables.cand_sel[None].expand(c, n_cand, n, l), 1,
                       idx).to(torch.int64)                 # [C, 1, N, L]
    dist4 = torch.stack(tg.split4(tables.dist8))[None].expand(c, 4, n, l)
    slots = [torch.gather(dist4, 1, (sel >> (2 * m)) & 3)[:, 0]
             for m in range(4)]
    return torch.cat(slots, dim=-1).to(torch.int8)


def sample_geno(keys, step: int, tables: TetraTables, spec: ModelSpec, freq,
                freq2, q, table, z, gumbel=None):
    """Gibbs update of the latent ordered genotype of every site
    (update_geno, poly_geno.c:520-580 + choose_*, 854-1215): the weights of
    the candidate orderings and a Gumbel-argmax, by the ``geno_choice_pass``
    kernel (K5); then the reconstruction."""
    choice = tg.geno_choice_pass(
        px.site_keys(keys), step, table, z, tables.dist8, tables.cand_nc, q, freq,
        freq if spec.autopoly else freq2, tables.cand_sel, tables.cand_cls,
        tables.cand_mult, autopoly=bool(spec.autopoly), gumbel=gumbel)
    return reconstruct_geno(tables, choice)


# ---------------------------------------------------------------------------
# initial state + the sweep
# ---------------------------------------------------------------------------

def init_tetra_state(seed: int, spec: ModelSpec, data: Dataset,
                     n_chains: int, init_rates=None, device="cuda",
                     chain_key=None, tables: Optional[TetraTables] = None,
                     mesh=None) -> McmcState:
    """Initial draw of ``n_chains`` chains (initial_geno,
    poly_geno.c:316-369): a uniform candidate ordering per site, z uniform,
    alpha ~ U[0, alpha_prior_max], Q | Z from the Dirichlet kernel, S from
    ``init_rates`` f32[C, K] or U(0, 1), flat freq and freq2.  Every draw is
    a function of Philox words at step ``INIT_STEP`` (see the module
    docstring), so the state is the same on the card and on the CPU.  On
    a loci-sharded ``mesh`` the orderings and z draw from the site keys and
    the Q counts are summed over the shards."""
    dev = torch.device(device)
    data = data.to(dev)
    if tables is None:
        tables = build_tables(spec, data)
    c = n_chains
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    k = spec.n_pops
    keys = px.make_keys(seed, c, dev, chain_key=chain_key,
                        shard=None if mesh is None else mesh.shard)
    step = px.INIT_STEP

    def unif(stream, count, k=keys):
        return px.u01_open(px.random_words(k, step, stream, count))

    kz = px.site_keys(keys)
    ncf = tables.cand_nc.to(torch.float32)
    choice = torch.minimum(torch.floor(unif(px.STREAM_GENO, n * l, kz)
                                       .reshape(c, n, l) * ncf), ncf - 1.0)
    geno = reconstruct_geno(tables, choice.to(torch.int8))
    z = torch.clamp(torch.floor(unif(px.STREAM_Z, n * 4 * l, kz)
                                .reshape(c, n, 4 * l) * k),
                    max=k - 1).to(torch.int8)
    alpha = unif(px.STREAM_ALPHA, 1)[:, 0] * spec.alpha_prior_max
    if init_rates is None:
        rates = unif(px.STREAM_R_PROP, k).contiguous()
    else:
        rates = torch.as_tensor(np.asarray(init_rates, np.float32),
                                device=dev).reshape(c, k)
    counts = up.psum(masked_z_counts(z, data, k), mesh)
    q = dk.dirichlet_nk(keys, step, counts + alpha[:, None, None])
    valid_f = data.allele_valid.to(torch.float32)
    freq = valid_f / torch.clamp_min(valid_f.sum(-1, keepdim=True), 1.0)
    freq = freq[None, None].expand(c, k, l, a).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    empty_i = torch.zeros((c, 0), dtype=torch.int32, device=dev)
    return McmcState(
        freq=freq, z=z, zz=empty_i, q=q, alpha=alpha, rates=rates,
        ais_state=_dt_stat(rates), gen=empty_i,
        loglik_indv=torch.zeros((c, n), **f32),
        loglik_total=torch.zeros((c,), **f32),
        dpm_values=torch.zeros((c, 0), **f32), dpm_counts=empty_i,
        dpm_assign=empty_i,
        prior_mu=torch.full((c,), spec.priors.normal_mu0, **f32),
        prior_sigma2=torch.full((c,), spec.priors.normal_sigmasqr0, **f32),
        freq2=freq.clone(), geno=geno,
        loglik_marg=torch.zeros((c, n), **f32))


def _draw(draws, name):
    return None if draws is None else getattr(draws, name)


def s_uniforms(keys, step: int, spec: ModelSpec, n_sweeps: int, draws):
    """(u_prop, u_acc, fresh or None) f32[C, J, K] of the S update: injected
    (``draws.s``) or one launch over the tail streams."""
    k = spec.n_pops
    adaptive = spec.back_refl != 1
    s = _draw(draws, "s")
    if s is not None:
        return s[0], s[1], (s[2] if adaptive else None)
    w = up.tail_uniforms(keys, step, 5 if adaptive else 2, n_sweeps * k)
    shape = (w.shape[0], n_sweeps, k)
    return (w[:, 0].reshape(shape), w[:, 1].reshape(shape),
            w[:, 4].reshape(shape) if adaptive else None)


def build_tetra_step(spec: ModelSpec, data: Dataset,
                     tables: Optional[TetraTables] = None, mesh=None):
    """(step_core, add_loglik) of one tetraploid sweep (the step body of
    mcmc_POP_tetra_selfing, poly_geno.c:98-136): P (+P2), the class tables,
    S, Z and Q, geno, alpha; the likelihood (cal_lkd, poly_geno.c:715) is
    split out so that ``run_mcmc`` evaluates it on stored steps only.  On a
    loci-sharded ``mesh`` (``data`` this rank's block) the Q counts, each
    subsweep's S log-ratio and the log-lik are summed over the shards."""
    if tables is None or tables.cand_sel is None:
        tables = build_tables(spec, data)
    fused = tetra_use_fused(spec, data)
    n_sweeps = max(1, spec.s_subsweeps)

    def add_loglik(state: McmcState) -> McmcState:
        table = class_table(tables, spec, state.freq, state.freq2,
                            state.rates)
        indv = up.psum(site_indv_loglik(tables, spec, data, state.freq,
                                        state.freq2, state.z, state.geno,
                                        table), mesh)
        return state._replace(loglik_indv=indv, loglik_total=indv.sum(dim=1))

    def s_update(state, keys, step_idx, draws, log_hwe):
        """Per-pop MH on S with the full-table rebuild; the accepted table
        is a per-pop select of the two solved ones (no third solve), and
        each subsweep's log-ratio is one ``s_delta_pass`` (K6) of the
        current and the proposed table."""
        u_prop, u_acc, fresh = s_uniforms(keys, step_idx, spec, n_sweeps,
                                          draws)
        rates, ais = state.rates, state.ais_state
        tab_cur = selfing_equilibrium(tables, log_hwe, rates)
        for j in range(n_sweeps):
            if spec.back_refl == 1:
                prop = up.propose_back_reflection(u_prop[:, j], rates,
                                                  spec.mh_step_s)
                prop_states, log_hast = ais, torch.zeros_like(rates)
            else:
                prop, prop_states, log_hast = \
                    up.propose_adaptive_independence(u_prop[:, j],
                                                     fresh[:, j], rates, ais)
            tab_prop = selfing_equilibrium(tables, log_hwe, prop)
            delta = tg.s_delta_pass(tab_cur, tab_prop, tables.lookup_l,
                                    state.z, state.geno, data.site_valid,
                                    tables.class_map)
            accept = torch.log(u_acc[:, j]) < up.psum(delta, mesh) + log_hast
            rates = torch.where(accept, prop, rates)
            ais = torch.where(accept, prop_states, ais)
            tab_cur = torch.where(accept[:, :, None, None], tab_prop, tab_cur)
        return rates, ais, tab_cur

    def step(state: McmcState, keys: px.RngKeys, step_idx: int,
             draws=None) -> McmcState:
        freq, freq2 = update_p(keys, step_idx, spec, data, state.z,
                               state.geno, _draw(draws, "p"),
                               _draw(draws, "p2"))
        if freq2 is None:
            freq2 = state.freq2
        log_hwe = log_hwe_table(tables, spec, freq, freq2)
        rates, ais, table = s_update(state, keys, step_idx, draws, log_hwe)
        z, q = update_zq(keys, step_idx, spec, data, freq, freq2, state.q,
                         state.alpha, state.geno, fused,
                         u=_draw(draws, "z"), q_draws=_draw(draws, "q"),
                         mesh=mesh)
        geno = sample_geno(keys, step_idx, tables, spec, freq, freq2, q,
                           table, z, gumbel=_draw(draws, "geno"))
        alpha = up.update_alpha(keys, step_idx, spec, q, state.alpha,
                                test_draws=_draw(draws, "alpha"))
        return state._replace(freq=freq, freq2=freq2, rates=rates,
                              ais_state=ais, z=z, q=q, geno=geno,
                              alpha=alpha)

    return step, add_loglik


def build_marg_loglik(spec: ModelSpec, data: Dataset,
                      tables: Optional[TetraTables] = None, mesh=None):
    """``add_marg(state)`` filling ``loglik_marg`` with the (z, geno)-
    conditional per-individual log-lik: no closed marginal over the latent
    ordering exists, so the focus of WAIC and the corrected DIC is the
    conditional pointwise likelihood (JAX step.py:504-520)."""
    if tables is None:
        tables = build_tables(spec, data, with_candidates=False)

    def add_marg(state: McmcState) -> McmcState:
        table = class_table(tables, spec, state.freq, state.freq2,
                            state.rates)
        return state._replace(loglik_marg=up.psum(site_indv_loglik(
            tables, spec, data, state.freq, state.freq2, state.z,
            state.geno, table), mesh))

    return add_marg


def plugin_loglik(spec: ModelSpec, data: Dataset, mean, final_state,
                  tables: Optional[TetraTables] = None) -> torch.Tensor:
    """Per-chain plug-in log-lik f32[C] under the (z, geno)-conditional
    focus: the site log-lik (K7) at the posterior means of (P, P2, S),
    conditional on the final draw's latent (z, geno), which have no
    posterior mean (JAX ``_plugin_tetra_loglik``)."""
    if tables is None:
        tables = build_tables(spec, data, with_candidates=False)
    freq = mean.freq
    freq2 = mean.freq2 if mean.freq2.numel() else freq
    table = class_table(tables, spec, freq, freq2, mean.rates)
    return site_indv_loglik(tables, spec, data, freq, freq2, final_state.z,
                            final_state.geno, table).sum(dim=1)
