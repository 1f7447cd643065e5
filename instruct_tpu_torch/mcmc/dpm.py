"""Dirichlet-process mixture prior over the individual selfing rates (mode
3) or inbreeding coefficients (mode 5), ``-f 1``.

Counterpart of ``instruct_tpu/mcmc/dpm.py``.  The reference's linked list
of clusters (DPMM.c:124-321) is a padded table of one slot per individual,
batched over chains:

  values  f32[C, N]  the S/F value of each slot
  counts  i32[C, N]  occupancy; 0 = free slot
  assign  i32[C, N]  the slot of each individual

Two samplers, as in the JAX package (``Priors.dp_truncation``):

* the exact collapsed-Gibbs CRP sweep (``dp_truncation == 0``): a
  sequential seating of the individuals, one kernel launch a sweep
  (``kernels/crp.py``).  What does not depend on the seating is drawn here
  for all individuals first: the new-table values (U(0, 1) for the prior
  draw, Beta(g_j, 2) through the Dirichlet kernel for mode 3, a
  Gumbel-argmax grid index for mode 5) and the new-table masses;
* the truncated stick-breaking sweep (``dp_truncation = T >= 2``),
  parallel over individuals, in plain tensor code: Beta sticks and mode-3
  values through the Dirichlet kernel (a Beta is a two-component
  Dirichlet), the categorical draws by Gumbel-argmax.

Mode 5's new-table mass and values come from each individual's
log-likelihood curve on a grid of ``GRID_M`` midpoints of F,
:func:`f_loglik_grid`: K*A masked ``[N, L] @ [L, M]`` products, in full
float32 (the JAX call asks ``Precision.HIGHEST``), one chain at a time.

Every draw takes injected numbers (``draws``; the tests feed the JAX
functions' own) or reads the Philox streams ``STREAM_DPM_SEAT``,
``STREAM_DPM_NEW``, ``STREAM_DPM_STICK`` and ``STREAM_DPM_THETA`` at the
sweep's step.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from instruct_tpu_torch.config import ModelSpec, PriorFamily
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import crp
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.model import likelihood as lk

_EPS = 1e-30
GRID_M = 128
# rows of the dense [N, L, M] grid curve evaluated at a time
_DENSE_ROWS = 64


class DpmTable(NamedTuple):
    values: torch.Tensor   # f32[C, N]
    counts: torch.Tensor   # i32[C, N]
    assign: torch.Tensor   # i32[C, N]


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


def uses_dpm(spec: ModelSpec) -> bool:
    """The DPM prior applies to the per-individual rates of the diploid
    modes 3 and 5; everywhere else it is ignored, as in the JAX package."""
    return (spec.priors.family == PriorFamily.DPM and spec.ploid == 2
            and spec.mode in (3, 5))


def check_truncation(t_max: int, n: int) -> None:
    """``dp_truncation``: 0 (the exact CRP sweep) or 2..N (JAX
    ``build_dpm_update``, ``instruct_tpu/mcmc/dpm.py:395-402``)."""
    if not 0 <= t_max <= n:
        raise ValueError(
            f"dp_truncation={t_max} out of range: must be 0 (exact CRP "
            f"sweep) or in [2, {n}] (= n_indv; the padded table has one "
            "slot per individual)")
    if t_max == 1:
        raise ValueError("dp_truncation=1 collapses the DP to a single "
                         "cluster; use 0 for the exact CRP sweep or T >= 2")


def grid_points(m: int, device) -> torch.Tensor:
    """The grid midpoints f32[M] (m + 0.5) / M."""
    return (torch.arange(m, dtype=torch.float32, device=device) + 0.5) / m


def _log_alpha(alpha: float, device) -> torch.Tensor:
    return _slog(torch.tensor(alpha, dtype=torch.float32, device=device))


def beta_draws(keys, step: int, stream: int, a, b) -> torch.Tensor:
    """Beta(a, b) f32[C, R] for a, b f32[C, R]: the first component of a
    two-component Dirichlet, one launch of the Dirichlet kernel
    (``kernels/dirichlet.py:dirichlet_rows``)."""
    conc = torch.stack([a, b], dim=1).contiguous()            # [C, 2, R]
    return dk.dirichlet_rows(keys, step, stream, conc,
                             rows_per_group=2)[:, 0].contiguous()


def gumbel_noise(keys, step: int, stream: int, shape) -> torch.Tensor:
    """f32[C, *shape] Gumbel noise: word i of ``stream``, row-major."""
    return px.gumbel(px.random_words(keys, step, stream, math.prod(shape))
                     ).reshape(-1, *shape)


# ---------------------------------------------------------------------------
# the exact CRP sweeps
# ---------------------------------------------------------------------------

def init_dpm(keys, step: int, alpha: float, n: int, draws=None) -> DpmTable:
    """The sequential CRP prior draw (init_DP, DPMM.c:124-161), every
    chain: individual j opens a new table with mass alpha, value U(0, 1),
    or joins table t with mass n_t.  ``draws`` = (seat noise f32[C, N,
    N + 1], new values f32[C, N]) injects the numbers."""
    dev = keys.chain_key.device
    c = keys.chain_key.shape[0]
    if draws is None:
        gumbel = None
        new_vals = px.u01_open(px.random_words(keys, step, px.STREAM_DPM_NEW,
                                               n))
    else:
        gumbel, new_vals = draws
    log_new = _log_alpha(alpha, dev).expand(c, n).contiguous()
    return DpmTable(*crp.crp_sweep(keys, step, crp.PRIOR, None, None, None,
                                   log_new, new_vals, gumbel=gumbel))


def crp_sweep_selfing(keys, step: int, table: DpmTable, gen, alpha: float,
                      draws=None) -> DpmTable:
    """One collapsed-Gibbs CRP sweep for mode 3 (update_DP + gen_post_prob,
    DPMM.c:165-199, 367-377): a table scores log n_t + log dgeom(v_t;
    g_j), a new table log alpha - log g - log(g + 1) (alpha B(g, 2)) and
    takes a Beta(g_j, 2) value.  ``draws`` = (seat noise f32[C, N, N + 1],
    new values f32[C, N])."""
    gf = gen.to(torch.float32)
    if draws is None:
        gumbel = None
        new_vals = beta_draws(keys, step, px.STREAM_DPM_NEW, gf,
                              torch.full_like(gf, 2.0))
    else:
        gumbel, new_vals = draws
    log_new = _log_alpha(alpha, gf.device) - _slog(gf) - _slog(gf + 1.0)
    return DpmTable(*crp.crp_sweep(keys, step, crp.SELFING, *table, log_new,
                                   new_vals, gen=gen, gumbel=gumbel))


def crp_sweep_inbreeding(keys, step: int, table: DpmTable, ll_grid,
                         alpha: float, draws=None) -> DpmTable:
    """One CRP sweep for mode 5 (gen_post_prob, DPMM.c:378-389) on the grid
    curves ``ll_grid`` f32[C, N, M]: a table scores log n_t + ll_j at its
    grid index, a new table log alpha + the midpoint integral of exp(ll_j)
    and takes a grid value drawn from exp(ll_j).  ``draws`` = (seat noise
    f32[C, N, N + 1], new grid indices i32[C, N])."""
    c, n, m = ll_grid.shape
    dev = ll_grid.device
    if draws is None:
        gumbel = None
        noise = gumbel_noise(keys, step, px.STREAM_DPM_NEW, (n, m))
        new_idx = torch.argmax(ll_grid + noise, dim=-1)
    else:
        gumbel, new_idx = draws
    new_idx = new_idx.to(torch.int32)
    log_m = torch.log(torch.tensor(float(m), device=dev))
    log_new = (_log_alpha(alpha, dev)
               + (torch.logsumexp(ll_grid, dim=-1) - log_m))
    new_vals = grid_points(m, dev)[new_idx.to(torch.int64)]
    return DpmTable(*crp.crp_sweep(keys, step, crp.INBREEDING, *table,
                                   log_new, new_vals, ll_grid=ll_grid,
                                   new_idx=new_idx, gumbel=gumbel))


# ---------------------------------------------------------------------------
# the mode-5 grid curve
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in full float32 (no TF32) inside the block,
    whatever the global setting: the JAX package computes them with
    ``Precision.HIGHEST``."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def hom_codes(data: Dataset, z0, hom_mask, a: int):
    """i16[N, L]: z0 * A + x0 at the hom same-z sites, -1 elsewhere -- the
    (pop, allele) cell whose one-hot mask a site falls in (16 bits: each
    mask reads 2 bytes a site)."""
    x0 = lk.split_copies(data.geno, data.ploid)[0].to(torch.int16)
    return torch.where(hom_mask, z0.to(torch.int16) * a + x0,
                       torch.full_like(x0, -1))


def masked_products(freq_c, code, table_fn, cols: int):
    """sum_{k,a} M_ka @ table_fn(freq[k, :, a]) f32[N, cols] for one
    chain: the 0/1 masks M_ka[n, l] = (code == k*A + a) built one at a time,
    each product in full float32."""
    k_pops, _, a_max = freq_c.shape
    out = torch.zeros((code.shape[0], cols), dtype=torch.float32,
                      device=code.device)
    with full_float32():
        for kk in range(k_pops):
            for aa in range(a_max):
                mask = (code == kk * a_max + aa).to(torch.float32)
                out = out + mask @ table_fn(freq_c[kk, :, aa][:, None])
    return out


def _f_grid_separable(data: Dataset, p0, p1, z0, z1):
    """The f-separable pieces of one chain's grid curve: (hom_mask,
    c_const f32[N], n_het f32[N]); het same-z sites contribute log(2 p0
    p1) + log(1 - f), hom same-z sites log p0 + log(p0 + f (1 - p0))."""
    valid = (z0 == z1) & data.site_valid
    hom = data.hom
    het_mask = valid & ~hom
    n_het = het_mask.sum(dim=1).to(torch.float32)
    zero = torch.zeros_like(p0)
    c_het = torch.where(het_mask, _slog(2.0 * p0 * p1), zero).sum(dim=1)
    hom_mask = valid & hom
    c_hom = torch.where(hom_mask, _slog(p0), zero).sum(dim=1)
    return hom_mask, c_hom + c_het, n_het


def _chain_sites(data: Dataset, freq, z, ci: int):
    """(p0, p1, z0, z1) f32 / i8 [N, L] of chain ``ci``."""
    pz = lk.gather_freq_at_z(freq[ci:ci + 1], data, z[ci:ci + 1])[0]
    p0, p1 = lk.split_copies(pz, data.ploid)
    z0, z1 = lk.split_copies(z[ci], data.ploid)
    return p0, p1, z0, z1


def f_loglik_grid(data: Dataset, freq, z, m: int = GRID_M) -> torch.Tensor:
    """ll f32[C, N, M]: each individual's F-log-likelihood at the grid
    midpoints (the curve func() integrates, DPMM.c:327-358).  The hom-site
    term is K*A masked products M_ka @ log(freq[k, :, a] + f_m (1 - freq))
    (``instruct_tpu/mcmc/dpm.py:184-220``), one chain at a time."""
    grid = grid_points(m, freq.device)
    a = freq.shape[3]
    out = []
    for ci in range(freq.shape[0]):
        p0, p1, z0, z1 = _chain_sites(data, freq, z, ci)
        hom_mask, c_const, n_het = _f_grid_separable(data, p0, p1, z0, z1)
        hom_term = masked_products(
            freq[ci], hom_codes(data, z0, hom_mask, a),
            lambda fk: _slog(fk + grid[None, :] * (1.0 - fk)), m)
        out.append(hom_term + c_const[:, None]
                   + n_het[:, None] * _slog(1.0 - grid)[None, :])
    return torch.stack(out)


def f_loglik_grid_dense(data: Dataset, freq, z, m: int = GRID_M
                        ) -> torch.Tensor:
    """The dense [N, L, M] form of :func:`f_loglik_grid` (the integrand
    func(), DPMM.c:327-358, transcribed), a few rows at a time: for the
    tests and the card's check only."""
    grid = grid_points(m, freq.device)
    out = []
    for ci in range(freq.shape[0]):
        p0, p1, z0, z1 = _chain_sites(data, freq, z, ci)
        hom_mask, c_const, n_het = _f_grid_separable(data, p0, p1, z0, z1)
        parts = []
        for r0 in range(0, p0.shape[0], _DENSE_ROWS):
            p = p0[r0:r0 + _DENSE_ROWS, :, None]
            inner = _slog(p + grid * (1.0 - p))
            parts.append((inner * hom_mask[r0:r0 + _DENSE_ROWS, :, None])
                         .sum(dim=1))
        out.append(torch.cat(parts) + c_const[:, None]
                   + n_het[:, None] * _slog(1.0 - grid)[None, :])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# the truncated stick-breaking sweeps
# ---------------------------------------------------------------------------

def _stick_log_weights(v, counts_t):
    """log w_t from the stick draws v_t ~ Beta(1 + n_t, alpha + tail_t)
    f32[C, T]; the last stick is 1."""
    v = v.clone()
    v[:, -1] = 1.0
    log1mv = _slog(1.0 - v)
    prefix = torch.cat([torch.zeros_like(v[:, :1]),
                        torch.cumsum(log1mv, dim=1)[:, :-1]], dim=1)
    return _slog(v) + prefix


def _stick_setup(keys, step, table: DpmTable, alpha: float, t_max: int,
                 v=None):
    """(assign clipped to the T components, counts_t f32[C, T], log w)."""
    assign = torch.clamp(table.assign, 0, t_max - 1).to(torch.int64)
    counts_t = _seat_counts(assign, t_max)
    tail = torch.flip(torch.cumsum(torch.flip(counts_t, [1]), dim=1),
                      [1]) - counts_t
    if v is None:
        v = beta_draws(keys, step, px.STREAM_DPM_STICK, 1.0 + counts_t,
                       alpha + tail)
    return assign, counts_t, _stick_log_weights(v, counts_t)


def _seat_counts(assign, t_max: int) -> torch.Tensor:
    """f32[C, T] individuals seated at each component."""
    return torch.zeros((assign.shape[0], t_max), dtype=torch.float32,
                       device=assign.device).scatter_add_(
        1, assign, torch.ones_like(assign, dtype=torch.float32))


def _reseat(keys, step, logits, seat_noise):
    """The parallel reseat assign ~ Cat(softmax(logits)) i32[C, N] by
    Gumbel-argmax."""
    if seat_noise is None:
        seat_noise = gumbel_noise(keys, step, px.STREAM_DPM_SEAT,
                                  tuple(logits.shape[1:]))
    return torch.argmax(logits + seat_noise, dim=-1).to(torch.int32)


def _stick_table(assign, theta, n: int) -> DpmTable:
    """The padded table of a stick-breaking sweep: the T components'
    values and counts in the leading slots."""
    c, t_max = theta.shape
    counts = _seat_counts(assign.to(torch.int64), t_max).to(torch.int32)
    values = torch.zeros((c, n), dtype=torch.float32, device=theta.device)
    counts_n = torch.zeros((c, n), dtype=torch.int32, device=theta.device)
    values[:, :t_max] = theta
    counts_n[:, :t_max] = counts
    return DpmTable(values, counts_n, assign)


def stick_sweep_selfing(keys, step: int, table: DpmTable, gen, alpha: float,
                        t_max: int, draws=None) -> DpmTable:
    """One blocked sweep for mode 3 under truncation T = ``t_max``
    (``instruct_tpu/mcmc/dpm.py:329``): sticks, then the components'
    conjugate values theta_t ~ Beta(1 + sum (g_j - 1), 1 + n_t), then the
    parallel reseat.  ``draws`` = (v f32[C, T], theta f32[C, T] (before the
    clip), seat noise f32[C, N, T])."""
    v, theta, seat = (None, None, None) if draws is None else draws
    assign, counts_t, logw = _stick_setup(keys, step, table, alpha, t_max, v)
    g1 = (gen - 1).to(torch.float32)
    sum_g1 = torch.zeros_like(counts_t).scatter_add_(1, assign, g1)
    if theta is None:
        theta = beta_draws(keys, step, px.STREAM_DPM_THETA, 1.0 + sum_g1,
                           1.0 + counts_t)
    theta = torch.clamp(theta, 1e-6, 1.0 - 1e-6)
    logits = (logw[:, None, :] + g1[:, :, None] * _slog(theta)[:, None, :]
              + _slog(1.0 - theta)[:, None, :])
    new_assign = _reseat(keys, step, logits, seat)
    return _stick_table(new_assign, theta, gen.shape[1])


def stick_sweep_inbreeding(keys, step: int, table: DpmTable, ll_grid,
                           alpha: float, t_max: int, draws=None) -> DpmTable:
    """One blocked sweep for mode 5 (``instruct_tpu/mcmc/dpm.py:357``): a
    component's posterior over the grid is the sum of its members' curves,
    its value a grid draw from it, then the parallel reseat.  ``draws`` =
    (v f32[C, T], theta noise f32[C, T, M], seat noise f32[C, N, T])."""
    c, n, m = ll_grid.shape
    v, theta_noise, seat = (None, None, None) if draws is None else draws
    assign, _, logw = _stick_setup(keys, step, table, alpha, t_max, v)
    table_ll = torch.zeros((c, t_max, m), dtype=torch.float32,
                           device=ll_grid.device)
    table_ll.scatter_add_(1, assign[:, :, None].expand(c, n, m), ll_grid)
    if theta_noise is None:
        theta_noise = gumbel_noise(keys, step, px.STREAM_DPM_THETA,
                                   (t_max, m))
    theta_idx = torch.argmax(table_ll + theta_noise, dim=-1)      # [C, T]
    theta = grid_points(m, ll_grid.device)[theta_idx]
    logits = logw[:, None, :] + torch.gather(
        ll_grid, 2, theta_idx[:, None, :].expand(c, n, t_max))
    new_assign = _reseat(keys, step, logits, seat)
    return _stick_table(new_assign, theta, n)


# ---------------------------------------------------------------------------
# the update of the sweep
# ---------------------------------------------------------------------------

def build_dpm_update(spec: ModelSpec, data: Dataset, mesh=None):
    """``dpm_update(state, keys, step, draws=None) -> state``: the DP sweep
    of modes 3/5 (mcmc.c:337-342, 423-428) -- the exact CRP sweep for
    ``dp_truncation == 0``, the stick-breaking sweep with T components
    otherwise -- after which each individual's rate is its table's value.
    Mode 5 evaluates the grid curves at the state's freq and z (summed
    over the loci shards of ``mesh``); every draw of the sweep is the same
    on every shard."""
    alpha = spec.priors.alpha_dpm
    t_max = spec.priors.dp_truncation
    check_truncation(t_max, data.n_indv)

    def dpm_update(state, keys, step: int, draws=None):
        table = DpmTable(state.dpm_values, state.dpm_counts,
                         state.dpm_assign)
        if spec.mode == 3:
            if t_max > 0:
                table = stick_sweep_selfing(keys, step, table, state.gen,
                                            alpha, t_max, draws)
            else:
                table = crp_sweep_selfing(keys, step, table, state.gen,
                                          alpha, draws)
        else:
            ll_grid = f_loglik_grid(data, state.freq, state.z)
            if mesh is not None:
                ll_grid = mesh.all_reduce_(ll_grid)
            if t_max > 0:
                table = stick_sweep_inbreeding(keys, step, table, ll_grid,
                                               alpha, t_max, draws)
            else:
                table = crp_sweep_inbreeding(keys, step, table, ll_grid,
                                             alpha, draws)
        rates = torch.gather(table.values, 1, table.assign.to(torch.int64))
        return state._replace(rates=rates, dpm_values=table.values,
                              dpm_counts=table.counts,
                              dpm_assign=table.assign)

    return dpm_update
