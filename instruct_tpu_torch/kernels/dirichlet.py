"""Dirichlet sampler over count groups — the P and Q draws of the sweep.

Counterpart of ``instruct_tpu/kernels/dirichlet_pallas.py``
(``dirichlet_rows`` :110, ``dirichlet_kla`` :174).  Same function: Gamma
variates by Marsaglia-Tsang with a FIXED number of rejection rounds and a
Wilson-Hilferty fallback, Box-Muller normals, the ``Gamma(a+1) * U^(1/a)``
boost for a < 1, normalised within each group.  A loop-until-accept sampler
would be a different function of the uniforms and could not be held against
the JAX kernel with injected draws.

Chains are a written-out leading axis.  On CUDA tensors the wrappers launch
``csrc/dirichlet.cu`` with the plan :func:`dirichlet_plan` (a warp draws
one cell row of 32 columns, a group's cells in parallel over the warps of a
block, each Philox block of the draw computed once and shared through
shared memory, the group sums in cell order after a barrier; the kernel
indexes ``[C, K, L, A]`` and ``[C, N, K]`` directly through strides, no row
transposes); on CPU tensors they run the plain version below, which
performs the same float32 operations in the same order.

Uniform planes: ``n_test_draws(rounds)`` planes per cell, in the JAX
kernel's draw order (per round: two Box-Muller uniforms then the accept
uniform; then two for the fallback normal; then the boost).  Plane ``d`` of
the cell in row ``r``, column ``m`` is Philox word ``d*R*M + r*M + m`` of the
(chain, step, stream) counter space, or ``test_draws[c, d, r, m]`` when
uniforms are injected.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

_TINY = 1e-30
_TWO_PI = 2.0 * math.pi
_THIRD = 1.0 / 3.0


def n_test_draws(rounds: int = 3) -> int:
    """Uniform planes consumed per cell: 3 per Marsaglia-Tsang round (two
    for the Box-Muller normal, one accept), 2 for the fallback normal, 1 for
    the boost (``instruct_tpu/kernels/dirichlet_pallas.py:167``)."""
    return 3 * rounds + 3


def box_muller(u1, u2):
    """A standard normal from two uniforms in (0, 1)."""
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def gamma_cells(conc, valid, u, rounds: int = 3, margins=None):
    """Gamma(conc) variates by the fixed-round sampler, plain version on
    logical cells: ``conc`` f32[...], ``valid`` bool broadcastable or None
    (invalid cells draw 0), ``u`` f32[n_test_draws(rounds), ...] uniform
    planes.  ``margins``, when a list, receives one tensor: per cell the
    least distance of a rejection round's accept test from its threshold
    (what tells a knife-edge flip from a wrong kernel)."""
    if valid is None:
        a0 = conc
    else:
        a0 = torch.where(valid, conc, torch.ones_like(conc))
    small = a0 < 1.0
    a = a0 + small.to(torch.float32)
    d = a - _THIRD
    c = torch.rsqrt(9.0 * d)
    g = torch.zeros_like(a)
    acc = torch.zeros_like(a, dtype=torch.bool)
    for r in range(rounds):
        z = box_muller(u[3 * r], u[3 * r + 1])
        v1 = 1.0 + c * z
        v = v1 * v1 * v1
        logu = torch.log(u[3 * r + 2])
        rhs = (0.5 * z * z + d - d * v
               + d * torch.log(torch.clamp_min(v, _TINY)))
        ok = (v > 0.0) & (logu < rhs)
        if margins is not None:
            gap = torch.minimum(torch.abs(rhs - logu), torch.abs(v))
            margins.append(gap if r == 0
                           else torch.minimum(margins.pop(), gap))
        g = torch.where(ok & ~acc, d * v, g)
        acc = acc | ok
    zf = box_muller(u[3 * rounds], u[3 * rounds + 1])
    w1 = 1.0 - 1.0 / (9.0 * a) + zf * torch.rsqrt(9.0 * a)
    wh = a * w1 * w1 * w1
    g = torch.where(acc, g, torch.clamp_min(wh, _TINY))
    boost = g * torch.exp(torch.log(u[3 * rounds + 2])
                          / torch.clamp_min(a0, 1e-6))
    g = torch.where(small, boost, g)
    if valid is not None:
        g = torch.where(valid, g, torch.zeros_like(g))
    return g


def _gamma_normalised(conc, valid, u, rounds, group_dim, margins=None):
    """:func:`gamma_cells`, normalised over ``group_dim``."""
    g = gamma_cells(conc, valid, u, rounds, margins)
    tot = g.select(group_dim, 0)
    for j in range(1, g.shape[group_dim]):
        tot = tot + g.select(group_dim, j)
    return g / torch.clamp_min(tot, _TINY).unsqueeze(group_dim)


def _planes(keys, step, stream, n_chains, rounds, r, m, test_draws):
    """f32[nd, C, R, M] uniform planes, injected or from Philox."""
    nd = n_test_draws(rounds)
    if test_draws is not None:
        if tuple(test_draws.shape) != (n_chains, nd, r, m):
            raise ValueError(f"test_draws: expected {(n_chains, nd, r, m)}, "
                             f"got {tuple(test_draws.shape)}")
        return test_draws.to(torch.float32).transpose(0, 1)
    words = px.random_words(keys, step, stream, nd * r * m)
    return px.u01_open(words).reshape(n_chains, nd, r, m).transpose(0, 1)


def dirichlet_rows_reference(keys, step: int, stream: int, conc, valid=None,
                             *, rows_per_group: int, rounds: int = 3,
                             test_draws=None, margins=None):
    """Plain PyTorch version of :func:`dirichlet_rows` (same signature,
    plus ``margins``, see :func:`_gamma_normalised`)."""
    n_chains, r, m = conc.shape
    j = rows_per_group
    u = _planes(keys, step, stream, n_chains, rounds, r, m, test_draws)
    cells = conc.reshape(n_chains, r // j, j, m)
    v = None if valid is None else valid.reshape(1, r // j, j, m)
    u = u.reshape(-1, n_chains, r // j, j, m)
    if margins is not None:
        margins_in = []
        out = _gamma_normalised(cells, v, u, rounds, 2, margins_in)
        margins.extend(t.reshape(n_chains, r, m) for t in margins_in)
        return out.reshape(n_chains, r, m)
    return _gamma_normalised(cells, v, u, rounds, 2).reshape(n_chains, r, m)


def dirichlet_kla_reference(keys, step: int, counts_kla, allele_valid=None,
                            *, rounds: int = 3, test_draws=None,
                            stream: int = px.STREAM_P, margins=None):
    """Plain PyTorch version of :func:`dirichlet_kla` (same signature, plus
    ``margins``)."""
    n_chains, k, l, a = counts_kla.shape
    u = _planes(keys, step, stream, n_chains, rounds, k * a, l, test_draws)
    # rows layout [K*A, L] of the planes -> the [K, L, A] layout of counts
    u = u.reshape(-1, n_chains, k, a, l).transpose(3, 4)
    v = None if allele_valid is None else allele_valid[None, None]
    return _gamma_normalised(counts_kla, v, u, rounds, 3, margins)


# The kernel's launch shape (csrc/dirichlet.cu): a task is one cell row of
# 32 columns, a warp; a block holds up to 4 warps; a block may take the
# card's 227 KB of shared memory.
COLS, MAX_WARPS = 32, 4
SMEM_MAX = 232_448
# From this many tiles a warp draws all J cells of its tile (8 waves of
# 4-warp blocks, 8 an SM, on 132 SMs): the card is full without spreading.
SERIAL_TILES = 8 * 132 * 8 * 4


class DirichletPlan(NamedTuple):
    """Launch plan of one K3 call (``csrc/dirichlet.cu:plan``): ``jw`` warps
    share a tile's J cell rows (warp w draws rows w, w + jw, ...; one warp
    all of them from ``SERIAL_TILES`` tiles on), ``nt``
    tiles a block, ``slots`` Philox blocks staged a uniform plane of a task
    (8 when M % 4 == 0: a task's 32 words start a block; else 9),
    ``col_tiles`` 32-column tiles a (chain, group), ``blocks`` x
    ``threads`` the grid, ``dyn_smem`` the block's shared memory: the
    warps' staged blocks and the gammas of its tiles."""
    jw: int
    nt: int
    slots: int
    col_tiles: int
    blocks: int
    threads: int
    dyn_smem: int


def dirichlet_plan(c: int, g: int, j: int, m: int,
                   rounds: int = 3) -> DirichletPlan:
    """The launch plan of K3 for C = c chains of g groups of j cell rows
    over m columns.  Pure arithmetic, the same as the kernel's: the CPU
    tests check it for every J and alignment of M, the card checks its
    shared memory and threads against ``dirichlet_launch_plan``."""
    col_tiles = -(-m // COLS)
    per = -(-j // MAX_WARPS)                  # cell rows a warp
    jw = 1 if c * g * col_tiles >= SERIAL_TILES else -(-j // per)
    nt = 1 if jw > MAX_WARPS // 2 else MAX_WARPS // jw
    slots = 8 if m % 4 == 0 else 9
    smem = (jw * nt * n_test_draws(rounds) * slots * 16
            + nt * j * COLS * 4)
    return DirichletPlan(jw, nt, slots, col_tiles,
                         -(-(c * g * col_tiles) // nt), COLS * jw * nt, smem)


def philox_schedule(g: int, j: int, m: int, rounds: int = 3):
    """The kernel's Philox schedule for one chain, mirrored: which counter
    blocks each task (group, cell row, column tile) stages in which slot,
    and from which (slot, word) each cell takes each plane's uniform.

    Returns ``(staged, read)``: ``staged`` int64[tasks, nd * slots] the
    block staged in each slot (-1: none), ``read`` int64[nd, g * j * m]
    the index ``task * nd * slots * 4 + slot * 4 + word`` of the staged
    word that plane d of cell ``r * m + col`` reads."""
    plan = dirichlet_plan(1, g, j, m, rounds)
    nd, slots = n_test_draws(rounds), plan.slots
    plane = g * j * m
    tasks = g * j * plan.col_tiles
    staged = np.full((tasks, nd * slots), -1, np.int64)
    read = np.full((nd, plane), -1, np.int64)
    lane = np.arange(COLS)
    for t in range(tasks):
        r, mt = divmod(t, plan.col_tiles)      # r = group * j + cell row
        m0 = mt * COLS
        live = min(COLS, m - m0)
        cell0 = r * m + m0
        for d in range(nd):
            base = d * plane + cell0
            for k in range((((base & 3) + live - 1) >> 2) + 1):
                staged[t, d * slots + k] = (base >> 2) + k
            x = ((d * (plane & 3) + (cell0 & 3)) & 3) + lane[:live]
            read[d, cell0 + lane[:live]] = (
                t * nd * slots * 4 + (d * slots + (x >> 2)) * 4 + (x & 3))
    return staged, read


def _launch(name, conc, valid, test_draws, out, c, g, j, m, cstrides,
            vstrides, rounds, keys, step, stream):
    nd = n_test_draws(rounds)
    if nd * g * j * m >= 1 << 34:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    if not 0 <= rounds <= 16:
        raise ValueError(f"rounds must be in [0, 16], got {rounds}")
    plan = dirichlet_plan(c, g, j, m, rounds)
    if plan.dyn_smem > SMEM_MAX:
        raise ValueError(f"{j} cells a group: beyond the kernel's shared "
                         "memory")
    if c * g * plan.col_tiles >= 1 << 31:
        raise ValueError("more than 2^31 column tiles in one launch")
    draws = None
    if test_draws is not None:
        _build.check(test_draws, "test_draws", torch.float32,
                     (c, nd, g * j, m))
        draws = test_draws
    _build.check(keys.chain_key, "chain_key", torch.int32, (c,))
    _build.launch(name, "dirichlet_launch", _build.ptr(conc),
                  _build.ptr(valid), _build.ptr(draws), _build.ptr(out),
                  c, g, j, m, *cstrides, *vstrides, rounds, keys.k0, keys.k1,
                  _build.ptr(keys.chain_key), step, stream)


def dirichlet_rows(keys, step: int, stream: int, conc: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, *,
                   rows_per_group: int, rounds: int = 3, test_draws=None):
    """Dirichlet rows: normalise Gamma(conc) within each group of
    ``rows_per_group`` consecutive rows, per column and per chain.

    keys        RngKeys (seed + per-chain keys)
    step        step index of the counter
    stream      Philox stream id of this draw
    conc        f32[C, R, M]  concentrations, R = groups * rows_per_group
    valid       bool[R, M]    optional mask shared by the chains; invalid
                              cells draw weight 0
    test_draws  f32[C, n_test_draws(rounds), R, M] injected uniforms

    Returns f32[C, R, M]; every (chain, group, column) simplex sums to 1.
    """
    if conc.dim() != 3 or conc.shape[1] % rows_per_group:
        raise ValueError(f"conc {tuple(conc.shape)}: rows not divisible by "
                         f"group {rows_per_group}")
    if not conc.is_cuda:
        return dirichlet_rows_reference(
            keys, step, stream, conc, valid, rows_per_group=rows_per_group,
            rounds=rounds, test_draws=test_draws)
    c, r, m = conc.shape
    j = rows_per_group
    _build.check(conc, "conc", torch.float32)
    if valid is not None:
        _build.check(valid, "valid", torch.bool, (r, m))
    out = torch.empty_like(conc)
    _launch("dirichlet_rows", conc, valid, test_draws, out, c, r // j, j, m,
            (r * m, j * m, m, 1), (j * m, m, 1), rounds, keys, step, stream)
    return out


def dirichlet_kla(keys, step: int, counts_kla: torch.Tensor,
                  allele_valid: Optional[torch.Tensor] = None, *,
                  rounds: int = 3, test_draws=None,
                  stream: int = px.STREAM_P):
    """P update: counts f32[C, K, L, A] (prior already added), allele_valid
    bool[L, A] -> freq f32[C, K, L, A], one Dirichlet per (chain, pop,
    locus).  ``test_draws`` f32[C, n_test_draws, K*A, L] is in the JAX
    kernel's row layout (row = k*A + a).  ``stream``: the Philox stream id
    (the allotetraploid engine's second frequency system draws from
    ``STREAM_P2``)."""
    if counts_kla.dim() != 4:
        raise ValueError("counts_kla must be [C, K, L, A]")
    if not counts_kla.is_cuda:
        return dirichlet_kla_reference(keys, step, counts_kla, allele_valid,
                                       rounds=rounds, test_draws=test_draws,
                                       stream=stream)
    c, k, l, a = counts_kla.shape
    _build.check(counts_kla, "counts_kla", torch.float32)
    if allele_valid is not None:
        _build.check(allele_valid, "allele_valid", torch.bool, (l, a))
    out = torch.empty_like(counts_kla)
    _launch("dirichlet_kla", counts_kla, allele_valid, test_draws, out,
            c, k, a, l, (k * l * a, l * a, 1, a), (0, 1, a), rounds, keys,
            step, stream)
    return out


def dirichlet_nk_reference(keys, step: int, conc_nk, *, rounds: int = 3,
                           test_draws=None, margins=None):
    """Plain PyTorch version of :func:`dirichlet_nk` (same signature, plus
    ``margins``)."""
    n_chains, n, k = conc_nk.shape
    u = _planes(keys, step, px.STREAM_Q, n_chains, rounds, k, n, test_draws)
    return _gamma_normalised(conc_nk, None, u.transpose(2, 3), rounds, 2,
                             margins)


def dirichlet_nk(keys, step: int, conc_nk: torch.Tensor, *, rounds: int = 3,
                 test_draws=None):
    """Q update: conc f32[C, N, K] (counts + alpha) -> q f32[C, N, K], one
    Dirichlet per (chain, individual) — ``dirichlet_rows`` on the [K, N]
    rows of the JAX step's ``draw_q`` (``instruct_tpu/mcmc/step.py:163``)
    without the transposes.  ``test_draws`` f32[C, n_test_draws, K, N] is in
    that row layout."""
    if conc_nk.dim() != 3:
        raise ValueError("conc_nk must be [C, N, K]")
    if not conc_nk.is_cuda:
        return dirichlet_nk_reference(keys, step, conc_nk, rounds=rounds,
                                      test_draws=test_draws)
    c, n, k = conc_nk.shape
    _build.check(conc_nk, "conc_nk", torch.float32)
    out = torch.empty_like(conc_nk)
    _launch("dirichlet_nk", conc_nk, None, test_draws, out, c, 1, k, n,
            (n * k, 0, 1, k), (0, 0, 0), rounds, keys, step, px.STREAM_Q)
    return out
