"""The sequential Chinese-restaurant-process seating sweep of the DPM prior
as one kernel.

Counterpart of the ``lax.scan`` bodies of ``instruct_tpu/mcmc/dpm.py``:
``init_dpm`` (:81, the prior draw), ``crp_sweep_selfing`` (:120, mode 3)
and ``crp_sweep_inbreeding`` (:238, mode 5).  Not a Pallas kernel there:
XLA runs the scan as one loop on the device, which eager PyTorch cannot
(10-15 tiny ops for each of the N individuals).  Per chain the sweep walks
the individuals j = 0 .. N-1 in order over a padded table of N slots
(``values``, ``counts``; ``assign`` the slot of each individual) and, for
each j:

  1. removes j from its table (not in the prior draw, which starts empty);
  2. scores the N + 1 choices -- choice 0 a new table at ``log_new[j]``,
     choice t >= 1 table t - 1 at ``log count`` plus the variant's term
     (none; :func:`geom_log_density` of (value, g_j); ``ll_j[vidx]``),
     ``_NEG`` for an empty table -- and adds Gumbel noise;
  3. takes the argmax, the first index winning ties (``jnp.argmax``);
  4. on a new table takes the first empty slot (``jnp.argmin(counts)``)
     and sets its value (``new_val[j]``; mode 5 also its grid index
     ``new_idx[j]``);
  5. seats j there.

The new tables' values and masses do not depend on the seating, so the
caller draws and computes them for all j before the sweep (as the JAX
functions do).  The Gumbel noise of choice t of individual j is element
``j * (N + 1) + t`` of the Philox stream ``STREAM_DPM_SEAT`` at the sweep's
step, drawn a few rows ahead of its use: there is no ``[N, N + 1]``
plane, so memory is O(N) at every N.  Only the plain version also takes
an injected plane ``gumbel[c, j, t]`` (the tests feed it the JAX
function's own).

On CUDA tensors :func:`crp_sweep` launches ``csrc/crp.cu`` (one block a
chain, one launch a sweep: a seater warp carries the N dependent steps,
slot s owned by lane s % 32, while producer warps draw the seat noise and
stage each individual's inputs ahead of it in a ring of ``RING_DEPTH``
entries; the plan is :func:`crp_plan`); on CPU tensors it runs the plain
version :func:`crp_sweep_reference`, which performs the same float32
operations, so the two seat every individual alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

PRIOR, SELFING, INBREEDING = 0, 1, 2
VARIANTS = {PRIOR: "prior", SELFING: "selfing", INBREEDING: "inbreeding"}
_EPS = 1e-30
_NEG = -1e30
# the kernel stages each individual's row of the mode-5 grid curve in its
# ring entry
MAX_GRID = 256
# the kernel keeps the table in shared memory up to this many slots (16
# bytes a slot), in a global scratch row above
SMEM_SLOTS = 8192
# the slots the seater warp keeps in registers (csrc/crp.cu:kRegSlots)
REG_SLOTS = 64
# the kernel's warps (csrc/crp.cu:CRP_WARPS): the seater and the producers
WARPS = 4
# entries of the noise ring, and the header words of an entry (kDepth,
# kHead)
RING_DEPTH = 8
HEAD = 8
# dynamic shared memory a block may take: 232 448 bytes less 1024 for what
# the kernel declares statically (kSmemBudget)
SMEM_BUDGET = 232_448 - 1024
# rows of Gumbel noise the plain version draws at a time
_NOISE_ROWS = 256


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


def geom_log_density(value, gen):
    """log dgeom(value; gen) = (gen-1) log value + log(1-value) (dgeom,
    mcmc.c:1596-1604), with the gen == 1 limit handled exactly: what a
    table of value ``value`` f32[C, N] scores for an individual of ``gen``
    i32[C, 1] in the selfing sweep (JAX ``dpm.py:113``)."""
    g1 = (gen - 1).to(torch.float32)
    return (torch.where(g1 > 0, g1 * _slog(value), torch.zeros_like(value))
            + _slog(1.0 - value))


def seat_noise(keys, step: int, n: int, j0: int, j1: int) -> torch.Tensor:
    """f32[C, j1 - j0, N + 1]: the Gumbel noise of the seat choices of
    individuals j0 .. j1-1, element ``j * (N + 1) + t`` of
    ``STREAM_DPM_SEAT``."""
    dev = keys.chain_key.device
    e = torch.arange(j0 * (n + 1), j1 * (n + 1), dtype=torch.int64,
                     device=dev)
    bits = px.element_words(keys, step, px.STREAM_DPM_SEAT, e)
    return px.gumbel(bits).reshape(-1, j1 - j0, n + 1)


def _up4(x: int) -> int:
    return (x + 3) & ~3


def crp_plan(n: int, m: int, variant: int) -> dict:
    """The seating kernel's launch plan (``csrc/crp.cu:make_plan``, which
    the card checks through ``crp_sweep_plan``): its warps, the ring's
    depth, its width (noise columns an entry holds: all N + 1 choices
    where shared memory holds them, else as many as it does, a multiple of
    4; the producers write the columns past it to a global spill [C,
    RING_DEPTH, N + 1 - width]), an entry's words (``HEAD``,
    mode 5's grid row, the noise), whether the table lies in shared memory
    (N <= ``SMEM_SLOTS``) and the dynamic shared-memory bytes: the table,
    the log counts ``logc[0..N]``, the ring."""
    table = 16 * n if n <= SMEM_SLOTS else 0
    logc = _up4(n + 1)
    ll = _up4(m) if variant == INBREEDING else 0
    free = (SMEM_BUDGET - table - 4 * logc) // (4 * RING_DEPTH) - HEAD - ll
    width = n + 1 if n + 1 <= free else free & ~3
    if width <= REG_SLOTS and width < n + 1:
        # the register slots' columns must lie in the ring
        raise ValueError(f"N = {n}: the seating kernel's log counts and "
                         "noise ring do not fit a block's shared memory")
    stride = HEAD + ll + _up4(width)
    return dict(warps=WARPS, depth=RING_DEPTH, reg_slots=REG_SLOTS,
                width=width, stride=stride, smem_table=table > 0,
                smem=table + 4 * logc + 4 * RING_DEPTH * stride)


def _check_variant(variant, gen, ll_grid, new_idx):
    if variant not in VARIANTS:
        raise ValueError(f"unknown CRP variant {variant}")
    if variant == SELFING and gen is None:
        raise ValueError("the selfing sweep needs gen")
    if variant == INBREEDING and (ll_grid is None or new_idx is None):
        raise ValueError("the inbreeding sweep needs ll_grid and new_idx")


def crp_sweep_reference(keys, step: int, variant: int, values, counts,
                        assign, log_new, new_val, *, gen=None, ll_grid=None,
                        new_idx=None, gumbel=None, margins=None,
                        occupied=None):
    """Plain PyTorch version of :func:`crp_sweep` (same signature).

    ``margins``, when a list, receives per individual the gap f32[C]
    between the best and the second-best noisy score (what tells a
    knife-edge flip from a wrong kernel); ``occupied``, when a list, the
    number of occupied tables i64[C] each individual was scored against
    (the work the data needs)."""
    _check_variant(variant, gen, ll_grid, new_idx)
    c, n = log_new.shape
    dev = log_new.device
    rows = torch.arange(c, device=dev)
    if variant == PRIOR:
        values = torch.zeros((c, n), dtype=torch.float32, device=dev)
        counts = torch.zeros((c, n), dtype=torch.int32, device=dev)
        assign = torch.zeros((c, n), dtype=torch.int32, device=dev)
    else:
        values, counts, assign = values.clone(), counts.clone(), \
            assign.clone()
    if variant == INBREEDING:
        m = ll_grid.shape[2]
        vidx = torch.clamp((values * m).to(torch.int32), 0, m - 1)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    noise = None
    for j in range(n):
        if gumbel is not None:
            row = gumbel[:, j]
        else:
            if j % _NOISE_ROWS == 0:
                noise = seat_noise(keys, step, n, j,
                                   min(n, j + _NOISE_ROWS))
            row = noise[:, j % _NOISE_ROWS]
        if variant != PRIOR:
            old = assign[:, j].to(torch.int64)
            counts[rows, old] -= 1
        live = counts > 0
        tab = _slog(counts.to(torch.float32))
        if variant == SELFING:
            tab = tab + geom_log_density(values, gen[:, j, None])
        elif variant == INBREEDING:
            tab = tab + torch.gather(ll_grid[:, j], 1, vidx.to(torch.int64))
        tab = torch.where(live, tab, neg)
        scores = torch.cat([log_new[:, j, None], tab], dim=1) + row
        if margins is not None:
            top = torch.topk(scores, min(2, n + 1), dim=1).values
            margins.append(top[:, 0] - top[:, -1])
        if occupied is not None:
            occupied.append(live.sum(dim=1))
        choice = torch.argmax(scores, dim=1)
        is_new = choice == 0
        free = torch.argmin(counts, dim=1)
        slot = torch.where(is_new, free, choice - 1)
        values[rows, slot] = torch.where(is_new, new_val[:, j],
                                         values[rows, slot])
        if variant == INBREEDING:
            vidx[rows, slot] = torch.where(is_new, new_idx[:, j],
                                           vidx[rows, slot])
        counts[rows, slot] += 1
        assign[:, j] = slot.to(torch.int32)
    return values, counts, assign


def crp_sweep(keys, step: int, variant: int, values: Optional[torch.Tensor],
              counts: Optional[torch.Tensor], assign: Optional[torch.Tensor],
              log_new: torch.Tensor, new_val: torch.Tensor, *,
              gen: Optional[torch.Tensor] = None,
              ll_grid: Optional[torch.Tensor] = None,
              new_idx: Optional[torch.Tensor] = None,
              gumbel: Optional[torch.Tensor] = None):
    """One sequential seating sweep of every chain.

    keys     RngKeys (seed + per-chain keys); step  the step index
    variant  PRIOR (the initial draw: the table starts empty; ``values``,
             ``counts``, ``assign`` may be None), SELFING or INBREEDING
    values   f32[C, N], counts i32[C, N], assign i32[C, N]  the table
    log_new  f32[C, N]  the new-table score of each individual
    new_val  f32[C, N]  the value a new table opened by j takes
    gen      i32[C, N]  selfing generations (SELFING)
    ll_grid  f32[C, N, M]  the grid curves (INBREEDING), M <= 256
    new_idx  i32[C, N]  the grid index of ``new_val`` (INBREEDING)
    gumbel   f32[C, N, N + 1]  injected seat noise (else Philox); CPU
             tensors only: the kernel draws its noise itself

    Returns the new (values, counts, assign)."""
    _check_variant(variant, gen, ll_grid, new_idx)
    if log_new.dim() != 2:
        raise ValueError("log_new must be [C, N]")
    c, n = log_new.shape
    if n * (n + 1) >= 1 << 34:
        raise ValueError(f"N = {n}: more than 2^32 Philox blocks of seat "
                         "noise in one sweep")
    if not log_new.is_cuda:
        return crp_sweep_reference(keys, step, variant, values, counts,
                                   assign, log_new, new_val, gen=gen,
                                   ll_grid=ll_grid, new_idx=new_idx,
                                   gumbel=gumbel)
    m = ll_grid.shape[2] if variant == INBREEDING else 0
    plan = crp_plan(n, m, variant)
    if gumbel is not None:
        raise ValueError("injected seat noise is taken by the plain version "
                         "only (CPU tensors)")
    chk = _build.check
    chk(log_new, "log_new", torch.float32, (c, n))
    chk(new_val, "new_val", torch.float32, (c, n))
    chk(keys.chain_key, "chain_key", torch.int32, (c,))
    if variant != PRIOR:
        chk(values, "values", torch.float32, (c, n))
        chk(counts, "counts", torch.int32, (c, n))
        chk(assign, "assign", torch.int32, (c, n))
    if variant == SELFING:
        chk(gen, "gen", torch.int32, (c, n))
    if variant == INBREEDING:
        if not 1 <= m <= MAX_GRID:
            raise ValueError(f"grid of {m} points: the kernel takes 1 to "
                             f"{MAX_GRID}")
        chk(ll_grid, "ll_grid", torch.float32, (c, n, m))
        chk(new_idx, "new_idx", torch.int32, (c, n))
    dev = log_new.device
    out_values = torch.empty((c, n), dtype=torch.float32, device=dev)
    out_counts = torch.empty((c, n), dtype=torch.int32, device=dev)
    out_assign = torch.empty((c, n), dtype=torch.int32, device=dev)
    # the working table, where it does not fit shared memory; the noise
    # columns past the ring
    scratch = (torch.empty((c, n, 4), dtype=torch.float32, device=dev)
               if n > SMEM_SLOTS else None)
    spill = (torch.empty((c, RING_DEPTH, n + 1 - plan["width"]),
                         dtype=torch.float32, device=dev)
             if plan["width"] <= n else None)
    p = _build.ptr
    _build.launch("crp_sweep", "crp_sweep_launch", p(values), p(counts),
                  p(assign), p(log_new), p(new_val), p(new_idx), p(gen),
                  p(ll_grid), p(out_values), p(out_counts),
                  p(out_assign), p(scratch), p(spill), c, n, m, variant,
                  keys.k0, keys.k1, p(keys.chain_key), step)
    return out_values, out_counts, out_assign


def warp_floor_reference(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_floor` (same signature)."""
    buf = (x.to(torch.int64) & 0xFFFFFFFF).reshape(-1, 32, 32).clone()
    c = buf.shape[0]
    rows = torch.arange(c, device=x.device)
    lanes = torch.arange(32, device=x.device)
    row = torch.zeros(c, dtype=torch.int64, device=x.device)
    for _ in range(n):
        v = buf[rows, row]
        m = v.max(dim=1).values
        win = torch.where(v == m[:, None], lanes, 32).min(dim=1).values
        buf[rows, row, win] = (v[rows, win] * 1664525 + 1013904223) \
            & 0xFFFFFFFF
        row = (m + win) & 31
    out = torch.cat([buf.reshape(c, 1024), row[:, None]], dim=1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def warp_floor(x: torch.Tensor, n: int) -> torch.Tensor:
    """The seating kernel's latency floor, a measurement aid: ``n``
    dependent steps of one warp a chain over x i32[C, 1024] (32 rows of
    32 words, word s of a row owned by lane s), each one shared-memory
    read of a row, the maximum and the least lane holding it by
    ``redux.sync``, and one shared-memory write (the winner's word, a
    linear congruential step); the next row is (maximum + lane) mod 32.
    Returns i32[C, 1025]: the words and the last row."""
    if x.dim() != 2 or x.shape[1] != 1024:
        raise ValueError("warp_floor takes x of shape [C, 1024]")
    if not x.is_cuda:
        return warp_floor_reference(x, n)
    _build.check(x, "x", torch.int32)
    out = torch.empty((x.shape[0], 1025), dtype=torch.int32,
                      device=x.device)
    _build.launch("crp_warp_floor", "crp_warp_floor_launch", _build.ptr(x),
                  _build.ptr(out), x.shape[0], n)
    return out
