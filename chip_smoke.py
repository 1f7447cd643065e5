#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``instruct_tpu_torch`` from
``instruct_tpu_torch/csrc`` with ``nvcc``, holds each kernel against its plain
PyTorch version on the card at the sampler's headline shapes (N = 1000
individuals x L = 10 000 loci, K = 3, 4 chains), then drives the main path --
``run_mcmc`` on the diploid mode-2 biallelic panel -- and checks that it went
through every kernel, that its output is sane and that two runs from one seed
are bitwise equal.  Every phase prints one JSON line; any failure raises, so
the exit code is non-zero.  There is no CPU path: without a CUDA device the
script exits with code 1 and prints no result.

The line before the last is the card's name and power limit as ``nvidia-smi``
prints them; the line before that is the ``{"kernels": [...]}`` summary; the
last line is ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset of build, kernels, main_path (development aid);
the device and Philox phases always run.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from instruct_tpu_torch import (ModelSpec, Schedule, run_mcmc,
                                synthetic_panel)
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import s_pop as sp
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import build_step_parts

# Headline shapes of the main path.
N_INDV, N_LOCI, N_POPS, N_CHAINS, SUBSWEEPS = 1000, 10_000, 3, 4, 12
PANEL_SEED, RUN_SEED = 17, 2024
N_ITER = 400           # sweeps of the main-path run (half of them burn-in)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the float32 rate outside the tensor cores.  The bound of a kernel is the
# larger of bytes / HBM_RATE and operations / FP32_RATE.
HBM_RATE = 3.35e12
FP32_RATE = 67e12

# Operation-count model (one multiply or add = 1, one multiply-add = 2):
OPS_PHILOX = 60        # 10 rounds x (2 wide multiplies + 4 xor/add)
OPS_TRANSC = 20        # one logf / expf / cosf / sqrtf / division


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3, inner: int = 10) -> float:
    """Device time of one ``fn()`` in ms: the median over ``reps`` samples,
    each a run of ``inner`` back-to-back launches between two CUDA events,
    after ``warm`` untimed launches.  For a kernel of a few microseconds
    this reads the host's enqueue rate, which is what an eager loop pays."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_RATE, n_ops / FP32_RATE
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(name, got, want, rtol, atol):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{name}: kernel and plain version disagree, max abs err "
            f"{max_err(got, want):.3e} (rtol {rtol}, atol {atol})")


# ---------------------------------------------------------------------------
# phases 1-3
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    emit("device", card=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    t0 = time.time()
    _build.library()
    seconds = time.time() - t0
    log = (_build.BUILD / "build.log")
    regs = {}
    if log.exists():
        src, prev = None, ""
        for line in log.read_text().splitlines():
            m = re.match(r"== (\S+) ", line)
            if m:
                src = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and src:
                spill = "0 bytes spill stores" not in prev
                r = regs.setdefault(src, {"max_registers": 0,
                                          "spills": False})
                r["max_registers"] = max(r["max_registers"],
                                         int(m.group(1)))
                r["spills"] = r["spills"] or spill
            prev = line
    emit("build", seconds=round(seconds, 2), nvcc=_build.find_nvcc(),
         flags=" ".join(_build.NVCC_FLAGS), ptxas=regs)


def phase_philox() -> dict:
    """The CUDA generator against the plain PyTorch one, bit for bit, on
    2^20 counters; and the entry of the ``random_words`` kernel at the
    shape the main path gives it (the alpha step's 3 words per chain)."""
    keys = px.make_keys(0x7F4A7C159E3779B9, N_CHAINS, "cuda",
                        chain_key=[0, 1, 0x7FFFFFFF, -5])
    n_blocks = (1 << 20) // N_CHAINS
    got = px.random_words(keys, 123456, px.STREAM_Z, 4 * n_blocks)
    want = px.random_words_reference(keys, 123456, px.STREAM_Z, 4 * n_blocks)
    if not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want):
        raise AssertionError("CUDA Philox4x32-10 differs from the plain "
                             "PyTorch generator")
    emit("philox", counters=n_blocks * N_CHAINS, words=4 * n_blocks * N_CHAINS,
         bit_equal=True)
    run = lambda: px.random_words(keys, 3, px.STREAM_ALPHA, 3)
    plain = lambda: px.random_words_reference(keys, 3, px.STREAM_ALPHA, 3)
    if not torch.equal(run().to(torch.int64) & 0xFFFFFFFF, plain()):
        raise AssertionError("random_words differs from its plain version")
    b_ms, b_by = bound(N_CHAINS * 16, N_CHAINS * OPS_PHILOX)
    return dict(name="philox_words", route="cuda",
                source="instruct_tpu_torch/csrc/philox_fill.cu",
                replaces="instruct_tpu/kernels/fused_step.py:40",
                max_abs_err=0.0, ms=time_ms(run),
                plain_ms=time_ms(plain, reps=5, warm=1, inner=1),
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                compared="words bit-equal")


# ---------------------------------------------------------------------------
# phase 4: each kernel against its plain version, at the main-path shapes
# ---------------------------------------------------------------------------

def kernel_inputs(panel):
    """State-like inputs at the headline shapes, from a seed."""
    data = panel.data.to("cuda")
    c, n, l, k = N_CHAINS, N_INDV, N_LOCI, N_POPS
    g = torch.Generator(device="cuda").manual_seed(99)
    gam = torch._standard_gamma(torch.full((c, k, l, 2), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((c, n, k), 0.3, device="cuda"),
                               generator=g).clamp_min(1e-20)
    q = (gq / gq.sum(-1, keepdim=True)).contiguous()
    z = torch.randint(0, k, (c, n, 2 * l), generator=g, device="cuda",
                      dtype=torch.int8)
    gen = torch.randint(1, 9, (c, n), generator=g, device="cuda",
                        dtype=torch.int32)
    gen_prop = torch.randint(1, 9, (c, n), generator=g, device="cuda",
                             dtype=torch.int32)
    rates = torch.rand((c, k), generator=g, device="cuda") * 0.9 + 0.05
    wg_pair = torch.exp2(1.0 - torch.stack([gen, gen_prop], -1).float())
    keys = px.make_keys(RUN_SEED, c, "cuda")
    return dict(data=data, freq=freq, q=q, z=z, gen=gen, rates=rates,
                wg_pair=wg_pair.contiguous(), keys=keys)


def check_allele_counts(x):
    d = x["data"]
    c, n, l, k = N_CHAINS, N_INDV, N_LOCI, N_POPS
    kw = dict(n_pops=k, max_alleles=2, bits2=d.bits2)
    run = lambda: fs.allele_counts(x["z"], d.geno, d.site_valid, **kw)
    plain = lambda: fs.allele_counts_reference(x["z"], d.geno, d.site_valid,
                                               **kw)
    got, want = run(), plain()
    if not torch.equal(got, want):
        raise AssertionError("allele_counts: counts differ from the plain "
                             f"version (max {max_err(got, want)})")
    unpacked = fs.allele_counts(x["z"], d.geno, d.site_valid, n_pops=k,
                                max_alleles=2)
    if not torch.equal(unpacked, want):
        raise AssertionError("allele_counts (geno + site_valid operands) "
                             "differs from the plain version")
    valid2 = 2.0 * float(d.site_valid.sum())
    for ch in range(c):
        if float(got[ch].sum()) != valid2:
            raise AssertionError("allele_counts: total != 2 * valid sites")
    n_bytes = c * n * 2 * l + n * l + c * k * l * 2 * 4
    n_ops = c * n * 2 * l * 4
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name="allele_counts", route="cuda",
                source="instruct_tpu_torch/csrc/allele_counts.cu",
                replaces="instruct_tpu/kernels/fused_step.py:87",
                max_abs_err=max_err(got, want), ms=time_ms(run),
                plain_ms=time_ms(plain, reps=5, warm=1, inner=1),
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bytes=n_bytes, ops=n_ops,
                compared="counts exactly equal")


def check_site_gendiff(x, structure: bool):
    d = x["data"]
    c, n, l, k = N_CHAINS, N_INDV, N_LOCI, N_POPS
    args = (x["keys"], 5, x["q"], x["freq"], d.bits2, x["wg_pair"])
    run = lambda: fs.zq_gendiff_pass(*args, structure=structure)
    plain = lambda: fs.zq_gendiff_pass_reference(*args, structure=structure)
    z, qq, ll, zc = run()
    pz, pqq, pll, pzc = plain()
    for nm, a, b in (("z", z, pz), ("qqnum", qq, pqq), ("zcounts", zc, pzc)):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(
                f"site_pass_gendiff(structure={structure}): {nm} differs "
                f"from the plain version at {bad} elements")
    # ll_diff: f32 sums over L = 10 000 sites taken in another order
    check_close(f"site_pass_gendiff(structure={structure}) ll_diff", ll, pll,
                rtol=1e-4, atol=2e-3)
    valid2 = 2.0 * float(d.site_valid.sum())
    for ch in range(c):
        if not (float(zc[ch].sum()) == float(qq[ch].sum()) == valid2):
            raise AssertionError("site_pass_gendiff: zcounts.sum() == "
                                 "qqnum.sum() == 2 * valid sites violated")
    z2 = run()
    if not all(torch.equal(a, b) for a, b in zip((z, qq, ll, zc), z2)):
        raise AssertionError("site_pass_gendiff: two launches from one seed "
                             "are not bitwise equal")
    # injected uniforms are honoured by the kernel too
    u = torch.rand((c, n, 2 * l), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(3))
    zi = fs.zq_gendiff_pass(*args, structure=structure, u=u)
    zp = fs.zq_gendiff_pass_reference(*args, structure=structure, u=u)
    if not torch.equal(zi[0], zp[0]):
        raise AssertionError("site_pass_gendiff: z differs under injected "
                             "uniforms")
    g0, g1, valid, hom = fs.unpack_bits2(d.bits2)
    same = (z[:, :, :l] == z[:, :, l:]) if structure else True
    n_logs = int((valid[None] & hom[None] & same).sum())
    n_bytes = (c * n * k * 4 + c * k * l * 2 * 4 + n * l + c * n * 2 * 4
               + c * n * 2 * l + c * n * k * 4 + c * k * l * 2 * 4
               + c * n * 4)
    per_site = 4 * k + 2 * (OPS_PHILOX / 4 + 3 + 3 * (k - 1) + 3 * k)
    n_ops = c * n * l * per_site + n_logs * (2 * OPS_TRANSC + 6)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name="site_pass_gendiff", route="cuda",
                source="instruct_tpu_torch/csrc/site_pass.cu",
                replaces="instruct_tpu/kernels/fused_step.py:612",
                structure=structure, max_abs_err=max_err(ll, pll),
                ms=time_ms(run),
                plain_ms=time_ms(plain, reps=3, warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bytes=n_bytes, ops=n_ops,
                compared="z, qqnum, zcounts exactly equal; ll_diff rtol "
                         "1e-4 atol 2e-3")


def check_site_loglik(x, structure: bool):
    d = x["data"]
    c, n, l, k = N_CHAINS, N_INDV, N_LOCI, N_POPS
    wg = x["wg_pair"][:, :, 0].contiguous()
    args = (x["freq"], x["q"], d.bits2, x["z"], wg)
    run = lambda: fs.panel_loglik_pass(*args, structure=structure)
    plain = lambda: fs.panel_loglik_pass_reference(*args,
                                                   structure=structure)
    got, want = run(), plain()
    # sums of ~10 000 logs of magnitude ~1: |ll| ~ 1e4, f32 in another order
    check_close(f"site_pass_loglik(structure={structure})", got, want,
                rtol=1e-5, atol=1e-2)
    if not torch.equal(got, run()):
        raise AssertionError("site_pass_loglik: two launches are not "
                             "bitwise equal")
    n_valid = int(d.site_valid.sum())
    n_bytes = (c * n * k * 4 + c * k * l * 2 * 4 + n * l + c * n * 2 * l
               + c * n * 4 + c * n * 4)
    n_ops = c * n_valid * (4 * k + 12 + OPS_TRANSC)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name="site_pass_loglik", route="cuda",
                source="instruct_tpu_torch/csrc/site_pass.cu",
                replaces="instruct_tpu/kernels/fused_step.py:612",
                structure=structure, max_abs_err=max_err(got, want),
                ms=time_ms(run),
                plain_ms=time_ms(plain, reps=3, warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bytes=n_bytes, ops=n_ops,
                compared="ll_indv rtol 1e-5 atol 1e-2")


def s_pop_agrees(name, got, want, margins) -> list:
    """Raise unless the S tail's outputs match the plain version: rates' and
    gen_prop exactly, wg_pair and logu at rtol 1e-6.  The accepts and the
    geometric draw's floor are knife-edge tests on floats, so a mismatch is
    accepted only where the plain version's own margin at that decision is
    within f32 rounding of the compared quantities (the target |f| ~ 1e3 ->
    2e-3; the log quotient -> 1e-4).  Returns notes on any such edge."""
    (rates, gprop, wg, logu), (prates, pgprop, pwg, plogu) = got, want
    if not torch.equal(rates, prates):
        accept_margin = torch.stack(margins[:-1]).abs().min(dim=0).values
        bad = (rates != prates).any(dim=1)
        if bool((accept_margin[bad] > 2e-3).any()):
            raise AssertionError(
                f"{name}: rates differ from the plain version away from a "
                f"knife-edge (margins {accept_margin.tolist()})")
        # the later outputs of such a chain follow from other rates
        return [f"rates differ in {int(bad.sum())} chain(s) at an accept "
                "knife-edge"]
    notes = []
    flipped = gprop != pgprop
    if bool(flipped.any()):
        if bool((margins[-1][flipped] > 1e-4).any()):
            raise AssertionError(f"{name}: gen_prop differs from the plain "
                                 "version away from a knife-edge")
        notes.append(f"gen_prop differs at {int(flipped.sum())} floor "
                     "knife-edge(s)")
    check_close(f"{name} wg_pair", wg[~flipped], pwg[~flipped], 1e-6, 0)
    check_close(f"{name} logu", logu, plogu, 1e-6, 1e-7)
    return notes


def check_s_pop_tail(x):
    c, n, k, j = N_CHAINS, N_INDV, N_POPS, SUBSWEEPS
    kw = dict(subsweeps=j, delta0=0.05, gen_cap=50)
    args = (x["keys"], 7, x["q"], x["gen"], x["rates"])
    run = lambda: sp.s_pop_tail(*args, **kw)
    plain = lambda: sp.s_pop_tail_reference(*args, **kw)
    got = run()
    margins = []
    want = sp.s_pop_tail_reference(*args, **kw, margins=margins)
    notes = s_pop_agrees("s_pop_tail", got, want, margins)
    if not all(torch.equal(a, b) for a, b in zip(got, run())):
        raise AssertionError("s_pop_tail: two launches from one seed are "
                             "not bitwise equal")
    # injected uniforms are honoured by the kernel too
    g = torch.Generator("cuda").manual_seed(4)
    inj = tuple(torch.rand((c, m), generator=g, device="cuda") * (1 - 2e-4)
                + 1e-4 for m in (j * k, j * k, n, n))
    margins = []
    notes += s_pop_agrees(
        "s_pop_tail under injected uniforms",
        sp.s_pop_tail(*args, **kw, test_draws=inj),
        sp.s_pop_tail_reference(*args, **kw, test_draws=inj,
                                margins=margins), margins)
    rates, prates = got[0], want[0]
    n_bytes = c * n * (k * 4 + 4) + c * k * 8 + c * n * (4 + 8 + 4)
    n_ops = c * (j * k + 1) * n * (2 * OPS_TRANSC + 8) + c * n * (
        3 * OPS_TRANSC + 2 * OPS_PHILOX)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name="s_pop_tail", route="cuda",
                source="instruct_tpu_torch/csrc/s_pop.cu",
                replaces="instruct_tpu/kernels/s_pop_pallas.py:115",
                max_abs_err=max_err(rates, prates), ms=time_ms(run),
                plain_ms=time_ms(plain, reps=5, warm=1, inner=1),
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bytes=n_bytes, ops=n_ops,
                notes=notes,
                compared="rates', gen_prop exactly equal (or shown to sit "
                         "on a knife-edge); wg_pair, logu rtol 1e-6")


def dirichlet_agrees(name, got, want, margin, group_dim) -> int:
    """Raise unless every Dirichlet cell matches the plain version at rtol
    1e-4, atol 1e-6, apart from groups in which a rejection round's accept
    test sits within f32 rounding (1e-4) of its threshold: a flipped accept
    changes that cell's gamma and, through the normalisation, its group.
    Returns the number of such knife-edge cells."""
    off = ~torch.isclose(got, want, rtol=1e-4, atol=1e-6)
    if bool(off.any()):
        knife = (margin < 1e-4).any(dim=group_dim, keepdim=True)
        if bool((off & ~knife).any()):
            raise AssertionError(
                f"{name}: {int((off & ~knife).sum())} cells differ from "
                "the plain version away from a knife-edge")
    return int(off.sum())


def _check_dirichlet(name, run, plain_with_margins, conc_numel, valid_numel):
    got = run()
    margins = []
    want = plain_with_margins(margins)
    n_off = dirichlet_agrees(name, got, want, margins[0], -1)
    sums = got.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise AssertionError(f"{name}: groups do not sum to 1")
    if not torch.equal(got, run()):
        raise AssertionError(f"{name}: two launches from one seed are not "
                             "bitwise equal")
    n_bytes = conc_numel * 8 + valid_numel
    n_ops = conc_numel * (dk.n_test_draws() * OPS_PHILOX + 16 * OPS_TRANSC
                          + 40)
    b_ms, b_by = bound(n_bytes, n_ops)
    keep = torch.isclose(got, want, rtol=1e-4, atol=1e-6)
    return dict(name=name, route="cuda",
                source="instruct_tpu_torch/csrc/dirichlet.cu",
                replaces="instruct_tpu/kernels/dirichlet_pallas.py:110",
                max_abs_err=max_err(got[keep], want[keep]),
                knife_edge_cells=n_off, ms=time_ms(run),
                plain_ms=time_ms(lambda: plain_with_margins(None), reps=5,
                                 warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bytes=n_bytes, ops=n_ops,
                compared="rtol 1e-4 atol 1e-6 on every cell not on an "
                         "accept knife-edge")


def check_dirichlet(x):
    d = x["data"]
    c, n, l, k = N_CHAINS, N_INDV, N_LOCI, N_POPS
    keys = x["keys"]
    g = torch.Generator("cuda").manual_seed(5)
    counts = torch.randint(0, 400, (c, k, l, 2), generator=g,
                           device="cuda").float() + 1.0
    out = [_check_dirichlet(
        "dirichlet_kla",
        lambda: dk.dirichlet_kla(keys, 9, counts, d.allele_valid),
        lambda m: dk.dirichlet_kla_reference(keys, 9, counts, d.allele_valid,
                                             margins=m),
        counts.numel(), d.allele_valid.numel())]
    # Q shape: counts + alpha with alpha < 1, many cells with conc < 1
    conc = (torch.randint(0, 3, (c, n, k), generator=g, device="cuda")
            .float() * torch.randint(0, 2, (c, n, k), generator=g,
                                     device="cuda").float() * 3000.0 + 0.08)
    out.append(_check_dirichlet(
        "dirichlet_nk",
        lambda: dk.dirichlet_nk(keys, 9, conc),
        lambda m: dk.dirichlet_nk_reference(keys, 9, conc, margins=m),
        conc.numel(), 0))
    # the generic row-layout wrapper, with a mask and injected uniforms
    groups, per, m = 3, 2, 777
    rows = (torch.rand((c, groups * per, m), generator=g, device="cuda")
            * 30.0 + 0.2)
    valid = torch.rand((groups * per, m), generator=g, device="cuda") > 0.1
    draws = (torch.rand((c, dk.n_test_draws(), groups * per, m), generator=g,
                        device="cuda") * (1 - 2e-4) + 1e-4)
    kw = dict(rows_per_group=per, test_draws=draws)
    got = dk.dirichlet_rows(keys, 1, px.STREAM_P, rows, valid, **kw)
    margins = []
    want = dk.dirichlet_rows_reference(keys, 1, px.STREAM_P, rows, valid,
                                       margins=margins, **kw)
    shape = (c, groups, per, m)
    dirichlet_agrees("dirichlet_rows", got.reshape(shape),
                     want.reshape(shape), margins[0].reshape(shape), 2)
    if bool((got[:, ~valid] != 0).any()):
        raise AssertionError("dirichlet_rows: masked cells are not zero")
    return out


def phase_edge_shapes() -> None:
    """Kernel against plain version at small ragged shapes: every
    instantiated K of the site pass, L not a multiple of 4 (unaligned
    Philox quads, byte loads), N not a multiple of the row strip, N above
    and below the S tail's 1024 lanes, and the unpacked A = 3 operands of
    ``allele_counts``."""
    g = torch.Generator("cuda").manual_seed(12)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def simplex(*shape):
        x = -torch.log(rand(*shape).clamp_min(1e-6))
        return (x / x.sum(-1, keepdim=True)).contiguous()

    cases = [(1, 5, 7, 1), (2, 33, 1025, 2), (3, 70, 130, 3), (2, 45, 1030, 4),
             (1, 1100, 36, 5), (2, 40, 37, 6), (1, 64, 250, 7),
             (2, 1500, 9, 8)]
    for c, n, l, k in cases:
        tag = f"edge shape C={c} N={n} L={l} K={k}"
        keys = px.make_keys(77, c, "cuda", chain_key=range(3, 3 + c))
        bits2 = torch.randint(0, 8, (n, l), generator=g, device="cuda",
                              dtype=torch.int8)
        q, freq = simplex(c, n, k), simplex(c, k, l, 2)
        gen = torch.randint(1, 9, (c, n, 2), generator=g, device="cuda")
        wg_pair = torch.exp2(1.0 - gen.float()).contiguous()
        rates = (rand(c, k) * 0.9 + 0.05).contiguous()
        for structure in (True, False):
            got = fs.zq_gendiff_pass(keys, 2, q, freq, bits2, wg_pair,
                                     structure=structure)
            want = fs.zq_gendiff_pass_reference(keys, 2, q, freq, bits2,
                                                wg_pair, structure=structure)
            for nm, a, b in zip(("z", "qqnum", "ll_diff", "zcounts"), got,
                                want):
                if nm == "ll_diff":
                    check_close(f"{tag} gendiff ll_diff", a, b, 1e-4, 1e-3)
                elif not torch.equal(a, b):
                    raise AssertionError(f"{tag}: gendiff {nm} differs")
            z = got[0]
            ll = fs.panel_loglik_pass(freq, q, bits2, z,
                                      wg_pair[:, :, 0].contiguous(),
                                      structure=structure)
            pll = fs.panel_loglik_pass_reference(
                freq, q, bits2, z, wg_pair[:, :, 0].contiguous(),
                structure=structure)
            check_close(f"{tag} loglik", ll, pll, 1e-5, 1e-3)
        g0, g1, valid, _ = fs.unpack_bits2(bits2)
        geno = torch.cat([g0, g1], dim=1).to(torch.int8)
        for kw in (dict(bits2=bits2), dict()):
            cnt = fs.allele_counts(z, geno, valid, n_pops=k, max_alleles=2,
                                   **kw)
            if not torch.equal(cnt, got[3]):
                raise AssertionError(f"{tag}: allele_counts differs from "
                                     "the site pass's carried counts")
        geno3 = torch.randint(0, 3, (n, 2 * l), generator=g, device="cuda",
                              dtype=torch.int8)
        cnt3 = fs.allele_counts(z, geno3, valid, n_pops=k, max_alleles=3)
        if not torch.equal(cnt3, fs.allele_counts_reference(
                z, geno3, valid, n_pops=k, max_alleles=3)):
            raise AssertionError(f"{tag}: allele_counts (A = 3) differs")
        kw = dict(subsweeps=3, delta0=0.05, gen_cap=50)
        gen1 = gen[:, :, 0].to(torch.int32).contiguous()
        mg = []
        s_pop_agrees(f"{tag} s_pop_tail",
                     sp.s_pop_tail(keys, 2, q, gen1, rates, **kw),
                     sp.s_pop_tail_reference(keys, 2, q, gen1, rates, **kw,
                                             margins=mg), mg)
        conc = (rand(c, n, k) * 5.0 + 0.05).contiguous()
        mg = []
        want = dk.dirichlet_nk_reference(keys, 2, conc, margins=mg)
        dirichlet_agrees(f"{tag} dirichlet_nk",
                         dk.dirichlet_nk(keys, 2, conc), want, mg[0], -1)
        counts = (rand(c, k, l, 2) * 50.0 + 1.0).contiguous()
        av = rand(l, 2) > 0.1
        mg = []
        want = dk.dirichlet_kla_reference(keys, 2, counts, av, margins=mg)
        dirichlet_agrees(f"{tag} dirichlet_kla",
                         dk.dirichlet_kla(keys, 2, counts, av), want, mg[0],
                         -1)
    emit("edge_shapes", cases=[dict(C=c, N=n, L=l, K=k)
                               for c, n, l, k in cases], all_match=True)


def phase_kernels(panel, philox_entry):
    """Entries by kernel name at the main path's variant (structure way);
    the expectation-way runs of the site pass are reported as variants."""
    x = kernel_inputs(panel)
    main = [philox_entry, check_allele_counts(x),
            check_site_gendiff(x, True), check_site_loglik(x, True),
            check_s_pop_tail(x), *check_dirichlet(x)]
    variants = [check_site_gendiff(x, False), check_site_loglik(x, False)]
    phase_edge_shapes()
    emit("kernels", shapes=dict(C=N_CHAINS, N=N_INDV, L=N_LOCI, K=N_POPS,
                                A=2, J=SUBSWEEPS),
         kernels=main, variants=variants)
    return {e["name"]: e for e in main}


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

MAIN_KERNELS = ("philox_words", "allele_counts", "site_pass_gendiff",
                "site_pass_loglik", "s_pop_tail", "dirichlet_kla",
                "dirichlet_nk")


def small_agreement() -> dict:
    """The port on the card against the port on the CPU (plain versions),
    same seed, a small panel, a few sweeps: the discrete state must agree
    exactly and the floats to f32 rounding."""
    panel = synthetic_panel(40, 120, n_pops=3, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, missing_rate=0.1, seed=3)
    spec = ModelSpec(mode=2, n_pops=3, s_subsweeps=4)
    out = {}
    for dev in ("cpu", "cuda"):
        data = panel.data.to(dev)
        keys = px.make_keys(11, 2, dev)
        # one initial state for both devices: drawn on the CPU
        state = init_state(11, spec, panel.data, n_chains=2, device="cpu")
        state = state.to(dev)
        step, add_loglik = build_step_parts(spec, data)
        for i in range(3):
            state = step(state, keys, i)
        out[dev] = add_loglik(state)
    a, b = out["cpu"], out["cuda"]
    for name in ("z", "gen"):
        if not torch.equal(getattr(a, name), getattr(b, name).cpu()):
            raise AssertionError(f"small agreement: {name} differs between "
                                 "the card and the CPU reference")
    errs = {}
    for name, tol in (("q", 1e-4), ("freq", 1e-4), ("rates", 1e-5),
                      ("alpha", 1e-5), ("loglik_indv", 1e-2)):
        x, y = getattr(a, name), getattr(b, name).cpu()
        errs[name] = max_err(x, y)
        if errs[name] > tol:
            raise AssertionError(f"small agreement: {name} differs by "
                                 f"{errs[name]:.3e} (> {tol})")
    return errs


def rates_trajectory(data, spec, n_steps: int) -> torch.Tensor:
    keys = px.make_keys(RUN_SEED, N_CHAINS, "cuda")
    state = init_state(RUN_SEED, spec, data, n_chains=N_CHAINS,
                       device="cuda")
    step, _ = build_step_parts(spec, data)
    trace = []
    for i in range(n_steps):
        state = step(state, keys, i)
        trace.append(state.rates)
    return torch.stack(trace)


def sweep_profile(data, spec, n_steps: int = 100) -> dict:
    """Where a sweep's time goes: host wall time per sweep of the bare step
    loop, and the device time of the kernels in it from ``torch.profiler``
    (summed by kernel name).  Device numbers are ``None`` where the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    keys = px.make_keys(RUN_SEED, N_CHAINS, "cuda")
    state = init_state(RUN_SEED, spec, data, n_chains=N_CHAINS,
                       device="cuda")
    step, _ = build_step_parts(spec, data)
    for i in range(20):
        state = step(state, keys, i)
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(20, 20 + n_steps):
        state = step(state, keys, i)
    enqueue = time.time() - t0
    torch.cuda.synchronize()
    wall = time.time() - t0
    out = dict(sweeps=n_steps, wall_ms_per_sweep=1e3 * wall / n_steps,
               enqueue_ms_per_sweep=1e3 * enqueue / n_steps,
               device_ms_per_sweep=None, device_idle_share=None,
               top_kernels=None)
    n_prof = 30
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(200, 200 + n_prof):
                state = step(state, keys, i)
            torch.cuda.synchronize()
    except RuntimeError as e:
        # the profiler is a measurement aid, not a check: where device
        # tracing is not available the device numbers stay None
        out["profiler_error"] = str(e)[:200]
        return out
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and \
                "cuda" not in str(ev.device_type).lower():
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / n_prof / 1e3, ev.count / n_prof))
    if rows:
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out.update(device_ms_per_sweep=busy,
                   device_idle_share=max(0.0, 1.0 - busy / out[
                       "wall_ms_per_sweep"]),
                   top_kernels=[dict(name=k[:60], ms_per_sweep=round(ms, 5),
                                     launches_per_sweep=round(cnt, 2))
                                for k, ms, cnt in rows[:8]],
                   device_kernel_launches_per_sweep=round(
                       sum(r[2] for r in rows), 1))
    return out


def phase_main_path(panel, smi: str) -> dict:
    spec = ModelSpec(mode=2, n_pops=N_POPS, s_subsweeps=SUBSWEEPS)
    n_iter = N_ITER
    sched = Schedule(n_iter=n_iter, burnin=n_iter // 2, thinning=10,
                     n_chains=N_CHAINS)
    agreement = small_agreement()
    data = panel.data.to("cuda")

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    res = run_mcmc(panel.data, spec, sched, RUN_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: int(_build.launches[k]) for k in MAIN_KERNELS}

    attempts = 1 + res.n_retries
    steps = n_iter * attempts
    stored = sched.n_stored
    last_extra = 0 if (n_iter - sched.burnin) % sched.thinning == 0 else 1
    want = {"philox_words": steps, "site_pass_gendiff": steps,
            "s_pop_tail": steps,
            "dirichlet_kla": steps, "dirichlet_nk": steps,
            "site_pass_loglik": (stored + last_extra) * attempts}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"main path: {name} launched "
                                 f"{launches[name]} times, expected {n}")
    if launches["allele_counts"] < attempts:
        raise AssertionError("main path: allele_counts was not launched")

    st, acc = res.final_state, res.accum
    checks = {
        "loglik finite": bool(torch.isfinite(st.loglik_indv).all()
                              and torch.isfinite(acc.mean.total_ll).all()
                              and torch.isfinite(acc.mean.ll_marg).all()),
        "rates in (0,1)": bool(((st.rates > 0) & (st.rates < 1)).all()
                               and ((acc.mean.rates > 0)
                                    & (acc.mean.rates < 1)).all()),
        "Q rows sum to 1": bool(torch.allclose(
            st.q.sum(-1), torch.ones_like(st.q.sum(-1)), atol=1e-4)),
        "freq rows sum to 1": bool(torch.allclose(
            st.freq.sum(-1), torch.ones_like(st.freq.sum(-1)), atol=1e-4)),
        "shapes": (tuple(st.z.shape) == (N_CHAINS, N_INDV, 2 * N_LOCI)
                   and tuple(st.q.shape) == (N_CHAINS, N_INDV, N_POPS)
                   and tuple(st.freq.shape) == (N_CHAINS, N_POPS, N_LOCI, 2)
                   and tuple(acc.mean.rates.shape) == (N_CHAINS, N_POPS)),
        "stored count": bool((acc.count == stored).all()),
        "zcounts carried": bool(torch.equal(
            st.zcounts, fs.allele_counts_reference(
                st.z, data.geno, data.site_valid, n_pops=N_POPS,
                max_alleles=2))),
        "retries not exhausted": res.n_retries < 10,
        "dic finite": bool(np.isfinite(res.dic()).all()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"main path: failed checks {bad}")

    res2 = run_mcmc(panel.data, spec, sched, RUN_SEED, device="cuda")
    same = (torch.equal(res.final_state.z, res2.final_state.z)
            and torch.equal(res.final_state.rates, res2.final_state.rates)
            and torch.equal(res.accum.mean.rates, res2.accum.mean.rates)
            and torch.equal(res.accum.mean.total_ll,
                            res2.accum.mean.total_ll))
    tr1 = rates_trajectory(data, spec, 60)
    tr2 = rates_trajectory(data, spec, 60)
    same = same and torch.equal(tr1, tr2)
    if not same:
        raise AssertionError("main path: two runs from one seed are not "
                             "bitwise equal")
    emit("sweep_profile", card=smi, **sweep_profile(data, spec))
    emit("main_path", card=smi, steps=steps, chains=N_CHAINS,
         n_retries=res.n_retries, wall_seconds=round(wall, 3),
         chain_steps_per_second=round(N_CHAINS * steps / wall, 1),
         ms_per_step=round(1e3 * wall / steps, 4), launches=launches,
         mean_rates=[[round(float(v), 4) for v in row]
                     for row in acc.mean.rates.cpu()],
         checks=sorted(checks), bitwise_reproducible=True,
         small_agreement_max_abs_err=agreement)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,main_path")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    smi = phase_device()
    if "build" in phases:
        phase_build()
    philox_entry = phase_philox()
    panel = synthetic_panel(N_INDV, N_LOCI, n_pops=N_POPS, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, seed=PANEL_SEED)
    entries = (phase_kernels(panel, philox_entry) if "kernels" in phases
               else {})
    launches = (phase_main_path(panel, smi)
                if "main_path" in phases else {})
    full = {"kernels", "main_path"} <= phases
    if full:
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        summary = []
        for name in MAIN_KERNELS:
            e = dict(entries[name], launches=launches[name])
            if e["launches"] < 1:
                raise AssertionError(f"{name} was never launched on the "
                                     "main path")
            summary.append({k: e[k] for k in keys})
        print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    if not full:
        print(json.dumps({"ok": False, "partial": sorted(phases)}))
        return 4
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
