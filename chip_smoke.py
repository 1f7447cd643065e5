#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``instruct_tpu_torch`` from
``instruct_tpu_torch/csrc`` with ``nvcc``, holds each kernel against its plain
PyTorch version on the card at the sampler's headline shapes (N = 1000
individuals x L = 10 000 loci, K = 3, 4 chains, packed biallelic panel;
N = 1000 x L = 2000 with A = 8 alleles for the generic site path; the site
pass's run-time-K body at K = 12 on the headline panel, K = 10 with the K
grid's 40 chains and K = 16 on an A = 4 panel, with K = 9 and 32 as variants;
and N = 1000 x L = 2000 with A = 16 alleles and K = 5, a microsatellite
panel whose K*A = 80 only the unfused sweep runs), and the tetraploid
engine's kernels on its benchmark panels (N = 500 x L = 5000, K = 3, A = 4,
auto and allo), then drives the main paths -- ``run_mcmc`` on the diploid
mode-2 biallelic panel, and ``infer_k`` over K = 1..10 on it (one padded
grid of 40 replicas) -- and the other paths -- ``run_mcmc`` in modes 1, 3,
4, 5 on that panel, in every mode on the A = 8 panel and in modes 1, 2, 4, 5
at K = 12 and at K = 16 on the A = 4 panel (the fused sweep); the unfused
sweep in mode 2 and modes 1, 3, 4, 5 on the wide panel, mode 0,
``use_pallas=False``, and the fused sweep under the normal prior and the
adaptive-independence proposal; the tetraploid engine, auto and allo, and
its four-subsweep S update, adaptive proposal, unfused sweep and a panel of
wide class tables (A = 8, K * G = 1320) -- and checks that each
went through its kernels, that its output is sane and that two runs from one
seed are bitwise equal.
Every phase prints one JSON line; any failure raises, so the exit code is
non-zero.  There is no CPU path: without a CUDA device the script exits with
code 1 and prints no result.

The line before the last is the card's name and power limit as ``nvidia-smi``
prints them; the line before that is the ``{"kernels": [...]}`` summary; the
last line is ``{"ok": true, "device": {...}}``.

``--phases`` runs a subset of build, kernels, main_path, modes, unfused,
tetra, kselect (development aid); the device and Philox phases always run.
``--parent-csrc DIR`` (another tree's ``instruct_tpu_torch/csrc``, e.g. a
``git archive`` of the parent commit unpacked under ``_parent/``) builds
that tree's site pass and K3 to K8 beside this one's and times them on
every timed entry point of the site pass, on the K3 to K8 entries (K6 and
K7 through their first bodies' launch functions where that tree has them)
and on K3's and K4's shapes of every path (``parent_ms`` in the kernels
phase line and the ``k3_shapes`` / ``k4_shapes`` lines; null without it),
and holds K3 bitwise to the parent's body there.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import shutil
import threading
import time

import numpy as np
import torch

import dataclasses

from instruct_tpu_torch import (ModelSpec, Priors, Schedule, infer_k,
                                run_mcmc,
                                synthetic_panel)
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.data.dataset import Dataset, packed_dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import s_pop as sp
from instruct_tpu_torch.kernels import zq as zqk
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import build_step_parts, use_fused
from instruct_tpu_torch.tetra import engine as te
from instruct_tpu_torch.tools import dirichlet_counts_variants as dcv
from instruct_tpu_torch.tools import geno_zq_variants as gzv
from instruct_tpu_torch.tools import profiling
from instruct_tpu_torch.tools import site_pass_variants as spv

# Headline shapes of the main path.
N_INDV, N_LOCI, N_POPS, N_CHAINS, SUBSWEEPS = 1000, 10_000, 3, 4, 12
PANEL_SEED, RUN_SEED = 17, 2024
N_ITER = 200           # sweeps of a run_mcmc path (half of them burn-in)
# The multi-allelic panel of the generic site path.
GEN_LOCI, GEN_ALLELES = 2000, 8
# The wide panel of the unfused sweep: K*A = 80 is beyond the fused sweep.
WIDE_LOCI, WIDE_ALLELES, WIDE_POPS = 2000, 16, 5
WIDE_RATES = (0.1, 0.3, 0.5, 0.7, 0.9)
UNFUSED_ITER = 40      # sweeps of the shorter unfused and new-arm paths
# K > 8, the site pass's run-time-K body: K = 12 on the headline panel, K = 16
# on an A = 4 panel (N = 1000 x L = 2000), each K*A <= 64
WIDE_K, GEN16_K, GEN16_ALLELES = 12, 16, 4
# K selection (the slice's main path): 4 chains per K, K = 1..10 (the
# reference's default range up to N^0.3 + 1 at N = 1600) -- one padded grid
# of 40 replicas at K_max = 10
KSEL_CHAINS, KSEL_MAX = 4, 10
# The tetraploid benchmark panels (the JAX package's, bench.py:100-130).
TETRA_INDV, TETRA_LOCI, TETRA_ALLELES, TETRA_SEED = 500, 5000, 4, 7
TETRA_ITER = 100       # sweeps of the tetraploid paths (half burn-in)

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
    regs, wide, wide_fn = {}, {}, None
    if log.exists():
        src, prev = None, ""
        for line in log.read_text().splitlines():
            m = re.match(r"== (\S+) ", line)
            if m:
                src = m.group(1)
            m = re.search(r"Function properties for \S*site_kernelILi"
                          r"(\d+)ELi(\d)E", line)
            if m and int(m.group(1)) > fs.WIDE_POPS:
                wide_fn = f"{src}: K <= {m.group(1)}, family {m.group(2)}"
            m = re.search(r"Used (\d+) registers", line)
            if m and wide_fn:
                wide[wide_fn] = (f"{m.group(1)} registers, "
                                 f"{prev.split(',')[1].strip()}")
                wide_fn = None
            if m and src:
                spill = "0 bytes spill stores" not in prev
                r = regs.setdefault(src, {"max_registers": 0,
                                          "spills": False})
                r["max_registers"] = max(r["max_registers"],
                                         int(m.group(1)))
                r["spills"] = r["spills"] or spill
            prev = line
    text = log.read_text() if log.exists() else ""
    emit("build", seconds=round(seconds, 2), nvcc=_build.find_nvcc(),
         flags=" ".join(_build.NVCC_FLAGS), ptxas=regs, ptxas_wide=wide,
         ptxas_k3_k4=kernel_frames(text, "dirichlet_kernel|allele_counts"),
         ptxas_k6_k7=kernel_frames(text, "s_delta_kernel|site_ll_kernel"))


def kernel_frames(log: str, names: str) -> dict:
    """Per instantiation of the kernels whose mangled names hold one of
    ``names`` (a regex alternation): registers, stack frame and spills as
    ``ptxas -v`` printed them (a stack frame is local memory: an array
    indexed at run time, or a library routine's slow path)."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*(?:" + names
                      + r")\S*)", line)
        if m and i + 2 < len(lines):
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            out[m.group(1)] = (f"{regs.group(1) if regs else '?'} "
                               f"registers, {lines[i + 1].strip()}")
    return out


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

def kernel_inputs(panel, k: int = N_POPS, c: int = N_CHAINS,
                  zero_tail: int = 0):
    """State-like inputs at the panel's shapes, from a seed.  With
    ``zero_tail`` the first half of each chain's rows has that many
    trailing zero-q columns (the padded K grid's inactive slots)."""
    data = panel.data.to("cuda")
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    g = torch.Generator(device="cuda").manual_seed(99)
    gam = torch._standard_gamma(torch.full((c, k, l, a), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((c, n, k), 0.3, device="cuda"),
                               generator=g).clamp_min(1e-20)
    if zero_tail:
        gq[:, : n // 2, k - zero_tail:] = 0.0
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

    def f_pair(r):
        f = torch.rand((c, r), generator=g, device="cuda") * 0.9 + 0.05
        step = (torch.rand((c, r), generator=g, device="cuda") - 0.5) * 0.1
        return torch.stack([f, (f + step).clamp(0.01, 0.99)], -1).contiguous()

    return dict(data=data, freq=freq, q=q, z=z, gen=gen, rates=rates,
                wg_pair=wg_pair.contiguous(), keys=keys, f_pop=f_pair(k),
                f_ind=f_pair(n), zero_tail=zero_tail)


def check_allele_counts(x):
    """``allele_counts`` at the inputs' shape: on the packed plane (the
    packed body) and on the allele codes (the codes body to K*A = 8, the
    table beyond)."""
    d = x["data"]
    c, n, k = x["q"].shape
    l, a = d.n_loci, d.max_alleles
    wide = k * a > 64
    name = "allele_counts_wide" if wide else "allele_counts"
    kw = dict(n_pops=k, max_alleles=a)
    run = lambda: fs.allele_counts(x["z"], d.geno, d.site_valid, **kw,
                                   bits2=d.bits2)
    plain = lambda: fs.allele_counts_reference(x["z"], d.geno, d.site_valid,
                                               **kw)
    got, want = run(), plain()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: counts differ from the plain version "
                             f"(max {max_err(got, want)})")
    if not torch.equal(got, run()):
        raise AssertionError(f"{name}: two launches are not bitwise equal")
    if d.bits2 is not None and not torch.equal(
            fs.allele_counts(x["z"], d.geno, d.site_valid, **kw), want):
        raise AssertionError("allele_counts (geno + site_valid operands) "
                             "differs from the plain version")
    valid2 = 2.0 * float(d.site_valid.sum())
    for ch in range(c):
        if float(got[ch].sum()) != valid2:
            raise AssertionError(f"{name}: total != 2 * valid sites")
    planes = n * l if fs.is_packed(d) and not wide else n * 3 * l
    n_bytes = c * n * 2 * l + planes + c * k * l * a * 4
    library = allele_counts_library_ms(x, want)
    n_ops = c * n * 2 * l * 4
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name=name, route="cuda",
                source="instruct_tpu_torch/csrc/allele_counts.cu",
                replaces="instruct_tpu/kernels/fused_step.py:87",
                max_abs_err=max_err(got, want), ms=time_ms(run),
                plain_ms=time_ms(plain, reps=5, warm=1, inner=1),
                bound_ms=b_ms,
                bound_by=b_by, library_ms=min(library.values()),
                library=library, bytes=n_bytes,
                ops=n_ops, shape=dict(C=c, N=n, L=l, K=k, A=a),
                plan=k4_plan_agrees(name, c, n, l, k, a,
                                    d.bits2 is not None),
                parent_ms=parent_k3k4(run, want)[0],
                compared="counts exactly equal")


def allele_counts_library_ms(x, want) -> dict:
    """The times of two PyTorch calls that compute ``allele_counts``, on
    flat cell indices built beforehand (not timed): an accumulating
    ``index_put_`` of every copy's weight (1 valid, 0 not) into zeroed
    [C, K, L, A] cells, and ``torch.bincount`` of the valid copies' cells
    with its cast to float32.  Raises unless each gives the kernel's
    counts."""
    d, z = x["data"], x["z"]
    c, n, k = x["q"].shape
    l, a = d.n_loci, d.max_alleles
    geno = d.geno.to(torch.int64).reshape(1, n, 2, l)
    cell = (((torch.arange(c, device="cuda").reshape(c, 1, 1, 1) * k
              + z.to(torch.int64).reshape(c, n, 2, l)) * l
             + torch.arange(l, device="cuda")) * a + geno)
    ones = d.site_valid.reshape(1, n, 1, l).expand(c, n, 2, l).float()
    cell, ones = cell.reshape(-1), ones.reshape(-1).contiguous()
    flat = cell[ones > 0]
    size = c * k * l * a
    runs = {"index_put_": lambda: torch.zeros(size, device="cuda")
            .index_put_((cell,), ones, accumulate=True),
            "bincount": lambda: torch.bincount(flat, minlength=size)
            .to(torch.float32)}
    out = {}
    for name, run in runs.items():
        if not torch.equal(run().reshape(want.shape), want):
            raise AssertionError(f"{name} counts differ from allele_counts")
        out[name] = time_ms(run, reps=5, warm=1, inner=1)
    del cell, ones, flat
    torch.cuda.empty_cache()
    return out


def k4_plan_agrees(tag, c, n, l, k, a, packed=False) -> dict:
    """K4's launch plan in Python (``fused_step.counts_plan``) against the
    one the kernel's launch function makes."""
    plan = fs.counts_plan(c, n, l, k, a, packed)
    out = (ctypes.c_int * 5)()
    rc = _build.library().allele_counts_launch_plan(c, n, l, k, a,
                                                    int(packed), out)
    got = (out[0], out[1], out[2], out[3], out[4])
    want = (plan.grid[0], plan.grid[1], plan.rows, plan.pops_per_window,
            plan.dyn_smem)
    if rc or got != want:
        raise AssertionError(f"{tag}: the kernel's plan {got} (rc {rc}), "
                             f"the wrapper's {want}")
    return plan._asdict()


def k3_plan_agrees(tag, c, g, j, m) -> dict:
    """K3's launch plan in Python (``dirichlet.dirichlet_plan``) against the
    shared memory and threads of the kernel's launch function."""
    plan = dk.dirichlet_plan(c, g, j, m)
    out = (ctypes.c_int * 2)()
    rc = _build.library().dirichlet_launch_plan(c, g, j, m, 3, out)
    if rc or (out[0], out[1]) != (plan.dyn_smem, plan.threads):
        raise AssertionError(f"{tag}: the kernel's shared memory and "
                             f"threads {(out[0], out[1])} (rc {rc}), the "
                             f"plan's {(plan.dyn_smem, plan.threads)}")
    return plan._asdict()


def k3_ops(cells: int) -> float:
    """K3's least operations: a quarter of a Philox block a uniform (one
    block serves four words), 16 transcendentals and ~40 float operations a
    cell."""
    return cells * (dk.n_test_draws() * OPS_PHILOX / 4 + 16 * OPS_TRANSC
                    + 40)


def check_k3_shapes() -> dict:
    """K3 at every shape the sweeps give it (``dcv.K3_SHAPES``: the main
    path's P and Q, A = 8 P, the K grid's P and Q at C = 40, K = 10, the
    allotetraploid P2): against the plain version, a rerun bitwise, the
    launch plan, and bitwise against the parent's body (``--parent-csrc``);
    the device time of each (profiler; the parent's too), its time by CUDA
    events (which read the host's enqueue where a launch is shorter), and
    the bound."""
    out = {}
    for shape, (kind, dims, _) in dcv.K3_SHAPES.items():
        run, plain, cells = dcv.k3_inputs(shape)
        got = run()
        margins = []
        want = plain(margins)
        n_off = dirichlet_agrees(f"K3 {shape}", got, want, margins[0], -1)
        del want, margins
        if not torch.equal(got, run()):
            raise AssertionError(f"K3 {shape}: two launches are not "
                                 "bitwise equal")
        geom = ((dims[0], dims[1], dims[3], dims[2]) if kind == "P"
                else (dims[0], 1, dims[2], dims[1]))
        plan = k3_plan_agrees(f"K3 {shape}", *geom)
        p_ms, _ = parent_k3k4(run, got, f"K3 {shape}", "dirichlet_kernel")
        valid = dims[2] * dims[3] if kind == "P" else 0
        b_ms, b_by = bound(cells * 8 + valid, k3_ops(cells))
        out[shape] = dict(device_ms=profiling.device_ms(run,
                                                        "dirichlet_kernel"),
                          parent_device_ms=p_ms, ms=time_ms(run),
                          bitwise_parent=p_ms is not None,
                          knife_edge_cells=n_off, bound_ms=b_ms,
                          bound_by=b_by, cells=cells, plan=plan)
        torch.cuda.empty_cache()
    dcv.k3_inputs.cache_clear()          # no input outlives the phase
    torch.cuda.empty_cache()
    emit("k3_shapes", shapes=out)
    return out


def check_k4_shapes() -> dict:
    """K4 at every shape the sweeps give it (``dcv.K4_SHAPES``: the
    headline's packed plane, A = 8, the wide panel, the tetraploid view of
    per-chain planes, auto and allo): exactly the plain version's counts, a
    rerun bitwise, the launch plan, its device time and the parent's
    (profiler), its time by CUDA events."""
    out = {}
    for shape, (c, n, l, k, a, panel) in dcv.K4_SHAPES.items():
        run = dcv.k4_run(shape)
        got = run()
        if not torch.equal(got, dcv.k4_plain(shape)):
            raise AssertionError(f"K4 {shape}: counts differ from the "
                                 "plain version")
        if not torch.equal(got, run()):
            raise AssertionError(f"K4 {shape}: two launches differ")
        z, geno, _, _ = dcv.k4_inputs(shape)
        l2 = z.shape[2] // 2
        planes = n * l2 if panel == "packed" else geno.numel() + n * l2
        n_bytes = z.numel() + planes + got.numel() * 4
        b_ms, b_by = bound(n_bytes, z.numel() * 4)
        out[shape] = dict(device_ms=profiling.device_ms(run,
                                                        "allele_counts"),
                          parent_device_ms=parent_k3k4(
                              run, got, f"K4 {shape}", "allele_counts")[0],
                          ms=time_ms(run),
                          bound_ms=b_ms, bound_by=b_by,
                          plan=k4_plan_agrees(f"K4 {shape}", c, n, l2, k, a,
                                              panel == "packed"))
        torch.cuda.empty_cache()
    dcv.k4_inputs.cache_clear()          # no input outlives the phase
    torch.cuda.empty_cache()
    emit("k4_shapes", shapes=out)
    return out


def zq_plan_agrees(tag, q, freq) -> dict:
    """The wrapper's launch plan of K8 on these operands, checked against
    the shared memory the kernel's launch function computes for it."""
    c, k, l, a = freq.shape
    plan = zqk.zq_plan(c, q.shape[1], l, k, a)
    dyn = _build.library().zq_sample_launch_dyn_smem(k, a, plan.rows)
    if dyn != plan.dyn_smem:
        raise AssertionError(f"{tag}: the kernel takes {dyn} bytes of "
                             f"dynamic shared memory, the plan "
                             f"{plan.dyn_smem}")
    return plan._asdict()


def zq_agrees(tag, keys, q, freq, geno, site_valid, u=None):
    """Raise unless ``zq_sample_counts`` gives exactly its plain version's
    z and qqnum on these inputs; returns the kernel's (z, qqnum)."""
    k = q.shape[2]
    args = (keys, 5, q, freq, geno, site_valid)
    got = zqk.zq_sample_counts(*args, n_pops=k, u=u)
    want = zqk.zq_sample_counts_reference(*args, n_pops=k, u=u)
    for nm, a, b in zip(("z", "qqnum"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {nm} differs from the plain "
                                 f"version at {int((a != b).sum())} elements")
    ploid = geno.shape[-1] // site_valid.shape[1]
    total = float(ploid) * float(site_valid.sum())
    for ch in range(q.shape[0]):
        if float(got[1][ch].sum()) != total:
            raise AssertionError(f"{tag}: qqnum.sum() != ploidy * valid "
                                 "sites")
    if int(got[0].min()) < 0 or int(got[0].max()) >= k:
        raise AssertionError(f"{tag}: z outside [0, K)")
    again = zqk.zq_sample_counts(*args, n_pops=k, u=u)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError(f"{tag}: two launches are not bitwise equal")
    return got


def check_zq_sample_counts(name, keys, q, freq, geno, site_valid,
                           k1_data=None):
    """K8 against its plain version, z and qqnum exactly equal, with Philox
    and with injected uniforms; against the generic site pass from the same
    keys where that exists (``k1_data``: diploid, K <= 8); its time and
    bound."""
    c, n, k = q.shape
    s, l, a = geno.shape[1], site_valid.shape[1], freq.shape[3]
    got = zq_agrees(name, keys, q, freq, geno, site_valid)
    plan = zq_plan_agrees(name, q, freq)
    u = torch.rand((c, n, s), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(3))
    zq_agrees(name + " under injected uniforms", keys, q, freq, geno,
              site_valid, u=u)
    del u
    run = lambda: zqk.zq_sample_counts(keys, 5, q, freq, geno, site_valid,
                                       n_pops=k)
    plain = lambda: zqk.zq_sample_counts_reference(keys, 5, q, freq, geno,
                                                   site_valid, n_pops=k)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, run())):
        raise AssertionError(f"{name}: two launches from one seed are not "
                             "bitwise equal")
    notes = []
    if k1_data is not None:
        z1, qq1, _ = fs.zq_sample_pass(keys, 5, q, freq,
                                       k1_data._replace(bits2=None))
        if not (torch.equal(z1, got[0]) and torch.equal(qq1, got[1])):
            raise AssertionError(f"{name}: differs from the generic "
                                 "zq_sample_pass from the same keys")
        notes.append("== zq_sample_pass on the generic path")
    n_bytes = (c * n * k * 4 * 2 + c * k * l * a * 4 + n * s + n * l
               + c * n * s)
    n_ops = c * n * s * (OPS_PHILOX / 4 + 1 + 2 * k + 3 * (k - 1) + k)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name=name, route="cuda",
                source="instruct_tpu_torch/csrc/zq_sample.cu",
                replaces="instruct_tpu/kernels/zq_pallas.py:91",
                max_abs_err=max_err(got[1], plain()[1]), ms=time_ms(run),
                plain_ms=time_ms(plain, reps=3, warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by,
                # torch.multinomial draws from the same distribution but is
                # another function of the uniforms
                library_ms=None, bytes=n_bytes, ops=n_ops, notes=notes,
                shape=dict(C=c, N=n, L=l, S=s, K=k, A=a), plan=plan,
                parent_ms=parent_kernel_ms(
                    "zq_sample_counts", (keys, 5, q, freq, geno,
                                         site_valid)),
                compared="z, qqnum exactly equal")


def ploidy4_inputs():
    """A ploidy-4 input of K8 at N = 1000, L = 2000, S = 4L, A = 4, K = 3,
    from a seed."""
    c, n, l, k, a = N_CHAINS, N_INDV, GEN_LOCI, N_POPS, 4
    g = torch.Generator(device="cuda").manual_seed(41)
    geno = torch.randint(0, a, (n, 4 * l), generator=g, device="cuda",
                         dtype=torch.int8)
    site_valid = torch.rand((n, l), generator=g, device="cuda") > 0.1
    gam = torch._standard_gamma(torch.full((c, k, l, a), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((c, n, k), 0.3, device="cuda"),
                               generator=g).clamp_min(1e-20)
    q = (gq / gq.sum(-1, keepdim=True)).contiguous()
    return px.make_keys(RUN_SEED, c, "cuda"), q, freq, geno, site_valid


# Entry points of the site pass: (launch-counter name, line of the wrapper's
# JAX counterpart in instruct_tpu/kernels/fused_step.py, sampling?).  On the
# generic path the counter is the name + "_generic", and the run-time-K
# body (K > 8) adds "_wide" (fs.site_counter).
SITE_ENTRIES = (("site_pass_sample", 763, True),
                ("site_pass_mode1", 790, True),
                ("site_pass_gen", 730, True),
                ("site_pass_gendiff", 748, True),
                ("site_pass_find", 815, True),
                ("site_pass_fpop", 815, True),
                ("site_pass_loglik", 803, False),
                ("site_pass_loglik_mode1", 777, False),
                ("site_pass_loglik_find", 847, False),
                ("site_pass_loglik_fpop", 847, False))
# ll columns are f32 sums over L sites taken in another order than the plain
# version's: full log-liks (|ll| ~ L) at rtol 1e-5, MH log-ratios (sums of
# small terms of either sign) at rtol 1e-4; atol scales with L / 10 000
# the entry points that also have an expectation way (structure=False)
EXP_WAY = ("site_pass_gen", "site_pass_gendiff", "site_pass_loglik")
LL_RTOL = {"site_pass_gendiff": 1e-4, "site_pass_find": 1e-4,
           "site_pass_fpop": 1e-4}
LL_ATOL = {"site_pass_gendiff": 2e-3, "site_pass_find": 2e-3,
           "site_pass_fpop": 2e-3}


def chain_rows(x, lo: int, hi: int):
    """The inputs ``x`` of chains lo..hi-1 (the chains draw from their own
    keys, so a group of them is a run of its own)."""
    out = dict(x)
    for name in ("freq", "q", "z", "gen", "rates", "wg_pair", "f_pop",
                 "f_ind"):
        out[name] = x[name][lo:hi]
    out["keys"] = x["keys"]._replace(chain_key=x["keys"].chain_key[lo:hi])
    return out


def site_calls(name: str, x, structure: bool, u=None, plain_group=None):
    """(kernel call, plain call) of one entry point on the inputs ``x``,
    each returning dict(z, qqnum, zcounts, ll) with ``None`` for what the
    entry point does not return.  ``plain_group`` runs the plain version
    that many chains at a time (its [C, N, L] temporaries do not fit the
    card at the K grid's 40 chains) and joins the groups."""
    if plain_group is not None:
        c = x["q"].shape[0]
        groups = [site_calls(name, chain_rows(x, lo, lo + plain_group),
                             structure,
                             None if u is None else u[lo:lo + plain_group])
                  for lo in range(0, c, plain_group)]
        kernel = site_calls(name, x, structure, u)[0]

        def plain():
            outs = [grp[1]() for grp in groups]
            return {nm: None if outs[0][nm] is None else
                    torch.cat([o[nm] for o in outs]) for nm in outs[0]}
        return kernel, plain
    d, keys, q, freq, z = x["data"], x["keys"], x["q"], x["freq"], x["z"]
    wg0 = x["wg_pair"][:, :, 0].contiguous()
    f_pop0 = x["f_pop"][:, :, 0].contiguous()
    f_ind0 = x["f_ind"][:, :, 0].contiguous()

    def sampling(fn, *extra, **kw):
        def call():
            out = fn(keys, 5, q, freq, d, *extra, u=u, **kw)
            zz, qq, zc = out[0], out[1], out[-1]
            return dict(z=zz, qqnum=qq, zcounts=zc,
                        ll=out[2] if len(out) == 4 else None)
        return call

    def stored(fn, *args, **kw):
        return lambda: dict(z=None, qqnum=None, zcounts=None,
                            ll=fn(*args, **kw))

    st = dict(structure=structure)
    table = {
        "site_pass_sample": (sampling, "zq_sample_pass", (), {}),
        "site_pass_mode1": (sampling, "zq_mode1_pass", (), {}),
        "site_pass_gen": (sampling, "zq_gen_pass", (x["wg_pair"],), st),
        "site_pass_gendiff": (sampling, "zq_gendiff_pass", (x["wg_pair"],),
                              st),
        "site_pass_find": (sampling, "zq_f_pass", (x["f_ind"],),
                           dict(pop=False)),
        "site_pass_fpop": (sampling, "zq_f_pass", (x["f_pop"],),
                           dict(pop=True)),
        "site_pass_loglik": (stored, "panel_loglik_pass",
                             (freq, q, d, z, wg0), st),
        "site_pass_loglik_mode1": (stored, "panel_loglik_mode1_pass",
                                   (freq, q, d, z), {}),
        "site_pass_loglik_find": (stored, "panel_loglik_f_pass",
                                  (freq, d, z, f_ind0), dict(pop=False)),
        "site_pass_loglik_fpop": (stored, "panel_loglik_f_pass",
                                  (freq, d, z, f_pop0), dict(pop=True)),
    }
    make, fn, args, kw = table[name]
    return (make(getattr(fs, fn), *args, **kw),
            make(getattr(fs, fn + "_reference"), *args, **kw))


def site_agrees(tag, name, got, want, scale=1.0) -> float:
    """Raise unless a site pass's kernel outputs match the plain version's:
    z, qqnum, zcounts exactly, the ll columns within the stated tolerance.
    Returns the largest absolute ll error."""
    for nm in ("z", "qqnum", "zcounts"):
        a, b = got[nm], want[nm]
        if (a is None) != (b is None):
            raise AssertionError(f"{tag}: {nm} is returned by only one of "
                                 "kernel and plain version")
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{tag}: {nm} differs from the plain "
                                 f"version at {int((a != b).sum())} elements")
    if got["ll"] is None:
        return 0.0
    check_close(f"{tag} ll", got["ll"], want["ll"],
                rtol=LL_RTOL.get(name, 1e-5),
                atol=LL_ATOL.get(name, 1e-2) * scale)
    return max_err(got["ll"], want["ll"])


def site_work(name, x, out, structure):
    """(bytes, operations) one call of the entry point must move and do on
    these inputs: each operand read once, each result written once; the
    logs and divisions counted from this run's masks (which sites are
    valid, homozygous, same-z), not from the most there could be."""
    d = x["data"]
    c, n, k = x["q"].shape
    l, a = d.n_loci, d.max_alleles
    sample = out["z"] is not None
    packed = fs.is_packed(d)
    z = out["z"] if sample else x["z"]
    valid, hom = d.site_valid[None], d.hom[None]
    fam = name.replace("site_pass_", "").replace("loglik_", "")
    z_cond = not (fam in ("gen", "gendiff", "loglik") and not structure)
    # sites whose likelihood is the joint (same-pop) form
    same = z[:, :, :l] == z[:, :, l:]
    joint = valid & (same if z_cond else torch.ones_like(same))
    n_valid = c * int(valid.sum())
    n_same = int(joint.sum())
    n_diff = n_valid - n_same
    if fam == "sample":
        n_transc = 0
    elif fam == "gendiff":
        n_transc = 2 * int((joint & hom).sum())
    elif sample and fam in ("find", "fpop"):
        n_transc = 2 * n_same
    else:
        cols = 2 if fam == "gen" and sample else 1
        n_transc = (cols * n_same + 2 * n_diff if fam != "mode1"
                    else 2 * n_valid)
    need_hom = fam not in ("sample", "mode1")
    planes = n * l * (1 if packed else 3 + int(need_hom))
    n_in = 2 if sample else 1
    n_bytes = planes + c * k * l * a * 4
    if sample or not z_cond:
        n_bytes += c * n * k * 4
    if fam in ("gen", "gendiff", "loglik", "find"):
        n_bytes += c * n * n_in * 4
    if fam == "fpop":
        n_bytes += c * k * n_in * 4
    n_bytes += c * n * 2 * l                       # z, written or read
    if sample:
        n_bytes += c * n * k * 4 + c * k * l * a * 4     # qqnum, zcounts
    if out["ll"] is not None:
        n_bytes += out["ll"].numel() * 4
    per_site = 0.0
    if sample:
        per_site = 4 * k + 2 * (OPS_PHILOX / 4 + 3 + 3 * (k - 1) + 3 * k)
    elif not z_cond:
        per_site = 4 * k
    n_ops = c * n * l * per_site + n_transc * OPS_TRANSC + n_valid * 8
    return n_bytes, n_ops


# The site pass of another tree (``--parent-csrc``), timed beside the current
# one: its build thread, then its library or the build's error.
PARENT: dict = {}


def start_parent_build(csrc) -> None:
    """Build the site-pass sources of ``csrc`` (another tree's
    ``instruct_tpu_torch/csrc``), its K5 and K8 sources and its K3 and K4
    sources in three threads, into :data:`PARENT`."""
    work_dir = _build.BUILD / "parent"
    shutil.rmtree(work_dir, ignore_errors=True)

    def work(key, build):
        try:
            PARENT[key], _ = build()
        except Exception as e:          # reported where it is needed
            PARENT[key + "_error"] = repr(e)
    jobs = {"lib": lambda: spv.build_site_library(
                work_dir, "parent", spv.source_texts(pathlib.Path(csrc))),
            "lib_geno_zq": lambda: gzv.build_library(
                work_dir, "parent_geno_zq", pathlib.Path(csrc)),
            "lib_k3k4": lambda: dcv.build_library(
                work_dir, "parent_k3k4", pathlib.Path(csrc))}
    PARENT["threads"] = [threading.Thread(target=work, args=(key, fn))
                         for key, fn in jobs.items()]
    for t in PARENT["threads"]:
        t.start()


def _parent_lib(key):
    for t in PARENT["threads"]:
        t.join()
    if key not in PARENT:
        raise RuntimeError(f"the parent's kernels did not build: "
                           f"{PARENT.get(key + '_error')}")
    return PARENT[key]


def parent_kernel_ms(kernel, args, kw=None, device_name=None):
    """The parent's K5 (``geno_choice_pass``) to K8 (``zq_sample_counts``)
    time on these arguments of the current wrapper, or None without
    ``--parent-csrc``; with ``device_name``, the profiler's device time of
    a call's kernels whose names hold it."""
    if "threads" not in PARENT:
        return None
    lib = _parent_lib("lib_geno_zq")
    run = lambda: gzv.parent_call(lib, kernel, args, kw or {})
    if device_name is None:
        return time_ms(run)
    return profiling.device_ms(run, device_name, per_call=True)


def parent_k3k4(run, want=None, tag=None, kernel=None):
    """The parent's K3 or K4 (``--parent-csrc``) on the current wrapper call
    ``run``: (its time, its output), or (None, None) without a parent; with
    ``kernel`` (a name the kernel's holds), the time is the profiler's
    device time.  With ``want``, raises unless the parent's output is
    bitwise ``want`` (K3: the same words, operations and order; K4: exact
    counts)."""
    if "threads" not in PARENT:
        return None, None
    with dcv.library(_parent_lib("lib_k3k4")):
        out = run()
        ms = (time_ms(run) if kernel is None
              else profiling.device_ms(run, kernel))
    if want is not None and not torch.equal(out, want):
        raise AssertionError(f"{tag}: not bitwise equal to the parent's "
                             "body")
    return ms, out


def parent_ms(name, x, structure):
    """The parent site pass's time on the entry point and inputs (its
    bodies take 16-row strips, as the kernel's ``site_pass_strips`` gives
    them), or None without ``--parent-csrc``."""
    if "threads" not in PARENT:
        return None
    with spv.site_library(_parent_lib("lib"), fs.MIN_STRIP_ROWS):
        return time_ms(site_calls(name, x, structure)[0])


def check_site_entry(name, line, x, structure=True, timed=True,
                     plain_group=None):
    d = x["data"]
    c, n, k = x["q"].shape
    packed = fs.is_packed(d)
    counter = fs.site_counter(name, d, k)
    tag = f"{counter}(K={k}, structure={structure})"
    run, plain = site_calls(name, x, structure, plain_group=plain_group)
    got, want = run(), plain()
    plan = None
    if k > fs.WIDE_POPS:
        # the wrapper's launch plan against the kernel's own shared memory
        sample = got["z"] is not None
        fam = name.replace("site_pass_", "").replace("loglik_", "")
        fam = {"sample": "none", "loglik": "gen"}.get(fam, fam)
        plan = fs.site_plan(c, n, d.n_loci, k, d.max_alleles, packed=packed,
                            sample=sample, ll_kind=fam,
                            structure=structure)._asdict()
        dyn = getattr(_build.library(), (
            f"site_{'packed' if packed else 'generic'}_"
            f"{'sample' if sample else 'eval'}_launch_dyn_smem"))(
                k, d.max_alleles, fs._FAMILY[fam], int(structure))
        if dyn != plan["dyn_smem"]:
            raise AssertionError(f"{tag}: the kernel takes {dyn} bytes of "
                                 f"dynamic shared memory, the plan "
                                 f"{plan['dyn_smem']}")
    scale = d.n_loci / 10_000
    err = site_agrees(tag, name, got, want, scale)
    sample = got["z"] is not None
    if sample:
        valid2 = 2.0 * float(d.site_valid.sum())
        for ch in range(c):
            if float(got["qqnum"][ch].sum()) != valid2:
                raise AssertionError(f"{tag}: qqnum.sum() != 2 * valid sites")
            if float(got["zcounts"][ch].sum()) != valid2:
                raise AssertionError(f"{tag}: zcounts.sum() != 2 * valid "
                                     "sites")
        if x.get("zero_tail"):
            # rows whose trailing q is zero never draw those slots
            cut = k - x["zero_tail"]
            if int(got["z"][:, : n // 2].max()) >= cut:
                raise AssertionError(f"{tag}: z selects a zero-q slot")
        if not packed:
            # the generic pass carries the counts the allele_counts kernel
            # (K4) makes of its z
            kw = dict(n_pops=k, max_alleles=d.max_alleles)
            if not torch.equal(got["zcounts"], fs.allele_counts(
                    got["z"], d.geno, d.site_valid, **kw)):
                raise AssertionError(f"{tag}: the carried counts differ "
                                     "from allele_counts'")
    again = run()
    for nm in ("z", "qqnum", "zcounts", "ll"):
        if got[nm] is not None and not torch.equal(got[nm], again[nm]):
            raise AssertionError(f"{tag}: two launches from one seed are "
                                 f"not bitwise equal ({nm})")
    if sample:
        # injected uniforms are honoured by the kernel too
        u = torch.rand(tuple(got["z"].shape), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(3))
        run_u, plain_u = site_calls(name, x, structure, u=u,
                                    plain_group=plain_group)
        site_agrees(tag + " under injected uniforms", name, run_u(),
                    plain_u(), scale)
        del u
    notes = []
    if name == "site_pass_fpop":
        # the step sums fdiff over N and accepts where log u < sum: the
        # decisions of kernel and plain version may differ only on a
        # knife-edge (the sum within f32 rounding of log u)
        s_k, s_p = got["ll"].sum(dim=1), want["ll"].sum(dim=1)
        logu = s_p + torch.linspace(-1.0, 1.0, s_p.numel(),
                                    device="cuda").reshape(s_p.shape)
        flip = (logu < s_k) != (logu < s_p)
        edge = 1e-5 * s_p.abs() + 5e-2 * scale
        if bool(((logu - s_p).abs()[flip] > edge[flip]).any()):
            raise AssertionError(f"{tag}: the F accept differs from the "
                                 "plain version away from a knife-edge")
        check_close(f"{tag} fdiff summed over N", s_k, s_p, 1e-5,
                    5e-2 * scale)
        notes.append(f"accept flips on a knife-edge: {int(flip.sum())}")
    n_bytes, n_ops = site_work(name, x, got, structure)
    b_ms, b_by = bound(n_bytes, n_ops)
    entry = dict(name=counter, route="cuda",
                 source="instruct_tpu_torch/csrc/site_pass.cuh",
                 replaces=f"instruct_tpu/kernels/fused_step.py:{line}",
                 shape=dict(C=c, N=n, L=d.n_loci, K=k, A=d.max_alleles),
                 structure=structure, max_abs_err=err, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None, bytes=n_bytes, ops=n_ops,
                 notes=notes, plan=plan,
                 compared="z, qqnum, zcounts exactly equal; ll rtol "
                          f"{LL_RTOL.get(name, 1e-5)} atol "
                          f"{LL_ATOL.get(name, 1e-2) * scale:.1e}")
    if timed:
        entry.update(ms=time_ms(run),
                     plain_ms=time_ms(plain, reps=3, warm=1, inner=1),
                     parent_ms=parent_ms(name, x, structure))
    return entry


def check_site_entries(x, structure=True, timed=True, only=None,
                       plain_group=None):
    return [check_site_entry(name, line, x, structure, timed, plain_group)
            for name, line, _ in SITE_ENTRIES
            if only is None or name in only]


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
    # the latency floor: J*K + 1 dependent reductions of N floats with the
    # same block shape and sum order, nothing else; it and the tail itself
    # last less than the host's enqueue of a launch, so device times too
    xf = torch.rand((c, n), generator=g, device="cuda")
    iters = j * k + 1
    check_close("s_pop_floor", sp.reduction_floor(xf, iters),
                sp.reduction_floor_reference(xf, iters), 1e-6, 0)
    floor_ms = profiling.device_ms(lambda: sp.reduction_floor(xf, iters),
                                   "s_pop_floor")
    device_ms = profiling.device_ms(run, "s_pop_tail")
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
                device_ms=device_ms, latency_floor_ms=floor_ms,
                floor_reductions=iters,
                notes=notes + s_pop_grid(),
                compared="rates', gen_prop exactly equal (or shown to sit "
                         "on a knife-edge); wg_pair, logu rtol 1e-6")


def s_pop_grid() -> list:
    """The S tail against its plain version over N (one thread's worth,
    ragged, the headline, one past it, the largest register depth and the
    streamed state beyond), K and the number of subsweeps, each also
    launched twice from one seed.  Returns notes on knife-edges."""
    g = torch.Generator("cuda").manual_seed(21)
    notes = []
    # (N, K, subsweeps); the last case draws its MH uniforms in two chunks
    cases = [(n, k, sub) for n in (1, 70, 1000, 1025, 4096, 6000)
             for k in (1, 3, 8) for sub in (0, 1, 12)] + [(70, 8, 300)]
    for n, k, sub in cases:
        keys = px.make_keys(91, 2, "cuda", chain_key=[4, 9])
        x = -torch.log(torch.rand((2, n, k), generator=g,
                                  device="cuda").clamp_min(1e-6))
        q = (x / x.sum(-1, keepdim=True)).contiguous()
        gen = torch.randint(1, 9, (2, n), generator=g, device="cuda",
                            dtype=torch.int32)
        rates = (torch.rand((2, k), generator=g, device="cuda") * 0.9
                 + 0.05).contiguous()
        kw = dict(subsweeps=sub, delta0=0.05, gen_cap=50)
        tag = f"s_pop_tail N={n} K={k} subsweeps={sub}"
        got = sp.s_pop_tail(keys, 3, q, gen, rates, **kw)
        mg = []
        notes += [f"{tag}: {m}" for m in s_pop_agrees(
            tag, got, sp.s_pop_tail_reference(keys, 3, q, gen, rates, **kw,
                                              margins=mg), mg)]
        again = sp.s_pop_tail(keys, 3, q, gen, rates, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two launches from one seed are "
                                 "not bitwise equal")
    return notes


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
    n_ops = k3_ops(conc_numel)
    b_ms, b_by = bound(n_bytes, n_ops)
    # the bound before PR 9's op model: a whole Philox block a uniform
    first_ms, _ = bound(n_bytes, n_ops + conc_numel * dk.n_test_draws()
                        * OPS_PHILOX * 3 / 4)
    keep = torch.isclose(got, want, rtol=1e-4, atol=1e-6)
    return dict(name=name, route="cuda",
                source="instruct_tpu_torch/csrc/dirichlet.cu",
                replaces="instruct_tpu/kernels/dirichlet_pallas.py:110",
                max_abs_err=max_err(got[keep], want[keep]),
                knife_edge_cells=n_off, ms=time_ms(run),
                plain_ms=time_ms(lambda: plain_with_margins(None), reps=5,
                                 warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bound_ms_block_a_uniform=first_ms,
                bytes=n_bytes, ops=n_ops,
                parent_ms=parent_k3k4(run, got, name)[0],
                compared="rtol 1e-4 atol 1e-6 on every cell not on an "
                         "accept knife-edge; bitwise the parent's body "
                         "with --parent-csrc")


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


def ragged_dataset(g, n, l, a) -> Dataset:
    """A random multi-allelic panel on the card: 2..``a`` alleles per locus
    (ragged), codes below the locus's allele count, ~12% of the sites
    invalid."""
    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")
    n_alleles = 2 + (rand(l) * (a - 1)).long().clamp_max(a - 2)
    n_alleles[0] = a
    geno = (rand(n, 2 * l) * n_alleles.repeat(2)[None]).long()
    allele_valid = torch.arange(a, device="cuda")[None] < n_alleles[:, None]
    return Dataset(geno=geno.to(torch.int8), site_valid=rand(n, l) > 0.12,
                   allele_valid=allele_valid,
                   hom=geno[:, :l] == geno[:, l:])


def phase_edge_shapes() -> None:
    """Kernel against plain version at small ragged shapes: every
    instantiated K of the site pass, L not a multiple of 4 (unaligned
    Philox quads, byte loads), N not a multiple of the row strip, N above
    and below the S tail's 1024 lanes; every entry point of the site pass on
    the packed plane and on the generic path with A in {3, 5, 8} and a
    ragged number of alleles per locus; the A > 2 operands of
    ``allele_counts`` and of the P draw."""
    g = torch.Generator("cuda").manual_seed(12)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def simplex(*shape, mask=None):
        x = -torch.log(rand(*shape).clamp_min(1e-6))
        if mask is not None:
            x = x * mask
        return (x / x.sum(-1, keepdim=True)).contiguous()

    # K <= 8 (one body per K), then the run-time-K body at K = 9..32 with
    # K * A <= 64, whose rows' first half has three trailing zero-q columns
    # (the padded K grid's inactive slots)
    cases = [(1, 5, 7, 1, 3), (2, 33, 1025, 2, 5), (3, 70, 130, 3, 8),
             (2, 45, 1030, 4, 3), (1, 1100, 36, 5, 5), (2, 40, 37, 6, 8),
             (1, 64, 250, 7, 5), (2, 1500, 9, 8, 8), (4, 77, 1030, 3, 4),
             (2, 45, 1030, 9, 3), (1, 70, 131, 12, 5), (2, 33, 250, 16, 4),
             (3, 40, 37, 32, 2), (1, 1100, 36, 10, 6), (2, 33, 250, 17, 3),
             (1, 40, 37, 20, 3)]
    for c, n, l, k, a in cases:
        tag = f"edge shape C={c} N={n} L={l} K={k}"
        keys = px.make_keys(77, c, "cuda", chain_key=range(3, 3 + c))
        bits2 = torch.randint(0, 8, (n, l), generator=g, device="cuda",
                              dtype=torch.int8)
        q = simplex(c, n, k)
        zero_tail = 3 if k > fs.WIDE_POPS else 0
        if zero_tail:
            q[:, : n // 2, k - zero_tail:] = 0.0
            q = (q / q.sum(-1, keepdim=True)).contiguous()
        gen = torch.randint(1, 9, (c, n, 2), generator=g, device="cuda")
        wg_pair = torch.exp2(1.0 - gen.float()).contiguous()
        rates = (rand(c, k) * 0.9 + 0.05).contiguous()
        z = torch.randint(0, k, (c, n, 2 * l), generator=g, device="cuda",
                          dtype=torch.int8)
        packed, ragged = packed_dataset(bits2), ragged_dataset(g, n, l, a)
        for data in (packed, ragged):
            av = data.allele_valid.float()[None, None]
            x = dict(data=data, keys=keys, q=q, z=z, wg_pair=wg_pair,
                     freq=simplex(c, k, l, data.max_alleles, mask=av),
                     f_pop=(rand(c, k, 2) * 0.98 + 0.01).contiguous(),
                     f_ind=(rand(c, n, 2) * 0.98 + 0.01).contiguous(),
                     zero_tail=zero_tail)
            for structure in (True, False):
                check_site_entries(x, structure, timed=False,
                                   only=None if structure else EXP_WAY)
        for data in (packed, ragged):
            kw = dict(n_pops=k, max_alleles=data.max_alleles)
            want = fs.allele_counts_reference(z, data.geno, data.site_valid,
                                              **kw)
            for extra in ((dict(bits2=bits2), dict()) if data is packed
                          else (dict(),)):
                cnt = fs.allele_counts(z, data.geno, data.site_valid, **kw,
                                       **extra)
                if not torch.equal(cnt, want):
                    raise AssertionError(f"{tag}: allele_counts "
                                         f"(A = {data.max_alleles}) differs")
        kw = dict(subsweeps=3, delta0=0.05, gen_cap=50)
        gen1 = gen[:, :, 0].to(torch.int32).contiguous()
        mg = []
        if k <= sp.MAX_POPS:
            s_pop_agrees(f"{tag} s_pop_tail",
                         sp.s_pop_tail(keys, 2, q, gen1, rates, **kw),
                         sp.s_pop_tail_reference(keys, 2, q, gen1, rates,
                                                 **kw, margins=mg), mg)
        conc = (rand(c, n, k) * 5.0 + 0.05).contiguous()
        mg = []
        want = dk.dirichlet_nk_reference(keys, 2, conc, margins=mg)
        dirichlet_agrees(f"{tag} dirichlet_nk",
                         dk.dirichlet_nk(keys, 2, conc), want, mg[0], -1)
        for av in (rand(l, 2) > 0.1, ragged.allele_valid):
            counts = (rand(c, k, l, av.shape[1]) * 50.0 + 1.0).contiguous()
            mg = []
            want = dk.dirichlet_kla_reference(keys, 2, counts, av, margins=mg)
            got = dk.dirichlet_kla(keys, 2, counts, av)
            dirichlet_agrees(f"{tag} dirichlet_kla A={av.shape[1]}", got,
                             want, mg[0], -1)
            if bool((got[:, :, ~av] != 0).any()):
                raise AssertionError(f"{tag}: dirichlet_kla gives weight to "
                                     "a padded allele")
        # the tails' uniforms: four streams in one launch, bit for bit
        words = px.random_streams(keys, 2, px.STREAM_R_PROP, 4, 3 * n + 1)
        if not torch.equal(words.to(torch.int64) & 0xFFFFFFFF,
                           px.random_streams_reference(
                               keys, 2, px.STREAM_R_PROP, 4, 3 * n + 1)):
            raise AssertionError(f"{tag}: random_streams differs from its "
                                 "plain version")
    # K8 and the wide allele counts: K beyond the site pass, many alleles
    # with a ragged number per locus, every ploidy, N no multiple of the row
    # strips, L no multiple of 4, missing copies coded -1 on invalid sites
    zq_cases = [(2, 45, 37, 1, 3, 2), (2, 33, 1026, 9, 16, 2),
                (1, 70, 131, 20, 30, 2), (2, 19, 250, 9, 3, 1),
                (1, 50, 1025, 20, 16, 3), (2, 37, 66, 5, 30, 4),
                (2, 40, 38, 5, 16, 2)]
    # every edge of K8's pop buckets (K <= 8 each, 16, 32, then the generic
    # body) at A = 16, across the ploidies; the first half of the rows with
    # zero q in the trailing pops; and a tile of P too wide for a block
    zq_cases += [(2, 41, 259, kk, 16, 1 + i % 4) for i, kk in enumerate(
        (1, 4, 5, 8, 9, 16, 17, 32, 33, 50))]
    zq_cases += [(1, 30, 130, 16, 127, 2), (1, 30, 130, 3, 127, 3),
                 (1, 30, 130, 10, 44, 2)]
    for c, n, l, k, a, ploid in zq_cases:
        tag = f"edge shape C={c} N={n} L={l} K={k} A={a} ploidy={ploid}"
        keys = px.make_keys(78, c, "cuda", chain_key=range(5, 5 + c))
        n_alleles = 2 + (rand(l) * (a - 1)).long().clamp_max(a - 2)
        n_alleles[0] = a
        allele_valid = (torch.arange(a, device="cuda")[None]
                        < n_alleles[:, None])
        geno = (rand(n, ploid * l) * n_alleles.repeat(ploid)[None]).long()
        site_valid = rand(n, l) > 0.1
        geno = torch.where(site_valid.repeat(1, ploid), geno,
                           torch.full_like(geno, -1)).to(torch.int8)
        q = simplex(c, n, k)
        if k > 8:
            q[:, : n // 2, k - 3:] = 0.0
            q = (q / q.sum(-1, keepdim=True)).contiguous()
        freq = simplex(c, k, l, a, mask=allele_valid.float()[None, None])
        z, _ = zq_agrees(tag, keys, q, freq, geno, site_valid)
        zq_plan_agrees(tag, q, freq)
        zq_agrees(tag + " under injected uniforms", keys, q, freq, geno,
                  site_valid, u=rand(c, n, ploid * l).contiguous())
        if ploid == 2 and k * a > 64:
            kw = dict(n_pops=k, max_alleles=a)
            if not torch.equal(
                    fs.allele_counts(z, geno, site_valid, **kw),
                    fs.allele_counts_reference(z, geno, site_valid, **kw)):
                raise AssertionError(f"{tag}: allele_counts (wide) differs")
        if ploid == 2 and fs.site_pass_fits(k, a):
            data = Dataset(geno=geno, site_valid=site_valid,
                           allele_valid=allele_valid,
                           hom=geno[:, :l] == geno[:, l:])
            z1, qq1, _ = fs.zq_sample_pass(keys, 5, q, freq, data)
            if not torch.equal(z1, z):
                raise AssertionError(f"{tag}: K8 differs from the generic "
                                     "zq_sample_pass")
    emit("edge_shapes", cases=[dict(C=c, N=n, L=l, K=k, A=a)
                               for c, n, l, k, a in cases],
         zq_cases=[dict(C=c, N=n, L=l, K=k, A=a, ploidy=p)
                   for c, n, l, k, a, p in zq_cases], all_match=True)


def k3_edge_shapes() -> list:
    """K3 against its plain version (and bitwise against the parent's body,
    ``--parent-csrc``) where its schedule has edges: columns M and planes
    R*M not multiples of 4 or 32 (Philox blocks straddling tasks, rows and
    planes), J = 1, 2, 3 and 50 cells a group, C = 1 and 40 chains, a masked
    and a ragged P, Philox and injected uniforms; each shape's plan against
    the kernel's."""
    g = torch.Generator("cuda").manual_seed(13)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    cases = []
    for c, groups, j, m in [(1, 3, 1, 37), (40, 2, 2, 33), (2, 1, 50, 7),
                            (1, 5, 2, 1), (3, 2, 3, 65), (40, 1, 1, 31),
                            (1, 2, 50, 64), (2, 7, 2, 1030)]:
        tag = f"K3 edge rows C={c} groups={groups} J={j} M={m}"
        keys = px.make_keys(81, c, "cuda", chain_key=range(9, 9 + c))
        rows = rand(c, groups * j, m) * 30.0 + 0.05
        valid = rand(groups * j, m) > 0.1
        draws = (rand(c, dk.n_test_draws(), groups * j, m) * (1 - 2e-4)
                 + 1e-4)
        for inj in (None, draws):
            kw = dict(rows_per_group=j, test_draws=inj)
            run = lambda: dk.dirichlet_rows(keys, 3, px.STREAM_P, rows,
                                            valid, **kw)
            got = run()
            margins = []
            want = dk.dirichlet_rows_reference(keys, 3, px.STREAM_P, rows,
                                               valid, margins=margins, **kw)
            shape = (c, groups, j, m)
            dirichlet_agrees(tag, got.reshape(shape), want.reshape(shape),
                             margins[0].reshape(shape), 2)
            if bool((got[:, ~valid] != 0).any()):
                raise AssertionError(f"{tag}: masked cells are not zero")
            parent_k3k4(run, got, tag)
        k3_plan_agrees(tag, c, groups, j, m)
        cases.append(dict(C=c, groups=groups, J=j, M=m))
    for c, n, k in [(1, 37, 50), (40, 33, 50), (40, 1, 3), (1, 1025, 10)]:
        tag = f"K3 edge Q C={c} N={n} K={k}"
        keys = px.make_keys(82, c, "cuda", chain_key=range(2, 2 + c))
        conc = (rand(c, n, k) * 5.0 + 0.05).contiguous()
        draws = (rand(c, dk.n_test_draws(), k, n) * (1 - 2e-4) + 1e-4)
        for inj in (None, draws):
            run = lambda: dk.dirichlet_nk(keys, 4, conc, test_draws=inj)
            got = run()
            mg = []
            want = dk.dirichlet_nk_reference(keys, 4, conc, test_draws=inj,
                                             margins=mg)
            dirichlet_agrees(tag, got, want, mg[0], -1)
            parent_k3k4(run, got, tag)
        k3_plan_agrees(tag, c, 1, k, n)
        cases.append(dict(C=c, N=n, K=k))
    for c, k, l, a in [(1, 3, 33, 3), (40, 2, 7, 5), (2, 1, 1, 127)]:
        tag = f"K3 edge P C={c} K={k} L={l} A={a}"
        keys = px.make_keys(83, c, "cuda")
        counts = (rand(c, k, l, a) * 40.0 + 1.0).contiguous()
        av = rand(l, a) > 0.2
        av[:, 0] = True
        run = lambda: dk.dirichlet_kla(keys, 6, counts, av)
        got = run()
        mg = []
        want = dk.dirichlet_kla_reference(keys, 6, counts, av, margins=mg)
        dirichlet_agrees(tag, got, want, mg[0], -1)
        parent_k3k4(run, got, tag)
        k3_plan_agrees(tag, c, k, a, l)
        cases.append(dict(C=c, K=k, L=l, A=a))
    return cases


def k4_edge_shapes() -> list:
    """K4 exactly against its plain version at every edge of its bodies:
    the packed body's pop buckets (K = 4/5, 8/9, 16/17, 32 at A = 2; 33
    leaves it), the codes body's 8 cells (8/9), the table's windows (one
    pop of 127 alleles), on the packed plane and on the allele codes, with
    shared and per-chain planes, N not a multiple of a strip nor of the
    warps' rows, L not a multiple of 4 (byte loads) or of a tile, corrupted
    z and missing codes dropped; each plan against the kernel's."""
    g = torch.Generator("cuda").manual_seed(14)
    cases = []
    for k, a in [(4, 2), (5, 2), (8, 2), (9, 2), (16, 2), (17, 2), (32, 2),
                 (33, 2), (8, 1), (9, 1), (3, 3), (4, 8), (11, 3), (16, 4),
                 (13, 5), (9, 127)]:
        for c, n, l in [(2, 259, 131), (3, 1013, 132), (1, 5, 3)]:
            tag = f"K4 edge C={c} N={n} L={l} K={k} A={a}"
            kw = dict(n_pops=k, max_alleles=a)
            z = torch.randint(-1, k + 1, (c, n, 2 * l), generator=g,
                              device="cuda", dtype=torch.int8)
            valid = torch.rand((n, l), generator=g, device="cuda") > 0.1
            geno = torch.randint(-1, a, (n, 2 * l), generator=g,
                                 device="cuda", dtype=torch.int8)
            per_chain = torch.randint(0, a, (c, n, 2 * l), generator=g,
                                      device="cuda", dtype=torch.int8)
            for gg in (geno, per_chain):
                if not torch.equal(
                        fs.allele_counts(z, gg, valid, **kw),
                        fs.allele_counts_reference(z, gg, valid, **kw)):
                    raise AssertionError(f"{tag}: counts differ (geno "
                                         f"{tuple(gg.shape)})")
            if a == 2 and k * a <= 64:
                # the packed plane, shared or one a chain (the valid bit
                # shared: site_valid is), and its allele codes
                vbit = valid.to(torch.int8) << 2
                for planes in ((n, l), (c, n, l)):
                    bits2 = torch.randint(0, 4, planes, generator=g,
                                          device="cuda",
                                          dtype=torch.int8) | vbit
                    gp = torch.cat([bits2 & 1, (bits2 >> 1) & 1], dim=-1)
                    got = fs.allele_counts(z, gp, valid, **kw, bits2=bits2)
                    if not torch.equal(got, fs.allele_counts_reference(
                            z, gp, valid, **kw)):
                        raise AssertionError(f"{tag}: counts on the packed "
                                             f"plane {planes} differ")
                k4_plan_agrees(tag, c, n, l, k, a, packed=True)
            k4_plan_agrees(tag, c, n, l, k, a)
            cases.append(dict(C=c, N=n, L=l, K=k, A=a))
    return cases


def check_wide_site_entries(panel, panel_a4, variants) -> list:
    """The site pass's run-time-K body (8 < K <= 32, K*A <= 64) against its
    plain version, half of each chain's rows with three trailing zero-q
    columns: every entry point at K = 12 on the headline panel and at
    K = 16 on the A = 4 panel (the shapes phase modes drives), but mode 2's
    two passes at the K grid's shape (40 chains, K = 10; the plain version
    four chains at a time), which the kselect phase drives.  Variants:
    K = 12's mode-2 passes and expectation way, every entry point at K = 9
    and 32 on the headline panel, and mode 2's passes on the generic path
    at A = 2 (the headline panel without its packed plane) at K = 9, 12,
    32; untimed, every entry point at the pop buckets' edge (K = 16 and 17
    on the headline panel, K = 17 on an A = 3 panel)."""
    grid_passes = ("site_pass_gendiff", "site_pass_loglik")
    main = []
    x = kernel_inputs(panel, WIDE_K, zero_tail=3)
    for e in check_site_entries(x):
        (variants if e["name"].replace("_wide", "") in grid_passes
         else main).append(e)
    variants += check_site_entries(x, structure=False, only=EXP_WAY)
    del x
    torch.cuda.empty_cache()
    x = kernel_inputs(panel, KSEL_MAX, c=KSEL_CHAINS * KSEL_MAX,
                      zero_tail=3)
    main += check_site_entries(x, only=grid_passes, plain_group=N_CHAINS)
    del x
    torch.cuda.empty_cache()
    main += check_site_entries(kernel_inputs(panel_a4, GEN16_K,
                                             zero_tail=3))
    torch.cuda.empty_cache()
    for k in (9, 32):
        variants += check_site_entries(kernel_inputs(panel, k, zero_tail=3))
        torch.cuda.empty_cache()
    for k in (9, WIDE_K, 32):
        x = kernel_inputs(panel, k, zero_tail=3)
        x["data"] = x["data"]._replace(bits2=None)
        variants += check_site_entries(x, only=grid_passes)
        del x
        torch.cuda.empty_cache()
    panel_a3 = synthetic_panel(N_INDV, GEN_LOCI, n_pops=N_POPS, n_alleles=3,
                               selfing_rates=np.array([0.1, 0.4, 0.8]),
                               admixture_alpha=0.1, seed=PANEL_SEED)
    for pnl, k in ((panel, 16), (panel, 17), (panel_a3, 17)):
        variants += check_site_entries(kernel_inputs(pnl, k, zero_tail=3),
                                       timed=False)
        torch.cuda.empty_cache()
    return main


def phase_kernels(panel, panel_a, panel_a4, panel_w, philox_entry,
                  tetra_panels):
    """Entries by kernel name at the main paths' variant (structure way);
    the expectation-way runs of the site pass (and K6 on the auto panel)
    are reported as variants."""
    x = kernel_inputs(panel)
    main = [philox_entry, check_allele_counts(x), *check_site_entries(x),
            check_s_pop_tail(x), *check_dirichlet(x)]
    variants = check_site_entries(x, structure=False, only=EXP_WAY)
    # K8 at the headline panel through the allele codes: also the generic
    # site pass's z from the same keys
    d = x["data"]
    main.append(check_zq_sample_counts(
        "zq_sample_counts_headline", x["keys"], x["q"], x["freq"], d.geno,
        d.site_valid, k1_data=d))
    del x, d
    torch.cuda.empty_cache()
    xw = kernel_inputs(panel_w, WIDE_POPS)
    dw = xw["data"]
    # K * A = 80: beyond the site pass, so no generic-pass cross-check
    main.append(check_zq_sample_counts(
        "zq_sample_counts", xw["keys"], xw["q"], xw["freq"], dw.geno,
        dw.site_valid))
    main.append(check_allele_counts(xw))
    del xw, dw
    main.append(check_zq_sample_counts("zq_sample_counts_ploidy4",
                                       *ploidy4_inputs()))
    torch.cuda.empty_cache()
    xa = kernel_inputs(panel_a)
    # K4 at A = 8 (the per-sweep recount of the generic path), beside its
    # library call
    a8 = check_allele_counts(xa)
    main[1].update(ms_a8=a8["ms"], plain_ms_a8=a8["plain_ms"],
                   bound_ms_a8=a8["bound_ms"],
                   library_ms_a8=a8["library_ms"])
    main += check_site_entries(xa)
    variants += check_site_entries(xa, structure=False, only=EXP_WAY)
    del xa
    torch.cuda.empty_cache()
    main += check_wide_site_entries(panel, panel_a4, variants)
    phase_edge_shapes()
    emit("k3_k4_edge_shapes", k3=k3_edge_shapes(), k4=k4_edge_shapes(),
         parent_bitwise="threads" in PARENT, all_match=True)
    torch.cuda.empty_cache()
    check_k3_shapes()
    check_k4_shapes()
    torch.cuda.empty_cache()
    main += check_tetra_kernels(tetra_panels)
    variants += tetra_variants
    emit("kernels", shapes=dict(C=N_CHAINS, N=N_INDV, L=N_LOCI, K=N_POPS,
                                A=2, J=SUBSWEEPS),
         generic_shapes=dict(C=N_CHAINS, N=N_INDV, L=GEN_LOCI, K=N_POPS,
                             A=GEN_ALLELES),
         wide_shapes=dict(C=N_CHAINS, N=N_INDV, L=WIDE_LOCI, K=WIDE_POPS,
                          A=WIDE_ALLELES),
         site_wide_shapes=dict(
             packed=dict(C=N_CHAINS, N=N_INDV, L=N_LOCI, K=WIDE_K, A=2),
             grid=dict(C=KSEL_CHAINS * KSEL_MAX, N=N_INDV, L=N_LOCI,
                       K=KSEL_MAX, A=2),
             generic=dict(C=N_CHAINS, N=N_INDV, L=GEN_LOCI, K=GEN16_K,
                          A=GEN16_ALLELES)),
         tetra_shapes=dict(C=N_CHAINS, N=TETRA_INDV, L=TETRA_LOCI, K=N_POPS,
                           A=TETRA_ALLELES),
         kernels=main, variants=variants)
    return {e["name"]: e for e in main}


# ---------------------------------------------------------------------------
# phases 5 and 6: the main path (mode 2, packed panel) and the other paths
# ---------------------------------------------------------------------------

# the sampling and the stored-step entry point of each mode's sweep
MODE_PASSES = {1: ("site_pass_sample", "site_pass_loglik_mode1"),
               2: ("site_pass_gendiff", "site_pass_loglik"),
               3: ("site_pass_gendiff", "site_pass_loglik"),
               4: ("site_pass_fpop", "site_pass_loglik_fpop"),
               5: ("site_pass_find", "site_pass_loglik_find")}


def small_agreement(mode: int, n_alleles: int, active=None,
                    **spec_kw) -> dict:
    """The port on the card against the port on the CPU (plain versions),
    same seed, a small panel, a few sweeps: the discrete state must agree
    exactly and the floats to f32 rounding.  ``active`` [C, K] runs the
    padded K grid's replicas (K = its width)."""
    panel = synthetic_panel(40, 120, n_pops=3, n_alleles=n_alleles,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, missing_rate=0.1, seed=3)
    c = 2 if active is None else active.shape[0]
    spec_kw.setdefault("n_pops", 3 if active is None else active.shape[1])
    spec = ModelSpec(mode=mode, s_subsweeps=4, **spec_kw)
    out = {}
    for dev in ("cpu", "cuda"):
        data = panel.data.to(dev)
        keys = px.make_keys(11, c, dev)
        # one initial state for both devices: drawn on the CPU
        state = init_state(11, spec, panel.data, n_chains=c, device="cpu",
                           active=active)
        state = state.to(dev)
        step, add_loglik = build_step_parts(spec, data)
        for i in range(3):
            state = step(state, keys, i)
        out[dev] = add_loglik(state)
    a, b = out["cpu"], out["cuda"]
    tag = f"small agreement (mode {mode}, A = {n_alleles}, {spec_kw})"
    for name in ("z", "zz", "gen", "ais_state"):
        if not torch.equal(getattr(a, name), getattr(b, name).cpu()):
            raise AssertionError(f"{tag}: {name} differs between the card "
                                 "and the CPU reference")
    errs = {}
    for name, tol in (("q", 1e-4), ("freq", 1e-4), ("rates", 1e-5),
                      ("alpha", 1e-5), ("prior_mu", 1e-5),
                      ("prior_sigma2", 1e-5), ("loglik_indv", 1e-2)):
        x, y = getattr(a, name), getattr(b, name).cpu()
        errs[name] = max_err(x, y) if x.numel() else 0.0
        if errs[name] > tol:
            raise AssertionError(f"{tag}: {name} differs by "
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


PROFILE_WINDOWS = profiling.WINDOWS  # windows tried before a profile fails


def _profile_window(step, state, keys, i0: int, n_prof: int):
    """One profiled window of ``n_prof`` sweeps behind one warm-up sweep
    (the profiler's own warm-up step: the events of the first sweep after
    it turns device tracing on can be lost).  Returns (state, kernel rows
    (name, device us, events), the wrappers' launches in the window)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_prof,
                                   repeat=1)) as prof:
        state = step(state, keys, i0)
        torch.cuda.synchronize()
        prof.step()
        before = collections.Counter(_build.launches)
        for i in range(n_prof):
            state = step(state, keys, i0 + 1 + i)
            if i == n_prof - 1:
                torch.cuda.synchronize()
            prof.step()
        host = collections.Counter(_build.launches)
        host.subtract(before)
    rows = []
    for ev in prof.key_averages():
        # the schedule's ProfilerStep# spans cover the step's kernels on the
        # device: a range, not a kernel, so they are left out of the sums
        if ev.key.startswith("ProfilerStep") or (
                getattr(ev, "device_type", None) is not None
                and "cuda" not in str(ev.device_type).lower()):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    return state, rows, host


def sweep_profile(data, spec, n_steps: int = 100, n_prof: int = 30,
                  active=None) -> dict:
    """Where a sweep's time goes: host wall time per sweep of the bare step
    loop, and the device time of the kernels in it from ``torch.profiler``
    (summed by kernel name).  The sweeps a trace holds are counted by an
    anchor, the Dirichlet kernel: every sweep launches it a fixed number of
    times, and the wrappers' counters say how many launches the window
    made.  A window whose trace holds fewer Dirichlet events than that, or
    fewer ``allele_counts`` kernels than its wrappers launched, lost events:
    it is reported and another is profiled, up to ``PROFILE_WINDOWS``.  Every per-sweep number is over the sweeps the
    trace holds.  Device numbers are ``None`` where the profiler shows no
    device time.  ``active`` [C, K] profiles the padded K grid's C
    replicas."""
    c = N_CHAINS if active is None else active.shape[0]
    keys = px.make_keys(RUN_SEED, c, "cuda")
    state = init_state(RUN_SEED, spec, data, n_chains=c, device="cuda",
                       active=active)
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
    lost = []
    for w in range(PROFILE_WINDOWS):
        try:
            state, rows, host = _profile_window(
                step, state, keys, 200 + w * (n_prof + 1), n_prof)
        except RuntimeError as e:
            # the profiler is a measurement aid: where device tracing is
            # not available the device numbers stay None
            out["profiler_error"] = str(e)[:200]
            return out
        if not rows:
            return out
        anchor_host = host["dirichlet_kla"] + host["dirichlet_nk"]
        anchor = sum(r[2] for r in rows if "dirichlet_kernel" in r[0])
        # K4's kernels in the trace, against its wrappers' launches
        k4_host = host["allele_counts"] + host["allele_counts_wide"]
        k4_dev = sum(r[2] for r in rows if "allele_counts" in r[0])
        if anchor == anchor_host and k4_dev == k4_host:
            break
        lost.append(dict(dirichlet_events=anchor,
                         dirichlet_launches=anchor_host,
                         allele_counts_events=k4_dev,
                         allele_counts_launches=k4_host))
    out.update(profiled_sweeps=n_prof, profile_windows_lost=lost,
               profile_complete=anchor == anchor_host and k4_dev == k4_host)
    if not out["profile_complete"]:
        return out
    sweeps = n_prof * anchor // anchor_host
    site_host = sum(v for name, v in host.items()
                    if name.startswith("site_pass"))
    out.update(sweeps_observed=sweeps,
               s_delta_launches_per_sweep=host["s_delta_pass"] / sweeps,
               s_delta_device_launches_per_sweep=sum(
                   r[2] for r in rows if "s_delta" in r[0]) / sweeps,
               site_pass_launches_per_sweep=site_host / sweeps,
               site_pass_device_launches_per_sweep=sum(
                   r[2] for r in rows if "site_kernel" in r[0]) / sweeps,
               memset_launches_per_sweep=sum(
                   r[2] for r in rows if "memset" in r[0].lower()) / sweeps)
    rows = sorted(((k, us / sweeps / 1e3, cnt / sweeps)
                   for k, us, cnt in rows), key=lambda r: -r[1])
    # K3 and K4 in the sweep (device ms and launches a sweep)
    out["k3_k4_in_sweep"] = {
        name: dict(ms_per_sweep=sum(r[1] for r in rows if pat in r[0]),
                   launches_per_sweep=sum(r[2] for r in rows
                                          if pat in r[0]))
        for name, pat in (("dirichlet", "dirichlet_kernel"),
                          ("allele_counts", "allele_counts"))}
    busy = sum(r[1] for r in rows)
    out.update(device_ms_per_sweep=busy,
               device_idle_share=max(0.0, 1.0 - busy / out[
                   "wall_ms_per_sweep"]),
               # the 8 longest, and every hand-written kernel of the sweep
               top_kernels=[dict(name=k[:60], ms_per_sweep=round(ms, 5),
                                 launches_per_sweep=round(cnt, 2))
                            for i, (k, ms, cnt) in enumerate(rows)
                            if i < 8 or "(anonymous namespace)" in k],
               device_kernel_launches_per_sweep=round(
                   sum(r[2] for r in rows), 1))
    return out


def check_one_site_launch(tag, prof, fused, counts_each_sweep=False) -> None:
    """A fused sweep calls the site pass once, and that call is one kernel
    launch on the device: in a profiled window whose trace holds every
    sweep (the Dirichlet anchor of ``sweep_profile``), exactly as many
    site-pass kernels as sweeps.  Every diploid sampling pass carries its
    counts, so nothing else in the sweep memsets (K4 and K8, which do, run
    only at the start): no memset shows either, unless the sweep counts
    with K4 each time (``counts_each_sweep``: the tetraploid P update).  A
    profile in which every window lost events fails."""
    if not fused or "profiler_error" in prof or \
            prof.get("profile_complete") is None:
        return
    if not prof["profile_complete"]:
        raise AssertionError(f"{tag}: every profiled window lost events "
                             f"{prof['profile_windows_lost']}")
    host = prof["site_pass_launches_per_sweep"]
    dev = prof["site_pass_device_launches_per_sweep"]
    memsets = prof["memset_launches_per_sweep"]
    if host != 1 or dev != 1 or (memsets and not counts_each_sweep):
        raise AssertionError(f"{tag}: the site pass made {host} calls and "
                             f"{dev} kernel launches, and the sweep "
                             f"{memsets} memsets per sweep")


def check_one_s_delta_launch(tag, prof, subsweeps: int) -> None:
    """A tetraploid sweep calls K6 once per S subsweep, and each call is one
    kernel launch on the device (no second reduce kernel): in a profiled
    window whose trace holds every sweep, as many K6 kernels as calls."""
    if "profiler_error" in prof or not prof.get("profile_complete"):
        return
    host = prof["s_delta_launches_per_sweep"]
    dev = prof["s_delta_device_launches_per_sweep"]
    if host != subsweeps or dev != host:
        raise AssertionError(f"{tag}: K6 made {host} calls and {dev} device "
                             f"launches a sweep, {subsweeps} expected")


def expected_launches(spec, data, steps, evals, attempts) -> dict:
    """Launches per kernel that ``run_mcmc``'s schedule predicts: ``steps``
    sweeps, ``evals`` stored-step log-lik passes, ``attempts`` initial
    states."""
    mode, fused = spec.mode, use_fused(spec, data)
    adaptive = spec.back_refl != 1 and mode in (2, 4)
    counts = ("allele_counts" if spec.n_pops * data.max_alleles <= 64
              else "allele_counts_wide")
    # one fill for the alpha step's words; one for the uniforms of the
    # S/F/G updates that are plain tensor code (or mode 0's z draw)
    # mode 2's S tail is the K2 kernel under back-reflection at K <= 8
    # (the JAX gate), else plain tensor code
    s_kernel = mode == 2 and not adaptive and spec.n_pops <= sp.MAX_POPS
    if fused:
        tail = mode in (3, 4, 5) or (mode == 2 and not s_kernel)
    else:
        tail = mode != 1
    want = {"dirichlet_kla": steps,
            "philox_words": steps * (int(mode != 0) + int(tail))}
    if mode != 0:
        want["dirichlet_nk"] = steps
    if fused:
        sampling, stored = MODE_PASSES[mode]
        k = spec.n_pops
        want.update({fs.site_counter(sampling, data, k): steps,
                     fs.site_counter(stored, data, k): evals,
                     # seeds zcounts; every sampling pass carries them on
                     counts: attempts})
        if s_kernel:
            want["s_pop_tail"] = steps
    elif mode != 0:
        # the P update counts from z each sweep; the stored-step log-lik
        # is plain tensor code
        want.update({"zq_sample_counts": steps, counts: attempts + steps})
    return want


def drive_path(tag, panel, spec, n_iter, smi, profile_sweeps=100,
               n_prof=30) -> dict:
    """Drive ``run_mcmc`` once with the launch counts set to 0 just before
    and read just after; check the counts against the schedule, the output,
    and that a second run from the seed is bitwise equal.  Returns the
    launches by kernel."""
    stored = n_iter // 2 // 10
    sched = Schedule(n_iter=n_iter, burnin=n_iter // 2, thinning=10,
                     n_chains=N_CHAINS, ckrep=min(20, stored),
                     nstep_check_empty_cluster=min(20, stored))
    data = panel.data.to("cuda")
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    k, mode = spec.n_pops, spec.mode

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    res = run_mcmc(panel.data, spec, sched, RUN_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: int(cnt) for name, cnt in _build.launches.items()}

    attempts = 1 + res.n_retries
    steps = n_iter * attempts
    last_extra = 0 if (n_iter - sched.burnin) % sched.thinning == 0 else 1
    want = expected_launches(spec, data, steps,
                             (sched.n_stored + last_extra) * attempts,
                             attempts)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, the schedule "
                             f"predicts {want}")

    st, acc = res.final_state, res.accum
    r = spec.n_rates(n)
    admix = spec.has_admixture
    fused = use_fused(spec, data)
    checks = {
        "loglik finite": bool(torch.isfinite(st.loglik_indv).all()
                              and torch.isfinite(acc.mean.total_ll).all()
                              and torch.isfinite(acc.mean.ll_marg).all()),
        "rates in [0,1]": bool(((st.rates >= 0) & (st.rates <= 1)).all()
                               and ((acc.mean.rates >= 0)
                                    & (acc.mean.rates <= 1)).all()),
        "Q rows sum to 1": bool(torch.allclose(
            st.q.sum(-1), torch.ones_like(st.q.sum(-1)), atol=1e-4)),
        "freq rows sum to 1": bool(torch.allclose(
            st.freq.sum(-1), torch.ones_like(st.freq.sum(-1)), atol=1e-4)),
        "shapes": (tuple(st.z.shape) == (
                       (N_CHAINS, n, 2 * l) if admix else (N_CHAINS, 0, 0))
                   and tuple(st.q.shape) == (
                       (N_CHAINS, n, k) if admix else (N_CHAINS, 0, 0))
                   and tuple(st.zz.shape) == (N_CHAINS, 0 if admix else n)
                   and tuple(acc.mean.q.shape) == (N_CHAINS, n, k)
                   and tuple(st.freq.shape) == (N_CHAINS, k, l, a)
                   and tuple(acc.mean.rates.shape) == (N_CHAINS, r)
                   and tuple(st.gen.shape) == (
                       N_CHAINS, n if spec.has_selfing else 0)),
        "stored count": bool((acc.count == sched.n_stored).all()),
        # the fused sweep carries the counts of its z; the unfused recounts
        "zcounts carried": not fused or bool(torch.equal(
            st.zcounts, fs.allele_counts_reference(
                st.z, data.geno, data.site_valid, n_pops=k,
                max_alleles=a))),
        "labels in range": bool(
            (st.z if admix else st.zz).min() >= 0
            and (st.z if admix else st.zz).max() < k),
        "mean Q rows sum to 1": bool(torch.allclose(
            acc.mean.q.sum(-1), torch.ones_like(acc.mean.q.sum(-1)),
            atol=1e-4)),
        "retries not exhausted": res.n_retries < 10,
        "dic finite": bool(np.isfinite(res.dic()).all()),
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{tag}: failed checks {bad}")

    res2 = run_mcmc(panel.data, spec, sched, RUN_SEED, device="cuda")
    same = (torch.equal(res.final_state.z, res2.final_state.z)
            and torch.equal(res.final_state.zz, res2.final_state.zz)
            and torch.equal(res.final_state.freq, res2.final_state.freq)
            and torch.equal(res.final_state.prior_mu,
                            res2.final_state.prior_mu)
            and torch.equal(res.final_state.rates, res2.final_state.rates)
            and torch.equal(res.final_state.gen, res2.final_state.gen)
            and torch.equal(res.accum.mean.rates, res2.accum.mean.rates)
            and torch.equal(res.accum.mean.total_ll,
                            res2.accum.mean.total_ll))
    if r:
        same = same and torch.equal(rates_trajectory(data, spec, 60),
                                    rates_trajectory(data, spec, 60))
    if not same:
        raise AssertionError(f"{tag}: two runs from one seed are not "
                             "bitwise equal")
    if profile_sweeps:
        prof = sweep_profile(data, spec, profile_sweeps, n_prof)
        emit("sweep_profile", path=tag, card=smi, **prof)
        check_one_site_launch(tag, prof, fused)
    mean_rates = acc.mean.rates.cpu()
    emit(tag.split(":")[0], path=tag, card=smi, mode=mode,
         panel=dict(N=n, L=l, A=a, K=k, packed=fs.is_packed(data)),
         sweep="fused" if fused else "unfused", steps=steps,
         chains=N_CHAINS, n_retries=res.n_retries,
         wall_seconds=round(wall, 3),
         chain_steps_per_second=round(N_CHAINS * steps / wall, 1),
         ms_per_step=round(1e3 * wall / steps, 4), launches=launches,
         # per pop, or the mean over individuals where S/F is per individual
         mean_rates=[[round(float(v), 4) for v in
                      (row if r == k else row.mean(0, keepdim=True))]
                     for row in mean_rates if r],
         checks=sorted(checks), bitwise_reproducible=True)
    return launches


def phase_main_path(panel, smi: str) -> dict:
    agreement = small_agreement(2, 2)
    emit("small_agreement", mode=2, A=2, max_abs_err=agreement)
    spec = ModelSpec(mode=2, n_pops=N_POPS, s_subsweeps=SUBSWEEPS)
    return drive_path("main_path: mode 2, packed panel", panel, spec, N_ITER,
                      smi)


def direct_calls(x, tag) -> None:
    """The two entry points that no sweep runs, called as a user would and
    held to the identities that define them: ``zq_gendiff_pass`` is the
    column difference of ``zq_gen_pass`` (same z), and ``zq_mode1_pass``'s
    log-lik is ``panel_loglik_mode1_pass`` at the z it drew."""
    d, keys = x["data"], x["keys"]
    scale = d.n_loci / 10_000
    for structure in (True, False):
        args = (keys, 8, x["q"], x["freq"], d, x["wg_pair"])
        z, qq, ll2, _ = fs.zq_gen_pass(*args, structure=structure)
        zd, qqd, lld, _ = fs.zq_gendiff_pass(*args, structure=structure)
        if not (torch.equal(z, zd) and torch.equal(qq, qqd)):
            raise AssertionError(f"{tag}: zq_gen_pass and zq_gendiff_pass "
                                 "draw different z from one seed")
        # a difference of two sums of ~L logs against one sum of ratios
        check_close(f"{tag} gendiff == gen[1] - gen[0] (structure="
                    f"{structure})", lld, ll2[:, :, 1] - ll2[:, :, 0],
                    rtol=1e-4, atol=5e-2 * scale)
    z, _, ll, _ = fs.zq_mode1_pass(keys, 8, x["q"], x["freq"], d)
    check_close(f"{tag} zq_mode1_pass ll == panel_loglik_mode1_pass at its "
                "z", ll, fs.panel_loglik_mode1_pass(x["freq"], None, d, z),
                rtol=1e-5, atol=1e-2 * scale)


def phase_modes(panel, panel_a, panel_a4, smi: str) -> dict:
    """The other paths: modes 1, 3, 4, 5 on the headline panel, every mode
    on the A = 8 panel (mode 2 at the main path's depth, the others
    shorter), the site pass's run-time-K body (modes 2, 1, 4, 5 at K = 12
    on the headline panel and at K = 16 on the A = 4 panel, shorter), and
    the direct calls.  Returns launches by kernel, each from the path that
    runs it."""
    launches = {}
    agreement = {}
    for a in (2, 4):
        for mode in (1, 2, 3, 4, 5):
            if (mode, a) != (2, 2):            # the main path's own check
                agreement[f"mode {mode}, A={a}"] = small_agreement(mode, a)
    emit("small_agreement", sweeps=3, max_abs_err=agreement)
    for mode in (1, 3, 4, 5):
        spec = ModelSpec(mode=mode, n_pops=N_POPS, s_subsweeps=SUBSWEEPS)
        got = drive_path(f"modes: mode {mode}, packed panel", panel, spec,
                         N_ITER, smi)
        launches.update({name: n for name, n in got.items()
                         if name in MODE_PASSES[mode]})
    for mode in (2, 1, 3, 4, 5):
        spec = ModelSpec(mode=mode, n_pops=N_POPS, s_subsweeps=SUBSWEEPS)
        got = drive_path(f"modes: mode {mode}, A = {GEN_ALLELES} panel",
                         panel_a, spec, N_ITER if mode == 2 else 40, smi,
                         profile_sweeps=100 if mode == 2 else 0)
        # mode 2 runs first and deepest: its counts stand for the passes
        # that mode 3 shares with it
        for name, n in got.items():
            if name.endswith("_generic"):
                launches.setdefault(name, n)
    # K > 8: mode 2 at K = 12 ran unfused before the run-time-K body; mode 3
    # shares mode 2's passes
    for pnl, k, what in ((panel, WIDE_K, "packed panel"),
                         (panel_a4, GEN16_K, f"A = {GEN16_ALLELES} panel")):
        for mode in (2, 1, 4, 5):
            got = drive_path(f"modes: mode {mode}, K = {k}, {what}", pnl,
                             ModelSpec(mode=mode, n_pops=k,
                                       s_subsweeps=SUBSWEEPS),
                             UNFUSED_ITER, smi,
                             profile_sweeps=30 if mode == 2 else 0, n_prof=10)
            for name, n in got.items():
                if name.endswith("_wide"):
                    launches.setdefault(name, n)
    _build.reset_launches()
    for pnl, k, tag in ((panel, N_POPS, "direct calls, packed panel"),
                        (panel_a, N_POPS,
                         f"direct calls, A = {GEN_ALLELES} panel"),
                        (panel, WIDE_K, f"direct calls, K = {WIDE_K}"),
                        (panel_a4, GEN16_K,
                         f"direct calls, K = {GEN16_K}, A = {GEN16_ALLELES}")):
        direct_calls(kernel_inputs(pnl, k), tag)
        torch.cuda.empty_cache()
    emit("direct_calls", launches=dict(_build.launches),
         identities=["gendiff == gen[1] - gen[0]",
                     "mode1 ll == loglik_mode1 at the fresh z"])
    launches.update({name: int(n) for name, n in _build.launches.items()
                     if name.replace("_generic", "").replace("_wide", "")
                     in ("site_pass_gen", "site_pass_mode1")})
    return launches


def phase_unfused(panel, panel_w, smi: str) -> dict:
    """The unfused sweep (P, then S or F, then G, then Z and Q through K8)
    at full width -- mode 2 on the wide panel, whose K*A = 80 the fused sweep
    cannot run -- and, shorter: modes 1, 3, 4, 5 on that panel, mode 0 and
    ``use_pallas=False`` on the headline panel; then the arms of
    the fused sweep that run plain updates in place of a kernel or beside it
    (the normal prior, the adaptive-independence proposal).  Returns
    launches by kernel entry, each from the path that runs it."""
    agreement = {}
    for a in (2, 4):
        for mode in (0, 1, 2, 3, 4, 5):
            agreement[f"unfused mode {mode}, A={a}"] = small_agreement(
                mode, a, use_pallas=False)
    normal = Priors(family=PriorFamily.NORMAL)
    arms = ((3, dict(priors=normal), "the normal prior"),
            (5, dict(priors=normal), "the normal prior"),
            (2, dict(back_refl=0), "back_refl=0"),
            (4, dict(back_refl=0), "back_refl=0"))
    for mode, kw, what in arms:
        for sweep in (None, False):
            agreement[f"mode {mode}, {what}, use_pallas={sweep}"] = \
                small_agreement(mode, 2, use_pallas=sweep, **kw)
    emit("small_agreement", sweeps=3, max_abs_err=agreement)

    short = dict(n_iter=UNFUSED_ITER, smi=smi, profile_sweeps=30, n_prof=10)
    launches = {}
    got = drive_path("unfused: mode 2, wide panel (K*A = 80)", panel_w,
                     ModelSpec(mode=2, n_pops=WIDE_POPS,
                               s_subsweeps=SUBSWEEPS), N_ITER, smi,
                     profile_sweeps=50)
    launches.update({name: got[name] for name in ("zq_sample_counts",
                                                  "allele_counts_wide")})
    for mode in (1, 3, 4, 5):
        drive_path(f"unfused: mode {mode}, wide panel", panel_w,
                   ModelSpec(mode=mode, n_pops=WIDE_POPS,
                             s_subsweeps=SUBSWEEPS), **short)
    drive_path("unfused: mode 0, headline panel", panel,
               ModelSpec(mode=0, n_pops=N_POPS), N_ITER, smi,
               profile_sweeps=30, n_prof=10)
    got = drive_path("unfused: mode 2, headline panel, use_pallas=False",
                     panel, ModelSpec(mode=2, n_pops=N_POPS,
                                      s_subsweeps=SUBSWEEPS,
                                      use_pallas=False), **short)
    launches["zq_sample_counts_headline"] = got["zq_sample_counts"]
    for mode, kw, what in arms:
        drive_path(f"unfused: the fused sweep with {what}, mode {mode}",
                   panel, ModelSpec(mode=mode, n_pops=N_POPS,
                                    s_subsweeps=SUBSWEEPS, **kw), **short)
    # no sweep runs a ploidy-4 panel yet: K8 called as a user would, held to
    # what defines its counts
    _build.reset_launches()
    keys, q, freq, geno, site_valid = ploidy4_inputs()
    z, qqnum = zqk.zq_sample_counts(keys, 8, q, freq, geno, site_valid,
                                    n_pops=N_POPS)
    valid = site_valid.repeat(1, 4)[None]
    want = torch.stack([(valid & (z == kk)).sum(dim=2) for kk in
                        range(N_POPS)], dim=2).to(torch.float32)
    if not torch.equal(qqnum, want):
        raise AssertionError("direct call, ploidy 4: qqnum is not the count "
                             "of the valid copies of z per pop")
    emit("direct_calls", launches=dict(_build.launches),
         identities=["ploidy 4: qqnum == counts of the returned z"])
    launches["zq_sample_counts_ploidy4"] = int(
        _build.launches["zq_sample_counts"])
    return launches


# ---------------------------------------------------------------------------
# phase 8: K selection (the padded chain x K grid; this slice's main path)
# ---------------------------------------------------------------------------

def grid_active(n_chains: int, k_max: int, k_small: int = 1) -> np.ndarray:
    """The active-pop mask of a K grid: replicas i*C..(i+1)*C run
    K = k_small + i on the leading slots."""
    ks = range(k_small, k_max + 1)
    act = np.zeros((len(ks) * n_chains, k_max), np.float32)
    for i, kv in enumerate(ks):
        act[i * n_chains:(i + 1) * n_chains, :kv] = 1.0
    return act


def phase_kselect(panel, smi: str) -> dict:
    """``infer_k`` on the headline panel in mode 2: 4 chains per K, K =
    1..10, one padded grid of 40 replicas at K_max = 10 (the fused sweep
    through the run-time-K body of the site pass, the plain S tail, as in
    JAX at K > 8), at the main path's depth (200 sweeps, half burn-in,
    thinning 10).  Checks: the panel's K = 3 is picked; launches as the
    schedule predicts; every K's slice puts no q mass or z on its padding;
    a rerun is bitwise equal; the card agrees with the CPU after 3 sweeps
    of a small grid in modes 0, 2 and 4.  Reports per-K WAIC, wall and
    device ms per sweep, launches and peak device memory.  Returns the
    launches of the grid's site passes."""
    small = grid_active(2, 4)
    agreement = {f"mode {m}": small_agreement(m, 2, active=small)
                 for m in (2, 0, 4)}
    emit("small_agreement", grid=dict(C=small.shape[0], K_max=4),
         sweeps=3, max_abs_err=agreement)
    stored = N_ITER // 2 // 10
    sched = Schedule(n_iter=N_ITER, burnin=N_ITER // 2, thinning=10,
                     n_chains=KSEL_CHAINS, ckrep=stored,
                     nstep_check_empty_cluster=stored)
    spec = ModelSpec(mode=2, n_pops=N_POPS, s_subsweeps=SUBSWEEPS)
    data = panel.data.to("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.time()
    res = infer_k(panel.data, spec, sched, RUN_SEED, n_small=1,
                  n_large=KSEL_MAX, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: int(n) for name, n in _build.launches.items()}
    peak = torch.cuda.max_memory_allocated()

    spec_pad = dataclasses.replace(spec, n_pops=KSEL_MAX)
    attempts = 1 + res.results[1].n_retries
    steps = N_ITER * attempts
    last_extra = 0 if (N_ITER - sched.burnin) % sched.thinning == 0 else 1
    want = expected_launches(spec_pad, data, steps,
                             (sched.n_stored + last_extra) * attempts,
                             attempts)
    if launches != want:
        raise AssertionError(f"kselect: launches {launches}, the schedule "
                             f"predicts {want}")
    waic = {k: float(w.mean()) for k, w in res.waic.items()}
    bad = []
    for k, r in res.results.items():
        st = r.final_state
        if float(st.q[:, :, k:].abs().sum()) != 0.0 or int(st.z.max()) >= k:
            bad.append(f"K = {k}: mass or labels on its padding")
        if tuple(r.posterior_mean.q.shape) != (KSEL_CHAINS, N_INDV, k):
            bad.append(f"K = {k}: posterior q not native-K")
        if not np.isfinite(res.waic[k]).all():
            bad.append(f"K = {k}: WAIC not finite")
    res2 = infer_k(panel.data, spec, sched, RUN_SEED, n_small=1,
                   n_large=KSEL_MAX, device="cuda")
    same = all(
        torch.equal(a.final_state.z, b.final_state.z)
        and torch.equal(a.final_state.rates, b.final_state.rates)
        and torch.equal(a.accum.mean.total_ll, b.accum.mean.total_ll)
        and torch.equal(a.accum.lme_indv, b.accum.lme_indv)
        for a, b in zip(res.results.values(), res2.results.values()))
    if not same:
        bad.append("two runs from one seed are not bitwise equal")
    del res2
    act = torch.as_tensor(grid_active(KSEL_CHAINS, KSEL_MAX),
                          device="cuda")
    # the bare sweeps' own peak (init, step loop, K1's scratch), apart from
    # run_mcmc's stored-step and WAIC passes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = sweep_profile(data, spec_pad, n_steps=30, n_prof=10, active=act)
    peak_sweeps = torch.cuda.max_memory_allocated()
    emit("sweep_profile", path="kselect: mode 2, headline panel, K = 1..10 "
         "grid", card=smi, **prof)
    check_one_site_launch("kselect", prof, True)
    emit("kselect", path="kselect: infer_k, mode 2, headline panel, "
         f"K = 1..{KSEL_MAX}", card=smi,
         replicas=KSEL_CHAINS * KSEL_MAX, chains_per_k=KSEL_CHAINS,
         sweeps=steps, best_k=res.best_k,
         waic=waic, waic_se=res.waic_se,
         dic={k: float(v.mean()) for k, v in res.dic.items()},
         wall_seconds=round(wall, 3),
         wall_ms_per_sweep=round(1e3 * wall / steps, 4),
         device_ms_per_sweep=prof.get("device_ms_per_sweep"),
         profiled_sweeps_observed=prof.get("sweeps_observed"),
         site_pass_device_launches_per_sweep=prof.get(
             "site_pass_device_launches_per_sweep"),
         peak_device_memory_bytes=int(peak),
         peak_device_memory_bytes_bare_sweeps=int(peak_sweeps),
         launches=launches,
         n_retries=res.results[1].n_retries, bitwise_reproducible=same)
    if bad:
        raise AssertionError(f"kselect: failed checks {bad}")
    if res.best_k != N_POPS:
        raise AssertionError(f"kselect: picked K = {res.best_k}, the panel "
                             f"has K = {N_POPS}")
    return {name: n for name, n in launches.items()
            if name.startswith("site_pass")}


# ---------------------------------------------------------------------------
# phase 7: the tetraploid engine (K5-K7 and the paths that run them)
# ---------------------------------------------------------------------------

TETRA_LINES = {"geno_choice_pass": 340, "s_delta_pass": 168,
               "site_ll_pass": 279}
# kernel entries timed beside the listed ones (K6 on the auto panel)
tetra_variants: list = []


def tetra_panel(autopoly: bool, n=TETRA_INDV, l=TETRA_LOCI, k=N_POPS,
                a=TETRA_ALLELES, missing=0.0, seed=TETRA_SEED):
    return synthetic_tetra_panel(n, l, n_pops=k, n_alleles=a,
                                 autopoly=autopoly, missing_rate=missing,
                                 seed=seed)


def tetra_inputs(panel, autopoly: bool, k=N_POPS, c=N_CHAINS, seed=31):
    """State-like inputs of the tetraploid kernels at the panel's shapes,
    from a seed: each individual's copies sit in one dominant pop with
    probability 0.85 (about two thirds of the sites same-z, as in a run
    at admixture 0.1), a random candidate ordering per site, S and a
    proposal one random-walk step away."""
    data = panel.data.to("cuda")
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly)
    tables = te.build_tables(spec, data)
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def simplex(*shape, conc=1.0, mask=None):
        x = torch._standard_gamma(torch.full(shape, conc, device="cuda"),
                                  generator=g).clamp_min(1e-20)
        x = x if mask is None else x * mask
        return (x / x.sum(-1, keepdim=True)).contiguous()

    dom = (rand(c, n, 1) * k).long().clamp_max(k - 1)
    other = (rand(c, n, 4 * l) * k).long().clamp_max(k - 1)
    z = torch.where(rand(c, n, 4 * l) < 0.85, dom, other).to(torch.int8)
    choice = torch.minimum(torch.floor(rand(c, n, l)
                                       * tables.cand_nc.float()),
                           tables.cand_nc.float() - 1).to(torch.int8)
    rates = (rand(c, k) * 0.9 + 0.05).contiguous()
    prop = (rates + (rand(c, k) - 0.5) * 0.1).clamp(0.01, 0.99).contiguous()
    av = data.allele_valid.float()
    freq, freq2 = simplex(c, k, l, a, mask=av), simplex(c, k, l, a, mask=av)
    tab_cur = te.class_table(tables, spec, freq, freq2, rates).contiguous()
    tab_prop = te.class_table(tables, spec, freq, freq2, prop).contiguous()
    return dict(data=data, spec=spec, tables=tables, z=z,
                geno=te.reconstruct_geno(tables, choice), q=simplex(c, n, k,
                                                                    conc=0.3),
                freq=freq, freq2=freq2, table=tab_cur, tab_cur=tab_cur,
                tab_prop=tab_prop, keys=px.make_keys(RUN_SEED, c, "cuda"))


def _k5_args(x, step=5):
    t = x["tables"]
    return (x["keys"], step, x["table"], x["z"], t.dist8, t.cand_nc, x["q"],
            x["freq"], x["freq2"], t.cand_sel, t.cand_cls, t.cand_mult)


def _k6_args(x):
    return (x["tab_cur"], x["tab_prop"], x["tables"].lookup_l, x["z"],
            x["geno"], x["data"].site_valid)


def _k7_args(x):
    t = x["tables"]
    return (x["table"], t.lookup_l, t.log_mult_l, x["freq"], x["freq2"],
            x["z"], x["geno"], x["data"].site_valid)


def k5_agrees(tag, x, gumbel=None) -> torch.Tensor:
    auto = bool(x["spec"].autopoly)
    got = tg.geno_choice_pass(*_k5_args(x), autopoly=auto, gumbel=gumbel)
    want = tg.geno_choice_pass_reference(*_k5_args(x), autopoly=auto,
                                         gumbel=gumbel)
    if not torch.equal(got, want):
        raise AssertionError(f"{tag}: choice differs from the plain version "
                             f"at {int((got != want).sum())} sites")
    if bool((got.long() >= x["tables"].cand_nc.long()).any()):
        raise AssertionError(f"{tag}: a choice beyond the site's candidates")
    return got


def k6_agrees(tag, x):
    """delta through the class map (the engine's call) and through the
    per-locus lookup rows (the JAX-shaped call), each to rtol 1e-5 and atol
    1e-6 x the sum of |terms| of its pop (f32 sums in another order); an MH
    decision may differ only within that of its threshold; two launches
    bitwise equal; the launch plan's shared memory the kernel's.  Returns
    (delta through the class map, plain delta, atol)."""
    want = tg.s_delta_pass_reference(*_k6_args(x))
    # the sum of |terms| per (chain, pop): the plain version on |tp - tc|
    mag = tg.s_delta_pass_reference(
        x["tab_cur"], x["tab_cur"] + (x["tab_prop"] - x["tab_cur"]).abs(),
        *_k6_args(x)[2:])
    atol = 1e-6 * mag
    logu = want + torch.linspace(-1.0, 1.0, want.numel(),
                                 device="cuda").reshape(want.shape)
    out = None
    for classes in (x["tables"].class_map, None):
        what = tag + (" (class map)" if classes is not None else "")
        got = tg.s_delta_pass(*_k6_args(x), classes)
        if bool(((got - want).abs() > 1e-5 * want.abs() + atol).any()):
            raise AssertionError(f"{what}: delta differs, max abs err "
                                 f"{max_err(got, want):.3e}")
        flip = (logu < got) != (logu < want)
        if bool(((logu - want).abs()[flip]
                 > atol[flip] + 1e-5 * want.abs()[flip]).any()):
            raise AssertionError(f"{what}: an S accept differs away from a "
                                 "knife-edge")
        if not torch.equal(got, tg.s_delta_pass(*_k6_args(x), classes)):
            raise AssertionError(f"{what}: two launches are not bitwise "
                                 "equal")
        out = got if out is None else out
    sums_plan_agrees(tag, x)
    return out, want, atol


def k7_agrees(tag, x):
    """ll through the class map and through the per-locus lookup rows, each
    to rtol 1e-5 and atol 1e-6 x the sum of |site terms|, bitwise equal to
    each other (the same site terms in the same order) and on a second
    launch.  Returns (ll, plain ll)."""
    auto = bool(x["spec"].autopoly)
    want = tg.site_ll_pass_reference(*_k7_args(x), autopoly=auto)
    mag = tg.site_loglik(*_k7_args(x), autopoly=auto).abs().sum(dim=2)
    out = None
    for classes in (x["tables"].class_map, None):
        what = tag + (" (class map)" if classes is not None else "")
        got = tg.site_ll_pass(*_k7_args(x), autopoly=auto, classes=classes)
        if bool(((got - want).abs() > 1e-5 * want.abs() + 1e-6 * mag).any()):
            raise AssertionError(f"{what}: ll differs, max abs err "
                                 f"{max_err(got, want):.3e}")
        if not torch.equal(got, tg.site_ll_pass(*_k7_args(x), autopoly=auto,
                                                classes=classes)):
            raise AssertionError(f"{what}: two launches are not bitwise "
                                 "equal")
        if out is not None and not torch.equal(got, out):
            raise AssertionError(f"{tag}: ll through the lookup rows is not "
                                 "bitwise ll through the class map")
        out = got if out is None else out
    return out, want


def sums_plan_agrees(tag, x) -> dict:
    """K6's and K7's launch plans (``tg.sums_plan``, with and without the
    class map) ask for the shared memory the kernels compute
    (``*_launch_dyn_smem``).  Returns the plans with the engine's class map
    by kernel."""
    t, d, spec = x["tables"], x["data"], x["spec"]
    c, k, l, g = x["tab_cur"].shape
    v, a, auto = t.lookup_l.shape[1], d.max_alleles, bool(spec.autopoly)
    lib = _build.library()
    plans = {}
    for n_cls in (0, t.class_map.lookup.shape[0]):
        p6 = tg.sums_plan("s_delta", c, d.n_indv, l, k, g, v, n_cls)
        p7 = tg.sums_plan("site_ll", c, d.n_indv, l, k, g, v, n_cls, a, auto)
        got = (lib.s_delta_launch_dyn_smem(k, g, v, n_cls, int(p6.stage),
                                           int(p6.lut_smem)),
               lib.site_ll_launch_dyn_smem(k, a, g, v, n_cls, int(auto),
                                           int(p7.stage), int(p7.lut_smem)))
        if got != (p6.dyn_smem, p7.dyn_smem):
            raise AssertionError(f"{tag}: the plans' shared memory "
                                 f"{(p6.dyn_smem, p7.dyn_smem)}, the "
                                 f"kernels' {got} (n_cls {n_cls})")
        plans = dict(s_delta=p6._asdict(), site_ll=p7._asdict())
    return plans


def views_agree(tag, x):
    """K1, K4 and K8 on the per-chain planes of the tetraploid views (the
    latent genotype is per chain) against their plain versions."""
    d, spec, keys = x["data"], x["spec"], x["keys"]
    k = spec.n_pops
    view = te.view_dataset(spec, d, x["geno"])
    f2l = te.freq_2l(spec, x["freq"], x["freq2"])
    if te.tetra_use_fused(spec, d):
        got = fs.zq_sample_pass(keys, 5, x["q"], f2l, view)
        want = fs.zq_sample_pass_reference(keys, 5, x["q"], f2l, view)
        for nm, a_, b_ in zip(("z", "qqnum"), got[:2], want[:2]):
            if not torch.equal(a_, b_):
                raise AssertionError(f"{tag}: zq_sample_pass on the view: "
                                     f"{nm} differs from the plain version")
    kw = dict(n_pops=k, max_alleles=d.max_alleles)
    zv, gv = te.diploid_view(spec, x["z"]), te.diploid_view(spec, x["geno"])
    v2 = d.site_valid.repeat(1, 2)
    if not torch.equal(fs.allele_counts(zv, gv, v2, **kw),
                       fs.allele_counts_reference(zv, gv, v2, **kw)):
        raise AssertionError(f"{tag}: allele_counts on the view differs")
    geno8 = x["geno"] if spec.autopoly else gv
    f8 = x["freq"] if spec.autopoly else f2l
    sv = d.site_valid if spec.autopoly else v2
    zq_agrees(f"{tag}: zq_sample_counts on per-chain planes", keys, x["q"],
              f8, geno8, sv)


def mixtures_used(cand_sel, nc, autopoly: bool) -> torch.Tensor:
    """int64[N, L]: the (distinct allele, system) pairs whose Q-mixture the
    valid candidates of a site read -- slots 0-1 read system 1, slots 2-3
    system 2 (allo; every slot system 1 when ``autopoly``): the mixtures
    and logs K5 needs at a mixed-z site."""
    sel = cand_sel.to(torch.int64)
    ok = (torch.arange(sel.shape[0], device=sel.device)[:, None, None]
          < nc.to(torch.int64)[None])
    systems = ((0, 1, 2, 3),) if autopoly else ((0, 1), (2, 3))
    total = torch.zeros(sel.shape[1:], dtype=torch.int64, device=sel.device)
    for slots in systems:
        for j in range(4):
            hit = torch.zeros_like(ok)
            for m in slots:
                hit = hit | (ok & (((sel >> (2 * m)) & 3) == j))
            total = total + hit.any(dim=0).to(torch.int64)
    return total


def tetra_work(x, classes: bool = True):
    """(bytes, operations) of one call of K5, K6, K7 on these inputs: each
    operand read once, each result written once; operations counted from
    this run's masks (same-z sites, valid candidates).  K6 and K7 read the
    class map (its class rows and a byte a locus) where ``classes``, else
    the per-locus lookup rows (the JAX-shaped call)."""
    d, t, spec = x["data"], x["tables"], x["spec"]
    c, k, l, g = x["table"].shape
    n, a, v = d.n_indv, d.max_alleles, t.lookup_l.shape[1]
    lut = (t.class_map.lookup.numel() * 4 + l if classes else l * v * 4)
    n_sys = 1 if spec.autopoly else 2
    zc = tg.split4(x["z"])
    same = tg.same_z(zc)
    valid = d.site_valid[None]
    n_same = int((same & valid).sum())
    n_sites = c * n * l
    n_valid = c * int(d.site_valid.sum())
    ncand = t.cand_nc.long()[None].expand(c, n, l)
    cand_same = int(ncand[same].sum())
    cand_mixed = int(ncand[~same].sum())
    planes = c * n * 4 * l
    k5_bytes = (planes + n * 4 * l + n * l + t.n_cand * n * l * 4
                + c * n * k * 4 + n_sys * c * k * l * a * 4
                + c * k * l * g * 4 + c * n * l)
    # K5's least work: per mixed site, the mixture (K products and adds) and
    # its log for each distinct allele that a valid candidate routes to a
    # system; per mixed candidate a log-multiplicity lookup and 4 adds; per
    # same-z candidate a table read; per valid candidate 2 Gumbel logs, a
    # quarter of a Philox block, the add and the compare
    mix_logs = (mixtures_used(t.cand_sel, t.cand_nc, spec.autopoly)[None]
                .expand(c, n, l)[~same].sum())
    k5_ops = (int(mix_logs) * (2 * k + OPS_TRANSC)
              + cand_mixed * 5 + cand_same * 1
              + (cand_same + cand_mixed) * (2 * OPS_TRANSC + OPS_PHILOX / 4
                                            + 2))
    k6_bytes = 2 * c * k * l * g * 4 + lut + 2 * planes + n * l + c * k * 4
    k6_ops = n_same * (12 + 1 + k)
    k7_bytes = (c * k * l * g * 4 + lut + l * g * 4
                + n_sys * c * k * l * a * 4 + 2 * planes + n * l + c * n * 4)
    k7_ops = n_same * 12 + (n_valid - n_same) * (4 * OPS_TRANSC + 17)
    return dict(geno_choice_pass=(k5_bytes, k5_ops),
                s_delta_pass=(k6_bytes, k6_ops),
                site_ll_pass=(k7_bytes, k7_ops))


def _tetra_entry(name, counter, x, work, err, run, plain, compared, notes,
                 parent_ms=None):
    b_ms, b_by = bound(*work)
    return dict(name=counter, route="cuda",
                source="instruct_tpu_torch/csrc/tetra_geno.cu",
                replaces="instruct_tpu/kernels/tetra_geno_pallas.py:"
                         f"{TETRA_LINES[name]}",
                max_abs_err=err, ms=time_ms(run),
                plain_ms=time_ms(plain, reps=3, warm=1, inner=1),
                bound_ms=b_ms, bound_by=b_by,
                # no one PyTorch call computes the weights + Gumbel-argmax,
                # the class-indexed masked per-pop sum or the two-branch
                # site log-lik
                library_ms=None, bytes=work[0], ops=work[1], notes=notes,
                shape=dict(C=N_CHAINS, N=x["data"].n_indv,
                           L=x["data"].n_loci, K=x["spec"].n_pops,
                           A=x["data"].max_alleles, G=x["tables"].g_max,
                           n_cand=x["tables"].n_cand),
                compared=compared, parent_ms=parent_ms)


def check_tetra_kernels(panels) -> list:
    """K5 (auto and allo), K6 and K7 against their plain versions at full
    width, with Philox and with injected Gumbel planes, plus the K1/K4/K8
    launches on the per-chain planes of the views; their times and bounds.
    K6 is reported once (the allo panel, G = 100); its auto time is a
    variant."""
    entries = []
    for auto, panel in panels.items():
        mode = "auto" if auto else "allo"
        x = tetra_inputs(panel, auto)
        tag = f"tetra kernels ({mode})"
        choice = k5_agrees(tag + " geno_choice_pass", x)
        c, n, l = choice.shape
        gum = -torch.log(-torch.log(torch.rand(
            (c, x["tables"].n_cand, n, l), device="cuda",
            generator=torch.Generator("cuda").manual_seed(8)).clamp(
                1e-7, 1 - 1e-7)))
        k5_agrees(tag + " geno_choice_pass under injected Gumbel planes", x,
                  gum)
        del gum
        if not torch.equal(choice, k5_agrees(tag, x)):
            raise AssertionError(f"{tag}: two K5 launches differ")
        d6, p6, atol6 = k6_agrees(tag + " s_delta_pass", x)
        d7, p7 = k7_agrees(tag + " site_ll_pass", x)
        views_agree(tag, x)
        work, work_rows = tetra_work(x), tetra_work(x, classes=False)
        a5 = _k5_args(x)
        share = float(tg.same_z(tg.split4(x["z"])).float().mean())
        entries.append(_tetra_entry(
            "geno_choice_pass", f"geno_choice_pass_{mode}", x,
            work["geno_choice_pass"], 0.0,
            lambda: tg.geno_choice_pass(*a5, autopoly=auto),
            lambda: tg.geno_choice_pass_reference(*a5, autopoly=auto),
            "choice exactly equal (Philox and injected Gumbel planes)",
            [f"same-z share {share:.3f}"],
            parent_kernel_ms("geno_choice_pass", a5, dict(autopoly=auto))))
        # K6 and K7 timed as the engine calls them (with its class map);
        # through the per-locus lookup rows (the JAX-shaped call) beside,
        # with that call's own bound;
        # ms, parent_ms: the profiler's device time of a call (its events
        # time reads the host's enqueue of the wrapper)
        a6, cm = _k6_args(x), x["tables"].class_map
        plans = sums_plan_agrees(tag, x)
        run6 = lambda: tg.s_delta_pass(*a6, cm)
        e6 = _tetra_entry(
            "s_delta_pass", "s_delta_pass", x, work["s_delta_pass"],
            max_err(d6, p6), run6,
            lambda: tg.s_delta_pass_reference(*a6),
            "delta rtol 1e-5, atol 1e-6 x sum |terms| (max "
            f"{float(atol6.max()):.2e}); MH decisions off only within it; "
            "with and without the class map",
            [f"|delta| max {float(p6.abs().max()):.3e}",
             f"same-z share {share:.3f}"],
            parent_kernel_ms("s_delta_pass", a6, device_name="s_delta"))
        e6.update(ms_events=e6["ms"],
                  ms=profiling.device_ms(run6, "s_delta", per_call=True),
                  ms_lookup_rows=profiling.device_ms(
                      lambda: tg.s_delta_pass(*a6), "s_delta", per_call=True),
                  bound_ms_lookup_rows=bound(*work_rows["s_delta_pass"])[0],
                  plan=plans["s_delta"])
        if auto:
            e6["name"] = "s_delta_pass(auto)"
            tetra_variants.append(e6)
        else:
            entries.append(e6)
        a7 = _k7_args(x)
        run7 = lambda: tg.site_ll_pass(*a7, autopoly=auto, classes=cm)
        e7 = _tetra_entry(
            "site_ll_pass", f"site_ll_pass_{mode}", x, work["site_ll_pass"],
            max_err(d7, p7), run7,
            lambda: tg.site_ll_pass_reference(*a7, autopoly=auto),
            "ll rtol 1e-5, atol 1e-6 x sum |site terms|; with and without "
            "the class map, bitwise alike",
            [f"|ll| max {float(p7.abs().max()):.3e}",
             f"same-z share {share:.3f}"],
            parent_kernel_ms("site_ll_pass", a7, dict(autopoly=auto),
                             device_name="site_ll"))
        e7.update(ms_events=e7["ms"],
                  ms=profiling.device_ms(run7, "site_ll", per_call=True),
                  ms_lookup_rows=profiling.device_ms(
                      lambda: tg.site_ll_pass(*a7, autopoly=auto), "site_ll",
                      per_call=True),
                  bound_ms_lookup_rows=bound(*work_rows["site_ll_pass"])[0],
                  plan=plans["site_ll"])
        entries.append(e7)
        del x
        torch.cuda.empty_cache()
    tetra_edge_shapes()
    return entries


def k5_edge_rows(tag, x) -> None:
    """K5 on the same inputs with every site of the first half of the rows
    same-z and every site of the second half mixed (where K > 1), and with
    every candidate count cut to 1: exactly the plain version, bitwise
    equal on a rerun, with Philox and with injected Gumbel planes."""
    z, l = x["z"], x["data"].n_loci
    n, k = z.shape[1], x["spec"].n_pops
    zs = z.clone()
    zs[:, : (n + 1) // 2] = z[:, : (n + 1) // 2, :l].repeat(1, 1, 4)
    if k > 1:
        zs[:, (n + 1) // 2:, l:2 * l] = (z[:, (n + 1) // 2:, :l] + 1) % k
    t = x["tables"]
    one = torch.ones_like(t.cand_nc)
    cases = ((" same-z / mixed rows", dict(x, z=zs.contiguous())),
             (" nc = 1", dict(x, tables=t._replace(cand_nc=one))))
    c, nn = z.shape[:2]
    gum = -torch.log(-torch.log(torch.rand(
        (c, t.n_cand, nn, l), device="cuda",
        generator=torch.Generator("cuda").manual_seed(9)).clamp(
            1e-7, 1 - 1e-7)))
    for what, xx in cases:
        for g in (None, gum):
            got = k5_agrees(tag + what, xx, g)
            if not torch.equal(got, k5_agrees(tag + what + " (rerun)", xx,
                                              g)):
                raise AssertionError(f"{tag}{what}: two K5 launches differ")
            if what == " nc = 1" and bool(got.any()):
                raise AssertionError(f"{tag}{what}: a choice beyond the one "
                                     "candidate")


def k67_edge_rows(tag, x) -> None:
    """K6 and K7 on the same inputs with every site of the first half of
    the rows same-z and every site of the second half mixed (where K > 1),
    and every site of the first row invalid: within their tolerances, two
    launches bitwise equal (``k6_agrees``, ``k7_agrees``)."""
    z, l = x["z"], x["data"].n_loci
    n, k = z.shape[1], x["spec"].n_pops
    zs = z.clone()
    zs[:, : (n + 1) // 2] = z[:, : (n + 1) // 2, :l].repeat(1, 1, 4)
    if k > 1:
        zs[:, (n + 1) // 2:, l:2 * l] = (z[:, (n + 1) // 2:, :l] + 1) % k
    sv = x["data"].site_valid.clone()
    sv[0] = False
    xx = dict(x, z=zs.contiguous(),
              data=x["data"]._replace(site_valid=sv))
    k6_agrees(tag + " same-z / mixed rows, row 0 invalid", xx)
    k7_agrees(tag + " same-z / mixed rows, row 0 invalid", xx)


def tetra_edge_shapes() -> None:
    """K5-K7 and the view launches at small ragged shapes: N = 1, L not a
    multiple of the block, missing sites, K = 1..5, A = 2, 3, auto and
    allo; wide class tables (A = 8: K * G = 1320 auto, 5184 allo) and
    K = 10, which only the unfused sweep runs; for K6 and K7: L at each
    residue of the 4-locus word (1, 3, 5, 7, 9, 5001), N off the 32-row
    block step, C = 1, K = 1, 9 and 33, rows all same-z, rows all mixed and
    a row with every site invalid (``k67_edge_rows``)."""
    cases = [(1, 1, 37, 2, 2), (2, 33, 258, 3, 3), (1, 7, 1, 1, 2),
             (2, 50, 301, 5, 3), (3, 19, 130, 4, 2), (2, 9, 40, 4, 8),
             (2, 11, 70, 10, 3), (2, 45, 3, 3, 4), (1, 70, 5, 2, 3),
             (2, 35, 7, 9, 2), (1, 20, 9, 33, 2), (2, 3, 5001, 3, 4),
             (1, 97, 64, 1, 4)]
    for c, n, l, k, a in cases:
        for auto in (True, False):
            panel = tetra_panel(auto, n=n, l=l, k=k, a=a, missing=0.15,
                                seed=n + l)
            x = tetra_inputs(panel, auto, k=k, c=c, seed=l)
            tag = f"tetra edge shape C={c} N={n} L={l} K={k} A={a} auto={auto}"
            k5_agrees(tag, x)
            k6_agrees(tag, x)
            k7_agrees(tag, x)
            views_agree(tag, x)
            k5_edge_rows(tag, x)
            k67_edge_rows(tag, x)
    emit("tetra_edge_shapes", cases=[dict(C=c, N=n, L=l, K=k, A=a)
                                     for c, n, l, k, a in cases],
         all_match=True)


def tetra_expected_launches(spec, data, steps, evals, margs, attempts):
    """Launches per kernel that ``run_mcmc``'s schedule predicts for the
    tetraploid engine (with ``track_freq``: one plug-in log-lik).  Both
    sweeps run K5, K6 (once per S subsweep) and K7."""
    auto = bool(spec.autopoly)
    mode = "auto" if auto else "allo"
    # S tail + alpha per sweep; the initial state's geno, z, alpha and S
    # words
    want = {"allele_counts" if spec.n_pops * data.max_alleles <= 64
            else "allele_counts_wide": steps,
            "dirichlet_kla": steps * (1 if auto else 2),
            "dirichlet_nk": steps + attempts,
            "philox_words": steps * 2 + 4 * attempts,
            f"geno_choice_pass_{mode}": steps,
            f"site_ll_pass_{mode}": evals + margs + 1,
            "s_delta_pass": steps * max(1, spec.s_subsweeps)}
    if te.tetra_use_fused(spec, data):
        want["site_pass_sample" + ("" if data.max_alleles == 2
                                   else "_generic")] = steps
    else:
        want["zq_sample_counts"] = steps
    return want


def geno_is_an_ordering(data, geno) -> bool:
    """Every valid site's latent genotype holds exactly the observed
    distinct alleles."""
    n, l = data.n_indv, data.n_loci
    dist = data.distinct.reshape(n, 4, l)[None]            # [1, N, 4, L]
    g = geno.to(torch.int32).reshape(-1, n, 4, l)
    nd = data.n_distinct[None, :, None, :]
    live = torch.arange(4, device=geno.device)[None, None, :, None] < nd
    # each slot's allele is one of the site's distinct alleles ...
    in_dist = ((g[:, :, :, None] == dist[:, :, None]) & live[:, :, None]
               ).any(dim=3)
    # ... and each distinct allele appears in some slot
    covered = ((dist[:, :, :, None] == g[:, :, None]).any(dim=3) | ~live)
    v = data.site_valid[None, :, None, :]
    return bool(((in_dist | ~v).all()) and ((covered | ~v).all()))


def tetra_small_agreement(autopoly: bool, **spec_kw) -> dict:
    """The port on the card against the port on the CPU (plain versions),
    same seed, a 40 x 120 panel, 3 sweeps from an initial state drawn on
    each device (the tetraploid initial state is a function of Philox
    words, so the two draw the same).  The class tables are float64 solves
    cast to float32 on both (cuSOLVER vs LAPACK): z, geno, rates and
    ais_state must agree exactly, or the sites that differ are counted and
    bounded (at most 0.5%, from a near-tie in a z threshold or in the move's
    argmax; a chain in which they differ may then also differ in its S).
    The class tables of the same (P, P2, S) agree to 1e-5 on the two."""
    panel = tetra_panel(autopoly, n=40, l=120, a=3, missing=0.1, seed=3)
    spec = ModelSpec(mode=2, ploid=4, n_pops=N_POPS, autopoly=autopoly,
                     **spec_kw)
    out = {}
    for dev in ("cpu", "cuda"):
        data = panel.data.to(dev)
        keys = px.make_keys(11, 2, dev)
        state = init_state(11, spec, data, n_chains=2, device=dev)
        out[dev + "_init"] = state
        step, add_loglik = build_step_parts(spec, data)
        for i in range(3):
            state = step(state, keys, i)
        out[dev] = add_loglik(state)
    tag = f"tetra small agreement (auto={autopoly}, {spec_kw})"
    a_, b_ = out["cpu"], out["cuda"]
    ia, ib = out["cpu_init"], out["cuda_init"]
    for name in ("z", "geno", "rates"):
        if not torch.equal(getattr(ia, name), getattr(ib, name).cpu()):
            raise AssertionError(f"{tag}: the initial {name} differs")
    errs = {}
    for name in ("z", "geno"):
        off = float((getattr(a_, name) != getattr(b_, name).cpu()).float()
                    .mean())
        errs[name + "_sites_differ"] = off
        if off > 5e-3:
            raise AssertionError(f"{tag}: {name} differs at {off:.2%}")
    exact = errs["z_sites_differ"] == 0 and errs["geno_sites_differ"] == 0
    for name in ("rates", "ais_state"):
        if exact and not torch.equal(getattr(a_, name),
                                     getattr(b_, name).cpu()):
            raise AssertionError(f"{tag}: {name} differs between the card "
                                 "and the CPU")
    # the solve: one (P, P2, S), two devices
    ta = te.class_table(te.build_tables(spec, panel.data,
                                        with_candidates=False), spec,
                        a_.freq, a_.freq2, a_.rates)
    tb = te.class_table(te.build_tables(spec, panel.data.to("cuda"),
                                        with_candidates=False), spec,
                        a_.freq.cuda(), a_.freq2.cuda(), a_.rates.cuda())
    fin = ta > -1e29
    errs["table"] = max_err(ta[fin], tb.cpu()[fin])
    if errs["table"] > 1e-5:
        raise AssertionError(f"{tag}: class table differs by "
                             f"{errs['table']:.3e}")
    for name, tol in (("rates", 0.0), ("q", 1e-4), ("freq", 1e-4),
                      ("freq2", 1e-4), ("alpha", 1e-5),
                      ("loglik_indv", 1e-2)):
        errs[name] = max_err(getattr(a_, name), getattr(b_, name).cpu())
        if exact and errs[name] > tol:
            raise AssertionError(f"{tag}: {name} differs by "
                                 f"{errs[name]:.3e} (> {tol})")
    return errs


def drive_tetra(tag, panel, spec, n_iter, smi, profile_sweeps=100,
                n_prof=30) -> dict:
    """``run_mcmc`` on a tetraploid panel with the launch counts set to 0
    just before and read just after; counts against the schedule, the
    output's checks, a second run from the seed bitwise equal."""
    stored = n_iter // 2 // 10
    sched = Schedule(n_iter=n_iter, burnin=n_iter // 2, thinning=10,
                     n_chains=N_CHAINS, ckrep=min(20, stored),
                     nstep_check_empty_cluster=min(20, stored),
                     dic_every=2)
    data = panel.data.to("cuda")
    n, l, a, k = data.n_indv, data.n_loci, data.max_alleles, spec.n_pops
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    res = run_mcmc(panel.data, spec, sched, RUN_SEED, track_freq=True,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: int(cnt) for name, cnt in _build.launches.items()}
    attempts = 1 + res.n_retries
    steps = n_iter * attempts
    last_extra = 0 if (n_iter - sched.burnin) % sched.thinning == 0 else 1
    margs = len(range(0, sched.n_stored, sched.dic_every)) * attempts
    want = tetra_expected_launches(spec, data, steps,
                                   (sched.n_stored + last_extra) * attempts,
                                   margs, attempts)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, the schedule "
                             f"predicts {want}")
    st, acc = res.final_state, res.accum
    allo = not spec.autopoly
    checks = {
        "loglik finite": bool(torch.isfinite(st.loglik_indv).all()
                              and torch.isfinite(acc.mean.total_ll).all()
                              and torch.isfinite(acc.mean.ll_marg).all()),
        "rates in [0,1]": bool(((st.rates >= 0) & (st.rates <= 1)).all()),
        "Q rows sum to 1": bool(torch.allclose(
            st.q.sum(-1), torch.ones_like(st.q.sum(-1)), atol=1e-4)),
        "freq rows sum to 1": bool(torch.allclose(
            st.freq.sum(-1), torch.ones_like(st.freq.sum(-1)), atol=1e-4)
            and (not allo or torch.allclose(
                st.freq2.sum(-1), torch.ones_like(st.freq2.sum(-1)),
                atol=1e-4))),
        "shapes": (tuple(st.z.shape) == (N_CHAINS, n, 4 * l)
                   and tuple(st.geno.shape) == (N_CHAINS, n, 4 * l)
                   and tuple(st.q.shape) == (N_CHAINS, n, k)
                   and tuple(st.freq2.shape) == (N_CHAINS, k, l, a)
                   and tuple(acc.mean.rates.shape) == (N_CHAINS, k)),
        "geno is an ordering of the observed alleles": geno_is_an_ordering(
            data, st.geno),
        "stored count": bool((acc.count == sched.n_stored).all()),
        "labels in range": bool(st.z.min() >= 0 and st.z.max() < k),
        "retries not exhausted": res.n_retries < 10,
        "waic finite": res.waic() is not None and bool(
            np.isfinite(res.waic()).all()),
        "plug-in log-lik finite": bool(np.isfinite(res.plugin_ll).all()),
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{tag}: failed checks {bad}")
    res2 = run_mcmc(panel.data, spec, sched, RUN_SEED, track_freq=True,
                    device="cuda")
    f2 = res2.final_state
    same = (torch.equal(st.z, f2.z) and torch.equal(st.geno, f2.geno)
            and torch.equal(st.freq, f2.freq)
            and torch.equal(st.freq2, f2.freq2)
            and torch.equal(st.rates, f2.rates)
            and torch.equal(acc.mean.rates, res2.accum.mean.rates)
            and torch.equal(acc.mean.total_ll, res2.accum.mean.total_ll))
    same = same and torch.equal(rates_trajectory(data, spec, 30),
                                rates_trajectory(data, spec, 30))
    if not same:
        raise AssertionError(f"{tag}: two runs from one seed are not "
                             "bitwise equal")
    if profile_sweeps:
        prof = sweep_profile(data, spec, profile_sweeps, n_prof)
        emit("sweep_profile", path=tag, card=smi, **prof)
        check_one_site_launch(tag, prof, te.tetra_use_fused(spec, data),
                              counts_each_sweep=True)
        check_one_s_delta_launch(tag, prof, max(1, spec.s_subsweeps))
    emit("tetra", path=tag, card=smi,
         panel=dict(N=n, L=l, A=a, K=k, autopoly=bool(spec.autopoly)),
         sweep="fused" if te.tetra_use_fused(spec, data) else "unfused",
         s_subsweeps=spec.s_subsweeps, back_refl=spec.back_refl,
         steps=steps, chains=N_CHAINS, n_retries=res.n_retries,
         wall_seconds=round(wall, 3),
         chain_steps_per_second=round(N_CHAINS * steps / wall, 1),
         ms_per_step=round(1e3 * wall / steps, 4), launches=launches,
         mean_rates=[[round(float(v), 4) for v in row]
                     for row in acc.mean.rates.cpu()],
         checks=sorted(checks), bitwise_reproducible=True)
    return launches


def phase_tetra(panels, smi: str) -> dict:
    """The tetraploid engine through ``run_mcmc`` at full width, auto and
    allo (the main path of this engine: the fused sweep with K5, K6, K7);
    shorter: four S subsweeps (``s_subsweeps=4``, K6 in each), the
    adaptive-independence proposal (``back_refl=0``), the unfused sweep
    (``use_pallas=False``, through K8) and an A = 8 panel whose class table
    rows are K * G = 1320 floats.  Returns launches by kernel entry, each
    from the path that runs it."""
    agreement = {}
    for auto in (True, False):
        mode = "auto" if auto else "allo"
        agreement[mode] = tetra_small_agreement(auto)
        agreement[mode + ", use_pallas=False"] = tetra_small_agreement(
            auto, use_pallas=False)
    agreement["allo, s_subsweeps=4"] = tetra_small_agreement(
        False, s_subsweeps=4)
    agreement["auto, back_refl=0"] = tetra_small_agreement(True,
                                                           back_refl=0)
    emit("tetra_small_agreement", sweeps=3, max_abs_err=agreement)
    launches = {}
    for auto, panel in panels.items():
        mode = "auto" if auto else "allo"
        spec = ModelSpec(mode=2, ploid=4, n_pops=N_POPS, autopoly=auto)
        got = drive_tetra(f"tetra: {mode}, fused sweep", panel, spec,
                          TETRA_ITER, smi)
        for name in (f"geno_choice_pass_{mode}", f"site_ll_pass_{mode}"):
            launches[name] = got[name]
        if not auto:
            launches["s_delta_pass"] = got["s_delta_pass"]
    short = dict(n_iter=UNFUSED_ITER, smi=smi, profile_sweeps=30, n_prof=10)
    drive_tetra("tetra: auto, s_subsweeps=4", panels[True],
                ModelSpec(mode=2, ploid=4, n_pops=N_POPS, s_subsweeps=4),
                **short)
    drive_tetra("tetra: allo, back_refl=0", panels[False],
                ModelSpec(mode=2, ploid=4, n_pops=N_POPS, autopoly=False,
                          back_refl=0), **short)
    for auto, panel in panels.items():
        mode = "auto" if auto else "allo"
        drive_tetra(f"tetra: {mode}, use_pallas=False (unfused, K8)", panel,
                    ModelSpec(mode=2, ploid=4, n_pops=N_POPS, autopoly=auto,
                              use_pallas=False), **short)
    drive_tetra("tetra: auto, A = 8, K = 4 (K * G = 1320)",
                tetra_panel(True, l=TETRA_LOCI // 5, k=4, a=8),
                ModelSpec(mode=2, ploid=4, n_pops=4), **short)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,main_path,modes,unfused,tetra,"
                            "kselect")
    ap.add_argument("--parent-csrc", default=None,
                    help="another tree's instruct_tpu_torch/csrc: its site "
                         "pass, K5 and K8 are built and timed beside this "
                         "one's")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    smi = phase_device()
    if args.parent_csrc:
        start_parent_build(args.parent_csrc)
    if "build" in phases:
        phase_build()
    philox_entry = phase_philox()
    rates = np.array([0.1, 0.4, 0.8])
    panel = synthetic_panel(N_INDV, N_LOCI, n_pops=N_POPS, n_alleles=2,
                            selfing_rates=rates, admixture_alpha=0.1,
                            seed=PANEL_SEED)
    panel_a = synthetic_panel(N_INDV, GEN_LOCI, n_pops=N_POPS,
                              n_alleles=GEN_ALLELES, selfing_rates=rates,
                              admixture_alpha=0.1, seed=PANEL_SEED)
    panel_a4 = synthetic_panel(N_INDV, GEN_LOCI, n_pops=N_POPS,
                               n_alleles=GEN16_ALLELES, selfing_rates=rates,
                               admixture_alpha=0.1, seed=PANEL_SEED)
    panel_w = synthetic_panel(N_INDV, WIDE_LOCI, n_pops=WIDE_POPS,
                              n_alleles=WIDE_ALLELES,
                              selfing_rates=np.array(WIDE_RATES),
                              admixture_alpha=0.1, seed=PANEL_SEED)
    tetra_panels = ({auto: tetra_panel(auto) for auto in (True, False)}
                    if phases & {"kernels", "tetra"} else {})
    entries = (phase_kernels(panel, panel_a, panel_a4, panel_w,
                             philox_entry, tetra_panels)
               if "kernels" in phases else {})
    launches = (phase_main_path(panel, smi)
                if "main_path" in phases else {})
    if "modes" in phases:
        # a kernel of the main path keeps the main path's count
        launches = {**phase_modes(panel, panel_a, panel_a4, smi),
                    **launches}
    if "unfused" in phases:
        launches = {**phase_unfused(panel, panel_w, smi), **launches}
    if "tetra" in phases:
        launches = {**phase_tetra(tetra_panels, smi), **launches}
    if "kselect" in phases:
        # the K grid's site passes: this slice's main path counts them
        launches.update(phase_kselect(panel, smi))
    full = {"kernels", "main_path", "modes", "unfused", "tetra",
            "kselect"} <= phases
    if full:
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        summary = []
        for name, e in entries.items():
            e = dict(e, launches=launches.get(name, 0))
            if e["launches"] < 1:
                raise AssertionError(f"{name} was never launched on a "
                                     "driven path")
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
