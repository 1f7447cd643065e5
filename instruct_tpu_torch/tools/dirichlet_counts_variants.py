#!/usr/bin/env python3
"""Time variants of the port's K3 (the Dirichlet draws of P and Q) and K4
(``allele_counts``) kernels on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.dirichlet_counts_variants
        [--parent CSRC_DIR] [--only k3|k4]

Compiles ``csrc/dirichlet.cu`` (K3) and ``csrc/allele_counts.cu`` (K4)
several times with ``nvcc`` -- as they are, once per launch shape (a macro of
the source) and once per ablation (a textual patch that removes one part of
the work) -- and, with ``--parent``, another tree's sources of the same
names.  Every build runs at once; each variant is then timed with CUDA
events over runs of 10 back-to-back launches (``ms``: where a launch is
shorter than the host's enqueue this reads the host) and by the profiler's
device time (``dev_ms``) at the shapes of ``chip_smoke.py``
(:data:`K3_SHAPES`, :data:`K4_SHAPES`).  An unmodified
body is first held to the plain version (``match``: K4 exactly, K3 at
rtol 1e-4 off the accept knife-edges) and, with ``--parent``, the current
K3 bitwise to the parent's (``parent_equal``); ``same`` says whether a
variant gives the unmodified body's result (an ablation changes it by
design, a launch shape must not).  One line per variant and shape; nothing
is written to the package.  A tuning aid: it shows which part of a kernel a
change would have to attack.

:func:`build_library`, :func:`library`, :func:`k3_inputs` and
:func:`k4_inputs` are also how ``chip_smoke.py --parent-csrc`` times the
parent's K3 and K4 beside the current ones.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import pathlib
import subprocess
import sys
import tempfile

import torch

from instruct_tpu_torch import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset, packed_dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.tetra import engine as te
from instruct_tpu_torch.tools import geno_zq_variants as gzv
from instruct_tpu_torch.tools import profiling
from instruct_tpu_torch.tools import site_pass_variants as spv

K3_SOURCE, K4_SOURCE = "dirichlet.cu", "allele_counts.cu"
HEADERS = ("philox.cuh",)
KERNEL_NAMES = {K3_SOURCE: "dirichlet_kernel", K4_SOURCE: "allele_counts"}

# K3 at the sweeps' shapes: kind (P on [C, K, L, A] or Q on [C, N, K]),
# then (C, K, L, A) or (C, N, K), and P's Philox stream
K3_SHAPES = {
    "main P": ("P", (4, 3, 10_000, 2), px.STREAM_P),
    "main Q": ("Q", (4, 1000, 3), None),
    "A=8 P": ("P", (4, 3, 2000, 8), px.STREAM_P),
    "grid P": ("P", (40, 10, 10_000, 2), px.STREAM_P),
    "grid Q": ("Q", (40, 1000, 10), None),
    "allo P2": ("P", (4, 3, 5000, 4), px.STREAM_P2),
}
# K4: (C, N, L, K, A, panel): the packed plane, the allele codes, or the
# tetraploid engine's diploid view of per-chain planes (L is the panel's)
K4_SHAPES = {
    "headline": (4, 1000, 10_000, 3, 2, "packed"),
    "headline codes": (4, 1000, 10_000, 3, 2, "codes"),
    "A=8": (4, 1000, 2000, 3, 8, "codes"),
    "wide": (4, 1000, 2000, 5, 16, "codes"),
    "tetra auto": (4, 500, 5000, 3, 4, "auto"),
    "tetra allo": (4, 500, 5000, 3, 4, "allo"),
}

_CHEAP_PHILOX = ("const Philox4 r = philox4x32_10(",
                 "const Philox4 r = a.k0 == 12345u && a.k1 == 54321u ? "
                 "philox4x32_10(")
K3_ABLATIONS = {
    # a cheap hash in place of the 10 rounds (keys never equal these)
    "no Philox rounds": [
        _CHEAP_PHILOX,
        ("a.k0, a.k1);\n            stage[q]",
         "a.k0, a.k1) : Philox4{(uint32_t)q * 2654435761u, chain, a.step, "
         "(uint32_t)k};\n            stage[q]")],
    "no gamma math": [("gj = gamma_cell(a.conc[off], ok, u, a.rounds);",
                       "gj = ok ? a.conc[off] * (u(0) + u(3 * a.rounds + "
                       "2)) : 0.0f;")],
    "no staging": [("        for (int q = lane; q < nd * a.slots; "
                    "q += kCols) {",
                    "        for (int q = lane; q < 0; q += kCols) {")],
}
K3_ABLATIONS["all of the above"] = [p for ps in K3_ABLATIONS.values()
                                    for p in ps]
K3_LAUNCH_SHAPES = {
    "cells spread over warps at any size": [
        ("#define DIRICHLET_SERIAL_TILES (8 * 132 * 8 * 4)",
         "#define DIRICHLET_SERIAL_TILES 0x7fffffff")],
    "one warp a block (cells serial)": [
        ("constexpr int kMaxWarps = 4;", "constexpr int kMaxWarps = 1;")],
    "two warps a block": [
        ("constexpr int kMaxWarps = 4;", "constexpr int kMaxWarps = 2;")],
}
K4_ABLATIONS = {
    # the per-copy work of both register bodies: one add, no compares
    "no counting": [("  for (int r = 0; r < NR; ++r) f[r] += ri == r ? "
                     "inc : 0u;", "  f[0] += inc + (uint32_t)ri;"),
                    ("  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & hv;",
                     "  return x & hv;")],
    "no table writes": [("    base[((long long)kk * a.L + ll) * a.A + al] "
                         "= (float)v;", "    if (v == 0xffffffffu) "
                         "base[((long long)kk * a.L + ll) * a.A + al] = "
                         "(float)v;")],
    "no cluster sums (own table only)": [
        ("part[s] = s < strips ? peer[s][i] : 0u;",
         "part[s] = s == 0 ? tab[i] : 0u;")],
    "every body the table": [("constexpr int kMaxCells = 64;",
                              "constexpr int kMaxCells = 0;"),
                             ("const bool table = !packed && K * A > "
                              "kCodesCells;", "const bool table = !packed;"),
                             ("} else if (cells <= kCodesCells) {",
                              "} else if (cells <= 0) {")],
    "no shared atomics (table body)": [
        ("        if (e0 >= 0) atomicAdd(tab + tab_at(e0, j, lane), 1u);\n"
         "        if (e1 >= 0) atomicAdd(tab + tab_at(e1, j, lane), 1u);",
         "        if (e0 == 99999 || e1 == 99999) "
         "atomicAdd(tab + tab_at(e0, j, lane), 1u);")],
}
# strips for a wave of half or twice as many SMs; 3 or 1 strips a tile
# where the tiles fill half a wave to two; the codes body's register fields
# up to 16 or 32 cells (4 or 8 registers a locus) in place of the table
K4_LAUNCH_SHAPES = {**{f"strips for {n} SMs": [f"COUNTS_SMS={n}"]
                       for n in (66, 264)},
                    **{f"{n} mid strips": [f"COUNTS_MID_STRIPS={n}"]
                       for n in (1, 3)},
                    "table body 4 rows at once": [
                        "COUNTS_TABLE_ROWS=4"],
                    **{f"codes fields to {n} cells": [
                        ("constexpr int kCodesCells = 8;",
                         f"constexpr int kCodesCells = {n};")]
                       for n in (16, 32)}}


def source_texts(csrc=_build.CSRC) -> dict:
    return {name: (pathlib.Path(csrc) / name).read_text()
            for name in HEADERS + (K3_SOURCE, K4_SOURCE)}


def build_library(work, tag: str, csrc, sources=(K3_SOURCE, K4_SOURCE)):
    """K3's and K4's sources of ``csrc`` compiled (in parallel), linked and
    loaded.  Returns (library, ptxas output)."""
    return spv.finish_build(spv.start_build(pathlib.Path(work), tag,
                                            source_texts(csrc), (), sources))


@contextlib.contextmanager
def library(lib):
    """Within the block the kernel wrappers launch through ``lib``."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        torch.cuda.synchronize()
        _build._lib = saved


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@functools.lru_cache(maxsize=None)
def k3_inputs(shape: str):
    """(run, plain_with_margins) of K3 at one of :data:`K3_SHAPES`: P on
    counts + 1 with a ragged allele mask, Q on counts + alpha < 1 with many
    cells below 1 (the boost)."""
    kind, dims, stream = K3_SHAPES[shape]
    g = _gen(5)
    keys = px.make_keys(2024, dims[0], "cuda")
    if kind == "P":
        c, k, l, a = dims
        counts = torch.randint(0, 400, (c, k, l, a), generator=g,
                               device="cuda").float() + 1.0
        valid = torch.rand((l, a), generator=g, device="cuda") > 0.05
        valid[:, :2] = True
        run = lambda: dk.dirichlet_kla(keys, 9, counts, valid, stream=stream)
        plain = lambda m: dk.dirichlet_kla_reference(
            keys, 9, counts, valid, stream=stream, margins=m)
        return run, plain, counts.numel()
    c, n, k = dims
    conc = (torch.randint(0, 3, (c, n, k), generator=g, device="cuda")
            .float() * torch.randint(0, 2, (c, n, k), generator=g,
                                     device="cuda").float() * 3000.0 + 0.08)
    run = lambda: dk.dirichlet_nk(keys, 9, conc)
    plain = lambda m: dk.dirichlet_nk_reference(keys, 9, conc, margins=m)
    return run, plain, conc.numel()


@functools.lru_cache(maxsize=None)
def k4_inputs(shape: str):
    """(z, geno, site_valid, kw) of ``allele_counts`` at one of
    :data:`K4_SHAPES` (``kw`` holds ``bits2`` on the packed panel)."""
    c, n, l, k, a, panel = K4_SHAPES[shape]
    g = _gen(7)
    if panel in ("auto", "allo"):
        # the engine's P counts: the diploid view of z and of the per-chain
        # latent genotype [C, N, 4L], over 2L loci
        spec = ModelSpec(mode=2, ploid=4, n_pops=k,
                         autopoly=panel == "auto")
        z = torch.randint(0, k, (c, n, 4 * l), generator=g, device="cuda",
                          dtype=torch.int8)
        geno = torch.randint(0, a, (c, n, 4 * l), generator=g,
                             device="cuda", dtype=torch.int8)
        valid = torch.rand((n, l), generator=g, device="cuda") > 0.1
        return (te.diploid_view(spec, z).contiguous(),
                te.diploid_view(spec, geno).contiguous(),
                valid.repeat(1, 2), dict(n_pops=k, max_alleles=a))
    z = torch.randint(0, k, (c, n, 2 * l), generator=g, device="cuda",
                      dtype=torch.int8)
    kw = dict(n_pops=k, max_alleles=a)
    if panel == "packed":
        data = packed_dataset(torch.randint(0, 8, (n, l), generator=g,
                                            device="cuda", dtype=torch.int8))
        kw["bits2"] = data.bits2
    else:
        geno = torch.randint(0, a, (n, 2 * l), generator=g, device="cuda",
                             dtype=torch.int8)
        data = Dataset(geno=geno,
                       site_valid=torch.rand((n, l), generator=g,
                                             device="cuda") > 0.1,
                       allele_valid=None, hom=None)
    return z, data.geno, data.site_valid, kw


def k4_run(shape: str, generic: bool = False):
    """One ``allele_counts`` call at the shape (through the allele codes
    where ``generic``, even on the packed panel)."""
    z, geno, valid, kw = k4_inputs(shape)
    if generic:
        kw = {key: v for key, v in kw.items() if key != "bits2"}
    return lambda: fs.allele_counts(z, geno, valid, **kw)


def k4_plain(shape: str):
    z, geno, valid, kw = k4_inputs(shape)
    kw = {key: v for key, v in kw.items() if key != "bits2"}
    return fs.allele_counts_reference(z, geno, valid, **kw)


def k3_matches(got, want, margin) -> bool:
    """Every cell within rtol 1e-4, atol 1e-6 of the plain version, apart
    from groups with an accept test within f32 rounding of its threshold
    (``chip_smoke.py:dirichlet_agrees``)."""
    off = ~torch.isclose(got, want, rtol=1e-4, atol=1e-6)
    knife = (margin < 1e-4).any(dim=-1, keepdim=True)
    return not bool((off & ~knife).any())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory whose bodies are timed beside")
    ap.add_argument("--only", choices=("k3", "k4"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    current = source_texts()
    # (source, tree, variant, texts, macros)
    plans = []
    for src, abl, shapes in ((K3_SOURCE, K3_ABLATIONS, K3_LAUNCH_SHAPES),
                             (K4_SOURCE, K4_ABLATIONS, K4_LAUNCH_SHAPES)):
        if args.only and (args.only == "k3") != (src == K3_SOURCE):
            continue
        plans.append((src, "current", "base", current, []))
        for tag, spec in shapes.items():
            if isinstance(spec[0], tuple):
                plans.append((src, "current", tag,
                              spv.patched(current, spec), []))
            else:
                plans.append((src, "current", tag, current, spec))
        plans += [(src, "current", tag, spv.patched(current, p), [])
                  for tag, p in abl.items()]
        if args.parent is not None:
            plans.append((src, "parent", "base",
                          source_texts(args.parent), []))
    with tempfile.TemporaryDirectory() as tmp:
        builds = [spv.start_build(pathlib.Path(tmp), str(i), texts, d,
                                  (src,))
                  for i, (src, _, _, texts, d) in enumerate(plans)]
        libs = [spv.finish_build(b) for b in builds]
        base = {}
        parent = {src: lib for (src, tree, _, _, _), (lib, _) in
                  zip(plans, libs) if tree == "parent"}
        for (src, tree, tag, _, _), (lib, ptxas) in zip(plans, libs):
            shapes = K3_SHAPES if src == K3_SOURCE else K4_SHAPES
            for shape in shapes:
                if src == K3_SOURCE:
                    run, plain, _ = k3_inputs(shape)
                else:
                    run = k4_run(shape, generic=tag == "every body the table")
                line = f"{src:16s} {tree:7s} {shape:10s} {tag:32s}"
                with library(lib):
                    out = run()
                    ms = spv.time_ms(run)
                    dev = profiling.device_ms(run, KERNEL_NAMES[src])
                # the plain versions draw their uniforms through the
                # package's own library
                if tag != "base":
                    line += f" same={torch.equal(out, base[(src, shape)])}"
                elif src == K3_SOURCE:
                    margins = []
                    want = plain(margins)
                    line += f" match={k3_matches(out, want, margins[0])}"
                    del want, margins
                else:
                    line += f" match={torch.equal(out, k4_plain(shape))}"
                if tag == "base" and tree == "current":
                    base[(src, shape)] = out
                    if src == K3_SOURCE and src in parent:
                        with library(parent[src]):
                            line += (" parent_equal="
                                     f"{torch.equal(out, run())}")
                    line += (" regs=[" + gzv.registers(
                        ptxas, KERNEL_NAMES[src]) + "]")
                print(f"{line} ms={ms:.4f} dev_ms={dev:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
