#!/usr/bin/env python3
"""Time variants of the port's site-pass kernel on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.site_pass_variants [--k K] [--c C]
        [--generic] [--parent CSRC_DIR]

Compiles the four site-pass sources of ``instruct_tpu_torch/csrc``
(``site_pass.cuh`` with ``quad.cuh`` and ``philox.cuh``) several times with
``nvcc`` for one body only (``SITE_K_ONLY``: K itself for K <= 8, else its
pop bucket) -- once per launch shape (the ``SITE_THREADS``,
``SITE_STAGE_ROWS`` and ``SITE_MIN_BLOCKS`` macros of the source, or a
textual patch of a constant) and once per ablation (a textual patch that
removes one part of the sampling kernel's work) -- and times
``zq_gendiff_pass`` through each library at C chains, N = 1000 and
L = 10 000 (packed panel, or the same panel without its packed plane with
``--generic``; the headline panel's K = 3, or K pops of random q and P),
with CUDA events over runs of 10 back-to-back launches.  ``same`` says
whether z, qqnum and zcounts equal the unmodified kernel's (an ablation
changes the result by design; a launch shape must not); ``registers`` is
what ``ptxas`` printed for the body's gendiff instantiation.  K <= 8 times
the packed K <= 8 body's launch shapes and ablations, K > 8 the wide body's
(``--parent`` also builds the sources of another ``csrc`` directory, as a
whole, and times its body with 16-row strips, the plan of the first wide
body).  One line per variant; nothing is written to the package.  A tuning
aid: it shows which part of the kernel a change would have to attack before
one is written.

:func:`build_site_library` and :func:`site_library` are also how
``chip_smoke.py --parent-csrc`` times an earlier body beside the current
one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px

N, L = 1000, 10_000
GENDIFF = 3            # the family id of zq_gendiff_pass (site_pass.cuh)

SOURCES = ("site_packed_sample.cu", "site_packed_eval.cu",
           "site_generic_sample.cu", "site_generic_eval.cu")
HEADERS = ("site_pass.cuh", "quad.cuh", "philox.cuh")

SHAPES = {
    "base": [],
    "min_blocks=6": ["SITE_MIN_BLOCKS=6"],
    "stage_rows=4": ["SITE_STAGE_ROWS=4"],
    "stage_rows=16": ["SITE_STAGE_ROWS=16"],
    "threads=256": ["SITE_THREADS=256", "SITE_MIN_BLOCKS=2"],
}
# launch shape by patch: strips long enough for one wave of blocks (about
# 110 rows a strip at the headline shape) instead of 16-row strips
SHAPE_PATCHES = {
    "strips of 112 rows": [
        ("constexpr int kStripRows = 16;", "constexpr int kStripRows = 112;")],
}

# (text in the source, replacement): each removes one part of the work
_NO_PHILOX = [
    ("const Philox4 a = philox4x32_10(blk, STREAM_Z, step, chain, k0, k1);",
     "const Philox4 a = Philox4{blk * 2654435761u + step, blk * 40503u "
     "+ chain, blk * 2246822519u + k0, blk * 3266489917u + k1};")]
_NO_LOG = [("acc[0] = acc[0] + logf(ratio);", "acc[0] = acc[0] + ratio;")]
_NO_Z_STORES = [
    ("store_bytes(zrow, l0, L, vec, z0v);",
     "if (cv0 == 12345.0f) store_bytes(zrow, l0, L, vec, z0v);"),
    ("store_bytes(zrow + L, l0, L, vec, z1v);",
     "if (cv0 == 12345.0f) store_bytes(zrow + L, l0, L, vec, z1v);")]
_NO_REDUCTIONS = [
    ("for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(",
     "for (int o = 16; o >= 16; o >>= 1) v = v + __shfl_xor_sync("),
    ("const uint32_t s2 = __reduce_add_sync(0xffffffffu, pair);",
     "const uint32_t s2 = pair;"),
    ("s2 = (float)__reduce_add_sync(0xffffffffu, het);", "s2 = (float)het;")]
_NO_TICKETS = [("if (last == 0) return;", "if (last >= 0) return;")]
ABLATIONS = {
    "no count partials": [
        ("if (j < n_live) dst[l0 + j] = cnt[j][k];",
         "if (j < n_live && cnt[j][k] == 12345u) dst[l0 + j] = cnt[j][k];")],
    "no Philox rounds": _NO_PHILOX,
    "no log": _NO_LOG,
    "no z stores": _NO_Z_STORES,
    "no warp reductions": _NO_REDUCTIONS,
    "no async staging": [
        ("cp_async4(&stage[buf][w][rr][tid], src[w] + l0);",
         "stage[buf][w][rr][tid] = "
         "*reinterpret_cast<const uint32_t*>(src[w] + l0);")],
    "no ticket reductions": _NO_TICKETS,
}
ABLATIONS["all of the above"] = [p for ps in list(ABLATIONS.values())
                                 for p in ps]
# the wide body (K > 8): its own parts, then the shared ones
WIDE_ABLATIONS = {
    "no count bytes": [
        ("wcnt2[z0 * kPlane + col] += (uint16_t)(v0 + v1);", ""),
        ("wcnt2[z0 * kPlane + col] += (uint16_t)v0;", ""),
        ("wcnt2[z1 * kPlane + col] += (uint16_t)v1;", ""),
        ("if (in0) wcnt[(z0 * A + g0) * kPlane + col] += 1;", ""),
        ("if (in1) wcnt[(z1 * A + g1) * kPlane + col] += 1;", "")],
    "no count atomics": [
        ("if (j < n_live && zeros != 0u)", "if (j < n_live && zeros == 7u)"),
        ("if (j < n_live && ones != 0u)", "if (j < n_live && ones == 7u)"),
        ("if (j < n_live && v != 0u)\n              atomicAdd(total",
         "if (j < n_live && v == 7u)\n              atomicAdd(total")],
    "no P staging": [
        ("cp_async8(&wp2[k * kPlane + col], src + 2 * li);",
         "wp2[k * kPlane + col] = make_float2(0.5f, 0.25f);"),
        ("cp_async4(&wpa[(k * A + al) * kPlane + col], src + li * A + al);",
         "wpa[(k * A + al) * kPlane + col] = 0.5f;")],
    "no draw count": [
        ("zz0 += ut0 > cum0[kc + i] ? 1 : 0;", ""),
        ("zz1 += ut1 > cum1[kc + i] ? 1 : 0;", "")],
    "one run of 4 pops": [("if (kc >= nk) break;", "if (kc >= 4) break;")],
    "no qqnum words": [
        ("const uint64_t b0 = 1ull << (4 * (z0 & 15));",
         "const uint64_t b0 = z0 == 99 ? 1ull : 0ull;"),
        ("const uint64_t b1 = 1ull << (4 * (z1 & 15));",
         "const uint64_t b1 = z1 == 99 ? 1ull : 0ull;")],
    "no Philox rounds": _NO_PHILOX,
    "no log": _NO_LOG,
    "no z stores": _NO_Z_STORES,
    "no warp reductions": _NO_REDUCTIONS,
    "no ticket reductions": _NO_TICKETS,
}
WIDE_ABLATIONS["all of the above"] = [p for ps in WIDE_ABLATIONS.values()
                                      for p in ps]
# the wide body's launch shapes: its strips' longest (rows), its rows
# staged at a time and the pops a run of its prefix loops
WIDE_STRIPS = (16, 32, 128)
WIDE_SHAPES = {"base": [], "wide stage rows=8": ["SITE_WIDE_STAGE_ROWS=8"],
               "run of 4 pops": ["SITE_WIDE_RUN=4"],
               "run of 1 pop": ["SITE_WIDE_RUN=1"]}


def patched(texts: dict, patches) -> dict:
    """``texts`` (name -> source text) with each (old, new) patch applied
    where ``old`` occurs; raises if one occurs nowhere."""
    out = dict(texts)
    for old, new in patches:
        hit = [name for name in out if old in out[name]]
        if not hit:
            raise RuntimeError(f"{old!r} is no longer in "
                               f"{' or '.join(sorted(out))}")
        out[hit[0]] = out[hit[0]].replace(old, new)
    return out


def source_texts(csrc: pathlib.Path = _build.CSRC) -> dict:
    return {name: (pathlib.Path(csrc) / name).read_text()
            for name in HEADERS + SOURCES}


def start_build(work: pathlib.Path, tag: str, texts: dict, defines=(),
                sources=SOURCES) -> dict:
    """Start compiling ``sources`` of ``texts`` (one ``nvcc`` per source,
    all at once); :func:`finish_build` links and loads them."""
    inc = pathlib.Path(work) / f"v{tag}"
    inc.mkdir(parents=True)
    for name, text in texts.items():
        (inc / name).write_text(text)
    nvcc = _build.find_nvcc()
    procs = []
    for src in sources:
        obj = inc / (src[:-3] + ".o")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(inc),
               *[f"-D{d}" for d in defines], "-c", str(inc / src), "-o",
               str(obj)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return dict(inc=inc, tag=tag, procs=procs)


def finish_build(build: dict):
    """Wait for :func:`start_build`'s compiles, link them and load the
    library with the launch functions' signatures.  Returns (library,
    ptxas output)."""
    log = []
    for obj, proc in build["procs"]:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {build['tag']}:\n"
                               f"{out}")
    so = build["inc"] / "lib.so"
    link = subprocess.run(
        [_build.find_nvcc(), "-shared", "-gencode",
         "arch=compute_90a,code=sm_90a", "-o", str(so),
         *[str(obj) for obj, _ in build["procs"]]], capture_output=True,
        text=True)
    if link.returncode:
        raise RuntimeError(f"linking variant {build['tag']} failed:\n"
                           f"{link.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, "\n".join(log)


def build_site_library(work: pathlib.Path, tag: str, texts: dict,
                       defines=(), sources=SOURCES):
    """Compile ``sources`` of ``texts`` in parallel, link them and load the
    library.  Returns (library, ptxas output)."""
    return finish_build(start_build(work, tag, texts, defines, sources))


def registers(ptxas: str, k: int, fam: int = GENDIFF) -> str:
    """'registers, spills' that ptxas printed for the body of K (its bucket
    when K > 8) and family ``fam``, of the first source that has it."""
    body = k if k <= fs.WIDE_POPS else next(b for b in fs.WIDE_BUCKETS
                                             if k <= b)
    lines = ptxas.splitlines()
    for tag in (body, 0):        # 0: a body with one wide instantiation
        for i, line in enumerate(lines):
            if (f"site_kernelILi{tag}ELi{fam}E" in line
                    and "Function properties" in line):
                regs = lines[i + 2].split("Used ")[1].split(",")[0]
                return f"{regs}, {lines[i + 1].split(',')[1].strip()}"
    return "?"


@contextlib.contextmanager
def site_library(lib, strip_rows=None):
    """Within the block the site-pass wrappers launch through ``lib`` (and
    the wide body's plan takes strips of at most ``strip_rows`` rows, when
    given); the scratch is dropped before and after."""
    saved = (_build._lib, fs.WIDE_STRIP_ROWS)
    fs._SCRATCH.clear()
    _build._lib = lib
    if strip_rows is not None:
        fs.WIDE_STRIP_ROWS = strip_rows
    try:
        yield
    finally:
        torch.cuda.synchronize()
        _build._lib, fs.WIDE_STRIP_ROWS = saved
        fs._SCRATCH.clear()


def time_ms(fn, reps=20, inner=10):
    for _ in range(3):
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


def inputs(c: int, k: int, generic: bool):
    """(keys, q, freq, data, wg_pair) on the card: the headline panel, with
    K pops of random q (admixture 0.1) and P."""
    panel = synthetic_panel(N, L, n_pops=3, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, seed=17)
    data = panel.data.to("cuda")
    if generic:
        data = data._replace(bits2=None)
    g = torch.Generator(device="cuda").manual_seed(99)
    gam = torch._standard_gamma(torch.full((c, k, L, 2), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((c, N, k), 0.1, device="cuda"),
                               generator=g).clamp_min(1e-20)
    q = (gq / gq.sum(-1, keepdim=True)).contiguous()
    gen = torch.randint(1, 9, (c, N, 2), generator=g, device="cuda")
    wg_pair = torch.exp2(1.0 - gen.float()).contiguous()
    return px.make_keys(2024, c, "cuda"), q, freq, data, wg_pair


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--c", type=int, default=4)
    ap.add_argument("--generic", action="store_true")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory whose body is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    k, wide = args.k, args.k > fs.WIDE_POPS
    keys, q, freq, data, wg_pair = inputs(args.c, k, args.generic)

    def run():
        z, qq, _, zc = fs.zq_gendiff_pass(keys, 5, q, freq, data, wg_pair,
                                          structure=True)
        return z, qq, zc

    texts = source_texts()
    only = [f"SITE_K_ONLY={k}"]
    variants = [(tag, texts, only + d)
                for tag, d in (WIDE_SHAPES if wide else SHAPES).items()]
    if wide:
        variants += [(f"strips of {r} rows", texts, only, r)
                     for r in WIDE_STRIPS]
    else:
        variants += [(tag, patched(texts, p), only)
                     for tag, p in SHAPE_PATCHES.items()]
    variants += [(tag, patched(texts, p), only) for tag, p in
                 (WIDE_ABLATIONS if wide else ABLATIONS).items()]
    if args.parent is not None:
        variants.append(("parent body (16-row strips)",
                         source_texts(args.parent), [], fs.MIN_STRIP_ROWS))
    # the packed sampling source (which also has the tiles and strips
    # functions), and the generic one for --generic; the parent as a whole
    sources = ["site_packed_sample.cu"] + (
        ["site_generic_sample.cu"] if args.generic else [])
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        builds = [start_build(pathlib.Path(tmp), str(i), src, defines,
                              sources if defines else SOURCES)
                  for i, (tag, src, defines, *rows) in enumerate(variants)]
        for build, (tag, src, defines, *rows) in zip(builds, variants):
            lib, ptxas = finish_build(build)
            with site_library(lib, rows[0] if rows else None):
                out = run()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"{tag:30s} ms={time_ms(run):.4f} same={same} "
                      f"registers={registers(ptxas, k)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
