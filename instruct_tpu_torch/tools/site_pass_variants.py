#!/usr/bin/env python3
"""Time variants of the port's site-pass kernel on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.site_pass_variants

Compiles the packed sampling instantiation of
``instruct_tpu_torch/csrc/site_pass.cuh`` (with its ``quad.cuh``) several
times with ``nvcc`` (K = 3 only) -- once per launch shape (the
``SITE_THREADS``, ``SITE_STAGE_ROWS`` and ``SITE_MIN_BLOCKS`` macros of the
source) and once per ablation (a textual
patch that removes one part of the sampling kernel's work: the strip count
partials, the Philox rounds, the log, the z stores, the warp reductions, the
asynchronous staging (plain loads instead), the last blocks' ticket
reductions) -- and times the ``zq_gendiff_pass`` launch of each at the
headline shapes (4 chains, N = 1000, L = 10 000, K = 3), with CUDA events
over runs of 10 back-to-back launches.  ``same`` says whether z, qqnum and zcounts
equal the unmodified kernel's (an ablation changes the result by design; a
launch shape must not).  One line per variant; nothing is written to the
package.  A tuning aid: it shows which part of the kernel a change would
have to attack before one is written.
"""

from __future__ import annotations

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
from instruct_tpu_torch.kernels import philox as px

C, N, L, K = 4, 1000, 10_000, 3

SHAPES = {
    "base": [],
    "min_blocks=6": ["SITE_MIN_BLOCKS=6"],
    "stage_rows=4": ["SITE_STAGE_ROWS=4"],
    "stage_rows=16": ["SITE_STAGE_ROWS=16"],
    "threads=256": ["SITE_THREADS=256", "SITE_MIN_BLOCKS=2"],
}

# (text in the source, replacement): each removes one part of the work
ABLATIONS = {
    "no count partials": [
        ("if (j < n_live) dst[l0 + j] = cnt[j][k];",
         "if (j < n_live && cnt[j][k] == 12345u) dst[l0 + j] = cnt[j][k];")],
    "no Philox rounds": [
        ("const Philox4 a = philox4x32_10(blk, STREAM_Z, step, chain, k0, "
         "k1);",
         "const Philox4 a = Philox4{blk * 2654435761u + step, blk * 40503u "
         "+ chain, blk * 2246822519u + k0, blk * 3266489917u + k1};")],
    "no log": [("acc[0] = acc[0] + logf(ratio);",
                "acc[0] = acc[0] + ratio;")],
    "no z stores": [
        ("store_bytes(zrow, l0, L, vec, z0v);",
         "if (cv0 == 12345.0f) store_bytes(zrow, l0, L, vec, z0v);"),
        ("store_bytes(zrow + L, l0, L, vec, z1v);",
         "if (cv0 == 12345.0f) store_bytes(zrow + L, l0, L, vec, z1v);")],
    "no warp reductions": [
        ("for (int o = 16; o >= 1; o >>= 1) v = v + __shfl_xor_sync(",
         "for (int o = 16; o >= 16; o >>= 1) v = v + __shfl_xor_sync("),
        ("const uint32_t s2 = __reduce_add_sync(0xffffffffu, pair);",
         "const uint32_t s2 = pair;"),
        ("s2 = (float)__reduce_add_sync(0xffffffffu, het);",
         "s2 = (float)het;")],
    "no async staging": [
        ("cp_async4(&stage[buf][w][rr][tid], src[w] + l0);",
         "stage[buf][w][rr][tid] = "
         "*reinterpret_cast<const uint32_t*>(src[w] + l0);")],
    "no ticket reductions": [
        ("if (last == 0) return;", "if (last >= 0) return;")],
}
# launch shape by patch: strips long enough for one wave of blocks (about
# 110 rows a strip at the headline shape) instead of 16-row strips
SHAPE_PATCHES = {
    "strips of 112 rows": [
        ("constexpr int kStripRows = 16;", "constexpr int kStripRows = 112;")],
}
ABLATIONS["all of the above"] = [p for ps in list(ABLATIONS.values())
                                 for p in ps]


LAUNCH = "site_packed_sample_launch"
GENDIFF = 3            # the family id of zq_gendiff_pass (site_pass.cuh)


HEADERS = ("site_pass.cuh", "quad.cuh")


def build(work: pathlib.Path, tag: str, headers: dict, defines):
    """Compile the packed sampling source against the (patched) texts of
    ``HEADERS``, for K = 3 only."""
    inc = work / f"v{tag}"
    inc.mkdir()
    for name, text in headers.items():
        (inc / name).write_text(text)
    src = inc / "site_packed_sample.cu"
    src.write_text((_build.CSRC / "site_packed_sample.cu").read_text())
    so = work / f"v{tag}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(inc),
           "-I", str(_build.CSRC), f"-DSITE_K_ONLY={K}",
           *[f"-D{d}" for d in defines], "-o", str(so), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on variant {tag}:\n{r.stderr}")
    regs = "?"
    lines = r.stderr.splitlines()
    for i, line in enumerate(lines):
        if (f"site_kernelILi{K}ELi{GENDIFF}E" in line
                and "Function properties" in line):
            regs = lines[i + 2].split("Used ")[1].split(",")[0]
            spill = lines[i + 1].split(",")[1].strip()
            regs = f"{regs}, {spill}"
    lib = ctypes.CDLL(str(so))
    getattr(lib, LAUNCH).argtypes = _build._SIGNATURES[LAUNCH]
    getattr(lib, LAUNCH).restype = ctypes.c_int
    for fn in ("site_pass_tiles", "site_pass_strips"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    panel = synthetic_panel(N, L, n_pops=K, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, seed=17)
    bits2 = panel.data.bits2.cuda()
    g = torch.Generator(device="cuda").manual_seed(99)
    gam = torch._standard_gamma(torch.full((C, K, L, 2), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((C, N, K), 0.3, device="cuda"),
                               generator=g).clamp_min(1e-20)
    q = (gq / gq.sum(-1, keepdim=True)).contiguous()
    gen = torch.randint(1, 9, (C, N, 2), generator=g, device="cuda")
    wg_pair = torch.exp2(1.0 - gen.float()).contiguous()
    keys = px.make_keys(2024, C, "cuda")

    scratch = {}

    def run(lib):
        if id(lib) not in scratch:
            t, s = lib.site_pass_tiles(L), lib.site_pass_strips(N)
            scratch[id(lib)] = (
                torch.empty((C, N, t, K + 2), dtype=torch.float32,
                            device="cuda"),
                torch.empty((C, s, K, L), dtype=torch.int32, device="cuda"),
                torch.zeros(C * s + C * t, dtype=torch.int32, device="cuda"),
                s)
        part, cnt, tickets, s = scratch[id(lib)]
        f32 = dict(dtype=torch.float32, device="cuda")
        z = torch.empty((C, N, 2 * L), dtype=torch.int8, device="cuda")
        qq, zc = torch.empty((C, N, K), **f32), torch.empty((C, K, L, 2),
                                                            **f32)
        ll = torch.empty((C, N), **f32)
        rc = getattr(lib, LAUNCH)(
            q.data_ptr(), freq.data_ptr(), bits2.data_ptr(), None, None,
            None, None, wg_pair.data_ptr(), None, None, z.data_ptr(),
            qq.data_ptr(), zc.data_ptr(), ll.data_ptr(), part.data_ptr(),
            cnt.data_ptr(), tickets.data_ptr(), C, N, L, K, 2, GENDIFF, 1, s,
            0, keys.k0, keys.k1, keys.chain_key.data_ptr(), 5,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch refused: cudaGetLastError = {rc}")
        return z, qq, zc

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

    source = {name: (_build.CSRC / name).read_text() for name in HEADERS}
    variants = [(tag, source, d) for tag, d in SHAPES.items()]
    for tag, patches in SHAPE_PATCHES.items():
        src = dict(source)
        for old, new in patches:
            if old not in src["site_pass.cuh"]:
                raise RuntimeError(f"shape {tag!r}: {old!r} is no longer in "
                                   "site_pass.cuh")
            src["site_pass.cuh"] = src["site_pass.cuh"].replace(old, new)
        variants.append((tag, src, []))
    for tag, patches in ABLATIONS.items():
        src = dict(source)
        for old, new in patches:
            hit = [name for name in HEADERS if old in src[name]]
            if not hit:
                raise RuntimeError(f"ablation {tag!r}: {old!r} is no longer "
                                   f"in {' or '.join(HEADERS)}")
            src[hit[0]] = src[hit[0]].replace(old, new)
        variants.append((tag, src, []))
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, src, defines) in enumerate(variants):
            lib, regs = build(pathlib.Path(tmp), str(i), src, defines)
            out = run(lib)
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"{tag:28s} ms={time_ms(lambda: run(lib)):.4f} "
                  f"same={same} registers={regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
