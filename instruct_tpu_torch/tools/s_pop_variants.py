#!/usr/bin/env python3
"""Time variants of the port's S-tail kernel on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.s_pop_variants

Compiles ``instruct_tpu_torch/csrc/s_pop.cu`` several times with ``nvcc``
-- once per block size (a textual patch of ``kThreads``) and once per
ablation (a patch that removes one part of the kernel's work: the two logs
of the target, the G proposal after the MH loop) -- and times the
``s_pop_tail`` launch of each at the headline shapes (4 chains, N = 1000,
K = 3, J = 12 subsweeps) beside the latency floor of the same build (J*K + 1
dependent reductions of N floats, ``s_pop_floor_launch``).  Times are the
device time per launch from ``torch.profiler`` (the kernels last tens of
microseconds, less than the host takes to enqueue one, so CUDA events
around back-to-back launches would read the host).  One line per variant;
nothing is written to the package.  A tuning aid.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

C, N, K, J = 4, 1000, 3, 12

# (text in the source, replacement)
VARIANTS = {
    "threads=512 (as built)": [],
    "threads=256": [("constexpr int kThreads = 512;",
                     "constexpr int kThreads = 256;")],
    "threads=1024": [("constexpr int kThreads = 512;",
                      "constexpr int kThreads = 1024;")],
    "no target logs": [
        ("  const float a = g1 > 0.0f ? g1 * logf(fmaxf(sb, kEps)) : 0.0f;\n"
         "  return a + logf(fmaxf(1.0f - sb, kEps));",
         "  return sb + g1;")],
    "no G proposal": [("      if (m < items) gen_proposal(",
                       "      if (m < 0) gen_proposal(")],
}


def device_ms(fn, name: str, n: int = 30):
    """Device time of one ``fn()`` in ms: the profiler's total for kernels
    whose name holds ``name``, over their count (None where the profiler
    recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "self_device_time_total", 0.0)
            count += ev.count
    return total / count / 1e3 if count else None


def build(work: pathlib.Path, tag: str, text: str):
    d = work / tag
    d.mkdir()
    (d / "s_pop.cu").write_text(text)
    so = d / "s_pop.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.CSRC), "-o", str(so),
                        str(d / "s_pop.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on variant {tag}:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("s_pop_tail_launch", "s_pop_floor_launch"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator("cuda").manual_seed(1)
    x = -torch.log(torch.rand((C, N, K), generator=g, device="cuda"))
    q = (x / x.sum(-1, keepdim=True)).contiguous()
    gen = torch.randint(1, 9, (C, N), generator=g, device="cuda",
                        dtype=torch.int32)
    rates = (torch.rand((C, K), generator=g, device="cuda") * 0.9
             + 0.05).contiguous()
    xf = torch.rand((C, N), generator=g, device="cuda")
    keys = px.make_keys(2024, C, "cuda")
    outs = [torch.empty((C, K), device="cuda"),
            torch.empty((C, N), dtype=torch.int32, device="cuda"),
            torch.empty((C, N, 2), device="cuda"),
            torch.empty((C, N), device="cuda")]
    floor_out = torch.empty(C, device="cuda")
    p = _build.ptr
    source = (_build.CSRC / "s_pop.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, patches) in enumerate(VARIANTS.items()):
            text = source
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"variant {tag!r}: {old!r} is no "
                                       "longer in s_pop.cu")
                text = text.replace(old, new)
            lib = build(pathlib.Path(tmp), f"v{i}", text)
            stream = torch.cuda.current_stream().cuda_stream

            def tail():
                rc = lib.s_pop_tail_launch(
                    p(q), p(gen), p(rates), None, None, None, None, None,
                    *[p(o) for o in outs], C, N, K, J, 0.05, 50, keys.k0,
                    keys.k1, p(keys.chain_key), 7, stream)
                if rc:
                    raise RuntimeError(f"launch refused: {rc}")

            def floor():
                rc = lib.s_pop_floor_launch(p(xf), p(floor_out), C, N,
                                            J * K + 1, stream)
                if rc:
                    raise RuntimeError(f"launch refused: {rc}")

            print(json.dumps(dict(variant=tag,
                                  tail_ms=device_ms(tail, "s_pop_tail"),
                                  floor_ms=device_ms(floor, "s_pop_floor"))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
