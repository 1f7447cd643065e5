"""Launch shapes of the seating kernel (``csrc/crp.cu``), and another
tree's body, timed at ``chip_smoke.py``'s seating shapes.

    python3 -m instruct_tpu_torch.tools.crp_variants [--parent DIR]

Builds ``crp.cu`` once a variant (its ``CRP_*`` macros; one ``nvcc`` a
variant, all started together) and, with ``--parent`` (another tree's
``instruct_tpu_torch/csrc``, a body with the first launch signature: no
noise spill), that tree's source.  Each body is held bitwise to the plain
version on every case, then timed by CUDA events (the median of 5 samples
of 2 back-to-back sweeps) in turns, twice (in order, then reversed), at C
= 4: N = 1000 in the three variants, alpha 10 and 10^4 (crowded), and the
selfing sweep at N = 5000 and 10 000, alpha 10 and 10^4.  The cases are
``chip_smoke.py:crp_case``'s.  Prints one JSON line a body; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import crp
from instruct_tpu_torch.tools import site_pass_variants as spv

SOURCES = ("crp.cu", "philox.cuh")
# name -> the macros of csrc/crp.cu it sets
VARIANTS = {
    "default": [],
    "8 warps (7 producers, one on the seater's scheduler)": ["CRP_WARPS=8"],
    "16 ring entries": ["CRP_DEPTH=16"],
}
# name -> kernels/crp.py's plan constants the variant needs
PLAN = {"16 ring entries": {"RING_DEPTH": 16}}
CASES = ([(v, 1000, a) for v in crp.VARIANTS for a in (10.0, 1e4)]
         + [(crp.SELFING, n, a) for n in (5000, 10_000) for a in (10.0, 1e4)])
# The first body's launch: values, counts, assign, log_new, new_val,
# new_idx, gen, ll_grid, out values, counts, assign, scratch, C, N, M,
# variant, k0, k1, chain_key, step, stream
FIRST_SIGNATURE = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_uint, ctypes.c_void_p])


def build(work, tag: str, csrc, defines=()):
    texts = {name: (pathlib.Path(csrc) / name).read_text()
             for name in SOURCES}
    return spv.start_build(pathlib.Path(work), tag, texts, list(defines),
                           ("crp.cu",))


def current_call(lib, name, args, kw):
    """The wrapper's sweep, launched through ``lib`` with the variant's
    plan constants."""
    def call():
        saved_lib = _build._lib
        saved = {k: getattr(crp, k) for k in PLAN.get(name, {})}
        _build._lib = lib
        for k, v in PLAN.get(name, {}).items():
            setattr(crp, k, v)
        try:
            return crp.crp_sweep(*args, **kw)
        finally:
            _build._lib = saved_lib
            for k, v in saved.items():
                setattr(crp, k, v)
    return call


def first_call(lib, args, kw):
    """The first body through its own launch signature (its table above
    4096 slots in a scratch row)."""
    fn = lib.crp_sweep_launch
    fn.argtypes, fn.restype = FIRST_SIGNATURE, ctypes.c_int
    keys, step, variant, values, counts, assign, log_new, new_val = args
    c, n = log_new.shape
    m = kw["ll_grid"].shape[2] if variant == crp.INBREEDING else 0
    ptr = _build.ptr

    def call():
        out = (torch.empty((c, n), device="cuda"),
               torch.empty((c, n), dtype=torch.int32, device="cuda"),
               torch.empty((c, n), dtype=torch.int32, device="cuda"))
        scratch = (torch.empty((c, n, 4), device="cuda") if n > 4096
                   else None)
        rc = fn(ptr(values), ptr(counts), ptr(assign), ptr(log_new),
                ptr(new_val), ptr(kw.get("new_idx")), ptr(kw.get("gen")),
                ptr(kw.get("ll_grid")), *[ptr(x) for x in out],
                ptr(scratch), c, n, m, variant, keys.k0, keys.k1,
                ptr(keys.chain_key), step,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the first seating body failed to launch "
                               f"({rc})")
        return out
    return call


def time_ms(fn, reps: int = 5, warm: int = 1, inner: int = 2) -> float:
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
    return sorted(times)[len(times) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree's instruct_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    # chip_smoke.py holds the cases; it sits at the root of the checkout
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    work = _build.BUILD / "crp_variants"
    shutil.rmtree(work, ignore_errors=True)
    builds = {name: build(work, f"v{i}", _build.CSRC, VARIANTS[name])
              for i, name in enumerate(VARIANTS)}
    if args.parent:
        builds["parent"] = build(work, "parent", args.parent)
    libs = {name: spv.finish_build(b)[0] for name, b in builds.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    times = {name: {} for name in libs}
    for variant, n, alpha in CASES:
        sweep_args, kw = cs.crp_case(variant, n, alpha=alpha)
        want = crp.crp_sweep_reference(*sweep_args, **kw)
        calls = {name: (first_call(lib, sweep_args, kw) if name == "parent"
                        else current_call(lib, name, sweep_args, kw))
                 for name, lib in libs.items()}
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: {crp.VARIANTS[variant]} N = "
                                     f"{n}, alpha {alpha} differs from the "
                                     "plain version")
        key = f"{crp.VARIANTS[variant]}, N={n}, alpha {alpha:g}"
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                times[name].setdefault(key, []).append(
                    round(time_ms(calls[name]), 4))
    for name, t in times.items():
        print(json.dumps({"variant": name, "card": card,
                          "macros": VARIANTS.get(name, []), "ms": t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
