"""Launch shapes of the G-curve kernel (``csrc/gen_curve.cu``), and another
tree's body, timed at the gradient samplers' shapes.

    python3 -m instruct_tpu_torch.tools.gen_curve_variants [--parent DIR]

Builds ``gen_curve.cu`` once a variant (its ``GEN_*`` macros; one ``nvcc``
a variant, all started together) and, with ``--parent`` (another tree's
``instruct_tpu_torch/csrc``), that tree's source; times each body's
forward at B = 4 and B = 128 and its backward at B = 4 on the headline
panel (N = 1000, L = 10 000, K = 3, G = 50): CUDA events, the median of 10
samples of 5 back-to-back calls (B = 128: 5 of 2), the bodies in turns,
twice (in order, then reversed).  Each variant's curve and gradients are
held to the default body's before it is timed (within 1e-4 of each
tensor's largest magnitude: the variants change rounding, not the
algebra).  The default body's backward is also split into its kernels by
the profiler's device time.  The first body (whose library has
``gen_curve_strip_rows``) is called through its own launch signatures.
Prints one JSON line a body; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from instruct_tpu_torch import synthetic_panel
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import gen_curve as gc
from instruct_tpu_torch.tools import profiling
from instruct_tpu_torch.tools import site_pass_variants as spv

SOURCE = "gen_curve.cu"
# name -> the macros of csrc/gen_curve.cu it sets
VARIANTS = {
    "default": [],
    "forward 3 blocks an SM": ["GEN_FWD_MIN_BLOCKS=3"],
    "forward 8 sites unrolled": ["GEN_FWD_UNROLL=8"],
    "forward 2 sites unrolled": ["GEN_FWD_UNROLL=2"],
    "backward 2 blocks an SM, 8 sites unrolled": ["GEN_BWD_MIN_BLOCKS=2",
                                                  "GEN_BWD_UNROLL=8"],
    "backward 4 sites unrolled": ["GEN_BWD_UNROLL=4"],
    "backward 2 chunks a block": ["GEN_BWD_SEGMENT=2"],
    "backward 8 chunks a block": ["GEN_BWD_SEGMENT=8"],
    "logf on the fast paths": ["GEN_FAST_LOG=0"],
}
# The first body's backward launch: q, p, geno, hom, valid,
# dper_gen, dm0, dm1, dq, strip partials, dp, B, N, L, K, A, G, stream
FIRST_BWD_SIGNATURE = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])


def build(work, tag: str, csrc, defines=()):
    """Start compiling ``csrc``'s G-curve source with ``defines``;
    :func:`spv.finish_build` links and loads it."""
    text = (pathlib.Path(csrc) / SOURCE).read_text()
    return spv.start_build(pathlib.Path(work), tag, {SOURCE: text},
                           list(defines), (SOURCE,))


def is_first_body(lib) -> bool:
    return getattr(lib, "gen_curve_strip_rows", None) is not None


def through(lib, fn, *args):
    """``fn(*args)`` with the kernel wrappers launching through ``lib``
    (a launch only reads the library; nothing waits for the card)."""
    saved = _build._lib
    _build._lib = lib
    try:
        return fn(*args)
    finally:
        _build._lib = saved


def first_body_call(lib, q, p, data, g: int, dper=None):
    """The first body's forward (``dper`` None) or backward through its
    own launch signatures: its [2, B, N, L] planes and strip partials
    allocated as its wrapper allocated them.  Returns per_gen or (dq,
    dp)."""
    lib.gen_curve_strip_rows.argtypes = [ctypes.c_int]
    lib.gen_curve_strip_rows.restype = ctypes.c_int
    lib.gen_curve_bwd_launch.argtypes = FIRST_BWD_SIGNATURE
    lib.gen_curve_bwd_launch.restype = ctypes.c_int
    ptr, stream = _build.ptr, torch.cuda.current_stream().cuda_stream
    b, n, k = q.shape
    l, a = data.n_loci, data.max_alleles
    panel = (ptr(q), ptr(p), ptr(data.geno), ptr(data.hom),
             ptr(data.site_valid))
    if dper is None:
        out = torch.empty((b, n, g), dtype=torch.float32, device=q.device)
        rc = lib.gen_curve_fwd_launch(*panel, ptr(out), b, n, l, k, a, g,
                                      stream)
    else:
        dm = torch.empty((2, b, n, l), dtype=torch.float32, device=q.device)
        dq, dp = torch.empty_like(q), torch.empty_like(p)
        rows = lib.gen_curve_strip_rows(n)
        part = torch.empty((-(-n // rows),) + tuple(p.shape),
                           dtype=torch.float32, device=q.device)
        rc = lib.gen_curve_bwd_launch(*panel, ptr(dper), ptr(dm[0]),
                                      ptr(dm[1]), ptr(dq), ptr(part),
                                      ptr(dp), b, n, l, k, a, g, stream)
        out = (dq, dp)
    if rc:
        raise RuntimeError(f"the first G-curve body failed to launch ({rc})")
    return out


def body_calls(lib, q, p, data, g: int, dper):
    """(forward, backward) of the body in ``lib`` as zero-argument calls
    on these inputs."""
    if is_first_body(lib):
        return (lambda: first_body_call(lib, q, p, data, g),
                lambda: first_body_call(lib, q, p, data, g, dper))

    return (lambda: through(lib, gc._forward, q, p, data, g),
            lambda: through(lib, gc._backward, q, p, data, g, dper))


def time_ms(fn, reps: int = 10, warm: int = 2, inner: int = 5) -> float:
    """Median device time of one ``fn()`` (CUDA events over ``inner``
    back-to-back calls, ``reps`` samples, after ``warm`` calls)."""
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
    return float(np.median(times))


def inputs(data, b: int, k: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    q = torch.softmax(1.5 * torch.randn((b, n, k), generator=g,
                                        device="cuda"), -1)
    p = torch.softmax(1.5 * torch.randn((b, k, l, a), generator=g,
                                        device="cuda"), -1)
    return q.contiguous(), p.contiguous()


def close(got, want, tol=1e-4) -> bool:
    got, want = got.double(), want.double()
    return bool((got - want).abs().max() <= tol * want.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another tree's instruct_tpu_torch/csrc")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    work = _build.BUILD / "gen_curve_variants"
    shutil.rmtree(work, ignore_errors=True)
    names = [x for x in VARIANTS
             if args.only is None or x in args.only.split(",")]
    builds = {name: build(work, f"v{i}", _build.CSRC, VARIANTS[name])
              for i, name in enumerate(names)}
    if args.parent:
        builds["parent"] = build(work, "parent", args.parent)
    libs, ptxas = {}, {}
    for name, started in builds.items():
        libs[name], ptxas[name] = spv.finish_build(started)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    panel = synthetic_panel(1000, 10_000, n_pops=3, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.4, 0.8]),
                            admixture_alpha=0.1, seed=17)
    data = panel.data.to("cuda")
    q, p = inputs(data, 4, 3, 5)
    q128, p128 = inputs(data, 128, 3, 7)
    dper = torch.randn((4, data.n_indv, 50), device="cuda")
    calls = {}
    ref = None
    for name, lib in libs.items():
        fwd, bwd = body_calls(lib, q, p, data, 50, dper)
        fwd128 = body_calls(lib, q128, p128, data, 50, dper)[0]
        out = (fwd(), *bwd())
        if ref is None:
            ref = out
        elif not all(close(x, y) for x, y in zip(out, ref)):
            raise AssertionError(f"variant {name}: output differs from "
                                 "the default body's")
        calls[name] = dict(fwd=fwd, fwd_b128=fwd128, bwd=bwd)
    times = {name: {k: [] for k in ("fwd", "fwd_b128", "bwd")}
             for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            for key, fn in calls[name].items():
                reps, inner = (5, 2) if key == "fwd_b128" else (10, 5)
                times[name][key].append(time_ms(fn, reps=reps, inner=inner))
    # the backward's kernels one by one, the default body's (profiler)
    split = {kernel: profiling.device_ms(calls["default"]["bwd"], kernel)
             for kernel in ("gen_curve_bwd_coef", "gen_curve_bwd_tile",
                            "gen_curve_bwd_sum")} if "default" in calls \
        else None
    for name in calls:
        regs = [line.split("Used ")[1].split(",")[0]
                for line in ptxas[name].splitlines() if "Used " in line]
        print(json.dumps({"variant": name, "card": card,
                          "macros": VARIANTS.get(name, []),
                          "ms": times[name], "ptxas_registers": regs,
                          **({"bwd_kernels_ms": split}
                             if name == "default" else {})}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
