"""Builds and loads the hand-written CUDA kernels.

The sources under ``instruct_tpu_torch/csrc`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  Every source is
compiled to an object file by its own ``nvcc`` process, all started
together, then linked into ``instruct_tpu_torch/build/
libinstruct_kernels.so`` and loaded with ``ctypes``.  The library is built at
first use and rebuilt when a source is newer than it.  Importing this module
builds nothing and needs no CUDA; a build that fails raises.

Each kernel wrapper counts its launches in :data:`launches` (one integer per
kernel name, incremented where the kernel is launched and nowhere else) so a
run can show which kernels it really went through.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB_NAME = "libinstruct_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no FMA contraction: the kernels and their plain PyTorch
              # versions then round every product and sum alike, so the
              # threshold tests of the z draw and the MH accepts agree
              "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


_lib = None

_P, _I, _L, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint, ctypes.c_float)

# name -> argtypes; every function returns the cudaGetLastError() code
_SIGNATURES = {
    # out, C, n_streams, n_blocks, k0, k1, first stream id, step, chain_key,
    # stream
    "philox_fill_launch": [_P, _I, _I, _L, _U, _U, _U, _U, _P, _P],
    # conc, valid, draws, out, C, G, J, M, conc/out strides (c, g, j, m),
    # valid strides (g, j, m), rounds, k0, k1, chain_key, step, stream_id,
    # stream
    "dirichlet_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                         _L, _L, _L, _I, _U, _U, _P, _U, _U, _P],
    # (C, G, J, M, rounds, out[2]) -> dynamic shared memory, threads of a
    # launch
    "dirichlet_launch_plan": [_I] * 5 + [_P],
    # q, gen, rates, draws(u_prop, u_acc, ug, ul), sbar scratch,
    # out rates, gen_prop, wg_pair, logu, C, N, K, subsweeps, delta0,
    # gen_cap, k0, k1, chain_key, step, stream
    "s_pop_tail_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _I, _U, _U, _P, _U, _P],
    # x, out, C, N, iters, stream (the S tail's latency floor)
    "s_pop_floor_launch": [_P, _P, _I, _I, _I, _P],
    # q, freq, bits2, geno, valid, hom, z_in, colv, fvals, u, z, qqnum,
    # zcounts, ll, part, cnt_part, tickets, C, N, L, K, A, family,
    # structure, strips, plane chain stride, k0, k1, chain_key, step,
    # stream -- one per source of the site pass
    **{f"site_{path}_{half}_launch": [_P] * 17 + [_I] * 8 + [_L, _U, _U, _P,
                                                           _U, _P]
       for path in ("packed", "generic") for half in ("sample", "eval")},
    # z, bits2, geno, valid, counts, C, N, L, K, A, plane chain stride,
    # stream
    "allele_counts_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
    # (C, N, L, K, A, packed, out[5]) -> the launch plan (grid x, grid y,
    # rows a strip, pops a window, dynamic shared memory)
    "allele_counts_launch_plan": [_I] * 6 + [_P],
    # q, freq, geno, valid, u, z, qqnum, C, N, L, K, A, ploidy, rows (0:
    # the generic body), geno chain stride, k0, k1, chain_key, step, stream
    "zq_sample_launch": [_P] * 7 + [_I] * 7 + [_L, _U, _U, _P, _U, _P],
    # (K, A, rows) -> dynamic shared-memory bytes of a K8 launch
    "zq_sample_launch_dyn_smem": [_I] * 3,
    # table, z, dist, nc, q, freq, freq2, cand_sel, cand_cls, cand_mult,
    # gumbel, choice, C, N, L, K, A, G, n_cand, autopoly, k0, k1, chain_key,
    # step, stream
    "geno_choice_launch": [_P] * 12 + [_I] * 8 + [_U, _U, _P, _U, _P],
    # tab_cur, tab_prop, lookup, cls_of, z, geno, valid, part, tickets,
    # delta, C, N, L, K, G, V, n_max, n_cls, strips, rows, stage, lut_smem,
    # stream
    "s_delta_launch": [_P] * 10 + [_I] * 12 + [_P],
    # table, lookup, cls_of, log_mult, freq, freq2, z, geno, valid, part,
    # tickets, ll, C, N, L, K, A, G, V, n_max, n_cls, autopoly, strips, rows,
    # stage, lut_smem, stream
    "site_ll_launch": [_P] * 12 + [_I] * 14 + [_P],
    # (K, G, V, n_cls, stage, lut_smem) / (K, A, G, V, n_cls, autopoly,
    # stage, lut_smem) -> dynamic shared-memory bytes of a K6 / K7 launch
    "s_delta_launch_dyn_smem": [_I] * 6,
    "site_ll_launch_dyn_smem": [_I] * 8,
    # values, counts, assign, log_new, new_val, new_idx, gen, ll_grid,
    # out values, counts, assign, scratch, noise spill, C, N, M, variant,
    # k0, k1, chain_key, step, stream
    "crp_sweep_launch": [_P] * 13 + [_I] * 4 + [_U, _U, _P, _U, _P],
    # (N, M, variant, out[6]) -> the seating kernel's plan (not a launch)
    "crp_sweep_plan": [_I] * 3 + [_P],
    # x, out, C, N, stream (the seating kernel's latency floor)
    "crp_warp_floor_launch": [_P, _P, _I, _I, _P],
    # q, p, geno, hom, valid, per_gen, B, N, L, K, A, G, stream
    "gen_curve_fwd_launch": [_P] * 6 + [_I] * 6 + [_P],
    # q, p, geno, hom, valid, dper_gen, row coefficients, dq partials, dP
    # partials, dq, dp, B, N, L, K, A, G, stream
    "gen_curve_bwd_launch": [_P] * 11 + [_I] * 6 + [_P],
    # (N, L, K, A, out[6]) -> the backward plan (not a launch)
    "gen_curve_bwd_plan": [_I] * 4 + [_P],
    # (which, K, A, out[5]) -> registers, local bytes, static and dynamic
    # shared bytes, blocks an SM of a kernel (not a launch)
    "gen_curve_kernel_info": [_I] * 3 + [_P],
    # q, p, bits2, geno, hom, valid, gen, rates, tile partials, out, C, N,
    # L, K, A, family, gen_float, stream
    "marg_loglik_launch": [_P] * 10 + [_I] * 7 + [_P],
    # (C, N, L, K, A, out[6]) -> the launch plan (not a launch)
    "marg_loglik_plan": [_I] * 5 + [_P],
    # L -> locus tiles per row of the site pass; N -> its row strips (not
    # launches)
    "site_pass_tiles": [_I],
    "site_pass_strips": [_I],
    # (K, A, family, structure) -> dynamic shared-memory bytes of a
    # source's site-pass launch
    **{f"site_{path}_{half}_launch_dyn_smem": [_I, _I, _I, _I]
       for path in ("packed", "generic") for half in ("sample", "eval")},
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "instruct_tpu_torch cannot be built on this machine")


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir()
               if p.suffix in (".cu", ".cuh"))


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` process per source, in parallel)
    and link the shared library.  Returns its path."""
    lib = BUILD / LIB_NAME
    if not force and not _stale(lib):
        return lib
    nvcc = find_nvcc()
    BUILD.mkdir(exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = BUILD / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    tmp = BUILD / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
         str(tmp), *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + link.stdout)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first when missing or stale)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call one launch function of the library on PyTorch's current stream,
    count the launch under ``kernel`` and raise if CUDA refused it."""
    fn = getattr(library(), fn_name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch "
                           f"(cudaGetLastError = {rc})")
    launches[kernel] += 1


def plane_stride(t: torch.Tensor, name: str, c: int, n: int, cols: int,
                 dtype) -> int:
    """Chain stride (in elements) of a panel plane that is either shared by
    the chains, [N, cols] (stride 0), or one per chain, [C, N, cols]; checks
    it as :func:`check` does."""
    per_chain = t.dim() == 3
    check(t, name, dtype, (c, n, cols) if per_chain else (n, cols))
    return n * cols if per_chain else 0


def ptr(t):
    """Device pointer of a tensor for ctypes (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype, shape=None,
          contiguous=True) -> None:
    """Raise unless ``t`` is a CUDA tensor of the dtype/shape a kernel
    takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: lies on {t.device}, but kernels launch on "
                         f"the current device cuda:"
                         f"{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte aligned storage")
