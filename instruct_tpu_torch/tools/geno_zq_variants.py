#!/usr/bin/env python3
"""Time variants of the port's K5 (``geno_choice_pass``) and K8
(``zq_sample_counts``) kernels on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.geno_zq_variants [--parent CSRC_DIR]
        [--parent-ablations] [--only k5|k8]

Compiles ``csrc/tetra_geno.cu`` (K5) and ``csrc/zq_sample.cu`` (K8) several
times with ``nvcc`` -- as they are, once per launch shape (a macro of the
source or a constant of the plan ``kernels/zq.py:zq_plan``) and once per
ablation (a textual patch that removes one part of the work) -- and, with
``--parent``, another tree's sources of the same names (with
``--parent-ablations`` also the ablations of the first bodies).
Every build runs at once; each variant is then timed
with CUDA events over runs of 10 back-to-back launches at the shapes of
``chip_smoke.py``: K5 on the tetraploid benchmark panels (4 chains, N = 500,
L = 5000, K = 3, A = 4, auto and allo; about two thirds of the sites
same-z) and, for the unmodified bodies, with every site same-z, every site
mixed and one chain; K8 on the wide panel (N = 1000, L = 2000, A = 16,
K = 5), the headline shape (L = 10 000, A = 2, K = 3) and ploidy 4
(L = 2000, A = 4, K = 3), 4 chains.  An unmodified body is first held
exactly to the plain version (``match``); ``same`` says whether a variant
gives the unmodified body's result (an ablation changes it by design).
One line per variant and shape; nothing is written to the package.  A
tuning aid: it shows which part of a kernel a change would have to attack.

:func:`build_library` and :func:`parent_call` are also how ``chip_smoke.py
--parent-csrc`` times the parent's K5 and K8 beside the current ones.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from instruct_tpu_torch import ModelSpec
from instruct_tpu_torch.data.synthetic import (synthetic_panel,
                                               synthetic_tetra_panel)
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.kernels import zq as zqk
from instruct_tpu_torch.tetra import engine as te
from instruct_tpu_torch.tools import site_pass_variants as spv

K5_SOURCE, K8_SOURCE = "tetra_geno.cu", "zq_sample.cu"
# what the mangled names of each kernel's instantiations hold
KERNEL_NAMES = {"geno_choice_pass": "geno_choice_kernel",
                "zq_sample_counts": "zq_"}
HEADERS = ("philox.cuh", "quad.cuh")
# The first K8 body's launch function: no tile and rows arguments; freq
# pop-minor, [C, L, A, K].
_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_uint)
FIRST_ZQ_SIGNATURE = [_P] * 7 + [_I] * 6 + [_L, _U, _U, _P, _U, _P]

_CHEAP_PHILOX = ("r = Philox4{(uint32_t)site * 2654435761u, chain, a.step, "
                 "(uint32_t)cc}; if (a.k0 == 12345u && a.k1 == 54321u) "
                 "r = philox4x32_10(")
_NO_GUMBEL_LOGS = ("g = -logf(-logf(u01_open(philox_word(r, cc & 3))));",
                   "g = u01_open(philox_word(r, cc & 3));")
_NO_ZQ_PHILOX = (
    "const Philox4 a = philox4x32_10(blk, STREAM_Z, step, chain, k0, k1);",
    "const Philox4 a = Philox4{blk * 2654435761u + step, blk * 40503u "
    "+ chain, blk * 2246822519u + k0, blk * 3266489917u + k1};")
_NO_Z_STORES = ("store_bytes(a.z + cn * S + (long long)p * L, l0, L, vec, zv);",
                "if (zv[0] == 99) store_bytes(a.z + cn * S + (long long)p "
                "* L, l0, L, vec, zv);")

# (text in the source, replacement): each removes one part of the work.
K5_ABLATIONS = {
    "no mixture logs": [
        ("        if ((used1 >> j) & 1u) m1[j] = slog(m1[j]);\n"
         "        if (!kAuto && ((used2 >> j) & 1u)) m2[j] = slog(m2[j]);\n",
         "")],
    "no mixtures": [("      for (int k = 0; k < K; ++k) {\n"
                     "        const float qk = __ldg(qrow + k);",
                     "      for (int k = 0; k < 0; ++k) {\n"
                     "        const float qk = __ldg(qrow + k);")],
    "no table gathers": [
        ("if (cc + 1 < nc) next = __ldg(trow + (int)(cand_s[cc + 1][me] "
         ">> 16));", "next = (float)(v >> 16);")],
    "no Gumbel logs": [_NO_GUMBEL_LOGS],
    "no Philox rounds": [("r = philox4x32_10(", _CHEAP_PHILOX)],
}
K5_ABLATIONS["all of the above"] = [p for ps in K5_ABLATIONS.values()
                                    for p in ps]
# the first body (a block per row and chain, 5 logs a mixed candidate)
K5_FIRST_ABLATIONS = {
    "no slot logs": [("w = w + slog(m < 2 ? pick4(m1, j) : pick4(m2, j));",
                      "w = w + (m < 2 ? pick4(m1, j) : pick4(m2, j));")],
    "no log mult": [("w = logf((float)a.mult[cs]);",
                     "w = (float)a.mult[cs];")],
    "no Gumbel logs": [_NO_GUMBEL_LOGS],
    "no Philox rounds": [("r = philox4x32_10(", _CHEAP_PHILOX)],
}
K5_FIRST_ABLATIONS["all of the above"] = [
    p for ps in K5_FIRST_ABLATIONS.values() for p in ps]
K8_ABLATIONS = {
    "no P staging": [("dst[((l & 3) * QT + (l >> 2)) * As + al] = "
                      "__ldg(src + e);",
                      "dst[((l & 3) * QT + (l >> 2)) * As + al] = 0.5f;")],
    "no counts": [("cw[w] += (zv[j] >> 2) == w ? inc : 0u;",
                   "cw[w] += 0u * inc;")],
    "no draw": [("z += ut > cum ? 1 : 0;", "")],
    "no Philox rounds": [_NO_ZQ_PHILOX],
    "no z stores": [_NO_Z_STORES],
}
K8_ABLATIONS["all of the above"] = [p for ps in K8_ABLATIONS.values()
                                    for p in ps]
# launch shapes: (source macros, plan constants of kernels/zq.py)
K5_SHAPES = {f"min blocks {b}": ([f"GENO_MIN_BLOCKS={b}"], {})
             for b in (3, 6)}
K8_SHAPES = {**{f"min blocks {b}": ([f"ZQ_MIN_BLOCKS={b}"], {})
                for b in (3, 6)},
             "blocks target 1056": ([], {"BLOCKS_TARGET": 1056}),
             "blocks target 264": ([], {"BLOCKS_TARGET": 264})}
K8_FIRST_ABLATIONS = {
    "one gather pass": [("cum = cum + qr[k] * __ldg(fp + k);",
                         "cum = cum + qr[k];")],
    "no gathers": [("float total = qr[0] * __ldg(fp);",
                    "float total = qr[0] * 0.5f;"),
                   ("for (int k = 1; k < K; ++k) total = total + qr[k] * "
                    "__ldg(fp + k);",
                    "for (int k = 1; k < K; ++k) total = total + qr[k];"),
                   ("cum = cum + qr[k] * __ldg(fp + k);",
                    "cum = cum + qr[k];")],
    "no count loop": [("      m = __reduce_add_sync(0xffffffffu, m);\n",
                       "      m = 0;\n")],
    "no Philox rounds": [_NO_ZQ_PHILOX],
    "no z stores": [_NO_Z_STORES],
}
K8_FIRST_ABLATIONS["all of the above"] = list(dict.fromkeys(
    p for ps in K8_FIRST_ABLATIONS.values() for p in ps))


def source_texts(csrc=_build.CSRC) -> dict:
    return {name: (pathlib.Path(csrc) / name).read_text()
            for name in HEADERS + (K5_SOURCE, K8_SOURCE)}


def start_build(work, tag: str, texts: dict, sources, defines=()) -> dict:
    return spv.start_build(pathlib.Path(work), tag, texts, defines, sources)


def finish_build(build: dict):
    """The library of a started build, with the first K8 body's launch
    signature where its source has no ``zq_sample_launch_dyn_smem``."""
    lib, ptxas = spv.finish_build(build)
    fn = getattr(lib, "zq_sample_launch", None)
    if fn is not None and getattr(lib, "zq_sample_launch_dyn_smem",
                                  None) is None:
        fn.argtypes = FIRST_ZQ_SIGNATURE
    return lib, ptxas


def build_library(work, tag: str, csrc):
    """K5's and K8's sources of ``csrc`` compiled (in parallel), linked and
    loaded.  Returns (library, ptxas output)."""
    return finish_build(start_build(work, tag, source_texts(csrc),
                                    (K5_SOURCE, K8_SOURCE)))


@contextlib.contextmanager
def library(lib, plan=None):
    """Within the block the kernel wrappers launch through ``lib`` (and
    K8's launch plan takes the constants ``plan`` of ``kernels/zq.py``)."""
    saved = _build._lib, {name: getattr(zqk, name) for name in plan or {}}
    _build._lib = lib
    for name, value in (plan or {}).items():
        setattr(zqk, name, value)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        _build._lib = saved[0]
        for name, value in saved[1].items():
            setattr(zqk, name, value)


def zq_call(lib, keys, step, q, freq, geno, site_valid, plan=None):
    """K8 through ``lib``: the current wrapper, or, for a library of the
    first body, its launch as that wrapper made it (P transposed first)."""
    if getattr(lib, "zq_sample_launch_dyn_smem", None) is not None:
        with library(lib, plan):
            return zqk.zq_sample_counts(keys, step, q, freq, geno,
                                        site_valid, n_pops=q.shape[2])
    c, k, l, a = freq.shape
    n, s = geno.shape[-2:]
    z = torch.empty((c, n, s), dtype=torch.int8, device=freq.device)
    qqnum = torch.empty((c, n, k), dtype=torch.float32, device=freq.device)
    freq_t = freq.permute(0, 2, 3, 1).contiguous()
    geno_cs = n * s if geno.dim() == 3 else 0
    p = _build.ptr
    rc = lib.zq_sample_launch(p(q), p(freq_t), p(geno), p(site_valid), None,
                              p(z), p(qqnum), c, n, l, k, a, s // l, geno_cs,
                              keys.k0, keys.k1, p(keys.chain_key), step,
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the first K8 body failed to launch ({rc})")
    return z, qqnum


def parent_call(lib, kernel: str, args: tuple, kw: dict, plan=None):
    """One call of K5 (``geno_choice_pass``) or K8 (``zq_sample_counts``)
    through another tree's library ``lib``, with the current wrapper's
    arguments (and K8's plan constants ``plan``)."""
    if kernel == "zq_sample_counts":
        return zq_call(lib, *args, plan=plan)
    with library(lib):
        return tg.geno_choice_pass(*args, **kw)


@functools.lru_cache(maxsize=None)
def _tetra_panel(autopoly: bool):
    panel = synthetic_tetra_panel(500, 5000, n_pops=3, n_alleles=4,
                                  autopoly=autopoly, seed=7)
    data = panel.data.to("cuda")
    spec = ModelSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    return data, spec, te.build_tables(spec, data)


def tetra_inputs(autopoly: bool, c: int = 4, z_kind: str = "state"):
    """K5's arguments on the tetraploid benchmark panel (N = 500, L = 5000,
    K = 3, A = 4): z with each individual's copies in one dominant pop with
    probability 0.85 (``state``), or every site same-z (``same``) or mixed
    (``mixed``)."""
    data, spec, t = _tetra_panel(autopoly)
    n, l, a, k = data.n_indv, data.n_loci, data.max_alleles, 3
    g = torch.Generator(device="cuda").manual_seed(31)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def simplex(*shape, conc=1.0):
        x = torch._standard_gamma(torch.full(shape, conc, device="cuda"),
                                  generator=g).clamp_min(1e-20)
        return (x / x.sum(-1, keepdim=True)).contiguous()

    dom = (rand(c, n, 1) * k).long().clamp_max(k - 1)
    other = (rand(c, n, 4 * l) * k).long().clamp_max(k - 1)
    z = torch.where(rand(c, n, 4 * l) < 0.85, dom, other)
    if z_kind == "same":
        z = z[:, :, :l].repeat(1, 1, 4)
    elif z_kind == "mixed":
        z = z.clone()
        z[:, :, l:2 * l] = (z[:, :, :l] + 1) % k
    freq, freq2 = simplex(c, k, l, a), simplex(c, k, l, a)
    rates = (rand(c, k) * 0.9 + 0.05).contiguous()
    table = te.class_table(t, spec, freq, freq2, rates).contiguous()
    args = (px.make_keys(2024, c, "cuda"), 5, table,
            z.to(torch.int8).contiguous(), t.dist8, t.cand_nc,
            simplex(c, n, k, conc=0.3), freq, freq2, t.cand_sel, t.cand_cls,
            t.cand_mult)
    return args, dict(autopoly=autopoly)


def zq_inputs(kind: str, c: int = 4):
    """K8's arguments: ``wide`` (N = 1000, L = 2000, A = 16, K = 5),
    ``headline`` (the headline panel's allele codes, L = 10 000, A = 2,
    K = 3) or ``ploidy4`` (L = 2000, A = 4, K = 3, S = 4L)."""
    g = torch.Generator(device="cuda").manual_seed(41)
    n = 1000
    if kind == "ploidy4":
        l, k, a = 2000, 3, 4
        geno = torch.randint(0, a, (n, 4 * l), generator=g, device="cuda",
                             dtype=torch.int8)
        site_valid = torch.rand((n, l), generator=g, device="cuda") > 0.1
    else:
        l, k, a = (2000, 5, 16) if kind == "wide" else (10_000, 3, 2)
        panel = synthetic_panel(n, l, n_pops=k, n_alleles=a,
                                selfing_rates=np.linspace(0.1, 0.9, k),
                                admixture_alpha=0.1, seed=17)
        data = panel.data.to("cuda")
        geno, site_valid = data.geno, data.site_valid
    gam = torch._standard_gamma(torch.full((c, k, l, a), 1.0, device="cuda"),
                                generator=g)
    freq = (gam / gam.sum(-1, keepdim=True)).contiguous()
    gq = torch._standard_gamma(torch.full((c, n, k), 0.3, device="cuda"),
                               generator=g).clamp_min(1e-20)
    q = (gq / gq.sum(-1, keepdim=True)).contiguous()
    return (px.make_keys(2024, c, "cuda"), 5, q, freq, geno, site_valid)


def _plain(kernel, args, kw):
    if kernel == "zq_sample_counts":
        return zqk.zq_sample_counts_reference(*args, n_pops=args[2].shape[2])
    return tg.geno_choice_pass_reference(*args, **kw)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def registers(ptxas: str, name: str) -> str:
    """'registers, spills' per instantiation whose mangled name holds
    ``name``, as ptxas printed them."""
    lines, out = ptxas.splitlines(), []
    for i, line in enumerate(lines):
        if "Function properties for" in line and name in line:
            inst = line.split("Function properties for ")[1].strip()
            regs = lines[i + 2].split("Used ")[1].split(",")[0]
            out.append(f"{inst[-24:]}: {regs}, "
                       f"{lines[i + 1].split(',')[1].strip()}")
    return "; ".join(out) or "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory whose bodies are timed beside")
    ap.add_argument("--parent-ablations", action="store_true",
                    help="also time the ablations of the first bodies on "
                         "the --parent sources")
    ap.add_argument("--only", choices=("k5", "k8"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    trees = [("current", source_texts())]
    if args.parent is not None:
        trees.append(("parent", source_texts(args.parent)))
    # (kernel, tree, variant, texts, source, macros, plan constants)
    plans = []
    for tree, texts in trees:
        first = tree == "parent"
        first_abl = args.parent_ablations
        for kernel, src, abl, shapes in (
                ("geno_choice_pass", K5_SOURCE,
                 (K5_FIRST_ABLATIONS if first_abl else {}) if first
                 else K5_ABLATIONS, {} if first else K5_SHAPES),
                ("zq_sample_counts", K8_SOURCE,
                 (K8_FIRST_ABLATIONS if first_abl else {}) if first
                 else K8_ABLATIONS,
                 {} if first else K8_SHAPES)):
            if args.only and (args.only == "k5") != (src == K5_SOURCE):
                continue
            plans.append((kernel, tree, "base", texts, src, [], {}))
            plans += [(kernel, tree, tag, texts, src, d, pl)
                      for tag, (d, pl) in shapes.items()]
            plans += [(kernel, tree, tag, spv.patched(texts, p), src, [], {})
                      for tag, p in abl.items()]
    with tempfile.TemporaryDirectory() as tmp:
        builds = [start_build(tmp, str(i), texts, (src,), d)
                  for i, (_, _, _, texts, src, d, _) in enumerate(plans)]
        libs = [finish_build(b) for b in builds]
        shapes = {"geno_choice_pass": {
            mode: tetra_inputs(mode == "auto") for mode in ("auto", "allo")},
            "zq_sample_counts": {
                kind: (zq_inputs(kind), {})
                for kind in ("wide", "headline", "ploidy4")}}
        base = {}
        for (kernel, tree, tag, _, _, _, pl), (lib, ptxas) in zip(plans,
                                                                  libs):
            for shape, (a, kw) in shapes[kernel].items():
                run = lambda: parent_call(lib, kernel, a, kw, pl)
                out = run()
                torch.cuda.synchronize()
                line = f"{kernel:17s} {tree:7s} {shape:8s} {tag:22s}"
                if tag == "base":
                    base[(kernel, tree, shape)] = out
                    line += f" match={_equal(out, _plain(kernel, a, kw))}"
                    line += f" regs=[{registers(ptxas, KERNEL_NAMES[kernel])}]"
                else:
                    line += (" same="
                             f"{_equal(out, base[(kernel, tree, shape)])}")
                print(f"{line} ms={spv.time_ms(run):.4f}", flush=True)
                if tag == "base" and kernel == "geno_choice_pass":
                    auto = shape == "auto"
                    for kind, c in (("same", 4), ("mixed", 4),
                                    ("state", 1)):
                        a2, kw2 = tetra_inputs(auto, c=c, z_kind=kind)
                        run2 = lambda: parent_call(lib, kernel, a2, kw2)
                        ok = _equal(run2(), _plain(kernel, a2, kw2))
                        print(f"{kernel:17s} {tree:7s} {shape:8s} "
                              f"{'z ' + kind + ', C=' + str(c):22s} "
                              f"match={ok} ms={spv.time_ms(run2):.4f}",
                              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
