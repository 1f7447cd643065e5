#!/usr/bin/env python3
"""Time variants of the port's K6 (``s_delta_pass``) and K7
(``site_ll_pass``) kernels on one NVIDIA GPU.

    python3 -m instruct_tpu_torch.tools.tetra_sums_variants [--parent CSRC_DIR]

Compiles ``csrc/tetra_geno.cu`` several times with ``nvcc`` -- as it is and
once per ablation (a textual patch that removes one part of the work) --
and, with ``--parent``, another tree's source of the same name (as it is,
and with its K6 reduced to the second, reduce kernel alone).  Every build
runs at once; each variant is then timed by the profiler's device time of
a call (the kernels of 30 calls over 30; CUDA events over back-to-back
launches would read the host's enqueue of the wrapper) on the tetraploid
benchmark panels (4 chains, N = 500, L = 5000, K = 3, A = 4, auto and
allo; about two thirds of the sites same-z) and on ``chip_smoke.py``'s
panel of wide class tables (L = 1000, K = 4, A = 8: K * G = 1320 auto,
5184 allo; the tables gathered), with the engine's class map where the
wrapper takes one.  The unmodified bodies are also timed under other
launch plans (tables gathered instead of staged, the class rows read from
device memory, no class map, other block targets), other launch shapes
(blocks an SM, loci a block) and with every site same-z and every site
mixed.  An unmodified body is first held to the plain version (``match``:
K6 at rtol 1e-5, atol 1e-6 x the sum of |terms|; K7 at rtol 1e-5, atol
1e-6 x the sum of |site terms|, as ``chip_smoke.py`` holds them); ``same``
says whether a variant gives the unmodified body's result bit for bit (an
ablation changes it by design).  One line per variant and shape, with each
body's registers, stack frame and spills; nothing is written to the
package.  A tuning aid: it shows which part of a kernel a change would
have to attack.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import subprocess
import sys
import tempfile

import torch

from instruct_tpu_torch import ModelSpec
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.tetra import engine as te
from instruct_tpu_torch.tools import geno_zq_variants as gzv
from instruct_tpu_torch.tools import profiling
from instruct_tpu_torch.tools import site_pass_variants as spv

SOURCE = "tetra_geno.cu"
KERNELS = ("s_delta_pass", "site_ll_pass")
# what the mangled names of each kernel's instantiations hold
KERNEL_NAMES = {"s_delta_pass": "s_delta_kernel",
                "site_ll_pass": "site_ll_kernel"}

_K6_STAGING = ("  if (kStage) {\n"
               "    // a pop's cells of the tile are one run of lt * G floats",
               "  if (false) {\n"
               "    // a pop's cells of the tile are one run of lt * G floats")
_K7_LOG_STAGING = ("  if (kStage) {\n    // the slot logs:",
                   "  if (false) {\n    // the slot logs:")
_K7_TABLE_STAGING = ("  if (kStage) {\n    // the class table and",
                     "  if (false) {\n    // the class table and")
# (text in the source, replacement): each removes one part of the work.
ABLATIONS = {
    # the plane words and the sums only: the words' xor is each lane's term
    "loads only": [
        _K6_STAGING, _K7_LOG_STAGING, _K7_TABLE_STAGING,
        ("    const uint32_t m = cur.same_bytes() & cur.valid_bytes();",
         "    acc[tid] += (float)(cur.same_bytes() ^ cur.valid_bytes() ^ "
         "cur.g[0] ^ cur.g[1] ^ cur.g[2] ^ cur.g[3]);\n"
         "    const uint32_t m = 0u;"),
        ("    const uint32_t hv = cur.valid_bytes(), same = cur.same_bytes();"
         "\n    float acc = 0.0f;",
         "    const uint32_t hv = 0u, same = 0u;\n"
         "    float acc = (float)(cur.valid_bytes() ^ cur.same_bytes() ^ "
         "cur.g[0] ^ cur.g[1] ^ cur.g[2] ^ cur.g[3]);")],
    # K6: no tab_prop - tab_cur (staged or gathered); K7: no class table
    # or log-multiplicity reads (its slot logs stay)
    "no table reads": [
        _K6_STAGING, _K7_TABLE_STAGING,
        ("               : kStage ? diff[off[j]]\n"
         "                        : __ldg(a.tab_prop + off[j]) - "
         "__ldg(a.tab + off[j]);",
         "               : (float)off[j];"),
        ("        base[j] = !((hv >> (8 * j + 7)) & 1u) ? 0.0f\n",
         "        base[j] = ((hv >> (8 * j + 7)) & 1u) ? (float)(cls[j] + z0 "
         "+ ll) : 0.0f;\n"
         "        if (false) base[j] = !((hv >> (8 * j + 7)) & 1u) ? 0.0f\n")],
    # K7: each mixed-z site takes its 4 slot logs itself, as the first body
    "in-loop logs": [
        _K7_LOG_STAGING,
        ("            if (kStage) {\n              s = s + slot_log",
         "            if (false) {\n              s = s + slot_log")],
}
# the plane words through L2 only (.cg) or as streaming loads (.cs), not
# through L1 (which shares the SM's memory with the staged tables)
for _op in ("cg", "cs"):
    ABLATIONS[f"plane loads .{_op}"] = [(
        "  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + l0));",
        f"  if (vec) return __ld{_op}(reinterpret_cast<const uint32_t*>"
        "(row + l0));")]
# K7: the log multiplicities gathered from device memory, not staged (the
# block's shared memory without their rows)
ABLATIONS["log mult gathered"] = [
    ("                               (size_t)(K + 1) * kSumTile * G)",
     "                               (size_t)K * kSumTile * G)"),
    ("      reinterpret_cast<int16_t*>(lm_s + (kStage ? kSumTile * G : 0));",
     "      reinterpret_cast<int16_t*>(lm_s);"),
    ("    stage_run<Run::kCopy>(lm_s, a.log_mult + (long long)lt0 * G, "
     "nullptr,",
     "    if (false) stage_run<Run::kCopy>(lm_s, a.log_mult + (long long)lt0 "
     "* G, nullptr,"),
    ("                       : (kStage ? lm_s[ll * G + cls[j]]",
     "                       : (false ? lm_s[ll * G + cls[j]]")]
# the first bodies: K6's second kernel alone (its row partials unwritten)
PARENT_ABLATIONS = {"reduce kernel alone": [
    ("  if (N > 0) {\n    SDeltaArgs a;", "  if (N < 0) {\n    SDeltaArgs a;")]}
# launch shapes: (macros of the source, ``sums_plan`` keywords to match)
SHAPES = {**{f"min blocks {b}": ([f"SUMS_MIN_BLOCKS={b}"], {})
             for b in (3, 5)},
          **{f"tile {w}": ([f"SUMS_TILE={w}"],
                           {"tile": w, "stage_smem": 110 * 1024})
             for w in (16, 64)}}
# launch plans of the unmodified bodies: (``sums_plan`` keywords, with the
# class map)
PLANS = {"tables gathered": ({"stage_smem": 0}, True),
         "class rows in device memory": ({"lut_smem_max": 0}, True),
         "no class map": ({}, False),
         "blocks target 528": ({"blocks_target": 528}, True),
         "blocks target 2112": ({"blocks_target": 2112}, True)}


@functools.lru_cache(maxsize=None)
def _panel(autopoly: bool, wide: bool):
    """The tetraploid benchmark panel (N = 500, L = 5000, K = 3, A = 4) or
    the wide class tables' panel of ``chip_smoke.py`` (L = 1000, K = 4,
    A = 8: K * G = 1320 auto, 5184 allo), on the card with its tables."""
    l, k, a = (1000, 4, 8) if wide else (5000, 3, 4)
    panel = synthetic_tetra_panel(500, l, n_pops=k, n_alleles=a,
                                  autopoly=autopoly, seed=7)
    data = panel.data.to("cuda")
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly)
    return data, spec, te.build_tables(spec, data)


def inputs(autopoly: bool, c: int = 4, z_kind: str = "state",
           wide: bool = False):
    """({kernel: (args, kw)}, class map) of K6 and K7 on a panel of
    :func:`_panel`: z with each individual's copies in one dominant pop with
    probability 0.85 (``state``), or every site same-z (``same``) or mixed
    (``mixed``); a random candidate ordering a site; frequencies from a
    flat Dirichlet; S and a proposal one random-walk step apart.  The
    kernels' arguments are the JAX-shaped ones (no class map)."""
    data, spec, t = _panel(autopoly, wide)
    n, l, a, k = data.n_indv, data.n_loci, data.max_alleles, spec.n_pops
    g = torch.Generator(device="cuda").manual_seed(31)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def simplex(*shape):
        x = torch._standard_gamma(torch.ones(shape, device="cuda"),
                                  generator=g).clamp_min(1e-20)
        x = x * data.allele_valid.float()
        return (x / x.sum(-1, keepdim=True)).contiguous()

    dom = (rand(c, n, 1) * k).long().clamp_max(k - 1)
    other = (rand(c, n, 4 * l) * k).long().clamp_max(k - 1)
    z = torch.where(rand(c, n, 4 * l) < 0.85, dom, other)
    if z_kind == "same":
        z = z[:, :, :l].repeat(1, 1, 4)
    elif z_kind == "mixed":
        z = z.clone()
        z[:, :, l:2 * l] = (z[:, :, :l] + 1) % k
    z = z.to(torch.int8).contiguous()
    freq, freq2 = simplex(c, k, l, a), simplex(c, k, l, a)
    choice = torch.minimum(torch.floor(rand(c, n, l) * t.cand_nc.float()),
                           t.cand_nc.float() - 1)
    geno = te.reconstruct_geno(t, choice.to(torch.int8))
    rates = rand(c, k) * 0.9 + 0.05
    prop = (rates + (rand(c, k) - 0.5) * 0.1).clamp(0.01, 0.99)
    tab_cur = te.class_table(t, spec, freq, freq2, rates).contiguous()
    tab_prop = te.class_table(t, spec, freq, freq2, prop).contiguous()
    return {"s_delta_pass": ((tab_cur, tab_prop, t.lookup_l, z, geno,
                              data.site_valid), {}),
            "site_ll_pass": ((tab_cur, t.lookup_l, t.log_mult_l, freq, freq2,
                              z, geno, data.site_valid),
                             dict(autopoly=autopoly))}, t.class_map


def device_ms(fn, kernel: str) -> float:
    """The device time of one ``fn()`` in ms: every kernel of ``kernel``'s
    call (both of a first K6 body)."""
    return profiling.device_ms(
        fn, "s_delta" if kernel == "s_delta_pass" else "site_ll",
        per_call=True)


def plan_of(kernel, args, kw, cmap, consts) -> tg.SumsPlan:
    """The plan of a call with the class map ``cmap`` (None: without) and
    the ``sums_plan`` keywords ``consts``."""
    c, k, l, g = args[0].shape
    n, v = args[-1].shape[0], args[2 if kernel == "s_delta_pass" else 1] \
        .shape[1]
    n_cls = 0 if cmap is None else cmap.lookup.shape[0]
    if kernel == "s_delta_pass":
        return tg.sums_plan("s_delta", c, n, l, k, g, v, n_cls, **consts)
    return tg.sums_plan("site_ll", c, n, l, k, g, v, n_cls, args[3].shape[3],
                        kw["autopoly"], **consts)


def agrees(kernel, args, kw, got) -> bool:
    """``got`` within chip_smoke.py's tolerance of the plain version."""
    if kernel == "s_delta_pass":
        want = tg.s_delta_pass_reference(*args)
        mag = tg.s_delta_pass_reference(
            args[0], args[0] + (args[1] - args[0]).abs(), *args[2:])
    else:
        want = tg.site_ll_pass_reference(*args, **kw)
        mag = tg.site_loglik(*args, **kw).abs().sum(dim=2)
    return not bool(((got - want).abs()
                     > 1e-5 * want.abs() + 1e-6 * mag).any())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a csrc directory whose bodies are timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    texts = gzv.source_texts()
    # (tree, variant, texts, macros, plan constants)
    plans = [("current", "base", texts, [], {})]
    plans += [("current", tag, texts, d, c)
              for tag, (d, c) in SHAPES.items()]
    plans += [("current", tag, spv.patched(texts, p), [], {})
              for tag, p in ABLATIONS.items()]
    if args.parent is not None:
        ptexts = gzv.source_texts(args.parent)
        plans.append(("parent", "base", ptexts, [], {}))
        plans += [("parent", tag, spv.patched(ptexts, p), [], {})
                  for tag, p in PARENT_ABLATIONS.items()]
    with tempfile.TemporaryDirectory() as tmp:
        builds = [gzv.start_build(tmp, str(i), t, (SOURCE,), d)
                  for i, (_, _, t, d, _) in enumerate(plans)]
        libs = [gzv.finish_build(b) for b in builds]
        shapes = {mode: inputs(mode.startswith("auto"),
                               wide=mode.endswith("A=8"))
                  for mode in ("auto", "allo", "auto A=8", "allo A=8")}
        base = {}
        for (tree, tag, _, _, consts), (lib, ptxas) in zip(plans, libs):
            for mode, (calls, cmap) in shapes.items():
                for kernel in KERNELS:
                    a, kw = calls[kernel]
                    kwm = kw
                    if tree == "current":
                        pl = plan_of(kernel, a, kw, cmap, consts)
                        kwm = dict(kw, classes=cmap, plan=pl)
                    run = lambda: gzv.parent_call(lib, kernel, a, kwm)
                    out = run()
                    ms = device_ms(run, kernel)
                    line = f"{kernel:13s} {tree:7s} {mode:8s} {tag:28s}"
                    if tree == "current":
                        line += f" strips={pl.strips} smem={pl.dyn_smem}"
                    if tag == "base":
                        base[(kernel, tree, mode)] = out
                        line += f" match={agrees(kernel, a, kw, out)}"
                        line += (" regs=[" + gzv.registers(
                            ptxas, KERNEL_NAMES[kernel]) + "]")
                    else:
                        line += (" same=" + str(torch.equal(
                            out, base[(kernel, tree, mode)])))
                        if tag in SHAPES:
                            line += f" match={agrees(kernel, a, kw, out)}"
                            line += (" regs=[" + gzv.registers(
                                ptxas, KERNEL_NAMES[kernel]) + "]")
                    print(f"{line} ms={ms:.4f}", flush=True)
                    if tree != "current" or tag != "base":
                        continue
                    for what, (pconsts, with_map) in PLANS.items():
                        cm = cmap if with_map else None
                        kwp = dict(kw, classes=cm,
                                   plan=plan_of(kernel, a, kw, cm, pconsts))
                        with gzv.library(lib):
                            run2 = lambda: getattr(tg, kernel)(*a, **kwp)
                            got = run2()
                            ms = device_ms(run2, kernel)
                        print(f"{kernel:13s} {tree:7s} {mode:8s} "
                              f"{'plan: ' + what:28s} "
                              f"match={agrees(kernel, a, kw, got)} "
                              f"same={torch.equal(got, out)} ms={ms:.4f}",
                              flush=True)
            if tree == "current" and tag == "base":
                for mode in ("auto", "allo"):
                    for kind in ("same", "mixed"):
                        calls, cmap = inputs(mode == "auto", z_kind=kind)
                        for kernel in KERNELS:
                            a, kw = calls[kernel]
                            kwm = dict(kw, classes=cmap)
                            run3 = lambda: gzv.parent_call(lib, kernel, a,
                                                           kwm)
                            ok = agrees(kernel, a, kw, run3())
                            ms = device_ms(run3, kernel)
                            print(f"{kernel:13s} {tree:7s} {mode:8s} "
                                  f"{'z ' + kind:28s} match={ok} "
                                  f"ms={ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
