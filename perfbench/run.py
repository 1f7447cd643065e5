#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``instruct_tpu_torch``.

    python3 perfbench/run.py --workload regmap.mode2 --seed 7 \
        --seconds 30 --trace 0

A cell (``BENCHMARK.json``'s ``workloads``) names a panel
(``configs/<config>.json``) and an analysis mix (``traffic/<mix>.json``).
The run:

1. set-up (``setup_s``, from the start of this script): the kernel library
   (built on the first run in a checkout), the panel made on the device
   from ``--seed`` (``panel.py``), the port's ``Dataset`` of it, and one
   warm-up job of the cell's own shapes;
2. the window: jobs back to back, each one call of the mix's entry
   (``jobs.py``) from its own seed, until the first job that ends after
   ``--seconds``; ``chain_steps_per_s`` is all the chain-sweeps asked of
   them over the window's time, ``peak_device_gib`` the device memory
   peak over the window;
3. with ``--trace 1``, after the window, jobs under ``torch.profiler``
   (``trace.py``), at least two complete ones, which the per-layer metrics
   (``metrics/<name>.py``, found by name) read;
4. the check (``check.py``): the last job's last sweep replayed by the
   plain reference from the program's state before it; each number is
   printed beside its limit (``limits/<workload>.json``) on standard error
   and in the result line, whose last key it is.

The last line of standard output is the result, one JSON object.  A run
exits 3 without a result where CUDA or the cell's cards are missing, and
4 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root, not this folder, on the path: the harness's module
# names must not shadow the standard library's (``trace``)
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "instruct_tpu")
GIB = float(1 << 30)
TRACED_JOBS = 2
NAME_CHARS = 120      # of a kernel's or a host call's name in the breakdown


def load_cell(name: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return dict(
        cell=cell,
        cfg=json.loads((ROOT / conf["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                       .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def model_of(mix: dict, dic_every: int) -> dict:
    """What the check needs of the mix: the model's settings and whether
    the job's last sweep is a stored step that refreshes the marginal
    log-lik (every ``dic_every``-th stored step does)."""
    n, b, t = mix["n_iter"], mix["burnin"], mix["thinning"]
    if (n - b) % t or n <= b:
        raise SystemExit("the mix's last sweep must be a stored step")
    nth = (n - b) // t - 1
    k = mix["k_range"][1] if mix["entry"] == "infer_k" else mix["n_pops"]
    return dict(mode=mix["mode"], n_pops=k, gen_cap=mix["gen_cap"],
                mh_step_s=mix["mh_step_s"], alpha_sd=mix["alpha_sd"],
                alpha_prior_max=mix["alpha_prior_max"],
                s_subsweeps=mix["s_subsweeps"],
                fused_tail=mix["mode"] == 2 and k <= 8,
                ckrep=mix["ckrep"],
                check_at=mix["nstep_check_empty_cluster"],
                refreshed=nth % dic_every == 0,
                track_freq=mix["entry"] == "infer_k" or mix["track_freq"])


def trace_inputs(model: dict, bits2, z) -> dict:
    """The traced calls' inputs that the roofline readers count work from:
    the shapes and the site counts of the last job's ancestries."""
    from perfbench.work.site_pass import site_masks
    c, n, l2 = z.shape
    return dict(c=c, n=n, l=l2 // 2, k=model["n_pops"], a=2,
                masks=site_masks(z, bits2))


def breakdown(jobs) -> dict:
    ops, gaps = {}, {}
    for j in jobs:
        for name, (sec, _) in j.kernels.items():
            ops[name] = ops.get(name, 0.0) + sec
        for name, sec in j.gaps.items():
            gaps[name] = gaps.get(name, 0.0) + sec

    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def judge(numbers: dict, limits: dict):
    """(correct, the checks: each number beside its limit)."""
    checks = {}
    correct = True
    for name, lim in limits.items():
        v = numbers.get(name)
        ok = v is not None and math.isfinite(v) and v <= lim
        correct = correct and ok
        checks[name] = {"value": v, "limit": lim}
    for name in numbers:
        if name not in limits:
            correct = False
            checks[name] = {"value": numbers[name], "limit": None}
    return correct, checks


def check_numbers(runner, bits2, picked, seed: int,
                  control: bool = False) -> dict:
    """The check's numbers of the runner's last job (of ``seed``): its last
    sweep replayed, and under K selection each K's WAIC and the pick
    (``picked``: the program's ``best_k`` and ``waic``).  With ``control``
    the reference in bfloat16 stands in the program's place."""
    from perfbench import check
    mix, cap = runner.mix, runner.capture
    rec = dict(seed=seed, chain_keys=cap.final_keys,
               step=mix["n_iter"] - 1, prev=cap.prev, final=cap.final,
               chains=check.replay_sample(seed, runner.replicas,
                                          mix.get("replay_chains")))
    numbers = check.replay_numbers(
        bits2, model_of(mix, runner.sched.dic_every), rec, control)
    if picked is not None:
        numbers.update(check.pick_numbers(mix["k_range"], mix["n_chains"],
                                          cap.final, picked, control))
    return numbers


def picked_of(res) -> dict:
    """What K selection's result says: the pick and each K's WAICs."""
    return {"best_k": res.best_k, "waic": dict(res.waic)}


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, dev,
             t_start: float) -> dict:
    """One run of a cell on ``dev``; returns the result (without the JAX
    check).  ``spec`` as :func:`load_cell` gives it."""
    import torch
    from instruct_tpu_torch.data.dataset import packed_dataset
    from instruct_tpu_torch.kernels import _build
    from perfbench import check, jobs, panel, trace

    mix = spec["mix"]
    cuda = dev.type == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        _build.library()
    marks.append(("kernels", time.perf_counter()))
    bits2 = panel.make_panel(spec["cfg"], seed, dev)
    runner = jobs.Runner(mix, packed_dataset(bits2))
    sync(dev)
    marks.append(("panel", time.perf_counter()))
    res = runner.run(jobs.job_seed(seed, 0), warm=True)
    res = None
    sync(dev)
    marks.append(("warm-up job", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = ", ".join(f"{name} {t - t0:.3f}" for (name, t), (_, t0) in
                      zip(marks, [("start", t_start)] + marks[:-1]))

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, unhealthy, j = [], 0, 0
    t0 = time.perf_counter()
    while True:
        j += 1
        res = None
        ts = time.perf_counter()
        res = runner.run(jobs.job_seed(seed, j))
        sync(dev)
        walls.append(time.perf_counter() - ts)
        unhealthy += runner.capture.unhealthy > 0
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_jobs = j

    kept = []
    if traced:
        res = None

        def traced_job():
            nonlocal j
            j += 1
            ts = time.perf_counter()
            out = runner.run(jobs.job_seed(seed, j))
            sync(dev)
            return (out, time.perf_counter() - ts,
                    runner.capture.attempts * mix["n_iter"])

        res, kept, _ = trace.trace_jobs(traced_job, TRACED_JOBS)
    cap = runner.capture
    picked = picked_of(res) if runner.grid else None
    res = None

    model = model_of(mix, runner.sched.dic_every)
    last_seed = jobs.job_seed(seed, j)
    inputs = trace_inputs(model, bits2, cap.final["z"]) if traced else None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_numbers(runner, bits2, picked, last_seed)
    cap = None
    runner.capture.prev = runner.capture.final = None
    if cuda:
        torch.cuda.empty_cache()
    numbers.update(check.init_numbers(bits2, model, *runner.initial_state()))
    correct, checks = judge(numbers, spec["limits"])
    print(f"[perfbench] setup {setup_s:.3f} s ({parts} s), window "
          f"{window_s:.3f} s "
          f"({n_jobs} jobs), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    if traced:
        summary = types.SimpleNamespace(job_walls=walls, jobs=kept,
                                        inputs=inputs)
        metrics = {}
        for m in spec["per_layer"]:
            reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
            v = reader.read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        values = {"chain_steps_per_s":
                  n_jobs * runner.sweeps_per_job / window_s,
                  "peak_device_gib": peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": 1, "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit() if cuda else None}
    if traced:
        device["busy_s"] = sum(t.busy_s for t in kept)
        device["window_s"] = sum(t.wall_s for t in kept)
    result = {"correct": correct, "attempted": n_jobs, "failed": unhealthy,
              "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = breakdown(kept)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    cache_dirs()
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] {args.workload} needs {chips} CUDA device(s); "
              "none or too few here", file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"[perfbench] loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
