#!/usr/bin/env python3
"""Readings that the check's limits are set from, for one cell, in one
process: for each seed, a panel and one job of the cell's mix, then the
check's numbers of the program (sound readings) and, for the first
``--control`` seeds, of the control (the reference in bfloat16 in the
program's place).  One JSON line a seed and kind; ``--out`` appends them
to a file as well.

    python3 perfbench/calibrate.py --workload regmap.mode2 --seeds 1-12 \
        --control 3 --out calib.jsonl
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(spec, seed: int, control: bool, dev):
    """(program's numbers, control's numbers or None) of one job."""
    import torch
    from instruct_tpu_torch.data.dataset import packed_dataset
    from perfbench import check, jobs, panel
    bits2 = panel.make_panel(spec["cfg"], seed, dev)
    runner = jobs.Runner(spec["mix"], packed_dataset(bits2))
    js = jobs.job_seed(seed, 1)
    t = time.perf_counter()
    res = runner.run(js)
    run.sync(dev)
    job_s = time.perf_counter() - t
    picked = run.picked_of(res) if runner.grid else None
    res = None
    cap = runner.capture
    t = time.perf_counter()
    sound = run.check_numbers(runner, bits2, picked, js)
    ref_s = time.perf_counter() - t
    ctrl = None
    if control:
        ctrl = run.check_numbers(runner, bits2, picked, js, control=True)
    attempts = cap.attempts
    cap.prev = cap.final = cap = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sound.update(check.init_numbers(
        bits2, run.model_of(spec["mix"], runner.sched.dic_every),
        *runner.initial_state()))
    return sound, ctrl, dict(job_s=job_s, reference_s=ref_s,
                             attempts=attempts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    run.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("[perfbench] calibrate needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    from instruct_tpu_torch.kernels import _build
    _build.library()
    for i, seed in enumerate(seeds_of(args.seeds)):
        sound, ctrl, times = readings(spec, seed, i < args.control, dev)
        lines = [dict(workload=args.workload, seed=seed, kind="program",
                      numbers=sound, **times)]
        if ctrl is not None:
            lines.append(dict(workload=args.workload, seed=seed,
                              kind="control", numbers=ctrl))
        for line in lines:
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(text + "\n")
    print(json.dumps({"done_s": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
