"""The traced jobs: each job of the traced window under ``torch.profiler``
(CPU and CUDA activity), reduced to what the per-layer metrics read.

The profiler drops records now and then.  A job's sweeps are counted by
an anchor, the Dirichlet kernel, which every sweep launches twice (P and
Q) and nothing else launches; a job whose trace holds fewer anchors than
its sweeps need lost events, is reported on standard error and left out,
and another job is profiled in its place, up to ``WINDOWS`` times.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import sys
from typing import Callable, Dict, List, Tuple

ANCHOR = "dirichlet_kernel"
ANCHORS_PER_SWEEP = 2
WINDOWS = 5
# CUDA runtime and driver calls that put work on the device: kernel
# launches and graph replays
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
SHORT_GAP_S = 20e-6          # idle gaps shorter than this are summed apart


@dataclasses.dataclass
class JobTrace:
    """One profiled job."""

    wall_s: float
    sweeps: int                   # sweeps the job ran, by the host's count
    anchors: int
    launches: int
    kernels: Dict[str, List[float]]   # name -> [device seconds, count]
    busy_s: float
    gaps: Dict[str, float]        # host activity -> idle seconds

    @property
    def complete(self) -> bool:
        return self.anchors >= ANCHORS_PER_SWEEP * self.sweeps


def _merge(intervals: List[Tuple[float, float]]):
    """Disjoint, sorted union of [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]], wall_s: float,
                  sweeps: int) -> JobTrace:
    """A job's trace from its device operations and host calls, each
    (name, start us, end us)."""
    kernels: Dict[str, List[float]] = {}
    for name, s, e in device:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += (e - s) * 1e-6
        row[1] += 1
    anchors = sum(row[1] for name, row in kernels.items() if ANCHOR in name)
    launches = sum(1 for name, _, _ in host if name in LAUNCH_CALLS)
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps: Dict[str, float] = {}
    ops = sorted((s, e, name) for name, s, e in host
                 if name not in LAUNCH_CALLS)
    starts = [o[0] for o in ops]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = (s1 - e0) * 1e-6
        if gap < SHORT_GAP_S:
            label = "short_gaps"
        else:
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid) - 1
            if i < 0:
                label = "no_host_call"
            else:
                s, e, name = ops[i]
                label = name if e >= mid else "after " + name
        gaps[label] = gaps.get(label, 0.0) + gap
    return JobTrace(wall_s, sweeps, anchors, launches, kernels, busy_s, gaps)


def profiled(job: Callable[[], Tuple[object, float, int]]) -> Tuple[object,
                                                                   JobTrace]:
    """Run ``job()`` -> (result, wall seconds, sweeps) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall_s, sweeps = job()
    device, host = [], []
    for ev in prof.events():
        row = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    return out, reduce_events(device, host, wall_s, sweeps)


def trace_jobs(job: Callable[[], Tuple[object, float, int]], n_keep: int):
    """Profile jobs until ``n_keep`` complete ones are held or ``WINDOWS``
    jobs lost events.  Returns (the last job's result, the complete traces,
    the number lost)."""
    kept: List[JobTrace] = []
    lost = 0
    out = None
    while len(kept) < n_keep and lost < WINDOWS:
        out = None
        out, jt = profiled(job)
        if jt.complete:
            kept.append(jt)
        else:
            lost += 1
            print(f"[perfbench] traced job lost events: {jt.anchors} "
                  f"{ANCHOR} records for {jt.sweeps} sweeps; profiling "
                  "another", file=sys.stderr)
    return out, kept, lost


SITE_NAME = re.compile(r"site_kernel<(\d+),\s*(\d+)>")


def site_calls(kernels: Dict[str, List[float]]) -> Dict[int, List[float]]:
    """The site pass's device seconds and calls by log-lik family (the
    kernel's second template argument)."""
    out: Dict[int, List[float]] = {}
    for name, (sec, count) in kernels.items():
        m = SITE_NAME.search(name)
        if m:
            row = out.setdefault(int(m.group(2)), [0.0, 0])
            row[0] += sec
            row[1] += count
    return out
