"""Device time of a call from ``torch.profiler``, for the variant tools and
``chip_smoke.py``.

CUDA events over back-to-back calls read the host's enqueue of a wrapper
when its kernels are shorter than that enqueue; the profiler's kernel
records do not.
"""

from __future__ import annotations

import sys

# profiled windows tried before a time falls back to CUDA events
WINDOWS = 5


def _window(fn, name: str, n: int):
    """One profiled window of ``n`` calls behind one warm-up call (the
    profiler's own warm-up step: the events of the first calls after it
    turns device tracing on can be lost).  Returns (the device us and the
    count of the kernels whose name holds ``name``, the count of every
    kernel the window holds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    total = count = seen = 0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", 0.0)
        if ev.key.startswith("ProfilerStep") or dev <= 0:
            continue
        seen += ev.count
        if name in ev.key:
            total += dev
            count += ev.count
    return total, count, seen


def _events_ms(fn, n: int) -> float:
    """The time of one ``fn()`` in ms by CUDA events over ``n`` calls
    back to back: the device's time where its kernels outlast the host's
    enqueue, the enqueue's where they do not."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, name: str, n: int = 30, per_call: bool = False) -> float:
    """Device time of one ``fn()`` in ms: the total of the kernels whose
    name holds ``name`` over their count, times the kernels a call where
    ``per_call`` (a call of several such kernels).  The profiler loses an
    event now and then, and now and then a whole window: a window without
    any is profiled again, up to ``WINDOWS``.  Where every window lost all
    its kernels, the time is that of one call by CUDA events
    (``_events_ms``), and a line on standard error says so; where the
    windows held other kernels but never ``name``, it fails."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    held_others = 0
    for _ in range(WINDOWS):
        total, count, seen = _window(fn, name, n)
        if count:
            return total / count * (max(1, round(count / n)) if per_call
                                    else 1) / 1e3
        held_others += seen > 0
    if held_others == WINDOWS:
        raise AssertionError(f"the profiler saw no kernel named {name} in "
                             f"{WINDOWS} windows that held other kernels")
    ms = _events_ms(fn, n)
    print(f"profiling.device_ms: the profiler lost every kernel of {name} "
          f"in {WINDOWS} windows; {ms:.6g} ms a call by CUDA events",
          file=sys.stderr, flush=True)
    return ms
