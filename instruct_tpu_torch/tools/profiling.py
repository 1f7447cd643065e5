"""Device time of a call from ``torch.profiler``, for the variant tools and
``chip_smoke.py``.

CUDA events over back-to-back calls read the host's enqueue of a wrapper
when its kernels are shorter than that enqueue; the profiler's kernel
records do not.
"""

from __future__ import annotations

# profiled windows tried before a time fails
WINDOWS = 3


def device_ms(fn, name: str, n: int = 30, per_call: bool = False) -> float:
    """Device time of one ``fn()`` in ms: the total of the kernels whose
    name holds ``name`` over their count, times the kernels a call where
    ``per_call`` (a call of several such kernels).  The profiler loses an
    event now and then, and now and then a whole window: a window without
    any is profiled again, up to ``WINDOWS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "self_device_time_total", 0.0)
                count += ev.count
        if count:
            return total / count * (max(1, round(count / n)) if per_call
                                    else 1) / 1e3
    raise AssertionError(f"the profiler saw no kernel named {name} in "
                         f"{WINDOWS} windows")
