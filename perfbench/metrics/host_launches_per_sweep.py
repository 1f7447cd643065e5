"""Work put on the device by the host a sweep: CUDA kernel launches and
graph replays in the profiler's host activity, over the sweeps the anchor
counts (layer: sweep and host dispatch).  Per-job work (init, the result's
gather, the stored passes) is spread over the job's sweeps."""

from perfbench.trace import ANCHORS_PER_SWEEP


def read(summary):
    sweeps = sum(j.anchors for j in summary.jobs) / ANCHORS_PER_SWEEP
    launches = sum(j.launches for j in summary.jobs)
    if not sweeps or not launches:
        return None
    return launches / sweeps
