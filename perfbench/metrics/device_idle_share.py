"""The share of the traced jobs' wall in which no operation runs on the
device (layer: device)."""


def read(summary):
    wall = sum(j.wall_s for j in summary.jobs)
    if wall <= 0:
        return None
    busy = sum(j.busy_s for j in summary.jobs)
    return 100.0 * max(0.0, 1.0 - busy / wall)
