"""The slowest job's wall in the window: host clock around each call,
ended by a synchronize (layer: the entry point)."""


def read(summary):
    return max(summary.job_walls) if summary.job_walls else None
