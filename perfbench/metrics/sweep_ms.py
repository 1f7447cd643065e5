"""Mean device milliseconds of a sweep: the program's ``mcmc.sweep`` spans
of the traced jobs (``instruct_tpu_torch/spans.py``; layer: sweep and host
dispatch).  None where the program records no spans."""

NAME = "mcmc.sweep"


def records():
    try:
        from instruct_tpu_torch import spans
    except ImportError:
        return []
    return spans.records()


def value(recs):
    xs = [r.device_s for r in recs if r.name == NAME]
    return 1e3 * sum(xs) / len(xs) if xs else None


def read(summary):
    return value(records())
