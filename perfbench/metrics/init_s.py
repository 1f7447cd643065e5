"""Mean device seconds of a chain start: the program's ``mcmc.init`` spans
of the traced jobs (``instruct_tpu_torch/spans.py``; the initial draws,
the Q counts and the seeded pop counts of ``mcmc/state.py:init_state``;
layer: entry point).  None where the program records no spans."""

NAME = "mcmc.init"


def records():
    try:
        from instruct_tpu_torch import spans
    except ImportError:
        return []
    return spans.records()


def value(recs):
    xs = [r.device_s for r in recs if r.name == NAME]
    return sum(xs) / len(xs) if xs else None


def read(summary):
    return value(records())
