"""The share of a job's device time that is not its sweeps: 100 x (the
``mcmc.run`` spans' device seconds less the ``mcmc.sweep`` spans') over
the ``mcmc.run`` spans', every traced job's together
(``instruct_tpu_torch/spans.py``; what a longer job would spread over
more sweeps; layer: entry point).  None where the program records no
spans."""

RUN = "mcmc.run"
SWEEP = "mcmc.sweep"


def records():
    try:
        from instruct_tpu_torch import spans
    except ImportError:
        return []
    return spans.records()


def value(recs):
    run = sum(r.device_s for r in recs if r.name == RUN)
    if run <= 0:
        return None
    sweeps = sum(r.device_s for r in recs if r.name == SWEEP)
    return 100.0 * (run - sweeps) / run


def read(summary):
    return value(records())
