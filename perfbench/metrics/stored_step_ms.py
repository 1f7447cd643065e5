"""Mean self device milliseconds of a stored step: each ``mcmc.stored``
span of the traced jobs (``instruct_tpu_torch/spans.py``) less its
``mcmc.marg_loglik`` child, the refresh that ``marg_refresh_s`` reads
(layer: sweep and host dispatch).  None where the program records no
spans."""

NAME = "mcmc.stored"
CHILD = "mcmc.marg_loglik"


def records():
    try:
        from instruct_tpu_torch import spans
    except ImportError:
        return []
    return spans.records()


def value(recs):
    child = {}
    for r in recs:
        if r.name == CHILD:
            child[r.parent] = child.get(r.parent, 0.0) + r.device_s
    xs = [r.device_s - child.get(r.id, 0.0) for r in recs if r.name == NAME]
    return 1e3 * sum(xs) / len(xs) if xs else None


def read(summary):
    return value(records())
