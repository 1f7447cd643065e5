"""Mean device seconds of a refresh of the Z-marginalized log-lik: the
program's ``mcmc.marg_loglik`` spans of the traced jobs
(``instruct_tpu_torch/spans.py``; layer: Z-marginalized log-lik,
``model/likelihood.py:marginal_indv_loglik``).  None where the program
records no spans."""

NAME = "mcmc.marg_loglik"


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
