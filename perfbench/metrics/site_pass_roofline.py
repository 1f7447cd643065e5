"""The site pass's (K1) share of its roofline: the least time the chip
could take for the calls the traced jobs made (``work/site_pass.py`` on
the cell's own inputs, by log-lik family) over the calls' device time
(layer: kernels)."""

from perfbench.trace import site_calls
from perfbench.work import bound_s
from perfbench.work.site_pass import site_work

# log-lik family (the kernel's second template argument) -> the entry it
# serves: (work family, sampling, log-lik columns written)
FAMILIES = {0: ("sample", True, 0), 1: ("mode1", False, 1),
            2: ("loglik", False, 1), 3: ("gendiff", True, 1)}


def read(summary):
    x = summary.inputs
    bound = dev = 0.0
    for job in summary.jobs:
        for fam, (sec, count) in site_calls(job.kernels).items():
            if fam not in FAMILIES:
                return None
            name, sample, cols = FAMILIES[fam]
            bound += count * bound_s(*site_work(
                name, sample, x["c"], x["n"], x["l"], x["k"], x["a"], True,
                x["masks"], cols))
            dev += sec
    return 100.0 * bound / dev if dev > 0 else None
