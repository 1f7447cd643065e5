"""The Dirichlet kernel's (K3) share of its roofline: the least time of a
sweep's two calls, P over (chain, pop, locus, allele) cells and Q over
(chain, individual, pop) cells (``work/dirichlet.py``), times the sweeps
the anchor counts, over the kernel's device time (layer: kernels)."""

from perfbench.trace import ANCHOR, ANCHORS_PER_SWEEP
from perfbench.work import bound_s
from perfbench.work.dirichlet import dirichlet_work


def read(summary):
    x = summary.inputs
    c, n, l, k, a = x["c"], x["n"], x["l"], x["k"], x["a"]
    sweep = (bound_s(*dirichlet_work(c * k * l * a, l * a))
             + bound_s(*dirichlet_work(c * n * k)))
    bound = dev = 0.0
    for job in summary.jobs:
        for name, (sec, count) in job.kernels.items():
            if ANCHOR in name:
                dev += sec
                bound += count / ANCHORS_PER_SWEEP * sweep
    return 100.0 * bound / dev if dev > 0 else None
