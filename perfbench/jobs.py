"""The system under test: one job of a cell's analysis mix through the
port's public entries (``run_mcmc`` or ``infer_k``), as a user calls them,
with the schedule's other settings at the program's defaults.

A job runs with ``progress_every = n_iter - 1``: the entry then hands its
state and running moments to ``progress_fn`` after sweep ``n_iter - 1``
and at the end, which is how the check gets the program's own state
before the last sweep.  That costs one more z-conditioned log-lik pass and
two small host reads a job (``PERF.md`` gives the measured cost).
:class:`Capture` keeps references to them (no copy) and follows the
entry's documented retry rule (a chain flagged unhealthy is rerun under
chain key ``10000 * attempt + c``) to know each chain's key.

The entry's initial state is tapped where the driver draws it: the tap
keeps the call's arguments and a fingerprint of the state (a few small
reductions on the device, no host read), so that the check judges the
same initial state that the timed job ran from.
"""

from __future__ import annotations

import dataclasses

import torch

from instruct_tpu_torch import ModelSpec, Schedule, infer_k, run_mcmc
from instruct_tpu_torch.mcmc import driver

MASK64 = 0xFFFFFFFFFFFFFFFF
INIT_STATE = driver.init_state   # the driver's own, whatever taps it
FOLD = 1009          # period of the position weights of a fingerprint
FP_BLOCK = 1 << 25   # elements of one block of a fingerprint's sums


def job_seed(seed: int, j: int) -> int:
    """The seed of job ``j`` of a run (job 0 is the warm-up)."""
    return (int(seed) * 0x9E3779B97F4A7C15
            + (j + 1) * 0xBF58476D1CE4E5B9) & MASK64


def fingerprint(state) -> dict:
    """Small tensors that tell one state from another: tensors of at most
    2^16 elements a chain whole, larger ones as the position-weighted
    sums of their two marginals, each chain apart (in blocks of rows, so
    that no copy of a whole plane is made)."""
    out = {}
    for name, x in state._asdict().items():
        if x is None or x.numel() == 0:
            continue
        c = x.shape[0]
        if x.numel() <= c << 16:
            out[name] = x.clone()
            continue
        dt = torch.float64 if x.is_floating_point() else torch.int64
        x = x.reshape(c, x.shape[1], -1)
        rows = max(1, FP_BLOCK // (c * x.shape[2]))
        cols = torch.zeros((c, x.shape[2]), dtype=dt, device=x.device)
        per_row = []
        for r0 in range(0, x.shape[1], rows):
            block = x[:, r0:r0 + rows].to(dt)
            cols += block.sum(1)
            per_row.append(block.sum(2))
        for key, m in (("cols", cols), ("rows", torch.cat(per_row, 1))):
            w = torch.arange(m.shape[1], device=m.device) % FOLD + 1
            out[f"{name}.{key}"] = (m * w.to(dt)).sum(-1)
    return out


def flat(state, accum) -> dict:
    """The state's and the moments' tensors by name (moments as
    ``acc.<field>``, tracked statistics as ``acc.mean.<stat>``)."""
    out = {name: v for name, v in state._asdict().items() if v is not None}
    for name, v in accum._asdict().items():
        if name in ("mean", "mean_sq"):
            for stat, x in v._asdict().items():
                out[f"acc.{name}.{stat}"] = x
        else:
            out["acc." + name] = v
    return out


class Capture:
    """``progress_fn`` of a job: the state before the last sweep and at the
    end, of the attempt that ran last, with its chain keys."""

    def __init__(self, n_iter: int, n_chains: int):
        self.n_iter = n_iter
        self.keys = list(range(n_chains))
        self.attempts = 0
        self.prev = self.final = None
        self.prev_keys = self.final_keys = None
        self.unhealthy = 0
        self.init_call = self.init_print = None

    def init_state(self, *args, **kw):
        """The driver's ``init_state``, tapped: the last attempt's call and
        its state's fingerprint are kept."""
        state = INIT_STATE(*args, **kw)
        self.init_call, self.init_print = (args, kw), fingerprint(state)
        return state

    def __call__(self, step, state, accum):
        if step == self.n_iter - 1:
            self.prev = flat(state, accum)
            self.prev_keys = list(self.keys)
        elif step == self.n_iter:
            self.final = flat(state, accum)
            self.final_keys = list(self.prev_keys)
            bad = (accum.empty_cluster
                   | ~torch.isfinite(accum.mean.total_ll)
                   | ~torch.isfinite(state.loglik_total)).tolist()
            self.attempts += 1
            self.unhealthy = sum(bad)
            self.keys = [10_000 * self.attempts + c if bad[c] else key
                         for c, key in enumerate(self.keys)]


class Runner:
    """Jobs of one cell: its mix (``traffic/<mix>.json``) on its panel."""

    def __init__(self, mix: dict, data):
        self.mix = mix
        self.data = data
        self.spec = ModelSpec(mode=mix["mode"], n_pops=mix["n_pops"],
                              gen_cap=mix["gen_cap"],
                              mh_step_s=mix["mh_step_s"],
                              s_subsweeps=mix["s_subsweeps"],
                              alpha_sd=mix["alpha_sd"],
                              alpha_prior_max=mix["alpha_prior_max"])
        self.grid = mix["entry"] == "infer_k"
        ks = mix["k_range"] if self.grid else [mix["n_pops"], mix["n_pops"]]
        self.replicas = (ks[1] - ks[0] + 1) * mix["n_chains"]
        self.sched = Schedule(n_iter=mix["n_iter"], burnin=mix["burnin"],
                              thinning=mix["thinning"],
                              n_chains=mix["n_chains"], ckrep=mix["ckrep"],
                              nstep_check_empty_cluster=mix[
                                  "nstep_check_empty_cluster"])
        # the warm-up: the same stages and shapes in fewer sweeps (a
        # burn-in of one thinning interval, then ckrep stored steps)
        t = mix["thinning"]
        self.warm_sched = dataclasses.replace(
            self.sched, burnin=t, n_iter=t * (1 + max(
                mix["ckrep"], mix["nstep_check_empty_cluster"])))
        self.capture = None

    @property
    def sweeps_per_job(self) -> int:
        """Chain-sweeps a job is asked for (replicas x sweeps)."""
        return self.replicas * self.mix["n_iter"]

    def run(self, seed: int, warm: bool = False):
        """One job (with ``warm`` the warm-up's shorter schedule); returns
        the entry's result.  ``self.capture`` holds its states."""
        self.capture = None
        sched = self.warm_sched if warm else self.sched
        cap = Capture(sched.n_iter, self.replicas)
        self.capture = cap
        kw = dict(progress_every=sched.n_iter - 1, progress_fn=cap,
                  device=self.data.geno.device)
        saved, driver.init_state = driver.init_state, cap.init_state
        try:
            if self.grid:
                lo, hi = self.mix["k_range"]
                spec = dataclasses.replace(self.spec, n_pops=hi)
                return infer_k(self.data, spec, sched, seed, n_small=lo,
                               n_large=hi, **kw)
            return run_mcmc(self.data, self.spec, sched, seed,
                            track_freq=self.mix["track_freq"], **kw)
        finally:
            driver.init_state = saved

    def initial_state(self) -> tuple:
        """(the initial state of the last job's last attempt, drawn again
        by the same call, as a dict; whether its fingerprint equals the
        one tapped from the job)."""
        args, kw = self.capture.init_call
        st = INIT_STATE(*args, **kw)
        same = _same(fingerprint(st), self.capture.init_print)
        return ({name: v for name, v in st._asdict().items()
                 if v is not None}, same)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)
