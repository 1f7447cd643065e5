"""The spans of ``run_mcmc`` (``instruct_tpu_torch/spans.py``) on the CPU:
off outside a profiler session (nothing stored, no draw changed), and
under one the tree of a tiny mode-2 run -- one span of each phase where
the schedule says, nested in time, stamped on the profiler's clock, and
never an event of the profiler's own."""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instruct_tpu_torch import (ModelSpec, Schedule, run_mcmc,
                                synthetic_panel, write_panel)
from instruct_tpu_torch import spans
from instruct_tpu_torch.cli import main

SCHED = dict(n_iter=12, burnin=4, thinning=2, n_chains=2, ckrep=2,
             nstep_check_empty_cluster=2, dic_every=3)
# how a run is segmented: (run_mcmc's keywords, the segment length)
SEGMENTS = {
    "whole": ({}, None),
    "progress": ({"progress_every": 5, "progress_fn": lambda *a: None}, 5),
    "checkpoint": ({"checkpoint_every": 4}, 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_store():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(20, 30, n_pops=2, n_alleles=2,
                           selfing_rates=np.array([0.2, 0.7]), seed=3)


def _run(panel, seed=5, **kw):
    return run_mcmc(panel.data, ModelSpec(mode=2, n_pops=2),
                    Schedule(**SCHED), seed, device="cpu", track_freq=True,
                    **kw)


def _tensors(x):
    if x is None:
        return []
    if torch.is_tensor(x):
        return [x]
    return [t for part in x for t in _tensors(part)]


def _expected(seg_len):
    """Per span name the count the schedule asks of one unretried call."""
    s = Schedule(**SCHED)
    n = s.n_iter
    stored = [i for i in range(s.burnin, n)
              if (i + 1 - s.burnin) % s.thinning == 0]
    ends = ([n] if seg_len is None
            else list(range(seg_len, n, seg_len)) + [n])
    counts = {"mcmc.run": 1, "mcmc.init": 1, "mcmc.sweep": n,
              "mcmc.stored": len(stored),
              "mcmc.marg_loglik": math.ceil(len(stored) / s.dic_every),
              "mcmc.loglik": sum(e - 1 not in stored for e in ends),
              "mcmc.segment_end": 0 if seg_len is None else len(ends),
              "mcmc.finish": 1}
    return {k: v for k, v in counts.items() if v}


def _aten(prof):
    """The profiler's host operator events: starts and ends, ns."""
    ops = np.array([(e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("aten::")], dtype=np.int64)
    return ops[:, 0], ops[:, 1]


def test_off_stores_nothing_and_changes_no_draw(panel):
    plain = _run(panel)
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run(panel)
    assert len(spans.records()) > 0
    a = _tensors(plain.final_state) + _tensors(plain.accum)
    b = _tensors(traced.final_state) + _tensors(traced.accum)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(plain.plugin_ll, traced.plugin_ll)
    assert plain.n_retries == traced.n_retries


@pytest.mark.parametrize("how", sorted(SEGMENTS))
def test_span_tree_of_a_tiny_mode2_run(panel, tmp_path, how):
    kw, seg_len = SEGMENTS[how]

    def call(seed):
        if how == "checkpoint":
            return _run(panel, seed, **kw,
                        checkpoint_dir=str(tmp_path / str(seed)))
        return _run(panel, seed, **kw)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = [call(seed) for seed in (5, 6)]
    assert all(r.n_retries == 0 for r in results)
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    runs = [r for r in recs if r.name == spans.RUN]
    assert len(runs) == 2 and runs[0].run != runs[1].run
    for root in runs:
        assert root.parent is None and root.run == root.id
        mine = [r for r in recs if r.run == root.id]
        counts = {}
        for r in mine:
            counts[r.name] = counts.get(r.name, 0) + 1
        assert counts == _expected(seg_len)
    assert all(r.run in {root.id for root in runs} for r in recs)
    for r in recs:
        if r.name == "mcmc.marg_loglik":
            assert by_id[r.parent].name == "mcmc.stored"
        elif r.name != spans.RUN:
            assert by_id[r.parent].name == spans.RUN
    # parents hold their children in time; no self time is negative
    for r in recs:
        assert r.start_ns <= r.end_ns and r.device_s >= 0
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for name, row in spans.totals(recs).items():
        assert row["self_s"] >= 0, name
    for r in recs:
        kids = sum(c.device_s for c in recs if c.parent == r.id)
        assert r.device_s - kids >= 0, r
    # no annotation: no span is an event of the profiler's
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {r.name for r in recs}
    assert not any(n.startswith("mcmc.") for n in names)
    # on the profiler's clock: every sweep holds operators, and none
    # crosses a span's edge
    starts, ends = _aten(prof)
    for r in recs:
        inside = (starts >= r.start_ns) & (starts <= r.end_ns)
        if r.name == "mcmc.sweep":
            assert inside.any()
        assert (ends[inside] <= r.end_ns).all(), r.name
        assert not ((starts < r.start_ns) & (ends > r.start_ns)).any(), r.name


def test_span_stamps_are_the_profilers_clock():
    x, y = torch.ones(3), torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.kron(x, y)
        with spans.span("probe", "cpu"):
            torch.kron(x, y)
        torch.kron(x, y)
    (rec,) = spans.records()
    krons = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "aten::kron")
    assert len(krons) == 3
    before, inside, after = krons
    assert before[1] <= rec.start_ns <= inside[0]
    assert inside[1] <= rec.end_ns <= after[0]
    assert rec.device_s == pytest.approx((rec.end_ns - rec.start_ns) * 1e-9)


def test_span_off_is_one_shared_object():
    a, b = spans.span("mcmc.sweep", "cpu"), spans.span("x", "cuda")
    assert a is b
    with a:
        pass
    assert spans.records() == []


def test_profile_dir_writes_the_spans(tmp_path):
    panel = synthetic_panel(15, 12, n_pops=2, seed=21)
    f = tmp_path / "panel.txt"
    write_panel(panel, str(f))
    prof = tmp_path / "prof"
    rc = main(["-d", str(f), "-o", str(tmp_path / "o.txt"), "-v", "1", "-u",
               "20", "-b", "10", "-t", "2", "-c", "1", "-r", "5", "-j", "5",
               "-g", "0", "-pi", "0", "--platform", "cpu", "--profile-dir",
               str(prof)])
    assert rc == 0
    out = json.loads((prof / "spans.json").read_text())
    recs = [spans.Record(**r) for r in out["records"]]
    assert out["totals"] == json.loads(json.dumps(spans.totals(recs)))
    counts = {k: v["count"] for k, v in out["totals"].items()}
    assert counts == {"mcmc.run": 1, "mcmc.init": 1, "mcmc.sweep": 20,
                      "mcmc.stored": 5, "mcmc.marg_loglik": 1,
                      "mcmc.finish": 1}
    run = out["totals"]["mcmc.run"]
    assert 0 <= run["self_s"] <= run["device_s"]
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert spans.records() == []
