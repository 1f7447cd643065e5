"""The readers of the program's spans (``metrics/sweep_ms.py``,
``stored_step_ms.py``, ``marg_refresh_s.py``, ``init_s.py``,
``job_fixed_share.py``): the exact value on hand-made records, None on
none and where the program has no spans, and on a tiny run's own."""

import importlib
import sys
from collections import namedtuple

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

R = namedtuple("R", "name id parent run start_ns end_ns device_s")


def _job(run_id, run_s, sweeps, stored, init_s):
    """Records of one job: its run span, init, sweeps and stored steps
    (device seconds, a refresh's child seconds or None each)."""
    ids = iter(range(run_id + 1, run_id + 100))
    out = [R("mcmc.run", run_id, None, run_id, 0, 1, run_s),
           R("mcmc.init", next(ids), run_id, run_id, 0, 1, init_s)]
    out += [R("mcmc.sweep", next(ids), run_id, run_id, 0, 1, s)
            for s in sweeps]
    for s, marg in stored:
        sid = next(ids)
        out.append(R("mcmc.stored", sid, run_id, run_id, 0, 1, s))
        if marg is not None:
            out.append(R("mcmc.marg_loglik", next(ids), sid, run_id, 0, 1,
                         marg))
    out.append(R("mcmc.finish", next(ids), run_id, run_id, 0, 1, 0.125))
    return out


RECS = (_job(1, 10.0, [2.0, 1.75, 2.25], [(0.25, None), (1.25, 1.0)], 0.5)
        + _job(200, 6.0, [2.0], [(1.5, 1.0)], 1.5))
EXPECTED = {
    "sweep_ms": 1e3 * 8.0 / 4,           # four sweeps
    "stored_step_ms": 1e3 * 1.0 / 3,     # 0.25 + (1.25 - 1) + (1.5 - 1)
    "marg_refresh_s": 2.0 / 2,
    "init_s": 2.0 / 2,
    "job_fixed_share": 100.0 * (16.0 - 8.0) / 16.0,
}


def _reader(name):
    return importlib.import_module(f"perfbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_hand_made_records(name):
    assert _reader(name).value(RECS) == EXPECTED[name]
    assert _reader(name).value([]) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_spans(monkeypatch, name):
    from instruct_tpu_torch import spans
    spans.clear()
    assert _reader(name).read(None) is None
    # a program without the span recorder: nothing to read, no error
    monkeypatch.setitem(sys.modules, "instruct_tpu_torch.spans", None)
    assert _reader(name).records() == []
    assert _reader(name).read(None) is None


def test_readers_on_a_tiny_traced_run():
    from instruct_tpu_torch import (ModelSpec, Schedule, run_mcmc, spans,
                                    synthetic_panel)
    panel = synthetic_panel(16, 20, n_pops=2, n_alleles=2,
                            selfing_rates=np.array([0.3, 0.8]), seed=2)
    sched = Schedule(n_iter=10, burnin=4, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2, dic_every=2)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        run_mcmc(panel.data, ModelSpec(mode=2, n_pops=2), sched, 9,
                 device="cpu")
    try:
        tot = spans.totals(spans.records())
        got = {name: _reader(name).read(None) for name in EXPECTED}
    finally:
        spans.clear()
    assert got["sweep_ms"] == pytest.approx(
        1e3 * tot["mcmc.sweep"]["device_s"] / 10)
    assert got["stored_step_ms"] == pytest.approx(
        1e3 * tot["mcmc.stored"]["self_s"] / 3)
    assert got["marg_refresh_s"] == pytest.approx(
        tot["mcmc.marg_loglik"]["device_s"] / 2)
    assert got["init_s"] == pytest.approx(tot["mcmc.init"]["device_s"])
    run = tot["mcmc.run"]["device_s"]
    assert got["job_fixed_share"] == pytest.approx(
        100 * (run - tot["mcmc.sweep"]["device_s"]) / run)
    assert 0 < got["job_fixed_share"] < 100
