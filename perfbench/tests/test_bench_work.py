"""The copied work counts and profile arithmetic, pinned to their source:
``work/site_pass.py`` and ``work/dirichlet.py`` give the bytes and
operations of ``chip_smoke.py``'s ``site_work`` and K3 counts on small CPU
inputs, for each site-pass entry the cells use; the trace's reduction
counts sweeps by its anchor and profiles again when a job is short of
events.  The benchmark's runs never read ``chip_smoke.py``."""

import importlib.util
from pathlib import Path

import pytest
import torch

from instruct_tpu_torch.data.dataset import packed_dataset
from instruct_tpu_torch.kernels import dirichlet as dk
from perfbench import panel, trace, work
from perfbench.work import dirichlet as wd
from perfbench.work import site_pass as ws

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CFG = {"n_indv": 30, "n_loci": 200,
       "assumed": {"n_pops": 3, "selfing_rates": [0.2, 0.5, 0.9],
                   "admixture_alpha": 0.2, "missing_rate": 0.05,
                   "gen_cap": 50}}
# the entries the cells run: (chip_smoke's name, family, sampling, columns)
ENTRIES = [("site_pass_gendiff", "gendiff", True, 1),
           ("site_pass_loglik", "loglik", False, 1),
           ("site_pass_sample", "sample", True, 0),
           ("site_pass_loglik_mode1", "mode1", False, 1)]


@pytest.mark.parametrize("k,c", [(3, 2), (8, 4), (10, 6)])
@pytest.mark.parametrize("entry", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_site_work_is_chip_smokes(smoke, entry, k, c):
    name, fam, sample, cols = entry
    bits2 = panel.make_panel(CFG, 3, "cpu")
    data = packed_dataset(bits2)
    g = torch.Generator().manual_seed(k * 10 + c)
    n, l = bits2.shape
    z = torch.randint(0, k, (c, n, 2 * l), generator=g).to(torch.int8)
    q = torch.rand((c, n, k), generator=g)
    ll = torch.zeros((c, n, cols)) if cols else None
    want = smoke.site_work(name, {"data": data, "q": q, "z": z},
                           {"z": z if sample else None, "ll": ll},
                           structure=True)
    got = ws.site_work(fam, sample, c, n, l, k, 2, True,
                       ws.site_masks(z, bits2), cols)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cells", [1, 64, 4 * 8 * 214051 * 2])
def test_dirichlet_work_is_chip_smokes(smoke, cells):
    assert wd.dirichlet_work(cells)[1] == pytest.approx(smoke.k3_ops(cells))
    assert wd.N_UNIFORMS == dk.n_test_draws()
    assert wd.dirichlet_work(cells, 10)[0] == cells * 8 + 10


def test_peaks_are_chip_smokes(smoke):
    assert (work.HBM_RATE, work.FP32_RATE) == (smoke.HBM_RATE,
                                               smoke.FP32_RATE)
    assert (work.OPS_PHILOX, work.OPS_TRANSC) == (smoke.OPS_PHILOX,
                                                  smoke.OPS_TRANSC)


def _events(sweeps, drop=0):
    """A fake job's device and host events: per sweep a site kernel, two
    anchors and a gap of 100 us labelled by a host call."""
    dev, host = [], []
    t = 0.0
    for i in range(sweeps):
        for name, dur in (("void site_kernel<8, 3>(SiteArgs)", 50.0),
                          ("dirichlet_kernel", 10.0),
                          ("dirichlet_kernel", 10.0)):
            dev.append((name, t, t + dur))
            host.append(("cudaLaunchKernel", t - 5.0, t - 4.0))
            t += dur
        host.append(("aten::where", t + 1.0, t + 99.0))
        t += 100.0
    return dev[drop:], host


def test_sweeps_counted_by_the_anchor():
    jt = trace.reduce_events(*_events(10), wall_s=1.0, sweeps=10)
    assert jt.complete and jt.anchors == 20 and jt.launches == 30
    assert jt.busy_s == pytest.approx(10 * 70e-6)
    assert jt.gaps["aten::where"] == pytest.approx(9 * 100e-6)
    assert trace.site_calls(jt.kernels) == {3: [pytest.approx(500e-6), 10]}
    lost = trace.reduce_events(*_events(10, drop=3), wall_s=1.0, sweeps=10)
    assert not lost.complete


def test_short_job_is_profiled_again(monkeypatch):
    calls = []

    def fake(job):
        calls.append(1)
        drop = 3 if len(calls) <= 2 else 0
        return "res", trace.reduce_events(*_events(5, drop), 1.0, 5)

    monkeypatch.setattr(trace, "profiled", fake)
    out, kept, lost = trace.trace_jobs(lambda: None, 2)
    assert (len(kept), lost, len(calls)) == (2, 2, 4)
    assert all(j.complete for j in kept)


def test_metric_readers_on_a_fake_trace():
    from types import SimpleNamespace

    from perfbench.metrics import (device_idle_share, dirichlet_roofline,
                                   host_launches_per_sweep, job_s_max,
                                   site_pass_roofline)
    bits2 = panel.make_panel(CFG, 3, "cpu")
    n, l = bits2.shape
    z = torch.randint(0, 3, (2, n, 2 * l),
                      generator=torch.Generator().manual_seed(1)).to(
        torch.int8)
    masks = ws.site_masks(z, bits2)
    jt = trace.reduce_events(*_events(10), wall_s=2e-3, sweeps=10)
    s = SimpleNamespace(job_walls=[1.5, 2.5], jobs=[jt],
                        inputs=dict(c=2, n=n, l=l, k=3, a=2, masks=masks))
    site = work.bound_s(*ws.site_work("gendiff", True, 2, n, l, 3, 2, True,
                                      masks, 1))
    assert site_pass_roofline.read(s) == pytest.approx(
        100 * 10 * site / 500e-6)
    sweep = (work.bound_s(*wd.dirichlet_work(2 * 3 * l * 2, l * 2))
             + work.bound_s(*wd.dirichlet_work(2 * n * 3)))
    assert dirichlet_roofline.read(s) == pytest.approx(
        100 * 10 * sweep / 200e-6)
    assert host_launches_per_sweep.read(s) == pytest.approx(3.0)
    assert job_s_max.read(s) == 2.5
    assert device_idle_share.read(s) == pytest.approx(
        100 * (1 - 700e-6 / 2e-3))
    empty = SimpleNamespace(job_walls=[], jobs=[], inputs=s.inputs)
    for reader in (site_pass_roofline, dirichlet_roofline,
                   host_launches_per_sweep, job_s_max, device_idle_share):
        assert reader.read(empty) is None
