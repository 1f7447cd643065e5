"""The port's report writers against the JAX package's: one posterior made
with numpy (every ChainAccum field, the plug-in log-lik, the retry count),
wrapped in each package's RunResult / KSelectResult, written with the same
argv and echo, must give byte-equal reports.

The Gelman-Rubin statistic and the ESS of the log-lik trace are computed by
each package's own diagnostics in float32, whose reductions run in another
order (XLA's against torch's), and the cancellation in the trace's variance
amplifies that to ~1e-6 of R: the 6th decimal the report prints.  So each
case writes both reports twice: with one shared pair of diagnostics
functions, where the bytes must be equal, and with each package's own,
where every line but the convergence lines must be equal and those hold the
same numbers to the diagnostics' own tolerance (``test_torch_slice.py``:
GR rtol 1e-5, ESS 1e-4)."""

import io
import re

import numpy as np
import pytest
import torch

import instruct_tpu.diagnostics as jdiag
import instruct_tpu.report as jreport
import instruct_tpu_torch.report as treport
from instruct_tpu.config import ModelSpec as JModelSpec
from instruct_tpu.config import Schedule as JSchedule
from instruct_tpu.data import loader as jloader
from instruct_tpu.kselect import KSelectResult as JKSelectResult
from instruct_tpu.mcmc.accumulators import ChainAccum as JChainAccum
from instruct_tpu.mcmc.accumulators import TrackedStats as JTrackedStats
from instruct_tpu.mcmc.driver import RunResult as JRunResult
from instruct_tpu.report import write_kselect_report as j_write_kselect
from instruct_tpu.report import write_report as j_write_report
from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data import loader
from instruct_tpu_torch.data.synthetic import (synthetic_panel,
                                               synthetic_tetra_panel)
from instruct_tpu_torch.kselect import KSelectResult
from instruct_tpu_torch.mcmc.accumulators import ChainAccum, TrackedStats
from instruct_tpu_torch.mcmc.driver import RunResult
from instruct_tpu_torch.report import write_kselect_report, write_report

N_CHAINS, CKREP = 3, 12
ARGV = ["instruct", "-d", "panel.txt", "-o", "out.txt"]
ECHO = {"datafile": "panel.txt", "initfile": None, "outfile": "out.txt",
        "missing": "-9", "siglevel": 0.9, "seeds": [1, 2, 3]}


GR_LINE = re.compile(r"The Gelman-Rubin statistics for the convergence of "
                     r"log-likelihood is (\S+)\.$")
ESS_LINE = re.compile(r"Effective sample size of the log-likelihood trace "
                      r"per chain: (.*) \(of (\d+) stored\)$")


def shared_gr(traces):
    """One float64 PSRF (check_converg.c:100-153) for both writers."""
    t = np.asarray(traces, np.float64)
    m, n = t.shape
    cm = t.mean(axis=1)
    w = t.var(axis=1, ddof=1).mean()
    b = n * ((cm - cm.mean()) ** 2).sum() / (m - 1)
    return np.float64((w * (n - 1) / n + b / n) / w)


def shared_ess(trace):
    return float(np.asarray(trace, np.float64).std() * 7.0 + 3.0)


def write_both(monkeypatch, shared, port_call, jax_call):
    """(port text, JAX text), with the shared diagnostics or each
    package's own."""
    with monkeypatch.context() as m:
        if shared:
            m.setattr(treport, "gelman_rubin", shared_gr)
            m.setattr(treport, "effective_sample_size", shared_ess)
            m.setattr(jreport, "gelman_rubin", shared_gr)
            m.setattr(jdiag, "effective_sample_size", shared_ess)
        return port_call(), jax_call()


def assert_reports_agree(monkeypatch, port_call, jax_call):
    text, jtext = write_both(monkeypatch, True, port_call, jax_call)
    assert text.encode() == jtext.encode()
    text, jtext = write_both(monkeypatch, False, port_call, jax_call)
    lines, jlines = text.split("\n"), jtext.split("\n")
    assert len(lines) == len(jlines)
    for a, b in zip(lines, jlines):
        if a == b:
            continue
        ga, gb = GR_LINE.match(a), GR_LINE.match(b)
        ea, eb = ESS_LINE.match(a), ESS_LINE.match(b)
        if ga and gb:
            np.testing.assert_allclose(float(ga[1]), float(gb[1]),
                                       rtol=1e-5)
        elif ea and eb:
            assert ea[2] == eb[2]
            np.testing.assert_allclose(
                [float(x) for x in ea[1].split()],
                [float(x) for x in eb[1].split()], rtol=1e-4)
        else:
            raise AssertionError(f"lines differ:\n{a!r}\n{b!r}")
    return text


def panels(tmp_path, ploid):
    """The same file read by both loaders: (port Panel, JAX Panel)."""
    f = tmp_path / f"panel{ploid}.txt"
    if ploid == 4:
        loader.write_panel(synthetic_tetra_panel(9, 7, n_pops=2,
                                                 n_alleles=3, seed=4),
                           str(f), data_fmt=1)
    else:
        loader.write_panel(synthetic_panel(11, 9, n_pops=2, n_alleles=3,
                                           seed=6), str(f), data_fmt=0)
    kw = dict(ploid=ploid, data_fmt=1 if ploid == 4 else 0,
              log=io.StringIO())
    return loader.read_data(str(f), **kw), jloader.read_data(str(f), **kw)


def posterior(rng, spec, n, l, a, track_freq):
    """(fields of mean, fields of mean_sq, rest of ChainAccum, plug-in) as
    float32 numpy arrays with a chain axis."""
    c, k = N_CHAINS, spec.n_pops
    r = spec.n_rates(n)

    def f32(x):
        return np.asarray(x, np.float32)

    def stats():
        q = rng.dirichlet(np.ones(k), size=(c, n))
        return dict(
            total_ll=f32(rng.normal(-300, 20, c)),
            indv_ll=f32(rng.normal(-25, 3, (c, n))),
            q=f32(q),
            rates=f32(rng.random((c, r))),
            gen=f32(1 + 3 * rng.random((c, n if spec.has_selfing else 0))),
            freq=(f32(rng.dirichlet(np.ones(a), size=(c, k, l)))
                  if track_freq else f32(np.zeros((c, 0)))),
            ll_marg=f32(rng.normal(-26, 3, (c, n))),
            freq2=f32(np.zeros((c, 0))))

    mean = stats()
    mean_sq = {name: f32(v * v + 0.05 * rng.random(v.shape))
               for name, v in mean.items()}
    rest = dict(count=np.full(c, 40, np.int32),
                convg_ld=f32(rng.normal(-300, 15, (c, CKREP))),
                empty_cluster=np.zeros(c, bool),
                lme_indv=f32(rng.normal(-24, 3, (c, n))),
                m2_ll_marg=f32(40 * rng.random((c, n))))
    plug = (rng.normal(-550, 10, c).astype(np.float64) if track_freq
            else None)
    return mean, mean_sq, rest, plug


def results(rng, spec, panel, track_freq, retries=1):
    """The same posterior as the JAX RunResult (numpy leaves, as after
    the JAX driver's host gather) and as the port's (CPU tensors)."""
    data = panel.data
    mean, mean_sq, rest, plug = posterior(
        rng, spec, data.n_indv, data.n_loci, data.max_alleles, track_freq)
    j = JRunResult(
        accum=JChainAccum(mean=JTrackedStats(**mean),
                          mean_sq=JTrackedStats(**mean_sq), **rest),
        final_state=None, n_retries=retries, plugin_ll=plug)

    def t(d):
        return {name: torch.from_numpy(v.copy()) for name, v in d.items()}

    p = RunResult(
        accum=ChainAccum(mean=TrackedStats(**t(mean)),
                         mean_sq=TrackedStats(**t(mean_sq)), **t(rest)),
        final_state=None, n_retries=retries,
        plugin_ll=None if plug is None else plug.copy())
    return p, j


def specs(mode, ploid, n_pops=3):
    kw = dict(mode=mode, ploid=ploid, n_pops=n_pops)
    return ModelSpec(**kw), JModelSpec(**kw)


def scheds():
    kw = dict(n_iter=200, burnin=100, thinning=2, n_chains=N_CHAINS,
              ckrep=CKREP, nstep_check_empty_cluster=5)
    return Schedule(**kw), JSchedule(**kw)


@pytest.mark.parametrize("distr_fmt", [0, 1], ids=["df0", "df1"])
@pytest.mark.parametrize("print_freq", [False, True], ids=["pf0", "pf1"])
@pytest.mark.parametrize("mode,ploid", [(1, 2), (2, 2), (3, 2), (4, 2),
                                        (2, 4)],
                         ids=["mode1", "mode2", "mode3", "mode4", "tetra"])
def test_write_report_bytes_match_jax(tmp_path, monkeypatch, mode, ploid,
                                      print_freq, distr_fmt):
    rng = np.random.default_rng(100 * mode + ploid + 10 * print_freq)
    panel, jpanel = panels(tmp_path, ploid)
    spec, jspec = specs(mode, ploid)
    sched, jsched = scheds()
    res, jres = results(rng, spec, panel, print_freq)
    names = ["alpha", "beta", "gamma"]
    kw = dict(chain_names=names, argv=ARGV, distr_fmt=distr_fmt,
              print_freq=print_freq, gr_flag=True, echo=ECHO)
    out, jout = tmp_path / "port.txt", tmp_path / "jax.txt"

    def port():
        write_report(str(out), panel, spec, sched, res, **kw)
        return out.read_text()

    def jax_():
        j_write_report(str(jout), jpanel, jspec, jsched, jres, **kw)
        return jout.read_text()

    text = assert_reports_agree(monkeypatch, port, jax_)
    assert "Gelman-Rubin" in text and "alpha:" in text
    assert ("Estimated allele frequencies" in text) == print_freq
    if print_freq:
        assert "Effective number of parameters pD" in text


@pytest.mark.parametrize("mode,print_freq,gr_flag", [
    (2, True, True), (1, False, True), (4, True, False)],
    ids=["mode2-pf1", "mode1-pf0", "mode4-pf1-gr0"])
def test_write_kselect_report_bytes_match_jax(tmp_path, monkeypatch, mode,
                                              print_freq, gr_flag):
    rng = np.random.default_rng(7 + mode)
    panel, jpanel = panels(tmp_path, 2)
    sched, jsched = scheds()
    ks = (1, 2, 3)
    port, jax_ = {}, {}
    for k in ks:
        spec_k, _ = specs(mode, 2, n_pops=k)
        port[k], jax_[k] = results(rng, spec_k, panel, print_freq,
                                   retries=0)
    cols = {}
    for name in ("dic", "dic_reference", "waic"):
        cols[name] = {k: rng.normal(1000, 30, N_CHAINS) for k in ks}
    cols["p_d"] = {k: (rng.normal(20, 2, N_CHAINS) if print_freq else None)
                   for k in ks}
    cols["waic_se"] = {k: float(rng.random() * 10) for k in ks}
    cols["gelman_rubin"] = {1: 1.0123, 2: None, 3: 1.5}
    common = dict(best_k=2, n_small=1, n_large=3, **cols)
    ksel = KSelectResult(results=port, **common)
    jksel = JKSelectResult(results=jax_, **common)
    spec, jspec = specs(mode, 2, n_pops=3)
    kw = dict(argv=ARGV, distr_fmt=1, print_freq=print_freq,
              gr_flag=gr_flag, echo=ECHO)
    out, jout = tmp_path / "port.txt", tmp_path / "jax.txt"

    def port():
        write_kselect_report(str(out), panel, spec, sched, ksel, **kw)
        return out.read_text()

    def jax_():
        j_write_kselect(str(jout), jpanel, jspec, jsched, jksel, **kw)
        return jout.read_text()

    text = assert_reports_agree(monkeypatch, port, jax_)
    assert "The optimal K is 2" in text
    assert text.count("The current K is") == len(ks)
    assert ("Gelman-Rubin" in text) == gr_flag
