"""Checkpoint / resume, retries, progress and the JSONL log of the port's
``run_mcmc`` on the CPU (the counterpart of ``tests/test_checkpoint.py``):
a run interrupted at a checkpoint resumes to *bitwise* the uninterrupted
run's moments; the carried ``zcounts`` are recounted from the restored z;
a retry saves under its own ``retry-<n>``; the progress block has the JAX
driver's lines for the same state values."""

import json
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JModelSpec
from instruct_tpu.config import Schedule as JSchedule
from instruct_tpu.data.synthetic import synthetic_panel as j_synthetic_panel
from instruct_tpu.mcmc.driver import run_mcmc as j_run_mcmc
from instruct_tpu_torch import (ModelSpec, Priors, Schedule, run_mcmc,
                                synthetic_panel)
from instruct_tpu_torch import checkpoint as ckpt
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.mcmc import driver as drv

SCHED = Schedule(n_iter=60, burnin=20, thinning=2, n_chains=2, ckrep=5,
                 nstep_check_empty_cluster=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(panel, spec, **kw):
    return run_mcmc(panel.data, spec, SCHED, 12, device="cpu", **kw)


def assert_same_moments(got, want):
    for name in ("total_ll", "q", "rates", "freq", "ll_marg"):
        assert torch.equal(getattr(got.accum.mean, name),
                           getattr(want.accum.mean, name)), name
    assert torch.equal(got.accum.mean_sq.total_ll, want.accum.mean_sq.total_ll)
    assert torch.equal(got.accum.convg_ld, want.accum.convg_ld)
    assert torch.equal(got.accum.lme_indv, want.accum.lme_indv)
    assert torch.equal(got.final_state.freq, want.final_state.freq)


@pytest.mark.parametrize("mode,ploid,family",
                         [(2, 2, None), (0, 2, None), (4, 2, None),
                          (2, 4, None), (3, 2, PriorFamily.DPM)],
                         ids=["mode2", "mode0", "mode4", "tetra",
                              "mode3_dpm"])
def test_checkpoint_resume_bitwise(tmp_path, mode, ploid, family):
    if ploid == 4:
        panel = synthetic_tetra_panel(10, 8, n_pops=2, n_alleles=3, seed=3)
    else:
        panel = synthetic_panel(10, 8, n_pops=2, seed=3)
    priors = Priors() if family is None else Priors(family=family)
    spec = ModelSpec(mode=mode, ploid=ploid, n_pops=2, priors=priors)
    straight = run(panel, spec)

    # checkpointed run, all segments in one process
    d1 = tmp_path / "ck1"
    ck = run(panel, spec, checkpoint_dir=str(d1), checkpoint_every=25)
    assert_same_moments(ck, straight)
    assert ckpt.latest_step(str(d1)) == 60
    saved = sorted(p.name for p in d1.iterdir())
    assert saved == [f"step_{s:012d}{x}" for s in (25, 50, 60)
                     for x in ("", ".meta.json")]

    # a crash after step 25: delete the last two checkpoints and resume
    shutil.rmtree(d1 / "step_000000000060")
    shutil.rmtree(d1 / "step_000000000050")
    resumed = run(panel, spec, checkpoint_dir=str(d1), checkpoint_every=25)
    assert_same_moments(resumed, straight)
    assert torch.equal(resumed.accum.mean.total_ll,
                       straight.accum.mean.total_ll)
    assert torch.equal(resumed.accum.mean.q, straight.accum.mean.q)
    assert torch.equal(resumed.accum.mean.rates, straight.accum.mean.rates)
    # the DPM prior's table is part of the state: stored, and resumed
    stored = torch.load(d1 / "step_000000000025" / "state.pt",
                        weights_only=True)
    for name in ("dpm_values", "dpm_counts", "dpm_assign"):
        assert (f"states.{name}" in stored) == (family is not None)
        assert torch.equal(getattr(resumed.final_state, name),
                           getattr(straight.final_state, name))


def test_checkpoint_format(tmp_path):
    """Leaves keyed by field path, CPU tensors, a meta file with the
    package and format version; a step without this package's meta (a JAX
    checkpoint, say) is refused."""
    panel = synthetic_panel(6, 5, n_pops=2, seed=1)
    spec = ModelSpec(mode=2, n_pops=2)
    d = tmp_path / "ck"
    run(panel, spec, checkpoint_dir=str(d), checkpoint_every=30)
    step = ckpt.latest_step(str(d))
    assert step == 60
    meta = json.loads((d / "step_000000000060.meta.json").read_text())
    assert meta["package"] == "instruct_tpu_torch"
    assert meta["format_version"] == ckpt.FORMAT_VERSION
    assert meta["step"] == 60
    for key in ("states.freq", "states.zcounts", "accums.mean.q",
                "accums.count", "chain_key"):
        assert key in meta["keys"]
    stored = torch.load(d / "step_000000000060" / "state.pt",
                        weights_only=True)
    assert stored["chain_key"].tolist() == [0, 1]
    assert "states.dpm_values" not in stored           # zero-size leaf
    assert all(t.device.type == "cpu" for t in stored.values())
    (d / "step_000000000060.meta.json").write_text(
        json.dumps({"format_version": 4, "step": 60, "keys": []}))
    with pytest.raises(ValueError, match="not a checkpoint"):
        run(panel, spec, checkpoint_dir=str(d), checkpoint_every=30)


def test_restore_refuses_a_shape_mismatch(tmp_path):
    payload = {"states": {"freq": torch.ones(2, 3)}, "chain_key": [0, 1]}
    ckpt.save_checkpoint(str(tmp_path), 5, payload)
    got = ckpt.restore_checkpoint(str(tmp_path), 5, payload)
    assert torch.equal(got["states"]["freq"], payload["states"]["freq"])
    assert got["chain_key"] == [0, 1]
    with pytest.raises(ValueError, match="expects"):
        ckpt.restore_checkpoint(str(tmp_path), 5,
                                {"states": {"freq": torch.ones(2, 4)},
                                 "chain_key": [0, 1]})


def test_resume_recomputes_zcounts(tmp_path, monkeypatch):
    """zcounts is derived state: a resume recounts it from the restored z
    with K4 (on the CPU its plain version) rather than trusting the saved
    value -- the fused sweep's P update reads it, so a trusted corrupt
    value would change the trajectory."""
    panel = synthetic_panel(8, 6, n_pops=2, seed=9)
    spec = ModelSpec(mode=2, n_pops=2)
    d = tmp_path / "ck"
    run(panel, spec, checkpoint_dir=str(d), checkpoint_every=30)
    shutil.rmtree(d / "step_000000000060")
    path = d / "step_000000000030" / "state.pt"
    saved = torch.load(path, weights_only=True)
    saved["states.zcounts"] = saved["states.zcounts"] + 123.0
    torch.save(saved, path)

    recounted = []
    real = fs.allele_counts

    def spy(z, *a, **kw):
        out = real(z, *a, **kw)
        recounted.append((z.clone(), out))
        return out

    monkeypatch.setattr(fs, "allele_counts", spy)
    resumed = run(panel, spec, checkpoint_dir=str(d), checkpoint_every=30)
    monkeypatch.undo()
    straight = run(panel, spec)
    assert_same_moments(resumed, straight)
    # the resume's recount read the restored z
    z_saved = saved["states.z"]
    assert any(torch.equal(z, z_saved) and torch.equal(
        out, fs.allele_counts_reference(
            z_saved, panel.data.geno, panel.data.site_valid, n_pops=2,
            max_alleles=2)) for z, out in recounted)


def test_checkpointed_run_retries_unhealthy(tmp_path, monkeypatch):
    """A chain flagged unhealthy in a checkpointed run is rerun with a
    fresh key in its own checkpoint namespace; the other chain replays its
    key (mirrors tests/test_checkpoint.py:157)."""
    panel = synthetic_panel(10, 8, n_pops=2, seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    clean = run(panel, spec)
    real_flags = drv.unhealthy_flags
    calls = {"n": 0}

    def flaky_flags(state, accum):
        calls["n"] += 1
        if calls["n"] == 1:                 # first pass: chain 0 "fails"
            return np.array([True, False])
        return real_flags(state, accum)

    monkeypatch.setattr(drv, "unhealthy_flags", flaky_flags)
    d = tmp_path / "ck"
    res = run(panel, spec, checkpoint_dir=str(d), checkpoint_every=25)
    assert res.n_retries == 1
    assert ckpt.latest_step(str(d / "retry-1")) == 60
    assert ckpt.restore_checkpoint(
        str(d / "retry-1"), 60, {"chain_key": [0, 0]})["chain_key"] == \
        [10_000, 1]
    ll, ll_clean = res.accum.mean.total_ll, clean.accum.mean.total_ll
    assert ll[0] != ll_clean[0]
    assert torch.equal(ll[1], ll_clean[1])


def test_jsonl_log_carries_full_rates(tmp_path):
    """One JSONL record a segment with the complete per-chain rates matrix
    (mirrors tests/test_checkpoint.py:194)."""
    panel = synthetic_panel(300, 8, n_pops=2, seed=3)
    spec = ModelSpec(mode=3, n_pops=2)       # per-individual S: 300 rates
    log = tmp_path / "log.jsonl"
    run(panel, spec, progress_every=30, jsonl_log=str(log),
        progress_fn=lambda *a: None)
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [30, 60]
    assert [x["stored"] for x in lines] == [5, 20]
    rates = np.asarray(lines[-1]["rates"])
    assert rates.shape == (2, 300)
    assert np.isfinite(rates).all()
    assert len(lines[-1]["loglik"]) == 2


PROGRESS = re.compile(
    r"^\nStep=\d+\tchain=\d+\tlog_likelihood=-?\d+\.\d{6}\n"
    r"(s|f)_0=\d\.\d{6}( st_0=[012])?( (s|f)_\d+=\d\.\d{6}( st_\d+=[012])?)*"
    r"( \.\.\. \[\d+ more; min=\d\.\d{6} mean=\d\.\d{6} max=\d\.\d{6}; "
    r"full values in the JSONL log\])?$")


def test_progress_block_matches_jax():
    """For the same state values the port's progress block has the JAX
    driver's lines: the JAX run's values, caught by a progress_fn, go
    through the port's printer and must give the text the JAX run
    printed."""
    import contextlib
    import io
    jpanel = j_synthetic_panel(n_indv=10, n_loci=8, n_pops=2, seed=3)
    jspec = JModelSpec(mode=2, n_pops=2, back_refl=0)
    jsched = JSchedule(n_iter=40, burnin=20, thinning=2, n_chains=2,
                       ckrep=5, nstep_check_empty_cluster=5)
    seen = []

    def catch(step, states, accums):
        seen.append((step, np.asarray(states.loglik_total),
                     np.asarray(states.rates), np.asarray(states.ais_state)))

    key = jax.random.key(4)
    j_run_mcmc(jpanel.data, jspec, jsched, key, progress_every=20,
               progress_fn=catch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_run_mcmc(jpanel.data, jspec, jsched, key, progress_every=20)
    spec = ModelSpec(mode=2, n_pops=2, back_refl=0)
    mine = "\n".join(drv.progress_lines(spec, s, ll, r, st)
                     for s, ll, r, st in seen) + "\n"
    assert [s for s, *_ in seen] == [20, 40]
    assert mine == out.getvalue()
    assert "st_1=" in mine


def test_progress_block_layout(capsys):
    """The port's own runs print one block a chain a segment: s_i= (modes
    2/3, tetraploid) or f_i= (4/5), st_i= under back_refl=0 where S/F is
    per pop, at most 512 values and then a summary."""
    panel = synthetic_panel(10, 8, n_pops=2, seed=3)
    run(panel, ModelSpec(mode=2, n_pops=2, back_refl=0), progress_every=30)
    out = capsys.readouterr().out
    blocks = re.findall(r"\nStep=[^\n]*\n[^\n]*", out)
    assert len(blocks) == 2 * 2
    for b in blocks:
        assert PROGRESS.match(b), b
        assert "st_1=" in b
    ll = np.array([-10.5, -11.25])
    text = drv.progress_lines(ModelSpec(mode=5, n_pops=2), 7, ll,
                              np.linspace(0, 1, 2 * 600).reshape(2, 600),
                              None)
    blocks = re.findall(r"\nStep=[^\n]*\n[^\n]*", text)
    assert len(blocks) == 2
    for b in blocks:
        assert PROGRESS.match(b), b
        assert b.count("f_") == 512 and "[88 more;" in b
