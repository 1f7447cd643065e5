"""The port's command line on the CPU (``--platform cpu``): the flows of
``tests/test_cli.py`` exit 0 and write reports with the JAX CLI's section
headers in the JAX CLI's order on the same file (the numbers differ by
design: the port draws Philox); ``--sampler hmc|nuts|svi|smc`` writes the
JAX writer's report bytes for its result; the mesh flags run (two
processes over gloo write one report, the unsharded run's) and what has no
counterpart (``--mesh-mode gspmd``) or no world (``--process-id`` alone)
exits 2 with the reason; without a card the default platform fails
instead of moving to the CPU."""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# both loaders bind their default log stream (sys.stdout) when imported:
# import them here, not inside a test whose captured stream then closes
import instruct_tpu.data.loader  # noqa: F401
from instruct_tpu.cli import main as j_main
from instruct_tpu_torch import synthetic_panel, write_panel
from instruct_tpu_torch.cli import build_parser, main, run_seed

REPO = Path(__file__).resolve().parent.parent

HEADER = re.compile(
    r"^(Run parameters:|    [A-Z][A-Za-z ]*[=:]|[A-Z][^\t]*:$|The |"
    r"Chain#|Indv\t|Given Pop|Locus_ID|K-selection|K\t|Effective sample|"
    r"Proportion of membership)")
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def headers(text):
    """The report's section headers in order, numbers blanked."""
    return [NUMBER.sub("#", ln) for ln in text.splitlines()
            if HEADER.match(ln)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def datafile(tmp_path):
    panel = synthetic_panel(15, 12, n_pops=2, seed=21)
    f = tmp_path / "panel.txt"
    write_panel(panel, str(f))
    return f


FLOWS = {
    "mode2": ["-v", "2", "-K", "2", "-u", "40", "-b", "20", "-t", "2",
              "-c", "2", "-r", "5", "-j", "5", "-s", "1", "2", "3"],
    "infer_k": ["-v", "1", "-u", "30", "-b", "10", "-t", "2", "-c", "1",
                "-r", "5", "-j", "5", "-ik", "1", "-kv", "1", "2", "-g",
                "0"],
    "initfile": ["-v", "2", "-K", "2", "-u", "30", "-b", "10", "-t", "2",
                 "-c", "1", "-r", "5", "-j", "5", "-g", "0"],
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cli_flows_match_jax_structure(datafile, tmp_path, capsys, flow):
    args = ["-d", str(datafile)] + FLOWS[flow]
    if flow == "initfile":
        init = tmp_path / "init.txt"
        init.write_text(">warm_start\n0.2 0.7\n")
        args += ["-i", str(init)]
    out, jout = tmp_path / "out.txt", tmp_path / "jout.txt"
    cvg, jcvg = tmp_path / "cvg.txt", tmp_path / "jcvg.txt"
    extra = ["-cf", str(cvg)] if flow == "mode2" else []
    assert main(args + ["-o", str(out), "--platform", "cpu"] + extra) == 0
    stdout = capsys.readouterr().out
    jextra = ["-cf", str(jcvg)] if flow == "mode2" else []
    assert j_main(args + ["-o", str(jout), "--platform", "cpu"]
                  + jextra) == 0
    jstdout = capsys.readouterr().out
    text, jtext = out.read_text(), jout.read_text()
    assert "SUCCESSFULLY FINISHED" in stdout
    assert headers(text) == headers(jtext)
    assert len(headers(text)) > 15
    # the same stdout lines apart from the numbers
    keep = re.compile(r"^(The memory|The maximum|The optimal|THE JOB)")
    assert [NUMBER.sub("#", ln) for ln in stdout.splitlines()
            if keep.match(ln)] == \
        [NUMBER.sub("#", ln) for ln in jstdout.splitlines()
         if keep.match(ln)]
    if flow == "mode2":
        assert "Selfing Rates" in text and "Gelman-Rubin" in text
        c, jc = cvg.read_text().split("\n"), jcvg.read_text().split("\n")
        assert c[0] == jc[0] == "Values of log-likelihood:"
        assert len(c[1].split()) == len(jc[1].split()) == 2 * 5
        assert c[1].endswith(" ") and "  " in c[1]
        assert "Step=40\tchain=1\tlog_likelihood=" in stdout
    if flow == "infer_k":
        assert "The optimal K is" in stdout
    if flow == "initfile":
        assert "warm_start" in text


def test_cli_checkpoint_resume_and_log(datafile, tmp_path, capsys):
    """A resumed CLI run (last checkpoint deleted) writes the report and
    the -cf file byte for byte as the first run did; the JSONL log has one
    record a segment with every chain's rates."""
    ck, log = tmp_path / "ck", tmp_path / "run.jsonl"
    base = ["-d", str(datafile), "-v", "2", "-K", "2", "-u", "40", "-b",
            "20", "-t", "2", "-c", "2", "-r", "5", "-j", "5", "-pf", "1",
            "--checkpoint-dir", str(ck), "--checkpoint-every", "20",
            "--jsonl-log", str(log), "--platform", "cpu"]
    first = base + ["-o", str(tmp_path / "a.txt"), "-cf",
                    str(tmp_path / "a.cvg")]
    assert main(first) == 0
    records = [json.loads(x) for x in log.read_text().splitlines()]
    # -pi 1: progress every max(1, 40 // 100) = 1 sweep
    assert [r["step"] for r in records] == list(range(1, 41))
    assert all(len(r["rates"]) == 2 and len(r["rates"][0]) == 2
               for r in records)
    os.remove(ck / "step_000000000040.meta.json")
    import shutil
    shutil.rmtree(ck / "step_000000000040")
    capsys.readouterr()
    assert main(first[:-4] + ["-o", str(tmp_path / "b.txt"), "-cf",
                              str(tmp_path / "b.cvg")]) == 0
    out = capsys.readouterr().out
    assert "Step=21\t" in out and "Step=20\t" not in out
    a = (tmp_path / "a.txt").read_text().replace("a.txt", "b.txt")
    a = a.replace("a.cvg", "b.cvg")
    assert a == (tmp_path / "b.txt").read_text()
    assert (tmp_path / "a.cvg").read_bytes() == \
        (tmp_path / "b.cvg").read_bytes()


REFUSED = {
    "mesh mode gspmd": (["--mesh-mode", "gspmd"], "has no counterpart"),
    "process id": (["--process-id", "0"], "needs --num-processes"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cli_refuses_what_is_not_ported(datafile, tmp_path, capsys, case):
    flags, reason = REFUSED[case]
    out = tmp_path / "out.txt"
    if "-p" in flags:
        from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
        write_panel(synthetic_tetra_panel(8, 6, n_pops=2, seed=1),
                    str(datafile), data_fmt=1)
        flags = flags + ["-af", "1"]
    rc = main(["-d", str(datafile), "-o", str(out), "-u", "30", "-b", "10",
               "--platform", "cpu"] + flags)
    assert rc == 2
    err = capsys.readouterr().err
    assert reason in err
    assert not out.exists()


def _report_body(path):
    """The report without the lines that echo the command line and the
    output file's name."""
    lines = Path(path).read_text().splitlines()
    skip = set()
    for i, ln in enumerate(lines):
        if ln.startswith("Command line arguments:"):
            skip.update((i, i + 1))
        if ln.startswith("Output File:"):
            skip.add(i)
    return [ln for i, ln in enumerate(lines) if i not in skip]


MESH_RUN = ["-v", "2", "-K", "2", "-u", "40", "-b", "20", "-t", "2", "-c",
            "2", "-r", "5", "-j", "5", "--platform", "cpu"]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_cli(datafile, tmp_path, flags, n=2):
    """``n`` processes of ``python -m instruct_tpu_torch`` joined over
    gloo, each with its own ``-o``; killed after 240 s."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "instruct_tpu_torch", "-d", str(datafile),
         "-o", str(tmp_path / f"o{i}.txt")] + MESH_RUN + flags +
        ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)})
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


MESH_CASES = {
    "two processes, chain shards": (["--chain-shards", "2"], 2, 0),
    "two processes, data shards": (["--data-shards", "2"], 2, 0),
    "mesh mode shard_map": (["--mesh-mode", "shard_map"], 1, 0),
    "a 1x1 mesh": (["--chain-shards", "1", "--data-shards", "1"], 1, 0),
    "chain shards without a world": (["--chain-shards", "2"], 1, 2),
    "num processes without a coordinator": (["--num-processes", "2"], 1,
                                            2),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_cli_runs_the_mesh_flags(datafile, tmp_path, capsys, case):
    """The mesh flags on the CPU: two processes over gloo exit 0 and rank
    0 alone writes the report -- the unsharded run's, byte for byte but
    for the lines naming the command and the output file, when the chains
    are split (bitwise the unsharded run); a run of one process takes a
    1x1 mesh and ``--mesh-mode shard_map`` to the same report; a mesh
    that does not fit the world (of one) and a world without a
    coordinator exit 2 naming why."""
    flags, n, rc_want = MESH_CASES[case]
    ref = tmp_path / "ref.txt"
    assert main(["-d", str(datafile), "-o", str(ref)] + MESH_RUN) == 0
    if n > 1:
        rcs, outs = _world_cli(datafile, tmp_path, flags, n)
        assert rcs == [0] * n, outs
        assert (tmp_path / "o0.txt").exists()
        assert not any((tmp_path / f"o{i}.txt").exists()
                       for i in range(1, n))
        assert outs[0].rstrip().endswith("THE JOB IS SUCCESSFULLY FINISHED")
        body = _report_body(tmp_path / "o0.txt")
        if "--chain-shards" in flags:
            assert body == _report_body(ref)
        else:
            # the loci shards draw their own site streams: the same report
            # sections, other numbers
            assert headers("\n".join(body)) == headers(
                "\n".join(_report_body(ref)))
        return
    capsys.readouterr()
    out = tmp_path / "o.txt"
    rc = main(["-d", str(datafile), "-o", str(out)] + MESH_RUN + flags)
    assert rc == rc_want
    if rc_want:
        err = capsys.readouterr().err
        assert ("world size is 1" if "--chain-shards" in flags
                else "--coordinator") in err
        assert not out.exists()
    else:
        assert _report_body(out) == _report_body(ref)


# Short engine configurations for the CLI's sampler runs: the schedule's
# own mapping (test_sampler_schedule_mapping_is_jax_s) asks NUTS for 150
# draws at depth 8, minutes of plain-version gradients on the CPU.
SHORT = {
    "hmc": dict(n_warmup=4, n_samples=4, n_leapfrog=3, init_step=0.02),
    "nuts": dict(n_warmup=2, n_samples=3, max_depth=3, init_step=0.02),
    "svi": dict(n_steps=20, learning_rate=0.02),
    "smc": dict(n_particles=16, n_temps=3, n_mh_steps=2, rw_scale=0.05),
}


def _short_config(method, sched):
    from instruct_tpu_torch.samplers import run as s_run
    return {"hmc": s_run.HmcConfig, "nuts": s_run.NutsConfig,
            "svi": s_run.SviConfig, "smc": s_run.SmcConfig}[method](
        **SHORT[method])


@pytest.mark.parametrize("method", list(SHORT))
def test_cli_runs_the_samplers(datafile, tmp_path, capsys, monkeypatch,
                               method):
    """``--sampler hmc|nuts|svi|smc --platform cpu``: exit code 0, the
    finishing line, and a report byte-identical to the JAX writer's
    (``instruct_tpu/samplers/run.py:write_sampler_report``) for the
    ``SamplerResult`` of the run."""
    from instruct_tpu.samplers import run as j_run
    from instruct_tpu_torch.data.loader import read_data
    from instruct_tpu_torch.samplers import run as s_run
    monkeypatch.setattr(s_run, "_schedule_config", _short_config)
    results = []
    real = s_run.run_sampler

    def spy(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(s_run, "run_sampler", spy)
    out, jout = tmp_path / "out.txt", tmp_path / "jout.txt"
    rc = main(["-d", str(datafile), "-o", str(out), "-v", "2", "-K", "2",
               "-u", "30", "-b", "10", "-t", "2", "-c", "2", "-r", "5", "-j",
               "5", "--sampler", method, "--platform", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.rstrip().endswith(
        "THE JOB IS SUCCESSFULLY FINISHED")
    (res,) = results
    assert res.method == method and res.s_mean.shape == (2,)
    assert res.q_mean.shape == (15, 2)
    assert np.isfinite(res.q_mean).all() and np.isfinite(res.s_mean).all()
    key = {"hmc": "accept_rate", "nuts": "accept_rate", "svi": "final_elbo",
           "smc": "log_evidence"}[method]
    assert key in res.extra
    j_res = j_run.SamplerResult(res.method, res.s_mean, res.s_var,
                                res.q_mean, res.q_var, res.extra)
    from instruct_tpu import ModelSpec as JSpec
    j_run.write_sampler_report(str(jout), read_data(str(datafile)),
                               JSpec(mode=2, n_pops=2), j_res, argv=sys.argv)
    text = out.read_bytes()
    assert text == jout.read_bytes()
    assert b"Selfing Rates" in text and b"Inferred ancestry" in text


class _Captured(Exception):
    pass


@pytest.mark.parametrize("method", ["hmc", "nuts", "svi", "smc"])
def test_sampler_schedule_mapping_is_jax_s(monkeypatch, method):
    """The engine configuration ``run_sampler`` derives from a Gibbs
    schedule (and chain count) is the one the JAX ``run_sampler`` passes to
    its engine, caught there by stubs."""
    import jax
    from instruct_tpu import ModelSpec as JSpec
    from instruct_tpu.data.synthetic import synthetic_panel as j_panel
    from instruct_tpu.samplers import nuts as j_nuts
    from instruct_tpu.samplers import run as j_run
    from instruct_tpu_torch import Schedule
    from instruct_tpu_torch.samplers.run import _schedule_config

    def catch(*args, **kw):
        cfgs = [a for a in args if dataclasses.is_dataclass(a)]
        raise _Captured(cfgs[0])

    monkeypatch.setattr(j_run, "_svi_warm_start", lambda *a: None)
    for mod, name in ((j_run, "run_hmc"), (j_nuts, "run_nuts"),
                      (j_run, "run_svi"), (j_run, "run_smc")):
        monkeypatch.setattr(mod, name, catch)
    data = j_panel(n_indv=6, n_loci=5, n_pops=2, seed=1).data
    for kw in (dict(n_iter=30, burnin=10, thinning=2, n_chains=2, ckrep=5,
                    nstep_check_empty_cluster=5),
               dict(n_iter=30_000, burnin=2000, thinning=10, n_chains=4,
                    ckrep=5, nstep_check_empty_cluster=5),
               dict(n_iter=900, burnin=300, thinning=1, n_chains=1, ckrep=5,
                    nstep_check_empty_cluster=5)):
        from instruct_tpu import Schedule as JSchedule
        with pytest.raises(_Captured) as cap:
            j_run.run_sampler(method, data, JSpec(mode=2, n_pops=2),
                              JSchedule(**kw), jax.random.key(0))
        want = cap.value.args[0]
        got = _schedule_config(method, Schedule(**kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw


RUNS_NOW = {
    "dpm prior": ["-v", "3", "-f", "1"],
    "dpm prior, tetraploid": ["-p", "4", "-f", "1"],
    "marginalize g": ["-v", "2", "--marginalize-g"],
}


@pytest.mark.parametrize("case", list(RUNS_NOW))
def test_cli_runs_what_was_refused(datafile, tmp_path, capsys, case):
    """The DPM prior (``-f 1``; ignored by the tetraploid engine, as in
    JAX) and ``--marginalize-g`` run to the report, whose section headers
    are the JAX command's for the same flags."""
    flags = RUNS_NOW[case]
    if "-p" in flags:
        from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
        write_panel(synthetic_tetra_panel(8, 6, n_pops=2, seed=1),
                    str(datafile), data_fmt=1)
        flags = flags + ["-af", "1"]
    args = ["-d", str(datafile), "-u", "30", "-b", "10", "-t", "2", "-c",
            "2", "-r", "5", "-j", "5", "-K", "2", "--platform", "cpu"] + flags
    out, jout = tmp_path / "out.txt", tmp_path / "jout.txt"
    assert main(args + ["-o", str(out)]) == 0
    assert "SUCCESSFULLY FINISHED" in capsys.readouterr().out
    text = out.read_text()
    if case == "dpm prior":
        assert "Dirichlet" in text
    if "-p" not in flags:
        assert j_main(args + ["-o", str(jout)]) == 0
        assert headers(text) == headers(jout.read_text())


def test_cli_never_falls_back_to_the_cpu(datafile, tmp_path):
    """The default platform is the card; without one the run fails."""
    assert build_parser().parse_args(["-d", "x", "-o", "y"]).platform == \
        "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    with pytest.raises(SystemExit) as e:
        main(["-d", str(datafile), "-o", str(tmp_path / "o.txt")])
    assert "--platform cpu" in str(e.value.code)
    assert not (tmp_path / "o.txt").exists()


def test_seed_folding_matches_jax():
    for seeds in ([1, 2, 3], [0, 0, 0], [123456, 7, 99999]):
        s1, s2, s3 = seeds
        assert run_seed(seeds) == ((s1 * 1_000_003 + s2) * 1_000_003
                                   + s3) % (2 ** 63)
    assert run_seed(None) == 13_04_1972
    assert run_seed([10 ** 12, 10 ** 12, 10 ** 12]) < 2 ** 63


def test_parser_has_every_jax_flag_and_default():
    from instruct_tpu.cli import build_parser as j_build_parser
    mine = {a.dest: a for a in build_parser()._actions}
    theirs = {a.dest: a for a in j_build_parser()._actions}
    assert set(mine) == set(theirs)
    for dest, a in theirs.items():
        assert mine[dest].option_strings == a.option_strings, dest
        if dest != "platform":          # the JAX default lets JAX choose
            assert mine[dest].default == a.default, dest
            assert mine[dest].choices == a.choices, dest


def test_profile_dir_writes_a_trace(datafile, tmp_path):
    prof = tmp_path / "prof"
    rc = main(["-d", str(datafile), "-o", str(tmp_path / "o.txt"), "-v",
               "1", "-u", "20", "-b", "10", "-t", "2", "-c", "1", "-r",
               "5", "-j", "5", "-g", "0", "-pi", "0", "--platform", "cpu",
               "--profile-dir", str(prof)])
    assert rc == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_python_dash_m_entry_point(datafile, tmp_path):
    """``python -m instruct_tpu_torch`` runs the CLI in its own process."""
    out = tmp_path / "o.txt"
    r = subprocess.run(
        [sys.executable, "-m", "instruct_tpu_torch", "-d", str(datafile),
         "-o", str(out), "-v", "2", "-K", "2", "-u", "20", "-b", "10", "-t",
         "2", "-c", "1", "-r", "5", "-j", "5", "-g", "0", "--platform",
         "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.rstrip().endswith("THE JOB IS SUCCESSFULLY FINISHED")
    assert "Inferred ancestry" in out.read_text()
    r = subprocess.run(
        [sys.executable, "-m", "instruct_tpu_torch", "-d", str(datafile),
         "-o", str(out), "--chain-shards", "2"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    # a 2-rank chain axis in a world of one process
    assert r.returncode == 2 and "world size is 1" in r.stderr


def test_python_dash_m_sampler_nuts_defaults_to_the_card(datafile,
                                                         tmp_path):
    """``python -m instruct_tpu_torch --sampler nuts`` in its own process:
    the flag is taken (not refused), the run defaults to the card, and
    without one it fails instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    out = tmp_path / "o.txt"
    r = subprocess.run(
        [sys.executable, "-m", "instruct_tpu_torch", "-d", str(datafile),
         "-o", str(out), "-v", "2", "-u", "30", "-b", "10", "-t", "2",
         "-r", "5", "-j", "5", "--sampler", "nuts"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 1, r.stderr[-2000:]
    assert "still to be ported" not in r.stderr
    assert "--platform cuda, but torch sees no CUDA device" in r.stderr
    assert not out.exists()


def test_no_module_of_the_port_imports_jax():
    """Every module of the package (the new ones included) and
    ``chip_smoke.py``: no import statement names ``jax`` or the JAX
    package."""
    bad_import = re.compile(
        r"^\s*(import|from)\s+(jax|instruct_tpu)(\.|\s|,|$)", re.M)
    files = sorted((REPO / "instruct_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert any(f.name == "cli.py" for f in files)
    for f in files:
        hits = bad_import.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"
