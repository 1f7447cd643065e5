"""The port's command line on the CPU (``--platform cpu``): the flows of
``tests/test_cli.py`` exit 0 and write reports with the JAX CLI's section
headers in the JAX CLI's order on the same file (the numbers differ by
design: the port draws Philox); every flag that is not ported yet exits 2
naming its ROADMAP item; without a card the default platform fails instead
of moving to the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

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
    "sampler hmc": (["--sampler", "hmc"], "Samplers (M10)"),
    "sampler nuts": (["--sampler", "nuts"], "Samplers (M10)"),
    "sampler svi": (["--sampler", "svi"], "Samplers (M10)"),
    "sampler smc": (["--sampler", "smc"], "Samplers (M10)"),
    "chain shards": (["--chain-shards", "2"], "Parallel (M9)"),
    "data shards": (["--data-shards", "2"], "Parallel (M9)"),
    "mesh mode shard_map": (["--mesh-mode", "shard_map"], "Parallel (M9)"),
    "mesh mode gspmd": (["--mesh-mode", "gspmd"], "Parallel (M9)"),
    "coordinator": (["--coordinator", "localhost:1234"], "Parallel (M9)"),
    "num processes": (["--num-processes", "2"], "Parallel (M9)"),
    "process id": (["--process-id", "0"], "Parallel (M9)"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cli_refuses_what_is_not_ported(datafile, tmp_path, capsys, case):
    flags, item = REFUSED[case]
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
    assert f"(ROADMAP: {item})" in err
    assert not out.exists()


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
         "-o", str(out), "--sampler", "nuts"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 2 and "ROADMAP: Samplers (M10)" in r.stderr


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
