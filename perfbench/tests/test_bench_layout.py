"""BENCHMARK.json against the contract's form, and the harness's files
found by the names in it."""

import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = run.load_cell(cell)
    assert spec["cfg"]["name"] == spec["cell"]["config"]
    assert spec["mix"]["entry"] in ("run_mcmc", "infer_k")
    assert set(spec["limits"]) >= {"exact_off", "z_flip_ulps", "init_bad"}
    conf = {c["name"]: c for c in BENCH["configs"]}[spec["cell"]["config"]]
    assert conf["reduced"] == spec["cfg"]["reduced"]
    for key in ("n_indv", "n_loci", "ploid", "n_alleles"):
        if key not in conf["reduced"]:
            assert spec["cfg"][key] == spec["cfg"]["published"][key]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    reader = importlib.import_module(f"perfbench.metrics.{metric}")
    assert callable(reader.read)
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
