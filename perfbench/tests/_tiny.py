"""A cell at a size the CPU holds: the mixes' own settings on a 40 x 300
panel, 32 sweeps a job (11 stored steps, the last refreshing the
marginal log-lik)."""

import json
import time
from pathlib import Path

import torch

from perfbench import run

HERE = Path(__file__).resolve().parents[1]


def tiny_spec(mode: int, workload: str) -> dict:
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    mix.update(mode=mode, n_pops=3, n_iter=32, burnin=10, thinning=2)
    rates = [0.2, 0.6, 0.9] if mode == 2 else [0.0, 0.0, 0.0]
    cfg = {"n_indv": 40, "n_loci": 300,
           "assumed": {"n_pops": 3, "selfing_rates": rates,
                       "admixture_alpha": 0.1, "missing_rate": 0.02,
                       "gen_cap": 50}}
    return dict(cell=cell, cfg=cfg, mix=mix,
                limits=json.loads((HERE / "limits" / f"{workload}.json")
                                  .read_text()),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def tiny_run(mode: int, workload: str, seed: int = 2 ** 31 + 77,
             traced: bool = False) -> dict:
    return run.run_cell(tiny_spec(mode, workload), seed, 0.05, traced,
                        torch.device("cpu"), time.perf_counter())


def tiny_grid_spec() -> dict:
    """K selection over K = 1..4, 2 chains a K, 4 of the 8 replicas
    replayed (the mix of a cell the port cannot run at its published size
    yet: ``PERF.md``), held to the RegMap cell's limits."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    mix = json.loads((HERE / "traffic" / "kgrid_k1_10.json").read_text())
    mix.update(k_range=[1, 4], n_pops=4, n_iter=32, burnin=10, thinning=2)
    cfg = {"n_indv": 40, "n_loci": 300,
           "assumed": {"n_pops": 2, "selfing_rates": [0.2, 0.9],
                       "admixture_alpha": 0.1, "missing_rate": 0.02,
                       "gen_cap": 50}}
    limits = json.loads((HERE / "limits" / "regmap.mode2.json").read_text())
    limits.update(waic_gap=1e-5, pick_off=0)
    return dict(cell={"chips": 1}, cfg=cfg, mix=mix, limits=limits,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
