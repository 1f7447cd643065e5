"""The check at a size the CPU holds: the reference agrees with jobs of the
port's entries, and ``correct`` comes out false under the control and
under each fault the cells can have, with the timed path broken
underneath and the rest of a run driven as on the card."""

import json
import math
import time

import pytest
import torch

from instruct_tpu_torch.data.dataset import packed_dataset
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.mcmc import driver
from perfbench import check, jobs, panel, run
from perfbench.reference import sweep as ref
from perfbench.tests._tiny import tiny_grid_spec, tiny_run, tiny_spec

CELLS = [(2, "regmap.mode2"), (1, "hgdp.mode1")]
F64 = torch.float64


@pytest.mark.parametrize("mode,cell", CELLS)
def test_reference_agrees(mode, cell):
    res = tiny_run(mode, cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["z_flip_ulps"]["value"] == 0.0
    assert res["checks"]["init_bad"]["value"] == 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"chain_steps_per_s", "peak_device_gib",
                                   "setup_s"}


def test_kgrid_reference_agrees_and_control_fails():
    """K selection's grid: the replayed replicas, each K's WAIC and the
    pick."""
    spec = tiny_grid_spec()
    res = run.run_cell(spec, 2 ** 31 + 99, 0.05, False, torch.device("cpu"),
                       0.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["pick_off"]["value"] == 0
    dev = torch.device("cpu")
    bits2 = panel.make_panel(spec["cfg"], 7, dev)
    runner = jobs.Runner(spec["mix"], packed_dataset(bits2))
    picked = run.picked_of(runner.run(jobs.job_seed(7, 1)))
    ctrl = run.check_numbers(runner, bits2, picked, jobs.job_seed(7, 1),
                             control=True)
    ctrl["init_bad"] = 0
    assert not run.judge(ctrl, spec["limits"])[0]


@pytest.mark.parametrize("mode,cell", CELLS)
def test_control_fails(mode, cell):
    """The reference in bfloat16 in the program's place."""
    spec = tiny_spec(mode, cell)
    dev = torch.device("cpu")
    bits2 = panel.make_panel(spec["cfg"], 11, dev)
    runner = jobs.Runner(spec["mix"], packed_dataset(bits2))
    runner.run(jobs.job_seed(11, 1))
    numbers = run.check_numbers(runner, bits2, None, jobs.job_seed(11, 1),
                                control=True)
    numbers["init_bad"] = 0
    correct, checks = run.judge(numbers, spec["limits"])
    assert not correct
    over = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert {"z_flip_ulps", "p_flip_ulps", "q_flip_ulps"} <= set(over)


def _break_last_step(monkeypatch, n_iter, fault):
    build = driver.build_step_parts

    def broken(spec, data, *a, **kw):
        core, add_ll = build(spec, data, *a, **kw)

        def step(state, keys, i, draws=None):
            if i != n_iter - 1:
                return core(state, keys, i, draws)
            return fault(state, core(state, keys, i, draws))

        return step, add_ll

    monkeypatch.setattr(driver, "build_step_parts", broken)


def _unchanged(old, new):
    return old


def _half_left_out(old, new):
    n = old.z.shape[1] // 2
    return new._replace(z=torch.cat([old.z[:, :n], new.z[:, n:]], dim=1),
                        q=torch.cat([old.q[:, :n], new.q[:, n:]], dim=1))


@pytest.mark.parametrize("mode,cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out],
                         ids=["state_unchanged", "half_left_out"])
def test_fault_fails(monkeypatch, mode, cell, fault):
    _break_last_step(monkeypatch, tiny_spec(mode, cell)["mix"]["n_iter"],
                     fault)
    res = tiny_run(mode, cell)
    assert not res["correct"]
    assert res["checks"]["z_flip_ulps"]["value"] > 1e4


def _alter_answer(monkeypatch, mode):
    """One ancestry changed where the site pass produces it."""
    name = "zq_gendiff_pass" if mode == 2 else "zq_sample_pass"
    orig = getattr(fs, name)

    def altered(*a, **kw):
        out = list(orig(*a, **kw))
        z = out[0].clone()
        z[0, 0, 0] = (z[0, 0, 0] + 1) % 3
        out[0] = z
        return tuple(out)

    monkeypatch.setattr(fs, name, altered)


@pytest.mark.parametrize("mode,cell", CELLS)
def test_answer_altered_fails(monkeypatch, mode, cell):
    _alter_answer(monkeypatch, mode)
    res = tiny_run(mode, cell)
    assert not res["correct"]
    assert res["checks"]["exact_off"]["value"] >= 1


@pytest.mark.parametrize("shape", [(4000, 8, 4e5), (4000, 2, 2e3),
                                   (4000, 7, 1.2e6)],
                         ids=["q_regmap", "p_rows", "q_hgdp"])
def test_float32_flips_are_explained(shape):
    """Dirichlet rows drawn by the reference in float32 (the program's
    precision) at the cells' concentrations differ from float64 only by
    accept tests within an ulp of their boundary; an altered cell or
    bfloat16 is explained by none."""
    n, k, big = shape
    g = torch.Generator().manual_seed(n + k)
    conc = torch.rand(n, k, dtype=F64, generator=g) * big + 0.05
    var, alts, costs = ref.dirichlet_q(3, 1, 7, conc, None, F64, True)
    q32 = ref.dirichlet_q(3, 1, 7, conc, None, torch.float32)
    assert 0.0 <= check.row_flip_ulps(q32, var, alts, costs) < 4.0
    act = torch.ones(k, dtype=F64)
    act[-1] = 0
    qa = ref.dirichlet_q(3, 1, 7, conc, act, torch.float32)
    assert check.row_flip_ulps(qa, var, alts, costs, act) < 4.0
    bf = ref.dirichlet_q(3, 1, 7, conc, None, torch.bfloat16)
    assert check.row_flip_ulps(bf, var, alts, costs) == math.inf
    bad = ref.normalize(var).clone()
    bad[n // 2, 0] *= 1.001
    assert check.row_flip_ulps(bad, var, alts, costs) == math.inf


def test_float32_ancestry_flips_are_explained():
    g = torch.Generator().manual_seed(3)
    b, l, k = 32, 20000, 8
    q = torch.rand(b, k, dtype=F64, generator=g) ** 4
    q = q / q.sum(-1, keepdim=True)
    w = torch.rand(k, b, l, dtype=F64, generator=g)
    u = torch.rand(b, l, dtype=F64, generator=g)
    z32 = ref.z_draw(q.float(), w.float(), u.float())
    z, gap = ref.z_draw(q, w, u, z32)
    assert gap < 4.0
    assert ref.z_draw(q, w, u, z)[1] == 0.0
    bf = ref.z_draw(q.bfloat16(), w.bfloat16(), u.bfloat16())
    assert ref.z_draw(q, w, u, bf)[1] > 1e3
    bad = z.clone()
    bad[0, 0] = (bad[0, 0] + 1) % k
    assert ref.z_draw(q, w, u, bad)[1] > 1e3


@pytest.mark.parametrize("mode,cell", CELLS)
@pytest.mark.parametrize("fault", ["not_the_same", "counts_wrong"])
def test_initial_state_fault_fails(monkeypatch, mode, cell, fault):
    """``init_bad`` judges the initial state that the timed job ran from:
    one that the job drew otherwise than the check's second call (Q's
    columns reversed, still on the simplex), or one whose carried counts
    are wrong on every call, fails."""
    orig = jobs.INIT_STATE

    def broken(*a, **kw):
        st = orig(*a, **kw)
        if fault == "counts_wrong":
            return st._replace(zcounts=st.zcounts + 1)
        # within a job the driver's call goes through the tap
        in_job = driver.init_state is not orig
        return st._replace(q=st.q.flip(-1)) if in_job else st

    monkeypatch.setattr(jobs, "INIT_STATE", broken)
    res = tiny_run(mode, cell)
    assert not res["correct"]
    assert res["checks"]["init_bad"]["value"] >= 1
    assert driver.init_state is orig


CARD_CASES = ["sound", "control", "state_unchanged", "half_left_out",
              "answer_altered"]


@pytest.mark.card
@pytest.mark.parametrize("mode,cell", CELLS)
@pytest.mark.parametrize("case", CARD_CASES)
def test_faults_fail_on_the_card(monkeypatch, mode, cell, case):
    """On the card at the cell's widths (every locus, the cell's K; a
    panel of 64 individuals): a sound run is correct, and the control and
    each fault, planted in the timed path's kernels' outputs, are not.
    Each run's numbers are printed as one JSON line."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    spec = run.load_cell(cell)
    spec["cfg"] = dict(spec["cfg"], n_indv=64)
    if case == "state_unchanged":
        _break_last_step(monkeypatch, spec["mix"]["n_iter"], _unchanged)
    elif case == "half_left_out":
        _break_last_step(monkeypatch, spec["mix"]["n_iter"], _half_left_out)
    elif case == "answer_altered":
        _alter_answer(monkeypatch, mode)
    seed = 2 ** 32 + 1000 * mode + CARD_CASES.index(case)
    res = run.run_cell(spec, seed, 0.1, False, torch.device("cuda", 0),
                       time.perf_counter())
    numbers = {k: c["value"] for k, c in res["checks"].items()}
    if case == "control":
        bits2 = panel.make_panel(spec["cfg"], seed, torch.device("cuda", 0))
        runner = jobs.Runner(spec["mix"], packed_dataset(bits2))
        runner.run(jobs.job_seed(seed, 1))
        numbers = run.check_numbers(runner, bits2, None,
                                    jobs.job_seed(seed, 1), control=True)
        numbers["init_bad"] = 0
        res["correct"] = run.judge(numbers, spec["limits"])[0]
    print(json.dumps({"card_reading": cell, "case": case, "seed": seed,
                      "correct": res["correct"], "numbers": numbers}))
    assert res["correct"] == (case == "sound"), numbers
