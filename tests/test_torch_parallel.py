"""The port's chain and loci sharding over ``torch.distributed``, in gloo
worlds of 2 and 4 CPU processes (``tests/_torch_world.py``; each world is
killed at its time limit):

* one sweep of a loci-sharded (1, 2) mesh, fed the unsharded sweep's
  draws (each rank its loci's part of the site draws, the replicated draws
  whole), gives the unsharded sweep's z, counts and G exactly and its Q,
  rates and log-lik within 1e-5, with the predicted all-reduces -- in modes
  0-5 on the fused and the unfused sweep and in the tetraploid engine, auto
  and allo; the replicated state is bitwise equal on both ranks;
* chain-sharded (2, 1) and (4, 1) runs are bitwise the unsharded run, as
  ``tests/test_sharding.py`` checks for the JAX package;
* a world of one is bitwise the unsharded run;
* a (1, 2) run resumes from its checkpoints bitwise, and a resume under
  another mesh is refused;
* ``infer_k`` on a (1, 2) mesh takes the per-K loop, on (2, 1) the grid.
"""

import numpy as np
import pytest
import torch

from _torch_world import run_world
from instruct_tpu_torch import ModelSpec, Schedule, run_mcmc
from instruct_tpu_torch import synthetic_panel
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import (StepDraws, build_step_parts,
                                          use_fused)
from instruct_tpu_torch.parallel import loci_shard as ls
from instruct_tpu_torch.parallel import make_mesh
from instruct_tpu_torch.tetra import engine as te


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_fields(obj):
    return {name: None if v is None else v.numpy()
            for name, v in obj._asdict().items()}


def _diploid_panel(n=9, l=13, seed=5):
    return synthetic_panel(n, l, n_pops=2, missing_rate=0.05,
                           selfing_rates=np.array([0.2, 0.7]), seed=seed)


def _tetra_panel(autopoly, n=10, l=13, seed=4):
    return synthetic_tetra_panel(n, l, n_pops=2, n_alleles=3,
                                 autopoly=autopoly, missing_rate=0.1,
                                 selfing_rates=np.array([0.3, 0.8]),
                                 seed=seed)


# ---------------------------------------------------------------------------
# (a) one sweep, exactly
# ---------------------------------------------------------------------------

# (name, spec, the all-reduces one sweep and its log-lik make)
SWEEPS = [(f"{'fused' if fused else 'unfused'} mode {m}",
           ModelSpec(mode=m, n_pops=2, use_pallas=None if fused else False),
           # pop counts, the G / F log-ratio (modes 2-5), the log-lik;
           # unfused mode 0: the [N, K] log-liks of the z draw and of the
           # log-lik
           2 + int(m >= 2))
          for fused in (True, False) for m in range(6)
          if fused is False or m > 0]
SWEEPS += [(f"tetra {'auto' if auto else 'allo'}",
            ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=auto), 3)
           for auto in (True, False)]


def _sweep_draws(spec, data, c, rng):
    """Uniforms for every draw of one sweep, in ``StepDraws``' layouts."""
    n, l, k, a = data.n_indv, data.n_loci, spec.n_pops, data.max_alleles
    nd = dk.n_test_draws()

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    d = dict(p=unif(c, nd, k * a, l))
    if spec.mode == 0:
        d["zz"] = unif(c, n)
        return d
    d.update(z=unif(c, n, data.ploid * l), q=unif(c, nd, k, n),
             alpha=(rng.standard_normal(c).astype(np.float32), unif(c)))
    if spec.ploid == 4:
        d["s"] = (unif(c, 1, k), unif(c, 1, k))
        n_cand = te.build_tables(spec, data).n_cand
        d["geno"] = -np.log(-np.log(unif(c, n_cand, n, l)))
        if not spec.autopoly:
            d["p2"] = unif(c, nd, k * a, l)
    elif spec.mode in (2, 3):
        r = spec.n_rates(n)
        d["s"] = (unif(c, r), unif(c, r), unif(c, n), unif(c, n))
    elif spec.mode in (4, 5):
        r = spec.n_rates(n)
        d["s"] = (unif(c, r), unif(c, r))
    return d


def _torch_draws(d):
    return StepDraws(**{k: tuple(torch.as_tensor(x) for x in v)
                        if isinstance(v, tuple) else torch.as_tensor(v)
                        for k, v in d.items()})


@pytest.fixture(scope="module")
def sweep_world():
    """The unsharded sweep of every case, and the (1, 2) world's."""
    rng = np.random.default_rng(11)
    cases, want = [], []
    for name, spec, _ in SWEEPS:
        panel = (_tetra_panel(spec.autopoly) if spec.ploid == 4
                 else _diploid_panel())
        data, c = panel.data, 2
        state = init_state(3, spec, data, c, device="cpu")
        draws = _sweep_draws(spec, data, c, rng)
        step, add_ll = build_step_parts(spec, data)
        want.append(add_ll(step(state, px.make_keys(0, c, "cpu"), 0,
                                _torch_draws(draws))))
        cases.append(dict(data=_np_fields(data), state=_np_fields(state),
                          draws=draws, spec=spec))
    outs = run_world("sweep_cases", 2, (cases, (1, 2)), timeout=150)
    return cases, want, outs


@pytest.mark.parametrize("case", range(len(SWEEPS)),
                         ids=[s[0] for s in SWEEPS])
def test_one_loci_sharded_sweep_is_the_unsharded_sweep(sweep_world, case):
    cases, want, outs = sweep_world
    name, spec, n_reduces = SWEEPS[case]
    w = want[case]
    data = _diploid_panel().data if spec.ploid == 2 else \
        _tetra_panel(spec.autopoly).data
    assert use_fused(spec, data) == (spec.use_pallas is not False)
    src = ls.loci_plan(data, 2)
    ranks = [o[case] for o in outs]
    got = {f: [torch.as_tensor(r["state"][f]) for r in ranks]
           for f in ("z", "zcounts", "freq", "geno", "zz")
           if ranks[0]["state"][f] is not None}
    if w.z.numel():
        z = ls.gather_sites(got["z"], src, data.ploid)
        assert torch.equal(z, w.z), name
    if w.zcounts is not None:
        assert torch.equal(ls.gather_loci(got["zcounts"], src, 2),
                           w.zcounts), name
    assert torch.equal(ls.gather_loci(got["freq"], src, 2), w.freq), name
    if w.geno is not None:
        assert torch.equal(ls.gather_sites(got["geno"], src, 4), w.geno)
    r0 = ranks[0]["state"]
    assert np.array_equal(r0["gen"], w.gen.numpy()), name
    assert np.array_equal(r0["zz"], w.zz.numpy()), name
    for f in ("q", "rates", "loglik_indv", "loglik_total", "alpha"):
        np.testing.assert_allclose(r0[f], getattr(w, f).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name}: {f}")
    # the replicated state is bitwise equal on both ranks
    for f in ("q", "alpha", "rates", "ais_state", "gen", "zz",
              "loglik_indv", "loglik_total", "prior_mu", "prior_sigma2"):
        assert np.array_equal(r0[f], ranks[1]["state"][f]), f"{name}: {f}"
    for r in ranks:
        assert r["stats"]["all_reduces"] == n_reduces, (name, r["stats"])


# ---------------------------------------------------------------------------
# (b) chain-sharded runs, (f) a world of one: bitwise the unsharded run
# ---------------------------------------------------------------------------

def _assert_same_result(got, ref, what):
    """Every field of the final state and the accumulators, and the
    plug-in log-lik, bitwise."""
    for name, v in ref.final_state._asdict().items():
        g = got["state"][name]
        if v is None:
            assert g is None, (what, name)
            continue
        assert np.array_equal(g, v.numpy()), (what, name)
    acc = ref.accum._asdict()
    for name, v in acc.items():
        if name in ("mean", "mean_sq"):
            for f, x in v._asdict().items():
                assert np.array_equal(got["accum"][name][f], x.numpy()), \
                    (what, name, f)
        else:
            assert np.array_equal(got["accum"][name], v.numpy()), \
                (what, name)
    assert np.array_equal(got["plugin_ll"], ref.plugin_ll), what
    assert got["n_retries"] == ref.n_retries


CHAIN_SPECS = {"mode 2": ModelSpec(mode=2, n_pops=2),
               "tetra allo": ModelSpec(mode=2, ploid=4, n_pops=2,
                                       autopoly=False)}


@pytest.mark.parametrize("n_shards", [2, 4])
def test_chain_sharded_runs_are_the_unsharded_run(n_shards):
    sched = Schedule(n_iter=24, burnin=8, thinning=2, n_chains=8, ckrep=4,
                     nstep_check_empty_cluster=2)
    for what, spec in CHAIN_SPECS.items():
        panel = (_tetra_panel(False) if spec.ploid == 4
                 else _diploid_panel(10, 12, seed=4))
        ref = run_mcmc(panel.data, spec, sched, 7, device="cpu",
                       track_freq=True)
        outs = run_world("run_case", n_shards,
                         (_np_fields(panel.data), spec, sched, 7,
                          (n_shards, 1), dict(track_freq=True)),
                         timeout=120)
        for r, got in enumerate(outs):
            _assert_same_result(got, ref, f"{what}, rank {r}")
            assert not got["stats"]


@pytest.mark.parametrize("what", ["mode 0", "mode 3 -f 1", "mode 5",
                                  "tetra auto"])
def test_a_world_of_one_is_the_unsharded_run(what):
    from instruct_tpu_torch.config import PriorFamily, Priors
    spec = {"mode 0": ModelSpec(mode=0, n_pops=2),
            "mode 3 -f 1": ModelSpec(mode=3, n_pops=2, priors=Priors(
                family=PriorFamily.DPM)),
            "mode 5": ModelSpec(mode=5, n_pops=2, use_pallas=False),
            "tetra auto": ModelSpec(mode=2, ploid=4, n_pops=2)}[what]
    panel = _tetra_panel(True) if spec.ploid == 4 else _diploid_panel()
    sched = Schedule(n_iter=16, burnin=6, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    ref = run_mcmc(panel.data, spec, sched, 9, device="cpu",
                   track_freq=True)
    mesh = make_mesh(1, 1, device="cpu")
    got = run_mcmc(panel.data, spec, sched, 9, track_freq=True, mesh=mesh)
    from _torch_world import result_fields
    _assert_same_result(result_fields(got), ref, what)
    assert not mesh.stats


def test_mesh_refusals():
    panel = _diploid_panel()
    sched = Schedule(n_iter=4, burnin=2, thinning=1, n_chains=3, ckrep=2,
                     nstep_check_empty_cluster=2)
    spec = ModelSpec(mode=2, n_pops=2)
    with pytest.raises(ValueError, match="gspmd"):
        run_mcmc(panel.data, spec, sched, 1, device="cpu",
                 mesh_mode="gspmd")
    mesh = make_mesh(1, 1, device="cpu")
    mesh.n_chain_shards = 2          # a chain axis that 3 chains miss
    with pytest.raises(ValueError, match="do not split"):
        run_mcmc(panel.data, spec, sched, 1, mesh=mesh)
    mesh.n_chain_shards, mesh.n_data_shards = 1, 2
    with pytest.raises(ValueError, match="active_pops"):
        run_mcmc(panel.data, spec, sched, 1, mesh=mesh,
                 active_pops=np.ones((3, 2), np.float32))


# ---------------------------------------------------------------------------
# (e) checkpoints, (g) K selection
# ---------------------------------------------------------------------------

def test_loci_sharded_resume_is_bitwise(tmp_path):
    panel = _diploid_panel(8, 12, seed=6)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=20, burnin=6, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    outs = run_world("checkpoint_case", 2,
                     (_np_fields(panel.data), spec, sched, 5, (1, 2),
                      str(tmp_path / "ck"), (2, 1)), timeout=120)
    for r, o in enumerate(outs):
        for part in ("state", "accum"):
            ref, got = o["ref"][part], o["got"][part]
            for name, v in ref.items():
                if isinstance(v, dict):
                    for f, x in v.items():
                        assert np.array_equal(got[name][f], x), (r, name, f)
                elif v is not None:
                    assert np.array_equal(got[name], v), (r, name)
        assert o["refused"] and "1x2 mesh" in o["refused"], o["refused"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["rank_0", "rank_1"]


@pytest.mark.parametrize("shape, grid", [((1, 2), False), ((2, 1), True)])
def test_infer_k_on_a_mesh(shape, grid):
    """A loci-sharded mesh runs K selection as the per-K loop (the K
    grid's mask does not combine with loci sharding); a chain mesh runs
    the one padded grid, its replicas split over the chain axis."""
    panel = synthetic_panel(24, 30, n_pops=2,
                            selfing_rates=np.array([0.15, 0.75]), seed=13)
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(n_iter=40, burnin=20, thinning=2, n_chains=2, ckrep=5,
                     nstep_check_empty_cluster=5)
    outs = run_world("kselect_case", 2,
                     (_np_fields(panel.data), spec, sched, 1, shape,
                      (1, 3)), timeout=120)
    for o in outs:
        assert o["calls"] == ([True] if grid else [False] * 3)
        assert o["best_k"] == outs[0]["best_k"]
        for k, w in o["waic"].items():
            assert np.array_equal(w, outs[0]["waic"][k])
    if grid:
        from instruct_tpu_torch.kselect import infer_k
        ref = infer_k(panel.data, spec, sched, 1, 1, 3, device="cpu")
        for k, w in ref.waic.items():
            assert np.array_equal(outs[0]["waic"][k], w)
