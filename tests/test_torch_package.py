"""The port as a package: what it imports, what it refuses, its random
number generator against an independent one, conversion, and the run loop's
bookkeeping (retry, determinism, defaults)."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import instruct_tpu_torch as itt
from instruct_tpu_torch import (ModelSpec, Priors, RunResult, Schedule,
                                run_mcmc, synthetic_panel)
from instruct_tpu_torch import convert
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import accumulators, driver, updates
from instruct_tpu_torch.mcmc import step as step_mod
from instruct_tpu_torch.mcmc.state import init_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(30, 40, n_pops=2, n_alleles=2,
                           selfing_rates=np.array([0.1, 0.8]), seed=4)


SCHED = dict(n_iter=60, burnin=30, thinning=3, n_chains=2, ckrep=5,
             nstep_check_empty_cluster=5, dic_every=2)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, instruct_tpu_torch, instruct_tpu_torch.convert, "
            "instruct_tpu_torch.diagnostics, "
            "instruct_tpu_torch.kernels.fused_step, instruct_tpu_torch.cli, "
            "instruct_tpu_torch.report, instruct_tpu_torch.checkpoint, "
            "instruct_tpu_torch.memory, instruct_tpu_torch.data.loader, "
            "instruct_tpu_torch.native, instruct_tpu_torch.mcmc.dpm, "
            "instruct_tpu_torch.mcmc.marg_g, instruct_tpu_torch.kernels.crp; "
            "from instruct_tpu_torch.cli import main; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'instruct_tpu' or "
            "m.startswith('instruct_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_exports_and_defaults():
    assert set(itt.__all__) == {"ModelSpec", "Schedule", "Priors", "Dataset",
                                "Panel", "synthetic_panel", "run_mcmc",
                                "RunResult", "infer_k", "KSelectResult",
                                "read_data", "write_panel", "write_report",
                                "__version__"}
    for fn in (run_mcmc, init_state, itt.infer_k):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # importing the package builds nothing and loads no library
    assert _build._lib is None
    # without a CUDA toolkit the build is refused loudly, never skipped
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
    else:
        assert os.path.isfile(nvcc)


@pytest.mark.parametrize("kwargs,what", [
    (dict(mode=3, marginalize_g=True), "marginalize_g"),
    (dict(mode=5, priors=Priors(family=PriorFamily.DPM)), "dpm prior"),
    (dict(mode=2, ploid=4, priors=Priors(family=PriorFamily.DPM)),
     "dpm prior"),
    (dict(mode=2, marginalize_g=True), "marginalize_g"),
    (dict(mode=2, priors=Priors(family=PriorFamily.DPM)), "dpm prior"),
])
def test_outside_the_slice_raises_not_implemented(panel, kwargs, what):
    """What lay outside the port's slices -- ``marginalize_g`` and the DPM
    prior -- is ported: no spec raises ``NotImplementedError`` any more.
    Each runs, and where the JAX package ignores the DPM prior (modes 0-2,
    4, ploidy 4) the port does too."""
    spec = ModelSpec(**{"n_pops": 2, **kwargs})
    data = panel.data
    if spec.ploid == 4:
        from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
        data = synthetic_tetra_panel(12, 10, n_pops=2, seed=2).data
    sched = Schedule(**SCHED)
    res = run_mcmc(data, spec, sched, 0, device="cpu")
    assert torch.isfinite(res.final_state.loglik_total).all()
    step_mod.build_step_parts(spec, data)
    used = res.final_state.dpm_counts.shape[1] > 0
    assert used == (what == "dpm prior" and spec.mode == 5
                    and spec.ploid == 2)


@pytest.mark.parametrize("kwargs,fused", [
    (dict(mode=0), False),
    (dict(mode=3, priors=Priors(family=PriorFamily.NORMAL)), True),
    (dict(mode=4, back_refl=0), True),
    (dict(mode=2, back_refl=0), True),
    (dict(mode=2, use_pallas=False), False),
    (dict(mode=2, priors=Priors(family=PriorFamily.NORMAL)), True),
    (dict(mode=2, n_pops=9), True),
    (dict(mode=2, n_pops=33), False),
])
def test_wider_specs_build_their_step_and_take_a_sweep(panel, kwargs, fused):
    """Mode 0, the normal prior, ``back_refl=0``, ``use_pallas=False`` and
    K > 8 build their step, route to the sweep that runs them (the fused
    one while K * A <= 64, the JAX gate) and take a sweep from Philox,
    twice alike."""
    spec = ModelSpec(**{"n_pops": 2, **kwargs})
    step_mod.check_supported(spec, panel.data)
    assert step_mod.use_fused(spec, panel.data) == fused
    step = step_mod.build_step(spec, panel.data)
    state = init_state(2, spec, panel.data, n_chains=2, device="cpu")
    keys = px.make_keys(2, 2, "cpu")
    new, again = step(state, keys, 0), step(state, keys, 0)
    assert torch.isfinite(new.loglik_total).all()
    assert new.loglik_indv.shape == (2, panel.n_indv)
    for x, y in zip(new, again):
        assert (x is None and y is None) or torch.equal(x, y)
    moved = new.zz if spec.mode == 0 else new.z
    assert not torch.equal(moved, state.zz if spec.mode == 0 else state.z)
    # the normal prior moves its hyperparameters only where it applies
    normal = (spec.priors.family == PriorFamily.NORMAL
              and spec.mode in (3, 5))
    assert torch.equal(new.prior_mu, state.prior_mu) != normal


def test_multiallelic_panel_raises_not_implemented():
    """A multi-allelic panel runs the fused sweep (the generic site path) as
    long as n_pops * max_alleles <= 64 and the unfused sweep beyond; only an
    unknown mode raises."""
    p3 = synthetic_panel(12, 15, n_pops=2, n_alleles=3, seed=1)
    assert p3.data.bits2 is None
    spec = ModelSpec(mode=2, n_pops=2)
    assert step_mod.use_fused(spec, p3.data)
    res = run_mcmc(p3.data, spec, Schedule(**SCHED), 0, device="cpu")
    assert torch.isfinite(res.accum.mean.total_ll).all()
    p9 = synthetic_panel(12, 15, n_pops=2, n_alleles=9, seed=1)
    wide = ModelSpec(mode=2, n_pops=8)
    assert not step_mod.use_fused(wide, p9.data)
    res = run_mcmc(p9.data, wide, Schedule(**SCHED), 0, device="cpu")
    assert torch.isfinite(res.accum.mean.total_ll).all()
    assert res.final_state.freq.shape == (2, 8, 15, 9)
    with pytest.raises(ValueError, match="unknown mode"):
        step_mod.check_supported(ModelSpec(mode=7), p3.data)


# ---------------------------------------------------------------------------
# Philox4x32-10 against an independent pure-Python-integer implementation
# ---------------------------------------------------------------------------

def _philox_python(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & 0xFFFFFFFF,
                          (p0 >> 32) ^ c3 ^ k1, p0 & 0xFFFFFFFF)
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c0, c1, c2, c3


def test_philox_matches_pure_python_integers():
    # the known-answer vectors of the Random123 distribution
    assert _philox_python((0, 0, 0, 0), (0, 0)) == (
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    assert _philox_python((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == (
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)
    rng = np.random.default_rng(0)
    n = 300
    ctr = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64)
    ctr[0], ctr[1] = 0, 0xFFFFFFFF
    for k0, k1 in ((0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0xA4093822,
                                                       0x299F31D0)):
        got = torch.stack(px.philox4x32_10(
            *[torch.from_numpy(ctr[:, i].astype(np.int64))
              for i in range(4)], k0, k1), dim=-1).numpy()
        want = np.array([_philox_python(tuple(int(v) for v in ctr[i]),
                                        (k0, k1)) for i in range(n)])
        np.testing.assert_array_equal(got, want)


def test_random_words_counter_layout_and_uniform_conversions():
    keys = px.make_keys(0x0123456789ABCDEF, 3, "cpu", chain_key=[0, 7, -2])
    assert (keys.k0, keys.k1) == (0x89ABCDEF, 0x01234567)
    words = px.random_words(keys, 11, px.STREAM_Z, 10).numpy()
    assert words.shape == (3, 10)
    for c, ck in enumerate([0, 7, 0xFFFFFFFE]):
        for i in (0, 3, 4, 9):
            block = _philox_python((i // 4, px.STREAM_Z, 11, ck),
                                   (keys.k0, keys.k1))
            assert int(words[c, i]) == block[i % 4]
    bits = torch.tensor([0, 1, 0x7FFFFF, 0xFFFFFFFF, 0x800000],
                        dtype=torch.int64)
    np.testing.assert_array_equal(
        px.u01_closed(bits).numpy(),
        np.array([0, 1, 0x7FFFFF, 0x7FFFFF, 0], np.float32) / 2 ** 23)
    np.testing.assert_array_equal(
        px.u01_open(bits).numpy(),
        (np.array([0, 1, 0x7FFFFF, 0x7FFFFF, 0], np.float32) + 0.5)
        / 2 ** 23)
    # the int32 bit patterns the CUDA generator returns convert alike
    as_i32 = torch.tensor([-1, -(1 << 31), 5], dtype=torch.int32)
    as_i64 = as_i32.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(px.u01_open(as_i32), px.u01_open(as_i64))
    streams = [px.STREAM_P, px.STREAM_S_PROP, px.STREAM_S_ACC,
               px.STREAM_S_GEN, px.STREAM_S_LOGU, px.STREAM_Z, px.STREAM_Q,
               px.STREAM_ALPHA]
    assert len(set(streams)) == len(streams)


# ---------------------------------------------------------------------------
# conversion and the run loop
# ---------------------------------------------------------------------------

def test_state_and_dataset_roundtrip_through_numpy(panel):
    spec = ModelSpec(mode=2, n_pops=2)
    state = init_state(5, spec, panel.data, n_chains=3, device="cpu")
    back = convert.state_from_numpy(convert.state_to_numpy(state), "cpu")
    for name, t in state._asdict().items():
        b = getattr(back, name)
        if t is None:
            assert b is None
        else:
            assert b.dtype == t.dtype and torch.equal(b, t), name
    d = panel.data
    fields = {k: None if v is None else v.numpy()
              for k, v in d._asdict().items()}
    d2 = convert.dataset_from_numpy(fields)
    assert torch.equal(d2.bits2, d.bits2) and torch.equal(d2.geno, d.geno)
    assert d2.distinct is None and d2.hom.dtype == torch.bool
    with pytest.raises(ValueError, match="unexpected shape"):
        bad = convert.state_to_numpy(state)
        bad["rates"] = bad["rates"][0, 0]
        convert.state_from_numpy(bad, "cpu")


def test_init_state_shapes_and_keyed_chains(panel):
    spec = ModelSpec(mode=2, n_pops=2)
    n, l = panel.n_indv, panel.n_loci
    s = init_state(9, spec, panel.data, n_chains=3, device="cpu",
                   chain_key=[0, 1, 0])
    assert s.z.shape == (3, n, 2 * l) and s.z.dtype == torch.int8
    assert s.q.shape == (3, n, 2) and s.freq.shape == (3, 2, l, 2)
    assert s.rates.shape == (3, 2) and s.gen.dtype == torch.int32
    assert s.zz.shape == (3, 0) and s.dpm_values.shape == (3, 0)
    assert s.freq2 is None and s.geno is None and s.active is None
    # a chain is a function of (seed, chain key): chains 0 and 2 coincide
    assert torch.equal(s.z[0], s.z[2]) and not torch.equal(s.z[0], s.z[1])
    assert torch.equal(s.rates[0], s.rates[2])
    np.testing.assert_allclose(s.q.sum(-1).numpy(), 1.0, atol=1e-5)
    assert int(s.gen.min()) >= 1 and int(s.gen.max()) <= spec.gen_cap
    np.testing.assert_array_equal(
        s.zcounts.numpy(),
        updates.allele_pop_counts(spec, panel.data, s.z).numpy())
    assert float(s.zcounts[0].sum()) == 2.0 * float(
        panel.data.site_valid.sum())
    fixed = init_state(9, spec, panel.data, n_chains=2, device="cpu",
                       init_rates=np.array([[0.2, 0.7], [0.0005, 0.9999]]))
    np.testing.assert_allclose(fixed.rates.numpy(),
                               [[0.2, 0.7], [0.0005, 0.9999]])
    assert fixed.ais_state.tolist() == [[1, 1], [0, 2]]


def test_run_mcmc_is_deterministic_and_counts_stored_steps(panel):
    spec = ModelSpec(mode=2, n_pops=2, s_subsweeps=2)
    sched = Schedule(**SCHED)
    a = run_mcmc(panel.data, spec, sched, 3, device="cpu", track_freq=True)
    b = run_mcmc(panel.data, spec, sched, 3, device="cpu", track_freq=True)
    c = run_mcmc(panel.data, spec, sched, 4, device="cpu")
    assert isinstance(a, RunResult) and a.n_retries == 0
    for x, y in zip(a.final_state, b.final_state):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(a.accum.mean.rates, b.accum.mean.rates)
    assert not torch.equal(a.final_state.z, c.final_state.z)
    assert a.accum.count.tolist() == [sched.n_stored] * 2 == [10, 10]
    assert a.accum.mean.freq.shape == (2, 2, panel.n_loci, 2)
    assert c.accum.mean.freq.shape == (2, 0)
    # the run ends on a stored step here, so the state's log-lik is the
    # last stored one, and the convergence trace holds the first ckrep
    assert torch.isfinite(a.final_state.loglik_total).all()
    assert (a.accum.convg_ld != 0).all() and a.accum.convg_ld.shape == (2, 5)
    # information criteria: plug-in only when P was tracked
    assert a.plugin_ll is not None and c.plugin_ll is None
    np.testing.assert_allclose(c.dic(), c.dic_reference())
    assert c.p_d() is None
    np.testing.assert_allclose(a.dic(), -4 * a.accum.mean.ll_marg.sum(-1)
                               .numpy() + 2 * a.plugin_ll, rtol=1e-6)
    np.testing.assert_allclose(a.waic(), a.waic_indv().sum(-1), rtol=1e-6)
    assert (a.p_waic() >= 0).all() and a.waic_se() > 0
    assert a.posterior_mean is a.accum.mean
    assert (a.posterior_var.rates >= -1e-6).all()


def test_unhealthy_chain_is_retried_with_a_fresh_key(panel, monkeypatch):
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(**SCHED)
    clean = run_mcmc(panel.data, spec, sched, 8, device="cpu")
    calls = []
    real = driver.unhealthy_flags

    def flag_chain0_once(state, accum):
        calls.append(1)
        flags = real(state, accum)
        if len(calls) == 1:
            flags = flags.copy()
            flags[0] = True
        return flags

    monkeypatch.setattr(driver, "unhealthy_flags", flag_chain0_once)
    res = run_mcmc(panel.data, spec, sched, 8, device="cpu")
    assert res.n_retries == 1 and len(calls) == 2
    # the unflagged chain replays its own key; the flagged one moved
    assert torch.equal(res.final_state.z[1], clean.final_state.z[1])
    assert not torch.equal(res.final_state.z[0], clean.final_state.z[0])
    # a chain that stays unhealthy exhausts the retries and is reported
    monkeypatch.setattr(driver, "unhealthy_flags",
                        lambda s, a: np.array([True, False]))
    res = run_mcmc(panel.data, spec, sched, 8, device="cpu", max_retries=2)
    assert res.n_retries == 2


def test_unhealthy_flags_reads_latch_and_non_finite(panel):
    spec = ModelSpec(mode=2, n_pops=2)
    sched = Schedule(**SCHED)
    state = init_state(1, spec, panel.data, n_chains=3, device="cpu")
    acc = accumulators.init_accum(spec, sched, panel.data, False, 3, "cpu")
    assert driver.unhealthy_flags(state, acc).tolist() == [False] * 3
    acc = acc._replace(empty_cluster=torch.tensor([False, True, False]))
    ll = state.loglik_total.clone()
    ll[2] = float("nan")
    flags = driver.unhealthy_flags(state._replace(loglik_total=ll), acc)
    assert flags.tolist() == [False, True, True]


def test_the_step_loop_has_no_host_synchronisation():
    """No read of a device value inside the sweep or the per-step driver
    code: stored/due are arithmetic on the step index, accepts and the
    latch are torch.where."""
    sources = [inspect.getsource(f) for f in (
        driver._chain_runner, step_mod.build_step_parts,
        step_mod._build_fused_parts, step_mod._build_unfused_parts,
        step_mod._tail_draws, step_mod._hyper_update,
        updates.update_freq, updates.update_zq, updates.update_z_noadmix,
        updates.update_s_pop, updates.update_gen,
        updates.propose_adaptive_independence, updates.update_normal_hyper,
        accumulators.accum_update, accumulators.extract_stats,
        updates.update_alpha, updates.alpha_draws,
        updates.empty_cluster_flag)]
    for src in sources:
        code = "\n".join(line.split("#")[0] for line in src.splitlines()
                         if not line.strip().startswith(('"', "'")))
        code = code.replace('float("-inf")', "")
        for banned in (".item(", ".cpu(", ".numpy(", ".tolist(", "bool(",
                       "float(", "print(", "synchronize"):
            assert banned not in code, banned
