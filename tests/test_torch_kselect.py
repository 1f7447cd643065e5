"""The port's K selection (``instruct_tpu_torch.kselect``) and the padded K
grid's active-pop mask against the JAX package, on the CPU.

The masked updates take the draws the JAX functions take from their keys
and must give their results (floats to rtol 1e-6); the grid's replicas must
reproduce the native-K posterior statistically and put exactly zero mass on
inactive slots in every diploid mode; ``infer_k`` (grid and per-K loop)
must pick the K that JAX's ``infer_k`` picks on a synthetic K = 2 panel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Schedule as JSchedule
from instruct_tpu import kselect as jks
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.mcmc.state import init_state as jax_init_state
from instruct_tpu.mcmc.step import build_marg_loglik as jax_marg

from instruct_tpu_torch import (ModelSpec, Schedule, infer_k, run_mcmc,
                                synthetic_panel)
from instruct_tpu_torch import kselect as tks
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.mcmc import updates as tup
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import nopop_marginal

EPS = 1e-30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PANEL = dict(n_indv=50, n_loci=100, n_pops=2,
             selfing_rates=np.array([0.15, 0.75]), admixture_alpha=0.2,
             seed=13)


@pytest.fixture(scope="module")
def panels():
    """The same synthetic K = 2 panel from both packages' generators."""
    return jax_panel(**PANEL), synthetic_panel(**PANEL)


def _active(counts, k):
    a = np.zeros((len(counts), k), np.float32)
    for c, n in enumerate(counts):
        a[c, :n] = 1.0
    return a


def _masked_q(rng, counts, n, k):
    q = rng.dirichlet(np.ones(k), size=(len(counts), n))
    q = q * _active(counts, k)[:, None, :]
    return (q / q.sum(-1, keepdims=True)).astype(np.float32)


def test_update_alpha_with_active_matches_jax():
    """alpha's MH step over each chain's active slots (K = its active
    count, the log-q sum masked), fed the normal and the uniform that JAX
    draws from its key."""
    rng = np.random.default_rng(3)
    counts, n, k = (1, 2, 4, 5), 30, 5
    q = _masked_q(rng, counts, n, k)
    alpha = rng.uniform(0.3, 3.0, size=len(counts)).astype(np.float32)
    act = _active(counts, k)
    spec, jspec = ModelSpec(mode=1, n_pops=k), JSpec(mode=1, n_pops=k)
    normals, unis, want = [], [], []
    for c in range(len(counts)):
        key = jax.random.key(40 + c)
        ku, ka = jax.random.split(key)
        normals.append(float(jax.random.normal(ka)))
        unis.append(float(jax.random.uniform(ku, minval=EPS)))
        want.append(float(jup.update_alpha(key, jspec, jnp.asarray(q[c]),
                                           jnp.asarray(alpha[c]),
                                           jnp.asarray(act[c]))))
    got = tup.update_alpha(None, 0, spec, torch.from_numpy(q),
                           torch.from_numpy(alpha), torch.from_numpy(act),
                           test_draws=(torch.tensor(normals),
                                       torch.tensor(unis)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # the mask is the density: without it the padded slots' log q = -69
    # would weigh in
    unmasked = tup.update_alpha(None, 0, spec, torch.from_numpy(q),
                                torch.from_numpy(alpha),
                                test_draws=(torch.tensor(normals),
                                            torch.tensor(unis)))
    assert not torch.equal(unmasked, got)


def test_empty_cluster_flag_exempts_inactive_slots():
    rng = np.random.default_rng(4)
    counts, n, k = (2, 3, 3), 20, 4
    q = _masked_q(rng, counts, n, k)
    q[2, :, 2] = 0.0                      # an ACTIVE slot run empty
    q[2] /= q[2].sum(-1, keepdims=True)
    act = _active(counts, k)
    got = tup.empty_cluster_flag(torch.from_numpy(q), torch.from_numpy(act))
    want = [bool(jup.empty_cluster_flag(jnp.asarray(q[c]),
                                        jnp.asarray(act[c])))
            for c in range(len(counts))]
    assert got.tolist() == want == [False, False, True]
    assert tup.empty_cluster_flag(torch.from_numpy(q)).all()


def test_mode0_marginal_over_active_slots_matches_jax(panels):
    """Mode 0's marginal log-lik mixes over the active slots only (JAX
    step.py:526-531)."""
    jp, tp = panels
    rng = np.random.default_rng(5)
    k, counts = 4, (2, 3)
    l, a = tp.data.n_loci, tp.data.max_alleles
    freq = rng.dirichlet(np.ones(a), size=(len(counts), k, l)
                         ).astype(np.float32)
    act = _active(counts, k)
    jspec = JSpec(mode=0, n_pops=k)
    add = jax_marg(jspec, jp.data)
    want = []
    for c in range(len(counts)):
        st = jax_init_state(jax.random.key(c), jspec, jp.data,
                            active=jnp.asarray(act[c]))
        want.append(np.asarray(add(st._replace(
            freq=jnp.asarray(freq[c]))).loglik_marg))
    got = nopop_marginal(ModelSpec(mode=0, n_pops=k), tp.data,
                         torch.from_numpy(freq), torch.from_numpy(act))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("mode", [0, 2])
def test_init_state_draws_over_the_active_slots(panels, mode):
    _, tp = panels
    counts, k = (1, 2, 3), 4
    act = torch.from_numpy(_active(counts, k))
    s = init_state(7, ModelSpec(mode=mode, n_pops=k), tp.data, n_chains=3,
                   device="cpu", active=act)
    assert torch.equal(s.active, act)
    for c, n_act in enumerate(counts):
        lab = s.zz[c] if mode == 0 else s.z[c]
        assert int(lab.min()) == 0 and int(lab.max()) == n_act - 1
        if mode:
            assert float(s.q[c, :, n_act:].abs().sum()) == 0.0
            np.testing.assert_allclose(s.q[c].sum(-1).numpy(), 1.0,
                                       atol=1e-5)
            assert float(s.zcounts[c, n_act:].sum()) == 0.0


def test_active_pops_are_checked(panels):
    _, tp = panels
    sched = Schedule(n_iter=4, burnin=2, thinning=1, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    spec = ModelSpec(mode=2, n_pops=3)
    for bad in (np.ones((2, 2)), np.array([[1, 0, 1], [1, 1, 0]]),
                np.zeros((2, 3)), np.full((2, 3), 0.5)):
        with pytest.raises(ValueError, match="active_pops"):
            run_mcmc(tp.data, spec, sched, 0, device="cpu",
                     active_pops=bad)
    tetra = synthetic_tetra_panel(10, 8, n_pops=1, autopoly=True, seed=1)
    with pytest.raises(ValueError, match="diploid"):
        run_mcmc(tetra.data, ModelSpec(mode=2, ploid=4, n_pops=2), sched, 0,
                 device="cpu", active_pops=np.ones((2, 2)))


SCHED = Schedule(n_iter=800, burnin=400, thinning=3, n_chains=2, ckrep=50,
                 nstep_check_empty_cluster=100)


@pytest.mark.parametrize("mode", [2, 0])
def test_padded_replica_matches_native(panels, mode):
    """K = 2 native against K = 2 active inside K_max = 4 (as
    tests/test_kgrid.py does for JAX): exact zeros on the inactive q, no z
    on an inactive slot, and the same posterior within Monte Carlo noise
    (selfing rates in mode 2; total log-lik, co-assignment and WAIC)."""
    _, tp = panels
    res_nat = run_mcmc(tp.data, ModelSpec(mode=mode, n_pops=2), SCHED, 0,
                       device="cpu", track_freq=True)
    res_pad = run_mcmc(tp.data, ModelSpec(mode=mode, n_pops=4), SCHED, 0,
                       device="cpu", track_freq=True,
                       active_pops=_active((2, 2), 4))
    q_pad = res_pad.posterior_mean.q.numpy()
    assert q_pad[:, :, 2:].max() == 0.0
    st = res_pad.final_state
    assert int((st.zz if mode == 0 else st.z).max()) <= 1
    ll_nat = float(res_nat.posterior_mean.total_ll.mean())
    ll_pad = float(res_pad.posterior_mean.total_ll.mean())
    assert abs(ll_pad - ll_nat) / abs(ll_nat) < 5e-3
    if mode == 2:
        s_nat = np.sort(res_nat.posterior_mean.rates.numpy(), -1).mean(0)
        s_pad = np.sort(res_pad.posterior_mean.rates.numpy()[:, :2],
                        -1).mean(0)
        np.testing.assert_allclose(s_pad, s_nat, atol=0.08)
    q_nat = res_nat.posterior_mean.q.numpy()
    co_nat = np.einsum("cik,cjk->ij", q_nat, q_nat) / q_nat.shape[0]
    co_pad = np.einsum("cik,cjk->ij", q_pad, q_pad) / q_pad.shape[0]
    assert np.abs(co_nat - co_pad).mean() < 0.05
    w_nat, w_pad = res_nat.waic().mean(), res_pad.waic().mean()
    assert abs(w_nat - w_pad) / abs(w_nat) < 0.02


KSEL = dict(n_small=1, n_large=3)
KSCHED = dict(n_iter=600, burnin=300, thinning=3, n_chains=2, ckrep=50,
              nstep_check_empty_cluster=100)


def test_infer_k_grid_and_loop_pick_jax_k(panels):
    """The port's grid and its per-K loop pick the K that JAX's infer_k
    picks (the generating K = 2), with per-K WAIC within Monte Carlo noise
    of each other and native-K shapes in the sliced results."""
    jp, tp = panels
    spec = ModelSpec(mode=2, n_pops=2)
    grid = infer_k(tp.data, spec, Schedule(**KSCHED), 1, device="cpu",
                   **KSEL)
    loop = infer_k(tp.data, spec, Schedule(**KSCHED), 1, device="cpu",
                   grid=False, **KSEL)
    jres = jks.infer_k(jp.data, JSpec(mode=2, n_pops=2),
                       JSchedule(**KSCHED), jax.random.key(1), **KSEL)
    assert grid.best_k == loop.best_k == jres.best_k == 2
    for k in (1, 2, 3):
        # past the true K a redundant cluster wanders or captures a few
        # individuals, and WAIC spreads over runs (the reason for the 1-SE
        # rule): 2% up to K = 2, 5% at K = 3
        wg, wl = grid.waic[k].mean(), loop.waic[k].mean()
        assert abs(wg - wl) / abs(wl) < (0.02 if k <= 2 else 0.05), (
            k, wg, wl)
        assert grid.results[k].posterior_mean.q.shape[-1] == k
        assert grid.results[k].posterior_mean.rates.shape[-1] == k
        assert grid.results[k].accum.count.shape == (2,)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5])
def test_infer_k_grid_runs_every_diploid_mode(panels, mode):
    """One padded run per mode: every K's slice is native-K, its q puts no
    mass on padding and its z no label there, and every column is
    reported."""
    _, tp = panels
    sched = Schedule(n_iter=24, burnin=12, thinning=2, n_chains=2, ckrep=4,
                     nstep_check_empty_cluster=4)
    res = infer_k(tp.data, ModelSpec(mode=mode, n_pops=2, s_subsweeps=2),
                  sched, 5, n_small=1, n_large=3, device="cpu")
    assert set(res.results) == {1, 2, 3} and res.best_k in (1, 2, 3)
    for k, r in res.results.items():
        assert r.posterior_mean.q.shape == (2, tp.n_indv, k)
        st = r.final_state
        if mode:
            assert float(st.q[:, :, k:].abs().sum()) == 0.0
        assert int((st.zz if mode == 0 else st.z).max()) < k
        assert np.isfinite(res.dic[k]).all() and res.waic[k] is not None


def test_infer_k_ploidy4_runs_per_k():
    """The tetraploid engine runs its K values one by one (as in JAX)."""
    panel = synthetic_tetra_panel(16, 12, n_pops=2, autopoly=True,
                                  selfing_rates=np.array([0.3, 0.7]),
                                  seed=2)
    sched = Schedule(n_iter=8, burnin=4, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    res = infer_k(panel.data, ModelSpec(mode=2, ploid=4, n_pops=1), sched,
                  3, n_small=1, n_large=2, device="cpu")
    assert set(res.results) == {1, 2}
    for k, r in res.results.items():
        assert r.final_state.q.shape[-1] == k
        assert r.final_state.active is None


def test_helpers_match_jax():
    """_rates_for_k and _pick_best are the JAX package's; the per-K seed is
    a Weyl step of the run's seed."""
    init = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r in (0, 2, 3, 7):
        a, b = tks._rates_for_k(init, r), jks._rates_for_k(init, r)
        assert (a is None and b is None) or np.array_equal(a, b)
    waic = {1: np.array([10.0, 11.0]), 2: np.array([5.0, 5.5]),
            3: np.array([5.2, 5.3])}
    se = {1: 1.0, 2: 0.4, 3: 0.3}
    dic = {k: v + 1 for k, v in waic.items()}
    args = (dic, waic, se, {}, dic, {}, {}, 1, 3)
    assert tks._pick_best(*args).best_k == jks._pick_best(*args).best_k == 2
    nowaic = {k: None for k in waic}
    args = (dic, nowaic, se, {}, dic, {}, {}, 1, 3)
    assert tks._pick_best(*args).best_k == jks._pick_best(*args).best_k
    assert tks.k_seed(5, 0) == 5 and tks.k_seed(5, 1) != tks.k_seed(5, 2)
    assert tks.k_seed(2 ** 64 - 1, 1) < 2 ** 64


def test_grid_threads_init_rates(panels):
    """The reference reuses the same initial rates for every K: the grid
    gives each K's replicas their slice, zeros on the padding."""
    _, tp = panels
    sched = Schedule(n_iter=6, burnin=3, thinning=1, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    init = np.asarray([[0.3, 0.6], [0.2, 0.9]], np.float32)
    res = infer_k(tp.data, ModelSpec(mode=2, n_pops=2), sched, 2,
                  n_small=2, n_large=3, init_rates=init, device="cpu")
    assert set(res.results) == {2, 3}


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
def test_marginal_loglik_in_chain_chunks_is_one_shot(panels, mode,
                                                     monkeypatch):
    """The Z-marginalized log-lik of the WAIC refresh and the plug-in runs
    a chunk of chains at a time (``MARG_CHUNK_BYTES``): with budgets of one
    chain, two and all five, it is bitwise the one-shot evaluation."""
    from instruct_tpu_torch.model import likelihood as tlk
    _, tp = panels
    d = tp.data
    rng = np.random.default_rng(3)
    c, n, l, k = 5, d.n_indv, d.n_loci, 3
    freq = torch.from_numpy(rng.dirichlet(np.ones(2), size=(c, k, l))
                            .astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(k), size=(c, n))
                         .astype(np.float32))
    gen = torch.from_numpy(rng.integers(1, 6, size=(c, n)).astype(np.int32))
    rates = torch.from_numpy(rng.uniform(0.05, 0.9, size=(c, n if mode == 5
                                                          else k))
                             .astype(np.float32))
    spec = ModelSpec(mode=mode, n_pops=k)
    want = tlk.marginal_site_loglik(spec, d, freq, q, gen, rates).sum(-1)
    for chains in (1, 2, 5):
        monkeypatch.setattr(tlk, "MARG_CHUNK_BYTES", chains * 4 * n * l)
        got = tlk.marginal_indv_loglik(spec, d, freq, q, gen, rates)
        assert got.shape == (c, n) and torch.equal(got, want)
