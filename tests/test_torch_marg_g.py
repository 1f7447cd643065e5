"""The port's ``marginalize_g`` updates (``instruct_tpu_torch/mcmc/
marg_g.py``) against the JAX package's ``instruct_tpu/mcmc/marg_g.py``, on
the CPU, fed the draws the JAX functions make from their keys: the G curve
(to rtol 1e-5 of its magnitude, against JAX's and against a dense numpy
transcription), the truncated geometric prior, the exact G draw (exactly),
the mode-2 and mode-3 S updates on the G-marginal target (back-reflection
and adaptive; uniform and normal prior), and one whole sweep of mode 2
under ``marginalize_g`` and of mode 3 under ``marginalize_g`` with the DPM
prior, fused and unfused, against the JAX kernels and updates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _dpm_sweeps import EPS, check_sweep, gumbel, panel, t, unif
from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Priors as JPriors
from instruct_tpu.config import PriorFamily as JFamily
from instruct_tpu.mcmc import marg_g as jmg

from instruct_tpu_torch import ModelSpec, Priors, Schedule, run_mcmc
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import marg_g as mg

C = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gtable_dense(data, freq, z, cap):
    """The G curve site by site in float64 numpy: hom same-z sites
    log(1 - (1 - p0) 2^(1-g)), het same-z sites (1 - g) log 2."""
    geno = data.geno.numpy()
    l = data.n_loci
    valid, hom = data.site_valid.numpy(), data.hom.numpy()
    gens = np.arange(1, cap + 1, dtype=np.float64)
    w = 2.0 ** (1.0 - gens)
    out = []
    for ci in range(freq.shape[0]):
        z0, z1 = z[ci, :, :l], z[ci, :, l:]
        same = (z0 == z1) & valid
        x0 = np.clip(geno[:, :l], 0, None)
        p0 = freq[ci, z0, np.arange(l)[None, :], x0].astype(np.float64)
        term = np.log(np.maximum(1.0 - (1.0 - p0[..., None]) * w, 1e-30))
        g = ((term * (same & hom)[..., None]).sum(1)
             + (same & ~hom).sum(1)[:, None] * (1.0 - gens) * np.log(2.0))
        out.append(g)
    return np.stack(out)


@pytest.mark.parametrize("n_alleles,cap", [(2, 50), (4, 13)])
def test_selfing_gtable_matches_jax_and_its_dense_form(n_alleles, cap):
    n, l, k = 21, 45, 3
    jdata, data = panel(n, l, k, n_alleles, seed=6)
    rng = np.random.default_rng(cap)
    freq = rng.dirichlet(np.ones(n_alleles), size=(C, k, l)
                         ).astype(np.float32)
    z = rng.integers(0, k, size=(C, n, 2 * l)).astype(np.int8)
    got = mg.selfing_gtable(data, t(freq), t(z), cap).numpy()
    dense = _gtable_dense(data, freq, z, cap)
    assert got.shape == (C, n, cap)
    np.testing.assert_allclose(
        mg.selfing_gtable_dense(data, t(freq), t(z), cap, rows=8).numpy(),
        dense, rtol=1e-5, atol=1e-5 * np.abs(dense).max())
    for ci in range(C):
        want = np.asarray(jmg.selfing_gtable(jdata, jnp.asarray(freq[ci]),
                                             jnp.asarray(z[ci]), cap))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[ci], want, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got[ci], dense[ci], rtol=1e-5,
                                   atol=1e-5 * scale)


def test_log_geom_trunc_and_the_exact_g_draw_match_jax():
    n, cap = 40, 50
    rng = np.random.default_rng(2)
    sbar = rng.uniform(0, 1, (C, n)).astype(np.float32)
    sbar[0, :3] = (0.0, 1.0, 1e-9)                     # the clipped edges
    gtable = rng.normal(0, 4, (C, n, cap)).astype(np.float32)
    np.testing.assert_allclose(
        mg.log_geom_trunc(t(sbar), cap).numpy(),
        np.asarray(jmg.log_geom_trunc(jnp.asarray(sbar), cap)), rtol=2e-6,
        atol=2e-5)
    keys = [jax.random.key(11 + ci) for ci in range(C)]
    want = np.stack([np.asarray(jmg.sample_gen_marginal(
        keys[ci], jnp.asarray(gtable[ci]), jnp.asarray(sbar[ci]), cap))
        for ci in range(C)])
    noise = t(np.stack([gumbel(kk, (n, cap)) for kk in keys]))
    got = mg.sample_gen_marginal(noise, t(gtable), t(sbar), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got.min()) >= 1
    # from Philox: the stream's words, reproducible
    pk = px.make_keys(3, C, "cpu")
    a = mg.gen_noise(pk, 5, n, cap)
    np.testing.assert_array_equal(
        a.numpy(), px.gumbel(px.random_words(pk, 5, px.STREAM_MARG_GEN,
                                             n * cap)).reshape(C, n, cap))


def _pop_draws(key, k, adaptive):
    """(u_prop, u_acc, u_fresh) f32[K] of one subsweep of
    ``update_s_pop_marginal``."""
    kacc, kprop = jax.random.split(key)
    u_acc = np.array([unif(kk, (), EPS) for kk in jax.random.split(kacc, k)])
    if not adaptive:
        return unif(kprop, (k,)), u_acc, None
    ku, kv = jax.random.split(kprop)
    return unif(ku, (k,)), u_acc, unif(kv, (k,))


@pytest.mark.parametrize("back_refl", [1, 0])
def test_update_s_pop_marginal_matches_jax(back_refl):
    n, k, cap, j = 35, 3, 50, 3
    rng = np.random.default_rng(back_refl)
    q = rng.dirichlet(np.full(k, 0.4), size=(C, n)).astype(np.float32)
    gtable = (rng.normal(0, 3, (C, n, cap))
              - np.arange(cap) * 0.3).astype(np.float32)
    rates = rng.uniform(0.05, 0.95, (C, k)).astype(np.float32)
    rates[0, 0] = 0.0
    ais = np.where(rates <= 1e-3, 0, 1).astype(np.int32)
    spec = ModelSpec(mode=2, n_pops=k, back_refl=back_refl,
                     marginalize_g=True)
    jspec = JSpec(mode=2, n_pops=k, back_refl=back_refl, marginalize_g=True)
    adaptive = back_refl == 0
    want_r, want_a, dr = [], [], []
    for ci in range(C):
        r, a = jnp.asarray(rates[ci]), jnp.asarray(ais[ci])
        ks, per = jax.random.key(30 + ci), []
        for jj in range(j):
            kj = jax.random.fold_in(ks, jj)
            per.append(_pop_draws(kj, k, adaptive))
            r, a = jmg.update_s_pop_marginal(kj, jspec, jnp.asarray(q[ci]),
                                             jnp.asarray(gtable[ci]), r, a)
        want_r.append(np.asarray(r))
        want_a.append(np.asarray(a))
        dr.append(per)

    def plane(i):
        return t(np.array([[d[i] for d in per] for per in dr], np.float32))

    got_r, got_a = mg.update_s_pop_marginal(
        plane(0), plane(1), spec, t(q), t(gtable), t(rates), t(ais),
        plane(2) if adaptive else None)
    np.testing.assert_allclose(got_r.numpy(), np.stack(want_r), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got_a.numpy(), np.stack(want_a))
    assert (got_r.numpy() != rates).any()


@pytest.mark.parametrize("normal", [False, True], ids=["uniform", "normal"])
def test_update_s_ind_marginal_matches_jax(normal):
    n, cap, j = 40, 50, 2
    rng = np.random.default_rng(7)
    # curves peaked at a generation of each individual's own
    peak = rng.integers(0, 12, (C, n, 1))
    gtable = (rng.normal(0, 1, (C, n, cap))
              - 2.0 * (np.arange(cap) - peak) ** 2).astype(np.float32)
    rates = rng.uniform(0.02, 0.98, (C, n)).astype(np.float32)
    mu = np.array([0.3, 0.6], np.float32)
    s2 = np.array([0.05, 0.2], np.float32)
    spec = ModelSpec(mode=3, n_pops=2, marginalize_g=True)
    jspec = JSpec(mode=3, n_pops=2, marginalize_g=True)
    want, u_prop, u_acc = [], [], []
    for ci in range(C):
        r, ks = jnp.asarray(rates[ci]), jax.random.key(50 + ci)
        up_c, ua_c = [], []
        for jj in range(j):
            kj = jax.random.fold_in(ks, jj)
            kp, ku = jax.random.split(kj)
            up_c.append(unif(kp, (n,)))
            ua_c.append(unif(ku, (n,), EPS))
            r = jmg.update_s_ind_marginal(
                kj, jspec, jnp.asarray(gtable[ci]), r,
                jnp.asarray(mu[ci]) if normal else None,
                jnp.asarray(s2[ci]) if normal else None)
        want.append(np.asarray(r))
        u_prop.append(up_c)
        u_acc.append(ua_c)
    got = mg.update_s_ind_marginal(
        t(u_prop), t(u_acc), spec, t(gtable), t(rates),
        t(mu) if normal else None, t(s2) if normal else None)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-6,
                               atol=1e-7)
    assert (got.numpy() != rates).any() and (got.numpy() == rates).any()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", [2, 3], ids=["mode2", "mode3_dpm"])
def test_one_marg_sweep_matches_jax(mode, fused):
    use = None if fused else False
    jprior, prior = {}, {}
    if mode == 3:
        jprior = dict(priors=JPriors(family=JFamily.DPM))
        prior = dict(priors=Priors(family=PriorFamily.DPM))
    jspec = JSpec(mode=mode, n_pops=3, s_subsweeps=2, use_pallas=use,
                  marginalize_g=True, **jprior)
    spec = ModelSpec(mode=mode, n_pops=3, s_subsweeps=2, use_pallas=use,
                     marginalize_g=True, **prior)
    got = check_sweep(jspec, spec)
    assert (got.gen >= 1).all() and (got.gen <= spec.gen_cap).all()


@pytest.mark.parametrize("kwargs", [
    dict(mode=2), dict(mode=3), dict(mode=2, back_refl=0),
    dict(mode=3, priors=Priors(family=PriorFamily.NORMAL)),
    dict(mode=3, priors=Priors(family=PriorFamily.DPM, dp_truncation=5))])
def test_marg_runs_reproducibly_on_both_sweeps(kwargs):
    data = panel(20, 30, 2, 2)[1]
    sched = Schedule(n_iter=8, burnin=4, thinning=2, n_chains=C, ckrep=2,
                     nstep_check_empty_cluster=2)
    outs = [run_mcmc(data, ModelSpec(n_pops=2, use_pallas=use,
                                     marginalize_g=True, **kwargs),
                     sched, seed=3, device="cpu")
            for use in (None, False, None)]
    a, b, c = (r.final_state for r in outs)
    for x, y in zip(a, c):
        assert (x is None and y is None) or torch.equal(x, y)
    for st in (a, b):
        assert torch.isfinite(st.loglik_total).all()
        assert ((st.rates >= 0) & (st.rates <= 1)).all()
