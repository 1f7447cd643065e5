"""The port's mode-2 slice against the JAX package, on the CPU.

Module by module on the same arrays (made with numpy from a seed) and the
same injected draws; then one whole sweep, deterministic, against the JAX
kernel functions called in the fused step's order in interpret mode; then
the sampler as a whole, statistically, against the JAX ``run_mcmc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Schedule as JSchedule
from instruct_tpu import diagnostics as jdiag
from instruct_tpu import run_mcmc as jax_run_mcmc
from instruct_tpu.data.dataset import make_dataset as jax_make_dataset
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.kernels import fused_step as jfs
from instruct_tpu.kernels.s_pop_pallas import s_pop_tail as jax_s_pop_tail
from instruct_tpu.mcmc import accumulators as jacc
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.mcmc.state import init_state as jax_init_state
from instruct_tpu.model import likelihood as jlk

from instruct_tpu_torch import ModelSpec, Schedule, run_mcmc
from instruct_tpu_torch import convert, diagnostics as tdiag
from instruct_tpu_torch.data.dataset import make_dataset
from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.dirichlet import n_test_draws
from instruct_tpu_torch.mcmc import accumulators as tacc
from instruct_tpu_torch.mcmc import updates as tup
from instruct_tpu_torch.mcmc.step import (StepDraws, build_marg_loglik,
                                          build_step, build_step_parts)
from instruct_tpu_torch.model import likelihood as tlk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: intra-op threads only add overhead, and
    the test workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def _alpha_draws(key):
    """The normal and the uniform that ``instruct_tpu`` ``update_alpha``
    draws from ``key``."""
    ku, ka = jax.random.split(key)
    return (np.asarray(jax.random.normal(ka), np.float32),
            np.asarray(jax.random.uniform(ku, minval=1e-30), np.float32))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_alleles,missing", [(2, 0.0), (2, 0.2), (3, 0.1)])
def test_synthetic_panel_and_make_dataset_equal_jax(n_alleles, missing):
    kw = dict(n_indv=23, n_loci=31, n_pops=3, n_alleles=n_alleles,
              selfing_rates=np.array([0.1, 0.4, 0.8]), admixture_alpha=0.1,
              missing_rate=missing, seed=17)
    want, got = jax_panel(**kw), synthetic_panel(**kw)
    for name, w in _fields(want.data).items():
        g = getattr(got.data, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (got.data.bits2 is not None) == (n_alleles == 2)
    np.testing.assert_array_equal(got.pop_index, want.pop_index)
    np.testing.assert_array_equal(got.n_alleles, want.n_alleles)
    np.testing.assert_array_equal(got.missing_per_indv,
                                  want.missing_per_indv)
    assert (got.n_indv, got.n_loci, got.data.ploid,
            got.data.max_alleles) == (23, 31, 2, want.data.max_alleles)
    np.testing.assert_array_equal(got.data.geno3, want.data.geno3)
    # make_dataset infers allele counts the same way when none are given
    rng = np.random.default_rng(2)
    geno = rng.integers(0, 2, (9, 12, 2))
    geno[:, 3] = 0                                     # a monomorphic locus
    miss = rng.random((9, 12)) < 0.2
    for name, w in _fields(jax_make_dataset(geno, miss)).items():
        g = getattr(make_dataset(geno, miss), name)
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ---------------------------------------------------------------------------
# modules outside the kernels
# ---------------------------------------------------------------------------

def _small(seed=5, n=19, l=37, k=3, c=2):
    jp = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=2,
                   missing_rate=0.1, seed=seed)
    data = convert.dataset_from_numpy(_fields(jp.data))
    rng = np.random.default_rng(seed)
    freq = rng.dirichlet(np.ones(2), size=(c, k, l)).astype(np.float32)
    q = rng.dirichlet(np.full(k, 0.5), size=(c, n)).astype(np.float32)
    z = rng.integers(0, k, size=(c, n, 2 * l)).astype(np.int8)
    gen = rng.integers(1, 9, size=(c, n)).astype(np.int32)
    return jp.data, data, freq, q, z, gen, rng


def test_update_alpha_matches_jax():
    _, _, _, q, _, _, rng = _small(c=6)
    spec, jspec = ModelSpec(mode=2, n_pops=3), JSpec(mode=2, n_pops=3)
    alpha = rng.uniform(0.05, 3.0, 6).astype(np.float32)
    alpha[0] = 0.3                         # small alpha: proposals <= 0 occur
    keys = [jax.random.key(100 + i) for i in range(6)]
    want = np.array([np.asarray(jup.update_alpha(
        keys[i], jspec, jnp.asarray(q[i]), jnp.asarray(alpha[i])))
        for i in range(6)])
    dr = [_alpha_draws(kk) for kk in keys]
    normal = _t(np.array([d[0] for d in dr]))
    u = _t(np.array([d[1] for d in dr]))
    got = tup.update_alpha(px.make_keys(0, 6, "cpu"), 0, spec, _t(q),
                           _t(alpha), test_draws=(normal, u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got != alpha).any() and (got == alpha).any()
    # from Philox: a valid MH step, reproducible per (seed, step)
    k6 = px.make_keys(3, 6, "cpu")
    a1 = tup.update_alpha(k6, 4, spec, _t(q), _t(alpha))
    a2 = tup.update_alpha(k6, 4, spec, _t(q), _t(alpha))
    assert torch.equal(a1, a2) and bool((a1 > 0).all())


@pytest.mark.parametrize("type_freq", [0, 1])
def test_likelihoods_match_jax(type_freq):
    jdata, data, freq, q, z, gen, rng = _small()
    spec = ModelSpec(mode=2, n_pops=3, type_freq=type_freq)
    jspec = JSpec(mode=2, n_pops=3, type_freq=type_freq)
    rates = rng.uniform(0.1, 0.9, (2, 3)).astype(np.float32)
    genf = gen.astype(np.float32) + 0.37          # real-valued generations
    got_m = tlk.marginal_indv_loglik(spec, data, _t(freq), _t(q), _t(genf),
                                     _t(rates)).numpy()
    got_c = tlk.per_indv_loglik(spec, data, _t(freq), _t(z), _t(q),
                                _t(gen)).numpy()
    for c in range(2):
        want = jlk.marginal_indv_loglik(
            jspec, jdata, jnp.asarray(freq[c]), jnp.asarray(q[c]),
            jnp.asarray(genf[c]), jnp.asarray(rates[c]))
        np.testing.assert_allclose(got_m[c], np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
        want = jlk.per_indv_loglik(
            jspec, jdata, jnp.asarray(freq[c]), jnp.asarray(z[c]),
            jnp.asarray(q[c]), jnp.asarray(gen[c]), jnp.asarray(rates[c]))
        np.testing.assert_allclose(got_c[c], np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    # the panel log-lik pass (kernel module) is the same function; its
    # affine form f0 + (f1 - f0) * g loses relative precision on rare
    # alleles, hence the tolerance the JAX package's own test of its pass
    # against this likelihood uses
    from instruct_tpu_torch.kernels.fused_step import panel_loglik_pass
    wg = torch.exp2(1.0 - _t(gen).float())
    via_pass = panel_loglik_pass(_t(freq), _t(q), data, _t(z), wg,
                                 structure=(type_freq == 1)).numpy()
    np.testing.assert_allclose(via_pass, got_c, rtol=2e-4, atol=2e-3)


def test_count_helpers_match_jax():
    jdata, data, _, _, z, _, _ = _small()
    from instruct_tpu.mcmc.state import masked_z_counts as jmzc
    from instruct_tpu_torch.mcmc.state import _dt_stat, masked_z_counts
    spec, jspec = ModelSpec(mode=2, n_pops=3), JSpec(mode=2, n_pops=3)
    got = tup.allele_pop_counts(spec, data, _t(z)).numpy()
    got_q = masked_z_counts(_t(z), data, 3).numpy()
    for c in range(2):
        np.testing.assert_array_equal(got[c], np.asarray(
            jup.allele_pop_counts(jspec, jdata, jnp.asarray(z[c]), None)))
        np.testing.assert_array_equal(
            got_q[c], np.asarray(jmzc(jnp.asarray(z[c]), jdata, 3)))
    r = np.array([0.0, 5e-4, 0.5, 0.9995, 1.0], np.float32)
    from instruct_tpu.mcmc.state import _dt_stat as jdt
    np.testing.assert_array_equal(_dt_stat(_t(r)).numpy(),
                                  np.asarray(jdt(jnp.asarray(r))))
    x = np.array([-0.3, 0.2, 1.4, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(tup.back_reflect(_t(x)).numpy(),
                               np.asarray(jup.back_reflect(jnp.asarray(x))))
    qq = np.full((3, 10, 2), 0.5, np.float32)
    qq[1, :, 0], qq[1, :, 1] = 0.0005, 0.9995
    np.testing.assert_array_equal(
        tup.empty_cluster_flag(_t(qq)).numpy(),
        [bool(jup.empty_cluster_flag(jnp.asarray(qq[c]))) for c in range(3)])
    # the geometric proposal, fed the uniforms
    u = np.random.default_rng(0).uniform(1e-6, 1, 200).astype(np.float32)
    sbar = np.linspace(0.0, 1.0, 200).astype(np.float32)
    s = np.clip(sbar, 1e-6, 1 - 1e-6)
    want = np.clip(1 + np.floor(np.log(u) / np.log(s)), 1, 50)
    want = np.where(sbar <= 1e-3, 1, np.where(sbar >= 1 - 1e-3, 50, want))
    got = tup.sample_geometric(_t(u), _t(sbar), 50).numpy()
    assert (got == want).mean() > 0.98 and got.min() >= 1 and got.max() <= 50


def test_accum_update_matches_jax():
    n, k, c, steps = 7, 2, 2, 7
    jp = jax_panel(n_indv=n, n_loci=5, n_pops=k, n_alleles=2, seed=1)
    data = convert.dataset_from_numpy(_fields(jp.data))
    sched = Schedule(n_iter=100, burnin=50, thinning=5, ckrep=4,
                     nstep_check_empty_cluster=3)
    jsched = JSchedule(n_iter=100, burnin=50, thinning=5, ckrep=4,
                       nstep_check_empty_cluster=3)
    spec, jspec = ModelSpec(mode=2, n_pops=k), JSpec(mode=2, n_pops=k)
    rng = np.random.default_rng(3)
    acc = tacc.init_accum(spec, sched, data, True, c, "cpu")
    jaccs = [jacc.init_accum(jspec, jsched, jp.data, True) for _ in range(c)]
    store = [1, 1, 0, 1, 1, 1, 1]
    for t in range(steps):
        s = dict(total_ll=rng.normal(-900, 5, c), indv_ll=rng.normal(
            -100, 3, (c, n)), q=rng.dirichlet(np.ones(k), (c, n)),
            rates=rng.uniform(0, 1, (c, k)), gen=rng.integers(
            1, 9, (c, n)).astype(float), freq=rng.dirichlet(
            np.ones(2), (c, k, 5)), ll_marg=rng.normal(-1000, 4, (c, n)))
        s = {kk: v.astype(np.float32) for kk, v in s.items()}
        empty = np.array([False, t == 3])     # 3rd stored sample is step 3
        stats = tacc.TrackedStats(**{kk: _t(v) for kk, v in s.items()},
                                  freq2=torch.zeros(c, 0))
        acc = tacc.accum_update(acc, stats, store[t], _t(empty), 3)
        for ci in range(c):
            js = jacc.TrackedStats(**{kk: jnp.asarray(v[ci])
                                      for kk, v in s.items()},
                                   freq2=jnp.zeros((0,)))
            jaccs[ci] = jacc.accum_update(
                jaccs[ci], js, jnp.asarray(store[t]),
                jnp.asarray(empty[ci]), 3)
    assert acc.count.tolist() == [6, 6]
    assert acc.empty_cluster.tolist() == [False, True]
    for ci in range(c):
        ja = jaccs[ci]
        assert int(ja.count) == 6
        assert bool(ja.empty_cluster) == (ci == 1)
        for name in ("total_ll", "indv_ll", "q", "rates", "gen", "freq",
                     "ll_marg"):
            for moment in ("mean", "mean_sq"):
                np.testing.assert_allclose(
                    getattr(getattr(acc, moment), name)[ci].numpy(),
                    np.asarray(getattr(getattr(ja, moment), name)),
                    rtol=1e-5, err_msg=f"{moment}.{name}")
        np.testing.assert_allclose(acc.lme_indv[ci].numpy(),
                                   np.asarray(ja.lme_indv), rtol=1e-5)
        np.testing.assert_allclose(acc.m2_ll_marg[ci].numpy(),
                                   np.asarray(ja.m2_ll_marg), rtol=1e-4)
        np.testing.assert_allclose(acc.convg_ld[ci].numpy(),
                                   np.asarray(ja.convg_ld), rtol=1e-6)
    var = tacc.variance(acc)
    np.testing.assert_allclose(
        var.rates[0].numpy(), np.asarray(jacc.variance(jaccs[0]).rates),
        rtol=1e-3, atol=1e-6)


def test_diagnostics_match_jax():
    rng = np.random.default_rng(0)
    x = np.zeros((4, 300), np.float32)
    for t in range(1, 300):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=4)
    x[1] += 0.5
    np.testing.assert_allclose(float(tdiag.gelman_rubin(x)),
                               float(jdiag.gelman_rubin(x)), rtol=1e-5)
    np.testing.assert_allclose(
        tdiag.effective_sample_size_batch(x).numpy(),
        np.asarray(jdiag.effective_sample_size_batch(x)), rtol=1e-4)
    np.testing.assert_allclose(tdiag.effective_sample_size(x[0]),
                               jdiag.effective_sample_size(x[0]), rtol=1e-4)
    np.testing.assert_allclose(tdiag.ess_per_param(x.T),
                               jdiag.ess_per_param(x.T), rtol=1e-4)
    assert tdiag.effective_sample_size(x[0, :3]) == 3.0
    assert float(tdiag.effective_sample_size_batch(np.ones((1, 50)))[0]) == 50
    assert tdiag.GR_THRESHOLD == jdiag.GR_THRESHOLD


# ---------------------------------------------------------------------------
# the slice, deterministic: one whole sweep with injected uniforms
# ---------------------------------------------------------------------------

def _jax_sweep(jspec, jdata, st, p_draws, s_planes, u, q_draws, ka):
    """The mode-2 fused sweep of ``instruct_tpu/mcmc/step.py:181-254`` plus
    ``add_loglik``, from the JAX kernel functions in interpret mode with
    explicit uniforms."""
    k, l, a = jspec.n_pops, jdata.n_loci, 2
    rows = jnp.transpose(st.zcounts + 1.0, (0, 2, 1)).reshape(k * a, l)
    vrows = jnp.tile(jdata.allele_valid.T, (k, 1))
    out = jdp.dirichlet_rows(0, rows, vrows, rows_per_group=a,
                             interpret=True, test_draws=jnp.asarray(p_draws))
    freq = out.reshape(k, a, l).transpose(0, 2, 1)
    rates, gen_prop, wg_pair, logu = jax_s_pop_tail(
        jnp.zeros(2, jnp.int32), st.q, st.gen, st.rates,
        subsweeps=jspec.s_subsweeps, delta0=jspec.mh_step_s,
        gen_cap=jspec.gen_cap, interpret=True,
        test_draws=[jnp.asarray(p) for p in s_planes])
    z, qqnum, ll_diff, zcounts = jfs.zq_gendiff_pass(
        0, st.q, freq, jdata.geno, jdata.site_valid, jdata.hom, st.z,
        wg_pair, structure=(jspec.type_freq == 1), interpret=True,
        u=jnp.asarray(u), bits2=jdata.bits2)
    gen = jnp.where(logu < ll_diff, gen_prop, st.gen)
    q_new = jdp.dirichlet_rows(0, (qqnum + st.alpha).T, rows_per_group=k,
                               interpret=True,
                               test_draws=jnp.asarray(q_draws)).T
    alpha = jup.update_alpha(ka, jspec, q_new, st.alpha)
    wg = jnp.exp2(1.0 - gen.astype(jnp.float32))[:, None]
    ll = jfs.panel_loglik_pass(freq, q_new, jdata.geno, jdata.site_valid,
                               jdata.hom, z, wg,
                               structure=(jspec.type_freq == 1),
                               interpret=True, bits2=jdata.bits2)
    return dict(freq=freq, rates=rates, z=z, q=q_new, alpha=alpha, gen=gen,
                zcounts=zcounts, loglik_indv=ll, loglik_total=ll.sum(),
                margin=jnp.abs(logu - ll_diff))


@pytest.mark.parametrize("type_freq", [1, 0])
def test_one_sweep_matches_jax_kernels(type_freq):
    n, l, k, c, j = 30, 90, 3, 2, 3
    jp = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=2,
                   selfing_rates=np.array([0.1, 0.4, 0.8]),
                   missing_rate=0.1, seed=21)
    jspec = JSpec(mode=2, n_pops=k, s_subsweeps=j, type_freq=type_freq)
    spec = ModelSpec(mode=2, n_pops=k, s_subsweeps=j, type_freq=type_freq)
    data = convert.dataset_from_numpy(_fields(jp.data))
    jstates = [jax_init_state(jax.random.key(40 + ci), jspec, jp.data)
               for ci in range(c)]
    stacked = {name: None if v is None else np.stack(
        [np.asarray(getattr(s, name)) for s in jstates])
        for name, v in jstates[0]._asdict().items()}
    state = convert.state_from_numpy(stacked, device="cpu")
    assert state.z.dtype == torch.int8 and state.z.shape == (c, n, 2 * l)
    one = convert.state_from_numpy(_fields(jstates[0]), device="cpu")
    assert torch.equal(one.q[0], state.q[0]) and one.q.shape == (1, n, k)

    rng = np.random.default_rng(8)
    nd, nu = n_test_draws(), j * k
    np_ = n + (-n % 128)

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, q_draws = unif(c, nd, k * 2, l), unif(c, nd, k, n)
    u = unif(c, n, 2 * l)
    planes = [[unif(1, 128), unif(1, 128), unif(1, np_), unif(1, np_)]
              for _ in range(c)]
    akeys = [jax.random.key(70 + ci) for ci in range(c)]
    want = [_jax_sweep(jspec, jp.data, jstates[ci], p_draws[ci], planes[ci],
                       u[ci], q_draws[ci], akeys[ci]) for ci in range(c)]

    adr = [_alpha_draws(kk) for kk in akeys]
    draws = StepDraws(
        p=_t(p_draws), z=_t(u), q=_t(q_draws),
        s=tuple(_t(np.stack([planes[ci][i][0, :m] for ci in range(c)]))
                for i, m in enumerate((nu, nu, n, n))),
        alpha=(_t(np.array([d[0] for d in adr])),
               _t(np.array([d[1] for d in adr]))))
    step = build_step(spec, data)
    keys = px.make_keys(0, c, "cpu")
    got = step(state, keys, 0, draws)

    for ci in range(c):
        w = want[ci]
        # the G accept compares f32 sums taken in another order: it may
        # differ only where the margin is within their rounding
        flipped = got.gen[ci].numpy() != np.asarray(w["gen"])
        assert (np.asarray(w["margin"])[flipped] < 1e-3).all()
        assert flipped.sum() <= 1
        np.testing.assert_array_equal(got.z[ci].numpy(), np.asarray(w["z"]))
        np.testing.assert_array_equal(got.zcounts[ci].numpy(),
                                      np.asarray(w["zcounts"]))
        np.testing.assert_allclose(got.rates[ci].numpy(),
                                   np.asarray(w["rates"]), rtol=1e-6)
        for name in ("freq", "q"):
            np.testing.assert_allclose(getattr(got, name)[ci].numpy(),
                                       np.asarray(w[name]), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        np.testing.assert_allclose(float(got.alpha[ci]), float(w["alpha"]),
                                   rtol=1e-5)
        if not flipped.any():
            np.testing.assert_allclose(got.loglik_indv[ci].numpy(),
                                       np.asarray(w["loglik_indv"]),
                                       rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(float(got.loglik_total[ci]),
                                       float(w["loglik_total"]), rtol=1e-5)
    # the sweep really moved the state, and the marginal log-lik fills
    assert not torch.equal(got.z, state.z)
    marg = build_marg_loglik(spec, data)(got)
    assert torch.isfinite(marg.loglik_marg).all()
    assert marg.loglik_marg.shape == (c, n)

    # with no injected draws the same sweep runs from Philox: reproducible
    # per (seed, step), and the carried counts stay those of z
    core, add_ll = build_step_parts(spec, data)
    a1 = core(core(state, keys, 0), keys, 1)
    a2 = core(core(state, keys, 0), keys, 1)
    assert torch.equal(a1.z, a2.z) and torch.equal(a1.rates, a2.rates)
    np.testing.assert_array_equal(
        a1.zcounts.numpy(), tup.allele_pop_counts(spec, data, a1.z).numpy())
    assert torch.isfinite(add_ll(a1).loglik_total).all()


# ---------------------------------------------------------------------------
# the slice, statistical: run_mcmc against the JAX run_mcmc
# ---------------------------------------------------------------------------

def _structure_way_panel(n, l, k, s_rates, alpha, seed):
    """Data from the exact structure-way model: selfing collapse applied
    only at same-z het sites (the generator of the JAX package's
    ``test_structure_way_generator_recovery``)."""
    rng = np.random.default_rng(seed)
    freq = rng.dirichlet(np.ones(2), size=(k, l))
    q = rng.dirichlet(np.full(k, alpha), size=n)
    sbar = q @ np.asarray(s_rates)
    gen = np.minimum(rng.geometric(np.clip(1.0 - sbar, 1e-9, 1.0)), 50)
    geno = np.zeros((n, l, 2), np.int32)
    for i in range(n):
        z = rng.choice(k, size=(l, 2), p=q[i])
        a = np.zeros((l, 2), np.int64)
        for c in range(2):
            pf = freq[z[:, c], np.arange(l)]
            a[:, c] = (rng.random(l)[:, None] > pf.cumsum(1)).sum(1)
        same = z[:, 0] == z[:, 1]
        p_surv = 0.5 ** (gen[i] - 1)
        collapse = same & (rng.random(l) > p_surv)
        pick = rng.integers(0, 2, l)
        a[collapse, 0] = a[collapse, pick[collapse]]
        a[collapse, 1] = a[collapse, 0]
        geno[i] = a
    return geno, np.zeros((n, l), bool), np.full(l, 2, np.int32)


def test_run_mcmc_recovers_the_selfing_rates_like_jax():
    """The port runs the fused order "Z, then G | z" and the JAX XLA path
    the reference order "G, then Z", so this check is statistical by
    design; the exact checks are the injected-uniform ones above."""
    geno, miss, n_alleles = _structure_way_panel(100, 100, 2, [0.1, 0.8],
                                                 0.2, seed=1)
    kw = dict(n_iter=3000, burnin=1500, thinning=5, n_chains=2, ckrep=100,
              nstep_check_empty_cluster=20)
    jres = jax_run_mcmc(jax_make_dataset(geno, miss, n_alleles),
                        JSpec(mode=2, n_pops=2, use_pallas=False),
                        JSchedule(**kw), jax.random.key(0))
    res = run_mcmc(make_dataset(geno, miss, n_alleles),
                   ModelSpec(mode=2, n_pops=2), Schedule(**kw), 0,
                   track_freq=True, device="cpu")
    s_jax = np.sort(np.asarray(jres.accum.mean.rates), -1).mean(0)
    s = np.sort(res.accum.mean.rates.numpy(), -1).mean(0)
    np.testing.assert_allclose(s, [0.1, 0.8], atol=0.1)
    np.testing.assert_allclose(s, s_jax, atol=0.1)
    assert res.accum.count.tolist() == [300, 300]
    rhat = float(tdiag.gelman_rubin(res.accum.convg_ld.numpy()))
    assert np.isfinite(rhat)
    # the information criteria are finite and of the JAX run's size
    assert np.isfinite(res.dic()).all() and np.isfinite(res.waic()).all()
    assert (res.p_d() > 0).all()
    np.testing.assert_allclose(res.dic_reference().mean(),
                               jres.dic_reference().mean(), rtol=0.02)
    np.testing.assert_allclose(res.waic().mean(), jres.waic().mean(),
                               rtol=0.02)
