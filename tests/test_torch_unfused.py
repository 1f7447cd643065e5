"""The port's unfused sweep ("G or F, then Z"), mode 0, the normal prior and
the adaptive-independence proposal against the JAX package, on the CPU.

Update by update on the same arrays (made with numpy from a seed), each fed
the uniforms that the JAX function draws from its key; then one whole unfused
sweep of each mode 0-5 against the same composition of JAX functions that
``instruct_tpu/mcmc/step.py:421-475`` makes with ``use_pallas=False``; then
mode 0 and the unfused mode 2 as a whole, statistically.

Tolerances: discrete draws (z, accepts, states, proposed generations) are
compared exactly, apart from an accept whose f32 log-ratio sits within 1e-3
of its threshold (the two packages sum over N or L in another order); floats
at rtol 1e-5; the draws that are another function of the uniforms in the two
packages (mode 0's z, the normal prior's hyper draw) by their frequencies
and moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Priors as JPriors
from instruct_tpu.config import PriorFamily as JFamily
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.mcmc.state import init_state as jax_init_state
from instruct_tpu.model import likelihood as jlk

from instruct_tpu_torch import (ModelSpec, Priors, Schedule, run_mcmc,
                                synthetic_panel)
from instruct_tpu_torch import convert
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.dirichlet import n_test_draws
from instruct_tpu_torch.mcmc import updates as tup
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import (StepDraws, build_marg_loglik,
                                          build_step, build_step_parts,
                                          use_fused)
from instruct_tpu_torch.model import likelihood as tlk

EPS = 1e-30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def _panel(n, l, k, a, seed=21):
    jp = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=a,
                   selfing_rates=np.linspace(0.1, 0.8, k), missing_rate=0.1,
                   seed=seed)
    return jp.data, convert.dataset_from_numpy(_fields(jp.data))


def _stack_states(jstates):
    return {name: None if v is None else np.stack(
        [np.asarray(getattr(s, name)) for s in jstates])
        for name, v in jstates[0]._asdict().items()}


def _unif(key, shape, minval=0.0, maxval=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=minval,
                                         maxval=maxval))


def _arrays(n, l, k, a, c, seed):
    rng = np.random.default_rng(seed)
    freq = rng.dirichlet(np.ones(a), size=(c, k, l)).astype(np.float32)
    q = rng.dirichlet(np.full(k, 0.5), size=(c, n)).astype(np.float32)
    z = rng.integers(0, k, size=(c, n, 2 * l)).astype(np.int8)
    gen = rng.integers(1, 9, size=(c, n)).astype(np.int32)
    return rng, freq, q, z, gen


# ---------------------------------------------------------------------------
# mode 0's matrix and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_alleles", [2, 5])
def test_mode0_matrix_and_counts_match_jax(n_alleles):
    n, l, k, c = 19, 37, 3, 2
    jdata, data = _panel(n, l, k, n_alleles, seed=5)
    rng, freq, _, _, _ = _arrays(n, l, k, n_alleles, c, 1)
    freq[0, 1, 3, 0] = 0.0                   # log of an underflowed draw
    zz = rng.integers(0, k, size=(c, n)).astype(np.int32)
    np.testing.assert_array_equal(
        tlk.allele_count_matrix(data).numpy(),
        np.asarray(jlk.allele_count_matrix(jdata)))
    got = tlk.loglik_matrix_nopop_admix(data, _t(freq)).numpy()
    spec, jspec = ModelSpec(mode=0, n_pops=k), JSpec(mode=0, n_pops=k)
    counts = tup.allele_pop_counts(spec, data, None, _t(zz)).numpy()
    for ci in range(c):
        want = jlk.loglik_matrix_nopop_admix(jdata, jnp.asarray(freq[ci]))
        np.testing.assert_allclose(got[ci], np.asarray(want), rtol=1e-5)
        np.testing.assert_array_equal(
            counts[ci], np.asarray(jup.allele_pop_counts(
                jspec, jdata, None, jnp.asarray(zz[ci]))))
    assert counts.sum() == c * 2 * float(data.site_valid.sum())


def test_update_z_noadmix_draws_the_conditional():
    """Inverse CDF on the normalised weights: the frequencies of the draw
    over many uniforms are the softmax of the log-lik matrix (the JAX
    function draws the same distribution by Gumbel-argmax)."""
    n, l, k, reps = 6, 4, 3, 4000
    jdata, data = _panel(n, l, k, 2, seed=2)
    rng = np.random.default_rng(0)
    freq = rng.dirichlet(np.ones(2) * 3, size=(1, k, l)).astype(np.float32)
    ll = np.asarray(jlk.loglik_matrix_nopop_admix(jdata,
                                                  jnp.asarray(freq[0])))
    want = np.exp(ll - ll.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    u = _t(rng.uniform(0, 1, (reps, n)).astype(np.float32))
    zz = tup.update_z_noadmix(u, data, _t(freq).expand(reps, k, l, 2))
    assert zz.dtype == torch.int32 and zz.shape == (reps, n)
    emp = np.stack([(zz.numpy() == kk).mean(0) for kk in range(k)], 1)
    np.testing.assert_allclose(emp, want, atol=0.03)
    jz = jax.vmap(lambda kk: jup.update_z_noadmix(
        kk, jdata, jnp.asarray(freq[0])))(jax.random.split(
            jax.random.key(1), reps))
    jemp = np.stack([(np.asarray(jz) == kk).mean(0) for kk in range(k)], 1)
    np.testing.assert_allclose(emp, jemp, atol=0.04)


# ---------------------------------------------------------------------------
# the unfused updates, each with the uniforms JAX draws from its key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n_alleles", [(3, 2), (9, 10)])
def test_update_zq_matches_jax(k, n_alleles):
    n, l, c = 14, 22, 2
    jdata, data = _panel(n, l, k, n_alleles, seed=4)
    _, freq, q, _, _ = _arrays(n, l, k, n_alleles, c, 2)
    spec, jspec = (ModelSpec(mode=1, n_pops=k, use_pallas=False),
                   JSpec(mode=1, n_pops=k, use_pallas=False))
    alpha = np.array([0.7, 2.0], np.float32)
    jkeys = [jax.random.key(30 + ci) for ci in range(c)]
    u = np.stack([_unif(jax.random.split(kk)[0], (n, 2 * l))
                  for kk in jkeys])
    z, q_new, qqnum = tup.update_zq(px.make_keys(0, c, "cpu"), 0, spec, data,
                                    _t(freq), _t(q), _t(alpha), u=_t(u))
    for ci in range(c):
        jz, jq, jqq = jup.update_zq(jkeys[ci], jspec, jdata,
                                    jnp.asarray(freq[ci]), jnp.asarray(q[ci]),
                                    jnp.asarray(alpha[ci]))
        np.testing.assert_array_equal(z[ci].numpy(), np.asarray(jz))
        np.testing.assert_array_equal(qqnum[ci].numpy(), np.asarray(jqq))
    # Q is a Dirichlet draw of (counts + alpha): rows on the simplex
    np.testing.assert_allclose(q_new.sum(-1).numpy(), 1.0, atol=1e-5)
    assert q_new.shape == (c, n, k)


@pytest.mark.parametrize("n_alleles", [2, 4])
@pytest.mark.parametrize("mode,type_freq", [(2, 1), (3, 1), (2, 0)])
def test_update_gen_matches_jax(mode, type_freq, n_alleles):
    n, l, k, c = 23, 41, 3, 2
    jdata, data = _panel(n, l, k, n_alleles, seed=9)
    rng, freq, q, z, gen = _arrays(n, l, k, n_alleles, c, 3)
    spec = ModelSpec(mode=mode, n_pops=k, type_freq=type_freq)
    jspec = JSpec(mode=mode, n_pops=k, type_freq=type_freq)
    rates = rng.uniform(0.05, 0.95, (c, spec.n_rates(n))).astype(np.float32)
    jkeys = [jax.random.key(60 + ci) for ci in range(c)]
    ug = np.stack([_unif(jax.random.split(kk)[0], (n,), 1e-12, 1.0)
                   for kk in jkeys])
    ua = np.stack([_unif(jax.random.split(kk)[1], (n,), EPS)
                   for kk in jkeys])
    got = tup.update_gen(_t(ug), _t(ua), spec, data, _t(freq), _t(z), _t(q),
                         _t(rates), _t(gen))
    assert got.dtype == torch.int32
    for ci in range(c):
        args = (jdata, jnp.asarray(freq[ci]), jnp.asarray(z[ci]),
                jnp.asarray(q[ci]), jnp.asarray(rates[ci]),
                jnp.asarray(gen[ci]))
        want = np.asarray(jup.update_gen(jkeys[ci], jspec, *args))
        off = got[ci].numpy() != want
        assert off.mean() <= 0.05, off.sum()
        assert (want != gen[ci]).any() and (want == gen[ci]).any()
    # the proposal alone is exact
    sbar = tup.mix_rates(_t(q), _t(rates)) if mode == 2 else _t(rates)
    prop = tup.sample_geometric(_t(ug), sbar, spec.gen_cap)
    jsbar = jnp.asarray(q[0]) @ jnp.asarray(rates[0]) if mode == 2 \
        else jnp.asarray(rates[0])
    jprop = jup.sample_geometric(jax.random.split(jkeys[0])[0], jsbar,
                                 jspec.gen_cap)
    assert (prop[0].numpy() != np.asarray(jprop)).mean() <= 0.05


def _s_pop_draws(key, k, adaptive):
    """(u_prop, u_acc, u_fresh) f32[K] as ``jup.update_s_pop`` draws them
    from ``key``."""
    kacc, kprop = jax.random.split(key)
    u_acc = np.array([_unif(kk, (), EPS) for kk in jax.random.split(kacc, k)])
    if not adaptive:
        return _unif(kprop, (k,)), u_acc, None
    ku, kv = jax.random.split(kprop)
    return _unif(ku, (k,)), u_acc, _unif(kv, (k,))


@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("back_refl", [1, 0])
def test_update_s_pop_matches_jax(back_refl, k):
    n, c, j = 40, 3, 3
    rng = np.random.default_rng(k + back_refl)
    q = rng.dirichlet(np.full(k, 0.4), size=(c, n)).astype(np.float32)
    gen = rng.integers(1, 7, size=(c, n)).astype(np.int32)
    rates = rng.uniform(0.05, 0.95, (c, k)).astype(np.float32)
    rates[0, 0], rates[1, 1] = 0.0, 1.0          # the boundary states
    ais = np.where(rates <= 1e-3, 0, np.where(rates >= 1 - 1e-3, 2, 1)
                   ).astype(np.int32)
    spec = ModelSpec(mode=2, n_pops=k, back_refl=back_refl)
    jspec = JSpec(mode=2, n_pops=k, back_refl=back_refl)
    adaptive = back_refl == 0
    ks = [jax.random.key(80 + ci) for ci in range(c)]
    want_r, want_a, dr = [], [], []
    for ci in range(c):
        r, a = jnp.asarray(rates[ci]), jnp.asarray(ais[ci])
        per = []
        for jj in range(j):                       # _s_subsweeps_pop
            kj = jax.random.fold_in(ks[ci], jj)
            per.append(_s_pop_draws(kj, k, adaptive))
            r, a = jup.update_s_pop(kj, jspec, jnp.asarray(q[ci]),
                                    jnp.asarray(gen[ci]), r, a)
        want_r.append(np.asarray(r))
        want_a.append(np.asarray(a))
        dr.append(per)

    def plane(i):
        return _t(np.array([[d[i] for d in per] for per in dr], np.float32))

    got_r, got_a = tup.update_s_pop(
        plane(0), plane(1), spec, _t(q), _t(gen), _t(rates), _t(ais),
        plane(2) if adaptive else None)
    np.testing.assert_allclose(got_r.numpy(), np.stack(want_r), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got_a.numpy(), np.stack(want_a))
    assert (got_r.numpy() != rates).any()
    if adaptive:
        assert (got_a.numpy() != ais).any()


def test_propose_adaptive_independence_matches_jax():
    rng = np.random.default_rng(4)
    shape = (5, 40)
    rates = rng.uniform(0, 1, shape).astype(np.float32)
    state = rng.integers(0, 3, shape).astype(np.int32)
    rates = np.where(state == 0, 0.0, np.where(state == 2, 1.0, rates)
                     ).astype(np.float32)
    key = jax.random.key(3)
    ku, kv = jax.random.split(key)
    u, fresh = _unif(ku, shape).copy(), _unif(kv, shape)
    u[0, :4] = [0.05, 0.95, 0.5, 0.049]          # the thresholds themselves
    # the JAX function at the same uniforms
    want = jup.propose_adaptive_independence(key, jnp.asarray(rates),
                                             jnp.asarray(state))
    u_j = _unif(ku, shape)
    got = tup.propose_adaptive_independence(_t(u_j), _t(fresh), _t(rates),
                                            _t(state))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert got[1].dtype == torch.int32
    # log q(prev | new) - log q(new | prev), the clamp at 1e-30 included
    new_r, new_s, lh = tup.propose_adaptive_independence(
        _t(u), _t(fresh), _t(rates), _t(state))
    assert set(np.unique(new_s.numpy())) <= {0, 1, 2}
    assert ((new_r.numpy() == 0.0) == (new_s.numpy() == 0)).all()
    lh = lh.numpy()
    np.testing.assert_allclose(lh[(state == 1) & (new_s.numpy() == 0)],
                               np.log(0.5) - np.log(0.05), rtol=1e-6)
    np.testing.assert_allclose(lh[(state == 0) & (new_s.numpy() == 0)], 0.0)


@pytest.mark.parametrize("mode", [3, 5])
def test_individual_updates_with_the_normal_prior_match_jax(mode):
    n, l, k, c = 23, 41, 3, 2
    jdata, data = _panel(n, l, k, 2, seed=9)
    rng, freq, _, z, gen = _arrays(n, l, k, 2, c, 3)
    spec = ModelSpec(mode=mode, n_pops=k, priors=Priors(family=PriorFamily.NORMAL))
    jspec = JSpec(mode=mode, n_pops=k, priors=JPriors(family=JFamily.NORMAL))
    rates = rng.uniform(0.05, 0.95, (c, n)).astype(np.float32)
    mu = np.array([0.3, 0.6], np.float32)
    s2 = np.array([0.002, 0.05], np.float32)     # a prior that bites
    jkeys = [jax.random.key(50 + ci) for ci in range(c)]
    dr = [(_unif(kp, (n,)), _unif(ku, (n,), EPS))
          for kp, ku in (jax.random.split(kk) for kk in jkeys)]
    u_prop = _t(np.stack([d[0] for d in dr]))
    u_acc = _t(np.stack([d[1] for d in dr]))
    if mode == 3:
        got = tup.update_s_ind(u_prop[:, None], u_acc[:, None], spec,
                               _t(gen), _t(rates), _t(mu), _t(s2))
        flat = tup.update_s_ind(u_prop[:, None], u_acc[:, None], spec,
                                _t(gen), _t(rates))
        want = [jup.update_s_ind(jkeys[ci], jspec, jnp.asarray(gen[ci]),
                                 jnp.asarray(rates[ci]), jnp.asarray(mu[ci]),
                                 jnp.asarray(s2[ci])) for ci in range(c)]
    else:
        args = (spec, data, _t(freq), _t(z), _t(rates))
        got = tup.update_f_ind(u_prop, u_acc, *args, _t(mu), _t(s2))
        flat = tup.update_f_ind(u_prop, u_acc, *args)
        want = [jup.update_f_ind(jkeys[ci], jspec, jdata,
                                 jnp.asarray(freq[ci]), jnp.asarray(z[ci]),
                                 jnp.asarray(rates[ci]), jnp.asarray(mu[ci]),
                                 jnp.asarray(s2[ci])) for ci in range(c)]
    want = np.stack([np.asarray(w) for w in want])
    off = ~np.isclose(got.numpy(), want, rtol=1e-6)
    assert off.mean() <= 0.02, off.sum()
    # the prior terms decide some accepts
    assert not torch.equal(got, flat)


@pytest.mark.parametrize("n_alleles", [2, 4])
def test_update_f_pop_adaptive_matches_jax(n_alleles):
    n, l, k, c = 23, 41, 3, 4
    jdata, data = _panel(n, l, k, n_alleles, seed=9)
    rng, freq, _, z, _ = _arrays(n, l, k, n_alleles, c, 6)
    spec = ModelSpec(mode=4, n_pops=k, back_refl=0)
    jspec = JSpec(mode=4, n_pops=k, back_refl=0)
    rates = rng.uniform(0.05, 0.95, (c, k)).astype(np.float32)
    rates[0, 0], rates[1, 2] = 0.0, 1.0
    ais = np.where(rates <= 1e-3, 0, np.where(rates >= 1 - 1e-3, 2, 1)
                   ).astype(np.int32)
    jkeys = [jax.random.key(90 + ci) for ci in range(c)]
    planes = []
    for kk in jkeys:
        ku, kv = jax.random.split(jax.random.fold_in(kk, 0))
        planes.append((_unif(ku, (k,)), _unif(kk, (k,), EPS),
                       _unif(kv, (k,))))
    u_prop, u_acc, fresh = (_t(np.stack([p[i] for p in planes]))
                            for i in range(3))
    got_r, got_a = tup.update_f_pop(u_prop, u_acc, spec, data, _t(freq),
                                    _t(z), _t(rates), _t(ais), fresh)
    for ci in range(c):
        wr, wa = jup.update_f_pop(jkeys[ci], jspec, jdata,
                                  jnp.asarray(freq[ci]), jnp.asarray(z[ci]),
                                  jnp.asarray(rates[ci]),
                                  jnp.asarray(ais[ci]))
        np.testing.assert_allclose(got_r[ci].numpy(), np.asarray(wr),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got_a[ci].numpy(), np.asarray(wa))
    assert got_a.dtype == torch.int32


def test_update_normal_hyper_moments_match_jax():
    """The port's gamma is the fixed-round sampler on Philox words, the JAX
    package's is ``jax.random.gamma``: another function of the uniforms, the
    same conjugate law.  Means to 2% and spreads to 10% over 6000 draws."""
    reps, n = 6000, 30
    rng = np.random.default_rng(2)
    rates = rng.beta(2, 5, n).astype(np.float32)
    pri, jpri = Priors(normal_mu0=0.4), JPriors(normal_mu0=0.4)
    u = px.u01_open(px.random_words(px.make_keys(5, reps, "cpu"), 0,
                                    px.STREAM_HYPER, tup.n_hyper_draws()))
    assert u.shape == (reps, n_test_draws() + 2)
    mu, s2 = tup.update_normal_hyper(u, _t(rates).expand(reps, n), pri)
    jmu, js2 = jax.vmap(lambda kk: jup.update_normal_hyper(
        kk, jnp.asarray(rates), jpri))(jax.random.split(jax.random.key(0),
                                                        reps))
    for got, want in ((mu, jmu), (s2, js2)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=0.02)
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.1)
    # and the closed forms: E[sigma^2] = sigmasqr_n / (nu_n - 2)
    ave, nu_n = rates.mean(), pri.normal_nu0 + n
    ssq = (pri.normal_nu0 * pri.normal_sigmasqr0
           + pri.normal_kappa0 * (ave - pri.normal_mu0) ** 2
           + ((ave - rates) ** 2).sum())
    np.testing.assert_allclose(s2.numpy().mean(), ssq / (nu_n - 2), rtol=0.02)
    mu_n = (pri.normal_kappa0 * pri.normal_mu0 + n * ave) / (
        pri.normal_kappa0 + n)
    np.testing.assert_allclose(mu.numpy().mean(), mu_n, rtol=0.01)


# ---------------------------------------------------------------------------
# one whole unfused sweep of each mode with injected draws
# ---------------------------------------------------------------------------

def _alpha_draws(key):
    ku, ka = jax.random.split(key)
    return (np.asarray(jax.random.normal(ka), np.float32),
            np.asarray(jax.random.uniform(ku, minval=1e-30), np.float32))


def _jax_unfused_sweep(jspec, jdata, st, p_draws, q_draws, ks, kg, kz, ka):
    """One sweep of ``instruct_tpu/mcmc/step.py:421-475`` and ``_cal_lkh``
    (modes 1-5) from the JAX update functions with explicit keys.  The two
    Dirichlet draws go through the JAX Dirichlet kernel with explicit
    uniforms (the JAX step draws them with ``jax.random.gamma``, which takes
    none).  Also returns the S/F/G uniforms as the port takes them."""
    mode, k, l = jspec.mode, jspec.n_pops, jdata.n_loci
    a = jdata.allele_valid.shape[1]
    n = jdata.geno.shape[0]
    j = max(1, jspec.s_subsweeps)
    counts = jup.allele_pop_counts(jspec, jdata, st.z, st.zz)
    rows = jnp.transpose(counts + 1.0, (0, 2, 1)).reshape(k * a, l)
    freq = jdp.dirichlet_rows(0, rows, jnp.tile(jdata.allele_valid.T, (k, 1)),
                              rows_per_group=a, interpret=True,
                              test_draws=jnp.asarray(p_draws)
                              ).reshape(k, a, l).transpose(0, 2, 1)
    rates, gen, tail = st.rates, st.gen, None
    if mode == 2:
        per, ais = [], st.ais_state
        for jj in range(j):
            kj = jax.random.fold_in(ks, jj)
            per.append(_s_pop_draws(kj, k, False))
            rates, ais = jup.update_s_pop(kj, jspec, st.q, st.gen, rates, ais)
        tail = [np.stack([p[0] for p in per]).reshape(-1),
                np.stack([p[1] for p in per]).reshape(-1)]
    elif mode == 3:
        u_prop, u_acc = [], []
        for jj in range(j):
            kj = jax.random.fold_in(ks, jj)
            kp, ku = jax.random.split(kj)
            u_prop.append(_unif(kp, (n,)))
            u_acc.append(_unif(ku, (n,), EPS))
            rates = jup.update_s_ind(kj, jspec, st.gen, rates)
        tail = [np.stack(u_prop), np.stack(u_acc)]
    elif mode == 4:
        rates, _ = jup.update_f_pop(ks, jspec, jdata, freq, st.z, st.rates,
                                    st.ais_state)
        tail = [_unif(jax.random.fold_in(ks, 0), (k,)),
                _unif(ks, (k,), EPS)]
    elif mode == 5:
        rates = jup.update_f_ind(ks, jspec, jdata, freq, st.z, st.rates)
        kp, ku = jax.random.split(ks)
        tail = [_unif(kp, (n,)), _unif(ku, (n,), EPS)]
    if jspec.has_selfing:
        gen = jup.update_gen(kg, jspec, jdata, freq, st.z, st.q, rates,
                             st.gen)
        kgg, kgu = jax.random.split(kg)
        tail += [_unif(kgg, (n,), 1e-12, 1.0), _unif(kgu, (n,), EPS)]
    z, _, qqnum = jup.update_zq(kz, jspec, jdata, freq, st.q, st.alpha)
    q_new = jdp.dirichlet_rows(0, (qqnum + st.alpha).T, rows_per_group=k,
                               interpret=True,
                               test_draws=jnp.asarray(q_draws)).T
    alpha = jup.update_alpha(ka, jspec, q_new, st.alpha)
    ll = jlk.per_indv_loglik(jspec, jdata, freq, z, q_new,
                             gen if jspec.has_selfing else None,
                             rates if rates.size else None)
    out = dict(freq=freq, rates=rates, gen=gen, z=z, q=q_new, alpha=alpha,
               loglik_indv=ll)
    return out, tail, _unif(jax.random.split(kz)[0], (n, 2 * l))


@pytest.mark.parametrize("n_alleles", [2, 4])
@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
def test_one_unfused_sweep_matches_jax_updates_per_mode(mode, n_alleles):
    n, l, k, c, j, a = 26, 70, 3, 2, 2, n_alleles
    jdata, data = _panel(n, l, k, a)
    jspec = JSpec(mode=mode, n_pops=k, s_subsweeps=j, use_pallas=False)
    spec = ModelSpec(mode=mode, n_pops=k, s_subsweeps=j, use_pallas=False)
    assert not use_fused(spec, data)
    jstates = [jax_init_state(jax.random.key(40 + ci), jspec, jdata)
               for ci in range(c)]
    state = convert.state_from_numpy(_stack_states(jstates), device="cpu")
    rng = np.random.default_rng(8 + mode)
    nd = n_test_draws()

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, q_draws = unif(c, nd, k * a, l), unif(c, nd, k, n)
    ukeys = [jax.random.split(jax.random.key(70 + ci), 4) for ci in range(c)]
    res = [_jax_unfused_sweep(jspec, jdata, jstates[ci], p_draws[ci],
                              q_draws[ci], *ukeys[ci]) for ci in range(c)]
    adr = [_alpha_draws(kk[3]) for kk in ukeys]
    tail = None
    if mode != 1:
        tail = tuple(_t(np.stack([r[1][i] for r in res]).astype(np.float32))
                     for i in range(len(res[0][1])))
    draws = StepDraws(p=_t(p_draws), q=_t(q_draws), s=tail,
                      z=_t(np.stack([r[2] for r in res])),
                      alpha=(_t(np.array([d[0] for d in adr])),
                             _t(np.array([d[1] for d in adr]))))
    keys = px.make_keys(0, c, "cpu")
    got = build_step(spec, data)(state, keys, 0, draws)

    for ci in range(c):
        w = res[ci][0]
        np.testing.assert_allclose(got.freq[ci].numpy(),
                                   np.asarray(w["freq"]), rtol=1e-5,
                                   atol=1e-7)
        # the G accept compares f32 sums over L taken in another order: a
        # flipped individual is tolerated (at most one per chain)
        flips = 0
        if mode in (2, 3):
            flips = int((got.gen[ci].numpy() != np.asarray(w["gen"])).sum())
            assert flips <= 1
        if mode != 1:
            np.testing.assert_allclose(got.rates[ci].numpy(),
                                       np.asarray(w["rates"]), rtol=1e-5,
                                       atol=1e-7)
        # z is drawn from (q, freq) of before the sweep's Q update: exact
        # wherever freq agrees to the last bit; a last-bit difference in a
        # frequency may move a draw that sits on its threshold
        zoff = (got.z[ci].numpy() != np.asarray(w["z"])).mean()
        assert zoff <= 2e-3, zoff
        if zoff == 0 and flips == 0:
            np.testing.assert_allclose(got.q[ci].numpy(), np.asarray(w["q"]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(float(got.alpha[ci]),
                                       float(w["alpha"]), rtol=1e-5)
            np.testing.assert_allclose(got.loglik_indv[ci].numpy(),
                                       np.asarray(w["loglik_indv"]),
                                       rtol=1e-5, atol=1e-4)
    assert not torch.equal(got.z, state.z)
    np.testing.assert_allclose(got.loglik_total.numpy(),
                               got.loglik_indv.sum(-1).numpy(), rtol=1e-6)
    marg = build_marg_loglik(spec, data)(got)
    assert torch.isfinite(marg.loglik_marg).all()

    # with no injected draws the same sweep runs from Philox: reproducible
    # per (seed, step)
    core, add_ll = build_step_parts(spec, data)
    a1 = core(core(state, keys, 0), keys, 1)
    a2 = core(core(state, keys, 0), keys, 1)
    for x, y in zip(a1, a2):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.isfinite(add_ll(a1).loglik_total).all()
    if mode != 1:
        assert not torch.equal(a1.rates, state.rates)


@pytest.mark.parametrize("n_alleles", [2, 4])
def test_one_unfused_sweep_mode0_matches_jax(n_alleles):
    n, l, k, c, a = 26, 70, 3, 2, n_alleles
    jdata, data = _panel(n, l, k, a)
    jspec, spec = JSpec(mode=0, n_pops=k), ModelSpec(mode=0, n_pops=k)
    jstates = [jax_init_state(jax.random.key(40 + ci), jspec, jdata)
               for ci in range(c)]
    state = convert.state_from_numpy(_stack_states(jstates), device="cpu")
    assert state.zz.shape == (c, n) and state.z.shape == (c, 0, 0)
    assert state.q.shape == (c, 0, 0) and state.zcounts is None
    rng = np.random.default_rng(3)
    p_draws = rng.uniform(1e-4, 1 - 1e-4, (c, n_test_draws(), k * a, l)
                          ).astype(np.float32)
    u = rng.uniform(0, 1, (c, n)).astype(np.float32)
    got = build_step(spec, data)(state, px.make_keys(0, c, "cpu"), 0,
                                 StepDraws(p=_t(p_draws), zz=_t(u)))
    for ci in range(c):
        st = jstates[ci]
        counts = jup.allele_pop_counts(jspec, jdata, st.z, st.zz)
        rows = jnp.transpose(counts + 1.0, (0, 2, 1)).reshape(k * a, l)
        freq = jdp.dirichlet_rows(
            0, rows, jnp.tile(jdata.allele_valid.T, (k, 1)),
            rows_per_group=a, interpret=True,
            test_draws=jnp.asarray(p_draws[ci])
        ).reshape(k, a, l).transpose(0, 2, 1)
        np.testing.assert_allclose(got.freq[ci].numpy(), np.asarray(freq),
                                   rtol=1e-5, atol=1e-7)
        # the z draw by inverse CDF on the JAX package's log-lik matrix
        ll = np.asarray(jlk.loglik_matrix_nopop_admix(jdata, freq),
                        np.float64)
        w = np.exp(ll - ll.max(1, keepdims=True))
        cum = np.cumsum(w, 1)
        ut = u[ci][:, None] * cum[:, -1:]
        want = (ut > cum[:, :-1]).sum(1)
        margin = np.abs(ut - cum[:, :-1]).min(1) / cum[:, -1]
        off = got.zz[ci].numpy() != want
        assert (margin[off] < 1e-4).all()
        # cal_lkh at the drawn z
        np.testing.assert_allclose(
            got.loglik_indv[ci].numpy(),
            ll[np.arange(n), got.zz[ci].numpy()], rtol=1e-5)
    assert got.zz.dtype == torch.int32 and got.alpha.tolist() == [0.0, 0.0]
    # the uniform mixture over the pops: within log K below the best pop
    marg = build_marg_loglik(spec, data)(got).loglik_marg
    best = tlk.loglik_matrix_nopop_admix(data, got.freq).max(-1).values
    assert (marg <= best + 1e-3).all()
    assert (marg >= best - np.log(k) - 1e-3).all()


@pytest.mark.parametrize("kwargs", [
    dict(mode=0), dict(mode=3, priors="normal"), dict(mode=5, priors="normal"),
    dict(mode=2, back_refl=0), dict(mode=4, back_refl=0)])
def test_convert_round_trip_of_the_new_states(kwargs):
    """A mode-0 state (zz, empty z and q, no zcounts), a normal-prior state
    (moved hyperparameters) and an adaptive-sampler state (moved 3-state
    flags) go across from the JAX package and back unchanged, and through
    numpy after a sweep of the port."""
    n, l, k, c = 11, 17, 2, 3
    jdata, data = _panel(n, l, k, 2)
    kw, jkw = dict(kwargs), dict(kwargs)
    if "priors" in kwargs:
        kw["priors"] = Priors(family=PriorFamily.NORMAL)
        jkw["priors"] = JPriors(family=JFamily.NORMAL)
    spec, jspec = ModelSpec(n_pops=k, **kw), JSpec(n_pops=k, **jkw)
    jstates = [jax_init_state(jax.random.key(i), jspec, jdata)
               for i in range(c)]
    for fields in (_fields(jstates[0]), _stack_states(jstates)):
        over = convert.state_from_numpy(fields, device="cpu")
        out = convert.state_to_numpy(over)
        stacked = np.asarray(fields["q"]).ndim == 3
        assert over.freq.shape[0] == (c if stacked else 1)
        for name, v in fields.items():
            if v is None:
                assert out[name] is None, name
            else:
                np.testing.assert_array_equal(
                    out[name] if stacked else out[name][0], v, err_msg=name)
    keys = px.make_keys(1, c, "cpu")
    moved = build_step(spec, data)(over, keys, 0)
    moved = build_step(spec, data)(moved, keys, 1)
    back = convert.state_from_numpy(convert.state_to_numpy(moved), "cpu")
    for name, v in moved._asdict().items():
        got = getattr(back, name)
        if v is None:
            assert got is None, name
        else:
            assert got.dtype == v.dtype and torch.equal(got, v), name
    own = init_state(3, spec, data, c, device="cpu")
    for name, v in over._asdict().items():
        w = getattr(own, name)
        assert (v is None) == (w is None), name
        if v is not None:
            assert v.shape == w.shape and v.dtype == w.dtype, name
    if "priors" in kwargs:
        assert not torch.equal(moved.prior_mu, over.prior_mu)
    if "back_refl" in kwargs:
        assert moved.ais_state.dtype == torch.int32
    if spec.mode == 0:
        assert moved.zz.shape == (c, n) and moved.zcounts is None


# ---------------------------------------------------------------------------
# whole runs, statistically
# ---------------------------------------------------------------------------

def test_mode0_recovers_the_labels_of_a_separated_panel():
    panel = synthetic_panel(60, 80, n_pops=3, n_alleles=4,
                            selfing_rates=np.zeros(3), admixture_alpha=0.01,
                            seed=6)
    sched = Schedule(n_iter=300, burnin=150, thinning=5, n_chains=2, ckrep=10,
                     nstep_check_empty_cluster=10)
    res = run_mcmc(panel.data, ModelSpec(mode=0, n_pops=3), sched, 1,
                   track_freq=True, device="cpu")
    assert res.accum.count.tolist() == [30, 30]
    assert not res.accum.empty_cluster.any()        # never latched in mode 0
    truth = panel.pop_index
    for ci in range(2):
        label = res.final_state.zz[ci].numpy()
        # up to a relabelling: each true pop maps onto one label
        table = np.array([[np.sum((truth == t) & (label == g))
                           for g in range(3)] for t in range(3)])
        assert table.max(1).sum() >= 58, table
        assert len(set(table.argmax(1))) == 3
        # the stored mean Q is the frequency of each label: rows sum to 1
        np.testing.assert_allclose(res.accum.mean.q[ci].sum(-1).numpy(), 1.0,
                                   atol=1e-5)
    assert np.isfinite(res.dic()).all() and np.isfinite(res.waic()).all()
    assert res.plugin_ll is not None and np.isfinite(res.plugin_ll).all()


def test_unfused_mode2_recovers_s_like_the_fused_sweep():
    """The two sweeps draw different trajectories of one invariant
    distribution: posterior-mean S of the two pops within 0.12 of each
    other and on the right side of the truth [0.1, 0.8]."""
    panel = synthetic_panel(100, 100, n_pops=2, n_alleles=2,
                            selfing_rates=np.array([0.1, 0.8]), seed=1)
    sched = Schedule(n_iter=1200, burnin=600, thinning=5, n_chains=2,
                     ckrep=100, nstep_check_empty_cluster=20)
    out = {}
    for sweep in (None, False):
        spec = ModelSpec(mode=2, n_pops=2, s_subsweeps=4, use_pallas=sweep)
        assert use_fused(spec, panel.data) == (sweep is None)
        res = run_mcmc(panel.data, spec, sched, 0, device="cpu")
        out[sweep] = np.sort(res.accum.mean.rates.numpy(), -1).mean(0)
        assert np.isfinite(res.dic_reference()).all()
    for s in out.values():
        assert s[0] < 0.35 < s[1]
    np.testing.assert_allclose(out[False], out[None], atol=0.12)
