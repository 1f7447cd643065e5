"""The port's tetraploid engine (``instruct_tpu_torch/tetra/engine.py``)
against the JAX package's (``instruct_tpu/tetra/engine.py``), on the CPU.

Update by update on the same arrays, each fed the uniforms that the JAX
function draws from its key; then one whole sweep, fused and unfused, auto
and allo, against the same composition of JAX functions; then ``run_mcmc``
end to end, statistically.

On the JAX side: the P counts are the XLA count loops of ``_update_p_tetra``
and the z draw is ``_update_zq_tetra``'s (XLA) at A > 2 and the Pallas site
kernel's affine path (interpret mode) at A = 2, as the JAX fused sweep runs
it.  The P and Q Dirichlet draws of the composition take the same injected
uniforms through the port's plain Dirichlet (``kernels/dirichlet.py``),
which ``tests/test_torch_kernels.py`` holds equal to the JAX kernel: the JAX
XLA path draws them with ``jax.random.gamma``, which takes no uniforms.

Tolerances: counts, z, qqnum exactly; in a whole sweep an S accept may flip
only within 1e-3 of its threshold (the port solves the class tables in
float64, the JAX package in float32), and z and geno may differ at 0.2% of
the sites (a last-bit difference in a frequency or a table entry moves a
draw that sits on its threshold); floats at rtol 1e-5 (log-liks atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.synthetic import synthetic_tetra_panel as jax_tetra
from instruct_tpu.kernels import fused_step as jfs
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.tetra import engine as jeng

from instruct_tpu_torch import ModelSpec, Schedule, convert, run_mcmc
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import (StepDraws, build_marg_loglik,
                                          build_step, build_step_parts,
                                          check_supported, use_fused)
from instruct_tpu_torch.tetra import engine as te

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


def _unif(key, shape, minval=0.0, maxval=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=minval,
                                         maxval=maxval), np.float32)


_CACHE = {}


def _setup(autopoly, n_alleles, k=3, n=12, l=17, c=2, **spec_kw):
    """JAX and port panels, specs, tables and a JAX initial state of ``c``
    chains carried across; the JAX tables are built once per panel.  Their
    candidate planes are the port's, which
    ``test_torch_tetra_kernels.py::test_tables_and_candidate_planes_match_jax``
    holds equal to the JAX package's (whose allo build compiles for ~10 s
    on every call)."""
    key = (autopoly, n_alleles, k, n, l, c)
    if key not in _CACHE:
        jp = jax_tetra(n_indv=n, n_loci=l, n_pops=k, n_alleles=n_alleles,
                       autopoly=autopoly, missing_rate=0.1, seed=4)
        jdata = jp.data
        data = convert.dataset_from_numpy(_fields(jdata))
        jspec = JSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly)
        t = te.build_tables(ModelSpec(mode=2, ploid=4, n_pops=k,
                                      autopoly=autopoly), data)
        jt = jeng.build_tables(jspec, jdata, with_candidates=False)._replace(
            **{name: jnp.asarray(getattr(t, name).numpy()) for name in
               ("cand_sel", "cand_cls", "cand_mult", "cand_nc")})
        jstates = [jeng.init_tetra_state(jax.random.key(50 + ci), jspec,
                                         jdata, tables=jt)
                   for ci in range(c)]
        _CACHE[key] = (jdata, data, jt, jstates)
    jdata, data, jt, jstates = _CACHE[key]
    jspec = JSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly, **spec_kw)
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly, **spec_kw)
    stacked = {name: None if v is None else np.stack(
        [np.asarray(getattr(s, name)) for s in jstates])
        for name, v in jstates[0]._asdict().items()}
    state = convert.state_from_numpy(stacked, device="cpu")
    return jdata, data, jspec, spec, jt, jstates, state


def _np_counts(z, geno, valid, k, a, slots):
    """The count loop of ``_update_p_tetra`` (JAX engine.py:319-330)."""
    l = valid.shape[1]
    out = np.zeros((k, l, a), np.float32)
    for kk in range(k):
        for ai in range(a):
            for m in slots:
                zc, gc = z[:, m * l:(m + 1) * l], geno[:, m * l:(m + 1) * l]
                out[kk, :, ai] += (valid & (zc == kk) & (gc == ai)).sum(0)
    return out


def _jax_fused_z(jspec, jdata, q, freq, freq2, geno, u):
    """The JAX fused sweep's z draw (``_update_zq_tetra_fused``) with
    injected uniforms u [N, 4L]: the Pallas site kernel in interpret mode on
    the auto view, or on each allo system."""
    l = jdata.n_loci
    seed = jnp.zeros(2, jnp.int32)
    if jspec.autopoly:
        z, _, _ = jfs.zq_sample_pass(
            seed, q, jnp.concatenate([freq, freq], axis=1), geno,
            jnp.tile(jdata.site_valid, (1, 2)), interpret=True, u=u)
        return np.asarray(z)
    z1, _, _ = jfs.zq_sample_pass(seed, q, freq, geno[:, :2 * l],
                                  jdata.site_valid, interpret=True,
                                  u=u[:, :2 * l])
    z2, _, _ = jfs.zq_sample_pass(seed, q, freq2, geno[:, 2 * l:],
                                  jdata.site_valid, interpret=True,
                                  u=u[:, 2 * l:])
    return np.concatenate([np.asarray(z1), np.asarray(z2)], axis=1)


def _qqnum(z, valid, k):
    v4 = np.tile(valid, (1, 4))
    return np.stack([(v4 & (z == kk)).sum(1) for kk in range(k)],
                    1).astype(np.float32)


# ---------------------------------------------------------------------------
# updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("autopoly,n_alleles", [(True, 2), (False, 2),
                                                (True, 4), (False, 4)])
def test_p_counts_and_z_draws_match_jax(autopoly, n_alleles):
    """The P counts on the diploid views and both sweeps' z draws (the site
    pass on the view, fused; K8, unfused) against the JAX package: exactly
    equal, with qqnum."""
    jdata, data, jspec, spec, jt, jstates, state = _setup(autopoly,
                                                          n_alleles)
    c, n, l, k = state.q.shape[0], data.n_indv, data.n_loci, spec.n_pops
    a = data.max_alleles
    valid = np.asarray(jdata.site_valid)
    rng = np.random.default_rng(n_alleles)
    freq = rng.dirichlet(np.ones(a), (c, k, l)).astype(np.float32)
    freq2 = rng.dirichlet(np.ones(a), (c, k, l)).astype(np.float32)
    q = rng.dirichlet(np.ones(k) * 0.7, (c, n)).astype(np.float32)
    c1, c2 = te.p_counts(spec, data, state.z, state.geno)
    keys = [jax.random.key(60 + ci) for ci in range(c)]
    us = []
    for ci in range(c):
        z, g = np.asarray(jstates[ci].z), np.asarray(jstates[ci].geno)
        if autopoly:
            np.testing.assert_array_equal(
                c1[ci].numpy(), _np_counts(z, g, valid, k, a, range(4)))
            assert c2 is None
        else:
            np.testing.assert_array_equal(
                c1[ci].numpy(), _np_counts(z, g, valid, k, a, [0, 1]))
            np.testing.assert_array_equal(
                c2[ci].numpy(), _np_counts(z, g, valid, k, a, [2, 3]))
        us.append(_unif(jax.random.split(keys[ci])[0], (n, 4 * l)))
    u = _t(np.stack(us))
    args = (None, 0, spec, data, _t(freq), _t(freq2), _t(q), state.alpha,
            state.geno)
    q_draws = _t(rng.uniform(1e-4, 1 - 1e-4, (c, dk.n_test_draws(), k, n)),
                 np.float32)
    for fused in (True, False):
        z, q_new = te.update_zq(*args, fused, u=u, q_draws=q_draws)
        assert z.dtype == torch.int8 and q_new.shape == (c, n, k)
        for ci in range(c):
            jargs = (jnp.asarray(freq[ci]), jnp.asarray(freq2[ci]),
                     jnp.asarray(q[ci]))
            if fused and n_alleles == 2:
                want = _jax_fused_z(jspec, jdata, jargs[2], jargs[0],
                                    jargs[1], jstates[ci].geno,
                                    jnp.asarray(us[ci]))
            else:
                want = np.asarray(jeng._update_zq_tetra(
                    keys[ci], jt, jspec, jdata, *jargs, jstates[ci].alpha,
                    jstates[ci].geno)[0])
            np.testing.assert_array_equal(z[ci].numpy(), want)
        qq = _qqnum(z.numpy()[0], valid, k)
        want_q = dk.dirichlet_nk_reference(
            None, 0, _t(qq[None]) + state.alpha[:1, None, None],
            test_draws=q_draws[:1])
        np.testing.assert_array_equal(q_new[:1].numpy(), want_q.numpy())


def test_init_tetra_state_draws_a_valid_state():
    jdata, data, jspec, spec, jt, _, _ = _setup(False, 4)
    st = init_state(3, spec, data, 2, device="cpu")
    n, l, k = data.n_indv, data.n_loci, spec.n_pops
    assert st.z.shape == (2, n, 4 * l) and st.z.dtype == torch.int8
    assert st.geno.shape == (2, n, 4 * l) and st.geno.dtype == torch.int8
    assert int(st.z.min()) >= 0 and int(st.z.max()) < k
    np.testing.assert_allclose(st.q.sum(-1).numpy(), 1.0, atol=1e-5)
    assert ((st.rates > 0) & (st.rates < 1)).all() and st.freq2 is not None
    assert ((st.alpha > 0) & (st.alpha < spec.alpha_prior_max)).all()
    # every latent genotype is one of the site's candidate orderings: its
    # alleles are the observed distinct ones
    dist = data.distinct.numpy().reshape(n, 4, l)
    nd = data.n_distinct.numpy()
    g = st.geno.numpy().reshape(2, n, 4, l)
    for i in range(n):
        for j in range(l):
            if nd[i, j]:
                want = set(dist[i, :nd[i, j], j].tolist())
                assert set(g[0, i, :, j].tolist()) == want
    # a function of (seed, chain key): equal on replay, other for another
    again = init_state(3, spec, data, 2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(st, again)
               if x is not None)
    other = init_state(3, spec, data, 2, device="cpu", chain_key=[7, 1])
    assert torch.equal(other.z[1], st.z[1]) and not torch.equal(
        other.z[0], st.z[0])
    given = init_state(3, spec, data, 2, device="cpu",
                       init_rates=np.full((2, k), 0.25))
    assert torch.equal(given.rates, torch.full((2, k), 0.25))


# ---------------------------------------------------------------------------
# one whole sweep
# ---------------------------------------------------------------------------

def _jax_sweep(jspec, jdata, jt, st, key, p_draws, p2_draws, q_draws):
    """One tetraploid sweep of ``instruct_tpu/tetra/engine.py:755-850``
    from JAX functions and explicit keys (the XLA formulation), P and Q
    through the injected uniforms.  Returns the new state's fields and the
    uniforms as the port takes them."""
    k, l, n = jspec.n_pops, jdata.n_loci, jdata.geno.shape[0]
    a = jdata.allele_valid.shape[1]
    kp, ks, kz, kg, ka = jax.random.split(key, 5)
    valid = np.asarray(jdata.site_valid)
    z0, g0 = np.asarray(st.z), np.asarray(st.geno)
    av = torch.from_numpy(np.array(jdata.allele_valid))

    def dirichlet(counts, draws):
        return jnp.asarray(dk.dirichlet_kla_reference(
            None, 0, _t(counts[None]) + 1.0, av,
            test_draws=_t(draws[None])).numpy()[0])

    slots = range(4) if jspec.autopoly else [0, 1]
    freq = dirichlet(_np_counts(z0, g0, valid, k, a, slots), p_draws)
    freq2 = (st.freq2 if jspec.autopoly else dirichlet(
        _np_counts(z0, g0, valid, k, a, [2, 3]), p2_draws))
    log_hwe = jeng.log_hwe_table(jt, jspec, freq, freq2)
    tab_cur = jeng.selfing_equilibrium(jt, log_hwe, st.rates)
    rates, ais = st.rates, st.ais_state
    cls_idx = jeng._site_class(jt, jdata, st.geno)
    zc = jeng._split4(st.z)
    same = (zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3])
    s_mask = same & jdata.site_valid
    ll_cur = jeng._table_at(tab_cur, zc[0], cls_idx)
    u_prop, u_acc, fresh, margin = [], [], [], np.inf
    for j in range(max(1, jspec.s_subsweeps)):
        kacc, kprop = jax.random.split(jax.random.fold_in(ks, j))
        if jspec.back_refl == 1:
            u_prop.append(_unif(kprop, (k,)))
            prop = jup.propose_back_reflection(kprop, rates, jspec.mh_step_s)
            pst, lh = ais, jnp.zeros_like(rates)
        else:
            ku, kv = jax.random.split(kprop)
            u_prop.append(_unif(ku, (k,)))
            fresh.append(_unif(kv, (k,)))
            prop, pst, lh = jup.propose_adaptive_independence(kprop, rates,
                                                              ais)
        tab_prop = jeng.selfing_equilibrium(jt, log_hwe, prop)
        ll_prop = jeng._table_at(tab_prop, zc[0], cls_idx)
        diff = jnp.where(s_mask, ll_prop - ll_cur, 0.0)
        delta = jnp.stack([jnp.where(zc[0] == kk, diff, 0.0).sum()
                           for kk in range(k)])
        ua = _unif(kacc, (k,), EPS)
        u_acc.append(ua)
        stat = np.asarray(delta + lh) - np.log(ua)
        margin = min(margin, float(np.abs(stat[np.isfinite(stat)]).min()))
        accept = jnp.log(jnp.asarray(ua)) < delta + lh
        rates = jnp.where(accept, prop, rates)
        ais = jnp.where(accept, pst, ais)
        tab_cur = jnp.where(accept[:, None, None], tab_prop, tab_cur)
        acc_site = jnp.zeros(ll_cur.shape, bool)
        for kk in range(k):
            acc_site = acc_site | ((zc[0] == kk) & accept[kk])
        ll_cur = jnp.where(acc_site, ll_prop, ll_cur)
    kz1 = jax.random.split(kz)[0]
    u = _unif(kz1, (n, 4 * l))
    if jspec.use_pallas is not False and a == 2:
        z = _jax_fused_z(jspec, jdata, st.q, freq, freq2, st.geno,
                         jnp.asarray(u))
    else:
        z = np.asarray(jeng._update_zq_tetra(kz, jt, jspec, jdata, freq,
                                             freq2, st.q, st.alpha,
                                             st.geno)[0])
    conc = _qqnum(z, valid, k) + np.asarray(st.alpha)
    q_new = jnp.asarray(dk.dirichlet_nk_reference(
        None, 0, _t(conc[None]), test_draws=_t(q_draws[None])).numpy()[0])
    n_cand = int(jt.n_patterns_np.max())
    gumbel = np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(
        jax.random.fold_in(kg, cc), (n, l), minval=1e-12, maxval=1.0))))
        for cc in range(n_cand)]).astype(np.float32)
    geno = jeng._sample_geno(kg, jt, jspec, jdata, freq, freq2, q_new,
                             tab_cur, jnp.asarray(z))
    alpha = jup.update_alpha(ka, jspec, q_new, st.alpha)
    kau, kan = jax.random.split(ka)
    table = jeng.selfing_equilibrium(
        jt, jeng.log_hwe_table(jt, jspec, freq, freq2), rates)
    ll = jeng._site_loglik(jt, jspec, jdata, freq, freq2, jnp.asarray(z),
                           geno, table).sum(axis=1)
    out = dict(freq=freq, freq2=freq2, rates=rates, ais_state=ais, z=z,
               q=q_new, geno=geno, alpha=alpha, loglik_indv=ll)
    draws = dict(s=(np.stack(u_prop), np.stack(u_acc),
                    np.stack(fresh) if fresh else None), z=u, geno=gumbel,
                 alpha=(np.asarray(jax.random.normal(kan), np.float32),
                        _unif(kau, (), EPS)))
    return {kk: np.asarray(v) for kk, v in out.items()}, draws, margin


@pytest.mark.parametrize("autopoly,kwargs", [
    (True, dict()), (False, dict()),
    (True, dict(use_pallas=False)), (False, dict(use_pallas=False)),
    (False, dict(s_subsweeps=3, back_refl=0)),
])
def test_one_sweep_matches_jax(autopoly, kwargs):
    """One whole sweep of the port (``build_step``) against the JAX
    composition, fed the same uniforms.  Both sweeps run the plain versions
    of K5, K6 (in every S subsweep, where the JAX composition carries the
    per-site values) and K7 here; the fused one the site pass for z, the
    unfused one K8."""
    jdata, data, jspec, spec, jt, jstates, state = _setup(autopoly, 4,
                                                          **kwargs)
    c, n, l, k = state.q.shape[0], data.n_indv, data.n_loci, spec.n_pops
    a = data.max_alleles
    assert use_fused(spec, data) == (kwargs.get("use_pallas") is not False)
    rng = np.random.default_rng(17)
    nd = dk.n_test_draws()

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, p2_draws = unif(c, nd, k * a, l), unif(c, nd, k * a, l)
    q_draws = unif(c, nd, k, n)
    res = [_jax_sweep(jspec, jdata, jt, jstates[ci],
                      jax.random.key(90 + ci), p_draws[ci], p2_draws[ci],
                      q_draws[ci]) for ci in range(c)]
    dr = [r[1] for r in res]

    def stack(get):
        return _t(np.stack([get(d) for d in dr]), np.float32)

    adaptive = spec.back_refl != 1
    s = (stack(lambda d: d["s"][0]), stack(lambda d: d["s"][1]),
         stack(lambda d: d["s"][2]) if adaptive else None)
    draws = StepDraws(p=_t(p_draws), p2=_t(p2_draws), q=_t(q_draws), s=s,
                      z=stack(lambda d: d["z"]),
                      geno=stack(lambda d: d["geno"]),
                      alpha=(stack(lambda d: d["alpha"][0]),
                             stack(lambda d: d["alpha"][1])))
    keys = px.make_keys(0, c, "cpu")
    got = build_step(spec, data)(state, keys, 0, draws)

    for ci in range(c):
        w, margin = res[ci][0], res[ci][2]
        np.testing.assert_allclose(got.freq[ci].numpy(), w["freq"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.freq2[ci].numpy(), w["freq2"],
                                   rtol=1e-5, atol=1e-7)
        same_rates = np.allclose(got.rates[ci].numpy(), w["rates"],
                                 rtol=1e-5, atol=1e-7)
        assert same_rates or margin < 1e-3, (got.rates[ci], w["rates"])
        if not same_rates:
            continue
        np.testing.assert_array_equal(got.ais_state[ci].numpy(),
                                      w["ais_state"])
        zoff = (got.z[ci].numpy() != w["z"]).mean()
        assert zoff <= 2e-3, zoff
        goff = (got.geno[ci].numpy() != w["geno"]).mean()
        assert goff <= 2e-3, goff
        if zoff == 0:
            np.testing.assert_allclose(got.q[ci].numpy(), w["q"], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(float(got.alpha[ci]),
                                       float(w["alpha"]), rtol=1e-5)
        if zoff == 0 and goff == 0:
            np.testing.assert_allclose(got.loglik_indv[ci].numpy(),
                                       w["loglik_indv"], rtol=1e-5,
                                       atol=1e-3)
    assert not torch.equal(got.geno, state.geno)
    assert not torch.equal(got.z, state.z)
    np.testing.assert_allclose(got.loglik_total.numpy(),
                               got.loglik_indv.sum(-1).numpy(), rtol=1e-6)
    marg = build_marg_loglik(spec, data)(got)
    np.testing.assert_allclose(marg.loglik_marg.numpy(),
                               got.loglik_indv.numpy(), rtol=1e-6)

    # with no injected draws the sweep draws from Philox: a function of
    # (seed, step)
    core, add_ll = build_step_parts(spec, data)
    a1 = core(core(state, keys, 0), keys, 1)
    a2 = core(core(state, keys, 0), keys, 1)
    for x, y in zip(a1, a2):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.isfinite(add_ll(a1).loglik_total).all()


@pytest.mark.parametrize("kwargs,n_alleles,k", [
    (dict(), 4, 3), (dict(use_pallas=False), 4, 3),
    (dict(s_subsweeps=3), 4, 3), (dict(), 8, 4), (dict(), 3, 10),
])
def test_every_sweep_calls_the_kernel_wrappers(monkeypatch, kwargs,
                                               n_alleles, k):
    """The fused and the unfused sweep, several S subsweeps, wide class
    tables (A = 8, K = 4: K * G = 1320 floats a site) and K = 10 all run the
    move, the S log-ratio and the log-lik through the wrappers of K5, K6
    (once per subsweep) and K7, which launch the kernels on a CUDA tensor:
    no sweep falls back to plain code on the card."""
    calls = {}

    def counted(name):
        fn = getattr(tg, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("geno_choice_pass", "s_delta_pass", "site_ll_pass"):
        monkeypatch.setattr(tg, name, counted(name))
    panel = synthetic_tetra_panel(6, 9, n_pops=k, n_alleles=n_alleles,
                                  autopoly=True, missing_rate=0.1, seed=2)
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, **kwargs)
    tables = te.build_tables(spec, panel.data)
    assert (k * tables.g_max > 1024) == (n_alleles == 8)
    state = init_state(1, spec, panel.data, 2, device="cpu")
    core, add_ll = build_step_parts(spec, panel.data)
    add_marg = build_marg_loglik(spec, panel.data)
    state = add_marg(add_ll(core(state, px.make_keys(1, 2, "cpu"), 0)))
    assert calls == {"geno_choice_pass": 1,
                     "s_delta_pass": max(1, spec.s_subsweeps),
                     "site_ll_pass": 2}
    assert torch.isfinite(state.loglik_indv).all()
    torch.testing.assert_close(state.loglik_marg, state.loglik_indv,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

def test_ploidy_4_is_supported_and_dispatched():
    jdata, data, jspec, spec, jt, jstates, state = _setup(True, 4)
    check_supported(spec, data)
    assert use_fused(spec, data)
    assert not use_fused(ModelSpec(mode=2, ploid=4, n_pops=3,
                                   use_pallas=False), data)
    # K > 8 or K * A > 64: the unfused sweep
    assert not te.tetra_use_fused(ModelSpec(ploid=4, n_pops=9), data)
    assert not te.tetra_use_fused(ModelSpec(ploid=4, n_pops=17), data)
    # a diploid panel has no distinct alleles to order
    diploid = data._replace(distinct=None, n_distinct=None)
    with pytest.raises(ValueError, match="distinct"):
        check_supported(spec, diploid)
    with pytest.raises(ValueError, match="marginalize_g"):
        check_supported(ModelSpec(ploid=4, marginalize_g=True), data)
    # the state carries across both ways, freq2 and geno included
    back = convert.state_to_numpy(state)
    again = convert.state_from_numpy(back, device="cpu")
    for x, y in zip(state, again):
        assert (x is None and y is None) or torch.equal(x, y)
    assert again.geno.dtype == torch.int8 and again.freq2.shape == (
        2, 3, data.n_loci, 4)


def test_run_mcmc_tracks_freq2_and_scores_the_model():
    """Allo through ``run_mcmc`` with ``track_freq``: freq2 moments, the
    (z, geno)-conditional plug-in and WAIC are finite, and two runs from
    one seed are bitwise equal."""
    panel = synthetic_tetra_panel(20, 15, n_pops=2, n_alleles=3,
                                  autopoly=False, missing_rate=0.1, seed=3)
    spec = ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=False)
    sched = Schedule(n_iter=30, burnin=10, thinning=2, n_chains=2, ckrep=5,
                     nstep_check_empty_cluster=5, dic_every=2)
    res = run_mcmc(panel.data, spec, sched, 11, track_freq=True,
                   device="cpu")
    m = res.accum.mean
    assert m.freq2.shape == (2, 2, 15, 3) and m.gen.shape == (2, 0)
    np.testing.assert_allclose(m.freq2.sum(-1).numpy(), 1.0, atol=1e-4)
    assert np.isfinite(res.plugin_ll).all() and np.isfinite(res.dic()).all()
    assert np.isfinite(res.waic()).all()
    assert (res.accum.count == sched.n_stored).all()
    res2 = run_mcmc(panel.data, spec, sched, 11, track_freq=True,
                    device="cpu")
    assert torch.equal(res.final_state.geno, res2.final_state.geno)
    assert torch.equal(m.rates, res2.accum.mean.rates)


def test_run_mcmc_recovers_the_selfing_rate():
    """One pop, strong signal: equilibrium data at s = 0.05 and s = 0.8
    (``tests/test_tetra.py::test_tetra_recovers_selfing_rate``)."""
    for s_true in (0.05, 0.8):
        panel = synthetic_tetra_panel(80, 60, n_pops=1,
                                      selfing_rates=np.array([s_true]),
                                      autopoly=True, seed=11)
        spec = ModelSpec(mode=2, ploid=4, n_pops=1)
        sched = Schedule(n_iter=300, burnin=100, thinning=2, n_chains=1,
                         ckrep=20, nstep_check_empty_cluster=10)
        res = run_mcmc(panel.data, spec, sched, 5, device="cpu")
        s_hat = float(res.accum.mean.rates[0, 0])
        assert abs(s_hat - s_true) < 0.2, (s_true, s_hat)
