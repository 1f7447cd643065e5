"""Shared helpers of ``test_torch_dpm.py`` and ``test_torch_marg_g.py``: the
panels, the draws that the JAX DPM and ``marg_g`` functions make from their
keys (rebuilt with ``jax.random`` so the port's plain versions can be fed
the same numbers), and one whole JAX sweep of the DPM prior or of
``marginalize_g`` composed from the JAX kernels (interpret mode) and
updates as ``instruct_tpu/mcmc/step.py`` composes them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.kernels import fused_step as jfs
from instruct_tpu.mcmc import dpm as jdpm
from instruct_tpu.mcmc import marg_g as jmg
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.mcmc.state import init_state as jax_init_state
from instruct_tpu.model import likelihood as jlk

from instruct_tpu_torch import convert
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.dirichlet import n_test_draws
from instruct_tpu_torch.mcmc.step import StepDraws, build_step

EPS = 1e-30


def t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def panel(n, l, k, a, seed=21, rates=None):
    rates = np.linspace(0.1, 0.8, k) if rates is None else rates
    jp = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=a,
                   selfing_rates=rates, missing_rate=0.1, seed=seed)
    return jp.data, convert.dataset_from_numpy(fields(jp.data))


def stack_states(jstates):
    return {name: None if v is None else np.stack(
        [np.asarray(getattr(s, name)) for s in jstates])
        for name, v in jstates[0]._asdict().items()}


def unif(key, shape, minval=0.0, maxval=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=minval,
                                         maxval=maxval))


def gumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape, jnp.float32))


def seat_plane(kg, n):
    """The seat noise the JAX CRP sweep draws from ``kg``: the hoisted
    plane, or the rows of ``fold_in(kg, j)`` above the plane's gate."""
    if n <= jdpm._GUMBEL_PLANE_MAX_N:
        return gumbel(kg, (n, n + 1))
    rows = jax.vmap(lambda j: jax.random.gumbel(
        jax.random.fold_in(kg, j), (n + 1,), jnp.float32))
    return np.asarray(rows(jnp.arange(n)))


def crp_draws(key, variant, gen=None, ll_grid=None):
    """(seat noise, new values or grid indices) that ``init_dpm`` /
    ``crp_sweep_selfing`` / ``crp_sweep_inbreeding`` draw from ``key``."""
    kg, kb = jax.random.split(key)
    if variant == "prior":
        n = gen
        return seat_plane(kg, n), unif(kb, (n,))
    if variant == "selfing":
        n = gen.shape[0]
        new = np.asarray(jax.random.beta(kb, jnp.asarray(gen, jnp.float32),
                                         2.0))
        return seat_plane(kg, n), new
    n = ll_grid.shape[0]
    new = np.asarray(jax.random.categorical(kb, jnp.asarray(ll_grid),
                                            axis=-1))
    return seat_plane(kg, n), new.astype(np.int32)


def stick_draws(key, assign, alpha, t_max, gen=None, m=None):
    """(v, theta or its grid noise, seat noise) that the JAX stick-breaking
    sweeps draw from ``key`` for the table's ``assign``."""
    k1, k2, k3 = jax.random.split(key, 3)
    a = np.clip(np.asarray(assign), 0, t_max - 1)
    n = a.shape[0]
    counts_t = np.bincount(a, minlength=t_max).astype(np.float32)
    tail = np.cumsum(counts_t[::-1])[::-1] - counts_t
    v = np.asarray(jax.random.beta(k1, jnp.asarray(1.0 + counts_t),
                                   jnp.asarray(alpha + tail)))
    if gen is not None:
        sum_g1 = np.bincount(a, weights=np.asarray(gen) - 1.0,
                             minlength=t_max).astype(np.float32)
        theta = np.asarray(jax.random.beta(k2, jnp.asarray(1.0 + sum_g1),
                                           jnp.asarray(1.0 + counts_t)))
    else:
        theta = gumbel(k2, (t_max, m))
    return v, theta, gumbel(k3, (n, t_max))


def s_pop_draws(key, k):
    """(u_prop, u_acc) f32[K] as one back-reflection subsweep of
    ``update_s_pop`` / ``update_s_pop_marginal`` draws them from ``key``."""
    kacc, kprop = jax.random.split(key)
    u_acc = np.array([unif(kk, (), EPS) for kk in jax.random.split(kacc, k)])
    return unif(kprop, (k,)), u_acc


def alpha_draws(key):
    ku, ka = jax.random.split(key)
    return (np.asarray(jax.random.normal(ka), np.float32),
            np.asarray(jax.random.uniform(ku, minval=1e-30), np.float32))


def _dpm_update(jspec, jdata, st, ks):
    """The JAX DP sweep on ``st`` with key ``ks``, and the draws it made."""
    if jspec.mode == 3:
        draws = crp_draws(ks, "selfing", gen=np.asarray(st.gen))
    else:
        ll = jdpm.f_loglik_grid(jspec, jdata, st.freq, st.z)
        draws = crp_draws(ks, "inbreeding", ll_grid=np.asarray(ll))
    return jdpm.build_dpm_update(jspec, jdata)(ks, st), draws


def jax_sweep(jspec, jdata, st, p_draws, u, q_draws, keys, fused):
    """One sweep of the JAX step for mode 3 or 5 under the DPM prior, or
    modes 2/3 under ``marginalize_g`` (with or without the DPM), fused
    (``step.py:181-335``) or unfused (``:421-475``), from the JAX kernels
    in interpret mode with the uniforms ``p_draws``, ``u``, ``q_draws`` and
    the updates with the keys ``keys`` = (ks, kg, kz, kacc, ka).  Returns
    (the new fields, the port's ``StepDraws`` fields as numpy: ``s``,
    ``dpm``, ``marg``, and the unfused sweep's z uniforms)."""
    mode, k, l = jspec.mode, jspec.n_pops, jdata.n_loci
    a = jdata.allele_valid.shape[1]
    n = jdata.geno.shape[0]
    j = max(1, jspec.s_subsweeps)
    ks, kg, kz, kacc, ka = keys
    marg = jspec.marginalize_g
    dpm = jspec.priors.family.value == "dpm"
    counts = (st.zcounts if fused
              else jup.allele_pop_counts(jspec, jdata, st.z, st.zz))
    rows = jnp.transpose(counts + 1.0, (0, 2, 1)).reshape(k * a, l)
    freq = jdp.dirichlet_rows(0, rows, jnp.tile(jdata.allele_valid.T, (k, 1)),
                              rows_per_group=a, interpret=True,
                              test_draws=jnp.asarray(p_draws)
                              ).reshape(k, a, l).transpose(0, 2, 1)
    st = st._replace(freq=freq)
    site = dict(interpret=True, u=jnp.asarray(u), bits2=jdata.bits2)
    panel_args = (jdata.geno, jdata.site_valid)
    zeros = np.zeros((j, n if mode == 3 else k), np.float32)
    draws = dict(s=None, dpm=None, marg=None)
    if marg:
        gtable = jmg.selfing_gtable(jdata, freq, st.z, jspec.gen_cap)
        if mode == 2:
            rates, ais, per = st.rates, st.ais_state, []
            for jj in range(j):
                kj = jax.random.fold_in(ks, jj)
                per.append(s_pop_draws(kj, k))
                rates, ais = jmg.update_s_pop_marginal(
                    kj, jspec, st.q, gtable, rates, ais)
            st = st._replace(rates=rates, ais_state=ais)
            sbar = st.q @ rates
            draws["s"] = (np.stack([p[0] for p in per]),
                          np.stack([p[1] for p in per]),
                          np.zeros(n, np.float32), np.zeros(n, np.float32))
        else:
            st, draws["dpm"] = _dpm_update(jspec, jdata, st, ks)
            sbar = st.rates
        gen = jmg.sample_gen_marginal(kg, gtable, sbar, jspec.gen_cap)
        draws["marg"] = gumbel(kg, (n, jspec.gen_cap))
        st = st._replace(gen=gen)
    else:
        assert dpm
        st, draws["dpm"] = _dpm_update(jspec, jdata, st, ks)
        if mode == 3 and fused:
            gen_prop = jup.sample_geometric(kg, st.rates, jspec.gen_cap)
            ul = unif(kacc, (n,), EPS)
            draws["s"] = (zeros, zeros, unif(kg, (n,), 1e-12, 1.0), ul)
        elif mode == 3:
            gen = jup.update_gen(kg, jspec, jdata, freq, st.z, st.q,
                                 st.rates, st.gen)
            kgg, kgu = jax.random.split(kg)
            draws["s"] = (zeros, zeros, unif(kgg, (n,), 1e-12, 1.0),
                          unif(kgu, (n,), EPS))
            st = st._replace(gen=gen)
    ll_diff = None
    if fused:
        if marg:
            z, qqnum, zcounts = jfs.zq_sample_pass(0, st.q, freq, *panel_args,
                                                   **site)
        elif mode == 3:
            wg_pair = jnp.exp2(1.0 - jnp.stack(
                [st.gen, gen_prop], axis=1).astype(jnp.float32))
            z, qqnum, ll_diff, zcounts = jfs.zq_gendiff_pass(
                0, st.q, freq, *panel_args, jdata.hom, st.z, wg_pair,
                structure=True, **site)
            st = st._replace(gen=jnp.where(jnp.log(jnp.asarray(ul))
                                           < ll_diff, gen_prop, st.gen))
        else:
            f_pair = jnp.stack([st.rates, st.rates], axis=1)
            z, qqnum, ll, zcounts = jfs.zq_f_pass(
                0, st.q, freq, *panel_args, jdata.hom, st.z, f_pair,
                pop=False, **site)
            uacc = jax.random.uniform(kacc, st.rates.shape, minval=1e-30)
            assert bool((jnp.log(uacc) < ll).all())   # the no-op accept
        if zcounts is None:
            zcounts = jfs.allele_counts(z, *panel_args, n_pops=k,
                                        max_alleles=a, interpret=True)
        z_u = None
    else:
        z, _, qqnum = jup.update_zq(kz, jspec, jdata, freq, st.q, st.alpha)
        zcounts = None
        z_u = unif(jax.random.split(kz)[0], (n, 2 * l))
    q_new = jdp.dirichlet_rows(0, (qqnum + st.alpha).T, rows_per_group=k,
                               interpret=True,
                               test_draws=jnp.asarray(q_draws)).T
    alpha = jup.update_alpha(ka, jspec, q_new, st.alpha)
    st = st._replace(z=z, q=q_new, alpha=alpha, zcounts=zcounts)
    if fused and mode == 5:
        ll_indv = jfs.panel_loglik_f_pass(freq, *panel_args, jdata.hom, z,
                                          st.rates[:, None], pop=False,
                                          interpret=True, bits2=jdata.bits2)
    elif fused:
        wg = jnp.exp2(1.0 - st.gen.astype(jnp.float32))[:, None]
        ll_indv = jfs.panel_loglik_pass(freq, q_new, *panel_args, jdata.hom,
                                        z, wg, structure=True,
                                        interpret=True, bits2=jdata.bits2)
    else:
        ll_indv = jlk.per_indv_loglik(jspec, jdata, freq, z, q_new,
                                      st.gen if jspec.has_selfing else None,
                                      st.rates)
    st = st._replace(loglik_indv=ll_indv, loglik_total=ll_indv.sum())
    return st, draws, z_u


def check_sweep(jspec, spec, n=30, l=48, k=3, c=2):
    """One sweep of the port with the draws of :func:`jax_sweep` against
    it, per chain: the DP table exactly, the rates, G (an accept at the
    knife-edge of its f32 sum may flip one individual), z (exactly on the
    fused sweep; on the unfused one the port draws by inverse CDF where
    JAX uses its own categorical), freq, and the rest where nothing
    flipped.  Returns the port's new state."""
    jdata, data = panel(n, l, k, 2)
    fused = spec.use_pallas is not False
    jstates = [jax_init_state(jax.random.key(40 + ci), jspec, jdata)
               for ci in range(c)]
    state = convert.state_from_numpy(stack_states(jstates), device="cpu")
    rng = np.random.default_rng(8 + jspec.mode)
    nd = n_test_draws()

    def u01(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, q_draws, u = (u01(c, nd, k * 2, l), u01(c, nd, k, n),
                           u01(c, n, 2 * l))
    ukeys = [jax.random.split(jax.random.key(70 + ci), 5) for ci in range(c)]
    res = [jax_sweep(jspec, jdata, jstates[ci], p_draws[ci], u[ci],
                     q_draws[ci], ukeys[ci], fused) for ci in range(c)]
    want = [r[0] for r in res]

    def stacked(name):
        first = res[0][1][name]
        if first is None:
            return None
        if isinstance(first, tuple):
            return tuple(t(np.stack([r[1][name][i] for r in res]))
                         for i in range(len(first)))
        return t(np.stack([r[1][name] for r in res]))

    adr = [alpha_draws(kk[4]) for kk in ukeys]
    draws = StepDraws(p=t(p_draws), q=t(q_draws), s=stacked("s"),
                      dpm=stacked("dpm"), marg=stacked("marg"),
                      z=t(u) if fused else t(np.stack([r[2] for r in res])),
                      alpha=(t(np.array([d[0] for d in adr])),
                             t(np.array([d[1] for d in adr]))))
    got = build_step(spec, data)(state, px.make_keys(0, c, "cpu"), 0, draws)
    dpm = jspec.priors.family.value == "dpm"
    for ci in range(c):
        w = want[ci]
        if dpm:
            for name in ("dpm_values", "dpm_counts", "dpm_assign"):
                np.testing.assert_array_equal(getattr(got, name)[ci].numpy(),
                                              np.asarray(getattr(w, name)),
                                              err_msg=name)
        np.testing.assert_allclose(got.rates[ci].numpy(),
                                   np.asarray(w.rates), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.freq[ci].numpy(), np.asarray(w.freq),
                                   rtol=1e-5, atol=1e-7)
        flips = 0
        if jspec.has_selfing:
            flips = int((got.gen[ci].numpy() != np.asarray(w.gen)).sum())
            assert flips <= 1, flips
        zoff = (got.z[ci].numpy() != np.asarray(w.z)).mean()
        assert zoff == 0 if fused else zoff <= 2e-3, zoff
        if fused:
            np.testing.assert_array_equal(got.zcounts[ci].numpy(),
                                          np.asarray(w.zcounts))
        if zoff == 0 and flips == 0:
            np.testing.assert_allclose(got.q[ci].numpy(), np.asarray(w.q),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(float(got.alpha[ci]), float(w.alpha),
                                       rtol=1e-5)
            np.testing.assert_allclose(got.loglik_indv[ci].numpy(),
                                       np.asarray(w.loglik_indv),
                                       rtol=1e-5, atol=1e-4)
    assert not torch.equal(got.rates, state.rates)
    return got
