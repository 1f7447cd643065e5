"""The port's diploid modes 1, 3, 4, 5 (and mode 2 on a multi-allelic panel)
against the JAX package, on the CPU.

Module by module on the same arrays (made with numpy from a seed) and the
same injected draws; then one whole sweep of each mode, deterministic,
against the same composition of JAX kernels (interpret mode) and updates
that ``instruct_tpu/mcmc/step.py`` makes; then one mode as a whole,
statistically, against the JAX ``run_mcmc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Schedule as JSchedule
from instruct_tpu import run_mcmc as jax_run_mcmc
from instruct_tpu.data.dataset import make_dataset as jax_make_dataset
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.kernels import fused_step as jfs
from instruct_tpu.mcmc import updates as jup
from instruct_tpu.mcmc.state import init_state as jax_init_state
from instruct_tpu.model import likelihood as jlk

from instruct_tpu_torch import ModelSpec, Priors, Schedule, run_mcmc
from instruct_tpu_torch import convert
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.data.dataset import make_dataset
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.dirichlet import n_test_draws
from instruct_tpu_torch.mcmc import step as step_mod
from instruct_tpu_torch.mcmc import updates as tup
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import (StepDraws, build_marg_loglik,
                                          build_step, build_step_parts)
from instruct_tpu_torch.model import likelihood as tlk

MODES = (1, 2, 3, 4, 5)


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


# ---------------------------------------------------------------------------
# modules outside the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_alleles", [2, 4])
@pytest.mark.parametrize("mode,type_freq", [(1, 1), (2, 1), (3, 1), (3, 0),
                                            (4, 1), (5, 1)])
def test_likelihoods_match_jax_per_mode(mode, type_freq, n_alleles):
    n, l, k, c = 19, 37, 3, 2
    jdata, data = _panel(n, l, k, n_alleles, seed=5)
    rng = np.random.default_rng(mode)
    freq = rng.dirichlet(np.ones(n_alleles), size=(c, k, l)
                         ).astype(np.float32)
    q = rng.dirichlet(np.full(k, 0.5), size=(c, n)).astype(np.float32)
    z = rng.integers(0, k, size=(c, n, 2 * l)).astype(np.int8)
    spec = ModelSpec(mode=mode, n_pops=k, type_freq=type_freq)
    jspec = JSpec(mode=mode, n_pops=k, type_freq=type_freq)
    r = spec.n_rates(n)
    rates = rng.uniform(0.05, 0.95, (c, r)).astype(np.float32)
    gen = rng.integers(1, 9, size=(c, n if spec.has_selfing else 0))
    genf = gen.astype(np.float32) + 0.37          # real-valued generations
    got_m = tlk.marginal_indv_loglik(spec, data, _t(freq), _t(q), _t(genf),
                                     _t(rates)).numpy()
    got_c = tlk.per_indv_loglik(spec, data, _t(freq), _t(z), _t(q),
                                _t(gen.astype(np.int32)), _t(rates)).numpy()
    for ci in range(c):
        jgen = jnp.asarray(genf[ci]) if spec.has_selfing else None
        jrates = jnp.asarray(rates[ci]) if r else None
        want = jlk.marginal_indv_loglik(
            jspec, jdata, jnp.asarray(freq[ci]), jnp.asarray(q[ci]), jgen,
            jrates)
        np.testing.assert_allclose(got_m[ci], np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
        jgen = jnp.asarray(gen[ci]) if spec.has_selfing else None
        want = jlk.per_indv_loglik(
            jspec, jdata, jnp.asarray(freq[ci]), jnp.asarray(z[ci]),
            jnp.asarray(q[ci]), jgen, jrates)
        np.testing.assert_allclose(got_c[ci], np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    # the gathers behind them, for any A
    np.testing.assert_array_equal(
        tlk.gather_freq_at_z(_t(freq), data, _t(z))[0].numpy(),
        np.asarray(jlk.gather_freq_at_z(jnp.asarray(freq[0]), jdata,
                                        jnp.asarray(z[0]))))
    np.testing.assert_allclose(
        tlk.mixture_copy_probs(_t(freq), data, _t(q))[1].numpy(),
        np.asarray(jlk.mixture_copy_probs(jnp.asarray(freq[1]), jdata,
                                          jnp.asarray(q[1]))), rtol=1e-6)
    # the stored-step pass of the mode is the same function of the state
    state = init_state(0, spec, data, c, device="cpu")._replace(
        freq=_t(freq), q=_t(q), z=_t(z), rates=_t(rates),
        gen=_t(gen.astype(np.int32)))
    via_pass = build_step_parts(spec, data)[1](state).loglik_indv.numpy()
    np.testing.assert_allclose(via_pass, got_c, rtol=2e-4, atol=2e-3)


def test_genofreq_inbreeding_matches_jax():
    rng = np.random.default_rng(0)
    p0, p1, f = (rng.uniform(0, 1, 50).astype(np.float32) for _ in range(3))
    hom = rng.random(50) < 0.5
    np.testing.assert_allclose(
        tlk.genofreq_inbreeding(_t(p0), _t(p1), _t(hom), _t(f)).numpy(),
        np.asarray(jlk.genofreq_inbreeding(jnp.asarray(p0), jnp.asarray(p1),
                                           jnp.asarray(hom),
                                           jnp.asarray(f))), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_init_state_shapes_per_mode(mode):
    n, l, k, c, a = 13, 21, 3, 2, 4
    jdata, data = _panel(n, l, k, a)
    spec, jspec = ModelSpec(mode=mode, n_pops=k), JSpec(mode=mode, n_pops=k)
    st = init_state(5, spec, data, c, device="cpu")
    jst = jax_init_state(jax.random.key(0), jspec, jdata)
    for name, v in jst._asdict().items():
        got = getattr(st, name)
        if v is None:
            assert got is None, name
        elif name not in ("dpm_values", "dpm_counts", "dpm_assign", "zz"):
            assert tuple(got.shape) == (c,) + tuple(v.shape), name
    r = {1: 0, 2: k, 3: n, 4: k, 5: n}[mode]
    assert st.rates.shape == (c, r) and st.ais_state.shape == (c, r)
    assert st.gen.shape == (c, n if mode in (2, 3) else 0)
    assert st.gen.dtype == torch.int32 and st.z.dtype == torch.int8
    if mode in (2, 3):
        assert int(st.gen.min()) >= 1 and int(st.gen.max()) <= spec.gen_cap
    assert bool(((st.rates >= 0) & (st.rates <= 1)).all())
    np.testing.assert_array_equal(
        st.zcounts.numpy(), tup.allele_pop_counts(spec, data, st.z).numpy())
    # a function of (seed, chain key) alone; init_rates are honoured
    st2 = init_state(5, spec, data, c, device="cpu")
    assert torch.equal(st.z, st2.z) and torch.equal(st.gen, st2.gen)
    if r:
        given = np.linspace(0.2, 0.7, c * r).reshape(c, r)
        st3 = init_state(5, spec, data, c, init_rates=given, device="cpu")
        np.testing.assert_allclose(st3.rates.numpy(), given, rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_convert_round_trip_per_mode(mode):
    n, l, k, c = 11, 17, 2, 3
    jdata, data = _panel(n, l, k, 3 if mode % 2 else 2)
    assert (data.bits2 is None) == bool(mode % 2)
    spec, jspec = ModelSpec(mode=mode, n_pops=k), JSpec(mode=mode, n_pops=k)
    # the port's own state: to numpy and back
    st = init_state(3, spec, data, c, device="cpu")
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    for name, v in st._asdict().items():
        got = getattr(back, name)
        if v is None:
            assert got is None, name
        else:
            assert got.dtype == v.dtype and torch.equal(got, v), name
    # a JAX state, one chain and several: over and back unchanged
    jstates = [jax_init_state(jax.random.key(i), jspec, jdata)
               for i in range(c)]
    for fields in (_fields(jstates[0]), _stack_states(jstates)):
        over = convert.state_from_numpy(fields, device="cpu")
        out = convert.state_to_numpy(over)
        stacked = np.asarray(fields["q"]).ndim == 3
        assert over.q.shape[0] == (c if stacked else 1)
        for name, v in fields.items():
            if v is None:
                assert out[name] is None, name
            else:
                np.testing.assert_array_equal(
                    out[name] if stacked else out[name][0], v, err_msg=name)
    # and the sweep runs from the carried-over state
    moved = build_step(spec, data)(over, px.make_keys(1, c, "cpu"), 0)
    assert torch.isfinite(moved.loglik_total).all()
    # the panel, packed or not
    d2 = convert.dataset_from_numpy(_fields(jdata))
    for name, v in d2._asdict().items():
        w = getattr(data, name)
        assert (v is None and w is None) or torch.equal(v, w), name


def test_tail_updates_match_jax():
    """The S/F tails outside the kernels, fed the uniforms the JAX
    functions draw from their keys."""
    n, l, k, c = 23, 41, 3, 2
    jdata, data = _panel(n, l, k, 2, seed=9)
    rng = np.random.default_rng(3)
    freq = rng.dirichlet(np.ones(2), size=(c, k, l)).astype(np.float32)
    z = rng.integers(0, k, size=(c, n, 2 * l)).astype(np.int8)
    gen = rng.integers(1, 9, size=(c, n)).astype(np.int32)
    x = np.array([-0.3, 0.2, 1.4, 1.0, 0.0], np.float32)
    key = jax.random.key(5)
    np.testing.assert_allclose(
        tup.propose_back_reflection(
            _t(np.asarray(jax.random.uniform(key, x.shape))), _t(x),
            0.05).numpy(),
        np.asarray(jup.propose_back_reflection(key, jnp.asarray(x), 0.05)),
        rtol=1e-6)

    def draws(kp, ku, shape):
        return (np.asarray(jax.random.uniform(kp, shape)),
                np.asarray(jax.random.uniform(ku, shape, minval=1e-30)))

    for mode, r in ((3, n), (4, k), (5, n)):
        spec, jspec = (ModelSpec(mode=mode, n_pops=k),
                       JSpec(mode=mode, n_pops=k))
        rates = rng.uniform(0.05, 0.95, (c, r)).astype(np.float32)
        keys = [jax.random.key(50 + 10 * mode + ci) for ci in range(c)]
        if mode == 3:
            dr = [draws(*jax.random.split(kk), (r,)) for kk in keys]
            want = [jup.update_s_ind(keys[ci], jspec, jnp.asarray(gen[ci]),
                                     jnp.asarray(rates[ci]))
                    for ci in range(c)]
        elif mode == 4:
            dr = [draws(jax.random.fold_in(kk, 0), kk, (r,)) for kk in keys]
            want = [jup.update_f_pop(
                keys[ci], jspec, jdata, jnp.asarray(freq[ci]),
                jnp.asarray(z[ci]), jnp.asarray(rates[ci]),
                jnp.ones((r,), jnp.int32))[0] for ci in range(c)]
        else:
            dr = [draws(*jax.random.split(kk), (r,)) for kk in keys]
            want = [jup.update_f_ind(
                keys[ci], jspec, jdata, jnp.asarray(freq[ci]),
                jnp.asarray(z[ci]), jnp.asarray(rates[ci]))
                for ci in range(c)]
        u_prop = _t(np.stack([d[0] for d in dr]))
        u_acc = _t(np.stack([d[1] for d in dr]))
        if mode == 3:
            got = tup.update_s_ind(u_prop[:, None], u_acc[:, None], spec,
                                   _t(gen), _t(rates))
        else:
            fn = tup.update_f_pop if mode == 4 else tup.update_f_ind
            args = (u_prop, u_acc, spec, data, _t(freq), _t(z), _t(rates))
            if mode == 4:
                ais = torch.ones((c, r), dtype=torch.int32)
                got, carried = fn(*args, ais)
                assert torch.equal(carried, ais)   # back-reflection
            else:
                got = fn(*args)
        got, want = got.numpy(), np.stack([np.asarray(w) for w in want])
        # an accept may flip only at a knife-edge of its f32 log-ratio
        off = ~np.isclose(got, want, rtol=1e-6)
        assert off.mean() <= 0.02, (mode, off.sum())
        assert (got != rates).any() and (got == rates).any(), mode


def test_tail_uniform_streams_are_disjoint_and_reproducible():
    keys = px.make_keys(99, 2, "cpu", chain_key=[4, 8])
    w = px.random_streams(keys, 7, px.STREAM_R_PROP, 4, 10)
    assert w.shape == (2, 4, 10)
    for s, stream in enumerate((px.STREAM_R_PROP, px.STREAM_R_ACC,
                                px.STREAM_G_PROP, px.STREAM_G_ACC)):
        assert torch.equal(w[:, s], px.random_words(keys, 7, stream, 10))
    ids = [px.STREAM_P, px.STREAM_S_PROP, px.STREAM_S_ACC, px.STREAM_S_GEN,
           px.STREAM_S_LOGU, px.STREAM_Z, px.STREAM_Q, px.STREAM_ALPHA,
           px.STREAM_R_PROP, px.STREAM_R_ACC, px.STREAM_G_PROP,
           px.STREAM_G_ACC, px.STREAM_R_FRESH, px.STREAM_HYPER,
           px.STREAM_ZZ, px.STREAM_GENO, px.STREAM_P2, px.STREAM_DPM_SEAT,
           px.STREAM_DPM_NEW, px.STREAM_DPM_STICK, px.STREAM_DPM_THETA,
           px.STREAM_MARG_GEN]
    assert len(set(ids)) == len(ids) and px.INIT_STEP not in ids
    # the DPM and marginalize_g streams: distinct words, reproducible
    new = [px.random_words(keys, 7, s, 16) for s in ids[-5:]]
    assert all(not torch.equal(a, b) for i, a in enumerate(new)
               for b in new[i + 1:])
    assert torch.equal(new[0], px.random_words(keys, 7, ids[-5], 16))
    np.testing.assert_array_equal(
        px.element_words(keys, 7, ids[-5], torch.arange(5, 13)).numpy(),
        new[0][:, 5:13].numpy())
    u = tup.tail_uniforms(keys, 7, 2, 33)
    assert u.shape == (2, 2, 33) and bool(((u > 0) & (u < 1)).all())
    assert torch.equal(u, tup.tail_uniforms(keys, 7, 2, 33))
    assert not torch.equal(u, tup.tail_uniforms(keys, 8, 2, 33))


@pytest.mark.parametrize("kwargs,what", [
    (dict(mode=1, marginalize_g=True), "marginalize_g applies"),
    (dict(mode=2, ploid=4, marginalize_g=True), "marginalize_g applies"),
    (dict(mode=3, type_freq=0, marginalize_g=True), "type_freq=1"),
    (dict(mode=3, priors=Priors(family=PriorFamily.DPM, dp_truncation=1)),
     "dp_truncation=1"),
    (dict(mode=5, priors=Priors(family=PriorFamily.DPM, dp_truncation=9)),
     "dp_truncation=9 out of range"),
])
def test_what_is_left_still_raises(kwargs, what):
    """The models the JAX package refuses too raise its ``ValueError``:
    ``marginalize_g`` outside the diploid modes 2/3 or with the expectation
    way, and a ``dp_truncation`` of 1 or above N (here N = 8)."""
    _, data = _panel(8, 9, 2, 2)
    spec = ModelSpec(**{"n_pops": 2, **kwargs})
    with pytest.raises(ValueError, match=what):
        step_mod.check_supported(spec, data)
    # the K grid's active mask and K > 8 are ported: no longer refused
    step_mod.check_supported(ModelSpec(mode=2, n_pops=12), data)
    q = torch.full((1, 8, 2), 0.5)
    assert torch.isfinite(tup.update_alpha(
        None, 0, ModelSpec(mode=1, n_pops=2), q, torch.ones(1),
        active=torch.ones(1, 2),
        test_draws=(torch.zeros(1), torch.full((1,), 0.5)))).all()


_DPM = Priors(family=PriorFamily.DPM)


@pytest.mark.parametrize("kwargs", [
    dict(mode=0), dict(mode=1, use_pallas=False),
    dict(mode=5, priors=Priors(family=PriorFamily.NORMAL)),
    dict(mode=5, back_refl=0), dict(mode=1, back_refl=0),
    dict(mode=4, priors=Priors(family=PriorFamily.NORMAL)),
    dict(mode=1, priors=_DPM), dict(mode=0, ploid=4, priors=_DPM),
    dict(mode=5, ploid=4, priors=_DPM), dict(mode=3, priors=_DPM),
    dict(mode=3, marginalize_g=True),
])
def test_what_was_refused_before_now_runs(kwargs):
    """Mode 0, the unfused sweep, the normal and DPM priors, ``back_refl=0``
    and ``marginalize_g`` are supported; where the JAX package ignores an
    option (the normal prior outside modes 3/5, the DPM prior outside
    diploid modes 3/5, ``back_refl=0`` outside modes 2/4) the port does
    too: the trajectory is that of the default spec."""
    ploid = kwargs.get("ploid", 2)
    if ploid == 4:
        data = synthetic_tetra_panel(8, 9, n_pops=2, seed=4).data
    else:
        _, data = _panel(8, 9, 2, 2)
    spec = ModelSpec(**{"n_pops": 2, **kwargs})
    step_mod.check_supported(spec, data)
    keys = px.make_keys(1, 2, "cpu")
    state = init_state(1, spec, data, 2, device="cpu")
    new = build_step(spec, data)(state, keys, 0)
    assert torch.isfinite(new.loglik_total).all()
    ignored = (("back_refl" in kwargs and spec.mode not in (2, 4))
               or ("priors" in kwargs and (spec.mode not in (3, 5)
                                           or ploid == 4)))
    default = ModelSpec(mode=spec.mode, ploid=ploid, n_pops=2)
    plain = build_step(default, data)(
        init_state(1, default, data, 2, device="cpu"), keys, 0)
    same = all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(new, plain))
    if ignored:
        assert same
    elif "priors" in kwargs or "marginalize_g" in kwargs:
        assert not same


# ---------------------------------------------------------------------------
# one whole sweep of each mode with injected draws
# ---------------------------------------------------------------------------

def _unif(key, shape, minval=0.0, maxval=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=minval,
                                         maxval=maxval))


def _jax_sweep(jspec, jdata, st, p_draws, u, q_draws, ks, kg, kacc, ka):
    """One fused sweep of ``instruct_tpu/mcmc/step.py:181-354`` for modes
    1, 3, 4, 5 (and ``add_loglik``), from the JAX kernel functions in
    interpret mode and the JAX updates, with explicit uniforms for the
    kernels and explicit keys for the updates.  Also returns the tail's
    uniforms as the port takes them, and the accept margins."""
    mode, k, l = jspec.mode, jspec.n_pops, jdata.n_loci
    a = jdata.allele_valid.shape[1]
    n = jdata.geno.shape[0]
    structure = jspec.type_freq == 1
    rows = jnp.transpose(st.zcounts + 1.0, (0, 2, 1)).reshape(k * a, l)
    vrows = jnp.tile(jdata.allele_valid.T, (k, 1))
    freq = jdp.dirichlet_rows(0, rows, vrows, rows_per_group=a,
                              interpret=True, test_draws=jnp.asarray(p_draws)
                              ).reshape(k, a, l).transpose(0, 2, 1)
    site = dict(interpret=True, u=jnp.asarray(u), bits2=jdata.bits2)
    panel = (jdata.geno, jdata.site_valid)
    out = dict(freq=freq, rates=st.rates, gen=st.gen)
    if mode == 1:
        z, qqnum, zcounts = jfs.zq_sample_pass(0, st.q, freq, *panel, **site)
        tail, margin = None, None
    elif mode == 3:
        sweeps = max(1, jspec.s_subsweeps)
        rates, u_prop, u_acc = st.rates, [], []
        for j in range(sweeps):
            kj = jax.random.fold_in(ks, j)
            kp, ku = jax.random.split(kj)
            u_prop.append(_unif(kp, (n,)))
            u_acc.append(_unif(ku, (n,), minval=1e-30))
            rates = jup.update_s_ind(kj, jspec, st.gen, rates)
        gen_prop = jup.sample_geometric(kg, rates, jspec.gen_cap)
        wg_pair = jnp.exp2(1.0 - jnp.stack([st.gen, gen_prop], axis=1
                                           ).astype(jnp.float32))
        ul = _unif(kacc, (n,), minval=1e-30)
        z, qqnum, ll_diff, zcounts = jfs.zq_gendiff_pass(
            0, st.q, freq, *panel, jdata.hom, st.z, wg_pair,
            structure=structure, **site)
        logu = jnp.log(jnp.asarray(ul))
        out.update(rates=rates,
                   gen=jnp.where(logu < ll_diff, gen_prop, st.gen))
        tail = (np.stack(u_prop), np.stack(u_acc),
                _unif(kg, (n,), minval=1e-12, maxval=1.0), ul)
        margin = jnp.abs(logu - ll_diff)
    else:
        r = st.rates.shape[0]
        kprop = jax.random.fold_in(ks, 0)
        prop = jup.propose_back_reflection(kprop, st.rates, jspec.mh_step_s)
        z, qqnum, ll, zcounts = jfs.zq_f_pass(
            0, st.q, freq, *panel, jdata.hom, st.z,
            jnp.stack([st.rates, prop], axis=1), pop=(mode == 4), **site)
        log_ratio = ll.sum(axis=0) if mode == 4 else ll
        u_acc = _unif(kacc, (r,), minval=1e-30)
        logu = jnp.log(jnp.asarray(u_acc))
        out.update(rates=jnp.where(logu < log_ratio, prop, st.rates))
        tail = (_unif(kprop, (r,)), u_acc)
        margin = jnp.abs(logu - log_ratio)
    if zcounts is None:
        zcounts = jfs.allele_counts(z, *panel, n_pops=k, max_alleles=a,
                                    interpret=True)
    q_new = jdp.dirichlet_rows(0, (qqnum + st.alpha).T, rows_per_group=k,
                               interpret=True,
                               test_draws=jnp.asarray(q_draws)).T
    alpha = jup.update_alpha(ka, jspec, q_new, st.alpha)
    if mode == 1:
        ll_indv = jfs.panel_loglik_mode1_pass(freq, q_new, *panel, z,
                                              interpret=True,
                                              bits2=jdata.bits2)
    elif mode == 3:
        wg = jnp.exp2(1.0 - out["gen"].astype(jnp.float32))[:, None]
        ll_indv = jfs.panel_loglik_pass(freq, q_new, *panel, jdata.hom, z,
                                        wg, structure=structure,
                                        interpret=True, bits2=jdata.bits2)
    else:
        ll_indv = jfs.panel_loglik_f_pass(freq, *panel, jdata.hom, z,
                                          out["rates"][:, None],
                                          pop=(mode == 4), interpret=True,
                                          bits2=jdata.bits2)
    out.update(z=z, q=q_new, alpha=alpha, zcounts=zcounts,
               loglik_indv=ll_indv, loglik_total=ll_indv.sum())
    return out, tail, margin


def _alpha_draws(key):
    ku, ka = jax.random.split(key)
    return (np.asarray(jax.random.normal(ka), np.float32),
            np.asarray(jax.random.uniform(ku, minval=1e-30), np.float32))


@pytest.mark.parametrize("n_alleles", [2, 4])
@pytest.mark.parametrize("mode", [1, 3, 4, 5])
def test_one_sweep_matches_jax_kernels_per_mode(mode, n_alleles):
    n, l, k, c, j, a = 30, 90, 3, 2, 3, n_alleles
    jdata, data = _panel(n, l, k, a)
    jspec = JSpec(mode=mode, n_pops=k, s_subsweeps=j)
    spec = ModelSpec(mode=mode, n_pops=k, s_subsweeps=j)
    jstates = [jax_init_state(jax.random.key(40 + ci), jspec, jdata)
               for ci in range(c)]
    state = convert.state_from_numpy(_stack_states(jstates), device="cpu")
    rng = np.random.default_rng(8 + mode)
    nd = n_test_draws()

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, q_draws = unif(c, nd, k * a, l), unif(c, nd, k, n)
    u = unif(c, n, 2 * l)
    ukeys = [jax.random.split(jax.random.key(70 + ci), 4) for ci in range(c)]
    res = [_jax_sweep(jspec, jdata, jstates[ci], p_draws[ci], u[ci],
                      q_draws[ci], *ukeys[ci]) for ci in range(c)]
    want = [r[0] for r in res]
    adr = [_alpha_draws(kk[3]) for kk in ukeys]
    tail = None
    if mode != 1:
        tail = tuple(_t(np.stack([r[1][i] for r in res]).astype(np.float32))
                     for i in range(len(res[0][1])))
    draws = StepDraws(p=_t(p_draws), z=_t(u), q=_t(q_draws), s=tail,
                      alpha=(_t(np.array([d[0] for d in adr])),
                             _t(np.array([d[1] for d in adr]))))
    keys = px.make_keys(0, c, "cpu")
    got = build_step(spec, data)(state, keys, 0, draws)

    for ci in range(c):
        w = want[ci]
        np.testing.assert_array_equal(got.z[ci].numpy(), np.asarray(w["z"]))
        np.testing.assert_array_equal(got.zcounts[ci].numpy(),
                                      np.asarray(w["zcounts"]))
        for name in ("freq", "q"):
            np.testing.assert_allclose(getattr(got, name)[ci].numpy(),
                                       np.asarray(w[name]), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        np.testing.assert_allclose(float(got.alpha[ci]), float(w["alpha"]),
                                   rtol=1e-5)
        # an MH accept compares f32 sums taken in another order: it may
        # differ only where the margin is within their rounding
        accepted = "gen" if mode == 3 else "rates"
        flipped = np.zeros((), bool)
        if mode != 1:
            flipped = ~np.isclose(getattr(got, accepted)[ci].numpy(),
                                  np.asarray(w[accepted]), rtol=1e-6)
            assert (np.asarray(res[ci][2])[flipped] < 1e-3).all()
            assert flipped.sum() <= 1
        if mode == 3:
            # the S subsweeps' own accepts: elementwise, same order
            assert np.isclose(got.rates[ci].numpy(), np.asarray(w["rates"]),
                              rtol=1e-6).mean() >= 0.95
        assert got.gen.shape == (c, n if mode == 3 else 0)
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
    if mode != 1:
        assert not torch.equal(a1.rates, state.rates)


@pytest.mark.parametrize("n_alleles", [2, 4])
@pytest.mark.parametrize("mode", [4, 5])
def test_fused_f_pass_agrees_with_the_unfused_update(mode, n_alleles):
    """"Z, then F | z": the accept the fused sweep makes is the one the
    unfused update (full genofreq log-liks) makes at the sweep's fresh z
    from the same proposal and accept uniforms."""
    n, l, k, c = 40, 96, 3, 2
    _, data = _panel(n, l, k, n_alleles, seed=2)
    spec = ModelSpec(mode=mode, n_pops=k)
    state = init_state(1, spec, data, c, device="cpu")
    keys = px.make_keys(1, c, "cpu")
    step = build_step_parts(spec, data)[0]
    for i in range(3):
        new = step(state, keys, i)
        w = tup.tail_uniforms(keys, i, 2, state.rates.shape[1])
        fn = tup.update_f_pop if mode == 4 else tup.update_f_ind
        args = (w[:, 0], w[:, 1], spec, data, new.freq, new.z, state.rates)
        want = fn(*args, state.ais_state)[0] if mode == 4 else fn(*args)
        assert np.isclose(new.rates.numpy(), want.numpy(),
                          rtol=1e-6).mean() >= 0.98
        state = new
    assert not torch.equal(state.rates,
                           init_state(1, spec, data, c, device="cpu").rates)


def test_mode2_sweep_on_a_multiallelic_panel_matches_jax_kernels():
    """Mode 2 on A = 4: the generic site path inside the whole sweep, with
    the recount of the allele-pop counts."""
    from instruct_tpu.kernels.s_pop_pallas import s_pop_tail as jax_s_tail
    n, l, k, c, j, a = 24, 60, 2, 2, 2, 4
    jdata, data = _panel(n, l, k, a)
    jspec = JSpec(mode=2, n_pops=k, s_subsweeps=j)
    spec = ModelSpec(mode=2, n_pops=k, s_subsweeps=j)
    jstates = [jax_init_state(jax.random.key(9 + ci), jspec, jdata)
               for ci in range(c)]
    state = convert.state_from_numpy(_stack_states(jstates), device="cpu")
    rng = np.random.default_rng(1)
    nd, nu, np_ = n_test_draws(), j * k, n + (-n % 128)

    def unif(*shape):
        return rng.uniform(1e-4, 1 - 1e-4, shape).astype(np.float32)

    p_draws, q_draws, u = unif(c, nd, k * a, l), unif(c, nd, k, n), unif(
        c, n, 2 * l)
    planes = [[unif(1, 128), unif(1, 128), unif(1, np_), unif(1, np_)]
              for _ in range(c)]
    draws = StepDraws(
        p=_t(p_draws), z=_t(u), q=_t(q_draws),
        s=tuple(_t(np.stack([planes[ci][i][0, :m] for ci in range(c)]))
                for i, m in enumerate((nu, nu, n, n))),
        alpha=(torch.zeros(c), torch.full((c,), 0.5)))
    got = build_step_parts(spec, data)[0](state, px.make_keys(0, c, "cpu"),
                                          0, draws)
    for ci in range(c):
        st = jstates[ci]
        rows = jnp.transpose(st.zcounts + 1.0, (0, 2, 1)).reshape(k * a, l)
        freq = jdp.dirichlet_rows(
            0, rows, jnp.tile(jdata.allele_valid.T, (k, 1)),
            rows_per_group=a, interpret=True,
            test_draws=jnp.asarray(p_draws[ci])
        ).reshape(k, a, l).transpose(0, 2, 1)
        rates, gen_prop, wg_pair, logu = jax_s_tail(
            jnp.zeros(2, jnp.int32), st.q, st.gen, st.rates, subsweeps=j,
            delta0=jspec.mh_step_s, gen_cap=jspec.gen_cap, interpret=True,
            test_draws=[jnp.asarray(p) for p in planes[ci]])
        z, qqnum, ll_diff, zc = jfs.zq_gendiff_pass(
            0, st.q, freq, jdata.geno, jdata.site_valid, jdata.hom, st.z,
            wg_pair, structure=True, interpret=True, u=jnp.asarray(u[ci]))
        np.testing.assert_array_equal(got.z[ci].numpy(), np.asarray(z))
        np.testing.assert_array_equal(got.zcounts[ci].numpy(),
                                      np.asarray(zc))
        np.testing.assert_allclose(got.freq[ci].numpy(), np.asarray(freq),
                                   rtol=1e-5, atol=1e-7)
        gen = np.asarray(jnp.where(logu < ll_diff, gen_prop, st.gen))
        flipped = got.gen[ci].numpy() != gen
        assert (np.abs(np.asarray(logu - ll_diff))[flipped] < 1e-3).all()


# ---------------------------------------------------------------------------
# one mode as a whole, statistically
# ---------------------------------------------------------------------------

def test_run_mcmc_mode4_recovers_the_inbreeding_like_jax():
    """The port runs the fused order "Z, then F | z" and the JAX XLA path
    the reference order "F, then Z", so this check is statistical by design:
    the posterior-mean F of the two pops within 0.1 of the JAX run's, and
    the information criteria of its size."""
    jp = jax_panel(n_indv=100, n_loci=100, n_pops=2, n_alleles=2,
                   selfing_rates=np.array([0.1, 0.8]), seed=1)
    geno, miss = jp.data.geno3, ~np.asarray(jp.data.site_valid)
    n_alleles = np.full(100, 2, np.int32)
    kw = dict(n_iter=2000, burnin=1000, thinning=5, n_chains=2, ckrep=100,
              nstep_check_empty_cluster=20)
    jres = jax_run_mcmc(jax_make_dataset(geno, miss, n_alleles),
                        JSpec(mode=4, n_pops=2, use_pallas=False),
                        JSchedule(**kw), jax.random.key(0))
    res = run_mcmc(make_dataset(geno, miss, n_alleles),
                   ModelSpec(mode=4, n_pops=2), Schedule(**kw), 0,
                   track_freq=True, device="cpu")
    f_jax = np.sort(np.asarray(jres.accum.mean.rates), -1).mean(0)
    f = np.sort(res.accum.mean.rates.numpy(), -1).mean(0)
    # selfing at rate s leaves F = s / (2 - s): 0.05 and 0.67
    assert f[0] < 0.3 < f[1]
    np.testing.assert_allclose(f, f_jax, atol=0.1)
    assert res.accum.count.tolist() == [200, 200]
    assert res.accum.mean.rates.shape == (2, 2)
    assert res.accum.mean.gen.shape == (2, 0)
    assert np.isfinite(res.dic()).all() and np.isfinite(res.waic()).all()
    assert (res.p_d() > 0).all()
    np.testing.assert_allclose(res.dic_reference().mean(),
                               jres.dic_reference().mean(), rtol=0.02)
    np.testing.assert_allclose(res.waic().mean(), jres.waic().mean(),
                               rtol=0.02)
