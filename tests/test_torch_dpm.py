"""The port's DPM prior (``instruct_tpu_torch/mcmc/dpm.py`` and the plain
version of the seating kernel, ``kernels/crp.py``) against the JAX
package's ``instruct_tpu/mcmc/dpm.py``, on the CPU.

The JAX functions take keys; each test rebuilds with ``jax.random`` the
draws they make (the seat noise plane, the Beta and uniform new values,
the categorical grid indices, the sticks) and feeds them to the port,
whose table must then be exactly JAX's.  The grid curve matches JAX's and
its dense form to rtol 1e-5 of the curve's magnitude (float32 sums over
the loci in another order).  Then one whole sweep of mode 3 and mode 5
under the DPM prior, fused and unfused, against the JAX kernels and
updates with injected draws; the seating kernel's Philox noise and the
checks of ``dp_truncation``; and a short run that recovers two groups'
selfing rates like the JAX package's run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _dpm_sweeps import (check_sweep, crp_draws, fields, panel, stick_draws,
                         t)
from instruct_tpu import ModelSpec as JSpec
from instruct_tpu import Priors as JPriors
from instruct_tpu import Schedule as JSchedule
from instruct_tpu import run_mcmc as jax_run_mcmc
from instruct_tpu.config import PriorFamily as JFamily
from instruct_tpu.data.synthetic import synthetic_panel as jax_synth
from instruct_tpu.mcmc import dpm as jdpm

from instruct_tpu_torch import ModelSpec, Priors, Schedule, convert, run_mcmc
from instruct_tpu_torch.config import PriorFamily
from instruct_tpu_torch.kernels import crp
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import dpm
from instruct_tpu_torch.mcmc import step as step_mod
from instruct_tpu_torch.mcmc.state import init_state

C = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys():
    return px.make_keys(0, C, "cpu")


def _assert_table(got, want):
    for i, name in enumerate(("values", "counts", "assign")):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.stack([np.asarray(w[i])
                                                for w in want]),
                                      err_msg=name)


def _jax_tables(n, alpha, seed):
    keys = [jax.random.key(seed + ci) for ci in range(C)]
    return keys, [jdpm.init_dpm(kk, alpha, n) for kk in keys]


# ---------------------------------------------------------------------------
# the exact CRP sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha", [(1, 10.0), (2, 1.0), (37, 10.0),
                                     (40, 0.5)])
def test_init_dpm_matches_jax(n, alpha):
    keys, want = _jax_tables(n, alpha, 3 * n)
    dr = [crp_draws(kk, "prior", gen=n) for kk in keys]
    got = dpm.init_dpm(_keys(), 0, alpha, n,
                       draws=(t(np.stack([d[0] for d in dr])),
                              t(np.stack([d[1] for d in dr]))))
    _assert_table(got, want)
    assert (got.counts.sum(-1) == n).all()


@pytest.mark.parametrize("n,alpha", [(1, 10.0), (2, 3.0), (33, 10.0),
                                     (40, 0.7)])
def test_crp_sweep_selfing_matches_jax(n, alpha):
    rng = np.random.default_rng(n)
    _, tables = _jax_tables(n, alpha, 7 * n)
    gen = rng.integers(1, 9, size=(C, n)).astype(np.int32)
    keys = [jax.random.key(900 + ci) for ci in range(C)]
    want = [jdpm.crp_sweep_selfing(keys[ci], tables[ci],
                                   jnp.asarray(gen[ci]), alpha)
            for ci in range(C)]
    dr = [crp_draws(keys[ci], "selfing", gen=gen[ci]) for ci in range(C)]
    table = dpm.DpmTable(*(t(np.stack([np.asarray(tb[i]) for tb in tables]))
                           for i in range(3)))
    got = dpm.crp_sweep_selfing(_keys(), 0, table, t(gen), alpha,
                                draws=(t(np.stack([d[0] for d in dr])),
                                       t(np.stack([d[1] for d in dr]))))
    _assert_table(got, want)
    # the sweep moved individuals, and a table's count is its members
    assert (got.assign.numpy() != table.assign.numpy()).any() or n <= 2
    for ci in range(C):
        np.testing.assert_array_equal(
            np.bincount(got.assign[ci].numpy(), minlength=n),
            got.counts[ci].numpy())


@pytest.mark.parametrize("n,m", [(1, 8), (2, 16), (35, 16), (40, 128)])
def test_crp_sweep_inbreeding_matches_jax(n, m):
    rng = np.random.default_rng(m + n)
    alpha = 4.0
    _, tables = _jax_tables(n, alpha, 11 * n)
    ll = (rng.normal(0.0, 3.0, (C, n, m))
          - rng.uniform(0, 40, (C, n, 1))).astype(np.float32)
    keys = [jax.random.key(500 + ci) for ci in range(C)]
    want = [jdpm.crp_sweep_inbreeding(keys[ci], tables[ci],
                                      jnp.asarray(ll[ci]), alpha)
            for ci in range(C)]
    dr = [crp_draws(keys[ci], "inbreeding", ll_grid=ll[ci])
          for ci in range(C)]
    table = dpm.DpmTable(*(t(np.stack([np.asarray(tb[i]) for tb in tables]))
                           for i in range(3)))
    got = dpm.crp_sweep_inbreeding(_keys(), 0, table, t(ll), alpha,
                                   draws=(t(np.stack([d[0] for d in dr])),
                                          t(np.stack([d[1] for d in dr]))))
    _assert_table(got, want)


def test_crp_sweep_above_the_jax_plane_gate_matches_jax():
    """N above ``_GUMBEL_PLANE_MAX_N``: JAX draws each row of seat noise
    from ``fold_in(kg, j)`` inside its scan; fed those rows, the port
    seats every individual alike."""
    n, alpha = jdpm._GUMBEL_PLANE_MAX_N + 3, 10.0
    rng = np.random.default_rng(1)
    key0, key1 = jax.random.key(77), jax.random.key(78)
    table = jdpm.init_dpm(key0, alpha, n)
    gen = rng.integers(1, 6, size=n).astype(np.int32)
    want = jdpm.crp_sweep_selfing(key1, table, jnp.asarray(gen), alpha)
    plane, new = crp_draws(key1, "selfing", gen=gen)
    got = dpm.crp_sweep_selfing(
        px.make_keys(0, 1, "cpu"), 0,
        dpm.DpmTable(*(t(np.asarray(x))[None] for x in table)),
        t(gen)[None], alpha, draws=(t(plane)[None], t(new)[None]))
    for i in range(3):
        np.testing.assert_array_equal(got[i][0].numpy(),
                                      np.asarray(want[i]))


def test_seat_noise_is_the_philox_element_stream():
    """The plain version's Philox noise: element j * (N + 1) + t of
    ``STREAM_DPM_SEAT``, whichever rows are drawn together; the Philox
    sweep is reproducible and seats as the injected plane of its own
    words does."""
    n = 13
    keys = px.make_keys(5, C, "cpu", chain_key=[3, 9])
    whole = crp.seat_noise(keys, 4, n, 0, n)
    words = px.random_words(keys, 4, px.STREAM_DPM_SEAT, n * (n + 1))
    np.testing.assert_array_equal(
        whole.numpy(), px.gumbel(words).reshape(C, n, n + 1).numpy())
    np.testing.assert_array_equal(crp.seat_noise(keys, 4, n, 5, 9).numpy(),
                                  whole[:, 5:9].numpy())
    a = dpm.init_dpm(keys, 4, 2.0, n)
    b = dpm.init_dpm(keys, 4, 2.0, n)
    new = px.u01_open(px.random_words(keys, 4, px.STREAM_DPM_NEW, n))
    c = dpm.init_dpm(keys, 4, 2.0, n, draws=(whole, new))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    # margins and occupied tables of the plain version, for the card check
    margins, occupied = [], []
    crp.crp_sweep_reference(keys, 4, crp.PRIOR, None, None, None,
                            torch.full((C, n), 0.7), new, margins=margins,
                            occupied=occupied)
    assert len(margins) == n and all((m >= 0).all() for m in margins)
    assert occupied[0].tolist() == [0, 0] and (occupied[-1] >= 1).all()


# ---------------------------------------------------------------------------
# the stick-breaking sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_max", [2, 6, 25])
def test_stick_sweep_selfing_matches_jax(t_max):
    n, alpha = 30, 3.0
    rng = np.random.default_rng(t_max)
    _, tables = _jax_tables(n, alpha, 40 + t_max)
    gen = rng.integers(1, 9, size=(C, n)).astype(np.int32)
    keys = [jax.random.key(60 + ci) for ci in range(C)]
    want = [jdpm.stick_sweep_selfing(keys[ci], tables[ci],
                                     jnp.asarray(gen[ci]), alpha, t_max)
            for ci in range(C)]
    dr = [stick_draws(keys[ci], tables[ci].assign, alpha, t_max,
                      gen=gen[ci]) for ci in range(C)]
    table = dpm.DpmTable(*(t(np.stack([np.asarray(tb[i]) for tb in tables]))
                           for i in range(3)))
    got = dpm.stick_sweep_selfing(
        _keys(), 0, table, t(gen), alpha, t_max,
        draws=tuple(t(np.stack([d[i] for d in dr])) for i in range(3)))
    _assert_table(got, want)


@pytest.mark.parametrize("t_max", [2, 9])
def test_stick_sweep_inbreeding_matches_jax(t_max):
    n, m, alpha = 28, 32, 5.0
    rng = np.random.default_rng(t_max)
    _, tables = _jax_tables(n, alpha, 90 + t_max)
    ll = (rng.normal(0.0, 2.0, (C, n, m))
          - rng.uniform(0, 20, (C, n, 1))).astype(np.float32)
    keys = [jax.random.key(30 + ci) for ci in range(C)]
    want = [jdpm.stick_sweep_inbreeding(keys[ci], tables[ci],
                                        jnp.asarray(ll[ci]), alpha, t_max)
            for ci in range(C)]
    dr = [stick_draws(keys[ci], tables[ci].assign, alpha, t_max, m=m)
          for ci in range(C)]
    table = dpm.DpmTable(*(t(np.stack([np.asarray(tb[i]) for tb in tables]))
                           for i in range(3)))
    got = dpm.stick_sweep_inbreeding(
        _keys(), 0, table, t(ll), alpha, t_max,
        draws=tuple(t(np.stack([d[i] for d in dr])) for i in range(3)))
    _assert_table(got, want)


def test_beta_draws_through_the_dirichlet_kernel():
    """Beta(a, b) as a two-component Dirichlet (the kernel's plain version
    on the CPU): the moments of the law."""
    keys = px.make_keys(1, C, "cpu")
    a = torch.tensor([[1.0] * 4000, [3.0] * 4000])
    b = torch.full_like(a, 2.0)
    x = dpm.beta_draws(keys, 0, px.STREAM_DPM_NEW, a, b)
    mean = (a / (a + b))[:, 0]
    var = (a * b / ((a + b) ** 2 * (a + b + 1)))[:, 0]
    assert ((x > 0) & (x < 1)).all()
    np.testing.assert_allclose(x.mean(1).numpy(), mean.numpy(), atol=0.015)
    np.testing.assert_allclose(x.var(1).numpy(), var.numpy(), rtol=0.1)


# ---------------------------------------------------------------------------
# the mode-5 grid curve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_alleles,m", [(2, 128), (4, 24)])
def test_f_loglik_grid_matches_jax_and_its_dense_form(n_alleles, m):
    n, l, k = 23, 47, 3
    jdata, data = panel(n, l, k, n_alleles, seed=4)
    rng = np.random.default_rng(n_alleles)
    freq = rng.dirichlet(np.ones(n_alleles), size=(C, k, l)
                         ).astype(np.float32)
    z = rng.integers(0, k, size=(C, n, 2 * l)).astype(np.int8)
    spec = JSpec(mode=5, n_pops=k)
    got = dpm.f_loglik_grid(data, t(freq), t(z), m).numpy()
    dense = dpm.f_loglik_grid_dense(data, t(freq), t(z), m).numpy()
    assert got.shape == (C, n, m)
    for ci in range(C):
        want = np.asarray(jdpm.f_loglik_grid(spec, jdata,
                                             jnp.asarray(freq[ci]),
                                             jnp.asarray(z[ci]), m))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[ci], want, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(
            dense[ci], np.asarray(jdpm.f_loglik_grid_dense(
                spec, jdata, jnp.asarray(freq[ci]), jnp.asarray(z[ci]), m)),
            rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got[ci], dense[ci], rtol=1e-5,
                                   atol=1e-5 * scale)


def test_the_grid_products_run_in_full_float32():
    """The masked products ask full float32 whatever the global setting,
    and leave the setting as they found it."""
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        seen = []
        real = torch.Tensor.__matmul__

        def spy(a, b):
            seen.append(torch.get_float32_matmul_precision())
            return real(a, b)

        _, data = panel(9, 11, 2, 2)
        freq = torch.full((1, 2, 11, 2), 0.5)
        z = torch.zeros((1, 9, 22), dtype=torch.int8)
        torch.Tensor.__matmul__ = spy
        try:
            dpm.f_loglik_grid(data, freq, z, 16)
        finally:
            torch.Tensor.__matmul__ = real
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


# ---------------------------------------------------------------------------
# whole sweeps, the state, the checks, a run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", [3, 5])
def test_one_dpm_sweep_matches_jax(mode, fused):
    prior = dict(priors=JPriors(family=JFamily.DPM))
    use = None if fused else False
    jspec = JSpec(mode=mode, n_pops=3, s_subsweeps=2, use_pallas=use, **prior)
    spec = ModelSpec(mode=mode, n_pops=3, s_subsweeps=2, use_pallas=use,
                     priors=Priors(family=PriorFamily.DPM))
    assert step_mod.use_fused(spec, panel(4, 4, 3, 2)[1]) == fused
    got = check_sweep(jspec, spec)
    np.testing.assert_array_equal(
        got.rates.numpy(),
        torch.gather(got.dpm_values, 1, got.dpm_assign.long()).numpy())


@pytest.mark.parametrize("mode,t_max", [(3, 0), (5, 0), (3, 7), (5, 7)])
def test_init_state_draws_the_crp_prior(mode, t_max):
    n, k = 17, 2
    _, data = panel(n, 13, k, 2)
    spec = ModelSpec(mode=mode, n_pops=k, priors=Priors(
        family=PriorFamily.DPM, dp_truncation=t_max))
    st = init_state(4, spec, data, C, init_rates=np.full((C, n), 0.5),
                    device="cpu")
    keys = px.make_keys(4, C, "cpu")
    table = dpm.init_dpm(keys, px.INIT_STEP, spec.priors.alpha_dpm, n)
    for x, y in zip((st.dpm_values, st.dpm_counts, st.dpm_assign), table):
        assert torch.equal(x, y)
    assert torch.equal(st.rates, torch.gather(table.values, 1,
                                              table.assign.long()))
    assert (st.rates != 0.5).all()           # init_rates are not read
    if mode == 3:
        assert int(st.gen.min()) >= 1
    # a retried chain (fresh key) starts from another table
    st2 = init_state(4, spec, data, C, chain_key=[0, 10_001], device="cpu")
    assert torch.equal(st2.dpm_assign[0], st.dpm_assign[0])
    assert not torch.equal(st2.dpm_values[1], st.dpm_values[1])


@pytest.mark.parametrize("t_max,ok", [(0, True), (2, True), (17, True),
                                      (1, False), (18, False), (-1, False)])
def test_dp_truncation_range(t_max, ok):
    _, data = panel(17, 9, 2, 2)
    spec = ModelSpec(mode=3, n_pops=2, priors=Priors(
        family=PriorFamily.DPM, dp_truncation=t_max))
    if ok:
        step_mod.check_supported(spec, data)
        dpm.build_dpm_update(spec, data)
    else:
        with pytest.raises(ValueError, match="dp_truncation"):
            step_mod.check_supported(spec, data)


@pytest.mark.parametrize("mode,t_max", [(3, 0), (5, 0), (3, 9), (5, 9)])
def test_dpm_runs_reproducibly_on_both_sweeps(mode, t_max):
    panel_ = panel(20, 30, 2, 2)[1]
    sched = Schedule(n_iter=8, burnin=4, thinning=2, n_chains=C, ckrep=2,
                     nstep_check_empty_cluster=2)
    outs = []
    for use in (None, False, None):
        spec = ModelSpec(mode=mode, n_pops=2, use_pallas=use, priors=Priors(
            family=PriorFamily.DPM, dp_truncation=t_max))
        outs.append(run_mcmc(panel_, spec, sched, seed=3, device="cpu"))
    a, b, c = (r.final_state for r in outs)
    for x, y in zip(a, c):
        assert (x is None and y is None) or torch.equal(x, y)
    for st in (a, b):
        assert torch.isfinite(st.loglik_total).all()
        assert (st.dpm_counts.sum(-1) == 20).all()
        assert torch.equal(st.rates, torch.gather(st.dpm_values, 1,
                                                  st.dpm_assign.long()))


def test_mode3_dpm_recovers_two_groups_like_jax():
    """A panel whose individuals self at 0.1 or 0.8 in two groups: mode 3
    under the DPM prior separates the groups as the JAX package's run
    does.  Per-individual S sees the data through one G each, so both
    packages shrink the group means towards each other (about 0.3 and 0.6
    at this depth); the port's group means lie within 0.05 of JAX's and
    more than 0.2 apart."""
    n, l = 60, 400
    jp = jax_synth(n_indv=n, n_loci=l, n_pops=2, n_alleles=2,
                   selfing_rates=np.array([0.1, 0.8]), admixture_alpha=0.02,
                   seed=19)
    truth = np.array([0.1, 0.8])[jp.pop_index]
    data = convert.dataset_from_numpy(fields(jp.data))
    sched = dict(n_iter=400, burnin=200, thinning=2, n_chains=2, ckrep=20,
                 nstep_check_empty_cluster=20)
    res = run_mcmc(data, ModelSpec(mode=3, n_pops=2, priors=Priors(
        family=PriorFamily.DPM)), Schedule(**sched), seed=2, device="cpu")
    jres = jax_run_mcmc(jp.data, JSpec(mode=3, n_pops=2, priors=JPriors(
        family=JFamily.DPM)), JSchedule(**sched), jax.random.key(2))
    got = res.accum.mean.rates.mean(0).numpy()
    want = np.asarray(jres.accum.mean.rates).mean(0)
    lo, hi = truth < 0.45, truth > 0.45
    assert lo.any() and hi.any()
    for g in (lo, hi):
        assert abs(got[g].mean() - want[g].mean()) < 0.05
    assert got[hi].mean() - got[lo].mean() > 0.2
    assert want[hi].mean() - want[lo].mean() > 0.2
