"""The port's loci-sharded runs against the JAX package, in gloo worlds of
CPU processes (``tests/_torch_world.py``):

* the all-reduced per-individual log-lik that leaves a (1, 4) run equals
  the JAX package's ``per_indv_loglik`` (diploid modes 1, 2, 4, 5) or its
  tetraploid site log-lik (auto, allo; a panel spanning the allele-count
  classes 2-4, padded per class) on the gathered final state over the
  whole panel, at the bound of ``tests/test_sharding.py`` (rtol = atol =
  2e-5) -- which checks where the sums are taken and how the state is put
  back together;
* the posterior of a (1, 2) run matches the JAX package's own sharded run
  (``run_mcmc(mesh=make_mesh(2, 4))`` on the 8 virtual devices) at the
  configuration and tolerances of ``tests/test_sharding.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import run_world
from instruct_tpu.config import ModelSpec as JSpec, Schedule as JSched
from instruct_tpu.data.dataset import make_dataset as j_make_dataset
from instruct_tpu.data.synthetic import synthetic_panel as j_panel
from instruct_tpu.mcmc.driver import run_mcmc as j_run_mcmc
from instruct_tpu.model import likelihood as jlk
from instruct_tpu.parallel.mesh import make_mesh as j_make_mesh
from instruct_tpu.tetra import engine as jeng

from instruct_tpu_torch import ModelSpec, Schedule

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj):
    return {name: None if v is None else np.asarray(v)
            for name, v in obj._asdict().items()}


def _mixed_class_tetra(n=8, l=15, seed=5):
    """The mixed allele-count panel of ``tests/test_tetra_sharding.py``."""
    rng = np.random.default_rng(seed)
    n_alleles = rng.choice([2, 3, 4], size=l, p=[0.5, 0.3, 0.2])
    n_alleles[:3] = [2, 3, 4]
    nd = np.minimum(rng.integers(1, 5, size=(n, l)), n_alleles[None, :])
    distinct = np.zeros((n, l, 4), np.int32)
    for i in range(n):
        for j in range(l):
            vals = np.sort(rng.choice(n_alleles[j], size=nd[i, j],
                                      replace=False))
            distinct[i, j, :nd[i, j]] = vals
    return j_make_dataset(distinct, np.zeros((n, l), bool),
                          n_alleles.astype(np.int32), distinct=distinct,
                          n_distinct=nd)


LOGLIK_CASES = {f"mode {m}": ModelSpec(mode=m, n_pops=2)
                for m in (1, 2, 4, 5)}
LOGLIK_CASES.update({
    "tetra auto": ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=True),
    "tetra allo": ModelSpec(mode=2, ploid=4, n_pops=2, autopoly=False)})


def _jax_data(spec):
    if spec.ploid == 4:
        return _mixed_class_tetra()
    return j_panel(n_indv=9, n_loci=13, n_pops=2, seed=5).data


@pytest.fixture(scope="module")
def loglik_world():
    """One (1, 4) world running every case (L = 13 pads to 16 on the
    diploid panel; the tetraploid plan pads each class)."""
    sched = Schedule(n_iter=12, burnin=4, thinning=2, n_chains=2, ckrep=2,
                     nstep_check_empty_cluster=2)
    args = [(_fields(_jax_data(spec)), spec, sched, 3)
            for spec in LOGLIK_CASES.values()]
    outs = run_world("run_cases", 4, (args, (1, 4)), timeout=150)
    return outs


def _jax_loglik(spec, jdata, st):
    jspec = JSpec(mode=spec.mode, ploid=spec.ploid, n_pops=spec.n_pops,
                  autopoly=spec.autopoly)
    out = []
    if spec.ploid == 4:
        tables = jeng.build_tables(jspec, jdata, with_candidates=False)
    for ci in range(st["q"].shape[0]):
        freq = jnp.asarray(st["freq"][ci])
        if spec.ploid == 4:
            freq2 = jnp.asarray(st["freq2"][ci])
            log_hwe = jeng.log_hwe_table(tables, jspec, freq, freq2)
            table = jeng.selfing_equilibrium(tables, log_hwe,
                                             jnp.asarray(st["rates"][ci]))
            site = jeng._site_loglik(tables, jspec, jdata, freq, freq2,
                                     jnp.asarray(st["z"][ci]),
                                     jnp.asarray(st["geno"][ci]), table)
            out.append(np.asarray(site.sum(axis=1)))
            continue
        gen = jnp.asarray(st["gen"][ci]) if spec.has_selfing else None
        rates = (jnp.asarray(st["rates"][ci]) if st["rates"].size
                 else None)
        out.append(np.asarray(jlk.per_indv_loglik(
            jspec, jdata, freq, jnp.asarray(st["z"][ci]),
            jnp.asarray(st["q"][ci]), gen, rates)))
    return np.stack(out)


@needs_8
@pytest.mark.parametrize("case", list(LOGLIK_CASES))
def test_sharded_loglik_is_jax_loglik_of_the_gathered_state(loglik_world,
                                                            case):
    i = list(LOGLIK_CASES).index(case)
    spec = LOGLIK_CASES[case]
    jdata = _jax_data(spec)
    ranks = [o[i] for o in loglik_world]
    st = ranks[0]["state"]
    l = jdata.site_valid.shape[1]
    assert st["freq"].shape[2] == l
    assert st["z"].shape[2] == spec.ploid * l
    np.testing.assert_allclose(st["loglik_indv"],
                               _jax_loglik(spec, jdata, st),
                               rtol=2e-5, atol=2e-5)
    # every rank holds the whole, equal result
    for r in ranks[1:]:
        for name, v in st.items():
            if v is not None:
                assert np.array_equal(r["state"][name], v), (case, name)


@needs_8
def test_sharded_posterior_matches_jax_sharded_run():
    jdata = j_panel(n_indv=40, n_loci=24, n_pops=2, seed=9).data
    jspec = JSpec(mode=2, n_pops=2)
    jsched = JSched(n_iter=1200, burnin=400, thinning=2, n_chains=2,
                    ckrep=10, nstep_check_empty_cluster=10)
    ref = j_run_mcmc(jdata, jspec, jsched, jax.random.key(1),
                     mesh=j_make_mesh(2, 4))
    sched = Schedule(n_iter=1200, burnin=400, thinning=2, n_chains=2,
                     ckrep=10, nstep_check_empty_cluster=10)
    outs = run_world("run_case", 2, (_fields(jdata), ModelSpec(mode=2,
                                                               n_pops=2),
                                     sched, 1, (1, 2)), timeout=150)
    got = outs[0]["accum"]["mean"]
    s_ref = np.sort(np.asarray(ref.accum.mean.rates), axis=-1)
    s_got = np.sort(got["rates"], axis=-1)
    np.testing.assert_allclose(s_got.mean(0), s_ref.mean(0), atol=0.12)
    ll_ref = np.asarray(ref.accum.mean.total_ll).mean()
    ll_got = got["total_ll"].mean()
    assert abs(ll_got - ll_ref) / abs(ll_ref) < 0.02
    for o in outs[1:]:
        assert np.array_equal(o["accum"]["mean"]["rates"], got["rates"])


@needs_8
@pytest.mark.parametrize("mode", [2, 4])
def test_convert_carries_a_jax_sharded_state_across(mode):
    """``convert.state_from_sharded`` puts a JAX (2, 4)-sharded run's
    final state (blocked z, padded P) into the port's layout: the port's
    per-individual log-lik of it over the whole panel is the log-lik the
    JAX run left (its all-reduced sums), at the bound above."""
    from instruct_tpu_torch import convert
    from instruct_tpu_torch.model import likelihood as lk
    jdata = j_panel(n_indv=9, n_loci=13, n_pops=2, seed=5).data
    jspec = JSpec(mode=mode, n_pops=2)
    jsched = JSched(n_iter=12, burnin=4, thinning=2, n_chains=2, ckrep=2,
                    nstep_check_empty_cluster=2)
    res = j_run_mcmc(jdata, jspec, jsched, jax.random.key(3),
                     mesh=j_make_mesh(2, 4))
    data = convert.dataset_from_numpy(_fields(jdata))
    st = convert.state_from_sharded(_fields(res.final_state), data, 4,
                                    device="cpu")
    assert st.z.shape == (2, 9, 26) and st.freq.shape[2] == 13
    spec = ModelSpec(mode=mode, n_pops=2)
    got = lk.per_indv_loglik(spec, data, st.freq, st.z, st.q, st.gen,
                             st.rates)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(res.final_state.loglik_indv),
                               rtol=2e-5, atol=2e-5)
