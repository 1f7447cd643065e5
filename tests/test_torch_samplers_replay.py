"""Short runs of the port's gradient samplers against the JAX package's on
a small mode-2 panel, on the CPU, with JAX's own threefry draws replayed
through the noise interface (``_sampler_noise.JaxNoise``): ``run_hmc``,
``run_nuts``, ``run_svi`` and ``run_smc`` on the same parameters
(``convert.marginal_params_from_numpy``); and, with the port's own Philox
draws, HMC's recovery of the selfing rates on the 40 x 60 panel of
``tests/test_samplers.py`` (100 + 100 draws; the JAX test 150 + 150).  The companion Gaussian runs,
and why the runs are this short (the frameworks' float32 rounding of the
gradient is amplified by the step-size adaptation), are in
``test_torch_samplers.py``.  Tolerance: 1e-3 of the values' magnitude (the
runs below stay within 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _sampler_noise import JaxNoise, close, fields
from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.samplers import hmc as jhmc
from instruct_tpu.samplers import nuts as jnuts
from instruct_tpu.samplers import smc as jsmc
from instruct_tpu.samplers import svi as jsvi
from instruct_tpu.samplers.potential import MarginalModel as JModel

from instruct_tpu_torch import ModelSpec, convert
from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.hmc import HmcConfig, run_hmc
from instruct_tpu_torch.samplers.noise import PhiloxNoise
from instruct_tpu_torch.samplers.nuts import NutsConfig, run_nuts
from instruct_tpu_torch.samplers.potential import MarginalModel
from instruct_tpu_torch.samplers.smc import SmcConfig, run_smc
from instruct_tpu_torch.samplers.svi import SviConfig, run_svi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    jp = jax_panel(n_indv=12, n_loci=20, n_pops=2, n_alleles=2,
                   selfing_rates=np.array([0.1, 0.8]), admixture_alpha=0.05,
                   missing_rate=0.1, seed=77)
    return jp.data, convert.dataset_from_numpy(fields(jp.data))


def models(small, mode):
    jdata, data = small
    return (JModel(JSpec(mode=mode, n_pops=2), jdata),
            MarginalModel(ModelSpec(mode=mode, n_pops=2), data))


def chain_keys(n, seed=0):
    return list(jax.random.split(jax.random.key(seed), n))


def panel_run_args(small, mode=2):
    jmodel, model = models(small, mode)
    keys = chain_keys(2, 6)
    jinit = jax.vmap(jmodel.init)(jax.random.split(jax.random.key(7), 2))
    init = convert.marginal_params_from_numpy(fields(jinit))
    return jmodel, model, keys, jinit, init


def test_hmc_and_nuts_replay_jax_on_a_small_mode2_panel(small):
    jmodel, model, keys, jinit, init = panel_run_args(small)
    for run, jrun, cfg, jcfg in (
            (run_hmc, jhmc.run_hmc,
             HmcConfig(n_warmup=2, n_samples=4, n_leapfrog=4,
                       init_step=0.02),
             jhmc.HmcConfig(n_warmup=2, n_samples=4, n_leapfrog=4,
                            init_step=0.02)),
            (run_nuts, jnuts.run_nuts,
             NutsConfig(n_warmup=2, n_samples=3, max_depth=4,
                        init_step=0.02),
             jnuts.NutsConfig(n_warmup=2, n_samples=3, max_depth=4,
                              init_step=0.02))):
        got, acc, _ = run(model.potential, init, JaxNoise(keys), cfg,
                          collect=lambda p: p)
        want, wacc, _ = jax.vmap(
            lambda k, p0, jrun=jrun, jcfg=jcfg: jrun(jmodel.potential, p0,
                                                     k, jcfg))(
            jnp.stack(keys), jinit)
        for name, g in zip(got._fields, got):
            close(g.numpy(), getattr(want, name), 1e-3)
        close(acc.numpy(), wacc, 1e-3)


def test_svi_and_smc_replay_jax_on_a_small_mode2_panel(small):
    jmodel, model, keys, jinit, init = panel_run_args(small)
    one = jax.tree.map(lambda x: x[0], jinit)
    cfg = dict(n_steps=25, n_elbo_samples=3, learning_rate=0.05)
    mu, _, elbo = jsvi.run_svi(jmodel.log_joint, one, keys[0],
                               jsvi.SviConfig(**cfg))
    gmu, _, gelbo = run_svi(model.log_joint, tr.tmap(lambda x: x[0], init),
                            JaxNoise([keys[0]]), SviConfig(**cfg))
    close(gmu.phi_s.numpy(), mu.phi_s, 1e-4)
    close(gmu.phi_q.numpy(), mu.phi_q, 1e-4)
    close(gelbo.numpy(), elbo, 1e-5)
    n = 16
    jparts = jax.vmap(jmodel.init)(jax.random.split(jax.random.key(8), n))
    cfg = dict(n_particles=n, n_temps=4, n_mh_steps=2, rw_scale=0.05)
    parts, logz, ess = jsmc.run_smc(jmodel.log_joint, jmodel.log_prior,
                                    jparts, keys[1], jsmc.SmcConfig(**cfg))
    gparts, glogz, gess = run_smc(
        model.log_joint, model.log_prior,
        convert.marginal_params_from_numpy(fields(jparts)),
        JaxNoise([keys[1]]), SmcConfig(**cfg))
    close(gparts.phi_s.numpy(), parts.phi_s, 1e-4)
    close(glogz.item(), logz, 1e-5)
    close(gess.numpy(), ess, 1e-3)


@pytest.fixture(scope="module")
def panel60():
    return synthetic_panel(n_indv=40, n_loci=60, n_pops=2, n_alleles=2,
                           selfing_rates=np.array([0.1, 0.8]),
                           admixture_alpha=0.05, seed=77)


def test_hmc_recovers_selfing_rates(panel60):
    model = MarginalModel(ModelSpec(mode=2, n_pops=2), panel60.data)
    params = model.init(PhiloxNoise(4, "cpu"), 1)
    samples, acc, _ = run_hmc(model.potential, params, PhiloxNoise(5, "cpu"),
                              HmcConfig(n_warmup=100, n_samples=100,
                                        n_leapfrog=12, init_step=0.02),
                              collect=model.selfing_rates)
    s = np.sort(samples[0].numpy().mean(0))
    assert float(acc[0]) > 0.3, acc
    assert s[0] < 0.45 and s[1] > 0.55, s
