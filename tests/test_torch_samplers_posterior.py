"""Posterior checks of the port's gradient samplers on the CPU, the ones
``tests/test_samplers.py`` and ``tests/test_nuts.py`` make of the JAX
package's: moments of known Gaussian targets (HMC, NUTS, SVI), the SMC
log-evidence of a conjugate Gaussian, the selfing rates recovered by SVI
on the 40 x 60 panel (by HMC: ``test_torch_samplers_replay.py``), and NUTS (``run_sampler``) against the port's
own Gibbs engine in mode 2 on the 40 x 80 panel.

The NUTS run here is shorter than the JAX test's (``max_depth`` 4 for 50 +
50 draws of 2 chains, against 8 chains of 800 Gibbs sweeps; the JAX test:
depth 8, 100 + 100 draws of 1 chain against 2 chains of 2000 sweeps): on
the CPU the plain versions make a gradient of the 40 x 80 panel cost
7-20 ms, and this posterior drives NUTS to its maximum depth, so the JAX
schedule takes ~50 000 of them.  More chains on both sides keep the
estimates' noise under the JAX test's tolerances, which are kept."""

import numpy as np
import pytest
import torch

from instruct_tpu_torch import ModelSpec, Schedule, run_mcmc
from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.hmc import HmcConfig, run_hmc
from instruct_tpu_torch.samplers.noise import PhiloxNoise
from instruct_tpu_torch.samplers.nuts import NutsConfig, run_nuts
from instruct_tpu_torch.samplers.potential import MarginalModel
from instruct_tpu_torch.samplers.run import run_sampler
from instruct_tpu_torch.samplers.smc import SmcConfig, run_smc
from instruct_tpu_torch.samplers.svi import SviConfig, run_svi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noise(seed):
    return PhiloxNoise(seed, "cpu")


def test_hmc_gaussian_target():
    scales = torch.tensor([1.0, 3.0])

    def potential(x):
        return 0.5 * ((x / scales) ** 2).sum(-1)

    samples, acc, _ = run_hmc(potential, torch.zeros((1, 2)), noise(0),
                              HmcConfig(n_warmup=300, n_samples=600,
                                        n_leapfrog=8))
    s = samples[0].numpy()
    assert float(acc[0]) > 0.5
    assert abs(s[:, 0].std() - 1.0) < 0.3
    assert abs(s[:, 1].std() - 3.0) < 1.0


def test_nuts_correlated_gaussian_moments():
    mu = torch.tensor([1.0, -2.0, 0.5])
    cov = torch.tensor([[1.0, 0.8, 0.2], [0.8, 1.5, -0.3],
                        [0.2, -0.3, 0.7]])
    prec = torch.linalg.inv(cov)

    def potential(x):
        d = x - mu
        return 0.5 * ((d @ prec) * d).sum(-1)

    samples, accept, _ = run_nuts(potential, torch.zeros((1, 3)), noise(0),
                                  NutsConfig(n_warmup=400, n_samples=1500,
                                             max_depth=8, init_step=0.2))
    s = samples[0].numpy()
    assert 0.5 < float(accept[0]) <= 1.0
    np.testing.assert_allclose(s.mean(0), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov.numpy(), atol=0.45)


def test_svi_gaussian_target():
    mu_true = torch.tensor([1.0, -2.0])

    def log_joint(x):
        return -0.5 * ((x - mu_true) ** 2 / 0.25).sum(-1)

    # the final iterate's spread over seeds is ~0.1 (JAX's run_svi alike)
    mu, log_sigma, elbo = run_svi(log_joint, torch.zeros(2), noise(0),
                                  SviConfig(n_steps=800, learning_rate=0.05))
    np.testing.assert_allclose(mu.numpy(), mu_true.numpy(), atol=0.15)
    np.testing.assert_allclose(np.exp(log_sigma.numpy()), 0.5, atol=0.2)
    assert elbo[-50:].mean() > elbo[:50].mean()


def test_smc_gaussian_marginal_likelihood():
    # prior N(0, 1), likelihood N(x; 1, 1) -> evidence N(1; 0, 2)
    def log_prior(x):
        return -0.5 * (x ** 2).sum(-1) - 0.5 * np.log(2 * np.pi)

    def log_joint(x):
        return (log_prior(x) - 0.5 * ((x - 1.0) ** 2).sum(-1)
                - 0.5 * np.log(2 * np.pi))

    init = noise(2).init([(1,)], 256)[0]
    parts, logz, ess = run_smc(log_joint, log_prior, init, noise(3),
                               SmcConfig(n_particles=256, n_temps=15,
                                         n_mh_steps=5, rw_scale=0.4))
    want = -0.5 * np.log(2 * np.pi * 2.0) - 0.5 * 1.0 / 2.0
    assert abs(float(logz) - want) < 0.25, (float(logz), want)
    assert float(parts.mean()) == pytest.approx(0.5, abs=0.25)
    assert bool((ess > 0).all())


@pytest.fixture(scope="module")
def panel60():
    return synthetic_panel(n_indv=40, n_loci=60, n_pops=2, n_alleles=2,
                           selfing_rates=np.array([0.1, 0.8]),
                           admixture_alpha=0.05, seed=77)


def test_svi_recovers_selfing_rates(panel60):
    model = MarginalModel(ModelSpec(mode=2, n_pops=2), panel60.data)
    params = model.init(noise(6), 1)
    mu, _, _ = run_svi(model.log_joint, tr.tmap(lambda x: x[0], params),
                       noise(7), SviConfig(n_steps=400, learning_rate=0.05))
    s = np.sort(torch.sigmoid(mu.phi_s).numpy())
    assert s[0] < 0.45 and s[1] > 0.55, s


def test_nuts_selfing_posterior_matches_gibbs():
    panel = synthetic_panel(n_indv=40, n_loci=80, n_pops=2,
                            selfing_rates=np.array([0.15, 0.75]), seed=3)
    spec = ModelSpec(mode=2, n_pops=2)
    gibbs = run_mcmc(panel.data, spec,
                     Schedule(n_iter=800, burnin=400, thinning=5,
                              n_chains=8, ckrep=50,
                              nstep_check_empty_cluster=40),
                     0, device="cpu")
    # sort per chain: label switching
    s_gibbs = np.sort(gibbs.accum.mean.rates.numpy(), axis=1).mean(0)
    res = run_sampler("nuts", panel.data, spec,
                      Schedule(n_iter=150, burnin=100, thinning=1,
                               n_chains=2, ckrep=10,
                               nstep_check_empty_cluster=10), 1,
                      device="cpu",
                      config=NutsConfig(n_warmup=50, n_samples=50,
                                        max_depth=4, init_step=0.02))
    np.testing.assert_allclose(np.sort(res.s_mean), s_gibbs, atol=0.12)
