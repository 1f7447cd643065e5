"""NUTS (``run_sampler``) against the port's own Gibbs engine in modes 3, 4
and 5 on the 40 x 80 panel of ``tests/test_nuts.py``, on the CPU: one
agreement check per extended mode family, per-individual selfing (3), pop
inbreeding F (4) and individual F (5), with the JAX test's tolerances.

The runs are shorter than the JAX test's (NUTS at ``max_depth`` 4 for 50 +
50 draws of 2 chains, against 8 chains of 800 Gibbs sweeps; the JAX test:
depth 8, 100 + 100 draws of 1 chain against 2 chains of 2000 sweeps): on
the CPU a gradient of the 40 x 80 panel costs 4-20 ms in the plain
versions, and this posterior drives NUTS to its maximum depth.  More
chains on both sides keep the estimates' noise (two Gibbs chains of mode
3 differ by ~0.1 on average) under the JAX test's tolerances, which are
kept."""

import numpy as np
import pytest
import torch

from instruct_tpu_torch import ModelSpec, Schedule, run_mcmc
from instruct_tpu_torch.data.synthetic import synthetic_panel
from instruct_tpu_torch.samplers.nuts import NutsConfig
from instruct_tpu_torch.samplers.run import run_sampler


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(n_indv=40, n_loci=80, n_pops=2,
                           selfing_rates=np.array([0.1, 0.8]),
                           admixture_alpha=0.05, seed=21)


@pytest.mark.parametrize("mode", [3, 4, 5])
def test_nuts_posterior_matches_gibbs_modes345(panel, mode):
    spec = ModelSpec(mode=mode, n_pops=2)
    gibbs = run_mcmc(panel.data, spec,
                     Schedule(n_iter=800, burnin=400, thinning=5,
                              n_chains=8, ckrep=50,
                              nstep_check_empty_cluster=40),
                     0, device="cpu")
    r_gibbs = gibbs.accum.mean.rates.numpy()                 # [C, R]
    res = run_sampler("nuts", panel.data, spec,
                      Schedule(n_iter=150, burnin=100, thinning=1,
                               n_chains=2, ckrep=10,
                               nstep_check_empty_cluster=10), 1,
                      device="cpu",
                      config=NutsConfig(n_warmup=50, n_samples=50,
                                        max_depth=4, init_step=0.02))
    if mode == 4:
        # pop-level F: exchangeable cluster labels -- compare sorted
        np.testing.assert_allclose(np.sort(res.s_mean),
                                   np.sort(r_gibbs, axis=1).mean(0),
                                   atol=0.15)
    else:
        # per-individual rates: label-free; elementwise and mean agreement
        # (with 80 loci the per-individual marginals are wide, posterior
        # sd ~0.2, so two short-chain estimates differ by ~0.05-0.1)
        d = np.abs(res.s_mean - r_gibbs.mean(0))
        assert d.mean() < 0.12, (d.mean(), d.max())
        assert d.max() < 0.35, d.max()
