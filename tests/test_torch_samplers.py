"""The port's gradient samplers (``instruct_tpu_torch/samplers/``) against
the JAX package's (``instruct_tpu/samplers/``) on the CPU.

* The marginalized potential's value and gradient equal JAX's in modes
  1-5 on the same parameters (``convert.marginal_params_from_numpy``).
* With JAX's own threefry draws replayed through the noise interface
  (:class:`JaxNoise`: the ``split`` / ``fold_in`` sequence of ``hmc.py``,
  ``nuts.py``, ``svi.py`` and ``smc.py``), short runs of ``run_hmc``,
  ``run_nuts``, ``run_svi`` and ``run_smc`` reproduce the JAX functions'
  output on a 2-D correlated Gaussian (on a small mode-2 panel:
  ``test_torch_samplers_replay.py``).
* ``_systematic_resample`` gives JAX's indices exactly.
* A chain run in a batch is bitwise the same chain run alone (Philox
  noise keyed by chain).

Tolerances: the potential to 1e-5 of its magnitude (a sum of ~10^3 float32
logs in another order); the replayed runs to 1e-3 of the values' magnitude
(NUTS on the Gaussian 1e-4).  The two frameworks round the potential's
gradient differently (~1e-7 relative), and dual averaging feeds each
trajectory's accept rate back into the step size, so the gap grows with
the run: 1e-5-1e-4 after the runs below, 1e-3-1e-1 after 15-30 HMC
transitions (a divergence, not a fault: each step matches).  The runs are
kept that short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.samplers import hmc as jhmc
from instruct_tpu.samplers import nuts as jnuts
from instruct_tpu.samplers import smc as jsmc
from instruct_tpu.samplers import svi as jsvi
from instruct_tpu.samplers.potential import MarginalModel as JModel

from _sampler_noise import JaxNoise, close, fields, t
from instruct_tpu_torch import ModelSpec, convert
from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.hmc import HmcConfig, run_hmc
from instruct_tpu_torch.samplers.noise import PhiloxNoise
from instruct_tpu_torch.samplers.nuts import (NutsConfig, nuts_transition,
                                              run_nuts)
from instruct_tpu_torch.samplers.potential import MarginalModel
from instruct_tpu_torch.samplers.smc import (SmcConfig, _systematic_resample,
                                             run_smc)
from instruct_tpu_torch.samplers.svi import SviConfig, run_svi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the potential
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
def test_potential_value_and_gradient_match_jax(small, mode):
    jmodel, model = models(small, mode)
    keys = jax.random.split(jax.random.key(mode), 3)
    jparams = jax.tree.map(lambda x: 5.0 * x, jax.vmap(jmodel.init)(keys))
    jparams = jparams._replace(phi_a=jnp.asarray([-1.0, 0.3, 2.5]))
    params = convert.marginal_params_from_numpy(fields(jparams))
    assert params.phi_s.shape == (3, {1: 0, 2: 2, 3: 12, 4: 2, 5: 12}[mode])
    for name in ("log_lik", "log_prior", "log_joint"):
        close(getattr(model, name)(params).numpy(),
              jax.jit(jax.vmap(getattr(jmodel, name)))(jparams), 1e-5)
    vals, grads = tr.value_and_grad(model.potential)(params)
    jvals, jgrads = jax.jit(jax.vmap(jax.value_and_grad(jmodel.potential)))(
        jparams)
    close(vals.numpy(), jvals, 1e-5)
    for name, g in zip(params._fields, grads):
        close(g.numpy(), getattr(jgrads, name), 1e-5)
    for name in ("selfing_rates", "admixture"):
        close(getattr(model, name)(params).numpy(),
              jax.vmap(getattr(jmodel, name))(jparams), 1e-6)


def test_marginal_model_refuses_what_jax_refuses(small):
    _, data = small
    with pytest.raises(ValueError, match="admixture modes 1-5"):
        MarginalModel(ModelSpec(mode=0, n_pops=2), data)
    with pytest.raises(ValueError, match="diploid-only"):
        MarginalModel(ModelSpec(mode=2, ploid=4, n_pops=2), data)


def test_params_carry_across_with_and_without_a_batch_axis(small):
    jmodel, _ = models(small, 2)
    one = jmodel.init(jax.random.key(0))
    got = convert.marginal_params_from_numpy(fields(one))
    assert got.phi_p.shape == (1, 2, 20, 2) and got.phi_a.shape == (1,)
    again = convert.marginal_params_from_numpy(
        [np.asarray(x) for x in one])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---------------------------------------------------------------------------
# the samplers with JAX's draws replayed
# ---------------------------------------------------------------------------

MU = np.array([1.0, -2.0], np.float32)
COV = np.array([[1.0, 0.8], [0.8, 1.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def gauss_jax(x):
    d = x - MU
    return 0.5 * d @ PREC @ d


def gauss_torch(x):
    d = x - t(MU)
    return 0.5 * ((d @ t(PREC)) * d).sum(-1)


def chain_keys(n, seed=0):
    return list(jax.random.split(jax.random.key(seed), n))


def test_hmc_replays_jax_on_a_gaussian():
    cfg = dict(n_warmup=10, n_samples=5, n_leapfrog=6, init_step=0.1)
    keys = chain_keys(2, 1)
    init = np.array([[0.0, 0.0], [0.5, -1.0]], np.float32)
    want = [jhmc.run_hmc(gauss_jax, jnp.asarray(init[b]), keys[b],
                         jhmc.HmcConfig(**cfg)) for b in range(2)]
    got, acc, state = run_hmc(gauss_torch, t(init), JaxNoise(keys),
                              HmcConfig(**cfg))
    for b in range(2):
        close(got[b].numpy(), want[b][0], 1e-3)
        close(acc[b].item(), want[b][1], 1e-3)
        close(state.log_step[b].item(), want[b][2].log_step, 1e-3)
        close(state.inv_mass[b].numpy(), want[b][2].inv_mass, 1e-3)


def test_nuts_replays_jax_on_a_gaussian():
    cfg = dict(n_warmup=20, n_samples=20, max_depth=5, init_step=0.2)
    keys = chain_keys(2, 2)
    init = np.array([[0.0, 0.0], [2.0, 1.0]], np.float32)
    want = [jnuts.run_nuts(gauss_jax, jnp.asarray(init[b]), keys[b],
                           jnuts.NutsConfig(**cfg)) for b in range(2)]
    got, acc, pos = run_nuts(gauss_torch, t(init), JaxNoise(keys),
                             NutsConfig(**cfg))
    for b in range(2):
        close(got[b].numpy(), want[b][0], 1e-4)
        close(acc[b].item(), want[b][1], 1e-4)
        close(pos[b].numpy(), want[b][2], 1e-4)


def test_svi_replays_jax_and_adam_matches_optax():
    def lj_jax(x):
        return -0.5 * jnp.sum((x - MU) ** 2 / 0.25)

    def lj_torch(x):
        return -0.5 * ((x - t(MU)) ** 2 / 0.25).sum(-1)

    key = jax.random.key(3)
    cfg = dict(n_steps=60, learning_rate=0.05)
    mu, ls, elbo = jsvi.run_svi(lj_jax, jnp.zeros(2), key,
                                jsvi.SviConfig(**cfg))
    got_mu, got_ls, got_elbo = run_svi(lj_torch, torch.zeros(2),
                                       JaxNoise([key]), SviConfig(**cfg))
    close(got_mu.numpy(), mu, 1e-5)
    close(got_ls.numpy(), ls, 1e-5)
    close(got_elbo.numpy(), elbo, 1e-5)


def test_torch_adam_step_matches_optax():
    import optax
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=5).astype(np.float32)
    grads = rng.normal(size=(40, 5)).astype(np.float32) * np.logspace(
        -4, 1, 40, dtype=np.float32)[:, None]
    opt = optax.adam(0.02)
    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    p = t(x0).requires_grad_(True)
    topt = torch.optim.Adam([p], lr=0.02, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st)
        x = optax.apply_updates(x, upd)
        p.grad = t(g)
        topt.step()
        # float32 rounding: optax divides by bias-corrected moments,
        # torch folds the corrections into the step size
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x),
                                   rtol=1e-5, atol=1e-6)


def test_smc_replays_jax_on_a_gaussian():
    def lp_jax(x):
        return -0.5 * jnp.sum(x ** 2) - 0.5 * jnp.log(2 * jnp.pi)

    def lj_jax(x):
        return lp_jax(x) - 0.5 * jnp.sum((x - 1.0) ** 2) \
            - 0.5 * jnp.log(2 * jnp.pi)

    def lp_torch(x):
        return -0.5 * (x ** 2).sum(-1) - 0.5 * np.log(2 * np.pi)

    def lj_torch(x):
        return lp_torch(x) - 0.5 * ((x - 1.0) ** 2).sum(-1) \
            - 0.5 * np.log(2 * np.pi)

    init = jax.random.normal(jax.random.key(4), (64, 1))
    key = jax.random.key(5)
    cfg = dict(n_particles=64, n_temps=6, n_mh_steps=3, rw_scale=0.4)
    parts, logz, ess = jsmc.run_smc(lj_jax, lp_jax, init, key,
                                    jsmc.SmcConfig(**cfg))
    gp, glogz, gess = run_smc(lj_torch, lp_torch, t(np.asarray(init)),
                              JaxNoise([key]), SmcConfig(**cfg))
    close(gp.numpy(), parts, 1e-5)
    close(glogz.item(), logz, 1e-5)
    close(gess.numpy(), ess, 1e-4)


def test_systematic_resample_gives_jax_indices():
    rng = np.random.default_rng(1)
    for n, seed in ((8, 0), (64, 1), (257, 2)):
        log_w = rng.normal(size=n).astype(np.float32) * 3
        key = jax.random.key(seed)
        want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(log_w),
                                                    n))
        u = t(np.asarray(jax.random.uniform(key)))
        got = _systematic_resample(u, t(log_w), n)
        np.testing.assert_array_equal(got.numpy(), want)
    # by hand: weights 1/2, 1/4, 1/4 (cum 0.5, 0.75, 1); u = 0.1 puts the
    # positions 0.1/3, 1.1/3, 2.1/3 at indices 0, 0, 1
    lw = torch.log(torch.tensor([0.5, 0.25, 0.25]))
    for u, want in ((0.1, [0, 0, 1]), (0.6, [0, 1, 2]), (0.9, [0, 1, 2]),
                    (0.0, [0, 0, 1])):
        assert _systematic_resample(torch.tensor(u), lw, 3).tolist() == want


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def test_a_chain_in_a_batch_is_the_chain_run_alone(small):
    _, model = models(small, 2)
    init = model.init(PhiloxNoise(11, "cpu"), 3)
    row = tr.tmap(lambda x: x[1:2], init)
    for run, cfg in ((run_hmc, HmcConfig(n_warmup=4, n_samples=4,
                                         n_leapfrog=3, init_step=0.05)),
                     (run_nuts, NutsConfig(n_warmup=3, n_samples=3,
                                           max_depth=4, init_step=0.05))):
        batch, bacc, _ = run(model.potential, init, PhiloxNoise(5, "cpu"),
                             cfg, collect=lambda p: p)
        alone, aacc, _ = run(model.potential, row,
                             PhiloxNoise(5, "cpu", chains=[1]), cfg,
                             collect=lambda p: p)
        for x, y in zip(batch, alone):
            assert torch.equal(x[1:2], y)
        assert torch.equal(bacc[1:2], aacc)


def test_nuts_transition_is_finite_and_moves():
    def potential(x):
        return 0.5 * (x * x).sum(-1)

    grad = tr.value_and_grad(potential)
    pos = torch.ones((2, 4))
    draws = PhiloxNoise(1, "cpu").nuts(0, 0, [pos], 6)
    new, pa, (u, g) = nuts_transition(grad, torch.ones((2, 4)),
                                      torch.full((2,), 0.3), 6, pos, draws)
    assert torch.isfinite(new).all()
    assert bool(((pa >= 0) & (pa <= 1)).all())
    assert not torch.allclose(new, pos)
    torch.testing.assert_close(u, potential(new))
    torch.testing.assert_close(g, new)


def test_philox_noise_is_keyed_by_chain_and_salt():
    from instruct_tpu_torch.kernels import philox as px
    ids = [v for k, v in vars(px).items() if k.startswith("STREAM_")]
    assert len(set(ids)) == len(ids)
    assert sorted(v for v in ids if v >= 23) == list(range(23, 36))
    x = [torch.zeros((3, 5)), torch.zeros((3,))]
    a = PhiloxNoise(9, "cpu").hmc(0, 4, x, 8)
    b = PhiloxNoise(9, "cpu", chains=[2]).hmc(0, 4, [v[:1] for v in x], 8)
    assert torch.equal(a[0][0][2:], b[0][0]) and torch.equal(a[1][2:], b[1])
    c = PhiloxNoise(9, "cpu").child(1).hmc(0, 4, x, 8)
    assert not torch.equal(a[0][0], c[0][0])
    assert bool(((a[2] >= 0) & (a[2] < 8)).all())
    mom, fwd, sub, leaf = PhiloxNoise(9, "cpu").nuts(2, 0, x, 5)
    assert fwd.shape == (3, 5) and sub.shape == (3, 5)
    assert leaf.shape == (3, 31) and bool(((leaf > 0) & (leaf < 1)).all())
    z = torch.cat([m.flatten() for m in
                   PhiloxNoise(9, "cpu").jitter([torch.zeros(4000)], 8)])
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03
