"""The JAX samplers' threefry draws, replayed through the port's sampler
noise interface (``instruct_tpu_torch/samplers/noise.py``), for the tests
that hold the port's samplers to the JAX package's
(``test_torch_samplers.py``, ``test_torch_samplers_replay.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch


def fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel):
    """Equal to ``rel`` of the larger of 1 and the values' magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(initial=1.0))


def _normals(key, shapes):
    ks = jax.random.split(key, len(shapes))
    return [jax.random.normal(k, s, jnp.float32) for k, s in zip(ks, shapes)]


def _transition_key(key, phase, step):
    return jax.random.fold_in(jax.random.split(key, 3)[phase], step)


@functools.partial(jax.jit, static_argnames=("shapes", "high"))
def _hmc_draws(keys, phase, step, shapes, high):
    """hmc.py:96-101 (transition) and 155-187 (its keys), per chain."""
    def one(key):
        kp, ka, kj = jax.random.split(_transition_key(key, phase, step), 3)
        return (_normals(kp, shapes), jax.random.uniform(ka, minval=1e-30),
                jax.random.randint(kj, (), 0, high))
    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnames=("shapes", "depth"))
def _nuts_draws(keys, phase, step, shapes, depth):
    """nuts.py:117, 166-167, 231-238 and run_nuts's keys, per chain."""
    def one(key):
        k_mom, k_dir = jax.random.split(_transition_key(key, phase, step))
        dirs, subs, leaves = [], [], []
        for j in range(depth):
            kd, ks, kn = jax.random.split(jax.random.fold_in(k_dir, j), 3)
            dirs.append(jax.random.bernoulli(kd))
            subs.append(jax.random.uniform(ks, minval=1e-37))
            leaves.append(jax.vmap(lambda i, kn=kn: jax.random.uniform(
                jax.random.fold_in(kn, i), minval=1e-37))(
                    jnp.arange(2 ** j)))
        return (_normals(k_mom, shapes), jnp.stack(dirs), jnp.stack(subs),
                jnp.concatenate(leaves))
    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnames=("shapes", "n"))
def _svi_draws(key, step, shapes, n):
    """svi.py:30-40."""
    keys = jax.random.split(jax.random.fold_in(key, step), n)
    return jax.vmap(lambda k: _normals(k, shapes))(keys)


@functools.partial(jax.jit, static_argnames=("shapes",))
def _smc_draws(key, temp, k, shapes):
    """smc.py:57-67 (the MH step's proposal and accept)."""
    _kr, km = jax.random.split(jax.random.fold_in(key, temp))
    kp, ka = jax.random.split(jax.random.fold_in(km, k))
    return (_normals(kp, shapes),
            jax.random.uniform(ka, (shapes[0][0],), minval=1e-30))


@jax.jit
def _smc_resample_u(key, temp):
    """smc.py:34-36 (the resampling uniform)."""
    kr, _km = jax.random.split(jax.random.fold_in(key, temp))
    return jax.random.uniform(kr)


def _torch(tree):
    return [t(np.asarray(x)) for x in tree]


class JaxNoise:
    """The noise interface of ``samplers/noise.py``, replaying the JAX
    samplers' threefry draws: ``keys`` are the per-chain keys handed to
    ``run_hmc`` / ``run_nuts`` (or the one key of ``run_svi`` /
    ``run_smc``)."""

    def __init__(self, keys):
        self.keys = jnp.stack(list(keys))

    def hmc(self, phase, step, like, high):
        mom, u, jit = _hmc_draws(self.keys, phase, step,
                                 tuple(tuple(x.shape[1:]) for x in like),
                                 high)
        return _torch(mom), t(np.asarray(u)), t(np.asarray(jit)).long()

    def nuts(self, phase, step, like, depth):
        mom, dirs, subs, leaves = _nuts_draws(
            self.keys, phase, step, tuple(tuple(x.shape[1:]) for x in like),
            depth)
        return (_torch(mom), t(np.asarray(dirs)), t(np.asarray(subs)),
                t(np.asarray(leaves)))

    def svi(self, step, like, n):
        return _torch(_svi_draws(self.keys[0], step,
                                 tuple(tuple(x.shape) for x in like), n))

    def smc_mutation(self, temp, k, like):
        z, u = _smc_draws(self.keys[0], temp, k,
                          tuple(tuple(x.shape) for x in like))
        return _torch(z), t(np.asarray(u))

    def smc_resample(self, temp):
        return t(np.asarray(_smc_resample_u(self.keys[0], temp)))
