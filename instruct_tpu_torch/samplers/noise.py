"""The randomness of the gradient samplers, behind one small interface.

Every sampler takes its draws from a noise provider, one call per
transition, temperature step or optimizer step.  :class:`PhiloxNoise` is
the only provider the port itself uses: counter-based Philox words
(``kernels/philox.py``), keyed by (seed, salt, stream, step word, chain,
element), so that a chain's draws never depend on the batch it runs in or
on how many leapfrog steps the other chains took -- what ``fold_in`` under
``jax.vmap`` gives the JAX package.  The tests hand the samplers another
provider with the same methods that replays the JAX package's threefry
draws, and hold the two samplers' outputs together.

The methods, with ``like`` the position's leaves (each [B, ...]; for
:meth:`svi`, :meth:`jitter` and :meth:`draws` without the batch axis):

  hmc(phase, step, like, high)   momenta (standard normals like the
                                 leaves), the accept uniform [B] and the
                                 jitter in [0, high) [B] of an HMC
                                 transition (phase 0, 1: warm-up windows,
                                 2: sampling)
  nuts(phase, step, like, depth) momenta, directions bool[B, depth], the
                                 subtree uniforms [B, depth] and the leaf
                                 uniforms [B, 2^depth - 1] (leaf i of
                                 subtree j at 2^j - 1 + i) of a NUTS draw
  svi(step, like, n)             n reparameterization normals per leaf
  smc_mutation(temp, k, like)    proposal normals and accept uniforms [B]
                                 of MH step k at temperature ``temp``
  smc_resample(temp)             the resampling uniform (a 0-d tensor)
  init(shapes, n)                normals of MarginalModel.init, n rows
  jitter(like, n)                the warm start's per-chain normals
  draws(like, n)                 draws of SVI's fitted Gaussian
  child(salt)                    the provider of a sub-run

Uniforms lie in (0, 1), so their logarithm is finite.
"""

from __future__ import annotations

import math

import torch

from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels.dirichlet import box_muller

_STEP_BITS = 24


def _step_word(high: int, low: int, low_bits: int) -> int:
    if not 0 <= low < 1 << low_bits or not 0 <= high < 1 << (32 - low_bits):
        raise ValueError(f"step word out of range: ({high}, {low})")
    return (high << low_bits) | low


class PhiloxNoise:
    """Philox draws for the samplers.  ``seed`` keys the run; ``salt``
    tells sub-runs apart (it sits above the stream id in counter word c1);
    ``chains``, when given, are the chain keys of the batch rows of the
    per-chain draws (a chain run alone keeps its key of the batch)."""

    def __init__(self, seed: int, device="cuda", salt: int = 0,
                 chains=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.salt = int(salt)
        self.chains = None if chains is None else [int(c) for c in chains]
        self._keys = {}

    def child(self, salt: int) -> "PhiloxNoise":
        return PhiloxNoise(self.seed, self.device, salt, self.chains)

    def _rows(self, n: int, chains: bool) -> px.RngKeys:
        ck = self.chains if chains and self.chains is not None else None
        if ck is not None and len(ck) != n:
            raise ValueError(f"{n} batch rows, but {len(ck)} chain keys")
        key = (n, ck is not None)
        if key not in self._keys:
            self._keys[key] = px.make_keys(self.seed, n, self.device,
                                           chain_key=ck)
        return self._keys[key]

    def _words(self, stream: int, step: int, n: int, n_words: int,
               n_streams: int = 1, chains: bool = True) -> torch.Tensor:
        return px.random_streams(self._rows(n, chains), step,
                                 stream | (self.salt << 8), n_streams,
                                 n_words)

    def _normals(self, stream: int, step: int, shapes, n: int,
                 chains: bool = True) -> list:
        sizes = [math.prod(s) for s in shapes]
        total = sum(sizes)
        u = px.u01_open(self._words(stream, step, n, 2 * total,
                                    chains=chains)[:, 0])
        z = box_muller(u[:, :total], u[:, total:])
        out, lo = [], 0
        for s, size in zip(shapes, sizes):
            out.append(z[:, lo:lo + size].reshape((n,) + tuple(s)))
            lo += size
        return out

    def hmc(self, phase: int, step: int, like, high: int):
        n = like[0].shape[0]
        word = _step_word(phase, step, _STEP_BITS)
        mom = self._normals(px.STREAM_MOMENTUM, word,
                            [x.shape[1:] for x in like], n)
        w = self._words(px.STREAM_HMC_ACCEPT, word, n, 1, n_streams=2)
        jit = (px.u01_closed(w[:, 1, 0]) * high).to(torch.int64)
        return mom, px.u01_open(w[:, 0, 0]), jit.clamp_max(high - 1)

    def nuts(self, phase: int, step: int, like, depth: int):
        n = like[0].shape[0]
        word = _step_word(phase, step, _STEP_BITS)
        mom = self._normals(px.STREAM_MOMENTUM, word,
                            [x.shape[1:] for x in like], n)
        w = self._words(px.STREAM_NUTS_DIR, word, n, depth, n_streams=2)
        leaf = self._words(px.STREAM_NUTS_LEAF, word, n, (1 << depth) - 1)
        return (mom, px.u01_closed(w[:, 0]) < 0.5, px.u01_open(w[:, 1]),
                px.u01_open(leaf[:, 0]))

    def svi(self, step: int, like, n: int) -> list:
        return self._normals(px.STREAM_ELBO, step, [x.shape for x in like],
                             n, chains=False)

    def smc_mutation(self, temp: int, k: int, like):
        n = like[0].shape[0]
        word = _step_word(temp, k, 8)
        z = self._normals(px.STREAM_SMC_PROPOSAL, word,
                          [x.shape[1:] for x in like], n, chains=False)
        u = self._words(px.STREAM_SMC_ACCEPT, word, n, 1, chains=False)
        return z, px.u01_open(u[:, 0, 0])

    def smc_resample(self, temp: int) -> torch.Tensor:
        w = self._words(px.STREAM_SMC_RESAMPLE, temp, 1, 1, chains=False)
        return px.u01_closed(w[0, 0, 0])

    def init(self, shapes, n: int) -> list:
        return self._normals(px.STREAM_SAMPLER_INIT, 0, shapes, n,
                             chains=False)

    def jitter(self, like, n: int) -> list:
        return self._normals(px.STREAM_SAMPLER_JITTER, 0,
                             [x.shape for x in like], n)

    def draws(self, like, n: int) -> list:
        return self._normals(px.STREAM_SVI_DRAW, 0, [x.shape for x in like],
                             n, chains=False)
