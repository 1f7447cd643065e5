"""Philox4x32-10 in plain PyTorch integer ops — bit-identical to
``csrc/philox.cuh``.

The JAX package's TPU kernels draw from the on-core PRNG, seeded per block
with two key words (``instruct_tpu/kernels/fused_step.py:40-49``).  The port
uses one counter-based generator everywhere instead:

  key     = the run's 64-bit seed, two words (k0 low, k1 high)
  counter = (c0 element-block index, c1 stream id, c2 step index,
             c3 chain key)

so every (chain, step, kernel stream, element) owns its draw whatever the
launch geometry.  A kernel and its plain version therefore draw the same
uniforms from the same seed, on the card and on the CPU.

32-bit words live in int64 tensors; a 32x32->64 product is one wrapping int64
multiply.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF

# Stream ids (counter word c1): one per family of uniform planes.
STREAM_P = 1        # Dirichlet draw of the allele frequencies P
STREAM_S_PROP = 2   # S tail: random-walk proposals
STREAM_S_ACC = 3    # S tail: MH accept uniforms
STREAM_S_GEN = 4    # S tail: geometric G proposal
STREAM_S_LOGU = 5   # S tail: log-uniforms of the G accept
STREAM_Z = 6        # per-copy z draw of the site pass
STREAM_Q = 7        # Dirichlet draw of the admixture proportions Q
STREAM_ALPHA = 8    # alpha MH step (normal proposal + accept uniform)
# The updates that are plain tensor code draw from consecutive streams, so
# one launch of ``random_streams`` fills all that a sweep needs; word
# ``j * R + i`` of a stream belongs to (subsweep j, element i).
STREAM_R_PROP = 9   # S/F proposals (random walk, or the adaptive sampler's
#                     state transition)
STREAM_R_ACC = 10   # S/F MH accept uniforms
STREAM_G_PROP = 11  # geometric G proposal
STREAM_G_ACC = 12   # log-uniforms of the G accept
STREAM_R_FRESH = 13  # adaptive-independence sampler: the fresh U(0, 1) value
STREAM_HYPER = 14   # normal prior: the conjugate (mu, sigma^2) draw
STREAM_ZZ = 15      # mode 0: one z per individual
STREAM_GENO = 16    # tetraploid latent-genotype move: the Gumbel noise
STREAM_P2 = 17      # tetraploid (allo): Dirichlet draw of the second
#                     subgenome's allele frequencies
# The DPM prior (mcmc/dpm.py) and the G-marginal updates (mcmc/marg_g.py):
STREAM_DPM_SEAT = 18  # Gumbel noise of the seat choices: element
#                       j * (N + 1) + t of the CRP sweep (individual j,
#                       choice t; kernels/crp.py), j * T + t of the
#                       stick-breaking sweep's reseat over T components
STREAM_DPM_NEW = 19  # the CRP sweep's new-table values: U(0, 1) (the prior
#                      draw), Beta(g_j, 2) through the Dirichlet kernel
#                      (mode 3), or the Gumbel noise of the grid index,
#                      element j * M + m (mode 5)
STREAM_DPM_STICK = 20  # stick-breaking: the Beta draws of the sticks
STREAM_DPM_THETA = 21  # stick-breaking: the components' values, Beta
#                        through the Dirichlet kernel (mode 3) or the
#                        Gumbel noise of the grid index, t * M + m (mode 5)
STREAM_MARG_GEN = 22  # marginalize_g: Gumbel noise of the exact G draw,
#                       element i * gen_cap + g
# The gradient samplers (samplers/noise.py:PhiloxNoise).  Their step word
# packs the draw's place: (phase << 24) | transition for HMC and NUTS,
# (temperature << 8) | MH step for SMC; the chain key is the batch row's
# chain (HMC, NUTS), ELBO sample (SVI) or particle (SMC).
STREAM_MOMENTUM = 23   # HMC / NUTS momenta: Box-Muller normals, two words
#                        a value, the leaves' values in order
STREAM_HMC_ACCEPT = 24  # HMC: the MH accept uniform (one word)
STREAM_HMC_JITTER = 25  # HMC: the jittered trajectory length (one word)
STREAM_NUTS_DIR = 26   # NUTS: direction of doubling j (word j)
STREAM_NUTS_SUBTREE = 27  # NUTS: the uniform that takes subtree j (word j)
STREAM_NUTS_LEAF = 28  # NUTS: leaf i of subtree j, word 2^j - 1 + i
STREAM_ELBO = 29       # SVI: the reparameterization noise (normals)
STREAM_SMC_PROPOSAL = 30  # SMC: random-walk proposal noise (normals)
STREAM_SMC_ACCEPT = 31  # SMC: MH accept uniforms (one word a particle)
STREAM_SMC_RESAMPLE = 32  # SMC: the systematic resampling uniform
STREAM_SAMPLER_INIT = 33  # MarginalModel.init: the initial normals
STREAM_SAMPLER_JITTER = 34  # the warm start's per-chain jitter (normals)
STREAM_SVI_DRAW = 35   # run_sampler("svi"): draws of the fitted Gaussian
# The initial state of the tetraploid engine and the DPM prior's initial
# table draw at step INIT_STEP, a step index no sweep reaches, from the
# streams of the sweep's same draws
INIT_STEP = 0xFFFFFFFF
# fold_seed's chain word: no chain key is negative as an int32, so no draw
# reads the blocks that fold the site seeds
FOLD_CHAIN = 0xFFFFFFFF


class RngKeys(NamedTuple):
    """The randomness of one run: the 64-bit ``seed`` (Philox key) and one
    int32 key per chain (counter word c3).  A retried chain gets a fresh
    chain key; the others replay theirs.

    ``site_seed`` is the key of the draws whose sites a loci shard owns
    (P, z and the tetraploid genotype noise; :func:`site_keys`): the run's
    seed with the shard's index folded in (:func:`fold_seed`) when the
    loci are split over several ranks, ``None`` (the seed itself)
    otherwise.  Every other draw reads ``seed``, so it is the same on every
    shard of a chain."""

    seed: int
    chain_key: torch.Tensor    # int32[C], on the run's device
    site_seed: Optional[int] = None

    @property
    def k0(self) -> int:
        return self.seed & _MASK

    @property
    def k1(self) -> int:
        return (self.seed >> 32) & _MASK


def fold_seed(seed: int, shard: int) -> int:
    """The site seed of loci shard ``shard``: two words of the Philox block
    with counter (shard, 0, 0, ``FOLD_CHAIN``) under the run's key, so
    shards never replay each other's site draws (the counterpart of the
    JAX package's ``fold_in(key, axis_index)``, ``mcmc/updates.py:54``)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    w = philox4x32_10(int(shard), 0, 0, FOLD_CHAIN, seed & _MASK,
                      seed >> 32)
    return int(w[0]) | (int(w[1]) << 32)


def make_keys(seed: int, n_chains: int, device, chain_key=None,
              shard: Optional[int] = None) -> RngKeys:
    """The keys of ``n_chains`` chains (chain keys ``chain_key``, default
    ``range(n_chains)``); ``shard`` is the loci shard's index when the loci
    are split over several ranks (see :class:`RngKeys`)."""
    if chain_key is None:
        chain_key = range(n_chains)
    ck = torch.tensor(list(chain_key), dtype=torch.int32, device=device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return RngKeys(seed, ck,
                   None if shard is None else fold_seed(seed, shard))


def site_keys(keys: Optional[RngKeys]) -> Optional[RngKeys]:
    """The keys of the site-level draws (see :class:`RngKeys`); None
    stays None (a caller that injects its draws)."""
    if keys is None or keys.site_seed is None:
        return keys
    return keys._replace(seed=keys.site_seed, site_seed=None)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * x, x in [0, 2^32).  The
    int64 product wraps modulo 2^64, which keeps all 64 bits of the
    unsigned product; the arithmetic shift's sign fill is masked off."""
    p = x * m
    return (p >> 32) & _MASK, p & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Four output words (int64 tensors holding 32-bit values) for counters
    ``c0..c3`` (int64 tensors or ints, broadcast together) and key
    ``(k0, k1)``."""
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*[
        torch.as_tensor(c, dtype=torch.int64, device=dev) & _MASK
        for c in (c0, c1, c2, c3)])
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def random_streams_reference(keys: RngKeys, step: int, stream0: int,
                             n_streams: int, n_words: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`random_streams` (same signature):
    int64[C, n_streams, n_words] holding the 32-bit words."""
    dev = keys.chain_key.device
    n_blocks = -(-n_words // 4)
    c0 = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, None, :]
    c1 = (stream0 + torch.arange(n_streams, dtype=torch.int64,
                                 device=dev))[None, :, None]
    c3 = keys.chain_key.to(torch.int64)[:, None, None]
    words = philox4x32_10(c0, c1, step, c3, keys.k0, keys.k1)
    return torch.stack(words, dim=-1).reshape(
        c3.shape[0], n_streams, -1)[:, :, :n_words]


def random_streams(keys: RngKeys, step: int, stream0: int, n_streams: int,
                   n_words: int) -> torch.Tensor:
    """[C, n_streams, n_words] raw 32-bit words of the consecutive streams
    ``stream0 .. stream0 + n_streams - 1``: word i of stream s of chain c is
    word i % 4 of the block with counter (i // 4, s, step, chain_key[c]).

    With the chain keys on a CUDA device this is one launch of
    ``csrc/philox_fill.cu`` and returns the words as int32 bit patterns; on
    the CPU it runs the plain version (int64 values).  Both feed
    :func:`u01_closed` / :func:`u01_open`, which read the low 23 bits."""
    n_blocks = -(-n_words // 4)
    if n_blocks >= 1 << 32:
        raise ValueError("more than 2^32 Philox blocks in one stream")
    if not keys.chain_key.is_cuda:
        return random_streams_reference(keys, step, stream0, n_streams,
                                        n_words)
    from instruct_tpu_torch.kernels import _build
    c = keys.chain_key.shape[0]
    _build.check(keys.chain_key, "chain_key", torch.int32, (c,))
    out = torch.empty((c, n_streams, n_blocks * 4), dtype=torch.int32,
                      device=keys.chain_key.device)
    _build.launch("philox_words", "philox_fill_launch", _build.ptr(out), c,
                  n_streams, n_blocks, keys.k0, keys.k1, stream0, step,
                  _build.ptr(keys.chain_key))
    return out[:, :, :n_words]


def random_words_reference(keys: RngKeys, step: int, stream: int,
                           n_words: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`random_words` (same signature):
    int64[C, n_words] holding the 32-bit words."""
    return random_streams_reference(keys, step, stream, 1, n_words)[:, 0]


def random_words(keys: RngKeys, step: int, stream: int, n_words: int
                 ) -> torch.Tensor:
    """[C, n_words] raw 32-bit words of one stream (see
    :func:`random_streams`)."""
    return random_streams(keys, step, stream, 1, n_words)[:, 0]


def u01_closed(bits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) on a 2^-23 grid — the z draw's conversion
    (``instruct_tpu/kernels/fused_step.py:310-312``)."""
    return (bits & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))


def u01_open(bits: torch.Tensor) -> torch.Tensor:
    """U(0, 1) strictly inside the interval — every other draw
    (``instruct_tpu/kernels/s_pop_pallas.py:42-43``)."""
    return ((bits & 0x7FFFFF).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u = :func:`u01_open` -- the
    noise of every Gumbel-argmax draw (``jax.random.categorical``)."""
    return -torch.log(-torch.log(u01_open(bits)))


def element_words(keys: RngKeys, step: int, stream: int,
                  elements: torch.Tensor) -> torch.Tensor:
    """int64[C, E] words of the given element indices (int64[E]) of one
    stream: word ``e % 4`` of the block with counter (``e // 4``, stream,
    step, chain key) -- the same words as :func:`random_words` at those
    positions, for an index range that need not start a block."""
    c3 = keys.chain_key.to(torch.int64)[:, None]
    words = philox4x32_10(elements >> 2, stream, step, c3, keys.k0, keys.k1)
    lane = (elements & 3)[None]
    out = words[3]
    for i in (2, 1, 0):
        out = torch.where(lane == i, words[i], out)
    return out
