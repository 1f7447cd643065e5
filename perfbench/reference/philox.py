"""Philox4x32-10 (Salmon et al., SC 2011) in plain PyTorch integer ops, and
the word layout under which the program under test documents its draws:

  key     = the run's 64-bit seed as two 32-bit words (low, high)
  counter = (element // 4, stream id, step index, chain key)
  word    = element % 4 of that block

A uniform is made from the low 23 bits of a word: ``[0, 1)`` for the
ancestry draw, ``(0, 1)`` (half a step in) for every other draw.  32-bit
words live in int64 tensors; a 32 x 32 -> 64 product is one wrapping int64
multiply.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF

# stream ids of the draws the benchmark's sweeps make
STREAM_P = 1        # Dirichlet draw of the allele frequencies P
STREAM_S_PROP = 2   # fused selfing tail (K <= 8): random-walk proposals
STREAM_S_ACC = 3    #   its MH accept uniforms
STREAM_S_GEN = 4    #   the geometric G proposal
STREAM_S_LOGU = 5   #   the G accept uniforms
STREAM_Z = 6        # the per-copy ancestry draw
STREAM_Q = 7        # Dirichlet draw of the admixture proportions Q
STREAM_ALPHA = 8    # alpha MH step (normal proposal + accept uniform)
STREAM_R_PROP = 9   # plain selfing updates (K > 8): proposals, word j*R + i
STREAM_R_ACC = 10   #   accept uniforms
STREAM_G_PROP = 11  #   the geometric G proposal
STREAM_G_ACC = 12   #   the G accept uniforms


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of the blocks with counters ``c0..c3``
    (int64 tensors or ints, broadcast together) under key ``(k0, k1)``."""
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*[
        torch.as_tensor(c, dtype=torch.int64, device=dev) & MASK
        for c in (c0, c1, c2, c3)])
    for _ in range(10):
        p0 = c0 * M0
        p1 = c2 * M1
        hi0, lo0 = (p0 >> 32) & MASK, p0 & MASK
        hi1, lo1 = (p1 >> 32) & MASK, p1 & MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK
        k1 = (k1 + W1) & MASK
    return c0, c1, c2, c3


def words(seed: int, chain_key: int, step: int, stream: int, start: int,
          count: int, device) -> torch.Tensor:
    """int64[count]: words ``start .. start + count - 1`` of one (chain,
    step, stream) counter space."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    b0, b1 = start // 4, (start + count - 1) // 4 + 1
    blocks = torch.arange(b0, b1, dtype=torch.int64, device=device)
    out = torch.stack(philox(blocks, stream, step, int(chain_key),
                             seed & MASK, seed >> 32), dim=-1).reshape(-1)
    off = start - 4 * b0
    return out[off:off + count]


def u01_closed(w: torch.Tensor, dtype) -> torch.Tensor:
    """U[0, 1) on a 2^-23 grid (the ancestry draw)."""
    return (w & 0x7FFFFF).to(torch.float64).mul_(2.0 ** -23).to(dtype)


def u01_open(w: torch.Tensor, dtype) -> torch.Tensor:
    """U(0, 1), half a step inside the interval (every other draw)."""
    return ((w & 0x7FFFFF).to(torch.float64) + 0.5).mul_(2.0 ** -23).to(dtype)
