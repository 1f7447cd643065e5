"""The Z-marginalized per-individual log-likelihood of the diploid modes 1-5
(the deviance focus of WAIC and the corrected DIC), as one kernel.

:func:`marg_indv_loglik` is the function of
``model/likelihood.py:marginal_indv_loglik``, which stays its plain version:
on CPU tensors it runs that; on CUDA tensors it launches
``csrc/marg_loglik.cu`` (one pass over the panel: a block a chain x
``TILE`` loci x ``STRIP`` individuals, the tile's P staged in shared
memory where ``K * A <= STAGE_CELLS``, each row's tile sums written to
``[C, tiles, N]`` scratch and added in tile order in float64 by a second
small launch).  No ``[C, N, L]`` tensor is made.  It has no backward: the
gradient samplers' potential (``samplers/potential.py``) differentiates
through the plain version.

Not a Pallas kernel in the JAX package: ``instruct_tpu/model/
likelihood.py:213-275`` is tensor code that XLA fuses.
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.model import likelihood as lk

TILE = 512         # loci of a tile (kTile)
STRIP = 64         # individuals of a strip (kStrip)
STAGE_CELLS = 32   # the tile's P staged in shared memory when K * A <= this
MAX_ALLELES = 127  # the int8 allele codes (kMaxA)
MAX_GRID = 65535   # chains and strips: grid dimensions
SMEM_MAX = 232448  # a block's shared memory on the H100
# the kernel's likelihood family of each mode (kMode1, kSelfing, kFPop,
# kFIndv)
FAMILY = {1: 1, 2: 2, 3: 2, 4: 4, 5: 5}


def marg_plan(c: int, n: int, l: int, k: int, a: int) -> dict:
    """The launch plan (``csrc/marg_loglik.cu:marg_loglik_plan``, which the
    card checks): tiles of ``TILE`` loci x strips of ``STRIP`` individuals
    a chain, the tile's P staged when ``k * a <= STAGE_CELLS``, the block's
    dynamic shared memory (bytes) and the tile partials' scratch shape.
    Raises on a shape the kernel does not take."""
    tiles, strips = -(-l // TILE), -(-n // STRIP)
    stage = k * a <= STAGE_CELLS
    smem = 4 * k * a * TILE if stage else 0
    if c < 1 or n < 1 or l < 1 or k < 1:
        raise ValueError(f"C, N, L, K = {c}, {n}, {l}, {k}: the kernel "
                         "takes at least one of each")
    if not 2 <= a <= MAX_ALLELES:
        raise ValueError(f"{a} alleles: the kernel takes 2 to "
                         f"{MAX_ALLELES}")
    if c > MAX_GRID or strips > MAX_GRID:
        raise ValueError(f"{c} chains and {strips} strips of {STRIP} "
                         f"individuals: the kernel takes at most {MAX_GRID} "
                         "of each")
    if smem > SMEM_MAX:
        raise ValueError(f"K * A = {k * a}: {smem} bytes of shared memory, "
                         f"beyond a block's {SMEM_MAX}")
    return dict(tile=TILE, strip=STRIP, tiles=tiles, strips=strips,
                stage=stage, smem=smem, scratch=(c, tiles, n))


def marg_indv_loglik(spec: ModelSpec, data: Dataset, freq, q, gen,
                     rates=None) -> torch.Tensor:
    """f32[C, N] Z-marginalized per-individual log-lik of ``freq`` f32[C,
    K, L, A], ``q`` f32[C, N, K], ``gen`` [C, N] (modes 2/3; integers or
    real-valued posterior means) and ``rates`` (mode 4: F f32[C, K]; mode
    5: F f32[C, N]) on ``data`` (the packed ``bits2`` plane where present,
    else the allele codes).  CPU tensors: the plain version."""
    if not freq.is_cuda:
        return lk.marginal_indv_loglik(spec, data, freq, q, gen, rates)
    lk._need_admixture(spec, "marg_indv_loglik")
    c, k, l, a = freq.shape
    n = data.n_indv
    if not c * n * l:
        return torch.zeros((c, n), dtype=torch.float32, device=freq.device)
    plan = marg_plan(c, n, l, k, a)
    chk = _build.check
    freq, q = freq.contiguous(), q.contiguous()
    chk(freq, "freq", torch.float32, (c, k, l, a))
    chk(q, "q", torch.float32, (c, n, k))
    packed = data.bits2 is not None and a == 2
    if packed:
        chk(data.bits2, "bits2", torch.int8, (n, l))
    else:
        chk(data.geno, "geno", torch.int8, (n, 2 * l))
        chk(data.hom, "hom", torch.bool, (n, l))
        chk(data.site_valid, "site_valid", torch.bool, (n, l))
    gen_float = 0
    if spec.mode in (2, 3):
        if gen.dtype != torch.int32:
            gen, gen_float = gen.to(torch.float32).contiguous(), 1
        chk(gen, "gen", gen.dtype, (c, n))
    else:
        gen = None
    if spec.mode in (4, 5):
        rates = rates.contiguous()
        chk(rates, "rates", torch.float32, (c, k if spec.mode == 4 else n))
    else:
        rates = None
    dev = freq.device
    part = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
    out = torch.empty((c, n), dtype=torch.float32, device=dev)
    ptr = _build.ptr
    _build.launch("marg_loglik", "marg_loglik_launch", ptr(q), ptr(freq),
                  ptr(data.bits2) if packed else None,
                  None if packed else ptr(data.geno),
                  None if packed else ptr(data.hom),
                  None if packed else ptr(data.site_valid),
                  ptr(gen), ptr(rates), ptr(part), ptr(out), c, n, l, k, a,
                  FAMILY[spec.mode], gen_float)
    return out
