"""Upfront memory budgeting (mem_cal parity, InStruct.c:204-225).

The reference predicts only the accumulator footprint (streaming moments)
and aborts when it exceeds `-mm` (default 1e9 bytes).  Here the dominant
cost is device HBM for the per-chain sampler state and the transient site
tensors, so the estimate covers both; the CLI checks it against `-mm`
before launching.

Counterpart of ``instruct_tpu/memory.py``: the same arithmetic and the same
dict (device memory of the card here, where it was TPU HBM there).
"""

from __future__ import annotations

from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset


def estimate_bytes(spec: ModelSpec, sched: Schedule, data: Dataset,
                   track_freq: bool = False) -> dict:
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    p = 4 if spec.ploid == 4 else data.ploid
    k = spec.n_pops
    r = spec.n_rates(n)
    c = sched.n_chains

    f32 = 4
    state = (k * l * a * f32                     # freq
             + n * l * p * f32                   # z (int32)
             + n * k * f32 + r * f32 + n * f32)  # q, rates, logliks
    if spec.ploid == 4:
        state += n * l * 4 * f32                 # latent geno
        if not spec.autopoly:
            state += k * l * a * f32             # freq2
    accum_item = (1 + n + n * k + r
                  + (n if spec.has_selfing else 0)
                  + (k * l * a if track_freq else 0))
    accums = 2 * accum_item * f32                # mean + mean_sq
    # transient site tensors in the fused step (worst case ~ (K+3) [N,S])
    transient = (k + 3) * n * l * p * f32
    per_chain = state + accums + transient
    dataset = n * l * p * f32 + 2 * n * l + l * a
    return {
        "dataset_bytes": dataset,
        "per_chain_bytes": per_chain,
        "total_bytes": dataset + c * per_chain,
    }
