"""Convergence and efficiency diagnostics on numpy arrays or torch tensors.

Counterpart of ``instruct_tpu/diagnostics.py``:

* :func:`gelman_rubin` -- the PSRF exactly as GelmanRubin()
  (check_converg.c:100-153) computes it: R = V/W with
  V = W (n-1)/n + B/n, pass threshold 1.1 (check_converg.c:52).
* :func:`effective_sample_size` -- initial-positive-sequence ESS estimator
  (Geyer 1992), the numerator of effective samples / sec.
"""

from __future__ import annotations

import numpy as np
import torch

GR_THRESHOLD = 1.1  # check_converg.c:52


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float32)
    x = np.asarray(x)
    if x.dtype.kind != "f":
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x))


def gelman_rubin(traces) -> torch.Tensor:
    """PSRF over per-chain traces [n_chains, n_samples] (check_converg.c:
    100-153).  Returns V/W; > 1.1 means "has not converged"."""
    traces = _as_tensor(traces)
    m, n = traces.shape
    chain_means = traces.mean(dim=1)
    grand = chain_means.mean()
    w = traces.var(dim=1, unbiased=True).mean()
    b = n * ((chain_means - grand) ** 2).sum() / (m - 1)
    v = w * (n - 1) / n + b / n
    return v / w


def effective_sample_size_batch(traces) -> torch.Tensor:
    """Batched Geyer ESS: traces [..., n] -> ESS [...].

    One rfft/irfft over the whole batch computes every autocovariance at
    once; the initial-positive-sequence truncation (stop at the first
    non-positive pair sum rho[2t-1] + rho[2t]) is a running
    cumulative-positivity mask, so there is no per-parameter loop."""
    x = _as_tensor(traces)
    n = x.shape[-1]
    if n < 4:
        return torch.full(x.shape[:-1], float(n), dtype=x.dtype,
                          device=x.device)
    x = x - x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False)
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, nfft, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), nfft, dim=-1)[..., :n] / n
    rho = acov / torch.clamp_min(acov[..., :1], 1e-30)
    # pair sums P_j = rho[2j+1] + rho[2j+2], j = 0 .. (n-4)//2
    n_pairs = max((n - 2) // 2, 1)
    idx = 1 + 2 * torch.arange(n_pairs, device=x.device)
    pairs = rho[..., idx] + rho[..., idx + 1]
    keep = torch.cumprod((pairs > 0).to(x.dtype), dim=-1)
    s = (pairs * keep).sum(dim=-1)
    ess = torch.clamp_max(n / (1.0 + 2.0 * s), float(n))
    return torch.where(var == 0, torch.full_like(ess, float(n)), ess)


def effective_sample_size(trace) -> float:
    """ESS of a single scalar chain via the initial positive sequence
    (Geyer 1992): ESS = n / (1 + 2 sum rho_t) truncated at the first
    non-positive pair sum.  Thin wrapper over the batched estimator."""
    x = _as_tensor(trace).reshape(-1)
    if x.numel() < 4:
        return float(x.numel())
    return float(effective_sample_size_batch(x[None])[0])


def ess_per_param(traces) -> np.ndarray:
    """ESS for each column of [n_samples, n_params] draws (one batched
    pass), summed over chains by the caller."""
    t = _as_tensor(traces)
    if t.dim() < 2:
        t = t.reshape(1, -1)
    return effective_sample_size_batch(t.transpose(0, 1)).cpu().numpy()
