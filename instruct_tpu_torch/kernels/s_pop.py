"""The mode-2 S-update tail as one kernel.

Counterpart of ``instruct_tpu/kernels/s_pop_pallas.py`` (``s_pop_tail``
:115).  Per chain it runs

  * all ``J * K`` back-reflection MH iterations on the per-pop selfing rates
    (update_S_POP, mcmc.c:913-983) against the cached scalar target
    ``f(sbar) = sum_i [(g_i - 1) log sbar_i]_{g_i > 1} + sum_i log(1 - sbar_i)``
    with ``sbar_i = sum_k q_ik s_k``, one rank-1 update per iteration;
  * the selfing-generation proposal ``g' ~ Geom(1 - sbar)`` at the fresh
    sbar with update_G's boundary overrides (mcmc.c:1071-1084);
  * the generation-weight pair ``2^(1-g)`` for (current, proposed) g; and
  * the log-uniforms of the downstream G accept.

On CUDA tensors the wrapper launches ``csrc/s_pop.cu`` (one block of 512
threads per chain, the MH iterations a loop inside the block, each thread's
individuals in registers); on CPU tensors it runs the plain version below.
The target's sum over individuals is taken in one fixed order in both
(:func:`block_sum`: each thread adds its strided individuals in turn, a warp
butterfly, then the 16 warp partials in order), so the knife-edge accept
tests ``log u < f_new - f_cur`` see the same floats in the kernel and in the
plain version.

Uniforms, in the JAX kernel's draw order: ``u_prop`` and ``u_acc`` (one per
MH iteration, iteration ``j*K + k``), then ``ug`` (G proposal) and ``ul``
(G accept), one per individual.  Each family is its own Philox stream; word
``i`` of the stream belongs to iteration / individual ``i``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import philox as px

_EPS = 1e-30
_THREADS = 512     # threads of the kernel's block
_WARP = 32
# individuals the kernel keeps in registers (8 a thread); beyond, it streams
# them through a scratch sbar row
_REGISTER_INDIVIDUALS = 8 * _THREADS
MAX_POPS = 8


def block_sum(t: torch.Tensor) -> torch.Tensor:
    """f32[C, N] -> f32[C] in the kernel's order: thread ``i`` of 512 adds
    elements ``i, i + 512, ...`` in turn; a warp butterfly adds the 32
    threads of each warp (the halving tree over lanes 16, 8, 4, 2, 1); then
    the 16 warp partials are added in order."""
    c, n = t.shape
    t = F.pad(t, (0, -n % _THREADS)).reshape(c, -1, _THREADS)
    acc = t[:, 0]
    for m in range(1, t.shape[1]):
        acc = acc + t[:, m]
    acc = acc.reshape(c, _THREADS // _WARP, _WARP)
    s = _WARP // 2
    while s >= 1:
        acc = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    acc = acc[..., 0]
    total = acc[:, 0]
    for w in range(1, acc.shape[1]):
        total = total + acc[:, w]
    return total


def _draws(keys, step, n_chains, nu, n, test_draws):
    if test_draws is not None:
        u_prop, u_acc, ug, ul = [d.to(torch.float32) for d in test_draws]
        for name, d, shape in (("u_prop", u_prop, (n_chains, nu)),
                               ("u_acc", u_acc, (n_chains, nu)),
                               ("ug", ug, (n_chains, n)),
                               ("ul", ul, (n_chains, n))):
            if tuple(d.shape) != shape:
                raise ValueError(f"test_draws {name}: expected {shape}, got "
                                 f"{tuple(d.shape)}")
        return u_prop, u_acc, ug, ul
    return tuple(px.u01_open(px.random_words(keys, step, stream, count))
                 for stream, count in ((px.STREAM_S_PROP, nu),
                                       (px.STREAM_S_ACC, nu),
                                       (px.STREAM_S_GEN, n),
                                       (px.STREAM_S_LOGU, n)))


def s_pop_tail_reference(keys, step: int, q, gen, rates, *, subsweeps: int,
                         delta0: float, gen_cap: int, test_draws=None,
                         margins=None):
    """Plain PyTorch version of :func:`s_pop_tail` (same signature).

    ``margins``, when a list, receives the distance of every discrete
    decision from its threshold: one f32[C] per MH iteration (accept
    margin) and one f32[C, N] for the geometric draw's floor — what a
    caller needs to tell a knife-edge flip from a wrong kernel."""
    n_chains, n, k = q.shape
    sweeps = max(1, subsweeps)
    u_prop, u_acc, ug, ul = _draws(keys, step, n_chains, sweeps * k, n,
                                   test_draws)
    g1 = gen.to(torch.float32) - 1.0
    ghas = g1 > 0.0
    r = [rates[:, kk] for kk in range(k)]
    sbar = r[0][:, None] * q[:, :, 0]
    for kk in range(1, k):
        sbar = sbar + r[kk][:, None] * q[:, :, kk]

    def target(sb):
        t = (torch.where(ghas, g1 * torch.log(torch.clamp_min(sb, _EPS)),
                         torch.zeros_like(sb))
             + torch.log(torch.clamp_min(1.0 - sb, _EPS)))
        return block_sum(t)

    f_cur = target(sbar)
    for j in range(sweeps):
        for kk in range(k):
            idx = j * k + kk
            s_old = r[kk]
            s_step = torch.abs(s_old + (2.0 * u_prop[:, idx] - 1.0) * delta0)
            s_new = torch.where(s_step >= 1.0, 2.0 - s_step, s_step)
            sbar_new = sbar + q[:, :, kk] * (s_new - s_old)[:, None]
            f_new = target(sbar_new)
            logu = torch.log(u_acc[:, idx])
            diff = f_new - f_cur
            acc = logu < diff
            if margins is not None:
                margins.append(diff - logu)
            r[kk] = torch.where(acc, s_new, s_old)
            sbar = torch.where(acc[:, None], sbar_new, sbar)
            f_cur = torch.where(acc, f_new, f_cur)

    s_c = torch.clamp(sbar, 1e-6, 1.0 - 1e-6)
    x = torch.log(ug) / torch.log(s_c)
    if margins is not None:
        margins.append(torch.minimum(x - torch.floor(x),
                                     torch.floor(x) + 1.0 - x))
    # clamp in float first: a huge quotient would overflow the int cast
    g = 1 + torch.clamp(torch.floor(x), 0.0, float(gen_cap)).to(torch.int32)
    g = torch.clamp(g, 1, gen_cap)
    g = torch.where(sbar <= 1e-3, torch.ones_like(g), g)
    g = torch.where(sbar >= 1.0 - 1e-3, torch.full_like(g, gen_cap), g)
    wg_pair = torch.stack([torch.exp2(1.0 - gen.to(torch.float32)),
                           torch.exp2(1.0 - g.to(torch.float32))], dim=-1)
    return torch.stack(r, dim=1), g, wg_pair, torch.log(ul)


def s_pop_tail(keys, step: int, q: torch.Tensor, gen: torch.Tensor,
               rates: torch.Tensor, *, subsweeps: int, delta0: float,
               gen_cap: int, test_draws=None):
    """Fused mode-2 S tail: J*K MH subsweeps + G proposal + accept logu.

    keys    RngKeys (seed + per-chain keys); step  the step index
    q       f32[C, N, K]  admixture proportions
    gen     i32[C, N]     current selfing generations
    rates   f32[C, K]     current selfing rates (K <= 8)
    test_draws            optional (u_prop f32[C, J*K], u_acc f32[C, J*K],
                          ug f32[C, N], ul f32[C, N]) injected uniforms

    Returns (rates' f32[C, K], gen_prop i32[C, N], wg_pair f32[C, N, 2],
    logu f32[C, N]).  ``subsweeps`` < 1 runs one sweep, as the JAX kernel.
    """
    if q.dim() != 3:
        raise ValueError("q must be [C, N, K]")
    n_chains, n, k = q.shape
    if k > MAX_POPS:
        raise ValueError(f"s_pop_tail supports n_pops <= {MAX_POPS}, got {k}")
    if not q.is_cuda:
        return s_pop_tail_reference(keys, step, q, gen, rates,
                                    subsweeps=subsweeps, delta0=delta0,
                                    gen_cap=gen_cap, test_draws=test_draws)
    sweeps = max(1, subsweeps)
    _build.check(q, "q", torch.float32)
    _build.check(gen, "gen", torch.int32, (n_chains, n))
    _build.check(rates, "rates", torch.float32, (n_chains, k))
    _build.check(keys.chain_key, "chain_key", torch.int32, (n_chains,))
    draws = [None] * 4
    if test_draws is not None:
        draws = list(test_draws)
        for d, cols in zip(draws, (sweeps * k, sweeps * k, n, n)):
            _build.check(d, "test_draws", torch.float32, (n_chains, cols))
    dev = q.device
    # the scratch row only where the state does not fit the registers
    sbar = (torch.empty((n_chains, n), dtype=torch.float32, device=dev)
            if n > _REGISTER_INDIVIDUALS else None)
    out_rates = torch.empty_like(rates)
    gen_prop = torch.empty_like(gen)
    wg_pair = torch.empty((n_chains, n, 2), dtype=torch.float32, device=dev)
    logu = torch.empty((n_chains, n), dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch("s_pop_tail", "s_pop_tail_launch", p(q), p(gen), p(rates),
                  p(draws[0]), p(draws[1]), p(draws[2]), p(draws[3]),
                  p(sbar), p(out_rates), p(gen_prop), p(wg_pair), p(logu),
                  n_chains, n, k, sweeps, float(delta0), gen_cap, keys.k0,
                  keys.k1, p(keys.chain_key), step)
    return out_rates, gen_prop, wg_pair, logu


def reduction_floor_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`reduction_floor` (same signature)."""
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(iters):
        total = block_sum(x + total[:, None] * 1e-30)
    return total


def reduction_floor(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The S tail's latency floor, a measurement aid: ``iters`` dependent
    :func:`block_sum` reductions of x f32[C, N] (N <= 4096), each input
    depending on the previous total, with the tail's block shape and
    register layout and nothing else.  Returns the last totals f32[C]."""
    c, n = x.shape
    if n > _REGISTER_INDIVIDUALS:
        raise ValueError(f"reduction_floor takes N <= "
                         f"{_REGISTER_INDIVIDUALS}, got {n}")
    if not x.is_cuda:
        return reduction_floor_reference(x, iters)
    _build.check(x, "x", torch.float32)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    _build.launch("s_pop_floor", "s_pop_floor_launch", _build.ptr(x),
                  _build.ptr(out), c, n, iters)
    return out
