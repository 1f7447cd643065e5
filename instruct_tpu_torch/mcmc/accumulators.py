"""On-device streaming posterior-moment accumulators.

Counterpart of ``instruct_tpu/mcmc/accumulators.py``, with the chains as a
written-out leading axis.  The reference stores running means and running
means-of-squares of every tracked quantity (store_chn, mcmc.c:1320-1456);
this is the stable Welford form  m += w (x - m) / n,  which keeps f32
accurate over millions of samples.

Tracked slots mirror CHAIN (allocate_chn, mcmc.c:588-642): total log-lik,
per-individual log-lik, Q, S, G, and optionally P.

:func:`accum_update` does not synchronise with the host: the stored count,
the convergence-trace write and the empty-cluster latch are tensor
arithmetic.  A weight-0 update is a no-op in the JAX package, so ``run_mcmc``
calls it on stored steps only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.mcmc.state import McmcState


class TrackedStats(NamedTuple):
    """One sample of everything store_chn records (leading axis: chain)."""

    total_ll: torch.Tensor   # f32[C]
    indv_ll: torch.Tensor    # f32[C, N]
    q: torch.Tensor          # f32[C, N, K]
    rates: torch.Tensor      # f32[C, R]
    gen: torch.Tensor        # f32[C, N] or f32[C, 0]
    freq: torch.Tensor       # f32[C, K, L, A] or f32[C, 0]
    ll_marg: torch.Tensor    # f32[C, N] Z-marginalized per-individual
    #   log-lik, refreshed every Schedule.dic_every-th stored step and held
    #   constant between refreshes (repeats weight the subsample uniformly).
    #   mean -> the E[logL] term of the corrected DIC; the centered
    #   accumulator below -> WAIC's pwaic.
    freq2: torch.Tensor      # f32[C, K, L, A] allotetraploid with
    #   track_freq (the second subgenome's P), else f32[C, 0]


class ChainAccum(NamedTuple):
    """Streaming moments plus convergence trace for all chains."""

    count: torch.Tensor        # i32[C] number of stored samples so far
    mean: TrackedStats
    mean_sq: TrackedStats
    convg_ld: torch.Tensor     # f32[C, ckrep] first ckrep stored total
    #   log-liks (the cvg->convg_ld buffer, check_converg.c:24-33)
    empty_cluster: torch.Tensor  # bool[C] latched at the
    #   nstep_check_empty_cluster-th stored sample (mcmc.c:227-234)
    lme_indv: torch.Tensor     # f32[C, N] running log-mean-exp of the
    #   per-individual pointwise log-lik: WAIC's lppd term
    m2_ll_marg: torch.Tensor   # f32[C, N] Welford sum of squared deviations
    #   of the per-individual marginal log-lik: WAIC's pwaic_2 = m2 / count


def _map2(fn, a: TrackedStats, b: TrackedStats) -> TrackedStats:
    return TrackedStats(*[fn(x, y) for x, y in zip(a, b)])


def extract_stats(spec: ModelSpec, state: McmcState, track_freq: bool
                  ) -> TrackedStats:
    c = state.q.shape[0]
    empty = torch.zeros((c, 0), dtype=torch.float32, device=state.q.device)
    gen = state.gen.to(torch.float32) if spec.has_selfing else empty
    q = state.q
    if spec.mode == 0 and spec.ploid == 2:
        # no admixture: each individual's Q row is the indicator of its pop
        q = torch.nn.functional.one_hot(state.zz.to(torch.int64),
                                        spec.n_pops).to(torch.float32)
    return TrackedStats(
        total_ll=state.loglik_total,
        indv_ll=state.loglik_indv,
        q=q,
        rates=state.rates,
        gen=gen,
        freq=state.freq if track_freq else empty,
        ll_marg=(state.loglik_marg if state.loglik_marg is not None
                 else empty),
        freq2=state.freq2 if _track_freq2(spec, track_freq) else empty,
    )


def _track_freq2(spec: ModelSpec, track_freq: bool) -> bool:
    return track_freq and spec.ploid == 4 and not spec.autopoly


def init_accum(spec: ModelSpec, sched: Schedule, data: Dataset,
               track_freq: bool, n_chains: int, device="cuda") -> ChainAccum:
    c = n_chains
    n, k = data.n_indv, spec.n_pops
    a, l = data.max_alleles, data.n_loci
    r = spec.n_rates(n)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def zeros():
        return TrackedStats(
            total_ll=z(c), indv_ll=z(c, n), q=z(c, n, k), rates=z(c, r),
            gen=z(c, n if spec.has_selfing else 0),
            freq=z(c, k, l, a) if track_freq else z(c, 0),
            ll_marg=z(c, n),
            freq2=(z(c, k, l, a) if _track_freq2(spec, track_freq)
                   else z(c, 0)))

    return ChainAccum(
        count=torch.zeros((c,), dtype=torch.int32, device=device),
        mean=zeros(), mean_sq=zeros(),
        convg_ld=z(c, sched.ckrep),
        empty_cluster=torch.zeros((c,), dtype=torch.bool, device=device),
        lme_indv=torch.full((c, n), float("-inf"), dtype=torch.float32,
                            device=device),
        m2_ll_marg=z(c, n),
    )


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[C] -> [C, 1, ...] broadcastable against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def accum_update(accum: ChainAccum, stats: TrackedStats, store: int,
                 empty_flag: torch.Tensor, check_at: int) -> ChainAccum:
    """Fold one MCMC draw into the moments with weight ``store`` in {0, 1}
    (a host integer: whether a step is stored is arithmetic on the step
    index).

    ``empty_flag`` bool[C] is the instantaneous empty-cluster indicator; it
    is latched exactly when the stored count reaches ``check_at``, matching
    ``if(cnt_step==nstep_check_empty_cluster)`` in every mode loop
    (e.g. mcmc.c:227-234).
    """
    if not store:
        return accum
    new_count = accum.count + 1
    denom = torch.clamp_min(new_count.to(torch.float32), 1.0)

    def upd(m, x):
        return m + (x - m) / _bc(denom, m)

    def upd_sq(m, x):
        return m + (x * x - m) / _bc(denom, m)

    mean = _map2(upd, accum.mean, stats)
    mean_sq = _map2(upd_sq, accum.mean_sq, stats)

    ckrep = accum.convg_ld.shape[1]
    # masked vector write at index `count` (no host read of the count)
    hit = (torch.arange(ckrep, device=accum.count.device)[None, :]
           == accum.count[:, None])
    convg = torch.where(hit, stats.total_ll[:, None], accum.convg_ld)

    latch = new_count == check_at
    empty = accum.empty_cluster | (latch & empty_flag)

    # running log-mean-exp of exp(ll_marg_i): lme_{n+1} =
    # logaddexp(lme_n + log n, x) - log(n+1)
    cnt = accum.count.to(torch.float32)
    prev = torch.where(_bc(accum.count > 0, accum.lme_indv),
                       accum.lme_indv
                       + _bc(torch.log(torch.clamp_min(cnt, 1.0)),
                             accum.lme_indv),
                       torch.full_like(accum.lme_indv, float("-inf")))
    lme = (torch.logaddexp(prev, stats.ll_marg)
           - _bc(torch.log(denom), accum.lme_indv))

    # Welford M2 of the marginal log-lik (old mean before this draw, new
    # mean after): m2 += (x - m_old)(x - m_new)
    m2 = accum.m2_ll_marg + ((stats.ll_marg - accum.mean.ll_marg)
                             * (stats.ll_marg - mean.ll_marg))

    return ChainAccum(count=new_count, mean=mean, mean_sq=mean_sq,
                      convg_ld=convg, empty_cluster=empty, lme_indv=lme,
                      m2_ll_marg=m2)


def variance(accum: ChainAccum) -> TrackedStats:
    """Posterior variance = E[x^2] - E[x]^2, the estimator the report
    writer prints (e.g. result_analysis.c:90, 109)."""
    return _map2(lambda m2, m: m2 - m * m, accum.mean_sq, accum.mean)
