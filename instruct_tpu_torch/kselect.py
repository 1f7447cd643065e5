"""Selection of the number of subpopulations K.

Counterpart of ``instruct_tpu/kselect.py`` (which imports JAX, so this is a
copy in torch and numpy): ``KSelectResult``, ``_rates_for_k``,
``_slice_result``, ``_pick_best`` and ``infer_k``.  As there, K runs over
[n_small, n_large] (default upper bound N^0.3 + 1, InStruct.c:547-548), all
chains per K, and the pick ranks on **WAIC under the one-standard-error
rule** (the smallest K whose chain-mean WAIC is within one SE of the
minimum), falling back to the minimum corrected DIC over chains where a K
has no WAIC; every column (WAIC and its SE, corrected DIC and pD, the
reference's DIC, Gelman-Rubin of the log-lik trace) is reported per K.
Initial S/F values (``init_rates``, the role of the ``-i`` file) are reused
for every K, sliced or cycled to its width (InStruct.c:563).

By default the sweep is ONE padded (chain x K) grid: every K value's chains
are replicas of a single ``run_mcmc`` at K_max shapes with a per-replica
active-pop mask (``run_mcmc(active_pops=...)``), and each K's result is
sliced back out of the replica axis (inactive slots hold exact zeros, so
DIC, WAIC and GR are unchanged).  The port compiles nothing per K, so the
grid buys one launch stream for all replicas rather than one compile; the
per-K loop (``grid=False``, and always for the tetraploid engine, as in the
JAX package) picks the same K.

Randomness: the grid is one run from ``seed`` whose replica ``i * C + c``
has chain key ``i * C + c``.  The JAX package folds its key per K in the
loop; here K's run takes the seed :func:`k_seed` ``(seed, K)``, a Weyl step
of the run's seed by K.  Grid and loop therefore draw different numbers and
agree in distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.diagnostics import gelman_rubin
from instruct_tpu_torch.mcmc.accumulators import ChainAccum, TrackedStats
from instruct_tpu_torch.mcmc.driver import RunResult, run_mcmc
from instruct_tpu_torch.mcmc.state import McmcState

_WEYL = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class KSelectResult:
    best_k: int
    dic: Dict[int, np.ndarray]            # per-K, per-chain corrected DIC
    results: Dict[int, RunResult]
    dic_reference: Dict[int, np.ndarray]  # reference-formula DIC per K/chain
    p_d: Dict[int, Optional[np.ndarray]]  # effective parameter count
    gelman_rubin: Dict[int, Optional[float]]  # per-K GR of the log-lik trace
    waic: Dict[int, Optional[np.ndarray]] = None  # per-K, per-chain WAIC
    #   (the selection statistic when available)
    waic_se: Dict[int, Optional[float]] = None    # per-K WAIC standard error
    n_small: int = 1
    n_large: int = 1


def k_seed(seed: int, k: int) -> int:
    """The seed of K's run in the per-K loop: ``seed + K * 0x9E3779B97F4A7C15``
    modulo 2^64."""
    return (int(seed) + int(k) * _WEYL) & 0xFFFFFFFFFFFFFFFF


def _rates_for_k(init_rates, r: int):
    """Adapt a [n_chains, R0] initial-rates matrix to a K run needing R
    values per chain: slice when wide enough, cycle columns otherwise
    (the reference reuses the same `initial` across K, InStruct.c:563)."""
    if init_rates is None or r == 0:
        return None
    init_rates = np.asarray(init_rates)
    r0 = init_rates.shape[1]
    if r0 >= r:
        return init_rates[:, :r]
    reps = -(-r // r0)
    return np.tile(init_rates, (1, reps))[:, :r]


def _slice_result(res: RunResult, rows: slice, k: int,
                  spec: ModelSpec) -> RunResult:
    """Per-K view of the padded grid run: select this K's chain replicas
    and truncate the padded pop axes back to k.  Valid because inactive
    slots carry exact zeros in q (and its moments) and are never
    referenced by any likelihood term."""
    def rows_of(x):
        return None if x is None else x[rows]

    def trunc(stats: TrackedStats) -> TrackedStats:
        stats = TrackedStats(*[rows_of(x) for x in stats])
        out = stats._replace(q=stats.q[:, :, :k])
        if spec.rates_are_per_pop:
            out = out._replace(rates=out.rates[:, :k])
        if out.freq.dim() == 4:
            out = out._replace(freq=out.freq[:, :k])
        return out

    acc = res.accum
    accum = ChainAccum(count=rows_of(acc.count), mean=trunc(acc.mean),
                       mean_sq=trunc(acc.mean_sq),
                       convg_ld=rows_of(acc.convg_ld),
                       empty_cluster=rows_of(acc.empty_cluster),
                       lme_indv=rows_of(acc.lme_indv),
                       m2_ll_marg=rows_of(acc.m2_ll_marg))
    final = McmcState(*[rows_of(x) for x in res.final_state])
    plug = None if res.plugin_ll is None else res.plugin_ll[rows]
    return RunResult(accum=accum, final_state=final,
                     n_retries=res.n_retries, plugin_ll=plug)


def _summaries(res: RunResult, n_chains: int):
    """(dic, dic_reference, waic, waic_se, p_d, gelman_rubin) of one K."""
    gr = None
    if n_chains > 1:
        gr = float(gelman_rubin(res.accum.convg_ld))
    return (res.dic(), res.dic_reference(), res.waic(), res.waic_se(),
            res.p_d(), gr)


def infer_k(data: Dataset, spec: ModelSpec, sched: Schedule, seed: int,
            n_small: int = 1, n_large: int = 0, init_rates=None,
            grid: bool = True, device="cuda", mesh=None,
            **run_kwargs) -> KSelectResult:
    """Run K = n_small..n_large (default 1..N^0.3 + 1 when the range is
    not a valid one) and pick K.  ``grid`` runs every diploid mode (0-5) as
    one padded (chain x K) grid; ploidy 4 and ``grid=False`` run one
    ``run_mcmc`` per K.  ``run_kwargs`` go to ``run_mcmc`` (``track_freq``
    defaults to True: the corrected DIC's plug-in needs the posterior-mean
    P).  ``mesh`` (``parallel/mesh.py``) goes to every run: on a mesh
    whose loci are split the K values run one by one (the grid's mask does
    not combine with loci sharding, JAX ``kselect.py:126-136``); on a
    chain mesh the grid's replicas are split over the chain axis."""
    if n_large < 1 or n_small < 1 or n_small > n_large:
        n_small = 1
        n_large = int(data.n_indv ** 0.3) + 1  # InStruct.c:547-548
    run_kwargs.setdefault("track_freq", True)
    ks_list = list(range(n_small, n_large + 1))
    cols = {name: {} for name in ("dic", "dic_ref", "waic", "waic_se",
                                  "p_d", "gr")}
    results: Dict[int, RunResult] = {}

    def record(kv, res, n_chains):
        results[kv] = res
        for name, v in zip(cols, _summaries(res, n_chains)):
            cols[name][kv] = v

    nc = sched.n_chains
    loci_split = mesh is not None and mesh.n_data_shards > 1
    if grid and spec.ploid == 2 and len(ks_list) > 1 and not loci_split:
        # one padded run: replicas i*C..(i+1)*C run K = ks[i]
        k_max = n_large
        spec_pad = dataclasses.replace(spec, n_pops=k_max)
        r_max = spec_pad.n_rates(data.n_indv)
        reps = len(ks_list) * nc
        active = np.zeros((reps, k_max), np.float32)
        rates_grid = None
        if init_rates is not None and r_max > 0:
            rates_grid = np.zeros((reps, r_max), np.float32)
        for i, kv in enumerate(ks_list):
            active[i * nc:(i + 1) * nc, :kv] = 1.0
            if rates_grid is not None:
                # the reference reuses the same `-i` starts for every K
                # (InStruct.c:563); inactive slots keep zeros
                r_k = kv if spec.rates_are_per_pop else r_max
                rates_grid[i * nc:(i + 1) * nc, :r_k] = _rates_for_k(
                    init_rates, r_k)
        res_all = run_mcmc(data, spec_pad,
                           dataclasses.replace(sched, n_chains=reps), seed,
                           init_rates=rates_grid, active_pops=active,
                           device=device, mesh=mesh, **run_kwargs)
        for i, kv in enumerate(ks_list):
            record(kv, _slice_result(res_all, slice(i * nc, (i + 1) * nc),
                                     kv, spec), nc)
    else:
        for kv in ks_list:
            spec_k = dataclasses.replace(spec, n_pops=kv)
            res = run_mcmc(data, spec_k, sched, k_seed(seed, kv),
                           init_rates=_rates_for_k(
                               init_rates, spec_k.n_rates(data.n_indv)),
                           device=device, mesh=mesh, **run_kwargs)
            record(kv, res, nc)
    return _pick_best(cols["dic"], cols["waic"], cols["waic_se"], results,
                      cols["dic_ref"], cols["p_d"], cols["gr"], n_small,
                      n_large)


def _pick_best(dic, waic, waic_se, results, dic_ref, p_d, gr,
               n_small, n_large) -> KSelectResult:
    # rank on the chain-mean WAIC under the one-standard-error rule when
    # every K produced one; else min-DIC over chains, as inf_K_val does
    # (InStruct.c:588-592)
    if all(w is not None for w in waic.values()):
        wmean = {k: float(w.mean()) for k, w in waic.items()}
        k_min = min(wmean, key=wmean.get)
        tol = wmean[k_min] + (waic_se[k_min] or 0.0)
        best_k = min(k for k, w in wmean.items() if w <= tol)
    else:
        best_k = min(dic, key=lambda k: dic[k].min())
    return KSelectResult(best_k=best_k, dic=dic, results=results,
                         dic_reference=dic_ref, p_d=p_d, gelman_rubin=gr,
                         waic=waic, waic_se=waic_se,
                         n_small=n_small, n_large=n_large)
