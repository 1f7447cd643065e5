"""The comparison that decides ``correct``: the last sweep of a job of the
window, replayed by the plain reference (``reference/sweep.py``) from the
program's own state before it, stage by stage.

Each stage takes the program's outputs of the stages before it as its
inputs, so a number judges one stage: the counts carried into the sweep,
P, the selfing rates S, the ancestries Z and their counts, the generation
counts G, Q, alpha, the stored step's z-conditioned and Z-marginalized
log-liks and the running moments.  The reference computes in float64.
The control puts the same reference, computed in bfloat16, in the
program's place.

Numbers (each has a limit in ``limits/<workload>.json``):

  exact_off      cells of the exact quantities that differ: the allele-pop
                 counts carried in and out of the sweep (against a recount
                 of z), the stored count, the empty-cluster latch
  z_flip_ulps    over the allele copies whose ancestry differs, how close
                 the reference's uniform lies to the CDF boundaries between
                 the two, in units of 2^-24 of the CDF's total: a float32
                 knife-edge reads a few, a wrong ancestry thousands or more
  p_flip_ulps    over the P rows (pop, locus) off by more than TOL, how
                 close the gamma accept tests lie whose flips explain the
                 program's row (``row_flip_ulps``); infinite where none do
  q_flip_ulps    the same of the Q rows (individuals)
  s_off_share    share of selfing rates off by more than TOL (mode 2)
  g_off_share    share of generation counts that differ (mode 2)
  alpha_off_share  share of chains whose alpha is off by more than TOL
  ll_gap         widest gap of the stored per-individual and total
                 log-liks, relative to the reference's value (at least 1)
  llm_gap        the same of the Z-marginalized log-lik
  moments_gap    widest gap of the running moments and the convergence
                 trace, relative to |reference| + 1e-3
  m2_gap         the same of the centred sum of squares of the marginal
                 log-lik, apart: its update subtracts numbers near the
                 log-lik's size, so its float32 rounding is that size's
                 and not its own
  waic_gap       (K selection) widest gap of each K's chain WAICs
  pick_off       (K selection) 1 where the picked K differs
  init_bad       invariants the initial state breaks (labels in range,
                 Q on the simplex, counts equal to a recount of z, rates,
                 generations and alpha in range), plus 1 where the state
                 judged is not the one the job ran from: the driver's
                 call is tapped (``jobs.py``) and made again after the
                 window, and the two states' fingerprints must be equal
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import philox as px
from perfbench.reference import sweep as ref

TOL = 1e-5
F64 = torch.float64
BLOCK_ELEMS = 1 << 25       # float64 elements of one [K, rows, L] block


def block_rows(n_loci: int, n_pops: int) -> int:
    return max(1, BLOCK_ELEMS // (n_loci * n_pops))


def recount(z, g0, g1, valid, n_pops: int):
    """int64[K, L, 2] valid allele copies by (pop, locus, allele) of one
    block: ``z`` int64[B, 2L]."""
    b, l = g0.shape
    out = torch.zeros(n_pops * 2 * l, dtype=torch.int64, device=z.device)
    loc = torch.arange(l, device=z.device)[None].expand(b, l)
    for zc, gc in ((z[:, :l], g0), (z[:, l:], g1)):
        code = ((zc * 2 + gc) * l + loc)[valid]
        out += torch.bincount(code, minlength=n_pops * 2 * l)
    return out.reshape(n_pops, 2, l).transpose(1, 2)


def qq_counts(z, valid, n_pops: int):
    """int64[B, K]: valid copies of each individual in each pop."""
    l = valid.shape[1]
    return torch.stack([
        (((z[:, :l] == k) & valid).sum(-1) + ((z[:, l:] == k) & valid).sum(-1))
        for k in range(n_pops)], dim=-1)


def _off(cand, want, tol=TOL) -> int:
    return int((torch.abs(cand.to(F64) - want.to(F64)) > tol).sum())


def _rel_gap(cand, want, floor: float) -> float:
    want = want.to(F64)
    gap = torch.abs(cand.to(F64) - want) / (torch.abs(want) + floor)
    # a NaN or an infinity on one side only is a gap of infinity
    bad = torch.isfinite(cand.to(F64)) != torch.isfinite(want)
    gap = torch.where(torch.isfinite(want) & ~bad, gap,
                      torch.where(bad, math.inf, 0.0))
    return float(gap.max()) if gap.numel() else 0.0


class Tally:
    """Counts and widest gaps over the chains of a run."""

    def __init__(self):
        self.n = {}
        self.total = {}
        self.gap = {}

    def off(self, name, count, total):
        self.n[name] = self.n.get(name, 0) + count
        self.total[name] = self.total.get(name, 0) + total

    def widest(self, name, value):
        self.gap[name] = max(self.gap.get(name, 0.0), value)

    def numbers(self) -> dict:
        out = {"exact_off": self.n.pop("exact", 0)}
        self.total.pop("exact", None)
        for name, count in self.n.items():
            out[name + "_off_share"] = count / max(1, self.total[name])
        out.update(self.gap)
        return out


def replay_numbers(bits2, model: dict, run: dict, control: bool = False
                   ) -> dict:
    """The numbers of one replayed sweep.

    ``model``: mode, n_pops, gen_cap, mh_step_s, alpha_sd, s_subsweeps,
    fused_tail (the selfing tail's streams), ckrep, check_at, refreshed
    (whether the stored step refreshed the marginal log-lik), track_freq.
    ``run``: seed, chain_keys (the attempt's), step (the replayed sweep's
    index), prev and final (dicts of the state's and the moments' tensors,
    chain axis first).  With ``control`` the program's outputs are
    replaced by the reference's in bfloat16."""
    t = Tally()
    for c in run.get("chains") or range(len(run["chain_keys"])):
        _chain(t, bits2, model, run, c, control)
    return t.numbers()


def replay_sample(seed: int, n_chains: int, n_replay) -> list:
    """The chains whose last sweep the check replays: all, or a sample of
    ``n_replay`` drawn from the job's seed."""
    if not n_replay or n_replay >= n_chains:
        return list(range(n_chains))
    g = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return sorted(torch.randperm(n_chains, generator=g)[:n_replay].tolist())


def waic_of(lme, m2, count, dtype=F64):
    """(WAIC a chain, the per-individual contributions) from the running
    log-mean-exp and centred sum of squares of the marginal log-lik:
    -2 sum_i (lppd_i - pwaic_i), pwaic_i = m2_i / count."""
    lme, m2 = lme.to(dtype), m2.to(dtype)
    cnt = torch.clamp_min(count.to(dtype), 1.0)[:, None]
    per = -2.0 * (lme - m2 / cnt)
    return per.sum(-1), per


def pick_numbers(k_range, n_chains, final: dict, picked: dict,
                 control: bool = False) -> dict:
    """``waic_gap``, the widest gap of each K's chain WAICs (relative to
    |reference| + 1), and ``pick_off``, 1 where the pick differs: the
    smallest K whose chain-mean WAIC is within one standard error (sqrt(N)
    times the spread over individuals of the chain-mean contributions) of
    the least.  ``final`` holds the grid's moments, replica ``i * C + c``
    running K = k_range[0] + i; ``picked`` the program's ``best_k`` and
    ``waic`` by K."""
    lo, hi = k_range
    want, se, got = {}, {}, {}
    for i, kv in enumerate(range(lo, hi + 1)):
        rows = slice(i * n_chains, (i + 1) * n_chains)
        args = (final["acc.lme_indv"][rows], final["acc.m2_ll_marg"][rows],
                final["acc.count"][rows])
        w, per = waic_of(*args)
        want[kv] = w
        mean_per = per.mean(0)
        se[kv] = float(math.sqrt(per.shape[1]) * mean_per.std(unbiased=False))
        got[kv] = (waic_of(*args, dtype=torch.bfloat16)[0] if control
                   else torch.as_tensor(picked["waic"][kv], device=w.device))
    wmean = {kv: float(w.mean()) for kv, w in want.items()}
    k_min = min(wmean, key=wmean.get)
    best = min(kv for kv, w in wmean.items() if w <= wmean[k_min] + se[k_min])
    if control:
        gmean = {kv: float(w.float().mean()) for kv, w in got.items()}
        g_min = min(gmean, key=gmean.get)
        prog_best = min(kv for kv, w in gmean.items()
                        if w <= gmean[g_min] + se[g_min])
    else:
        prog_best = picked["best_k"]
    gap = max(_rel_gap(got[kv], want[kv], 1.0) for kv in want)
    return {"waic_gap": gap, "pick_off": int(prog_best != best)}


def row_flip_ulps(cand, g, alts, costs, active=None) -> float:
    """How close to their accept tests lie the rounding flips that explain
    the program's Dirichlet rows ``cand`` [M, A]: 0 where every row equals
    the reference's (``g`` [M, A] its variates) within TOL; else, over the
    rows that differ, the widest of the least costs of the flips of
    gamma's accept tests (``alts``, ``costs`` [ROUNDS + 1, M, A], as
    :func:`ref.gamma` gives them) that give the program's row; infinite
    where no flips do."""
    want = ref.normalize(g, active)
    off = ~(torch.abs(cand.to(F64) - want) <= TOL).all(-1)
    rows = off.nonzero().flatten()
    if rows.numel() == 0:
        return 0.0
    cand = cand[rows].to(F64).cpu()
    alts, costs = alts[:, rows].cpu(), costs[:, rows].cpu()
    act = None if active is None else active.cpu() > 0
    worst = 0.0
    for i in range(rows.numel()):
        worst = max(worst, _explain(cand[i], alts[:, i], costs[:, i], act))
        if worst == math.inf:
            break
    return worst


def _explain(cand, alts, costs, active) -> float:
    """The least cost of one row's explanation: each cell's variate is one
    of its outcomes (the reference's at cost 0); a cell's outcome taken as
    the anchor fixes the row's sum, and every other cell must then match
    one of its outcomes.  Inactive cells must read 0."""
    vals, cost = alts, costs                            # [R + 1, A]
    if active is not None:
        if bool((torch.abs(cand[~active]) > TOL).any()):
            return math.inf
        vals, cost, cand = vals[:, active], cost[:, active], cand[active]
    ok = torch.isfinite(cost)
    # anchors: (candidate r, cell j) with the row's sum vals[r, j] / cand[j]
    r, j = ok.nonzero(as_tuple=True)
    keep = cand[j] > 0
    r, j = r[keep], j[keep]
    if r.numel() == 0:
        return math.inf
    total = vals[r, j] / cand[j]                          # [M]
    scaled = vals[None] / total[:, None, None]            # [M, R + 1, A]
    match = (torch.abs(scaled - cand[None, None]) <= TOL) & ok[None]
    per_cell = torch.where(match, cost[None], math.inf).amin(1)  # [M, A]
    best = torch.maximum(per_cell.amax(-1), cost[r, j])
    return float(best.min())


def _chain(t: Tally, bits2, model, run, c, control):
    mode, k = model["mode"], model["n_pops"]
    seed, ck, step = run["seed"], int(run["chain_keys"][c]), run["step"]
    prev = {name: v[c] for name, v in run["prev"].items()}
    fin = {name: v[c] for name, v in run["final"].items()}
    dev = bits2.device
    n, l = bits2.shape
    lo_t = torch.bfloat16
    selfing = mode == 2
    active = prev.get("active")
    dts = (F64, lo_t) if control else (F64,)

    q_prev = prev["q"].to(F64)
    rates_fin = fin["rates"]
    # the selfing tail: S from the state before the sweep, then G's
    # proposal from the program's new S
    if selfing:
        u_prop, u_acc, ug, ul = ref.s_tail_uniforms(
            seed, ck, step, max(1, model["s_subsweeps"]), k, n,
            model["fused_tail"], F64, dev)
        s_ref = ref.s_sweeps(q_prev, prev["gen"], prev["rates"].to(F64),
                             u_prop, u_acc, model["mh_step_s"])
        if control:
            s_cand = ref.s_sweeps(q_prev.to(lo_t), prev["gen"],
                                  prev["rates"].to(lo_t), u_prop.to(lo_t),
                                  u_acc.to(lo_t), model["mh_step_s"])
        else:
            s_cand = rates_fin
        t.off("s", _off(s_cand, s_ref), k)
        gprop = {dt: ref.gen_proposal(ug.to(dt), q_prev.to(dt)
                                      @ rates_fin.to(dt), model["gen_cap"])
                 for dt in dts}
        wc = torch.exp2(1.0 - prev["gen"].to(F64))

    rows = block_rows(l, k)
    counts_prev = torch.zeros((k, l, 2), dtype=torch.int64, device=dev)
    counts_fin = torch.zeros_like(counts_prev)
    qq = torch.zeros((n, k), dtype=torch.int64, device=dev)
    ll_diff, ll, llm = ({dt: torch.zeros(n, dtype=dt, device=dev)
                         for dt in dts} for _ in range(3))
    wg_fin = torch.exp2(1.0 - fin["gen"].to(F64)) if selfing else None
    z_ulps = 0.0
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        g0, g1, valid, hom = ref.unpack(bits2[r0:r1])
        zp = prev["z"][r0:r1].to(torch.int64)
        zf = fin["z"][r0:r1].to(torch.int64)
        counts_prev += recount(zp, g0, g1, valid, k)
        counts_fin += recount(zf, g0, g1, valid, k)
        qq[r0:r1] = qq_counts(zf, valid, k)
        u = px.u01_closed(px.words(seed, ck, step, px.STREAM_Z, r0 * 2 * l,
                                   (r1 - r0) * 2 * l, dev), F64)
        u = u.reshape(r1 - r0, 2 * l)
        zf0, zf1 = zf[:, :l], zf[:, l:]
        ws = {dt: (ref.copy_probs(fin["freq"].to(dt), g0),
                   ref.copy_probs(fin["freq"].to(dt), g1)) for dt in dts}
        zc = zf
        if control:
            w0, w1 = ws[lo_t]
            qb, ub = q_prev[r0:r1].to(lo_t), u.to(lo_t)
            zc = torch.cat([ref.z_draw(qb, w0, ub[:, :l]),
                            ref.z_draw(qb, w1, ub[:, l:])], dim=1)
        w0, w1 = ws[F64]
        for wc_, half in ((w0, slice(0, l)), (w1, slice(l, 2 * l))):
            _, gap = ref.z_draw(q_prev[r0:r1], wc_, u[:, half], zc[:, half])
            z_ulps = max(z_ulps, gap)
        for dt, (w0, w1) in ws.items():
            if selfing:
                wp = torch.exp2(1.0 - gprop[dt][r0:r1].to(dt))
                ll_diff[dt][r0:r1] = ref.gen_loglik_ratio(
                    w0, w1, zf0, zf1, valid, hom, wc[r0:r1].to(dt), wp)
            wgb = None if wg_fin is None else wg_fin[r0:r1].to(dt)
            ll[dt][r0:r1] = ref.zcond_loglik(mode, w0, w1, zf0, zf1, valid,
                                             hom, wgb)
            if model["refreshed"]:
                llm[dt][r0:r1] = ref.marginal_loglik(
                    mode, fin["q"][r0:r1].to(dt), w0, w1, valid, hom, wgb)
    t.widest("z_flip_ulps", z_ulps)

    # the exact quantities
    if control:
        zc_prev = counts_prev.to(lo_t).to(F64)
        zc_fin = counts_fin.to(lo_t).to(F64)
    else:
        zc_prev, zc_fin = prev["zcounts"], fin["zcounts"]
    exact = (int((zc_prev.to(F64) != counts_prev.to(F64)).sum())
             + int((zc_fin.to(F64) != counts_fin.to(F64)).sum()))

    # P | the recounted counts
    p_g, p_alts, p_costs = ref.dirichlet_p(seed, ck, step,
                                           counts_prev.to(F64), F64, True)
    p_cand = (ref.dirichlet_p(seed, ck, step, counts_prev.to(F64), lo_t)
              if control else fin["freq"])
    t.widest("p_flip_ulps", row_flip_ulps(
        p_cand.reshape(-1, 2), p_g.reshape(-1, 2),
        p_alts.reshape(p_alts.shape[0], -1, 2),
        p_costs.reshape(p_costs.shape[0], -1, 2)))
    del p_g, p_alts, p_costs, p_cand

    # G's accept at the program's z
    if selfing:
        ul_log = torch.log(ul)
        g_ref = torch.where(ul_log < ll_diff[F64], gprop[F64],
                            prev["gen"].to(torch.int64))
        g_cand = (torch.where(ul_log.to(lo_t) < ll_diff[lo_t], gprop[lo_t],
                              prev["gen"].to(torch.int64))
                  if control else fin["gen"].to(torch.int64))
        t.off("g", int((g_cand != g_ref).sum()), n)

    # Q | the program's z, then alpha | the program's Q
    conc = qq.to(F64) + prev["alpha"].to(F64)
    q_g, q_alts, q_costs = ref.dirichlet_q(seed, ck, step, conc, active, F64,
                                           True)
    q_cand = (ref.dirichlet_q(seed, ck, step, conc, active, lo_t)
              if control else fin["q"])
    t.widest("q_flip_ulps", row_flip_ulps(q_cand, q_g, q_alts, q_costs,
                                          active))
    a_ref = ref.alpha_step(seed, ck, step, fin["q"].to(F64),
                           prev["alpha"].to(F64), active, model["alpha_sd"],
                           F64)
    a_cand = (ref.alpha_step(seed, ck, step, fin["q"].to(lo_t),
                             prev["alpha"].to(lo_t), active,
                             model["alpha_sd"], lo_t)
              if control else fin["alpha"])
    t.off("alpha", _off(a_cand, a_ref, TOL * max(1.0, float(a_ref))), 1)

    # the stored step's log-liks
    ll_cand = ll[lo_t] if control else fin["loglik_indv"]
    tot_cand = ll[lo_t].sum() if control else fin["loglik_total"]
    t.widest("ll_gap", max(_rel_gap(ll_cand, ll[F64], 1.0),
                           _rel_gap(tot_cand, ll[F64].sum(), 1.0)))
    if model["refreshed"]:
        llm_cand = llm[lo_t] if control else fin["loglik_marg"]
        t.widest("llm_gap", _rel_gap(llm_cand, llm[F64], 1.0))

    # the running moments: the program's before the sweep, folded with the
    # program's stored draw
    stats = {"total_ll": fin["loglik_total"], "indv_ll": fin["loglik_indv"],
             "q": fin["q"], "rates": fin["rates"],
             "gen": fin["gen"].float() if selfing else prev["acc.mean.gen"],
             "freq": fin["freq"] if model["track_freq"]
             else prev["acc.mean.freq"],
             "ll_marg": fin["loglik_marg"]}
    qsum = fin["q"].to(F64).sum(0) < 0.01
    if active is not None:
        qsum = qsum & (active > 0)
    flag = bool(qsum.any())

    def moments(dt):
        acc = {name[4:]: (v.to(dt) if v.is_floating_point() else v)
               for name, v in prev.items() if name.startswith("acc.")}
        return ref.moments_update(acc, {s: v.to(dt) for s, v in stats.items()},
                                  model["check_at"], model["ckrep"], flag)

    want = moments(F64)
    got = (moments(lo_t) if control else
           {name[4:]: v for name, v in fin.items() if name.startswith("acc.")})
    exact += int(int(got["count"]) != want["count"])
    exact += int(bool(got["empty_cluster"]) != want["empty_cluster"])
    gap = 0.0
    for name, w in want.items():
        if name in ("count", "empty_cluster") or w.numel() == 0:
            continue
        if name == "m2_ll_marg":
            t.widest("m2_gap", _rel_gap(got[name], w, 1e-3))
        else:
            gap = max(gap, _rel_gap(got[name], w, 1e-3))
    t.widest("moments_gap", gap)
    t.off("exact", exact, 1)


def init_numbers(bits2, model: dict, state: dict, same: bool = True
                 ) -> dict:
    """``init_bad`` of the initial state (chain axis first); ``same``:
    whether it is the one the timed job ran from (by fingerprint)."""
    k, cap = model["n_pops"], model["gen_cap"]
    bad = int(not same)
    z, q = state["z"], state["q"]
    n, l = bits2.shape
    bad += int(((z < 0) | (z >= k)).any())
    bad += int(((q < 0).any() | (torch.abs(q.to(F64).sum(-1) - 1.0) > 1e-4)
                .any()))
    bad += int(((state["rates"] < 0) | (state["rates"] > 1)).any())
    bad += int(((state["alpha"] < 0)
                | (state["alpha"] > model["alpha_prior_max"])).any())
    if model["mode"] == 2:
        bad += int(((state["gen"] < 1) | (state["gen"] > cap)).any())
    rows = block_rows(l, k)
    for c in range(z.shape[0]):
        counts = torch.zeros((k, l, 2), dtype=torch.int64, device=z.device)
        for r0 in range(0, n, rows):
            g0, g1, valid, _ = ref.unpack(bits2[r0:r0 + rows])
            counts += recount(z[c, r0:r0 + rows].to(torch.int64), g0, g1,
                              valid, k)
        bad += int((state["zcounts"][c].to(F64) != counts.to(F64)).any())
    return {"init_bad": bad}
