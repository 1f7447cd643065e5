"""Human-readable output report, drop-in comparable with the reference.

Reproduces the report structure written by printinfo (InStruct.c:450-531),
chain_stat/print_*_to_file (result_analysis.c:34-414) and chain_converg
(check_converg.c:44-91): banner, config echo, per-chain posterior tables
(log-lik + DIC, S/F, generations, Q in plain or Distruct format, membership
matrix, optional P), and the Gelman-Rubin verdict.

Counterpart of ``instruct_tpu/report.py``: it reads this package's
``RunResult`` / ``KSelectResult`` (tensors come to the host with
``.detach().cpu().numpy()``) and, given the same posterior moments, writes
the same bytes as the JAX package's writer -- its banner included, so the
two reports compare with ``cmp``.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

import torch

from instruct_tpu_torch.config import ModelSpec, PriorFamily, Schedule
from instruct_tpu_torch.data.dataset import Panel
from instruct_tpu_torch.diagnostics import (effective_sample_size,
                                            gelman_rubin)
from instruct_tpu_torch.mcmc.driver import RunResult

_BANNER_WIDTH = 100


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _chain_view(tree, chn):
    return {k: _host(v)[chn] for k, v in tree._asdict().items()}


def write_report(
    path: str,
    panel: Panel,
    spec: ModelSpec,
    sched: Schedule,
    result: RunResult,
    chain_names: Optional[Sequence[str]] = None,
    argv: Optional[Sequence[str]] = None,
    distr_fmt: int = 1,
    print_freq: bool = False,
    gr_flag: bool = True,
    echo: Optional[dict] = None,
) -> None:
    buf = io.StringIO()
    _print_header(buf, panel, spec, sched, argv, distr_fmt, echo,
                  gr_flag=gr_flag, print_freq=print_freq)
    n_chains = sched.n_chains
    if chain_names is None:
        chain_names = [f"Chain#{i + 1}" for i in range(n_chains)]
    for chn in range(n_chains):
        _print_chain(buf, panel, spec, result, chn, chain_names[chn],
                     distr_fmt, print_freq)
    if gr_flag:
        _print_convergence(buf, result, n_chains)
    with open(path, "w") as fh:
        fh.write(buf.getvalue())


def _print_header(fh, panel, spec, sched, argv, distr_fmt, echo=None,
                  gr_flag=True, print_freq=False):
    """Banner + config echo, mirroring printinfo (InStruct.c:450-531)
    line for line where a counterpart exists.  ``echo`` optionally carries
    run-context values the reference echoes from globals: datafile,
    initfile, outfile, missing, siglevel, seeds, inf_k."""
    echo = echo or {}
    fh.write("\n" + "=" * _BANNER_WIDTH + "\n")
    fh.write("\tinstruct_tpu — TPU-native reimplementation of\n")
    fh.write("\tInStruct by Gao, Williamson and Bustamante (2007)\n")
    fh.write("=" * _BANNER_WIDTH + "\n\n")
    if argv:
        fh.write("Command line arguments:\n    " + " ".join(argv) + "\n\n")
    if echo.get("datafile"):
        fh.write(f"Data File:   {echo['datafile']}\n")  # InStruct.c:474
    if echo.get("initfile"):
        fh.write(f"Initial File:   {echo['initfile']}\n")
    if echo.get("outfile"):
        fh.write(f"Output File:   {echo['outfile']}\n\n")
    fh.write("Run parameters:\n")
    fh.write(f"    Chain Number={sched.n_chains}\n")
    fh.write(f"    MCMC Iterations Number={sched.n_iter}\n")
    fh.write(f"    Burn-in={sched.burnin}\n")
    fh.write(f"    Thinning={sched.thinning}\n")
    fh.write(f"    Ploid={spec.ploid}\n")
    if spec.ploid > 2:
        fh.write("Autopolyploid assumed\n" if spec.autopoly
                 else "Allopolyploid assumed\n")  # InStruct.c:484-486
    if echo.get("missing") is not None:
        fh.write(f"    Missing Data={echo['missing']}\n")  # InStruct.c:488
    fh.write(f"    Population size={panel.n_indv}\n")
    fh.write(f"    Number of loci={panel.n_loci}\n")
    fh.write(f"    Population number assumed={spec.n_pops}\n")
    if echo.get("siglevel") is not None:
        fh.write("    Significance level for Posterior Credible Interval="
                 f"{echo['siglevel']:f}\n")  # InStruct.c:493
    if echo.get("seeds") is not None:
        fh.write("    Random number generator seeds="
                 + " ".join(str(s) for s in echo["seeds"]) + "\n")
    mode_txt = {
        0: "Make inference of population structure only without admixture.",
        1: "Make inference of population structure only with admixture.",
        2: ("Make inference of population structure and the selfing rates "
            "for subpopulations."),
        3: ("Make inference of population structure and the selfing rates "
            "for individuals."),
        4: ("Make inference of population structure and the inbreeding "
            "coefficients for subpopulations."),
        5: ("Make inference of population structure and the inbreeding "
            "coefficients for individuals."),
    }
    fh.write(f"    Mode = {mode_txt[spec.mode]}\n")
    if echo.get("inf_k"):
        fh.write("\nMake inference of the number of subpopulations.\n")
    if spec.mode in (3, 5):            # InStruct.c:515-517
        fam = spec.priors.family
        if fam == PriorFamily.UNIFORM:
            fh.write("The Uniform prior is used for selfing rates.\n")
        elif fam == PriorFamily.DPM:
            fh.write("The Dirichlet Process prior is used for selfing "
                     "rates and the scaling parameter is "
                     f"{spec.priors.alpha_dpm:f}.\n")
        else:
            fh.write("The hierarchical Normal prior is used for selfing "
                     "rates.\n")
    prop = ("back-reflection" if spec.back_refl
            else "adaptive independence sampler")
    fh.write(f"The proposal method for selfing rates is {prop}.\n")
    if print_freq:                     # InStruct.c:525-526
        fh.write("The posterior allele frequencies will also be "
                 "summarized and written to output file.\n")
    if gr_flag:                        # InStruct.c:528
        fh.write(f"The {sched.ckrep} stored iteration results after "
                 "burn-in will be used to calculate the GR statistic.\n")
    if distr_fmt == 1:
        fh.write("The output of Q are generated in the Distruct format.\n")
    fh.write("\n")


def _sort_clusters(spec: ModelSpec, rates_mean: np.ndarray) -> np.ndarray:
    """Cluster relabeling by ascending posterior-mean S/F — the indexx sort
    (result_analysis.c:83-87 via quantile.c:20)."""
    if spec.rates_are_per_pop and rates_mean.size:
        return np.argsort(rates_mean, kind="stable")
    return np.arange(spec.n_pops)


def _print_chain(fh, panel: Panel, spec, result: RunResult, chn, name,
                 distr_fmt, print_freq):
    mean = _chain_view(result.accum.mean, chn)
    var = _chain_view(result.posterior_var, chn)
    fh.write(f"\n\n\n{name}:\n")
    fh.write("\nThe log Likelihood:\n")
    fh.write(f"    Posterior Mean = {mean['total_ll']:.3f}\n")
    fh.write(f"    Posterior Variance = {var['total_ll']:.3f}\n")
    dic = float(result.dic()[chn])
    fh.write(
        f"\nThe Deviance information criterion of this model is {dic:f}.\n")
    pd = result.p_d()
    if pd is not None:
        # corrected DIC = Dbar + pD with a real plug-in deviance at the
        # posterior means; the reference-formula number (-2 E[logL],
        # result_analysis.c:403-411) is kept for binary comparison
        fh.write(f"    Effective number of parameters pD = "
                 f"{float(pd[chn]):.3f}\n")
        fh.write(f"    (reference-formula DIC = "
                 f"{float(result.dic_reference()[chn]):f})\n")
    waic = result.waic()
    if waic is not None:
        pw = result.p_waic()
        fh.write(f"The WAIC of this model is {float(waic[chn]):f} "
                 f"(pWAIC = {float(pw[chn]):.3f}).\n")

    order = _sort_clusters(spec, mean["rates"])

    if spec.rates_are_per_pop and mean["rates"].size:
        label = ("Selfing Rates" if (spec.has_selfing or spec.ploid == 4)
                 else "Inbreeding Coefficients")
        fh.write(f"\nThe Posterior distribution of {label}:\n")
        fh.write("\t\tMean\tVar\n")
        for j, src in enumerate(order):
            fh.write(f"Cluster {j + 1}\t{mean['rates'][src]:.3f}\t"
                     f"{var['rates'][src]:.3f}\n")
    elif spec.rates_are_per_indv:
        label = ("Selfing Rates" if spec.has_selfing
                 else "Inbreeding Coefficients")
        fh.write(f"\nThe Posterior distribution of {label}:\n")
        fh.write("\t\tMean\tVar\n")
        for j in range(panel.n_indv):
            nm = (panel.indv_names[j] + "\t") if panel.indv_names else ""
            fh.write(f"Indv {j + 1}\t\t{nm}{mean['rates'][j]:.3f}\t"
                     f"{var['rates'][j]:.3f}\n")

    if spec.has_selfing:
        fh.write("\nThe Posterior distribution of Generations:\n")
        fh.write("\t\tMean\tVariance\n")
        for j in range(panel.n_indv):
            nm = (panel.indv_names[j] + "\t") if panel.indv_names else ""
            fh.write(f"Indv {j + 1}\t\t{nm}{mean['gen'][j]:.3f}\t"
                     f"{var['gen'][j]:.3f}\n")

    _print_q(fh, panel, spec, mean, var, order, distr_fmt)
    if print_freq and mean["freq"].size:
        _print_p(fh, panel, spec, mean, var, order)


def _print_q(fh, panel: Panel, spec, mean, var, order, distr_fmt):
    q, q2 = mean["q"], var["q"]
    n, k = q.shape
    title = ("Inferred Classification of individuals"
             if spec.mode == 0 and spec.ploid == 2
             else "Inferred ancestry of individuals")
    fh.write(f"\n{title}:\n\nIndv\t")
    if panel.indv_names:
        fh.write("Label\t")
    fh.write("(Miss)\tPop : ")
    for j in range(k):
        fh.write(f"\tCluster {j + 1}" if distr_fmt else
                 f"Cluster {j + 1}:Mean\tVar\t\t")
    fh.write("\n")
    missv = panel.missing_per_indv
    pop_count = panel.n_predefined_pops
    membership = np.zeros((pop_count, k))
    tally = np.zeros(pop_count, np.int64)
    for j in range(n):
        fh.write(f"{j + 1}\t")
        if panel.indv_names:
            fh.write(f"{panel.indv_names[j]}\t")
        fh.write(f"({int(missv[j])})\t")
        src_pop = int(panel.pop_index[j]) if panel.pop_index is not None else 0
        fh.write(f"{src_pop} : " if panel.pop_index is not None else "1 : ")
        membership[src_pop] += q[j]
        tally[src_pop] += 1
        for kk in range(k):
            if distr_fmt:
                fh.write(f"\t{q[j, kk]:.3f}")
            else:
                fh.write(f"\t{q[j, kk]:.3f}\t{q2[j, kk]:.3f}\t")
        fh.write("\n")

    fh.write("\n\n\nThe index and name of pre-defined populations:\n")
    if panel.pop_names:
        for i, nm in enumerate(panel.pop_names):
            fh.write(f"{i} {nm}\n")
    else:
        fh.write("1\n")
    fh.write(f"\n\nProportion of membership of each pre-defined population "
             f"in each of the {k} clusters\n")
    fh.write("Given Pop\tInferred Clusters\t\tNumber of Individuals\n    \t\t")
    fh.write("".join(f"{i + 1}    " for i in range(k)) + "\n")
    # Modes with per-pop rates print clusters in sorted order
    # (result_analysis.c:298-299).
    cluster_cols = order if spec.rates_are_per_pop else np.arange(k)
    for i in range(pop_count):
        fh.write(f"{i}:\t")
        for col in cluster_cols:
            fh.write(f"{membership[i, col] / max(tally[i], 1):.3f} ")
        fh.write(f"\t{tally[i]}\n")
    fh.write("\n")


def _print_p(fh, panel: Panel, spec, mean, var, order):
    freq, freq2 = mean["freq"], var["freq"]
    fh.write("\n\n\nEstimated allele frequencies:\n\nLocus_ID\t")
    if panel.marker_names:
        fh.write("Marker Name\t")
    fh.write("Alleletype\t")
    k = freq.shape[0]
    for j in range(k):
        fh.write(f"Cluster {j + 1}:Mean\tVar\t\t")
    fh.write("\n")
    cols = order if spec.rates_are_per_pop else np.arange(k)
    n_alleles = (panel.n_alleles if panel.n_alleles is not None
                 else np.full(panel.n_loci, freq.shape[2]))
    for l in range(panel.n_loci):
        for a in range(int(n_alleles[l])):
            fh.write(f"{l + 1}\t" if a == 0 else "\t")
            if panel.marker_names:
                fh.write(f"{panel.marker_names[l]}\t" if a == 0 else "\t")
            aname = (panel.allele_names[l][a]
                     if panel.allele_names else str(a))
            fh.write(f"{aname}\t")
            for col in cols:
                fh.write(f"\t{freq[col, l, a]:.3f}\t{freq2[col, l, a]:.3f}\t")
            fh.write("\n")
        fh.write("\n")


def write_kselect_report(
    path: str,
    panel: Panel,
    spec: ModelSpec,
    sched: Schedule,
    ksel,
    chain_names: Optional[Sequence[str]] = None,
    argv: Optional[Sequence[str]] = None,
    distr_fmt: int = 1,
    print_freq: bool = False,
    gr_flag: bool = True,
    echo: Optional[dict] = None,
) -> None:
    """K-inference report: per-K sections (banner + chain tables + GR, the
    appends of inf_K_val, InStruct.c:555-577) followed by the closing range
    + optimal-K lines (InStruct.c:595-598) and a per-K DIC/pD/GR summary
    table the reference lacks."""
    import dataclasses as _dc

    echo = dict(echo or {})
    echo["inf_k"] = True
    buf = io.StringIO()
    _print_header(buf, panel, spec, sched, argv, distr_fmt, echo,
                  gr_flag=gr_flag, print_freq=print_freq)
    n_chains = sched.n_chains
    if chain_names is None:
        chain_names = [f"Chain#{i + 1}" for i in range(n_chains)]
    for k in sorted(ksel.results):
        buf.write(f"\n\nThe current K is {k}\n")      # InStruct.c:560
        spec_k = _dc.replace(spec, n_pops=k)
        res = ksel.results[k]
        for chn in range(n_chains):
            _print_chain(buf, panel, spec_k, res, chn, chain_names[chn],
                         distr_fmt, print_freq)
        if gr_flag:
            _print_convergence(buf, res, n_chains)
    buf.write(f"\n\nThe range of value for K is ({ksel.n_small} - "
              f"{ksel.n_large})!\n")                  # InStruct.c:597
    buf.write(f"The optimal K is {ksel.best_k}\n")
    # per-K selection summary (beyond the reference): WAIC (the selection
    # statistic — label-invariant, unlike any DIC plug-in), corrected DIC
    # with pD, reference-formula DIC and the GR verdict per K
    buf.write("\nK-selection summary (ranked on the chain-mean WAIC under "
              "the one-standard-error rule when available, else on the "
              "corrected DIC = Dbar + pD):\n")
    buf.write("K\tWAIC (mean±SE)\tmin DIC\tpD(min chain)\tmin ref-DIC\tGR\n")
    for k in sorted(ksel.dic):
        dic_k = ksel.dic[k]
        best_chain = int(np.argmin(dic_k))
        w_k = (ksel.waic or {}).get(k)
        se_k = (ksel.waic_se or {}).get(k)
        w_txt = (f"{float(w_k.mean()):.3f}±{se_k:.1f}"
                 if w_k is not None and se_k is not None else "-")
        pd_k = ksel.p_d.get(k)
        pd_txt = (f"{float(pd_k[best_chain]):.3f}"
                  if pd_k is not None else "-")
        gr_k = ksel.gelman_rubin.get(k)
        gr_txt = f"{gr_k:.4f}" if gr_k is not None else "-"
        buf.write(f"{k}\t{w_txt}\t{float(dic_k.min()):.3f}\t{pd_txt}\t"
                  f"{float(ksel.dic_reference[k].min()):.3f}\t{gr_txt}\n")
    with open(path, "w") as fh:
        fh.write(buf.getvalue())


def _print_convergence(fh, result: RunResult, n_chains):
    if n_chains == 1:
        fh.write("There is only one MCMC. No need to check the "
                 "convergence.\n")
        return
    convg = _host(result.accum.convg_ld)
    gr = float(gelman_rubin(convg))
    fh.write(f"\n\nThe Gelman-Rubin statistics for the convergence of "
             f"log-likelihood is {gr:f}.\n")
    # Extra diagnostic beyond the reference: per-chain ESS of the stored
    # log-likelihood trace.
    ess = [effective_sample_size(convg[c]) for c in range(convg.shape[0])]
    fh.write("Effective sample size of the log-likelihood trace per "
             "chain: " + " ".join(f"{e:.1f}" for e in ess)
             + f" (of {convg.shape[1]} stored)\n")
