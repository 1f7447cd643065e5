"""Command-line interface accepting the reference's conceptual knobs.

Counterpart of ``instruct_tpu/cli.py``: the same parser (every flag, the
same defaults) and the same output lines; run ``python -m
instruct_tpu_torch --help``.  ``--platform`` picks the torch device:
``cuda`` (the default) or ``cpu``.  Without a CUDA device the run fails
unless ``--platform cpu`` is given; it never moves to the CPU on its own.
``--profile-dir`` writes a ``torch.profiler`` trace of the run there, and
the run's spans (``spans.py``) beside it.

``--sampler hmc|nuts|svi|smc`` runs the gradient samplers over the
marginalized model (``samplers/run.py``) and writes their report; as in
the JAX package they take no mesh.

Sharded runs (``parallel/``): every process of a world runs the same line
with its own ``--process-id``, joined through ``--coordinator host:port``
and ``--num-processes``: NCCL under ``--platform cuda``, gloo under
``--platform cpu``.  ``--chain-shards`` / ``--data-shards`` shape the
(chain, data) mesh over the world (every rank on the chain axis by
default); rank 0 alone writes the report and the ``-cf`` file.
``--mesh-mode gspmd`` has no counterpart and is refused with exit code 2,
as is ``--process-id`` without ``--num-processes``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="instruct_tpu_torch",
        description="Bayesian inference of population structure with "
                    "selfing/inbreeding (InStruct model family) on an "
                    "NVIDIA GPU")
    p.add_argument("-d", dest="datafile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-i", dest="initfile", default=None)
    p.add_argument("-K", dest="popnum", type=int, default=2)
    p.add_argument("-L", dest="nloci", type=int, default=100)
    p.add_argument("-N", dest="totalsize", type=int, default=100)
    p.add_argument("-p", dest="ploid", type=int, default=2)
    p.add_argument("-u", dest="update", type=int, default=1_000_000)
    p.add_argument("-b", dest="burnin", type=int, default=500_000)
    p.add_argument("-t", dest="thinning", type=int, default=10)
    p.add_argument("-c", dest="chainnum", type=int, default=2)
    p.add_argument("-s", dest="seeds", type=int, nargs=3, default=None,
                   help="three seed integers (folded into the run's 64-bit "
                        "seed)")
    p.add_argument("-m", dest="missing", default="-9")
    p.add_argument("-sl", dest="siglevel", type=float, default=0.9)
    p.add_argument("-lb", dest="label", type=int, default=1)
    p.add_argument("-a", dest="popdata", type=int, default=1)
    p.add_argument("-g", dest="gr_flag", type=int, default=1)
    p.add_argument("-r", dest="ckrep", type=int, default=20)
    p.add_argument("-f", dest="prior_flag", type=int, default=0,
                   help="0=uniform, 1=DPM, 2=normal prior on S/F")
    p.add_argument("-v", dest="mode", type=int, default=1)
    p.add_argument("-h2", "--alpha-dpm", dest="alpha_dpm", type=float,
                   default=10.0, help="DPM concentration (reference -h)")
    p.add_argument("--s-subsweeps", dest="s_subsweeps", type=int, default=1,
                   help="inner MH sweeps of the S update per step (modes "
                        "2/3); ~12 saturates S mixing for ~10% step cost, "
                        "1 = reference schedule")
    p.add_argument("--dp-trunc", dest="dp_truncation", type=int, default=0,
                   help="0 = exact sequential CRP sweep; T>0 = blocked "
                        "truncated-stick-breaking DP with T components "
                        "(parallel over individuals, for large N)")
    p.add_argument("--marginalize-g", dest="marginalize_g",
                   action="store_true",
                   help="Rao-Blackwellize the selfing generations (modes "
                        "2/3, structure way): exact categorical G draws + "
                        "S updates on the G-marginal posterior")
    p.add_argument("-e", dest="back_refl", type=int, default=1)
    p.add_argument("-y", dest="type_freq", type=int, default=1)
    p.add_argument("-j", dest="nstep_check", type=int, default=20)
    p.add_argument("-x", dest="n_extra_col", type=int, default=0)
    p.add_argument("-w", dest="markername", type=int, default=0)
    p.add_argument("-cf", dest="convgfile", default=None)
    p.add_argument("-pi", dest="print_iter", type=int, default=1)
    p.add_argument("-pf", dest="print_freq", type=int, default=0)
    p.add_argument("-ik", dest="inf_k", type=int, default=0)
    p.add_argument("-kv", dest="k_range", type=int, nargs=2, default=None)
    p.add_argument("-df", dest="distr_fmt", type=int, default=1)
    p.add_argument("-mm", dest="max_mem", type=float, default=16e9)
    p.add_argument("-ap", dest="autopoly", type=int, default=1)
    p.add_argument("-af", dest="data_fmt", type=int, default=0)
    p.add_argument("--chain-shards", type=int, default=None)
    p.add_argument("--data-shards", type=int, default=None)
    p.add_argument("--mesh-mode", default="auto",
                   choices=["auto", "shard_map", "gspmd"],
                   help="loci-axis partitioning: auto and shard_map are "
                        "the per-rank all-reduce path; gspmd has no "
                        "counterpart in the port")
    p.add_argument("--platform", default="cuda",
                   help="torch device of the run: cuda (default) or cpu")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: rank 0's address (host:port) for "
                        "torch.distributed")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's id")
    p.add_argument("--sampler", default="gibbs",
                   choices=["gibbs", "hmc", "nuts", "svi", "smc"],
                   help="inference engine (gibbs = reference-family MCMC; "
                        "hmc/nuts/svi/smc = gradient samplers over the "
                        "marginalized model)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100_000)
    p.add_argument("--jsonl-log", default=None,
                   help="structured per-segment metrics log")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    return p


def run_seed(seeds) -> int:
    """The run's integer seed from ``-s s1 s2 s3`` (the reference's three
    Wichmann-Hill seeds), or its default seeds' value."""
    if seeds is None:
        return 13_04_1972
    s1, s2, s3 = seeds
    return ((s1 * 1_000_003 + s2) * 1_000_003 + s3) % (2 ** 63)


@contextlib.contextmanager
def _profiled(directory, device):
    """A ``torch.profiler`` trace of the block, written as
    ``<directory>/trace.json`` (Chrome trace format), and the run's spans
    (``spans.py``) as ``<directory>/spans.json``: the records, then per
    span name the count, total device seconds and total self seconds."""
    import json
    import torch
    from torch.profiler import ProfilerActivity, profile
    from instruct_tpu_torch import spans
    os.makedirs(directory, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    recs = spans.records()
    with open(os.path.join(directory, "spans.json"), "w") as fh:
        json.dump({"records": [r._asdict() for r in recs],
                   "totals": spans.totals(recs)}, fh)
    spans.clear()


def _refused(message: str) -> int:
    print(f"instruct_tpu_torch: {message}", file=sys.stderr)
    return 2


def _mesh_of(args, device):
    """The run's mesh from the shard flags (after joining the world), or
    None for an unsharded run in a world of one."""
    from instruct_tpu_torch.parallel import initialize_multihost, make_mesh
    from instruct_tpu_torch.parallel.mesh import world
    initialize_multihost(args.coordinator, args.num_processes,
                         args.process_id, device=device)
    mesh_dev = device if device.type == "cpu" else None
    if args.chain_shards or args.data_shards:
        return make_mesh(args.chain_shards, args.data_shards,
                         device=mesh_dev)
    if world()[0] > 1:
        return make_mesh(device=mesh_dev)
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh_mode == "gspmd":
        return _refused("--mesh-mode gspmd has no counterpart in the "
                        "PyTorch port (GSPMD partitioning gives the "
                        "unsharded run's result: run without a mesh)")
    if args.process_id is not None and args.num_processes is None:
        return _refused("--process-id needs --num-processes")
    if (args.num_processes or 0) > 1 and args.coordinator is None:
        return _refused("--num-processes needs --coordinator host:port")

    import torch
    device = torch.device(args.platform)
    try:
        try:
            mesh = _mesh_of(args, device)
        except ValueError as e:
            return _refused(str(e))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("instruct_tpu_torch: --platform cuda, but "
                             "torch sees no CUDA device (give --platform "
                             "cpu to run on the CPU)")
        return _run(args, device, mesh)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device, mesh) -> int:

    from instruct_tpu_torch.config import (ModelSpec, PriorFamily, Priors,
                                           Schedule)
    from instruct_tpu_torch.data.loader import read_data, read_init
    from instruct_tpu_torch.kselect import infer_k
    from instruct_tpu_torch.mcmc.driver import run_mcmc
    from instruct_tpu_torch.mcmc.step import check_supported
    from instruct_tpu_torch.report import write_report

    panel = read_data(args.datafile, ploid=args.ploid, missing=args.missing,
                      label=args.label, popdata=args.popdata,
                      n_extra_col=args.n_extra_col,
                      markername=args.markername, data_fmt=args.data_fmt)
    family = {0: PriorFamily.UNIFORM, 1: PriorFamily.DPM,
              2: PriorFamily.NORMAL}[args.prior_flag]
    spec = ModelSpec(
        mode=args.mode, ploid=args.ploid, n_pops=args.popnum,
        type_freq=args.type_freq, back_refl=args.back_refl,
        priors=Priors(family=family, alpha_dpm=args.alpha_dpm,
                      dp_truncation=args.dp_truncation),
        autopoly=bool(args.autopoly), s_subsweeps=args.s_subsweeps,
        marginalize_g=args.marginalize_g)
    check_supported(spec, panel.data)
    sched = Schedule(
        n_iter=args.update, burnin=args.burnin, thinning=args.thinning,
        n_chains=args.chainnum, ckrep=args.ckrep,
        nstep_check_empty_cluster=args.nstep_check)

    from instruct_tpu_torch.memory import estimate_bytes
    mem = estimate_bytes(spec, sched, panel.data,
                         track_freq=bool(args.print_freq))
    print(f"The memory required for this run is {mem['total_bytes']:.0f}")
    print(f"The maximum memory allowed is {args.max_mem:.0f}")
    if mem["total_bytes"] > args.max_mem:
        raise SystemExit(
            "Your request of memory exceeds the maximum memory allowed! "
            "Please change the parameter max_mem")  # InStruct.c:171-172

    seed = run_seed(args.seeds)
    n_rates = spec.n_rates(panel.n_indv)
    init_rates, chain_names = read_init(args.initfile, args.chainnum,
                                        n_rates or 1)
    if n_rates == 0:
        init_rates = None

    profile_ctx = (_profiled(args.profile_dir, device)
                   if args.profile_dir else contextlib.nullcontext())
    if args.sampler != "gibbs":
        from instruct_tpu_torch.samplers.run import (run_sampler,
                                                     write_sampler_report)
        with profile_ctx:
            result = run_sampler(args.sampler, panel.data, spec, sched, seed,
                                 device=device)
        if mesh is not None and mesh.rank != 0:
            return 0
        write_sampler_report(args.outfile, panel, spec, result,
                             argv=sys.argv)
        print("THE JOB IS SUCCESSFULLY FINISHED")
        return 0

    echo = {"datafile": args.datafile, "initfile": args.initfile,
            "outfile": args.outfile, "missing": args.missing,
            "siglevel": args.siglevel,
            "seeds": args.seeds if args.seeds is not None else None}

    if args.inf_k:
        from instruct_tpu_torch.report import write_kselect_report
        n_small, n_large = (args.k_range if args.k_range else (1, 0))
        with profile_ctx:
            ksel = infer_k(panel.data, spec, sched, seed, n_small, n_large,
                           init_rates=init_rates,
                           track_freq=bool(args.print_freq)
                           or spec.ploid == 2, device=device, mesh=mesh,
                           mesh_mode=args.mesh_mode)
        if mesh is not None and mesh.rank != 0:
            return 0
        write_kselect_report(args.outfile, panel, spec, sched, ksel,
                             chain_names=chain_names, argv=sys.argv,
                             distr_fmt=args.distr_fmt,
                             print_freq=bool(args.print_freq),
                             gr_flag=bool(args.gr_flag), echo=echo)
        print(f"The optimal K is {ksel.best_k}")
        print("THE JOB IS SUCCESSFULLY FINISHED")
        return 0

    # print_info cadence: every 1% of iterations (mcmc.c:1273)
    progress = (max(1, args.update // 100) if args.print_iter else None)
    with profile_ctx:
        res = run_mcmc(panel.data, spec, sched, seed,
                       init_rates=init_rates,
                       track_freq=bool(args.print_freq), device=device,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every,
                       progress_every=progress, jsonl_log=args.jsonl_log,
                       mesh=mesh, mesh_mode=args.mesh_mode)
    if mesh is not None and mesh.rank != 0:
        # every rank holds the whole result; rank 0 writes it
        return 0
    write_report(args.outfile, panel, spec, sched, res,
                 chain_names=chain_names, argv=sys.argv,
                 distr_fmt=args.distr_fmt, print_freq=bool(args.print_freq),
                 gr_flag=bool(args.gr_flag), echo=echo)

    if args.convgfile:
        # byte-compatible with the reference's trace dump: chain-major flat
        # values, first "%f " then " %f " each (check_converg.c:75-89)
        convg = res.accum.convg_ld.detach().cpu().numpy().reshape(-1)
        with open(args.convgfile, "w") as fh:
            fh.write("Values of log-likelihood:\n")
            fh.write("  ".join(f"{v:f}" for v in convg) + " \n")

    print("THE JOB IS SUCCESSFULLY FINISHED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
