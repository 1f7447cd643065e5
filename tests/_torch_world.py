"""Gloo worlds of the PyTorch port for the CPU tests.

``run_world(target, world, args)`` starts ``world`` processes of this
module, each a rank of a ``torch.distributed`` gloo world on localhost
(through the port's ``initialize_multihost``), calls ``target(*args)`` in
every rank and returns the ranks' return values, by rank.  The parent polls
the ranks: a rank that fails ends the world at once (the others are
killed, so none waits on a collective), and the world is killed at its
time limit.  The targets below are the ranks' halves of
``tests/test_torch_parallel*.py``; they import nothing of JAX.

    python tests/_torch_world.py DIR RANK WORLD PORT TARGET
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_world(target: str, world: int, args=(), timeout: float = 120.0):
    """The return values of ``target(*args)`` in each of ``world`` gloo
    ranks (``target`` names a function of this module)."""
    with tempfile.TemporaryDirectory(prefix="torch_world_") as td:
        tdp = Path(td)
        (tdp / "args.pkl").write_bytes(pickle.dumps(args))
        port = _free_port()
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   [str(REPO), str(HERE), os.environ.get("PYTHONPATH", "")]),
               "OMP_NUM_THREADS": "1"}
        procs = []
        for rank in range(world):
            with open(tdp / f"log_{rank}.txt", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__)), td, str(rank),
                     str(world), str(port), target],
                    stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO),
                    env=env))
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {target} exited with "
                        f"{codes[bad[0]]}:\n"
                        + _tail(tdp / f"log_{bad[0]}.txt"))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{target}: world of {world} still running after "
                        f"{timeout} s:\n" + _tail(tdp / "log_0.txt"))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [pickle.loads((tdp / f"out_{r}.pkl").read_bytes())
                for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' halves of the tests
# ---------------------------------------------------------------------------

def _np_tree(x):
    """Tensors (in NamedTuples, tuples, dicts) as numpy arrays."""
    import torch
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _np_tree(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return type(x)(_np_tree(v) for v in x)
    return x


def result_fields(res):
    """A RunResult as numpy: final state, accumulators, plug-in, retries."""
    return dict(state=_np_tree(res.final_state), accum=_np_tree(res.accum),
                plugin_ll=res.plugin_ll, n_retries=res.n_retries)


def run_case(data_fields, spec, sched, seed, mesh_shape, kwargs=None):
    """``run_mcmc`` on the mesh; the result (whole on every rank) and this
    rank's all-reduce counts."""
    from instruct_tpu_torch import convert, run_mcmc
    from instruct_tpu_torch.parallel import make_mesh
    mesh = make_mesh(*mesh_shape, device="cpu")
    data = convert.dataset_from_numpy(data_fields)
    res = run_mcmc(data, spec, sched, seed, mesh=mesh, **(kwargs or {}))
    return dict(result_fields(res), stats=dict(mesh.stats),
                rank=mesh.rank, data_index=mesh.data_index)


def run_cases(cases, mesh_shape):
    """:func:`run_case` of each ``(data_fields, spec, sched, seed)``."""
    return [run_case(*case, mesh_shape) for case in cases]


def sweep_cases(cases, mesh_shape):
    """One sweep of each case on this rank's loci block, from the
    unsharded state's block and the unsharded sweep's draws (this rank's
    loci of P's, z's and the orderings' draws; the replicated draws
    whole).  Returns this rank's state after the sweep and its log-lik."""
    from instruct_tpu_torch import convert
    from instruct_tpu_torch.kernels import philox as px
    from instruct_tpu_torch.mcmc.driver import recount_zcounts
    from instruct_tpu_torch.mcmc.step import StepDraws, build_step_parts
    from instruct_tpu_torch.parallel import loci_shard as ls
    from instruct_tpu_torch.parallel import make_mesh
    mesh = make_mesh(*mesh_shape, device="cpu")
    out = []
    for case in cases:
        full = convert.dataset_from_numpy(case["data"])
        src = ls.loci_plan(full, mesh.n_data_shards)[mesh.data_index]
        data = ls.shard_panel(full, mesh)
        state = local_state(convert.state_from_numpy(case["state"], "cpu"),
                            data, src)
        state = recount_zcounts(case["spec"], data, state)
        draws = StepDraws(**{k: local_draw(k, v, src, data.ploid)
                             for k, v in case["draws"].items()})
        step, add_ll = build_step_parts(case["spec"], data, mesh=mesh)
        keys = px.make_keys(0, state.q.shape[0], "cpu", shard=mesh.shard)
        mesh.reset_stats()
        got = add_ll(step(state, keys, 0, draws))
        out.append(dict(state=_np_tree(got), stats=dict(mesh.stats)))
    return out


def _take_loci(x, src, axis):
    """Columns ``src`` of axis ``axis`` (-1: a padding locus, column 0)."""
    import torch
    idx = torch.as_tensor([max(int(s), 0) for s in src])
    return x.index_select(axis, idx).contiguous()


def _take_sites(x, src, ploid):
    """Copy-major sites [..., ploid * L] -> this block's [..., ploid *
    L_loc] (padding sites take locus 0's values: they are invalid)."""
    lead = x.shape[:-1]
    y = _take_loci(x.reshape(*lead, ploid, -1), src, x.dim())
    return y.reshape(*lead, -1)


def local_state(state, data, src):
    """The block ``src`` of a whole-panel state (padding loci: flat P)."""
    import torch
    ploid = data.ploid
    pad = torch.as_tensor(src < 0)

    def freq_block(f):
        if f is None or f.dim() != 4:
            return f
        f = _take_loci(f, src, 2)
        av = data.allele_valid.to(torch.float32)
        flat = av / av.sum(-1, keepdim=True).clamp_min(1.0)
        return torch.where(pad[None, None, :, None], flat[None, None], f)

    def sites(x):
        if x is None or x.numel() == 0:
            return x
        return _take_sites(x, src, ploid)

    return state._replace(freq=freq_block(state.freq),
                          freq2=freq_block(state.freq2),
                          z=sites(state.z), geno=sites(state.geno),
                          zcounts=None if state.zcounts is None else
                          _take_loci(state.zcounts, src, 2))


def local_draw(name, v, src, ploid):
    """This rank's part of an injected draw of the unsharded sweep: the
    loci of P's (``p``, ``p2``: [..., L]), z's ([C, N, ploid * L]) and the
    orderings' ([..., L]) draws; the replicated draws whole."""
    import torch
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(None if x is None else torch.as_tensor(x) for x in v)
    t = torch.as_tensor(v)
    if name in ("p", "p2", "geno"):
        return _take_loci(t, src, t.dim() - 1)
    if name == "z":
        return _take_sites(t, src, ploid)
    return t


def checkpoint_case(data_fields, spec, sched, seed, mesh_shape, ck,
                    other_shape):
    """A run, the same run checkpointed every 8 sweeps, cut after step 8
    and resumed; then a resume under ``other_shape`` (refused)."""
    import shutil
    from instruct_tpu_torch import convert, run_mcmc
    from instruct_tpu_torch.parallel import make_mesh
    mesh = make_mesh(*mesh_shape, device="cpu")
    data = convert.dataset_from_numpy(data_fields)
    ref = run_mcmc(data, spec, sched, seed, mesh=mesh)
    run_mcmc(data, spec, sched, seed, mesh=mesh, checkpoint_dir=ck,
             checkpoint_every=8)
    mesh.gather(None)                       # every rank has saved
    if mesh.rank == 0:
        for root, dirs, files in os.walk(ck):
            for name in dirs + files:
                if name.startswith("step_") and int(name[5:17]) > 8:
                    p = os.path.join(root, name)
                    shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    mesh.gather(None)
    got = run_mcmc(data, spec, sched, seed, mesh=mesh, checkpoint_dir=ck,
                   checkpoint_every=8)
    other = make_mesh(*other_shape, device="cpu")
    try:
        run_mcmc(data, spec, sched, seed, mesh=other, checkpoint_dir=ck,
                 checkpoint_every=8)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(ref=result_fields(ref), got=result_fields(got),
                refused=refused)


def kselect_case(data_fields, spec, sched, seed, mesh_shape, ks):
    """``infer_k`` over K = ks[0]..ks[1] on the mesh, counting the
    ``run_mcmc`` calls it makes and whether any ran the padded grid."""
    from instruct_tpu_torch import convert
    from instruct_tpu_torch import kselect
    from instruct_tpu_torch.parallel import make_mesh
    mesh = make_mesh(*mesh_shape, device="cpu")
    data = convert.dataset_from_numpy(data_fields)
    calls = []
    real = kselect.run_mcmc

    def counted(*a, **kw):
        calls.append(kw.get("active_pops") is not None)
        return real(*a, **kw)

    kselect.run_mcmc = counted
    sel = kselect.infer_k(data, spec, sched, seed, ks[0], ks[1],
                          device="cpu", mesh=mesh)
    return dict(best_k=sel.best_k, calls=calls,
                waic={k: v for k, v in sel.waic.items()})


def _main(argv) -> int:
    td, rank, world, port, target = argv
    import torch
    torch.set_num_threads(1)
    from datetime import timedelta
    from instruct_tpu_torch.parallel import initialize_multihost
    initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                         device="cpu", timeout=timedelta(seconds=60))
    args = pickle.loads((Path(td) / "args.pkl").read_bytes())
    out = globals()[target](*args)
    (Path(td) / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
