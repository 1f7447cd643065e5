"""Multi-process entry points.

Counterpart of ``instruct_tpu/parallel/distributed.py``.  Every process
calls :func:`initialize_multihost` with the same coordinator and world
size and its own rank, builds the same mesh (:func:`global_chain_mesh` or
``make_mesh``) and calls ``run_mcmc(..., mesh=mesh)`` with the same
arguments.  One process drives one device: NCCL between CUDA devices,
gloo on the CPU.  NCCL refuses two ranks on one device, so a world of
several ranks on one card names ``backend="gloo"``.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None, device="cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` (``host:port``, rank 0 listens there); nothing
    at ``num_processes <= 1``, as in the JAX package.  ``backend`` defaults
    to ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU; a failure
    of the backend is raised, never answered by another backend."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs the "
                         "coordinator address (host:port) and this "
                         "process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def global_chain_mesh(n_data_shards: int = 1, *, device=None):
    """The canonical multi-process mesh: every rank, chains-major."""
    from instruct_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(None, n_data_shards, device=device)
