"""The ("chain", "data") mesh of a run over ``torch.distributed``.

Counterpart of ``instruct_tpu/parallel/mesh.py``.  The JAX package drives
every device of a mesh from one program; the port runs one process per
rank, and rank ``r`` of a world of ``C x D`` ranks sits at mesh position
``(r // D, r % D)`` -- the JAX package's chains-major
``np.asarray(devices).reshape(C, D)``:

  * ``chain`` -- the chains are split into ``C`` contiguous blocks; the
    ranks of one chain block never talk during the sweeps;
  * ``data``  -- the loci are split into ``D`` contiguous blocks
    (``parallel/loci_shard.py``); the ``D`` ranks of a chain block add up
    three families of per-individual sums over their ``data_group``
    (:meth:`Mesh.all_reduce_`, the counterpart of ``_psum``,
    ``instruct_tpu/mcmc/updates.py:47``): the pop counts before the Q
    draw, the MH log-ratio columns, and the per-individual log-liks.

``chain_sharding``, ``replicate``, ``shard_dataset`` and ``get_shard_map``
have no counterpart: a rank holds its own chains and its own loci on its
own device, so there is no placement to declare and no partitioner to
call.  The JAX package's GSPMD mode has none either (``run_mcmc`` refuses
``mesh_mode="gspmd"``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def world() -> tuple:
    """(world size, rank): (1, 0) when ``torch.distributed`` is not
    initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``C x D`` mesh, its device, its process
    groups and a counter of its all-reduces (``stats``: their number,
    bytes and host seconds, the call's wall time)."""

    n_chain_shards: int
    n_data_shards: int
    rank: int
    device: torch.device
    data_group: Any = None     # the D ranks of this rank's chain block
    host_group: Any = None     # gloo over the world (object gathers);
    #   None: the default group, itself gloo
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def world_size(self) -> int:
        return self.n_chain_shards * self.n_data_shards

    @property
    def chain_index(self) -> int:
        return self.rank // self.n_data_shards

    @property
    def data_index(self) -> int:
        return self.rank % self.n_data_shards

    @property
    def shard(self) -> Optional[int]:
        """The loci shard's index for the site seed
        (``kernels/philox.py:fold_seed``), None when the loci are whole."""
        return self.data_index if self.n_data_shards > 1 else None

    def chain_rows(self, n_chains: int) -> range:
        """The global chain indices this rank runs."""
        if n_chains % self.n_chain_shards:
            raise ValueError(
                f"{n_chains} chains do not split over the "
                f"chain axis of {self.n_chain_shards} ranks")
        per = n_chains // self.n_chain_shards
        return range(self.chain_index * per, (self.chain_index + 1) * per)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the data group in place and return it; the
        identity when the loci are whole.  Every rank of the group gets
        the same bits (the reduction's result is broadcast), so the state
        that the sums feed stays equal across the group."""
        if self.n_data_shards == 1:
            return x
        if not x.is_contiguous():
            x = x.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=self.data_group)
        self.stats["all_reduce_s"] += time.perf_counter() - t0
        self.stats["all_reduces"] += 1
        self.stats["all_reduce_bytes"] += x.numel() * x.element_size()
        return x

    def gather(self, obj) -> List[Any]:
        """Every rank's ``obj`` (picklable), indexed by rank, on every
        rank; through CPU memory over gloo whatever the run's backend."""
        if self.world_size == 1:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def reset_stats(self) -> None:
        self.stats.clear()


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise ValueError("make_mesh: no CUDA device; pass device='cpu' "
                         "for a CPU run")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_chain_shards: Optional[int] = None,
              n_data_shards: Optional[int] = None, *,
              device=None) -> Mesh:
    """This rank's mesh over the ``torch.distributed`` world (a world of
    one when it is not initialized).  Defaults as in the JAX package: every
    rank on the chain axis; give ``n_data_shards`` to split the loci
    instead or as well.  ``device`` defaults to ``cuda:(local rank %
    device count)``.  Every rank must call it with the same arguments: it
    creates every data group of the mesh, in the same order on all ranks.
    The ranks of a loci block need no group of their own: what crosses
    chain blocks (the retry flags, the progress values, the result) is
    gathered over the whole world (:meth:`Mesh.gather`)."""
    n, rank = world()
    given = [x for x in (n_chain_shards, n_data_shards) if x is not None]
    if any(x < 1 or n % x for x in given):
        raise ValueError(f"mesh {n_chain_shards}x{n_data_shards} does not "
                         f"fit {n} ranks (the torch.distributed world size "
                         f"is {n})")
    if n_chain_shards is None and n_data_shards is None:
        n_chain_shards, n_data_shards = n, 1
    elif n_chain_shards is None:
        n_chain_shards = n // n_data_shards
    elif n_data_shards is None:
        n_data_shards = n // n_chain_shards
    if n_chain_shards < 1 or n_data_shards < 1 \
            or n_chain_shards * n_data_shards != n:
        raise ValueError(f"mesh {n_chain_shards}x{n_data_shards} != {n} "
                         f"ranks (the torch.distributed world size is {n})")
    dev = _default_device(rank) if device is None else torch.device(device)
    mesh = Mesh(n_chain_shards, n_data_shards, rank, dev)
    if dev.type == "cuda":
        # NCCL's collectives run on the current device
        torch.cuda.set_device(dev)
    if n == 1:
        return mesh
    c, d = n_chain_shards, n_data_shards
    if d > 1:
        for ci in range(c):
            g = dist.new_group([ci * d + j for j in range(d)])
            if ci == mesh.chain_index:
                mesh.data_group = g
    if dist.get_backend() != "gloo":
        mesh.host_group = dist.new_group(backend="gloo")
    return mesh
