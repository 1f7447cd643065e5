"""Checkpoint / resume for long MCMC runs.

Counterpart of ``instruct_tpu/checkpoint.py``, with ``torch.save`` in place
of orbax.  The reference has none -- a crashed 1M-iteration run restarts
from zero (survey section 5).  Here the (sampler states, streaming
accumulators, chain keys) payload is saved on a cadence, and resume is
**bitwise**: every draw is Philox keyed on (run seed, chain key, step)
(``kernels/philox.py``), so replaying from a checkpoint at step s produces
exactly the draws the uninterrupted run would have produced.  The chain
keys play the role of the JAX package's raw key data.

Format: ``<dir>/step_<12 digits>/state.pt`` holds a flat dict of CPU
tensors keyed by each leaf's field path (``states.freq``,
``accums.mean.q``, ``chain_key``), which is stable under adding or
reordering state fields; zero-size and ``None`` leaves are not stored and
are re-grafted from the caller's template at restore time.  A sibling
``step_<12 digits>.meta.json`` carries the package name, ``format_version``
and the saved keys, and the mesh that saved it (``mesh`` [C, D], ``rank``;
a loci- or chain-sharded run saves each rank's part under
``<dir>/rank_<r>/``, :func:`saved_mesh`).  A port checkpoint is not a JAX checkpoint: the JAX
package cannot read one (no orbax tree), and :func:`restore_checkpoint`
refuses a step without this package's meta file, so neither reads the
other's.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import torch

PACKAGE = "instruct_tpu_torch"
FORMAT_VERSION = 1
_STATE_FILE = "state.pt"


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:012d}")


def _meta_path(directory: str, step: int) -> str:
    return _ckpt_path(directory, step) + ".meta.json"


def _children(node):
    """(name, child) pairs of a dict or NamedTuple; None for a leaf (a
    tensor, ``None`` or a list of ints)."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return None


def _flatten(payload: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(field path, leaf) pairs of a payload of dicts and NamedTuples."""
    kids = _children(payload)
    if kids is None:
        return [(prefix, payload)]
    out = []
    for name, x in kids:
        out.extend(_flatten(x, f"{prefix}.{name}" if prefix else str(name)))
    return out


def _unflatten(template: Any, leaves: dict, prefix: str = "") -> Any:
    kids = _children(template)
    if kids is None:
        return leaves[prefix]
    vals = [_unflatten(x, leaves, f"{prefix}.{name}" if prefix else str(name))
            for name, x in kids]
    if isinstance(template, dict):
        return dict(zip(template, vals))
    return type(template)(*vals)


def _stored(leaf) -> bool:
    if leaf is None:
        return False
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() > 0
    return True


def save_checkpoint(directory: str, step: int, payload: Any,
                    mesh: Tuple[int, int] = (1, 1), rank: int = 0) -> None:
    """Persist ``payload`` (dicts and NamedTuples of tensors, ``None`` and
    lists of ints) at ``step``.  Tensors are stored from the CPU.  The meta
    file is written first and the state directory appears under its final
    name only once it is complete, so every entry that
    :func:`latest_step` finds has both.  ``mesh`` and ``rank`` record the
    saving run's mesh shape and rank."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = _ckpt_path(directory, step)
    pairs = _flatten(payload)
    d = {}
    for k, x in pairs:
        if not _stored(x):
            continue
        d[k] = (x.detach().cpu() if isinstance(x, torch.Tensor)
                else torch.tensor(x, dtype=torch.int64))
    td = tempfile.mkdtemp(dir=os.path.dirname(path), prefix=".tmp-")
    try:
        torch.save(d, os.path.join(td, _STATE_FILE))
        with open(_meta_path(directory, step), "w") as fh:
            json.dump({"package": PACKAGE, "format_version": FORMAT_VERSION,
                       "step": step, "keys": [k for k, _ in pairs],
                       "mesh": list(mesh), "rank": rank}, fh)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(td, path)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The largest step with a complete entry under ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".meta.json"):
            try:
                step = int(name[5:])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(directory, name, _STATE_FILE)):
                steps.append(step)
    return max(steps) if steps else None


def rank_dir(directory: str, rank: int) -> str:
    """Where rank ``rank`` of a sharded run keeps its part."""
    return os.path.join(directory, f"rank_{rank}")


def saved_mesh(directory: str) -> Optional[Tuple[int, int]]:
    """The mesh shape (C, D) of the run that saved under ``directory``: of
    its latest step, or of rank 0's part; None when nothing is saved
    there.  Checkpoints of older versions, without the key, are
    unsharded."""
    for d in (directory, rank_dir(directory, 0)):
        step = latest_step(d)
        if step is None:
            continue
        try:
            with open(_meta_path(d, step)) as fh:
                return tuple(json.load(fh).get("mesh", (1, 1)))
        except (OSError, ValueError):
            return (1, 1)
    return None


def restore_checkpoint(directory: str, step: int, template: Any) -> Any:
    """Restore the payload saved at ``step``, shaped like ``template``: each
    stored tensor goes to its template leaf's device and must match its
    dtype and shape; leaves the checkpoint does not hold (zero-size,
    ``None``) are the template's own."""
    path = _ckpt_path(directory, step)
    try:
        with open(_meta_path(directory, step)) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        meta = {}
    if meta.get("package") != PACKAGE:
        raise ValueError(f"{path} is not a checkpoint of {PACKAGE} (no "
                         "meta file of this package beside it)")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: format version "
                         f"{meta.get('format_version')}, this package "
                         f"reads {FORMAT_VERSION}")
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                       weights_only=True)
    leaves = {}
    for k, t in _flatten(template):
        if k not in saved:
            leaves[k] = t
            continue
        x = saved[k]
        if isinstance(t, torch.Tensor):
            if x.dtype != t.dtype or tuple(x.shape) != tuple(t.shape):
                raise ValueError(
                    f"{path}: {k} is {x.dtype}{tuple(x.shape)}, the run "
                    f"expects {t.dtype}{tuple(t.shape)}")
            leaves[k] = x.to(t.device)
        else:
            leaves[k] = [int(v) for v in x.tolist()]
    return _unflatten(template, leaves)
