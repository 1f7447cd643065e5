"""Carry a panel, a sampler state or the gradient samplers' parameters
across from the JAX package.

The port imports nothing of ``instruct_tpu``, so a JAX ``Dataset`` or
``McmcState`` (or ``MarginalParams``) is handed over as a dict of numpy
arrays keyed by field name
(``{name: np.asarray(value) for name, value in obj._asdict().items()}``).
The tests use this to let both packages compute on the same numbers.
:func:`state_from_sharded` carries the final state of a JAX run on a mesh
whose loci were split (blocked z, padded P, the tetraploid plan's
permuted loci) into the port's unsharded layout.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.mcmc.state import McmcState
from instruct_tpu_torch.samplers.potential import MarginalParams

# one chain's rank of every state field (the JAX package's layout)
_STATE_RANK = dict(freq=3, z=2, zz=1, q=2, alpha=0, rates=1, ais_state=1,
                   gen=1, loglik_indv=1, loglik_total=0, dpm_values=1,
                   dpm_counts=1, dpm_assign=1, prior_mu=0, prior_sigma2=0,
                   freq2=3, geno=2, zcounts=3, loglik_marg=1, active=1)
_STATE_DTYPE = dict(z=torch.int8, zz=torch.int32, ais_state=torch.int32,
                    gen=torch.int32, dpm_counts=torch.int32,
                    dpm_assign=torch.int32, geno=torch.int8)


def dataset_from_numpy(fields: Mapping[str, np.ndarray],
                       device="cpu") -> Dataset:
    """A :class:`Dataset` from the JAX ``Dataset``'s fields as numpy
    arrays (absent or ``None`` optional fields stay ``None``)."""
    def get(name, dtype):
        v = fields.get(name)
        if v is None:
            return None
        return torch.from_numpy(np.array(v)).to(dtype).to(device)
    return Dataset(geno=get("geno", torch.int8),
                   site_valid=get("site_valid", torch.bool),
                   allele_valid=get("allele_valid", torch.bool),
                   hom=get("hom", torch.bool),
                   distinct=get("distinct", torch.int32),
                   n_distinct=get("n_distinct", torch.int32),
                   bits2=get("bits2", torch.int8))


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cuda") -> McmcState:
    """A :class:`McmcState` from the JAX ``McmcState``'s fields as numpy
    arrays: one chain (a chain axis of length 1 is added) or several
    chains stacked on a leading axis, told apart by the rank of ``q``."""
    stacked = np.asarray(fields["q"]).ndim == _STATE_RANK["q"] + 1
    out = {}
    for name in McmcState._fields:
        v = fields.get(name)
        if v is None:
            out[name] = None
            continue
        v = np.array(v)
        if not stacked:
            v = v[None]
        if v.ndim != _STATE_RANK[name] + 1:
            raise ValueError(f"state field {name}: unexpected shape "
                             f"{v.shape}")
        t = torch.from_numpy(v)
        dtype = _STATE_DTYPE.get(name, torch.float32)
        out[name] = t.to(dtype).to(device).contiguous()
    return McmcState(**out)


def state_from_sharded(fields: Mapping[str, np.ndarray], data: Dataset,
                       n_data_shards: int, device="cuda") -> McmcState:
    """:func:`state_from_numpy` of the JAX package's loci-sharded final
    state (chains stacked): its site tensors (z, geno) are the shards'
    copy-major blocks side by side (``loci_shard.py:unblock_sites``'s
    "blocked" layout) and its per-locus tensors (freq, freq2, zcounts) the
    shards' loci side by side, padding included, in the plan of
    ``parallel/loci_shard.py:loci_plan`` for ``data`` (the port's panel).
    Returns the state over the panel's loci in their order."""
    from instruct_tpu_torch.parallel import loci_shard as ls
    src = ls.loci_plan(data, n_data_shards)
    d, p = n_data_shards, data.ploid
    out = dict(fields)
    for name in ("freq", "freq2", "zcounts"):
        v = fields.get(name)
        if v is not None and np.asarray(v).ndim == 4:
            parts = np.split(np.array(v), d, axis=2)
            out[name] = ls.gather_loci(parts, src, axis=2).numpy()
    for name in ("z", "geno"):
        v = fields.get(name)
        if v is not None and np.asarray(v).size:
            parts = np.split(np.array(v), d, axis=-1)
            out[name] = ls.gather_sites(parts, src, p).numpy()
    return state_from_numpy(out, device=device)


def state_to_numpy(state: McmcState) -> dict:
    """The state's fields as numpy arrays, chain axis leading."""
    return {name: None if t is None else t.detach().cpu().numpy()
            for name, t in state._asdict().items()}


def marginal_params_from_numpy(fields, device="cpu"):
    """The samplers' :class:`MarginalParams` from the JAX package's
    ``MarginalParams`` as numpy arrays (a mapping by field name, or the
    tuple in field order): one position (a batch axis of length 1 is
    added) or several stacked on a leading axis, told apart by the rank of
    ``phi_q``."""
    if not isinstance(fields, Mapping):
        fields = dict(zip(MarginalParams._fields, fields))
    stacked = np.asarray(fields["phi_q"]).ndim == 3
    out = []
    for name in MarginalParams._fields:
        v = np.array(fields[name], dtype=np.float32)
        out.append(torch.from_numpy(v if stacked else v[None]).to(device))
    return MarginalParams(*out)
