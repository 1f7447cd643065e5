"""The loci layout of a loci-sharded run.

Counterpart of ``instruct_tpu/parallel/loci_shard.py``, on numpy and torch:
``pad_loci`` (:41 there), ``stack_loci`` (:62), ``tetra_shard_plan``
(:92), ``_shard_class_counts`` (:116), ``stack_loci_tetra`` (:137),
``local_view`` (:193), ``unblock_sites`` (:207) and ``block_sites``
(:220).

The model is conditionally independent across loci given (Z, Q, P), so
the loci axis L splits into blocks, one a rank, each a self-contained
local panel in the standard copy-major layout.  A diploid panel is padded
to a multiple of the shard count (padding loci are invalid everywhere, so
they add nothing) and split contiguously.  A tetraploid panel is dealt by
the class-uniform plan of :func:`tetra_shard_plan`: the loci sorted by
allele count, each class padded to a multiple of the shard count and dealt
in contiguous chunks, so that every shard holds the same classes in the
same columns.

The JAX package stacks every block on a leading shard axis for
``shard_map``; a rank of the port holds only its own block
(:func:`shard_panel`), and :func:`loci_plan` / :func:`gather_loci` put the
blocks' per-locus tensors back into the input panel's loci order, padding
dropped -- for the tetraploid plan too (the JAX package leaves a sharded
tetraploid run's P in the plan's permuted order).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from instruct_tpu_torch.data.dataset import Dataset


def pad_loci(data: Dataset, n_shards: int) -> Dataset:
    """Pad the loci axis so L % n_shards == 0; padded loci are invalid.
    Diploid panels only: a tetraploid panel goes through
    :func:`stack_loci_tetra` (its ``distinct`` planes have no padding
    here)."""
    if data.distinct is not None or data.ploid != 2:
        raise ValueError("pad_loci pads diploid panels; a tetraploid panel "
                         "is dealt by tetra_shard_plan / stack_loci_tetra")
    l = data.n_loci
    pad = -l % n_shards
    if pad == 0:
        return data
    n, p = data.n_indv, data.ploid

    def pad_l(x):          # [N, L] -> [N, L + pad]
        return torch.nn.functional.pad(x, (0, pad))

    geno3 = data.geno.reshape(n, p, l)
    return Dataset(
        geno=torch.nn.functional.pad(geno3, (0, pad)).reshape(
            n, p * (l + pad)),
        site_valid=pad_l(data.site_valid),
        allele_valid=torch.nn.functional.pad(data.allele_valid,
                                             (0, 0, 0, pad)),
        hom=pad_l(data.hom),
        bits2=None if data.bits2 is None else pad_l(data.bits2))


def _diploid_block(data: Dataset, lo: int, hi: int) -> Dataset:
    """Loci [lo, hi) of a (padded) diploid panel as a local panel."""
    n, l, p = data.n_indv, data.n_loci, data.ploid
    return Dataset(
        geno=data.geno.reshape(n, p, l)[:, :, lo:hi].reshape(n, -1),
        site_valid=data.site_valid[:, lo:hi],
        allele_valid=data.allele_valid[lo:hi],
        hom=data.hom[:, lo:hi],
        bits2=None if data.bits2 is None else data.bits2[:, lo:hi])


def stack_loci(data: Dataset, n_shards: int) -> Dataset:
    """The (padded) panel split into ``n_shards`` contiguous loci blocks
    stacked on a new leading axis; tetraploid panels (``distinct``
    present) take the class-uniform layout of :func:`stack_loci_tetra`."""
    if data.distinct is not None:
        return stack_loci_tetra(data, n_shards)
    data = pad_loci(data, n_shards)
    ll = data.n_loci // n_shards
    blocks = [_diploid_block(data, s * ll, (s + 1) * ll)
              for s in range(n_shards)]
    return Dataset(*[None if x[0] is None else torch.stack(list(x))
                     for x in zip(*blocks)])


def tetra_shard_plan(data: Dataset, n_shards: int) -> np.ndarray:
    """src i64[n_shards, L_loc]: the input locus of each shard-local column
    (-1 = a padding locus) under the class-uniform layout: loci sorted by
    allele count, each class padded to a multiple of ``n_shards`` and dealt
    in contiguous chunks, so class c holds the same local columns on every
    shard."""
    n_all = data.allele_valid.sum(-1).cpu().numpy().astype(np.int64)
    shard_src = [[] for _ in range(n_shards)]
    for v in sorted(set(n_all.tolist())):
        idx = np.nonzero(n_all == v)[0]
        m = -(-len(idx) // n_shards)
        padded = np.concatenate(
            [idx, np.full(m * n_shards - len(idx), -1, np.int64)])
        for s in range(n_shards):
            shard_src[s].extend(padded[s * m:(s + 1) * m].tolist())
    return np.asarray(shard_src, np.int64)


def _shard_class_counts(data: Dataset, src: np.ndarray) -> np.ndarray:
    """cnt i64[n_shards, L_loc]: the allele count of each local column's
    class, the same on every shard, padding columns included (they take
    their class's count, read off the shards that hold a real locus in
    that column)."""
    n_all = data.allele_valid.sum(-1).cpu().numpy().astype(np.int64)
    n_shards, ll = src.shape
    cnt = np.empty((n_shards, ll), np.int64)
    real = src >= 0
    cnt[real] = n_all[src[real]]
    col_class = cnt.copy()
    col_class[~real] = -1
    col_fill = col_class.max(axis=0)
    for s in range(n_shards):
        cnt[s, ~real[s]] = col_fill[~real[s]]
    return cnt


def _tetra_block(data: Dataset, cols: np.ndarray,
                 cls_cnt: np.ndarray) -> Dataset:
    """The tetraploid local panel of plan row ``cols`` (padding loci: no
    valid site, one distinct allele, their class's allele count)."""
    n, a, l = data.n_indv, data.max_alleles, data.n_loci
    safe = torch.as_tensor(np.where(cols >= 0, cols, 0))
    pad = torch.as_tensor(cols < 0)

    def take3(x, fill):     # [N, 4L] -> [N, 4 L_loc]
        x = x.reshape(n, 4, l)[:, :, safe]
        return torch.where(pad, torch.full_like(x, fill), x).reshape(n, -1)

    def take2(x, fill):     # [N, L] -> [N, L_loc]
        x = x[:, safe]
        return torch.where(pad, torch.full_like(x, fill), x)

    return Dataset(
        geno=take3(data.geno, 0),
        site_valid=take2(data.site_valid, False),
        allele_valid=torch.as_tensor(np.arange(a)[None, :]
                                     < cls_cnt[:, None]),
        hom=take2(data.hom, True),
        distinct=take3(data.distinct, 0),
        n_distinct=take2(data.n_distinct, 1))


def stack_loci_tetra(data: Dataset, n_shards: int) -> Dataset:
    """Tetraploid counterpart of :func:`stack_loci`: the local panels of
    :func:`tetra_shard_plan`, stacked on a leading shard axis.  The loci
    are permuted: per-locus results go back through :func:`gather_loci`."""
    data = data.to("cpu")
    src = tetra_shard_plan(data, n_shards)
    cls_cnt = _shard_class_counts(data, src)
    blocks = [_tetra_block(data, src[s], cls_cnt[s])
              for s in range(n_shards)]
    return Dataset(*[None if x[0] is None else torch.stack(list(x))
                     for x in zip(*blocks)])


def local_view(stacked: Dataset, shard: int = 0) -> Dataset:
    """Shard ``shard``'s panel of a stacked panel."""
    return Dataset(*[None if x is None else x[shard] for x in stacked])


def loci_plan(data: Dataset, n_shards: int) -> np.ndarray:
    """src i64[n_shards, L_loc]: the input locus of each shard's local
    columns, -1 for padding -- contiguous blocks of the padded panel
    (diploid) or :func:`tetra_shard_plan` (tetraploid)."""
    if data.distinct is not None:
        return tetra_shard_plan(data, n_shards)
    l = data.n_loci
    ll = -(-l // n_shards)
    src = np.arange(n_shards * ll, dtype=np.int64)
    src[src >= l] = -1
    return src.reshape(n_shards, ll)


def shard_panel(data: Dataset, mesh) -> Dataset:
    """This rank's local panel on ``mesh.device``: shard
    ``mesh.data_index`` of :func:`loci_plan`, the whole panel when the
    loci are whole.  The rank never builds the other shards' blocks."""
    d = mesh.n_data_shards
    if d == 1:
        return data.to(mesh.device)
    s = mesh.data_index
    data = data.to("cpu")
    if data.distinct is not None:
        src = tetra_shard_plan(data, d)
        block = _tetra_block(data, src[s], _shard_class_counts(data, src)[s])
    else:
        data = pad_loci(data, d)
        ll = data.n_loci // d
        block = _diploid_block(data, s * ll, (s + 1) * ll)
    return Dataset(*[None if x is None else x.contiguous()
                     for x in block]).to(mesh.device)


def inverse_plan(src: np.ndarray, n_loci: int) -> np.ndarray:
    """i64[L]: the position of each input locus in the shard-major
    concatenation of the plan's columns (the inverse of ``src``)."""
    flat = src.reshape(-1)
    inv = np.full(n_loci, -1, np.int64)
    real = flat >= 0
    inv[flat[real]] = np.nonzero(real)[0]
    if (inv < 0).any():
        raise ValueError("the plan does not hold every locus")
    return inv


def gather_loci(parts: Sequence, src: np.ndarray, axis: int):
    """The shards' per-locus tensors (``parts[s]`` with shard s's local
    loci on ``axis``) as one tensor over the input's loci in their order,
    padding dropped."""
    x = torch.cat([torch.as_tensor(p) for p in parts], dim=axis)
    inv = torch.as_tensor(inverse_plan(src, int((src >= 0).sum())),
                          device=x.device)
    return x.index_select(axis, inv)


def gather_sites(parts: Sequence, src: np.ndarray, ploid: int):
    """:func:`gather_loci` for copy-major site tensors [..., ploid *
    L_loc]: the result is [..., ploid * L] in the input's order."""
    split = [torch.as_tensor(p) for p in parts]
    split = [p.reshape(*p.shape[:-1], ploid, -1) for p in split]
    x = gather_loci(split, src, axis=split[0].dim() - 1)
    return x.reshape(*x.shape[:-2], -1)


def unblock_sites(x, n_shards: int, ploid: int) -> np.ndarray:
    """Blocked-global site tensor [..., n_shards * ploid * L_loc] (the
    shard-major concatenation of the local copy-major blocks) -> standard
    copy-major [..., ploid * L] with L = n_shards * L_loc."""
    x = np.asarray(x)
    lead = x.shape[:-1]
    ll = x.shape[-1] // (n_shards * ploid)
    x = x.reshape(*lead, n_shards, ploid, ll)
    order = tuple(range(len(lead)))
    x = x.transpose(*order, len(lead) + 1, len(lead), len(lead) + 2)
    return x.reshape(*lead, ploid * n_shards * ll)


def block_sites(x, n_shards: int, ploid: int) -> np.ndarray:
    """Inverse of :func:`unblock_sites`."""
    x = np.asarray(x)
    lead = x.shape[:-1]
    ll = x.shape[-1] // (n_shards * ploid)
    x = x.reshape(*lead, ploid, n_shards, ll)
    order = tuple(range(len(lead)))
    x = x.transpose(*order, len(lead) + 1, len(lead), len(lead) + 2)
    return x.reshape(*lead, ploid * n_shards * ll)
