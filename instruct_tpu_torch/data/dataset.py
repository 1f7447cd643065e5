"""Genotype panel representation as torch tensors.

Counterpart of ``instruct_tpu/data/dataset.py``.  The layout is kept so the
two packages can be compared tensor by tensor: allele copies are stored
flat, S = L * ploid with site index s = copy * L + l (copy-major: each
copy's [N, L] plane is a contiguous column slice).

  * ``geno``         int8[N, S]  allele codes in [0, A); 0 where missing.
  * ``site_valid``   bool[N, L]  observed AND polymorphic locus
                     (`missindx[i][j]!=1 && allelenum[j]>1`, mcmc.c:817).
  * ``allele_valid`` bool[L, A]  per-locus padding mask over alleles.
  * ``hom``          bool[N, L]  all copies identical (chcksame,
                     mcmc.c:1658-1667).
  * ``bits2``        int8[N, L]  diploid-biallelic only: the whole site in
                     one byte (bit0 = copy-0 allele, bit1 = copy-1 allele,
                     bit2 = site_valid; hom is bit0 == bit1).  The site
                     kernels read this single plane.
  * ``distinct``     int32[N, 4L] tetraploid only: the sorted distinct
                     alleles observed at each site, copy-major like ``geno``
                     (unused slots 0), ``n_distinct`` int32[N, L] their number
                     (0 where missing); the latent-genotype move routes them
                     through its candidate orderings (``tetra/engine.py``).

The panel tensors carry no chain axis: every chain reads the same panel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Dataset(NamedTuple):
    """The panel tensors (all on one device)."""

    geno: torch.Tensor          # int8[N, S], S = L * ploid
    site_valid: torch.Tensor    # bool[N, L]
    allele_valid: torch.Tensor  # bool[L, A]
    hom: torch.Tensor           # bool[N, L]
    distinct: Optional[torch.Tensor] = None
    n_distinct: Optional[torch.Tensor] = None
    bits2: Optional[torch.Tensor] = None        # int8[N, L] (diploid A=2)

    @property
    def n_indv(self) -> int:
        return self.site_valid.shape[0]

    @property
    def n_loci(self) -> int:
        return self.site_valid.shape[1]

    @property
    def ploid(self) -> int:
        return self.geno.shape[-1] // self.site_valid.shape[1]

    @property
    def max_alleles(self) -> int:
        return self.allele_valid.shape[1]

    @property
    def geno3(self) -> np.ndarray:
        """Host-side [N, L, ploid] view for tests/reporting."""
        n = self.geno.shape[0]
        return (self.geno.cpu().numpy().reshape(n, self.ploid, self.n_loci)
                .transpose(0, 2, 1))

    def to(self, device) -> "Dataset":
        """The same panel with every tensor on ``device``."""
        return Dataset(*[None if t is None else t.to(device) for t in self])


def make_dataset(geno: np.ndarray, missing: np.ndarray,
                 n_alleles: Optional[np.ndarray] = None,
                 distinct: Optional[np.ndarray] = None,
                 n_distinct: Optional[np.ndarray] = None,
                 device="cpu") -> Dataset:
    """Build a :class:`Dataset` from host arrays.

    ``geno`` int[N, L, ploid] with allele codes (missing entries arbitrary),
    ``missing`` bool[N, L] marks loci unobserved for an individual (any copy
    missing drops the whole site, as in get_missing,
    data_interface.c:826-833).  A tetraploid panel also passes ``distinct``
    int[N, L, 4] and ``n_distinct`` int[N, L].  The panel is built on the
    host and placed on ``device``; `run_mcmc` moves it to its own device
    anyway.
    """
    geno = np.asarray(geno, dtype=np.int32)
    missing = np.asarray(missing, dtype=bool)
    n, l, p = geno.shape
    geno = np.where(missing[:, :, None], 0, geno)
    if n_alleles is None:
        n_alleles = np.zeros(l, dtype=np.int32)
        for j in range(l):
            obs = geno[:, j][~missing[:, j]]
            n_alleles[j] = int(obs.max()) + 1 if obs.size else 0
    n_alleles = np.asarray(n_alleles, dtype=np.int32)
    a_max = max(int(n_alleles.max()), 2)
    allele_valid = np.arange(a_max)[None, :] < n_alleles[:, None]
    # Monomorphic / empty loci contribute nothing (mcmc.c:817: allelenum>1).
    site_valid = (~missing) & (n_alleles > 1)[None, :]
    hom = np.all(geno == geno[:, :, :1], axis=2)
    if a_max > 127:
        raise ValueError(f"more than 127 alleles at one locus ({a_max}); "
                         "the int8 genotype layout caps A at 127")
    bits2 = None
    if p == 2 and a_max == 2:
        bits2 = torch.from_numpy((geno[:, :, 0] | (geno[:, :, 1] << 1)
                                  | (site_valid.astype(np.int32) << 2))
                                 .astype(np.int8))
    return Dataset(
        geno=torch.from_numpy(np.ascontiguousarray(
            geno.transpose(0, 2, 1).reshape(n, p * l).astype(np.int8))),
        site_valid=torch.from_numpy(site_valid),
        allele_valid=torch.from_numpy(allele_valid),
        hom=torch.from_numpy(hom),
        distinct=(None if distinct is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(distinct, np.int32)
                                 .transpose(0, 2, 1).reshape(n, -1)))),
        n_distinct=(None if n_distinct is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(n_distinct, np.int32)))),
        bits2=bits2,
    ).to(device)


def packed_dataset(bits2: torch.Tensor) -> Dataset:
    """The diploid-biallelic :class:`Dataset` that a packed site plane
    int8[N, L] stands for (every locus with both alleles valid), on the
    plane's device."""
    si = bits2.to(torch.int64)
    g0, g1 = si & 1, (si >> 1) & 1
    return Dataset(
        geno=torch.cat([g0, g1], dim=1).to(torch.int8),
        site_valid=(si & 4) != 0,
        allele_valid=torch.ones((bits2.shape[1], 2), dtype=torch.bool,
                                device=bits2.device),
        hom=g0 == g1, bits2=bits2)


@dataclasses.dataclass
class Panel:
    """Host-side panel: the Dataset plus human metadata (individual labels,
    pre-defined population index/names, marker names, allele-type string
    tables used by the report writer)."""

    data: Dataset
    indv_names: Optional[Sequence[str]] = None
    pop_index: Optional[np.ndarray] = None      # int[N] pre-defined pop
    pop_names: Optional[Sequence[str]] = None
    marker_names: Optional[Sequence[str]] = None
    allele_names: Optional[Sequence[Sequence[str]]] = None  # per locus
    n_alleles: Optional[np.ndarray] = None

    @property
    def n_indv(self) -> int:
        return self.data.n_indv

    @property
    def n_loci(self) -> int:
        return self.data.n_loci

    @property
    def missing_per_indv(self) -> np.ndarray:
        """`missvec` (data_interface.c:819-834): # missing loci per indiv."""
        return (~self.data.site_valid).sum(1).cpu().numpy().astype(np.int64)

    @property
    def n_predefined_pops(self) -> int:
        if self.pop_index is None:
            return 1
        return int(np.max(self.pop_index)) + 1
