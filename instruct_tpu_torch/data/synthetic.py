"""Synthetic genotype panels for tests and benchmarks.

Counterpart of ``instruct_tpu/data/synthetic.py``: the same numpy generator,
draw for draw, so a seed gives the same panel in both packages.  Data comes
from the generative model itself (admixture + partial selfing), so posterior
checks have a known ground truth.  The tetraploid generator waits for the
tetraploid engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from instruct_tpu_torch.data.dataset import Panel, make_dataset


def synthetic_panel(
    n_indv: int = 100,
    n_loci: int = 100,
    n_pops: int = 2,
    n_alleles: int = 2,
    ploid: int = 2,
    selfing_rates: Optional[np.ndarray] = None,
    admixture_alpha: float = 0.2,
    missing_rate: float = 0.0,
    seed: int = 0,
) -> Panel:
    """Draw a panel from the mode-2 generative model.

    For each subpop k and locus l: p_kl ~ Dirichlet(1,...,1).
    For each individual: q_i ~ Dirichlet(alpha), selfing generations
    g_i ~ Geometric(1 - qbar_i @ S) capped at 50 (mcmc.c:196-199), then each
    locus draws z-copies ~ Cat(q_i) and alleles; with probability controlled
    by g_i the two copies coalesce into a homozygote, matching the
    partial-selfing genotype frequencies of genofreq() (mcmc.c:1683-1703).
    """
    rng = np.random.default_rng(seed)
    if selfing_rates is None:
        selfing_rates = np.linspace(0.1, 0.8, n_pops)
    selfing_rates = np.asarray(selfing_rates, dtype=np.float64)

    freq = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    q = rng.dirichlet(np.full(n_pops, admixture_alpha), size=n_indv)
    sbar = q @ selfing_rates
    gen = np.minimum(rng.geometric(np.clip(1.0 - sbar, 1e-9, 1.0)), 50)

    geno = np.zeros((n_indv, n_loci, ploid), dtype=np.int32)
    for i in range(n_indv):
        z = rng.choice(n_pops, size=(n_loci, ploid), p=q[i])
        a = np.zeros((n_loci, ploid), dtype=np.int64)
        for c in range(ploid):
            pf = freq[z[:, c], np.arange(n_loci)]
            cum = pf.cumsum(axis=1)
            u = rng.random(n_loci)[:, None]
            a[:, c] = (u > cum).sum(axis=1)
        if ploid == 2:
            # With g generations of selfing, a heterozygote survives with
            # probability 2^{1-g}; otherwise it collapses to one of its
            # alleles (each with prob 1/2) — the stationary intuition behind
            # genofreq() (mcmc.c:1683-1703).
            p_het_survive = 0.5 ** (gen[i] - 1)
            collapse = rng.random(n_loci) > p_het_survive
            pick = rng.integers(0, 2, n_loci)
            a[collapse, 0] = a[collapse, pick[collapse]]
            a[collapse, 1] = a[collapse, 0]
        geno[i] = a
    missing = rng.random((n_indv, n_loci)) < missing_rate
    data = make_dataset(geno, missing, np.full(n_loci, n_alleles, np.int32))
    return Panel(
        data=data,
        indv_names=[f"ind{i}" for i in range(n_indv)],
        pop_index=np.argmax(q, axis=1),
        pop_names=[f"pop{k}" for k in range(n_pops)],
        n_alleles=np.full(n_loci, n_alleles, np.int32),
    )
