"""Synthetic genotype panels for tests and benchmarks.

Counterpart of ``instruct_tpu/data/synthetic.py``: the same numpy generator,
draw for draw, so a seed gives the same panel in both packages.  Data comes
from the generative model itself (admixture + partial selfing), so posterior
checks have a known ground truth.  :func:`synthetic_tetra_panel` draws from
the same model as its JAX counterpart, vectorised (one inverse-CDF draw for
all individuals at once), so its panel is not the JAX generator's draw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from instruct_tpu_torch.data.dataset import Panel, make_dataset
from instruct_tpu_torch.tetra.combinatorics import build_class_tables


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


def synthetic_tetra_panel(
    n_indv: int = 50,
    n_loci: int = 40,
    n_pops: int = 2,
    n_alleles: int = 2,
    autopoly: bool = True,
    selfing_rates: Optional[np.ndarray] = None,
    admixture_alpha: float = 0.1,
    missing_rate: float = 0.0,
    seed: int = 0,
) -> Panel:
    """Tetraploid panel drawn from the engine's own generative model: each
    individual's dominant pop contributes an ordered genotype drawn from the
    *selfing-equilibrium* class distribution (I - sA)P = (1-s)R, and the
    observation is the set of distinct alleles (transform_data2 semantics,
    data_interface.c:571-669).

    Vectorised: the class probabilities of every (pop, locus) come from one
    batched solve, and every individual's class at every locus from one
    inverse-CDF draw against them (64 individuals at a time, to bound the
    [64, L, G] comparison)."""
    rng = np.random.default_rng(seed)
    if selfing_rates is None:
        selfing_rates = np.linspace(0.1, 0.8, n_pops)
    s = np.asarray(selfing_rates, np.float64).reshape(n_pops)
    freq = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    freq2 = rng.dirichlet(np.ones(n_alleles), size=(n_pops, n_loci))
    q = rng.dirichlet(np.full(n_pops, admixture_alpha), size=n_indv)
    # each individual's dominant pop, by inverse CDF over its q row
    cq = np.cumsum(q, axis=1)
    pop = np.minimum((rng.random((n_indv, 1)) > cq).sum(axis=1), n_pops - 1)

    ct = build_class_tables(np.full(n_loci, n_alleles, np.int32), autopoly)
    g = int(ct.g_count[0])
    digits = ct.digits[0, :g]                                 # [G, 4]
    a_mat = ct.self_mat[0, :g, :g].astype(np.float64)
    # HWE class probabilities R [K, L, G]: multiplicity x slot frequencies
    logr = np.broadcast_to(ct.log_mult[0, :g].astype(np.float64),
                           (n_pops, n_loci, g)).copy()
    for slot in range(4):
        f = freq if (autopoly or slot < 2) else freq2
        logr += np.log(f[:, :, digits[:, slot]])
    mats = np.eye(g)[None] - s[:, None, None] * a_mat[None]   # [K, G, G]
    p_cls = (1.0 - s)[:, None, None] * np.linalg.solve(
        mats, np.exp(logr).transpose(0, 2, 1)).transpose(0, 2, 1)
    p_cls = np.maximum(p_cls, 0.0)
    cum = np.cumsum(p_cls / p_cls.sum(-1, keepdims=True), axis=-1)

    u = rng.random((n_indv, n_loci))
    cls = np.empty((n_indv, n_loci), np.int64)
    for i0 in range(0, n_indv, 64):
        rows = slice(i0, i0 + 64)
        cls[rows] = (u[rows, :, None] > cum[pop[rows]]).sum(axis=-1)
    cls = np.minimum(cls, g - 1)
    # the distinct alleles of each class, sorted, padded with 0
    dist_tab = np.zeros((g, 4), np.int32)
    n_tab = np.zeros(g, np.int32)
    for gi in range(g):
        alleles = sorted(set(int(x) for x in digits[gi]))
        n_tab[gi] = len(alleles)
        dist_tab[gi, :len(alleles)] = alleles
    distinct = dist_tab[cls]                                  # [N, L, 4]
    n_distinct = n_tab[cls]
    miss = rng.random((n_indv, n_loci)) < missing_rate
    n_distinct = np.where(miss, 0, n_distinct)
    data = make_dataset(distinct, miss, np.full(n_loci, n_alleles, np.int32),
                        distinct=distinct, n_distinct=n_distinct)
    return Panel(data=data,
                 indv_names=[f"ind{i}" for i in range(n_indv)],
                 pop_index=pop,
                 pop_names=[f"pop{k}" for k in range(n_pops)],
                 n_alleles=np.full(n_loci, n_alleles, np.int32))
