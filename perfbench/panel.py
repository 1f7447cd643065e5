"""A cell's genotype panel, made on the device from the run's seed.

The generative model is that of the program's synthetic panels (mode 2:
admixture with partial selfing): per (pop, locus) P ~ Dirichlet(1, 1);
per individual Q ~ Dirichlet(alpha), selfing generations g ~ Geometric(1 -
Q.S) capped at ``gen_cap``; per locus each copy's pop ~ Cat(Q) and its
allele ~ Bernoulli(P); with probability 1 - 2^(1 - g) the two copies
collapse onto one of them (each with probability 1/2); then a share of
the sites goes missing.  The draws come from one ``torch.Generator`` on
the device, in blocks of rows, so one seed gives the same panel bit for
bit.  The result is the packed site plane int8[N, L]: bit 0 copy 0's
allele, bit 1 copy 1's, bit 2 set where the site is observed and the locus
polymorphic; missing sites carry allele 0.
"""

from __future__ import annotations

import torch

ROWS = 64          # individuals drawn at a time


def make_panel(cfg: dict, seed: int, device) -> torch.Tensor:
    n, l = cfg["n_indv"], cfg["n_loci"]
    a = cfg["assumed"]
    k = a["n_pops"]
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    f64 = dict(dtype=torch.float64, device=dev)
    p1 = torch.rand((k, l), generator=g, device=dev)       # P(allele 1)
    qg = torch._standard_gamma(torch.full((n, k), a["admixture_alpha"],
                                          **f64), generator=g)
    q = qg / torch.clamp_min(qg.sum(-1, keepdim=True), 1e-300)
    cum = torch.cumsum(q, dim=-1)
    cum[:, -1] = 1.0
    sbar = q @ torch.tensor(a["selfing_rates"], **f64)
    u = torch.rand(n, generator=g, **f64)
    gen = torch.where(sbar > 0, 1.0 + torch.floor(torch.log(u) / torch.log(
        torch.clamp(sbar, 1e-300, 1.0 - 1e-12))), torch.ones_like(sbar))
    gen = torch.clamp(gen, 1, a["gen_cap"])
    keep_het = torch.exp2(1.0 - gen).to(torch.float32)

    bits2 = torch.empty((n, l), dtype=torch.int8, device=dev)
    ones = torch.zeros(l, dtype=torch.int64, device=dev)
    copies = torch.zeros(l, dtype=torch.int64, device=dev)
    loc = torch.arange(l, device=dev)
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        b = r1 - r0
        uz = torch.rand((b, 2 * l), generator=g, device=dev)
        z = torch.searchsorted(cum[r0:r1].to(torch.float32).contiguous(), uz,
                               right=True).clamp_max(k - 1)
        z = z.reshape(b, 2, l)
        p = p1.reshape(-1)[z * l + loc]
        allele = (torch.rand((b, 2, l), generator=g, device=dev)
                  < p).to(torch.int64)
        collapse = (torch.rand((b, l), generator=g, device=dev)
                    >= keep_het[r0:r1, None])
        pick = torch.rand((b, l), generator=g, device=dev) < 0.5
        a0 = torch.where(collapse & pick, allele[:, 1], allele[:, 0])
        a1 = torch.where(collapse, a0, allele[:, 1])
        seen = torch.rand((b, l), generator=g, device=dev) >= a["missing_rate"]
        a0, a1 = a0 * seen, a1 * seen
        ones += (a0 + a1).sum(0)
        copies += 2 * seen.sum(0)
        bits2[r0:r1] = (a0 | (a1 << 1) | (seen.to(torch.int64) << 2)).to(
            torch.int8)
    poly = (ones > 0) & (ones < copies)
    return torch.where(poly[None], bits2, bits2 & 3)
