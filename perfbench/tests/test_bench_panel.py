"""The panel generator: the configured shapes, bitwise repeatable for one
seed, different for another."""

import torch

from perfbench import panel

CFG = {"n_indv": 70, "n_loci": 500,
       "assumed": {"n_pops": 3, "selfing_rates": [0.1, 0.5, 0.95],
                   "admixture_alpha": 0.1, "missing_rate": 0.05,
                   "gen_cap": 50}}


def test_shape_and_bits():
    b = panel.make_panel(CFG, 2 ** 31 + 5, "cpu")
    assert b.shape == (70, 500) and b.dtype == torch.int8
    s = b.to(torch.int64)
    assert int(s.min()) >= 0 and int(s.max()) <= 7
    missing = (s & 4) == 0
    assert 0.02 < float(missing.float().mean()) < 0.2
    # a site is valid only where observed on a polymorphic locus; a missing
    # site carries allele 0 unless its locus is monomorphic (its bits then
    # stay as drawn, the valid bit cleared)
    poly_any = ((s & 4) != 0).any(0)
    assert bool(((s & 3)[missing & poly_any[None]] == 0).all())
    ones = ((s & 1) + ((s >> 1) & 1)) * ((s & 4) != 0)
    poly = ((s & 4) != 0).any(0)
    assert bool((ones.sum(0)[poly] > 0).all())


def test_repeatable():
    a = panel.make_panel(CFG, 123456789123, "cpu")
    b = panel.make_panel(CFG, 123456789123, "cpu")
    c = panel.make_panel(CFG, 123456789124, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_selfing_shows():
    cfg = dict(CFG, assumed=dict(CFG["assumed"], missing_rate=0.0,
                                 selfing_rates=[0.0, 0.0, 0.0]))
    out = panel.make_panel(cfg, 9, "cpu").to(torch.int64)
    selfer = dict(CFG, assumed=dict(cfg["assumed"],
                                    selfing_rates=[0.99, 0.99, 0.99]))
    inb = panel.make_panel(selfer, 9, "cpu").to(torch.int64)

    def het(s):
        return float((((s & 1) != ((s >> 1) & 1)) & ((s & 4) != 0))
                     .float().mean())

    assert het(inb) < 0.5 * het(out)
