"""The launch plan and the class map of K6 ``s_delta_pass`` and K7
``site_ll_pass`` (``instruct_tpu_torch/kernels/tetra_geno.py``), on the CPU.

The plan (``sums_plan``) is pure arithmetic: it must fit the card's shared
memory and grid and cover every locus and row, for every K the wrappers
take and every class table the engine builds (A = 1..8 alleles, auto and
allo; with and without a class map).  The card checks the same plan
against the kernels' ``*_launch_dyn_smem`` (``chip_smoke.py``).

The class map (``ClassMap``) is an optional argument: the CPU path with it
must equal the path without it bit for bit, and both the JAX package's
formulation (``instruct_tpu/tetra/engine.py``: ``_site_class``,
``_table_at``, ``_site_loglik``) at rtol 1e-5, atol 1e-4 (f32 sums over N
or L in another order), as ``tests/test_torch_tetra_kernels.py`` holds the
path without it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.synthetic import synthetic_tetra_panel as jax_tetra
from instruct_tpu.tetra import engine as jeng

from instruct_tpu_torch import ModelSpec, convert
from instruct_tpu_torch.data.dataset import make_dataset
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.tetra import combinatorics as comb
from instruct_tpu_torch.tetra import engine as te

# (C, N, L): single rows and loci, ragged sizes, the tetraploid benchmark
# panel (4 x 500 x 5000), the K grid's 40 chains, a large panel
PLAN_SIZES = [(1, 1, 1), (2, 33, 258), (3, 19, 130), (4, 500, 5000),
              (40, 500, 5000), (1, 10_000, 100_000), (4, 3, 5001)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _class_shapes(n_alleles: int, autopoly: bool):
    """(G, V, n_cls) of the class tables the engine builds for loci of
    1..n_alleles alleles."""
    ct = comb.build_class_tables(np.arange(1, n_alleles + 1), autopoly)
    return ct.g_max, ct.n_max ** 4, len(ct.allele_counts)


def _smem(kind, plan, k, g, v, n_cls, a, autopoly):
    lut = 2 * n_cls * v if plan.lut_smem else 0
    if kind == "s_delta":
        return (4 * k * tg.SUM_THREADS
                + (4 * k * tg.SUM_TILE * g if plan.stage else 0)
                + lut + tg.SUM_TILE)
    sys = 1 if autopoly else 2
    return ((4 * (sys * k * tg.SUM_TILE * a + (k + 1) * tg.SUM_TILE * g)
             if plan.stage else 0) + lut + tg.SUM_TILE)


@pytest.mark.parametrize("kind", ["s_delta", "site_ll"])
@pytest.mark.parametrize("autopoly", [True, False])
@pytest.mark.parametrize("n_alleles", [1, 2, 4, 8])
def test_sums_plan_fits_the_card_and_covers_the_panel(kind, autopoly,
                                                      n_alleles):
    """For every K (1..127), with and without the class map, and panels
    from one site to 10^4 x 10^5: the block's shared memory fits the card
    (and is the kernel's formula), the grid's tiles cover every locus once
    and its strips every row once, within the grid's limits; tables are
    staged only within ``STAGE_SMEM`` and the class rows only within
    ``LUT_SMEM``."""
    g, v, n_cls_map = _class_shapes(n_alleles, autopoly)
    for c, n, l in PLAN_SIZES:
        for k in range(1, tg.MAX_POPS + 1):
            for n_cls in (0, n_cls_map):
                plan = tg.sums_plan(kind, c, n, l, k, g, v, n_cls,
                                    n_alleles, autopoly)
                assert plan.dyn_smem == _smem(kind, plan, k, g, v, n_cls,
                                              n_alleles, autopoly)
                assert plan.dyn_smem <= tg.SMEM_MAX
                assert not plan.stage or plan.dyn_smem <= tg.STAGE_SMEM
                assert plan.lut_smem == (
                    n_cls > 0 and 2 * n_cls * v <= tg.LUT_SMEM)
                assert (plan.tiles - 1) * tg.SUM_TILE < l \
                    <= plan.tiles * tg.SUM_TILE <= l + tg.SUM_TILE - 1
                assert plan.tiles <= tg.GRID_MAX and c <= tg.GRID_MAX
                assert plan.rows >= 1 and plan.strips >= 1
                assert (plan.strips - 1) * plan.rows < n \
                    <= plan.strips * plan.rows


@pytest.mark.parametrize("kind", ["s_delta", "site_ll"])
@pytest.mark.parametrize("autopoly", [True, False])
def test_sums_plan_at_the_benchmark_panel(kind, autopoly):
    """At the tetraploid benchmark panel (4 chains, 500 x 5000, K = 3,
    A = 4; G = 35 auto, 100 allo) both kernels stage their tables and the
    class rows, and the grid is two strips of 250 rows over 157 tiles; the
    wide class tables of the A = 8 panel (K * G = 1320 auto, 5184 allo)
    are gathered."""
    g, v, n_cls = _class_shapes(4, autopoly)
    plan = tg.sums_plan(kind, 4, 500, 5000, 3, g, v, n_cls, 4, autopoly)
    assert plan.stage and plan.lut_smem
    assert (plan.strips, plan.rows, plan.tiles) == (2, 250, 157)
    g8, v8, n_cls8 = _class_shapes(8, autopoly)
    wide = tg.sums_plan(kind, 4, 500, 1000, 4, g8, v8, 1, 8, autopoly)
    assert not wide.stage and wide.lut_smem
    assert 4 * g8 == (1320 if autopoly else 5184)


def _ragged_dataset(seed=9):
    """A panel whose loci hold 1..4 alleles: four class rows."""
    rng = np.random.default_rng(seed)
    n, l = 10, 11
    n_alleles = np.array([1, 2, 3, 4, 2, 4, 3, 1, 4, 2, 3], np.int32)
    distinct = np.zeros((n, l, 4), np.int32)
    n_distinct = np.zeros((n, l), np.int32)
    for i in range(n):
        for j in range(l):
            cnt = rng.integers(1, n_alleles[j] + 1)
            alle = np.sort(rng.choice(n_alleles[j], cnt, replace=False))
            distinct[i, j, :cnt], n_distinct[i, j] = alle, cnt
    miss = rng.random((n, l)) < 0.1
    return make_dataset(distinct, miss, n_alleles, distinct=distinct,
                        n_distinct=n_distinct)


def _inputs(data, autopoly, k=3, c=2, seed=5):
    """The engine's tables and state-like inputs of K6 and K7 from a seed:
    half the rows with all four copies of a site in one pop."""
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly)
    t = te.build_tables(spec, data)
    rng = np.random.default_rng(seed)
    n, l = data.site_valid.shape
    a = data.max_alleles
    av = data.allele_valid.numpy()

    def simplex():
        f = rng.dirichlet(np.ones(a), size=(c, k, l)) * av
        return torch.from_numpy((f / f.sum(-1, keepdims=True))
                                .astype(np.float32))

    freq, freq2 = simplex(), simplex()
    z = rng.integers(0, k, size=(c, n, 4 * l)).astype(np.int8)
    z[:, : n // 2] = np.tile(z[:, : n // 2, :l], (1, 1, 4))
    nc = t.cand_nc.to(torch.float32)
    choice = torch.floor(torch.from_numpy(rng.random((c, n, l))).float()
                         * nc).to(torch.int8)
    geno = te.reconstruct_geno(t, choice)
    cur = torch.from_numpy(rng.uniform(0.05, 0.95, (c, k)).astype(np.float32))
    prop = (cur + 0.05).clamp(0.01, 0.99)
    tc = te.class_table(t, spec, freq, freq2, cur)
    tp = te.class_table(t, spec, freq, freq2, prop)
    return spec, t, freq, freq2, torch.from_numpy(z), geno, tc, tp


def _panels():
    jp = jax_tetra(n_indv=12, n_loci=17, n_pops=3, n_alleles=4,
                   autopoly=True, missing_rate=0.1, seed=3)
    fields = {k: None if v is None else np.asarray(v)
              for k, v in jp.data._asdict().items()}
    return {"A = 4": convert.dataset_from_numpy(fields),
            "loci of 1..4 alleles": _ragged_dataset()}


@pytest.mark.parametrize("autopoly", [True, False])
@pytest.mark.parametrize("panel", ["A = 4", "loci of 1..4 alleles"])
def test_class_map_path_is_the_lookup_path(autopoly, panel):
    """K6 and K7 on the CPU with the engine's class map give bit for bit
    what they give without it, and the map's rows are ``lookup_l``'s."""
    data = _panels()[panel]
    spec, t, freq, freq2, z, geno, tc, tp = _inputs(data, autopoly)
    cm = t.class_map
    assert cm.of_locus.dtype == torch.uint8
    assert torch.equal(cm.lookup[cm.of_locus.long()], t.lookup_l)
    assert torch.equal(tg.site_class(t.lookup_l, geno, cm),
                       tg.site_class(t.lookup_l, geno))
    d_map = tg.s_delta_pass(tc, tp, t.lookup_l, z, geno, data.site_valid,
                            cm)
    d = tg.s_delta_pass(tc, tp, t.lookup_l, z, geno, data.site_valid)
    assert torch.equal(d_map, d) and bool((d != 0).any())
    ll_map = tg.site_ll_pass(tc, t.lookup_l, t.log_mult_l, freq, freq2, z,
                             geno, data.site_valid, autopoly=autopoly,
                             classes=cm)
    ll = tg.site_ll_pass(tc, t.lookup_l, t.log_mult_l, freq, freq2, z, geno,
                         data.site_valid, autopoly=autopoly)
    assert torch.equal(ll_map, ll) and bool(torch.isfinite(ll).all())
    # the engine's entry passes the map
    assert torch.equal(te.site_indv_loglik(t, spec, data, freq, freq2, z,
                                           geno, tc), ll)


@pytest.mark.parametrize("autopoly", [True, False])
def test_class_map_path_matches_jax(autopoly):
    """K6 and K7 through the class map against the JAX package's XLA
    formulation on the same inputs (its tables built from the same
    panel)."""
    jp = jax_tetra(n_indv=12, n_loci=17, n_pops=3, n_alleles=4,
                   autopoly=autopoly, missing_rate=0.1, seed=3)
    jdata = jp.data
    fields = {k: None if v is None else np.asarray(v)
              for k, v in jdata._asdict().items()}
    data = convert.dataset_from_numpy(fields)
    spec, t, freq, freq2, z, geno, tc, tp = _inputs(data, autopoly, seed=8)
    jspec = JSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    jt = jeng.build_tables(jspec, jdata, False)
    cm = t.class_map
    d = tg.s_delta_pass(tc, tp, t.lookup_l, z, geno, data.site_valid, cm)
    ll = tg.site_ll_pass(tc, t.lookup_l, t.log_mult_l, freq, freq2, z, geno,
                         data.site_valid, autopoly=autopoly, classes=cm)
    for ci in range(z.shape[0]):
        jz, jg = jnp.asarray(z[ci].numpy()), jnp.asarray(geno[ci].numpy())
        zc = jeng._split4(jz)
        cls_idx = jeng._site_class(jt, jdata, jg)
        mask = (((zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3]))
                & jdata.site_valid)
        diff = jnp.where(mask,
                         jeng._table_at(jnp.asarray(tp[ci].numpy()), zc[0],
                                        cls_idx)
                         - jeng._table_at(jnp.asarray(tc[ci].numpy()), zc[0],
                                          cls_idx), 0.0)
        want = np.stack([np.asarray(jnp.where(zc[0] == kk, diff, 0.0).sum())
                         for kk in range(3)])
        np.testing.assert_allclose(d[ci].numpy(), want, rtol=1e-5,
                                   atol=1e-4)
        want_ll = jeng._site_loglik(
            jt, jspec, jdata, jnp.asarray(freq[ci].numpy()),
            jnp.asarray(freq2[ci].numpy()), jz, jg,
            jnp.asarray(tc[ci].numpy())).sum(axis=1)
        np.testing.assert_allclose(ll[ci].numpy(), np.asarray(want_ll),
                                   rtol=1e-5, atol=1e-4)
