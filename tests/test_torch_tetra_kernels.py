"""The tetraploid engine's tables and the plain versions of its kernels
(K5 ``geno_choice_pass``, K6 ``s_delta_pass``, K7 ``site_ll_pass``) against
the JAX package, on the CPU.

The same inputs, made with numpy from a seed or by the JAX panel generator
and carried across with ``convert``, go through the JAX function and its
counterpart in the port.  The JAX side is the package's XLA formulation
(``instruct_tpu/tetra/engine.py``), which the package's own tests hold
bit-equal to its Pallas kernels.

Tolerances: combinatorics, candidate planes, class indices and chosen
candidates exactly; the log class tables at rtol 1e-5, atol 1e-5 (the port
solves the equilibrium in float64, the JAX package in float32); the K6 and
K7 sums at rtol 1e-5, atol 1e-4 (f32 sums over N or L in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.dataset import make_dataset as jax_make_dataset
from instruct_tpu.data.synthetic import synthetic_tetra_panel as jax_tetra
from instruct_tpu.tetra import combinatorics as jcomb
from instruct_tpu.tetra import engine as jeng

from instruct_tpu_torch import ModelSpec, convert
from instruct_tpu_torch.data.dataset import make_dataset
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import tetra_geno as tg
from instruct_tpu_torch.tetra import combinatorics as comb
from instruct_tpu_torch.tetra import engine as te


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def _panel(autopoly, n_alleles, n=12, l=17, k=3, missing=0.1, seed=3):
    jp = jax_tetra(n_indv=n, n_loci=l, n_pops=k, n_alleles=n_alleles,
                   autopoly=autopoly, missing_rate=missing, seed=seed)
    return jp.data, convert.dataset_from_numpy(_fields(jp.data))


def _state_arrays(jdata, k, c, seed, a=None):
    """freq, freq2 f32[C, K, L, A], q f32[C, N, K], z i8[C, N, 4L] (some
    individuals with all four copies in one pop), geno i8[C, N, 4L] (a
    random candidate ordering per site) from a seed."""
    rng = np.random.default_rng(seed)
    n, l = np.asarray(jdata.n_distinct).shape
    a = jdata.allele_valid.shape[1] if a is None else a
    av = np.asarray(jdata.allele_valid)
    freq = rng.dirichlet(np.ones(a), size=(c, k, l)) * av
    freq2 = rng.dirichlet(np.ones(a), size=(c, k, l)) * av
    freq = (freq / freq.sum(-1, keepdims=True)).astype(np.float32)
    freq2 = (freq2 / freq2.sum(-1, keepdims=True)).astype(np.float32)
    q = rng.dirichlet(np.ones(k), size=(c, n)).astype(np.float32)
    z = rng.integers(0, k, size=(c, n, 4 * l)).astype(np.int8)
    z[:, : n // 2] = np.tile(z[:, : n // 2, :l], (1, 1, 4))
    return rng, freq, freq2, q, z


_JAX_TABLES = {}


def _tables(autopoly, jdata, data, with_candidates=True):
    """(jspec, spec, JAX tables, port tables).  The JAX tables with their
    candidate planes take seconds to compile (12 candidates x 256-way
    select chains for allo), so the standard panels' are built once."""
    jspec = JSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    spec = ModelSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    key = (autopoly, jdata.max_alleles, jdata.geno.shape, with_candidates)
    if key not in _JAX_TABLES:
        _JAX_TABLES[key] = jeng.build_tables(jspec, jdata, with_candidates)
    return jspec, spec, _JAX_TABLES[key], te.build_tables(spec, data)


def _jax_class_tables(jt, jspec):
    """The JAX (log HWE table, equilibrium table) of (freq, freq2, rates),
    jitted whole: one compile instead of one per eager op."""
    def fn(freq, freq2, rates):
        h = jeng.log_hwe_table(jt, jspec, freq, freq2)
        return h, jeng.selfing_equilibrium(jt, h, rates)
    return jax.jit(fn)


def _genos(t, c, rng):
    """A random candidate ordering per site and chain, i8[C, N, 4L]."""
    n, l = t.cand_nc.shape
    nc = t.cand_nc.to(torch.float32)
    choice = torch.floor(torch.from_numpy(rng.random((c, n, l))).float()
                         * nc).to(torch.int8)
    return te.reconstruct_geno(t, choice).numpy()


# ---------------------------------------------------------------------------
# combinatorics, data, tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("autopoly", [True, False])
@pytest.mark.parametrize("n_alleles", [[2] * 5, [3] * 5, [4] * 5,
                                       [1, 2, 4, 3, 2, 4]])
def test_class_tables_match_jax(autopoly, n_alleles):
    na = np.asarray(n_alleles, np.int32)
    got = comb.build_class_tables(na, autopoly)
    want = jcomb.build_class_tables(na, autopoly)
    for name in ("allele_counts", "g_count", "digits", "valid", "log_mult",
                 "lookup", "self_mat", "subgenome2"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.g_max, got.n_max) == (want.g_max, want.n_max)
    np.testing.assert_array_equal(got.class_of_locus(na),
                                  want.class_of_locus(na))
    for pats, jpats in ((comb.AUTO_PATTERNS, jcomb.AUTO_PATTERNS),
                        (comb.ALLO_PATTERNS, jcomb.ALLO_PATTERNS)):
        for cnt in pats:
            np.testing.assert_array_equal(pats[cnt], jpats[cnt])


def test_make_dataset_distinct_matches_jax():
    rng = np.random.default_rng(2)
    n, l = 9, 13
    distinct = np.sort(rng.integers(0, 4, size=(n, l, 4)), axis=-1)
    n_distinct = rng.integers(0, 5, size=(n, l))
    miss = rng.random((n, l)) < 0.2
    args = (distinct, miss, np.full(l, 4, np.int32))
    got = make_dataset(*args, distinct=distinct, n_distinct=n_distinct)
    want = jax_make_dataset(*args, distinct=distinct, n_distinct=n_distinct)
    for name in ("geno", "site_valid", "allele_valid", "hom", "distinct",
                 "n_distinct"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.distinct.dtype == torch.int32 and got.ploid == 4
    assert got.bits2 is None and got.n_indv == n


@pytest.mark.parametrize("autopoly", [True, False])
def test_synthetic_tetra_panel_is_the_model_draw(autopoly):
    """The vectorised generator: observations are sorted distinct-allele
    sets of genotype classes, missing sites are empty, and the per-locus
    class frequencies follow the selfing equilibrium (a strongly selfing
    pop shows far more single-allele sites than a weakly selfing one)."""
    kw = dict(n_indv=400, n_loci=30, n_pops=1, n_alleles=3,
              autopoly=autopoly, admixture_alpha=1.0, seed=5)
    lo = synthetic_tetra_panel(selfing_rates=np.array([0.05]), **kw).data
    hi = synthetic_tetra_panel(selfing_rates=np.array([0.9]),
                               missing_rate=0.1, **kw).data
    for d in (lo, hi):
        dist = d.distinct.numpy().reshape(400, 4, 30).transpose(0, 2, 1)
        nd = d.n_distinct.numpy()
        valid = d.site_valid.numpy()
        assert ((nd >= 1) == valid).all() and (nd <= 3).all()
        for m in range(1, 4):
            live = m < nd
            assert (dist[..., m][live] > dist[..., m - 1][live]).all()
            assert (dist[..., m][~live & valid] == 0).all()
        v4 = np.tile(valid, (1, 4))
        np.testing.assert_array_equal(d.geno.numpy()[v4],
                                      d.distinct.numpy()[v4])
    one = lambda d: (d.n_distinct.numpy()[d.site_valid.numpy()] == 1).mean()
    assert one(hi) > one(lo) + 0.2


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 2), (False, 2),
                                                (True, 4), (False, 4)])
def test_tables_and_candidate_planes_match_jax(autopoly, n_alleles):
    jdata, data = _panel(autopoly, n_alleles)
    _, _, jt, t = _tables(autopoly, jdata, data)
    for name in ("cand_sel", "cand_cls", "cand_mult", "cand_nc"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.lookup_l.numpy(),
                                  np.asarray(jt.lookup[jt.cls]))
    np.testing.assert_array_equal(t.log_mult_l.numpy(),
                                  np.asarray(jt.log_mult[jt.cls]))
    assert t.n_cand == (3 if autopoly else 12)
    assert t.cand_sel.dtype == torch.uint8 and t.cand_cls.dtype == torch.int16


def test_ragged_panel_tables_match_jax():
    """Loci with 1..4 alleles: several class groups, each with its own G."""
    rng = np.random.default_rng(9)
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
    args = (distinct, miss, n_alleles)
    jdata = jax_make_dataset(*args, distinct=distinct, n_distinct=n_distinct)
    data = make_dataset(*args, distinct=distinct, n_distinct=n_distinct)
    for autopoly in (True, False):
        # the allo candidate planes are held to JAX's on the standard panels
        jspec, spec, jt, t = _tables(autopoly, jdata, data, autopoly)
        assert len(t.class_loci) == 4
        for name in ("cand_sel", "cand_cls", "cand_mult", "cand_nc"):
            if autopoly:
                np.testing.assert_array_equal(getattr(t, name).numpy(),
                                              np.asarray(getattr(jt, name)))
        _, freq, freq2, _, _ = _state_arrays(jdata, 3, 1, 4)
        rates = np.array([0.0, 0.45, 0.93], np.float32)
        jh, jeq = _jax_class_tables(jt, jspec)(
            jnp.asarray(freq[0]), jnp.asarray(freq2[0]), jnp.asarray(rates))
        h = te.log_hwe_table(t, spec, torch.from_numpy(freq),
                             torch.from_numpy(freq2))
        np.testing.assert_allclose(h[0].numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        eq = te.selfing_equilibrium(t, h, torch.from_numpy(rates)[None])
        np.testing.assert_allclose(eq[0].numpy(), np.asarray(jeq), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("autopoly", [True, False])
def test_log_hwe_and_equilibrium_match_jax(autopoly):
    jdata, data = _panel(autopoly, 4)
    jspec, spec, jt, t = _tables(autopoly, jdata, data, False)
    c = 2
    _, freq, freq2, _, _ = _state_arrays(jdata, 3, c, 11)
    rates = np.array([[0.05, 0.5, 0.95], [0.0, 0.3, 0.999]], np.float32)
    h = te.log_hwe_table(t, spec, torch.from_numpy(freq),
                         torch.from_numpy(freq2))
    eq = te.selfing_equilibrium(t, h, torch.from_numpy(rates))
    jfn = _jax_class_tables(jt, jspec)
    for ci in range(c):
        jh, jeq = jfn(jnp.asarray(freq[ci]), jnp.asarray(freq2[ci]),
                      jnp.asarray(rates[ci]))
        np.testing.assert_allclose(h[ci].numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(eq[ci].numpy(), np.asarray(jeq),
                                   rtol=1e-5, atol=1e-5)
    # every class column sums to 1 at every (chain, pop, locus)
    p = torch.exp(eq).sum(-1)
    np.testing.assert_allclose(p.numpy(), 1.0, atol=1e-5)
    # a rate of exactly 1 leaves I - A singular: NaN, never an exception
    bad = te.selfing_equilibrium(t, h, torch.ones(c, 3))
    assert torch.isnan(bad).any()


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

def _jax_gumbel(key, n_cand, n, l):
    """The Gumbel planes ``engine._sample_geno`` draws from ``key``."""
    return np.stack([np.asarray(-jnp.log(-jnp.log(jax.random.uniform(
        jax.random.fold_in(key, c), (n, l), minval=1e-12, maxval=1.0))))
        for c in range(n_cand)]).astype(np.float32)


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 2), (False, 2),
                                                (True, 4), (False, 4)])
def test_geno_move_plain_version_matches_jax(autopoly, n_alleles):
    """K5's plain version + the reconstruction against the JAX move
    (``_sample_geno``, XLA path) fed the same Gumbel noise: the chosen
    orderings, hence the new genotypes, exactly equal."""
    jdata, data = _panel(autopoly, n_alleles)
    jspec, spec, jt, t = _tables(autopoly, jdata, data)
    n, l = data.n_distinct.shape
    c, k = 2, 3
    _, freq, freq2, q, z = _state_arrays(jdata, k, c, 7 + n_alleles)
    rates = np.array([[0.1, 0.5, 0.9], [0.7, 0.2, 0.4]], np.float32)
    table = te.class_table(t, spec, torch.from_numpy(freq),
                           torch.from_numpy(freq2), torch.from_numpy(rates))
    keys = [jax.random.key(30 + ci) for ci in range(c)]
    gumbel = np.stack([_jax_gumbel(kk, t.n_cand, n, l) for kk in keys])
    want = []
    for ci in range(c):
        want.append(np.asarray(jeng._sample_geno(
            keys[ci], jt, jspec, jdata, jnp.asarray(freq[ci]),
            jnp.asarray(freq2[ci]), jnp.asarray(q[ci]),
            jnp.asarray(table[ci].numpy()), jnp.asarray(z[ci]))))
    got = te.sample_geno(None, 0, t, spec, torch.from_numpy(freq),
                         torch.from_numpy(freq2), torch.from_numpy(q), table,
                         torch.from_numpy(z), gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    # without injected noise the move draws from Philox: a function of
    # (seed, step), and the candidate drawn is always a valid one
    pkeys = px.make_keys(5, c, "cpu")
    args = (pkeys, 3, table, torch.from_numpy(z), t.dist8, t.cand_nc,
            torch.from_numpy(q), torch.from_numpy(freq),
            torch.from_numpy(freq2), t.cand_sel, t.cand_cls, t.cand_mult)
    ch = tg.geno_choice_pass(*args, autopoly=autopoly)
    assert torch.equal(ch, tg.geno_choice_pass_reference(
        *args, autopoly=autopoly))
    assert ch.dtype == torch.int8 and (ch.long() < t.cand_nc.long()).all()
    assert not torch.equal(ch, tg.geno_choice_pass(
        pkeys, 4, *args[2:], autopoly=autopoly))


def _reference_weights(table, z, dist, q, freq, freq2, cand_sel, cand_cls,
                       cand_mult, autopoly):
    """f32[C, n_cand, N, L]: the candidate weights of
    ``geno_choice_pass_reference`` as its loop forms them (5 logs a mixed
    candidate)."""
    c = z.shape[0]
    n_cand, n, l = cand_sel.shape
    zc = tg.split4(z)
    mix1 = tg.mix_per_allele(freq, q)
    mix2 = mix1 if autopoly else tg.mix_per_allele(freq2, q)
    dist4 = torch.stack(tg.split4(dist))
    out = []
    for cc in range(n_cand):
        w_mix = torch.log(cand_mult[cc].to(torch.float32))
        sel8 = cand_sel[cc].to(torch.int64)
        for m in range(4):
            av = dist4.gather(0, ((sel8 >> (2 * m)) & 3)[None])
            mix = mix1 if (autopoly or m < 2) else mix2
            w_mix = w_mix + tg._slog(
                mix.gather(1, av[None].expand(c, 1, n, l))[:, 0])
        out.append(torch.where(tg.same_z(zc),
                               tg.table_at(table, zc[0], cand_cls[cc]),
                               w_mix))
    return torch.stack(out, dim=1)


def _hoisted_weights(table, z, dist, q, freq, freq2, cand_sel, cand_cls,
                     cand_mult, autopoly):
    """The same weights as the CUDA kernel forms them: the log of each of
    the site's (at most 4) distinct mixtures per system taken once, then a
    candidate's weight log mult + those logs gathered by its selectors, in
    slot order."""
    c = z.shape[0]
    n_cand, n, l = cand_sel.shape
    zc = tg.split4(z)
    dist4 = torch.stack(tg.split4(dist))
    logs = []
    for f in ((freq,) if autopoly else (freq, freq2)):
        mix = tg.mix_per_allele(f, q)
        logs.append(torch.stack(
            [tg._slog(mix.gather(1, dist4[j][None, None].expand(c, 1, n, l))
                      [:, 0]) for j in range(4)], dim=1))
    log_int = torch.log(torch.arange(256, dtype=torch.float32))
    out = []
    for cc in range(n_cand):
        w = log_int[cand_mult[cc].to(torch.int64)]
        sel8 = cand_sel[cc].to(torch.int64)
        for m in range(4):
            lg = logs[0 if (autopoly or m < 2) else 1]
            j = ((sel8 >> (2 * m)) & 3)[None, None].expand(c, 1, n, l)
            w = w + lg.gather(1, j)[:, 0]
        out.append(torch.where(tg.same_z(zc),
                               tg.table_at(table, zc[0], cand_cls[cc]), w))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("autopoly,n_alleles", [(True, 2), (False, 2),
                                                (True, 4), (False, 4)])
def test_hoisted_geno_weights_are_the_plain_versions(autopoly, n_alleles):
    """K5's kernel takes the log of each distinct mixture once per site and
    chain and a log multiplicity from a table of log(i): its weights equal,
    bit for bit, those the plain version forms per candidate, and their
    Gumbel-argmax under injected noise is the plain version's choice."""
    _, data = _panel(autopoly, n_alleles, n=14, l=23, missing=0.15,
                     seed=20 + n_alleles)
    spec = ModelSpec(mode=2, ploid=4, n_pops=3, autopoly=autopoly)
    t = te.build_tables(spec, data)
    assert set(data.n_distinct[data.site_valid].tolist()) == (
        set(range(1, n_alleles + 1)))
    c, k = 3, 3
    rng = np.random.default_rng(40 + n_alleles)
    n, l = data.n_distinct.shape
    av = data.allele_valid.numpy()
    freq, freq2 = (torch.from_numpy((rng.dirichlet(
        np.ones(n_alleles), size=(c, k, l)) * av).astype(np.float32))
        for _ in range(2))
    q = torch.from_numpy(rng.dirichlet(np.ones(k), size=(c, n))
                         .astype(np.float32))
    z = rng.integers(0, k, size=(c, n, 4 * l)).astype(np.int8)
    z[:, : n // 2] = np.tile(z[:, : n // 2, :l], (1, 1, 4))
    z = torch.from_numpy(z)
    rates = torch.from_numpy(np.array([[0.1, 0.5, 0.9]] * c, np.float32))
    table = te.class_table(t, spec, freq, freq2, rates)
    args = (table, z, t.dist8, q, freq, freq2, t.cand_sel, t.cand_cls,
            t.cand_mult, autopoly)
    want = _reference_weights(*args)
    got = _hoisted_weights(*args)
    live = (torch.arange(t.n_cand)[None, :, None, None]
            < t.cand_nc.long()[None, None])
    assert torch.equal(torch.where(live.expand_as(got), got, 0.0),
                       torch.where(live.expand_as(want), want, 0.0))
    for seed in range(3):
        g = torch.from_numpy(-np.log(-np.log(np.random.default_rng(seed)
                                             .uniform(1e-7, 1 - 1e-7, (
                                                 c, t.n_cand, n, l))))
                             .astype(np.float32))
        v = torch.where(live, got + g, torch.full_like(got, -1e30))
        best = torch.full((c, n, l), -1e30)
        choice = torch.zeros((c, n, l), dtype=torch.int64)
        for cc in range(t.n_cand):
            take = v[:, cc] > best
            best = torch.where(take, v[:, cc], best)
            choice = torch.where(take, torch.full_like(choice, cc), choice)
        ref = tg.geno_choice_pass_reference(
            None, 0, table, z, t.dist8, t.cand_nc, q, freq, freq2,
            t.cand_sel, t.cand_cls, t.cand_mult, autopoly=autopoly,
            gumbel=g)
        assert torch.equal(choice.to(torch.int8), ref)


@pytest.mark.parametrize("autopoly", [True, False])
def test_s_delta_plain_version_matches_jax(autopoly):
    """K6's plain version against the JAX S update's XLA log-ratio
    (``_site_class``, two ``_table_at`` and the masked per-pop sums)."""
    jdata, data = _panel(autopoly, 4)
    jspec, spec, jt, t = _tables(autopoly, jdata, data, False)
    c, k = 2, 3
    rng, freq, freq2, _, z = _state_arrays(jdata, k, c, 21)
    geno = _genos(t, c, rng)
    cur = rng.uniform(0.05, 0.95, (c, k)).astype(np.float32)
    prop = np.clip(cur + rng.uniform(-0.05, 0.05, (c, k)), 0.01,
                   0.99).astype(np.float32)
    h = te.log_hwe_table(t, spec, torch.from_numpy(freq),
                         torch.from_numpy(freq2))
    tc = te.selfing_equilibrium(t, h, torch.from_numpy(cur))
    tp = te.selfing_equilibrium(t, h, torch.from_numpy(prop))
    got = tg.s_delta_pass(tc, tp, t.lookup_l, torch.from_numpy(z),
                          torch.from_numpy(geno), data.site_valid)
    assert got.shape == (c, k)
    for ci in range(c):
        jz, jg = jnp.asarray(z[ci]), jnp.asarray(geno[ci])
        cls_idx = jeng._site_class(jt, jdata, jg)
        zc = jeng._split4(jz)
        s_mask = (((zc[0] == zc[1]) & (zc[1] == zc[2]) & (zc[2] == zc[3]))
                  & jdata.site_valid)
        diff = jnp.where(s_mask,
                         jeng._table_at(jnp.asarray(tp[ci].numpy()), zc[0],
                                        cls_idx)
                         - jeng._table_at(jnp.asarray(tc[ci].numpy()), zc[0],
                                          cls_idx), 0.0)
        want = np.stack([np.asarray(jnp.where(zc[0] == kk, diff, 0.0).sum())
                         for kk in range(k)])
        np.testing.assert_allclose(got[ci].numpy(), want, rtol=1e-5,
                                   atol=1e-4)
    assert (got != 0).any()


@pytest.mark.parametrize("autopoly", [True, False])
def test_site_ll_plain_version_matches_jax(autopoly):
    """K7's plain version against ``engine._site_loglik`` summed over loci
    (10% of the sites missing)."""
    jdata, data = _panel(autopoly, 4)
    jspec, spec, jt, t = _tables(autopoly, jdata, data, False)
    c, k = 2, 3
    rng, freq, freq2, _, z = _state_arrays(jdata, k, c, 31)
    geno = _genos(t, c, rng)
    rates = rng.uniform(0.05, 0.95, (c, k)).astype(np.float32)
    ft, f2t = torch.from_numpy(freq), torch.from_numpy(freq2)
    table = te.class_table(t, spec, ft, f2t, torch.from_numpy(rates))
    got = tg.site_ll_pass(table, t.lookup_l, t.log_mult_l, ft, f2t,
                          torch.from_numpy(z), torch.from_numpy(geno),
                          data.site_valid, autopoly=autopoly)
    for ci in range(c):
        want = jeng._site_loglik(
            jt, jspec, jdata, jnp.asarray(freq[ci]), jnp.asarray(freq2[ci]),
            jnp.asarray(z[ci]), jnp.asarray(geno[ci]),
            jnp.asarray(table[ci].numpy())).sum(axis=1)
        np.testing.assert_allclose(got[ci].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)
    assert torch.isfinite(got).all() and (got < 0).all()
    # the engine's entry is the kernel's wrapper
    assert torch.equal(te.site_indv_loglik(t, spec, data, ft, f2t,
                                           torch.from_numpy(z),
                                           torch.from_numpy(geno), table),
                       got)
