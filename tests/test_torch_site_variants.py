"""Every entry point of the port's per-site pass (plain PyTorch versions,
CPU) against the JAX package's Pallas kernel run in interpret mode, on the
packed biallelic plane and on multi-allelic panels (the generic path), at
K <= 8 and at 8 < K <= 32 (the kernel's run-time-K body).

Inputs are made with numpy from a seed and handed to both sides together
with the same injected z-draw uniforms, so z, qqnum and zcounts must agree
exactly and the log-lik columns to f32 rounding (sums over L taken in
another order than the Pallas blocks': rtol 1e-5, atol 1e-4).  Every
sampling pass carries its allele-pop counts on both paths: they equal JAX's
carried counts and the plain ``allele_counts``.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.data.dataset import make_dataset as jax_make_dataset
from instruct_tpu.kernels import fused_step as jfs

from instruct_tpu_torch import convert
from instruct_tpu_torch.kernels import fused_step as tfs
from instruct_tpu_torch.kernels import philox as px

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _keys(c=1):
    return px.make_keys(7, c, "cpu")


# (N, L, K, A): K in {1, 2, 3}; A = 2 is the packed plane, A = 4 the generic
# path with a ragged number of alleles per locus
PANELS = {"packed-K3": (24, 96, 3, 2), "packed-K1": (9, 20, 1, 2),
          "generic-K2": (20, 48, 2, 4), "generic-K3": (12, 31, 3, 4)}


@pytest.fixture(scope="module", params=sorted(PANELS))
def setup(request):
    n, l, k, a = PANELS[request.param]
    rng = np.random.default_rng(11)
    n_alleles = (np.full(l, 2) if a == 2
                 else rng.integers(2, a + 1, size=l))
    n_alleles[0] = a
    geno = rng.integers(0, 1 << 30, size=(n, l, 2)) % n_alleles[None, :, None]
    missing = rng.random((n, l)) < 0.15
    jdata = jax_make_dataset(geno, missing, n_alleles.astype(np.int32))
    assert (jdata.bits2 is not None) == (a == 2)
    data = convert.dataset_from_numpy(
        {f: None if v is None else np.asarray(v)
         for f, v in jdata._asdict().items()})
    av = np.asarray(jdata.allele_valid, np.float64)
    freq = rng.dirichlet(np.ones(a), size=(k, l)) * av[None]
    freq = (freq / freq.sum(-1, keepdims=True)).astype(np.float32)
    x = dict(
        jdata=jdata, data=data, k=k, freq=freq,
        q=rng.dirichlet(np.ones(k), size=n).astype(np.float32),
        z=rng.integers(0, k, size=(n, 2 * l)).astype(np.int8),
        u=rng.uniform(1e-6, 1 - 1e-6, size=(n, 2 * l)).astype(np.float32),
        wg_pair=np.exp2(1.0 - rng.integers(1, 12, size=(n, 2))
                        ).astype(np.float32),
        f_pop=rng.uniform(0.02, 0.98, size=(k, 2)).astype(np.float32),
        f_ind=rng.uniform(0.02, 0.98, size=(n, 2)).astype(np.float32))
    return x


def _jax_panel_args(x):
    d = x["jdata"]
    return d.geno, d.site_valid


def _same_draw(x, got, want):
    """z, qqnum, zcounts of a sampling pass: exactly equal, on both paths;
    the carried counts also equal the plain ``allele_counts`` of the z
    drawn.  (Where the JAX side ran with a padded allele of zero weight,
    its counts of that allele are zero.)"""
    z, qq, zc = got
    jz, jqq, jzc = want
    assert z.dtype == torch.int8 and z.shape[0] == 1
    np.testing.assert_array_equal(z[0].numpy(), np.asarray(jz))
    np.testing.assert_array_equal(qq[0].numpy(), np.asarray(jqq))
    d = x["data"]
    a = d.max_alleles
    jzc = np.asarray(jzc)
    assert zc.shape == (1, x["k"], d.n_loci, a)
    np.testing.assert_array_equal(zc[0].numpy(), jzc[..., :a])
    assert not jzc[..., a:].any()
    np.testing.assert_array_equal(
        zc.numpy(), tfs.allele_counts(z, d.geno, d.site_valid,
                                      n_pops=x["k"], max_alleles=a).numpy())
    assert float(qq.sum()) == float(zc.sum()) == 2.0 * float(
        d.site_valid.sum())


def _close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _b(a):
    """numpy -> torch with the chain axis."""
    return _t(a)[None]


def test_zq_sample_pass_matches_jax(setup):
    x = setup
    geno, valid = _jax_panel_args(x)
    want = jfs.zq_sample_pass(0, jnp.asarray(x["q"]), jnp.asarray(x["freq"]),
                              geno, valid, interpret=True,
                              u=jnp.asarray(x["u"]), bits2=x["jdata"].bits2)
    got = tfs.zq_sample_pass(_keys(), 0, _b(x["q"]), _b(x["freq"]),
                             x["data"], u=_b(x["u"]))
    _same_draw(x, got, want)


def test_zq_mode1_pass_matches_jax(setup):
    x = setup
    geno, valid = _jax_panel_args(x)
    jz, jqq, jll, jzc = jfs.zq_mode1_pass(
        0, jnp.asarray(x["q"]), jnp.asarray(x["freq"]), geno, valid,
        interpret=True, u=jnp.asarray(x["u"]), bits2=x["jdata"].bits2)
    z, qq, ll, zc = tfs.zq_mode1_pass(_keys(), 0, _b(x["q"]), _b(x["freq"]),
                                      x["data"], u=_b(x["u"]))
    _same_draw(x, (z, qq, zc), (jz, jqq, jzc))
    _close(ll, jll)
    # the one-pass form is the stored-step pass at the z it drew
    again = tfs.panel_loglik_mode1_pass(_b(x["freq"]), None, x["data"], z)
    np.testing.assert_allclose(ll.numpy(), again.numpy(), rtol=1e-6)


def test_panel_loglik_mode1_pass_matches_jax(setup):
    x = setup
    geno, valid = _jax_panel_args(x)
    want = jfs.panel_loglik_mode1_pass(
        jnp.asarray(x["freq"]), jnp.asarray(x["q"]), geno, valid,
        jnp.asarray(x["z"]), interpret=True, bits2=x["jdata"].bits2)
    got = tfs.panel_loglik_mode1_pass(_b(x["freq"]), _b(x["q"]), x["data"],
                                      _b(x["z"]))
    _close(got, want)


@pytest.mark.parametrize("structure", [True, False])
def test_zq_gen_pass_matches_jax_and_gendiff_is_its_difference(setup,
                                                               structure):
    x = setup
    d = x["jdata"]
    args = (0, jnp.asarray(x["q"]), jnp.asarray(x["freq"]), d.geno,
            d.site_valid, d.hom, jnp.asarray(x["z"]),
            jnp.asarray(x["wg_pair"]))
    kw = dict(structure=structure, interpret=True, u=jnp.asarray(x["u"]),
              bits2=d.bits2)
    jz, jqq, jll, jzc = jfs.zq_gen_pass(*args, **kw)
    targs = (_keys(), 0, _b(x["q"]), _b(x["freq"]), x["data"],
             _b(x["wg_pair"]))
    tkw = dict(structure=structure, u=_b(x["u"]))
    z, qq, ll, zc = tfs.zq_gen_pass(*targs, **tkw)
    assert ll.shape == (1, x["q"].shape[0], 2)
    _same_draw(x, (z, qq, zc), (jz, jqq, jzc))
    _close(ll, jll)
    # the production form: same draw, the column difference in one column
    zd, qqd, lld, zcd = tfs.zq_gendiff_pass(*targs, **tkw)
    assert torch.equal(z, zd) and torch.equal(qq, qqd)
    np.testing.assert_allclose(lld.numpy(),
                               (ll[:, :, 1] - ll[:, :, 0]).numpy(),
                               rtol=1e-4, atol=ATOL)
    _close(lld, jfs.zq_gendiff_pass(*args, **kw)[2])


@pytest.mark.parametrize("structure", [True, False])
def test_panel_loglik_pass_matches_jax_on_every_path(setup, structure):
    x = setup
    d = x["jdata"]
    wg = x["wg_pair"][:, 0]
    want = jfs.panel_loglik_pass(
        jnp.asarray(x["freq"]), jnp.asarray(x["q"]), d.geno, d.site_valid,
        d.hom, jnp.asarray(x["z"]), jnp.asarray(wg)[:, None],
        structure=structure, interpret=True, bits2=d.bits2)
    got = tfs.panel_loglik_pass(_b(x["freq"]), _b(x["q"]), x["data"],
                                _b(x["z"]), _b(wg), structure=structure)
    _close(got, want)


@pytest.mark.parametrize("pop", [True, False])
def test_zq_f_pass_matches_jax(setup, pop):
    x = setup
    d = x["jdata"]
    f_pair = x["f_pop"] if pop else x["f_ind"]
    jz, jqq, jll, jzc = jfs.zq_f_pass(
        0, jnp.asarray(x["q"]), jnp.asarray(x["freq"]), d.geno, d.site_valid,
        d.hom, jnp.asarray(x["z"]), jnp.asarray(f_pair), pop=pop,
        interpret=True, u=jnp.asarray(x["u"]), bits2=d.bits2)
    z, qq, ll, zc = tfs.zq_f_pass(_keys(), 0, _b(x["q"]), _b(x["freq"]),
                                  x["data"], _b(f_pair), pop=pop,
                                  u=_b(x["u"]))
    n = x["q"].shape[0]
    assert ll.shape == ((1, n, x["k"]) if pop else (1, n))
    _same_draw(x, (z, qq, zc), (jz, jqq, jzc))
    _close(ll, jll)
    # "Z, then F | z": the terms are those of the FRESH z -- the stored-step
    # pass at that z differs by them between the proposed and the current F
    cur = tfs.panel_loglik_f_pass(_b(x["freq"]), x["data"], z,
                                  _b(f_pair[:, 0]), pop=pop)
    new = tfs.panel_loglik_f_pass(_b(x["freq"]), x["data"], z,
                                  _b(f_pair[:, 1]), pop=pop)
    np.testing.assert_allclose((ll.sum(dim=2) if pop else ll).numpy(),
                               (new - cur).numpy(), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("pop", [True, False])
def test_panel_loglik_f_pass_matches_jax(setup, pop):
    x = setup
    d = x["jdata"]
    f = (x["f_pop"] if pop else x["f_ind"])[:, 0]
    want = jfs.panel_loglik_f_pass(
        jnp.asarray(x["freq"]), d.geno, d.site_valid, d.hom,
        jnp.asarray(x["z"]), jnp.asarray(f)[:, None], pop=pop,
        interpret=True, bits2=d.bits2)
    got = tfs.panel_loglik_f_pass(_b(x["freq"]), x["data"], _b(x["z"]),
                                  _b(f), pop=pop)
    _close(got, want)


def test_sampling_passes_share_one_draw_and_never_read_the_old_z(setup):
    """Every sampling entry point draws the same z from the same uniforms
    (the family only adds a log-lik column), and two chains with their own
    keys draw their own."""
    x = setup
    base = (_keys(), 3, _b(x["q"]), _b(x["freq"]), x["data"])
    z = tfs.zq_sample_pass(*base, u=_b(x["u"]))[0]
    for out in (tfs.zq_mode1_pass(*base, u=_b(x["u"])),
                tfs.zq_gendiff_pass(*base, _b(x["wg_pair"]), structure=True,
                                    u=_b(x["u"])),
                tfs.zq_f_pass(*base, _b(x["f_pop"]), pop=True, u=_b(x["u"])),
                tfs.zq_f_pass(*base, _b(x["f_ind"]), pop=False,
                              u=_b(x["u"]))):
        assert torch.equal(out[0], z)
    if x["k"] > 1:
        keys = px.make_keys(3, 3, "cpu", chain_key=[5, 9, 5])
        q3 = _b(x["q"]).expand(3, -1, -1).contiguous()
        f3 = _b(x["freq"]).expand(3, -1, -1, -1).contiguous()
        z3 = tfs.zq_sample_pass(keys, 4, q3, f3, x["data"])[0]
        assert torch.equal(z3[0], z3[2]) and not torch.equal(z3[0], z3[1])
        assert not torch.equal(
            z3, tfs.zq_sample_pass(keys, 5, q3, f3, x["data"])[0])


def test_generic_path_guards_allele_codes():
    """A copy whose allele code is outside [0, A) weighs 0 under every pop
    (the JAX kernel's ``w_of`` matches no allele): z = 0 there, and the
    site, being invalid, is counted nowhere."""
    rng = np.random.default_rng(4)
    n, l, k, a = 6, 10, 2, 3
    geno = rng.integers(0, a, size=(n, 2 * l)).astype(np.int8)
    valid = rng.random((n, l)) < 0.8
    geno[0, 3], valid[0, 3] = 7, False
    geno[2, l + 5], valid[2, 5] = -1, False
    from instruct_tpu_torch.data.dataset import Dataset
    data = Dataset(geno=_t(geno), site_valid=_t(valid),
                   allele_valid=torch.ones(l, a, dtype=torch.bool),
                   hom=_t(geno[:, :l] == geno[:, l:]))
    q = _b(rng.dirichlet(np.ones(k), size=n).astype(np.float32))
    freq = _b(rng.dirichlet(np.ones(a), size=(k, l)).astype(np.float32))
    z, qq, ll, zc = tfs.zq_mode1_pass(_keys(), 0, q, freq, data)
    assert z[0, 0, 3] == 0 and z[0, 2, l + 5] == 0
    assert torch.isfinite(ll).all()
    assert float(qq.sum()) == float(zc.sum()) == 2.0 * float(valid.sum())
    assert torch.equal(zc, tfs.allele_counts(z, data.geno, data.site_valid,
                                             n_pops=k, max_alleles=a))


# K > 8: the kernel's run-time-K body.  (N, L, K, A, generic): packed and
# generic at A = 2, generic at A = 4.  The JAX kernel runs its affine path
# at every A = 2 panel, so the port's generic path at A = 2 is held against
# JAX's generic path, which it takes when P carries a third allele of zero
# weight (the allele codes never name it, so every w and prefix is the
# same).  Half the rows' q has three trailing zero columns, as in the
# padded K grid.
WIDE = {"packed-K9": (16, 40, 9, 2, False),
        "packed-K12": (14, 37, 12, 2, False),
        "packed-K32": (10, 24, 32, 2, False),
        "generic-A2-K9": (16, 40, 9, 2, True),
        "generic-A2-K12": (14, 37, 12, 2, True),
        "generic-A2-K32": (10, 24, 32, 2, True),
        "generic-K16": (12, 29, 16, 4, False),
        # bucket edges of the kernel's wide body (16 | 17), for the padding
        # test below
        "packed-K16": (12, 26, 16, 2, False),
        "packed-K17": (12, 26, 17, 2, False),
        "generic-A3-K17": (12, 27, 17, 3, False)}
N_ZERO = 3        # trailing zero-q columns of the padded rows


@functools.lru_cache(maxsize=None)
def _wide_inputs(name):
    n, l, k, a, generic = WIDE[name]
    rng = np.random.default_rng(23)
    n_alleles = (np.full(l, 2) if a == 2
                 else rng.integers(2, a + 1, size=l))
    n_alleles[0] = a
    geno = rng.integers(0, 1 << 30, size=(n, l, 2)) % n_alleles[None, :, None]
    missing = rng.random((n, l)) < 0.15
    jdata = jax_make_dataset(geno, missing, n_alleles.astype(np.int32))
    data = convert.dataset_from_numpy(
        {f: None if v is None else np.asarray(v)
         for f, v in jdata._asdict().items()})
    if generic:
        data = data._replace(bits2=None)
    assert tfs.is_packed(data) == (a == 2 and not generic)
    av = np.asarray(jdata.allele_valid, np.float64)
    freq = rng.dirichlet(np.ones(a), size=(k, l)) * av[None]
    freq = (freq / freq.sum(-1, keepdims=True)).astype(np.float32)
    q = rng.dirichlet(np.ones(k), size=n)
    q[: n // 2, k - N_ZERO:] = 0.0
    q = (q / q.sum(-1, keepdims=True)).astype(np.float32)
    jfreq = freq
    if generic and a == 2:
        jfreq = np.concatenate([freq, np.zeros_like(freq[..., :1])], -1)
    return dict(
        jdata=jdata, data=data, k=k, freq=freq, q=q,
        jfreq=jnp.asarray(jfreq), jbits2=None if generic else jdata.bits2,
        z=rng.integers(0, k, size=(n, 2 * l)).astype(np.int8),
        u=rng.uniform(1e-6, 1 - 1e-6, size=(n, 2 * l)).astype(np.float32),
        wg_pair=np.exp2(1.0 - rng.integers(1, 12, size=(n, 2))
                        ).astype(np.float32),
        f_pop=rng.uniform(0.02, 0.98, size=(k, 2)).astype(np.float32),
        f_ind=rng.uniform(0.02, 0.98, size=(n, 2)).astype(np.float32))


@pytest.fixture(scope="module",
                params=["packed-K9", "packed-K12", "packed-K32",
                        "generic-K16"])
def wide(request):
    """The panels whose every entry point is held against JAX's (the JAX
    kernel's generic path at K = 32 takes minutes to compile, so the
    generic A = 2 panels check the draw: test_wide_generic_a2_draw...)."""
    return _wide_inputs(request.param)


def _jax_site(x):
    """(positional panel args, keyword args) of the JAX entry points."""
    d = x["jdata"]
    return d.geno, d.site_valid, d.hom, dict(interpret=True, bits2=x["jbits2"])


def test_wide_sampling_passes_match_jax(wide):
    """K > 8, every sampling entry point: z, qqnum and zcounts exactly
    JAX's (``zq_sample_pass`` against the draw of JAX's mode-1 pass, the
    same uniforms), the log-lik columns to f32 rounding; z never selects a
    zero-q trailing slot."""
    x = wide
    geno, valid, hom, kw = _jax_site(x)
    q, u = jnp.asarray(x["q"]), jnp.asarray(x["u"])
    jf = x["jfreq"]
    base = (_keys(), 0, _b(x["q"]), _b(x["freq"]), x["data"])
    tu = dict(u=_b(x["u"]))
    jz, jqq, jll, jzc = jfs.zq_mode1_pass(0, q, jf, geno, valid, u=u, **kw)
    z, qq, zc = tfs.zq_sample_pass(*base, **tu)
    _same_draw(x, (z, qq, zc), (jz, jqq, jzc))
    n = x["q"].shape[0]
    assert int(z[0, : n // 2].max()) < x["k"] - N_ZERO
    z1, qq1, ll, zc1 = tfs.zq_mode1_pass(*base, **tu)
    _same_draw(x, (z1, qq1, zc1), (jz, jqq, jzc))
    _close(ll, jll)
    zold, wg = jnp.asarray(x["z"]), jnp.asarray(x["wg_pair"])
    jz, jqq, jll, jzc = jfs.zq_gen_pass(0, q, jf, geno, valid, hom, zold, wg,
                                        structure=True, u=u, **kw)
    zg, qqg, llg, zcg = tfs.zq_gen_pass(*base, _b(x["wg_pair"]),
                                        structure=True, **tu)
    _same_draw(x, (zg, qqg, zcg), (jz, jqq, jzc))
    _close(llg, jll)
    jz, jqq, jll, jzc = jfs.zq_gendiff_pass(0, q, jf, geno, valid, hom, zold,
                                            wg, structure=True, u=u, **kw)
    zd, qqd, lld, zcd = tfs.zq_gendiff_pass(*base, _b(x["wg_pair"]),
                                            structure=True, **tu)
    _same_draw(x, (zd, qqd, zcd), (jz, jqq, jzc))
    _close(lld, jll)
    for pop, f_pair in ((True, x["f_pop"]), (False, x["f_ind"])):
        jz, jqq, jll, jzc = jfs.zq_f_pass(0, q, jf, geno, valid, hom, zold,
                                          jnp.asarray(f_pair), pop=pop, u=u,
                                          **kw)
        zf, qqf, llf, zcf = tfs.zq_f_pass(*base, _b(f_pair), pop=pop, **tu)
        _same_draw(x, (zf, qqf, zcf), (jz, jqq, jzc))
        _close(llf, jll)
        assert llf.shape == ((1, n, x["k"]) if pop else (1, n))


def test_wide_stored_passes_match_jax(wide):
    """K > 8, every stored-step entry point at a carried z: the log-lik
    columns to f32 rounding.  XLA takes more than 15 minutes to compile JAX's
    per-pop F stored pass on its affine (packed) path from K = 12 on, so on
    the packed panels there the port's stored pass is held to JAX's generic
    path (a third allele of zero weight, as the generic-A2 panels do), and
    also to the JAX-checked sampling pass: at the z that pass drew, the
    stored pass at (proposed F) minus at (current F) is its MH sum."""
    x = wide
    geno, valid, hom, kw = _jax_site(x)
    jf, zc = x["jfreq"], jnp.asarray(x["z"])
    tf, tz = _b(x["freq"]), _b(x["z"])
    _close(tfs.panel_loglik_mode1_pass(tf, None, x["data"], tz),
           jfs.panel_loglik_mode1_pass(jf, jnp.asarray(x["q"]), geno, valid,
                                       zc, **kw))
    wg = x["wg_pair"][:, 0]
    _close(tfs.panel_loglik_pass(tf, _b(x["q"]), x["data"], tz, _b(wg),
                                 structure=True),
           jfs.panel_loglik_pass(jf, jnp.asarray(x["q"]), geno, valid, hom,
                                 zc, jnp.asarray(wg)[:, None],
                                 structure=True, **kw))
    for pop in (True, False):
        f = (x["f_pop"] if pop else x["f_ind"])[:, 0]
        got = tfs.panel_loglik_f_pass(tf, x["data"], tz, _b(f), pop=pop)
        affine = x["jbits2"] is not None and pop and x["k"] > 9
        jf_pass, kw_pass = jf, kw
        if affine:
            jf_pass = jnp.concatenate([jf, jnp.zeros_like(jf[..., :1])], -1)
            kw_pass = dict(kw, bits2=None)
        _close(got, jfs.panel_loglik_f_pass(jf_pass, geno, valid, hom, zc,
                                            jnp.asarray(f)[:, None], pop=pop,
                                            **kw_pass))
        if not affine:
            continue
        z, _, fdiff, _ = tfs.zq_f_pass(_keys(), 0, _b(x["q"]), tf, x["data"],
                                       _b(x["f_pop"]), pop=True,
                                       u=_b(x["u"]))
        cur, new = [tfs.panel_loglik_f_pass(tf, x["data"], z,
                                            _b(x["f_pop"][:, i]), pop=True)
                    for i in (0, 1)]
        np.testing.assert_allclose(fdiff.sum(dim=2).numpy(),
                                   (new - cur).numpy(), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", sorted(n for n in WIDE
                                         if n.startswith("generic-A2")))
def test_wide_generic_a2_draw_matches_jax(name):
    """K > 8, the generic path at A = 2: every sampling entry point draws
    JAX's z, qqnum and zcounts (JAX's generic ``zq_sample_pass``, the same
    uniforms), and z never selects a zero-q trailing slot."""
    x = _wide_inputs(name)
    geno, valid, _, kw = _jax_site(x)
    want = jfs.zq_sample_pass(0, jnp.asarray(x["q"]), x["jfreq"], geno,
                              valid, u=jnp.asarray(x["u"]), **kw)
    base = (_keys(), 0, _b(x["q"]), _b(x["freq"]), x["data"])
    tu = dict(u=_b(x["u"]))
    outs = [tfs.zq_sample_pass(*base, **tu),
            tfs.zq_mode1_pass(*base, **tu),
            tfs.zq_gen_pass(*base, _b(x["wg_pair"]), structure=True, **tu),
            tfs.zq_gendiff_pass(*base, _b(x["wg_pair"]), structure=True,
                                **tu),
            tfs.zq_f_pass(*base, _b(x["f_pop"]), pop=True, **tu),
            tfs.zq_f_pass(*base, _b(x["f_ind"]), pop=False, **tu)]
    for out in outs:
        _same_draw(x, (out[0], out[1], out[-1]), want)
        assert all(torch.isfinite(t).all() for t in out[2:-1])
    n = x["q"].shape[0]
    assert int(outs[0][0][0, : n // 2].max()) < x["k"] - N_ZERO


@pytest.mark.parametrize("name", ["packed-K12", "generic-A2-K9"])
def test_wide_expectation_way_matches_jax(name):
    """K > 8, the expectation way (``structure=False``: the Q mixture in
    place of P at z) of the G passes, sampling and stored-step."""
    x = _wide_inputs(name)
    geno, valid, hom, kw = _jax_site(x)
    q, jf = jnp.asarray(x["q"]), x["jfreq"]
    zold, wg = jnp.asarray(x["z"]), jnp.asarray(x["wg_pair"])
    jz, jqq, jll, jzc = jfs.zq_gendiff_pass(0, q, jf, geno, valid, hom, zold,
                                            wg, structure=False,
                                            u=jnp.asarray(x["u"]), **kw)
    z, qq, ll, zc = tfs.zq_gendiff_pass(_keys(), 0, _b(x["q"]),
                                        _b(x["freq"]), x["data"],
                                        _b(x["wg_pair"]), structure=False,
                                        u=_b(x["u"]))
    _same_draw(x, (z, qq, zc), (jz, jqq, jzc))
    _close(ll, jll)
    w0 = x["wg_pair"][:, 0]
    _close(tfs.panel_loglik_pass(_b(x["freq"]), _b(x["q"]), x["data"],
                                 _b(x["z"]), _b(w0), structure=False),
           jfs.panel_loglik_pass(jf, q, geno, valid, hom, zold,
                                 jnp.asarray(w0)[:, None], structure=False,
                                 **kw))


def test_wide_rerun_and_trailing_zero_q_never_drawn():
    """The plain version at K = 32 from Philox (no injected uniforms):
    reruns are bitwise equal, rows with trailing zero-q columns never draw
    those slots, and the counts are the plain ``allele_counts``."""
    x = _wide_inputs("packed-K32")
    d, k = x["data"], x["k"]
    keys = px.make_keys(5, 2, "cpu", chain_key=[3, 8])
    q = _b(x["q"]).expand(2, -1, -1).contiguous()
    f = _b(x["freq"]).expand(2, -1, -1, -1).contiguous()
    z, qq, zc = tfs.zq_sample_pass(keys, 9, q, f, d)
    again = tfs.zq_sample_pass(keys, 9, q, f, d)
    assert all(torch.equal(a, b) for a, b in zip((z, qq, zc), again))
    n = x["q"].shape[0]
    assert int(z[:, : n // 2].max()) < k - N_ZERO
    assert float(qq[:, : n // 2, k - N_ZERO:].abs().sum()) == 0.0
    assert torch.equal(zc, tfs.allele_counts(z, d.geno, d.site_valid,
                                             n_pops=k, max_alleles=2))


def test_site_pass_gate_is_k_times_a():
    """The wrappers run K * A <= 64 (the JAX step's gate) and refuse
    beyond, naming the bound; the plain versions run any K."""
    assert tfs.site_pass_fits(32, 2) and tfs.site_pass_fits(16, 4)
    assert not tfs.site_pass_fits(33, 2) and not tfs.site_pass_fits(9, 8)
    x = _wide_inputs("generic-K16")
    freq = _b(np.concatenate([x["freq"]] * 3, axis=0))      # K = 48, A = 4
    q = _b(np.concatenate([x["q"]] * 3, axis=1) / 3.0)
    with pytest.raises(ValueError, match="64"):
        tfs.zq_sample_pass(_keys(), 0, q, freq, x["data"])
    z, qq, zc = tfs.zq_sample_pass_reference(_keys(), 0, q, freq, x["data"])
    assert zc.shape == (1, 48, x["data"].n_loci, 4)


def _every_entry(x, q, freq, f_pop):
    """{name: outputs} of every entry point's plain version (sampling from
    the injected uniforms; the expectation way of the G passes too) at the
    given q, P and per-pop F pair."""
    d, keys = x["data"], _keys()
    u, wg, f_ind, z = _b(x["u"]), _b(x["wg_pair"]), _b(x["f_ind"]), _b(x["z"])
    out = {
        "sample": tfs.zq_sample_pass_reference(keys, 0, q, freq, d, u=u),
        "mode1": tfs.zq_mode1_pass_reference(keys, 0, q, freq, d, u=u),
        "fpop": tfs.zq_f_pass_reference(keys, 0, q, freq, d, f_pop, pop=True,
                                        u=u),
        "find": tfs.zq_f_pass_reference(keys, 0, q, freq, d, f_ind,
                                        pop=False, u=u),
        "loglik_mode1": (tfs.panel_loglik_mode1_pass_reference(freq, q, d,
                                                               z),),
        "loglik_fpop": (tfs.panel_loglik_f_pass_reference(
            freq, d, z, f_pop[:, :, 0], pop=True),),
        "loglik_find": (tfs.panel_loglik_f_pass_reference(
            freq, d, z, f_ind[:, :, 0], pop=False),)}
    for st in (True, False):
        out[f"gen {st}"] = tfs.zq_gen_pass_reference(keys, 0, q, freq, d, wg,
                                                     structure=st, u=u)
        out[f"gendiff {st}"] = tfs.zq_gendiff_pass_reference(
            keys, 0, q, freq, d, wg, structure=st, u=u)
        out[f"loglik {st}"] = (tfs.panel_loglik_pass_reference(
            freq, q, d, z, wg[:, :, 0], structure=st),)
    return out


@pytest.mark.parametrize("name", ["packed-K9", "packed-K12", "packed-K16",
                                  "packed-K17", "packed-K32", "generic-A2-K9",
                                  "generic-A2-K12", "generic-A2-K32",
                                  "generic-K16", "generic-A3-K17"])
def test_zero_pops_up_to_a_bucket_change_nothing(name):
    """What the kernel's wide body relies on: q and P padded with zero pops
    up to K rounded to 2 (and 4) and up to every pop bucket at or above K
    give, in
    the plain version of every entry point, bitwise the native z, and the
    native qqnum, zcounts and per-pop F sums in the first K slots (zero
    past them), and the native log-liks."""
    x = _wide_inputs(name)
    k = x["k"]
    q, freq, f_pop = _b(x["q"]), _b(x["freq"]), _b(x["f_pop"])
    want = _every_entry(x, q, freq, f_pop)
    widths = {-(-k // r) * r for r in (2, 4)} | {b for b in tfs.WIDE_BUCKETS
                                                 if b >= k}
    for w in sorted(widths - {k}):
        pad = w - k
        got = _every_entry(
            x, torch.nn.functional.pad(q, (0, pad)),
            torch.nn.functional.pad(freq, (0, 0, 0, 0, 0, pad)),
            torch.cat([f_pop, torch.full((1, pad, 2), 0.5)], dim=1))
        for entry, outs in want.items():
            for i, (a, b) in enumerate(zip(outs, got[entry])):
                tag = f"{entry} output {i} at {w} pops"
                if b.dim() >= 3 and b.shape[-1] == w:        # qqnum, fdiff
                    assert torch.equal(b[..., :k], a), tag
                    assert not b[..., k:].any(), tag
                elif b.dim() == 4:                            # zcounts
                    assert torch.equal(b[:, :k], a), tag
                    assert not b[:, k:].any(), tag
                else:
                    assert torch.equal(b, a), tag


@pytest.mark.parametrize("packed", [True, False])
def test_wide_launch_plan_fits_the_card(packed):
    """The wide body's launch plan for every 8 < K <= 32 with K * A <= 64,
    every family, sampling and stored passes (both ways), at several call
    shapes: a
    bucket that holds K, a block's shared memory (dynamic and static)
    within the H100's 232,448 bytes, strips that cover the rows with at
    most 64 rows each (the byte counts take 127)."""
    shapes = [(40, 1000, 10_000), (4, 1000, 10_000), (4, 1000, 2000),
              (1, 7, 9), (3, 130_000, 600)]
    kinds = [(True, f) for f in ("none", "mode1", "gen", "gendiff", "find",
                                 "fpop")]
    kinds += [(False, f) for f in ("mode1", "gen", "find", "fpop")]
    n_plans = 0
    for a in ([2] if packed else range(2, 8)):
        for k in range(9, 33):
            if k * a > 64:
                continue
            for sample, fam in kinds:
                for (c, n, l), st in itertools.product(shapes,
                                                       (True, False)):
                    p = tfs.site_plan(c, n, l, k, a, packed=packed,
                                      sample=sample, ll_kind=fam,
                                      structure=st)
                    assert p.bucket in tfs.WIDE_BUCKETS and k <= p.bucket
                    assert p.dyn_smem + p.static_smem <= tfs.SMEM_LIMIT
                    assert p.strips * p.strip_rows >= n
                    assert (p.strips - 1) * p.strip_rows < n
                    assert p.strip_rows <= tfs.WIDE_STRIP_ROWS
                    n_plans += 1
    assert n_plans > 0
    with pytest.raises(ValueError, match="64"):
        tfs.site_plan(4, 100, 100, 9, 8, packed=False, sample=True,
                      ll_kind="none")
