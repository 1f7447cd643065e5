"""The G-marginalized site log-likelihood curve of the gradient samplers
(``instruct_tpu_torch/kernels/gen_curve.py``) on the CPU, where its wrapper
runs the plain versions: the forward curve and the explicit backward pass
against the JAX package's ``MarginalModel.log_lik`` expression
(``instruct_tpu/samplers/potential.py:119-128``) and ``jax.vjp`` /
``jax.value_and_grad`` on the same parameters (carried across with
``convert.marginal_params_from_numpy``), in modes 2 and 3, several seeds,
panels with missing sites; and against torch autograd of the dense
``[B, N, L, G]`` formula in float64, clip included.  A float64 emulation
of the CUDA kernel's own algebra (``csrc/gen_curve.cu``: the products of
the exact generation indices over a lane's chunk of sites, the power-sum
tail forward, the per-row cubic backward, the clip path g by g), held
against JAX's dense curve and ``jax.vjp`` at G = 1, 8, 9, 50 and 64, and the
backward pass's tile plan.

Tolerances: float32 against JAX, rtol 2e-5 of each output's largest
magnitude (sums of ~10^2 logs in another order; the kernel's series are
truncated below 2^-32 of a term); float64 against the dense autograd,
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JSpec
from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.model import likelihood as jlk
from instruct_tpu.samplers.potential import MarginalModel as JModel

from instruct_tpu_torch import ModelSpec, convert
from instruct_tpu_torch.kernels import gen_curve as gc
from instruct_tpu_torch.samplers import tree as tr
from instruct_tpu_torch.samplers.potential import MarginalModel

RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(obj):
    return {k: None if v is None else np.asarray(v)
            for k, v in obj._asdict().items()}


def panels(seed, n=14, l=25, k=3, a=2):
    jp = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=a,
                   selfing_rates=np.linspace(0.1, 0.8, k),
                   missing_rate=0.15, seed=seed)
    return jp.data, convert.dataset_from_numpy(fields(jp.data))


def jax_params(jmodel, seed, b=2, scale=10.0):
    """b stacked JAX inits, scaled so that P and Q spread out."""
    keys = jax.random.split(jax.random.key(seed), b)
    return jax.tree.map(lambda x: scale * x, jax.vmap(jmodel.init)(keys))


def jax_per_gen(jmodel, params):
    """potential.py:113-128 for one chain: the dense [N, L, G] curve."""
    data = jmodel.data
    p, q, _s, _a = jmodel.constrain(params)
    m0, m1 = jlk.split_copies(jlk.mixture_copy_probs(p, data, q), data.ploid)
    gens = jnp.arange(1, jmodel.gen_cap + 1, dtype=jnp.float32)
    w = jnp.exp2(1.0 - gens)
    gf = jnp.where(data.hom[..., None],
                   m0[..., None] * m0[..., None]
                   + m0[..., None] * (1 - m0[..., None]) * (1 - w),
                   2.0 * m0[..., None] * m1[..., None] * w)
    site = jnp.log(jnp.maximum(gf, 1e-30))
    return jnp.where(data.site_valid[..., None], site, 0.0).sum(1)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("mode", [2, 3])
@pytest.mark.parametrize("seed,n_alleles", [(0, 2), (1, 2), (2, 3)])
def test_curve_and_gradients_match_jax(mode, seed, n_alleles):
    jdata, data = panels(seed, a=n_alleles)
    jmodel = JModel(JSpec(mode=mode, n_pops=3), jdata)
    model = MarginalModel(ModelSpec(mode=mode, n_pops=3), data)
    jparams = jax_params(jmodel, seed)
    params = convert.marginal_params_from_numpy(fields(jparams))
    p, q, _s, _a = model.constrain(params)

    # the forward curve
    got = gc.gen_curve_reference(q, p, data, model.gen_cap)
    want = jax.vmap(lambda pr: jax_per_gen(jmodel, pr))(jparams)
    assert got.shape == (2, 14, 50)
    assert_close(got.numpy(), want)

    # the explicit backward against jax.vjp of the curve in (P, Q)
    dper = np.random.default_rng(seed).normal(size=got.shape).astype(
        np.float32)
    dq, dp = gc.gen_curve_backward_reference(q, p, data, model.gen_cap,
                                             torch.from_numpy(dper))

    def curve_of(pq):
        pp, qq = pq
        m0, m1 = jlk.split_copies(jlk.mixture_copy_probs(pp, jdata, qq), 2)
        gens = jnp.arange(1, 51, dtype=jnp.float32)
        w = jnp.exp2(1.0 - gens)
        gf = jnp.where(jdata.hom[..., None],
                       m0[..., None] * m0[..., None]
                       + m0[..., None] * (1 - m0[..., None]) * (1 - w),
                       2.0 * m0[..., None] * m1[..., None] * w)
        site = jnp.log(jnp.maximum(gf, 1e-30))
        return jnp.where(jdata.site_valid[..., None], site, 0.0).sum(1)

    for b in range(2):
        _, vjp = jax.vjp(curve_of, (jnp.asarray(p[b].numpy()),
                                    jnp.asarray(q[b].numpy())))
        (jdp, jdq), = vjp(jnp.asarray(dper[b]))
        assert_close(dq[b].numpy(), jdq)
        assert_close(dp[b].numpy(), jdp)

    # log_lik and its gradient in the unconstrained parameters
    vals, grads = tr.value_and_grad(model.log_lik)(params)
    jvals, jgrads = jax.vmap(jax.value_and_grad(jmodel.log_lik))(jparams)
    assert_close(vals.numpy(), jvals, 1e-6)
    for name, g in zip(params._fields, grads):
        assert_close(g.numpy(), getattr(jgrads, name))


@pytest.mark.parametrize("k,gen_cap", [(33, 65), (64, 50), (3, 200)])
def test_wide_k_and_long_g_match_jax(k, gen_cap):
    """Past the kernel's former limits (K <= 32, gen_cap <= 64), which the
    JAX potential never had: on a tiny panel the plain curve and the
    autograd gradient of ``log_lik`` agree with JAX's
    ``MarginalModel.log_lik`` and ``value_and_grad`` (mode 2), and the
    kernel's shape check takes the shape."""
    jdata, data = panels(k + gen_cap, n=6, l=9, k=3)
    spec_kw = dict(mode=2, n_pops=k, gen_cap=gen_cap)
    jmodel = JModel(JSpec(**spec_kw), jdata)
    model = MarginalModel(ModelSpec(**spec_kw), data)
    jparams = jax_params(jmodel, k, scale=3.0)
    params = convert.marginal_params_from_numpy(fields(jparams))
    p, q, _s, _a = model.constrain(params)
    got = gc.gen_curve_reference(q, p, data, gen_cap)
    assert got.shape == (2, 6, gen_cap)
    assert_close(got.numpy(),
                 jax.vmap(lambda pr: jax_per_gen(jmodel, pr))(jparams))
    vals, grads = tr.value_and_grad(model.log_lik)(params)
    jvals, jgrads = jax.vmap(jax.value_and_grad(jmodel.log_lik))(jparams)
    assert_close(vals.numpy(), jvals, 1e-6)
    for name, g in zip(params._fields, grads):
        assert_close(g.numpy(), getattr(jgrads, name))
    with pytest.raises(ValueError, match="CUDA"):
        gc._check(q, p, data, gen_cap)


def dense_curve(q, p, data, gen_cap):
    """The dense [B, N, L, G] formula, differentiable by torch autograd."""
    l = data.n_loci
    m = 0.0
    for k, pk in enumerate(gc.per_pop_copy_probs(p, data)):
        m = m + q[:, :, k, None] * pk
    m0, m1 = m[..., :l, None], m[..., l:, None]
    w = gc.gen_weights(gen_cap, "cpu").to(q.dtype)
    gf = torch.where(data.hom[None, ..., None],
                     m0 * m0 + m0 * (1 - m0) * (1 - w), 2.0 * m0 * m1 * w)
    site = torch.log(torch.clamp_min(gf, 1e-30))
    return torch.where(data.site_valid[None, ..., None], site,
                       torch.zeros((), dtype=q.dtype)).sum(2)


@pytest.mark.parametrize("seed,gen_cap", [(3, 50), (4, 1), (5, 64)])
def test_backward_matches_dense_autograd_in_float64(seed, gen_cap):
    _, data = panels(seed, n=9, l=17, k=2, a=3)
    rng = np.random.default_rng(seed)
    b, k, a = 3, 2, data.max_alleles
    q = torch.softmax(torch.from_numpy(rng.normal(size=(b, 9, k))), -1)
    logits = torch.from_numpy(rng.normal(size=(b, k, 17, a)) * 3)
    # one locus nearly fixed: tiny P, so 2 m0 m1 w_g falls under the clip
    # at large g (the clip binds and its gradient is zero)
    logits[:, :, 4, 1:] -= 30.0
    p = torch.softmax(logits, -1)
    q.requires_grad_(True)
    p.requires_grad_(True)
    dense = dense_curve(q, p, data, gen_cap)
    dper = torch.from_numpy(rng.normal(size=dense.shape))
    want_q, want_p = torch.autograd.grad(dense, (q, p), dper)
    with torch.no_grad():
        got = gc.gen_curve_reference(q, p, data, gen_cap)
        dq, dp = gc.gen_curve_backward_reference(q, p, data, gen_cap, dper)
    torch.testing.assert_close(got, dense.detach(), rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(dq, want_q, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dp, want_p, rtol=1e-10, atol=1e-10)
    if gen_cap == 64:
        t = 2.0 * p[:, 0, 4, 1] ** 2
        assert bool((t * 2.0 ** -63 < 1e-30).any())   # the clip binds


def test_autograd_function_runs_the_plain_versions_on_the_cpu():
    _, data = panels(6, n=8, l=12, k=2)
    rng = np.random.default_rng(6)
    q = torch.softmax(torch.from_numpy(
        rng.normal(size=(2, 8, 2)).astype(np.float32)), -1)
    p = torch.softmax(torch.from_numpy(
        rng.normal(size=(2, 2, 12, 2)).astype(np.float32)), -1)
    qg, pg = q.clone().requires_grad_(True), p.clone().requires_grad_(True)
    out = gc.gen_curve(qg, pg, data, 50)
    assert torch.equal(out.detach(), gc.gen_curve_reference(q, p, data, 50))
    dper = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(dper)
    dq, dp = gc.gen_curve_backward_reference(q, p, data, 50, dper)
    assert torch.equal(qg.grad, dq) and torch.equal(pg.grad, dp)


def test_g_chunks_cover_the_generations_once():
    assert gc._g_chunks(10, 50) == [(0, 50)]
    big = gc._g_chunks(4 * 1000 * 10_000, 50)
    assert big == [(g, g + 1) for g in range(50)]
    mid = gc._g_chunks(gc._CHUNK_ELEMS // 7, 20)
    assert [hi - lo for lo, hi in mid] == [7, 7, 6]


def test_bwd_tile_plan_covers_every_individual_and_site_once():
    """The backward pass's plan (``bwd_plan``, mirrored by the kernel's
    ``gen_curve_bwd_plan``, which the card checks): the blocks' tiles of
    ``BWD_INDV`` individuals and segments of ``SEGMENT`` chunks of ``TILE``
    sites, each ragged edge cut as the kernel cuts it (``min(BWD_INDV, N -
    n0)``, ``min(chunks, c0 + SEGMENT)``, ``min(TILE, L - l0)``), cover
    every individual and every site once;
    P is staged when K * A <= ``STAGE_CELLS``; every (K, A) the kernel
    takes fits a block's shared memory (232 448 bytes)."""
    for n in list(range(1, 70)) + [255, 256, 257, 1000, 1023, 5000]:
        for l in (1, 31, 255, 256, 257, 1001, 10_000):
            plan = gc.bwd_plan(n, l, 3, 2)
            rows = [t * plan["indv"] + i for t in range(plan["tiles"])
                    for i in range(min(plan["indv"], n - t * plan["indv"]))]
            seg = plan["segment"]
            sites = [c * gc.TILE + j
                     for s in range(-(-plan["chunks"] // seg))
                     for c in range(s * seg, min(plan["chunks"],
                                                 (s + 1) * seg))
                     for j in range(min(gc.TILE, l - c * gc.TILE))]
            assert rows == list(range(n)) and sites == list(range(l))
    for k in range(1, gc.MAX_POPS + 1):
        for a in range(1, gc.MAX_ALLELES + 1):
            plan = gc.bwd_plan(10, 10, k, a)
            assert plan["stage"] == (k * a <= gc.STAGE_CELLS)
            assert plan["smem"] <= 232_448
    assert gc.bwd_plan(1000, 10_000, 3, 2) == dict(
        indv=16, tiles=63, chunks=40, segment=4, stage=True, smem=72_896)


def kernel_emulation(q, p, geno, hom, valid, gen_cap, dper):
    """float64 numpy emulation of ``csrc/gen_curve.cu``'s algebra:
    per_gen [B, N, G] and (dq [B, N, K], dp [B, K, L, A]) given ``dper``.
    Forward: fast homozygous sites (m0 >= 1e-14) as log m0 + log(1 - u
    w_g), u = 1 - m0, the indices 1..7 as logs of the products over a
    lane's sites of a chunk (sites c * 256 + j * 32 + lane, j = 0..7), from
    index 8 on the tail -sum_j w^j S_j / j of the power sums S_j = sum u^j;
    fast heterozygous sites (2 m0 m1 w_G > 1e-30) as log(2 m0 m1) - g log 2;
    the rest JAX's form and clip g by g.  Backward: fast homozygous dm0 =
    (dsum + d_0) / m0 + sum_{g=1..7} d_g w_g / (1 - u w_g) + the cubic
    c_0 + u (c_1 + u (c_2 + u c_3)), c_j = sum_{g >= 8} d_g w_g^(j+1);
    heterozygous dm_c = (sum of d_g over the unclipped g) / m_c; the rest
    JAX's form g by g, zero where the clip binds."""
    q, p = np.asarray(q, np.float64), np.asarray(p, np.float64)
    d = np.asarray(dper, np.float64)
    b, n, k = q.shape
    l, a_max = hom.shape[1], p.shape[3]
    g_all = np.arange(gen_cap)
    w = 2.0 ** -g_all
    x0 = np.clip(geno[:, :l], 0, a_max - 1)
    x1 = np.clip(geno[:, l:], 0, a_max - 1)
    sites = np.arange(l)[None, :]
    pk0, pk1 = p[:, :, sites, x0], p[:, :, sites, x1]      # [B, K, N, L]
    m0 = np.einsum("bnk,bknl->bnl", q, pk0)
    m1 = np.einsum("bnk,bknl->bnl", q, pk1)
    t = 2.0 * m0 * m1
    fast_h = valid & hom & (m0 >= 1e-14)
    slow_h = valid & hom & ~fast_h
    fast_e = valid & ~hom & (t * w[-1] > 1e-30)
    slow_e = valid & ~hom & ~fast_e
    u = np.where(fast_h, 1.0 - m0, 0.0)
    # forward
    lm = np.where(fast_h, np.log(np.where(fast_h, m0, 1.0)), 0.0).sum(-1)
    lt = np.where(fast_e, np.log(np.where(fast_e, t, 1.0)), 0.0).sum(-1)
    cnt = fast_e.sum(-1)
    chunks = -(-l // 256)
    per_gen = np.empty((b, n, gen_cap))
    for g in range(gen_cap):
        if g == 0:
            f = lm
        elif g < 8:
            fac = np.ones((b, n, chunks * 256))
            fac[..., :l] = np.where(fast_h, 1.0 - u * w[g], 1.0)
            prods = fac.reshape(b, n, chunks, 8, 32).prod(3)
            f = np.log(prods).sum((-1, -2))
        else:
            f = -sum(w[g] ** j * (u ** j).sum(-1) / j for j in range(1, 5))
        with np.errstate(divide="ignore"):
            slow = np.where(
                slow_h, np.log(np.maximum(m0 * m0 + m0 * (1 - m0)
                                          * (1 - w[g]), 1e-30)), 0.0)
            slow += np.where(slow_e, np.where(
                t * w[g] >= 1e-30, np.log(np.where(slow_e, t, 1.0))
                - g * np.log(2.0), np.log(1e-30)), 0.0)
        per_gen[..., g] = f + slow.sum(-1) + lm + lt - g * np.log(2.0) * cnt
    # backward: the rows' coefficients, then dm_c
    dsum = d.sum(-1)
    ex = d[..., 1:8] * w[1:8]
    cj = [(d[..., 8:] * w[8:] ** (j + 1)).sum(-1) for j in range(4)]
    with np.errstate(divide="ignore", invalid="ignore"):
        dm_fast = ((dsum + d[..., 0])[..., None] / m0
                   + (ex[:, :, None, :]
                      / (1.0 - u[..., None] * w[None, None, None, 1:8])
                      ).sum(-1)
                   + (cj[0][..., None] + u * (cj[1][..., None] + u * (
                       cj[2][..., None] + u * cj[3][..., None]))))
        gf = (m0[..., None] ** 2 + m0[..., None] * (1 - m0[..., None])
              * (1 - w))
        num = 2.0 * m0[..., None] * w + (1 - w)
        dm_slow = np.where(gf > 1e-30, d[:, :, None, :] * num / gf,
                           0.0).sum(-1)
        s_het = np.where(fast_e, dsum[..., None], np.where(
            t[..., None] * w > 1e-30, d[:, :, None, :], 0.0).sum(-1))
        dm0 = np.where(fast_h, dm_fast, np.where(slow_h, dm_slow, 0.0))
        dm0 = np.where(valid & ~hom, np.where(s_het != 0, s_het / m0, 0.0),
                       dm0)
        dm1 = np.where(valid & ~hom, np.where(s_het != 0, s_het / m1, 0.0),
                       0.0)
    dq = (np.einsum("bnl,bknl->bnk", dm0, pk0)
          + np.einsum("bnl,bknl->bnk", dm1, pk1))
    dp = np.zeros_like(p)
    for al in range(a_max):
        c = (np.where(geno[:, :l] == al, dm0, 0.0)
             + np.where(geno[:, l:] == al, dm1, 0.0))
        dp[..., al] = np.einsum("bnk,bnl->bkl", q, c)
    return per_gen, dq, dp


def jax_curve(jdata, gen_cap):
    """JAX's dense [N, L, G] curve of one row (potential.py:119-128) as a
    function of (P, Q)."""
    def curve(pq):
        pp, qq = pq
        m0, m1 = jlk.split_copies(jlk.mixture_copy_probs(pp, jdata, qq), 2)
        w = jnp.exp2(1.0 - jnp.arange(1, gen_cap + 1, dtype=jnp.float32))
        gf = jnp.where(jdata.hom[..., None],
                       m0[..., None] * m0[..., None]
                       + m0[..., None] * (1 - m0[..., None]) * (1 - w),
                       2.0 * m0[..., None] * m1[..., None] * w)
        site = jnp.log(jnp.maximum(gf, 1e-30))
        return jnp.where(jdata.site_valid[..., None], site, 0.0).sum(1)
    return curve


@pytest.mark.parametrize("gen_cap", [1, 8, 9, 50, 64, 65, 200])
def test_kernel_algebra_matches_jax(gen_cap):
    """The kernel's fast-path algebra (``kernel_emulation``) against JAX's
    dense curve and ``jax.vjp`` on a panel of 20 x 300 (two chunks, the
    second ragged) from a numpy seed, with two loci whose allele 1 is
    nearly absent so that the clip paths run: P = e^-42 (m0 < 1e-14 at
    its homozygous sites, gf clipped at g = 1 only; 2 m0 m1 w_G below 1e-30
    from G = 50 on) and P = e^-80 (every g clipped: a zero gradient).
    rtol 2e-5 of each output's largest magnitude (JAX's float32 sums)."""
    jdata, data = panels(10 + gen_cap, n=20, l=300, k=3, a=2)
    rng = np.random.default_rng(gen_cap)
    b, k = 2, 3
    geno = data.geno.numpy().astype(np.int64)
    hom, valid = data.hom.numpy(), data.site_valid.numpy()
    # loci with a valid homozygous site of allele 1 and a heterozygous one
    both = ((valid & hom & (geno[:, :300] == 1)).any(0)
            & (valid & ~hom).any(0)).nonzero()[0]
    q = softmax(rng.normal(size=(b, 20, k)) * 1.5).astype(np.float32)
    logits = rng.normal(size=(b, k, 300, 2)) * 1.5
    logits[:, :, both[0], 1] -= 42.0
    logits[:, :, both[1], 1] -= 80.0
    p = softmax(logits).astype(np.float32)
    dper = rng.normal(size=(b, 20, gen_cap)).astype(np.float32)
    got, dq, dp = kernel_emulation(q, p, geno, hom, valid, gen_cap, dper)
    curve = jax_curve(jdata, gen_cap)
    for r in range(b):
        want, vjp = jax.vjp(curve, (jnp.asarray(p[r]), jnp.asarray(q[r])))
        assert_close(got[r], want)
        (jdp, jdq), = vjp(jnp.asarray(dper[r]))
        assert_close(dq[r], jdq)
        assert_close(dp[r], jdp)


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_kernel_limits_are_checked_before_any_launch():
    """The kernel takes any number of generations and any K whose
    backward block fits shared memory (``MAX_POPS``); what it refuses is
    refused before a launch.  A shape it takes reaches the device check,
    which refuses a CPU tensor."""
    _, data = panels(7, n=4, l=5, k=2)
    q = torch.full((1, 4, 2), 0.5)
    p = torch.full((1, 2, 5, 2), 0.5)
    with pytest.raises(ValueError, match="generations"):
        gc._check(q, p, data, 0)
    for cap in (64, 65, 200):
        with pytest.raises(ValueError, match="CUDA"):
            gc._check(q, p, data, cap)
    for k in (33, 64, gc.MAX_POPS):
        with pytest.raises(ValueError, match="CUDA"):
            gc._check(torch.full((1, 4, k), 1.0 / k),
                      torch.full((1, k, 5, 2), 0.5), data, 50)
    assert gc.bwd_plan(4, 5, gc.MAX_POPS, 2)["smem"] == 232_448
    wide = torch.full((1, 4, gc.MAX_POPS + 1), 0.1)
    with pytest.raises(ValueError, match="pops"):
        gc._check(wide, p, data, 50)
    rows = torch.full((gc.MAX_ROWS + 1, 1, 1), 1.0).expand(-1, 4, 2)
    with pytest.raises(ValueError, match="rows"):
        gc._check(rows, p, data, 50)
    # a CPU tensor is refused by the launch path (no quiet plain version)
    with pytest.raises(ValueError, match="CUDA"):
        gc._check(q, p, data, 50)
