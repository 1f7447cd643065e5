"""The G-marginalized site log-likelihood curve of the gradient samplers
(``instruct_tpu_torch/kernels/gen_curve.py``) on the CPU, where its wrapper
runs the plain versions: the forward curve and the explicit backward pass
against the JAX package's ``MarginalModel.log_lik`` expression
(``instruct_tpu/samplers/potential.py:119-128``) and ``jax.vjp`` /
``jax.value_and_grad`` on the same parameters (carried across with
``convert.marginal_params_from_numpy``), in modes 2 and 3, several seeds,
panels with missing sites; and against torch autograd of the dense
``[B, N, L, G]`` formula in float64, clip included.

Tolerances: float32 against JAX, rtol 2e-5 of each output's largest
magnitude (sums of ~10^2 logs in another order); float64 against the
dense autograd, 1e-10."""

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


def test_dp_pass_strips_cover_the_individuals_once():
    """The dP pass's plan (``col_strips``, mirrored by the kernel's
    ``gen_curve_strip_rows``, which the card checks): strips of at least
    ``STRIP_MIN`` rows (one strip below that), at most ``MAX_STRIPS``, no
    empty strip."""
    for n in list(range(1, 300)) + [1000, 1023, 1024, 1025, 5000, 10 ** 5]:
        rows, strips = gc.col_strips(n)
        assert 1 <= strips <= gc.MAX_STRIPS
        assert rows * strips >= n > rows * (strips - 1)
        assert rows >= min(n, gc.STRIP_MIN)
    assert gc.col_strips(1000) == (67, 15) and gc.col_strips(40) == (40, 1)


def test_kernel_limits_are_checked_before_any_launch():
    _, data = panels(7, n=4, l=5, k=2)
    q = torch.full((1, 4, 2), 0.5)
    p = torch.full((1, 2, 5, 2), 0.5)
    for cap in (0, gc.MAX_GEN + 1):
        with pytest.raises(ValueError, match="generations"):
            gc._check(q, p, data, cap)
    wide = torch.full((1, 4, gc.MAX_POPS + 1), 0.1)
    with pytest.raises(ValueError, match="pops"):
        gc._check(wide, p, data, 50)
    # a CPU tensor is refused by the launch path (no quiet plain version)
    with pytest.raises(ValueError, match="CUDA"):
        gc._check(q, p, data, 50)
