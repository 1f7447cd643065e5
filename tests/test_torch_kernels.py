"""The port's kernel modules (plain PyTorch versions, CPU) against the JAX
package's Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both sides together
with the same injected uniforms, so every discrete output (z, counts,
proposed generations) must agree exactly and every float to f32 rounding.
Where an exact check could fail only at a knife-edge of a threshold test,
the test asserts that the margin there is within float tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.data.synthetic import synthetic_panel as jax_panel
from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.kernels import fused_step as jfs
from instruct_tpu.kernels.s_pop_pallas import s_pop_tail as jax_s_pop_tail

from instruct_tpu_torch import convert
from instruct_tpu_torch.data.dataset import packed_dataset
from instruct_tpu_torch.kernels import dirichlet as tdp
from instruct_tpu_torch.kernels import fused_step as tfs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import s_pop as tsp


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _keys(c=1):
    return px.make_keys(7, c, "cpu")


def _tdata(jdata):
    """The port's Dataset of a JAX Dataset."""
    return convert.dataset_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in jdata._asdict().items()})


@pytest.fixture(scope="module", params=[(17, 23, 3), (9, 300, 2),
                                        (40, 130, 3)])
def setup(request):
    n, l, k = request.param
    panel = jax_panel(n_indv=n, n_loci=l, n_pops=k, n_alleles=2,
                      missing_rate=0.15, seed=5)
    data = panel.data
    assert data.bits2 is not None
    rng = np.random.default_rng(0)
    freq = rng.dirichlet(np.ones(2), size=(k, l)).astype(np.float32)
    q = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    z = rng.integers(0, k, size=data.geno.shape).astype(np.int8)
    gen = rng.integers(1, 12, size=n).astype(np.int32)
    gen_prop = rng.integers(1, 12, size=n).astype(np.int32)
    u = rng.uniform(1e-6, 1 - 1e-6, size=data.geno.shape).astype(np.float32)
    return data, freq, q, z, gen, gen_prop, u, k


def test_allele_counts_matches_jax(setup):
    data, freq, q, z, gen, gen_prop, u, k = setup
    want = np.asarray(jfs.allele_counts(
        jnp.asarray(z), data.geno, data.site_valid, n_pops=k, max_alleles=2,
        interpret=True))
    got = tfs.allele_counts(_t(z)[None], _t(data.geno), _t(data.site_valid),
                            n_pops=k, max_alleles=2, bits2=_t(data.bits2))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("structure", [True, False])
def test_zq_gendiff_pass_matches_jax(setup, structure):
    data, freq, q, z_old, gen, gen_prop, u, k = setup
    wg_pair = np.exp2(1.0 - np.stack([gen, gen_prop], 1).astype(np.float32))
    jz, jqq, jll, jzc = jfs.zq_gendiff_pass(
        0, jnp.asarray(q), jnp.asarray(freq), data.geno, data.site_valid,
        data.hom, jnp.asarray(z_old), jnp.asarray(wg_pair),
        structure=structure, interpret=True, u=jnp.asarray(u),
        bits2=data.bits2)
    z, qq, ll, zc = tfs.zq_gendiff_pass(
        _keys(), 0, _t(q)[None], _t(freq)[None], _tdata(data),
        _t(wg_pair)[None], structure=structure, u=_t(u)[None])
    assert z.dtype == torch.int8
    np.testing.assert_array_equal(z[0].numpy(), np.asarray(jz))
    np.testing.assert_array_equal(qq[0].numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(zc[0].numpy(), np.asarray(jzc))
    # f32 sums over L in another order than the Pallas blocks'
    np.testing.assert_allclose(ll[0].numpy(), np.asarray(jll), rtol=1e-5,
                               atol=1e-4)
    # the invariants of the counts
    nvalid = 2.0 * np.asarray(data.site_valid).sum()
    assert float(qq.sum()) == float(zc.sum()) == nvalid


@pytest.mark.parametrize("structure", [True, False])
def test_panel_loglik_pass_matches_jax(setup, structure):
    data, freq, q, z, gen, gen_prop, u, k = setup
    wg = np.exp2(1.0 - gen.astype(np.float32))
    want = jfs.panel_loglik_pass(
        jnp.asarray(freq), jnp.asarray(q), data.geno, data.site_valid,
        data.hom, jnp.asarray(z), jnp.asarray(wg)[:, None],
        structure=structure, interpret=True, bits2=data.bits2)
    got = tfs.panel_loglik_pass(_t(freq)[None], _t(q)[None], _tdata(data),
                                _t(z)[None], _t(wg)[None],
                                structure=structure)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_site_pass_refuses_unpacked_panel():
    """An unpacked panel is no longer refused: it runs the generic path,
    which carries the allele-pop counts as the packed one does.  What the
    site pass does refuse is a panel that does not fit ``freq``, and a
    model beyond K * A <= 64 (the JAX step's gate)."""
    rng = np.random.default_rng(2)
    data = packed_dataset(_t(rng.integers(0, 8, (4, 5)).astype(np.int8)))
    q = torch.full((1, 4, 2), 0.5)
    freq = torch.full((1, 2, 5, 2), 0.5)
    wg = torch.ones(1, 4, 2)
    z, qq, ll, zc = tfs.zq_gendiff_pass(_keys(), 0, q, freq,
                                        data._replace(bits2=None), wg,
                                        structure=True)
    assert zc.shape == (1, 2, 5, 2) and z.shape == (1, 4, 10)
    assert ll.shape == (1, 4)
    assert tfs.zq_gendiff_pass(_keys(), 0, q, freq, data, wg,
                               structure=True)[3].shape == (1, 2, 5, 2)
    with pytest.raises(ValueError, match="does not fit"):
        tfs.zq_gendiff_pass(_keys(), 0, q, torch.full((1, 2, 5, 3), 1 / 3),
                            data, wg, structure=True)
    with pytest.raises(ValueError, match="n_pops \\* n_alleles <= 64"):
        tfs.zq_sample_pass(_keys(), 0, torch.full((1, 4, 33), 1 / 33),
                           torch.full((1, 33, 5, 2), 0.5), data)


def test_site_pass_chains_are_independent_streams():
    """Each chain of the written-out chain axis draws from its own Philox
    stream: same inputs, different chain keys, different z; same key, same
    z."""
    rng = np.random.default_rng(1)
    n, l, k = 12, 40, 3
    bits2 = _t(rng.integers(0, 8, (n, l)).astype(np.int8))
    data = packed_dataset(bits2)
    q = _t(rng.dirichlet(np.ones(k), size=n).astype(np.float32))
    freq = _t(rng.dirichlet(np.ones(2), size=(k, l)).astype(np.float32))
    wg = torch.ones(n, 2)
    keys = px.make_keys(3, 3, "cpu", chain_key=[5, 9, 5])
    z, qq, _, zc = tfs.zq_gendiff_pass(
        keys, 4, q.expand(3, n, k).contiguous(),
        freq.expand(3, k, l, 2).contiguous(), data,
        wg.expand(3, n, 2).contiguous(), structure=True)
    assert torch.equal(z[0], z[2])
    assert not torch.equal(z[0], z[1])
    z_other_step = tfs.zq_gendiff_pass(
        keys, 5, q.expand(3, n, k).contiguous(),
        freq.expand(3, k, l, 2).contiguous(), data,
        wg.expand(3, n, 2).contiguous(), structure=True)[0]
    assert not torch.equal(z, z_other_step)
    valid2 = 2.0 * float(((bits2 & 4) != 0).sum())
    for c in range(3):
        assert float(qq[c].sum()) == float(zc[c].sum()) == valid2


@pytest.mark.parametrize("n,k,subsweeps", [(70, 3, 4), (130, 2, 1),
                                           (1100, 3, 12)])
def test_s_pop_tail_matches_jax(n, k, subsweeps):
    rng = np.random.default_rng(5)
    q = rng.dirichlet(np.full(k, 0.4), size=n).astype(np.float32)
    gen = rng.integers(1, 9, n).astype(np.int32)
    rates = rng.uniform(0.05, 0.95, k).astype(np.float32)
    nu = subsweeps * k
    urows = -(-nu // 128)
    np_ = n + (-n % 128)
    planes = [rng.uniform(1e-4, 1 - 1e-4, (urows, 128)).astype(np.float32),
              rng.uniform(1e-4, 1 - 1e-4, (urows, 128)).astype(np.float32),
              rng.uniform(1e-4, 1 - 1e-4, (1, np_)).astype(np.float32),
              rng.uniform(1e-4, 1 - 1e-4, (1, np_)).astype(np.float32)]
    want = jax_s_pop_tail(jnp.zeros(2, jnp.int32), jnp.asarray(q),
                          jnp.asarray(gen), jnp.asarray(rates),
                          subsweeps=subsweeps, delta0=0.05, gen_cap=50,
                          interpret=True,
                          test_draws=[jnp.asarray(p) for p in planes])
    draws = (_t(planes[0].reshape(-1)[:nu])[None],
             _t(planes[1].reshape(-1)[:nu])[None],
             _t(planes[2][0, :n])[None], _t(planes[3][0, :n])[None])
    margins = []
    got = tsp.s_pop_tail_reference(
        _keys(), 0, _t(q)[None], _t(gen)[None], _t(rates)[None],
        subsweeps=subsweeps, delta0=0.05, gen_cap=50, test_draws=draws,
        margins=margins)
    via_wrapper = tsp.s_pop_tail(
        _keys(), 0, _t(q)[None], _t(gen)[None], _t(rates)[None],
        subsweeps=subsweeps, delta0=0.05, gen_cap=50, test_draws=draws)
    for a, b in zip(got, via_wrapper):
        assert torch.equal(a, b)
    # the MH accepts compare f32 sums taken in another order: every accept
    # margin must be clear of the rounding of those sums, else the rates
    # could legitimately differ
    accept_margin = torch.stack(margins[:-1]).abs().min().item()
    assert accept_margin > 1e-3, accept_margin
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    gp, jgp = got[1][0].numpy(), np.asarray(want[1])
    flipped = gp != jgp
    # a proposed generation may differ only where log u / log sbar sits on
    # an integer to within f32 rounding
    assert (margins[-1][0].numpy()[flipped] < 1e-4).all()
    assert flipped.mean() < 0.01
    np.testing.assert_allclose(got[2][0].numpy()[~flipped],
                               np.asarray(want[2])[~flipped], rtol=1e-6)
    np.testing.assert_allclose(got[3][0].numpy(), np.asarray(want[3]),
                               rtol=1e-6, atol=1e-7)


def test_s_pop_tail_boundaries_and_wide_k():
    n, k = 8, 2
    q = np.zeros((n, k), np.float32)
    q[:4, 0] = 1.0
    q[4:, 1] = 1.0
    half = lambda m: torch.full((1, m), 0.5)  # noqa: E731
    out = tsp.s_pop_tail(_keys(), 0, _t(q)[None],
                         torch.ones(1, n, dtype=torch.int32),
                         torch.tensor([[1e-6, 1.0 - 1e-6]]), subsweeps=0,
                         delta0=0.0, gen_cap=50,
                         test_draws=(half(k), half(k), half(n), half(n)))
    np.testing.assert_allclose(out[0][0].numpy(), [1e-6, 1.0 - 1e-6],
                               atol=1e-6)
    assert (out[1][0, :4] == 1).all() and (out[1][0, 4:] == 50).all()
    with pytest.raises(ValueError):
        tsp.s_pop_tail(_keys(), 0, torch.ones(1, 4, 9) / 9,
                       torch.ones(1, 4, dtype=torch.int32),
                       torch.full((1, 9), 0.5), subsweeps=1, delta0=0.05,
                       gen_cap=50)


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1025, 2500])
def test_block_sum_is_the_fixed_tree(n):
    rng = np.random.default_rng(2)
    t = rng.normal(size=(2, n)).astype(np.float32)
    got = tsp.block_sum(_t(t)).numpy()
    # the kernel's order: thread i of 512 adds elements i, i + 512, ... in
    # turn; a warp butterfly over each 32 threads; the 16 warps in order
    rows = -(-n // 512)
    pad = np.zeros((2, rows * 512), np.float32)
    pad[:, :n] = t
    acc = pad[:, :512].copy()
    for m in range(1, rows):
        acc = acc + pad[:, m * 512:(m + 1) * 512]
    warps = []
    for w in range(16):
        lanes = acc[:, 32 * w:32 * (w + 1)].copy()
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        assert (lanes == lanes[:, :1]).all()   # every lane holds the sum
        warps.append(lanes[:, 0])
    want = warps[0]
    for w in range(1, 16):
        want = want + warps[w]
    np.testing.assert_array_equal(got, want)


def test_reduction_floor_is_dependent_block_sums():
    # the S tail's latency floor: each total feeds the next reduction's input
    rng = np.random.default_rng(3)
    x = _t(rng.uniform(size=(2, 700)).astype(np.float32))
    total = torch.zeros(2)
    for _ in range(5):
        total = tsp.block_sum(x + total[:, None] * 1e-30)
    assert torch.equal(tsp.reduction_floor(x, 5), total)
    with pytest.raises(ValueError):
        tsp.reduction_floor(torch.zeros(1, 4097), 1)


@pytest.mark.parametrize("rows_per_group,c", [(2, 300), (3, 77)])
def test_dirichlet_rows_matches_jax(rows_per_group, c):
    rng = np.random.default_rng(0)
    r = rows_per_group * 2
    conc = rng.uniform(0.2, 50.0, (r, c)).astype(np.float32)
    conc[0, :10] = rng.uniform(0.01, 0.9, 10)          # conc < 1: the boost
    valid = rng.random((r, c)) > 0.05
    draws = rng.uniform(1e-4, 1.0 - 1e-4,
                        (jdp.n_test_draws(), r, c)).astype(np.float32)
    want = np.asarray(jdp.dirichlet_rows(
        0, jnp.asarray(conc), jnp.asarray(valid),
        rows_per_group=rows_per_group, interpret=True,
        test_draws=jnp.asarray(draws)))
    assert tdp.n_test_draws() == jdp.n_test_draws()
    got = tdp.dirichlet_rows(_keys(), 0, px.STREAM_Q, _t(conc)[None],
                             _t(valid), rows_per_group=rows_per_group,
                             test_draws=_t(draws)[None])[0].numpy()
    assert (got[~valid] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_dirichlet_kla_and_nk_match_jax_rows():
    """The layout wrappers: P on [C, K, L, A] and Q on [C, N, K] against the
    JAX kernel on the row layouts its step builds."""
    rng = np.random.default_rng(5)
    k, l, a, n = 3, 40, 2, 31
    nd = jdp.n_test_draws()
    counts = rng.integers(0, 30, (k, l, a)).astype(np.float32) + 1.0
    allele_valid = np.ones((l, a), bool)
    allele_valid[::7, 1] = False                       # monomorphic loci
    draws = rng.uniform(1e-4, 1 - 1e-4, (nd, k * a, l)).astype(np.float32)
    rows = counts.transpose(0, 2, 1).reshape(k * a, l)
    vrows = np.tile(allele_valid.T, (k, 1))
    want = np.asarray(jdp.dirichlet_rows(
        0, jnp.asarray(rows), jnp.asarray(vrows), rows_per_group=a,
        interpret=True, test_draws=jnp.asarray(draws)))
    want = want.reshape(k, a, l).transpose(0, 2, 1)
    got = tdp.dirichlet_kla(_keys(), 0, _t(counts)[None], _t(allele_valid),
                            test_draws=_t(draws)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)

    conc = (rng.integers(0, 20, (n, k)) + 0.07).astype(np.float32)
    draws = rng.uniform(1e-4, 1 - 1e-4, (nd, k, n)).astype(np.float32)
    want = np.asarray(jdp.dirichlet_rows(
        0, jnp.asarray(conc.T), rows_per_group=k, interpret=True,
        test_draws=jnp.asarray(draws))).T
    got = tdp.dirichlet_nk(_keys(), 0, _t(conc)[None],
                           test_draws=_t(draws)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_dirichlet_philox_draws_are_a_distribution():
    """With no injected uniforms the sampler draws from Philox: moments of
    Dirichlet(conc) within Monte-Carlo error, reproducible per (seed, step),
    different across steps and chains."""
    conc = torch.tensor([[4.0, 0.5, 2.0]]).expand(4000, 3).contiguous()[None]
    conc = conc.expand(2, 4000, 3).contiguous()
    keys = px.make_keys(11, 2, "cpu")
    a = tdp.dirichlet_nk(keys, 3, conc)
    b = tdp.dirichlet_nk(keys, 3, conc)
    c = tdp.dirichlet_nk(keys, 4, conc)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    mean = a.reshape(-1, 3).mean(0).numpy()
    np.testing.assert_allclose(mean, np.array([4.0, 0.5, 2.0]) / 6.5,
                               atol=0.01)
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
