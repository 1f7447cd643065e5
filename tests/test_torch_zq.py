"""The port's Z-Gibbs draw of the unfused sweep (``kernels/zq.py``) against
the JAX kernel ``instruct_tpu.kernels.zq_pallas.zq_sample_counts`` in
interpret mode, on the CPU: the same arrays (made with numpy from a seed) and
the same injected uniforms.  z and qqnum are compared exactly (both are
integer-valued); nothing here has a tolerance.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.kernels import zq_pallas as jzq

from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.kernels import zq


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _inputs(n, l, k, a, ploid, c=2, missing=0.1, seed=0):
    """A ragged panel (2..a alleles per locus, missing copies coded 0 on
    invalid sites), q, freq and uniforms, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n_alleles = rng.integers(2, a + 1, size=l)
    n_alleles[0] = a
    geno = (rng.random((n, ploid * l)) * np.tile(n_alleles, ploid)).astype(
        np.int8)
    valid = rng.random((n, l)) >= missing
    geno = np.where(np.tile(valid, (1, ploid)), geno, 0).astype(np.int8)
    allele_valid = np.arange(a)[None, :] < n_alleles[:, None]
    freq = rng.dirichlet(np.ones(a), size=(c, k, l)) * allele_valid
    freq = (freq / freq.sum(-1, keepdims=True)).astype(np.float32)
    q = rng.dirichlet(np.full(k, 0.5), size=(c, n)).astype(np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, (c, n, ploid * l)).astype(np.float32)
    return geno, valid, allele_valid, freq, q, u


CASES = [(17, 23, 3, 2, 2), (5, 7, 2, 2, 2), (12, 9, 9, 10, 2),
         (11, 13, 3, 4, 4), (9, 10, 4, 5, 1), (8, 6, 20, 3, 3)]


@pytest.mark.parametrize("n,l,k,a,ploid", CASES)
def test_plain_version_matches_the_jax_kernel(n, l, k, a, ploid):
    geno, valid, _, freq, q, u = _inputs(n, l, k, a, ploid, seed=n + k)
    keys = px.make_keys(0, freq.shape[0], "cpu")
    z, qqnum = zq.zq_sample_counts(keys, 0, _t(q), _t(freq), _t(geno),
                                   _t(valid), n_pops=k, u=_t(u))
    assert z.dtype == torch.int8 and z.shape == u.shape
    assert qqnum.shape == q.shape
    for ci in range(freq.shape[0]):
        jz, jqq = jzq.zq_sample_counts(
            0, jnp.asarray(q[ci]), jnp.asarray(freq[ci]),
            jnp.asarray(geno, jnp.int32), jnp.asarray(valid), n_pops=k,
            interpret=True, u=jnp.asarray(u[ci]))
        np.testing.assert_array_equal(z[ci].numpy(), np.asarray(jz))
        np.testing.assert_array_equal(qqnum[ci].numpy(), np.asarray(jqq))
    # the counts are those of the returned z over the valid sites
    v = np.tile(valid, (1, ploid))[None]
    want = np.stack([(v & (z.numpy() == kk)).sum(-1) for kk in range(k)], -1)
    np.testing.assert_array_equal(qqnum.numpy(), want)
    assert (z.numpy() != 0).any() or k == 1


@pytest.mark.parametrize("n,l,k,a", [(17, 23, 3, 2), (12, 9, 8, 8),
                                     (6, 31, 5, 16)])
def test_same_draw_as_the_generic_site_pass(n, l, k, a):
    """On a diploid panel K8 and the generic path of the site pass read the
    same Philox words and form the same prefixes; the site pass also carries
    the allele-pop counts of its z."""
    geno, valid, allele_valid, freq, q, u = _inputs(n, l, k, a, 2, seed=3)
    data = Dataset(geno=_t(geno), site_valid=_t(valid),
                   allele_valid=_t(allele_valid),
                   hom=_t(geno[:, :l] == geno[:, l:]))
    keys = px.make_keys(77, freq.shape[0], "cpu", chain_key=[3, 9])
    for inj in (None, _t(u)):
        z, qqnum = zq.zq_sample_counts(keys, 4, _t(q), _t(freq), data.geno,
                                       data.site_valid, n_pops=k, u=inj)
        z1, qq1, zc = fs.zq_sample_pass_reference(keys, 4, _t(q), _t(freq),
                                                  data, u=inj)
        assert torch.equal(zc, fs.allele_counts_reference(
            z1, data.geno, data.site_valid, n_pops=k, max_alleles=a))
        assert torch.equal(z, z1) and torch.equal(qqnum, qq1)
    # another step or chain key is another draw
    z2, _ = zq.zq_sample_counts(keys, 5, _t(q), _t(freq), data.geno,
                                data.site_valid, n_pops=k)
    assert not torch.equal(z, z2)


def test_missing_codes_weigh_zero_and_bad_shapes_raise():
    n, l, k, a = 6, 9, 3, 4
    geno, valid, _, freq, q, u = _inputs(n, l, k, a, 2, seed=1)
    keys = px.make_keys(0, 2, "cpu")
    geno = geno.copy()
    geno[0, :3], geno[1, l:l + 2] = -1, a          # outside [0, A)
    z, qqnum = zq.zq_sample_counts(keys, 0, _t(q), _t(freq), _t(geno),
                                   _t(valid), n_pops=k, u=_t(u))
    assert (z[:, 0, :3] == 0).all() and (z[:, 1, l:l + 2] == 0).all()
    assert float(qqnum.sum()) == 2 * 2 * valid.sum()
    with pytest.raises(ValueError, match="n_pops"):
        zq.zq_sample_counts(keys, 0, _t(q), _t(freq), _t(geno), _t(valid),
                            n_pops=k + 1)
    with pytest.raises(ValueError, match="copies"):
        zq.zq_sample_counts(keys, 0, _t(q), _t(freq), _t(geno[:, :-1]),
                            _t(valid), n_pops=k)
    with pytest.raises(ValueError, match="u: expected"):
        zq.zq_sample_counts(keys, 0, _t(q), _t(freq), _t(geno), _t(valid),
                            n_pops=k, u=_t(u[:, :, :-1]))


def test_wrapper_has_no_cpu_path_for_cuda_tensors():
    """On the CPU the wrapper runs the plain version only because its
    tensors lie there: the branch is on ``freq.is_cuda`` and nothing
    else."""
    import inspect
    src = inspect.getsource(zq.zq_sample_counts)
    assert "if not freq.is_cuda:" in src
    assert src.count("zq_sample_counts_reference") == 1
    assert "except" not in src


@pytest.mark.parametrize("ploid", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [3, 9, 17])
def test_zero_pops_up_to_a_bucket_change_nothing(k, ploid):
    """The kernel's pop buckets (K <= 16, K <= 32) draw from q and P padded
    with pops of zero weight: padding leaves the plain version's z and
    counts bitwise as they were, with Philox uniforms and injected ones,
    missing codes (-1 and A) included; the padded pops are never drawn."""
    n, l, a = 9, 13, 4
    geno, valid, _, freq, q, u = _inputs(n, l, k, a, ploid, seed=k + ploid)
    geno = geno.copy()
    geno[0, :2], geno[1, -2:] = -1, a
    keys = px.make_keys(11, freq.shape[0], "cpu")
    for bucket in (b for b in (8, 16, 32) if b >= k):
        qp = np.concatenate([q, np.zeros(q.shape[:2] + (bucket - k,),
                                         np.float32)], axis=2)
        fp = np.concatenate([freq, np.zeros((freq.shape[0], bucket - k)
                                            + freq.shape[2:], np.float32)],
                            axis=1)
        for inj in (None, _t(u)):
            z, qq = zq.zq_sample_counts(keys, 2, _t(q), _t(freq), _t(geno),
                                        _t(valid), n_pops=k, u=inj)
            zp, qqp = zq.zq_sample_counts(keys, 2, _t(qp), _t(fp), _t(geno),
                                          _t(valid), n_pops=bucket, u=inj)
            assert torch.equal(z, zp)
            assert torch.equal(qq, qqp[:, :, :k])
            assert not qqp[:, :, k:].any()


PLAN_SIZES = [(4, 1000, 10_000), (40, 1000, 10_000), (1, 5, 7),
              (3, 600_000, 130), (2, 70, 2_000_000)]


def test_launch_plan_fits_the_card():
    """For every K and A the wrapper takes (1..127 each; any ploidy, which
    the plan does not read: a copy is a row of the tile) and panels from a
    handful of individuals to 600 000, the plan asks a block for at most
    the card's 227 KB of shared memory and the grid for at most 65 535 in
    y and z; K <= 8 runs its own body, 9..16 and 17..32 the padded buckets
    where the tile's P fits, the rest the generic body."""
    for c, n, l in PLAN_SIZES:
        for k in range(1, zq.MAX_POPS + 1):
            for a in range(1, zq.MAX_ALLELES + 1):
                plan = zq.zq_plan(c, n, l, k, a)
                assert plan.dyn_smem <= zq.SMEM_MAX
                assert max(plan.grid[1:]) <= zq.GRID_MAX
                assert plan.grid[0] * (zq.TILE if plan.bucket
                                       else 4 * zq.THREADS) >= l
                assert plan.grid[1] * (plan.rows or zq.GENERIC_ROWS) >= n
                if plan.bucket:
                    assert plan.bucket == zq.zq_bucket(k) >= k
                    assert plan.dyn_smem == 4 * (k * zq.TILE * (a | 1)
                                                 + 2 * plan.rows * k)
                else:
                    # a strip of the fewest rows the grid allows leaves no
                    # room beside a tile of P
                    least = max(1, -(-n // zq.GRID_MAX))
                    assert k > 32 or 4 * k * (zq.TILE * (a | 1)
                                              + 2 * least) > zq.SMEM_MAX
    # the benchmark shapes take the buckets, at most 48 KB and at least 4
    # blocks an SM
    for c, n, l, k, a in [(4, 1000, 2000, 5, 16), (4, 1000, 10_000, 3, 2),
                          (4, 1000, 2000, 3, 4)]:
        plan = zq.zq_plan(c, n, l, k, a)
        assert plan.bucket == k and plan.dyn_smem <= 48 * 1024
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 528
    with pytest.raises(ValueError, match="A must be"):
        zq.zq_sample_counts(px.make_keys(0, 1, "cpu"), 0,
                            torch.ones(1, 2, 1), torch.ones(1, 1, 3, 128),
                            torch.zeros(2, 3, dtype=torch.int8),
                            torch.ones(2, 3, dtype=torch.bool), n_pops=1)
