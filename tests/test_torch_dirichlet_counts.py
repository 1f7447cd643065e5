"""K3 (the Dirichlet draws of P and Q) and K4 (allele-pop counts) of the
PyTorch port: their launch plans and Philox schedule, mirrored in Python
from ``csrc/dirichlet.cu`` and ``csrc/allele_counts.cu`` and checked here
for every shape the wrappers take, and the wrappers (on the CPU: their
plain versions) against the JAX kernels at the kernels' edge shapes.

The kernels themselves run only on a card; ``chip_smoke.py`` holds them to
these plans and plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instruct_tpu.kernels import dirichlet_pallas as jdp
from instruct_tpu.kernels import fused_step as jfs

from instruct_tpu_torch import ModelSpec
from instruct_tpu_torch.kernels import dirichlet as dk
from instruct_tpu_torch.kernels import fused_step as fs
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.tetra import engine as te


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K3: the launch plan and the Philox schedule
# ---------------------------------------------------------------------------

# columns M: multiples of 4 and 32, and every residue mod 4 and mod 32
COLUMNS = (1, 2, 3, 4, 5, 31, 32, 33, 36, 63, 64, 65, 1000, 10_000, 10_001)


@pytest.mark.parametrize("rounds", [0, 3, 16])
def test_dirichlet_plan_fits_for_every_group_size(rounds):
    """For every J up to 127 and every alignment of M, with few tiles and
    with many: at most 4 warps a block, the warps of a tile take each cell
    row once, the tiles cover
    every (chain, group, column), the shared memory fits the card, and 8
    Philox slots a plane exactly where M % 4 == 0."""
    for j in range(1, 128):
        for m in COLUMNS:
            for c, g in ((1, 1), (40, 10)):
                plan = dk.dirichlet_plan(c, g, j, m, rounds)
                warps = plan.jw * plan.nt
                assert 1 <= warps <= dk.MAX_WARPS
                assert plan.threads == dk.COLS * warps
                rows = sorted(r for w in range(plan.jw)
                              for r in range(w, j, plan.jw))
                assert rows == list(range(j))
                # the warps' loads differ by one cell row at most
                assert -(-j // plan.jw) - j // plan.jw <= 1
                assert plan.col_tiles * dk.COLS >= m > (plan.col_tiles
                                                        - 1) * dk.COLS
                assert plan.blocks * plan.nt >= c * g * plan.col_tiles
                assert (plan.blocks - 1) * plan.nt < c * g * plan.col_tiles
                assert plan.dyn_smem <= dk.SMEM_MAX
                assert plan.slots == (8 if m % 4 == 0 else 9)
    # the sweeps' shapes: a group's cells spread over the warps, but where
    # tiles fill the card many times over (the K grid's P)
    assert dk.dirichlet_plan(4, 1, 3, 1000)[:2] == (3, 1)      # main Q
    assert dk.dirichlet_plan(4, 3, 2, 10_000)[:2] == (2, 2)    # main P
    assert dk.dirichlet_plan(40, 1, 10, 1000)[:2] == (4, 1)    # grid Q
    assert dk.dirichlet_plan(40, 10, 2, 10_000)[:2] == (1, 4)  # grid P


@pytest.mark.parametrize("g,j,m", [
    (3, 2, 37), (2, 3, 13), (1, 1, 5), (2, 50, 7), (1, 2, 64), (2, 1, 33),
    (1, 3, 1000), (3, 2, 31), (1, 127, 3), (2, 5, 34), (4, 2, 1)])
@pytest.mark.parametrize("rounds", [0, 3])
def test_philox_schedule_gives_every_word_once(g, j, m, rounds):
    """The kernel's Philox schedule, mirrored: every word (plane d, cell) of
    the counter space is read by its own cell only, from a slot its task
    staged with the word's own block; no staged word is read twice; where
    M % 4 == 0 every block is computed exactly once, else at most once a
    task (a block straddling two tasks' edge is computed by both)."""
    nd = dk.n_test_draws(rounds)
    plane = g * j * m
    slots = dk.dirichlet_plan(1, g, j, m, rounds).slots
    staged, read = dk.philox_schedule(g, j, m, rounds)
    assert (read >= 0).all()
    task, rest = np.divmod(read, nd * slots * 4)
    slot, word = np.divmod(rest, 4)
    block = staged[task, slot]
    assert (block >= 0).all()
    want = np.arange(nd)[:, None] * plane + np.arange(plane)[None]
    np.testing.assert_array_equal(block * 4 + word, want)
    assert len(np.unique(read)) == read.size
    # a block is staged for a plane only where a cell of the task reads it
    used = np.zeros(staged.shape, bool)
    used[task, slot] = True
    np.testing.assert_array_equal(used, staged >= 0)
    blocks = staged[staged >= 0]
    if m % 4 == 0:
        assert len(blocks) == len(np.unique(blocks)) == nd * plane // 4
    else:
        # per plane: each task's blocks distinct, at most one shared with
        # the task before it
        assert len(blocks) <= nd * (-(-plane // 4)
                                    + g * j * -(-m // dk.COLS))


@pytest.mark.parametrize("rows_per_group,cols", [(1, 37), (2, 33),
                                                 (50, 7)])
def test_dirichlet_rows_matches_jax_at_edge_groups(rows_per_group, cols):
    """J = 1, 2 and 50 cells a group, columns not a multiple of 4 or 32:
    the wrapper against the JAX kernel on the same injected uniforms."""
    rng = np.random.default_rng(rows_per_group)
    r = rows_per_group * 3
    conc = rng.uniform(0.2, 40.0, (r, cols)).astype(np.float32)
    conc[:, :3] = rng.uniform(0.01, 0.9, (r, 3))       # the boost
    valid = rng.random((r, cols)) > 0.05
    draws = rng.uniform(1e-4, 1.0 - 1e-4,
                        (jdp.n_test_draws(), r, cols)).astype(np.float32)
    want = np.asarray(jdp.dirichlet_rows(
        0, jnp.asarray(conc), jnp.asarray(valid),
        rows_per_group=rows_per_group, interpret=True,
        test_draws=jnp.asarray(draws)))
    got = dk.dirichlet_rows(px.make_keys(3, 1, "cpu"), 0, px.STREAM_P,
                            _t(conc)[None], _t(valid),
                            rows_per_group=rows_per_group,
                            test_draws=_t(draws)[None])[0].numpy()
    assert (got[~valid] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("c", [1, 40])
def test_dirichlet_nk_chains_draw_their_own_words(c):
    """Q with C = 1 and 40 chains and K = 50 cells a group (the unfused
    sweep's widest Q): each chain draws from its own counter space, as
    the same chain alone does."""
    rng = np.random.default_rng(c)
    conc = _t((rng.integers(0, 9, (c, 13, 50)) + 0.3).astype(np.float32))
    keys = px.make_keys(21, c, "cpu", chain_key=range(5, 5 + c))
    out = dk.dirichlet_nk(keys, 4, conc)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    last = px.make_keys(21, 1, "cpu", chain_key=[4 + c])
    assert torch.equal(out[-1:], dk.dirichlet_nk(last, 4, conc[-1:]))


# ---------------------------------------------------------------------------
# K4: the launch plan, the fields, and the counts at the bucket edges
# ---------------------------------------------------------------------------

COUNT_SIZES = [(4, 1000, 10_000), (40, 1000, 10_000), (4, 500, 10_000),
               (4, 1000, 2000), (1, 5, 7), (3, 600_000, 130),
               (2, 70, 2_000_000), (1, 31, 129)]


def test_counts_plan_fits_the_card():
    """For every K and A up to 127 (the int8 codes) and panels from a
    handful of individuals to 600 000: the packed plane (A = 2, K <= 32)
    takes the packed body of the least pop bucket that holds K, other
    K*A <= 8 the codes body, the rest the table of whole pops; the table
    fits 48 KB unless one pop's alleles take more, and a block's shared
    memory fits the card; the strips of a tile (a cluster) cover N, at most
    8 and, beyond two, at most one wave of resident blocks (two of the
    table body), of at least 32 rows each."""
    for c, n, l in COUNT_SIZES:
        tiles = -(-l // fs.COUNTS_TILE)
        for k in range(1, 128):
            for a in range(1, 128):
                for packed in (False, True):
                    plan = fs.counts_plan(c, n, l, k, a, packed)
                    x, y, z = plan.grid
                    assert z == c and 1 <= y <= fs.COUNTS_MAX_STRIPS
                    assert y * plan.rows >= n > (y - 1) * plan.rows
                    assert y <= 2 or x * y * z <= fs.COUNTS_SMS * 6
                    assert y == 1 or plan.rows >= fs.COUNTS_MIN_ROWS
                    if packed and a == 2 and k <= 32:
                        assert plan.body == "packed"
                        assert plan.bucket >= k > plan.bucket // 2 or (
                            plan.bucket == 4 and k <= 4)
                    else:
                        assert plan.body == ("codes" if k * a <= 8
                                             else "table")
                    if plan.body != "table":
                        assert x == tiles and plan.pops_per_window == k
                    else:
                        kw = plan.pops_per_window
                        assert x == tiles * -(-k // kw)
                        assert kw == 1 or kw * a * fs.COUNTS_TILE * 4 <= (
                            fs.COUNTS_TABLE_SMEM)
                    assert plan.dyn_smem == (plan.pops_per_window * a
                                             * fs.COUNTS_TILE * 4)
                    assert plan.dyn_smem <= 232_448
    # the sweeps' shapes: a few strips a tile where the chains' tiles are
    # few, one on the K grid's 40 chains
    for args, grid in [((4, 1000, 10_000, 3, 2, True), (79, 2, 4)),
                       ((40, 1000, 10_000, 10, 2, True), (79, 1, 40)),
                       ((4, 500, 10_000, 3, 4, False), (79, 2, 4)),
                       ((4, 1000, 2000, 3, 8, False), (16, 8, 4)),
                       ((4, 1000, 2000, 5, 16, False), (16, 8, 4))]:
        assert fs.counts_plan(*args).grid == grid


@pytest.mark.parametrize("ploid", [1, 2, 3, 4])
def test_count_fields_never_overflow(ploid):
    """The register body's 8-bit fields: a lane flushes them every
    COUNTS_FIELD_ROWS of its rows, and a row puts at most 2 copies into a
    (locus, cell) -- the kernel counts a [C, N, 2L] z; a panel of any
    ploidy reaches it as that diploid view (the tetraploid engine's
    [C, N, 4L] as 2L loci of 2 copies) -- so a field never passes 255.  The
    integer table and float counts hold ploidy * N copies a locus exactly
    for N up to 2^22."""
    per_row = 2                       # copies of a (row, locus) the kernel sees
    assert per_row * fs.COUNTS_FIELD_ROWS < 1 << fs.COUNTS_FIELD_BITS
    assert ploid * (1 << 22) <= 1 << 24
    rng = np.random.default_rng(ploid)
    n, l, k, a = 9, 7, 3, 4
    copies = ploid * l
    z = rng.integers(0, k, (2, n, copies)).astype(np.int8)
    geno = rng.integers(0, a, (2, n, copies)).astype(np.int8)
    valid = rng.random((n, l)) > 0.2
    if ploid % 2:
        # an odd ploidy's copies as a diploid view: one padded copy a locus
        # that no valid site carries (code -1)
        z = np.concatenate([z, np.full((2, n, l), -1, np.int8)], axis=2)
        geno = np.concatenate([geno, np.zeros((2, n, l), np.int8)], axis=2)
    half = z.shape[2] // 2
    vv = np.tile(valid, (1, half // l))
    got = fs.allele_counts(_t(z), _t(geno), _t(vv), n_pops=k,
                           max_alleles=a).numpy()
    want = np.zeros((2, k, half, a), np.float32)
    for ci in range(2):
        for row in range(n):
            for s in range(2 * half):
                zz, gg, li = z[ci, row, s], geno[ci, row, s], s % half
                if vv[row, li] and 0 <= zz < k:
                    want[ci, zz, li, gg] += 1
    np.testing.assert_array_equal(got, want)
    assert got.max() <= per_row * n


# K*A at the edges of the kernel's bodies (the codes body's 8 cells, the
# packed body's pop buckets 4, 8, 16, 32 at A = 2, the table's 64 cells)
BUCKET_EDGES = [(4, 2), (3, 3), (8, 2), (17, 1), (4, 8), (11, 3), (16, 4),
                (13, 5), (5, 13)]


@pytest.mark.parametrize("k,a", BUCKET_EDGES)
def test_allele_counts_matches_jax_at_bucket_edges(k, a):
    """The wrapper against the JAX kernel at K*A = 8, 9, 16, 17, 32, 33, 64,
    65: on the allele codes with invalid sites, chain by chain, N not a
    multiple of a strip and L not of a tile (its plain version on the CPU;
    the card holds the kernel to that)."""
    rng = np.random.default_rng(k * 131 + a)
    n, l, c = 37, 131, 2
    geno = rng.integers(0, a, (n, 2 * l)).astype(np.int8)
    valid = rng.random((n, l)) > 0.15
    z = rng.integers(0, k, (c, n, 2 * l)).astype(np.int8)
    got = fs.allele_counts(_t(z), _t(geno), _t(valid), n_pops=k,
                           max_alleles=a).numpy()
    for ci in range(c):
        want = np.asarray(jfs.allele_counts(
            jnp.asarray(z[ci]), jnp.asarray(geno), jnp.asarray(valid),
            n_pops=k, max_alleles=a, interpret=True))
        np.testing.assert_array_equal(got[ci], want)


@pytest.mark.parametrize("autopoly", [True, False])
def test_allele_counts_on_the_tetraploid_view_matches_jax(autopoly):
    """The tetraploid engine's P counts -- one call on the diploid view of
    per-chain planes -- against the JAX kernel on each chain's view."""
    rng = np.random.default_rng(int(autopoly))
    n, l, k, a, c = 11, 29, 3, 4, 2
    spec = ModelSpec(mode=2, ploid=4, n_pops=k, autopoly=autopoly)
    z = _t(rng.integers(0, k, (c, n, 4 * l)).astype(np.int8))
    geno = _t(rng.integers(0, a, (c, n, 4 * l)).astype(np.int8))
    valid = _t(rng.random((n, l)) > 0.1)
    zv, gv = te.diploid_view(spec, z), te.diploid_view(spec, geno)
    v2 = valid.repeat(1, 2)
    got = fs.allele_counts(zv, gv, v2, n_pops=k, max_alleles=a).numpy()
    for ci in range(c):
        want = np.asarray(jfs.allele_counts(
            jnp.asarray(zv[ci].numpy()), jnp.asarray(gv[ci].numpy()),
            jnp.asarray(v2.numpy()), n_pops=k, max_alleles=a,
            interpret=True))
        np.testing.assert_array_equal(got[ci], want)
