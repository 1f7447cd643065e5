"""The port's loci layout (``instruct_tpu_torch/parallel/loci_shard.py``)
and mesh layout (``parallel/mesh.py``) against the JAX package's, in one
process on the CPU: every layout function exactly equal on the same numpy
panels (diploid L = 13 over 1, 2 and 4 shards, with padding and with the
packed ``bits2`` plane; a tetraploid panel spanning the allele-count
classes 2, 3 and 4), the blocked-sites round trip, the ranks' mesh
positions against ``make_mesh(c, d).devices``, and what the port does
where the JAX package does not: ``pad_loci`` refuses a tetraploid panel,
and the gathered per-locus tensors come back in the input's loci order."""

import jax
import numpy as np
import pytest
import torch

from instruct_tpu.data.dataset import make_dataset as j_make_dataset
from instruct_tpu.data.synthetic import synthetic_panel as j_panel
from instruct_tpu.parallel import loci_shard as jls
from instruct_tpu.parallel.mesh import make_mesh as j_make_mesh

from instruct_tpu_torch import convert
from instruct_tpu_torch.parallel import loci_shard as ls
from instruct_tpu_torch.parallel import make_mesh
from instruct_tpu_torch.parallel import mesh as pmesh


def _fields(obj):
    return {name: None if v is None else np.asarray(v)
            for name, v in obj._asdict().items()}


def _same(jd, td):
    """Every field of a JAX and a port Dataset exactly equal."""
    for name, v in _fields(jd).items():
        t = getattr(td, name)
        if v is None:
            assert t is None, name
            continue
        np.testing.assert_array_equal(t.numpy(), v, err_msg=name)
        assert t.shape == v.shape, name


def _diploid(bits2: bool, n_alleles=2):
    jdata = j_panel(n_indv=7, n_loci=13, n_pops=2, n_alleles=n_alleles,
                    missing_rate=0.1, seed=5).data
    if not bits2:
        jdata = jdata._replace(bits2=None)
    return jdata, convert.dataset_from_numpy(_fields(jdata))


def _mixed_class_tetra(n=8, l=23, seed=2):
    """A tetraploid panel whose loci span the allele-count classes 2, 3
    and 4 in counts that do not divide by the shard count (the
    construction of ``tests/test_tetra_sharding.py``)."""
    rng = np.random.default_rng(seed)
    n_alleles = rng.choice([2, 3, 4], size=l, p=[0.5, 0.3, 0.2])
    n_alleles[:3] = [2, 3, 4]
    nd = np.minimum(rng.integers(1, 5, size=(n, l)), n_alleles[None, :])
    distinct = np.zeros((n, l, 4), np.int32)
    for i in range(n):
        for j in range(l):
            vals = np.sort(rng.choice(n_alleles[j], size=nd[i, j],
                                      replace=False))
            distinct[i, j, :nd[i, j]] = vals
    jdata = j_make_dataset(distinct, np.zeros((n, l), bool),
                           n_alleles.astype(np.int32), distinct=distinct,
                           n_distinct=nd)
    return jdata, convert.dataset_from_numpy(_fields(jdata))


@pytest.mark.parametrize("bits2", [True, False])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_diploid_layout_matches_jax(n_shards, bits2):
    jdata, data = _diploid(bits2)
    _same(jls.pad_loci(jdata, n_shards), ls.pad_loci(data, n_shards))
    jst = jls.stack_loci(jdata, n_shards)
    st = ls.stack_loci(data, n_shards)
    _same(jst, st)
    for s in range(n_shards):
        want = jax.tree.map(lambda x: x[s], jst)
        _same(want, ls.local_view(st, s))

        class _M:
            n_data_shards, data_index, device = n_shards, s, "cpu"
        _same(want, ls.shard_panel(data, _M))
    src = ls.loci_plan(data, n_shards)
    assert src.shape == (n_shards, -(-13 // n_shards))
    assert sorted(src[src >= 0].tolist()) == list(range(13))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tetra_layout_matches_jax(n_shards):
    jdata, data = _mixed_class_tetra()
    src = ls.tetra_shard_plan(data, n_shards)
    np.testing.assert_array_equal(src, jls.tetra_shard_plan(jdata,
                                                            n_shards))
    np.testing.assert_array_equal(ls._shard_class_counts(data, src),
                                  jls._shard_class_counts(jdata, src))
    assert (src < 0).any() or n_shards == 1
    jst = jls.stack_loci_tetra(jdata, n_shards)
    st = ls.stack_loci_tetra(data, n_shards)
    _same(jst, st)
    _same(jst, ls.stack_loci(data, n_shards))
    np.testing.assert_array_equal(ls.loci_plan(data, n_shards), src)
    for s in range(n_shards):
        class _M:
            n_data_shards, data_index, device = n_shards, s, "cpu"
        # one shard: the rank holds the panel as it is, unpermuted
        _same(jax.tree.map(lambda x: x[s], jst) if n_shards > 1 else jdata,
              ls.shard_panel(data, _M))
        _same(jls.local_view(jax.tree.map(lambda x: x[s:s + 1], jst)),
              ls.local_view(st, s))


@pytest.mark.parametrize("ploid", [2, 4])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_block_and_unblock_sites_match_jax(n_shards, ploid):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 9, size=(3, 5, n_shards * ploid * 6)).astype(np.int8)
    np.testing.assert_array_equal(ls.unblock_sites(x, n_shards, ploid),
                                  jls.unblock_sites(x, n_shards, ploid))
    np.testing.assert_array_equal(ls.block_sites(x, n_shards, ploid),
                                  jls.block_sites(x, n_shards, ploid))
    np.testing.assert_array_equal(
        ls.block_sites(ls.unblock_sites(x, n_shards, ploid), n_shards,
                       ploid), x)
    np.testing.assert_array_equal(
        ls.unblock_sites(ls.block_sites(x, n_shards, ploid), n_shards,
                         ploid), x)


def test_pad_loci_refuses_a_tetraploid_panel():
    _, data = _mixed_class_tetra()
    with pytest.raises(ValueError, match="tetraploid"):
        ls.pad_loci(data, 2)


@pytest.mark.parametrize("tetra", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_gathered_loci_come_back_in_the_input_order(n_shards, tetra):
    """Per-locus tensors of the shards' blocks ([C, K, L_loc, A] and
    copy-major sites) go back to the input panel's loci, padding dropped:
    for the tetraploid plan's permutation too."""
    _, data = _mixed_class_tetra() if tetra else _diploid(True)
    l, p = data.n_loci, data.ploid
    src = ls.loci_plan(data, n_shards)
    freq = torch.arange(2 * 3 * l * 4, dtype=torch.float32).reshape(
        2, 3, l, 4)
    sites = torch.arange(2 * 5 * p * l).reshape(2, 5, p * l)
    blocks, site_blocks = [], []
    for row in src:
        idx = torch.as_tensor(np.where(row >= 0, row, 0))
        blocks.append(freq.index_select(2, idx))
        site_blocks.append(sites.reshape(2, 5, p, l).index_select(3, idx)
                           .reshape(2, 5, -1))
    assert torch.equal(ls.gather_loci(blocks, src, axis=2), freq)
    assert torch.equal(ls.gather_sites(site_blocks, src, p), sites)
    inv = ls.inverse_plan(src, l)
    assert (src.reshape(-1)[inv] == np.arange(l)).all()


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8),
                                   (None, 2), (2, None), (None, None)])
def test_mesh_positions_match_jax(monkeypatch, shape):
    """Rank r of the port's mesh sits where device r sits in the JAX
    mesh over 8 devices (chains-major), for every shape; a shape that
    does not cover the world raises JAX's ValueError."""
    jm = j_make_mesh(*shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    order = {d.id: i for i, d in enumerate(jax.devices())}
    pos = np.vectorize(order.get)(ids)
    for r in range(8):
        monkeypatch.setattr(pmesh, "world", lambda r=r: (8, r))
        # the groups come from torch.distributed: here only the positions
        monkeypatch.setattr(pmesh.dist, "new_group", lambda *a, **k: None)
        monkeypatch.setattr(pmesh.dist, "get_backend", lambda: "gloo")
        m = make_mesh(*shape, device="cpu")
        assert (m.n_chain_shards, m.n_data_shards) == jm.devices.shape
        assert pos[m.chain_index, m.data_index] == r


@pytest.mark.parametrize("shape", [(3, None), (None, 3), (4, 4), (3, 3)])
def test_mesh_refuses_what_jax_refuses(monkeypatch, shape):
    with pytest.raises(ValueError):
        j_make_mesh(*shape)
    monkeypatch.setattr(pmesh, "world", lambda: (8, 0))
    with pytest.raises(ValueError, match="world size is 8"):
        make_mesh(*shape, device="cpu")


def test_world_of_one_mesh_without_torch_distributed():
    m = make_mesh(device="cpu")
    assert (m.n_chain_shards, m.n_data_shards, m.rank) == (1, 1, 0)
    assert m.shard is None and m.chain_rows(4) == range(4)
    x = torch.ones(3)
    assert m.all_reduce_(x) is x and not m.stats
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh(2, 1, device="cpu")
