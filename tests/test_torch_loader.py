"""The port's loader, native tokenizer and memory budget against the JAX
package's: on the same file, ``read_data`` gives the same arrays (exactly,
dtypes included), the same ``Panel`` metadata and the same log; the native
tokenizer the same values as the pure-Python split; ``write_panel`` the same
bytes; ``read_init`` the same starts; ``estimate_bytes`` the same dict."""

import io

import numpy as np
import pytest
import torch

from instruct_tpu.config import ModelSpec as JModelSpec
from instruct_tpu.config import Schedule as JSchedule
from instruct_tpu.data import loader as jloader
from instruct_tpu.memory import estimate_bytes as j_estimate_bytes
from instruct_tpu_torch import native
from instruct_tpu_torch.config import ModelSpec, Schedule
from instruct_tpu_torch.data import loader
from instruct_tpu_torch.data.synthetic import synthetic_tetra_panel
from instruct_tpu_torch.memory import estimate_bytes

N_INDV, N_LOCI = 12, 10
FIELDS = ("geno", "site_valid", "allele_valid", "hom", "distinct",
          "n_distinct", "bits2")
META = ("indv_names", "pop_index", "pop_names", "marker_names",
        "allele_names", "n_alleles")


def _alleles(rng, kind, n_copies):
    """[n_copies, L] allele tokens: per locus 1-4 types (locus 0 is
    monomorphic, so it is dropped for diploids)."""
    out = np.empty((n_copies, N_LOCI), dtype=object)
    for j in range(N_LOCI):
        if kind == "int":
            types = [str(v) for v in (101, 102)]
        elif kind == "multi":
            types = [str(v) for v in (101, 102, 105, 110)]
        elif kind == "dna":
            types = ["A", "C", "G", "T"][:2 + j % 3]
        else:                                   # microsatellite names
            types = ["m120", "m124", "m128"]
        if j == 0:
            types = types[:1]
        out[:, j] = rng.choice(types, size=n_copies)
    return out


def write_diploid(path, seed, kind="int", data_fmt=0, label=1, popdata=1,
                  n_extra_col=0, markername=0, missing="-9"):
    """A diploid panel file in the reference's format: one haploid a line
    (``data_fmt=0``) or one individual a line, loci-major (1)."""
    rng = np.random.default_rng(seed)
    al = _alleles(rng, kind, 2 * N_INDV)
    miss = rng.random((N_INDV, N_LOCI)) < 0.1
    lines = []
    if markername:
        lines.append(" ".join(f"mk{j}" for j in range(N_LOCI)))
    for i in range(N_INDV):
        meta = []
        if label:
            meta.append(f"id{i}")
        if popdata:
            meta.append(f"pop{(i * 7) % 3}")
        meta += [f"x{c}" for c in range(n_extra_col)]
        copies = [[missing if miss[i, j] else al[2 * i + c, j]
                   for j in range(N_LOCI)] for c in range(2)]
        if data_fmt == 0:
            lines += [" ".join(meta + copies[c]) for c in range(2)]
        else:
            toks = [copies[c][j] for j in range(N_LOCI) for c in range(2)]
            lines.append(" ".join(meta + toks))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


DIPLOID = {
    # name: (file kwargs, the path the port must take)
    "fmt0": (dict(), "native"),
    "fmt1": (dict(data_fmt=1), "native"),
    "fmt0, no label or popdata": (dict(label=0, popdata=0), "native"),
    "fmt1, label only": (dict(data_fmt=1, popdata=0), "native"),
    "fmt0, popdata only": (dict(label=0), "native"),
    "fmt0, 2 extra columns": (dict(n_extra_col=2), "native"),
    "fmt1, 2 extra columns": (dict(data_fmt=1, n_extra_col=2), "native"),
    "fmt0, marker names": (dict(markername=1), "python"),
    "fmt1, marker names": (dict(data_fmt=1, markername=1), "python"),
    "fmt0, missing -1": (dict(missing="-1"), "native"),
    "fmt1, missing NA": (dict(data_fmt=1, missing="NA"), "python"),
    "fmt0, multi-allelic": (dict(kind="multi"), "native"),
    "fmt1, multi-allelic, missing 0": (dict(data_fmt=1, kind="multi",
                                            missing="0"), "native"),
    "fmt0, DNA letters": (dict(kind="dna"), "python"),
    "fmt1, microsatellite names": (dict(data_fmt=1, kind="msat"),
                                   "python"),
}


def _read_kwargs(kw):
    return dict(ploid=2, missing=kw.get("missing", "-9"),
                label=kw.get("label", 1), popdata=kw.get("popdata", 1),
                n_extra_col=kw.get("n_extra_col", 0),
                markername=kw.get("markername", 0),
                data_fmt=kw.get("data_fmt", 0))


def assert_same_panel(got, want):
    for f in FIELDS:
        a, b = getattr(got.data, f), getattr(want.data, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in META:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif a is not None:
            assert [list(x) if isinstance(x, list) else x for x in a] == \
                [list(x) if isinstance(x, list) else x for x in b], f


@pytest.mark.parametrize("case", list(DIPLOID))
def test_read_data_matches_jax_diploid(tmp_path, case):
    kw, path_taken = DIPLOID[case]
    f = tmp_path / "panel.txt"
    write_diploid(f, seed=len(case), **kw)
    log_port, log_jax = io.StringIO(), io.StringIO()
    got = loader.read_data(str(f), log=log_port, **_read_kwargs(kw))
    assert loader.last_parse == path_taken
    want = jloader.read_data(str(f), log=log_jax, **_read_kwargs(kw))
    assert_same_panel(got, want)
    assert log_port.getvalue() == log_jax.getvalue()
    assert "The locus 1 is not polymorphic." in log_port.getvalue()


@pytest.mark.parametrize("autopoly", [True, False], ids=["auto", "allo"])
def test_read_data_matches_jax_tetraploid(tmp_path, autopoly):
    """A tetraploid file (one individual a line, loci-major: the layout
    both loaders read at ploidy 4) through the pure-Python path, with the
    sorted distinct alleles and their counts."""
    panel = synthetic_tetra_panel(N_INDV, N_LOCI, n_pops=2, n_alleles=4,
                                  autopoly=autopoly, seed=7)
    f = tmp_path / "tetra.txt"
    loader.write_panel(panel, str(f), data_fmt=1)
    got = loader.read_data(str(f), ploid=4, data_fmt=1, log=io.StringIO())
    assert loader.last_parse == "python"
    want = jloader.read_data(str(f), ploid=4, data_fmt=1, log=io.StringIO())
    assert_same_panel(got, want)
    assert got.data.distinct is not None and got.data.n_distinct is not None
    # the panel's distinct sets survive the round trip (recoded 100 + a)
    np.testing.assert_array_equal(got.data.n_distinct.numpy(),
                                  panel.data.n_distinct.numpy())


@pytest.mark.parametrize("data_fmt", [0, 1])
def test_write_panel_round_trip_and_bytes(tmp_path, data_fmt):
    """write_panel writes the JAX writer's bytes, and reading what it wrote
    gives the panel back."""
    f = tmp_path / "in.txt"
    write_diploid(f, seed=3, kind="multi", data_fmt=data_fmt)
    kw = _read_kwargs(dict(data_fmt=data_fmt))
    panel = loader.read_data(str(f), log=io.StringIO(), **kw)
    jpanel = jloader.read_data(str(f), log=io.StringIO(), **kw)
    out, jout = tmp_path / "out.txt", tmp_path / "jout.txt"
    loader.write_panel(panel, str(out), data_fmt=data_fmt)
    jloader.write_panel(jpanel, str(jout), data_fmt=data_fmt)
    assert out.read_bytes() == jout.read_bytes()
    again = loader.read_data(str(out), log=io.StringIO(), **kw)
    for fld in ("geno", "site_valid", "allele_valid", "bits2"):
        a, b = getattr(again.data, fld), getattr(panel.data, fld)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), fld
    assert again.indv_names == panel.indv_names


def test_write_panel_tetra_bytes(tmp_path):
    panel = synthetic_tetra_panel(N_INDV, N_LOCI, n_pops=2, n_alleles=4,
                                  autopoly=False, seed=5)
    f = tmp_path / "t.txt"
    loader.write_panel(panel, str(f), data_fmt=1)
    jpanel = jloader.read_data(str(f), ploid=4, data_fmt=1,
                               log=io.StringIO())
    for fmt in (0, 1):
        a, b = tmp_path / f"a{fmt}.txt", tmp_path / f"b{fmt}.txt"
        loader.write_panel(loader.read_data(str(f), ploid=4, data_fmt=1,
                                            log=io.StringIO()),
                           str(a), data_fmt=fmt)
        jloader.write_panel(jpanel, str(b), data_fmt=fmt)
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("lines", [
    None,
    ">warm\n0.2 0.7 0.4\n",
    ">first\n0.1 0.2 0.3\n>second\n0.9 0.8 0.7\n",
], ids=["no file", "one chain", "two chains"])
def test_read_init_matches_jax(tmp_path, lines):
    path = None
    if lines is not None:
        path = tmp_path / "init.txt"
        path.write_text(lines)
        path = str(path)
    got = loader.read_init(path, 3, 3)
    want = jloader.read_init(path, 3, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert got[1] == want[1]


def test_read_init_refuses_like_jax(tmp_path):
    f = tmp_path / "init.txt"
    f.write_text(">a\n0.1 0.2\n")
    for mod in (loader, jloader):
        with pytest.raises(ValueError, match="not equal"):
            mod.read_init(str(f), 2, 3)


def test_native_tokenizer_matches_python_split(tmp_path):
    """The C tokenizer's values and per-line counts equal the pure-Python
    split: integers as values, every other token the NONINT sentinel, blank
    lines skipped; it is built into this package's build directory."""
    f = tmp_path / "t.txt"
    f.write_text("id0 pop1 101 -9 +7 12x\n\n  3\t-0  x 99999999999\n"
                 "a\r\n1234567890123456789 -12\n")
    tok = native.tokenize_file(str(f))
    assert tok is not None, "the native tokenizer did not build"
    values, per_line = tok
    rows = loader._tokenize(str(f))
    assert per_line.tolist() == [len(r) for r in rows]

    def as_int(t):
        body = t.lstrip("+-")
        if body.isdigit() and len(body) <= 18:
            return int(t)
        return int(native.NONINT)

    assert values.tolist() == [as_int(t) for r in rows for t in r]
    assert native.BUILD.name == "native"
    assert native.BUILD.parent.parent.name == "instruct_tpu_torch"
    assert (native.BUILD / native.LIB_NAME).exists()


@pytest.mark.parametrize("mode,ploid,autopoly,track", [
    (0, 2, True, False), (1, 2, True, True), (2, 2, True, False),
    (3, 2, True, True), (4, 2, True, False), (5, 2, True, True),
    (2, 4, True, True), (2, 4, False, False), (2, 4, False, True),
])
def test_estimate_bytes_matches_jax(tmp_path, mode, ploid, autopoly, track):
    f = tmp_path / "panel.txt"
    if ploid == 4:
        loader.write_panel(synthetic_tetra_panel(N_INDV, N_LOCI, n_pops=2,
                                                 n_alleles=4, seed=2),
                           str(f), data_fmt=1)
        kw = dict(ploid=4, data_fmt=1)
    else:
        write_diploid(f, seed=9, kind="multi")
        kw = dict(ploid=2)
    data = loader.read_data(str(f), log=io.StringIO(), **kw).data
    jdata = jloader.read_data(str(f), log=io.StringIO(), **kw).data
    sched = dict(n_iter=100, burnin=50, thinning=5, n_chains=3, ckrep=5,
                 nstep_check_empty_cluster=5)
    spec = dict(mode=mode, ploid=ploid, n_pops=3, autopoly=autopoly)
    got = estimate_bytes(ModelSpec(**spec), Schedule(**sched), data, track)
    want = j_estimate_bytes(JModelSpec(**spec), JSchedule(**sched), jdata,
                            track)
    assert got == want
    assert set(got) == {"dataset_bytes", "per_chain_bytes", "total_bytes"}
