"""Input-file parsing for both reference data formats.

Counterpart of ``instruct_tpu/data/loader.py`` (a copy: that package's
``__init__`` imports JAX): the same parse, the same recode and the same
:class:`Panel`, built through this package's ``make_dataset`` on the host.
:data:`last_parse` records whether the last :func:`read_data` took the
native tokenizer (``"native"``) or the pure-Python parser (``"python"``).

Format 1 (`-af 0`, the default): one *haploid* per line — each individual
occupies `ploid` consecutive lines (read_data_fmt1, data_interface.c:91-128;
line grammar in read_data_from_file, data_interface.c:133-245).

Format 2 (`-af 1`): one individual per line, loci-major allele columns
(read_data_fmt2 / read_data_from_file2, data_interface.c:247-350, 671-707).

Both formats share the line structure
    [label] [popdata] [extra_col...] <alleles...>
with an optional marker-name header line (`-w 1`).  Alleles are arbitrary
strings recoded to dense integers per locus in order of first appearance
(transform_data, data_interface.c:489-569); monomorphic loci are dropped for
diploids with a notice (data_interface.c:524-548).  For tetraploids the
observed *set* of distinct alleles per (indiv, locus) is kept sorted and the
ordered genotype stays latent (transform_data2, data_interface.c:571-669).

N and L are always inferred from the file, correcting the user-supplied
values with a warning, never an error (cnt_loci/cnt_lines,
data_interface.c:356-487).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from instruct_tpu_torch.data.dataset import Panel, make_dataset

MISSING_CODE = -9  # transform_data's missing_num (data_interface.c:494)

last_parse: Optional[str] = None   # "native" or "python", set by read_data


def _tokenize(path: str) -> List[List[str]]:
    with open(path) as fh:
        lines = [ln.split() for ln in fh]
    return [ln for ln in lines if ln]


def _try_native_grid(path: str, meta_cols: int):
    """Native fast path (instruct_tpu_torch.native): C tokenizer returns the
    integer token grid; usable when every line has the same token count and
    all allele tokens are integers (the overwhelmingly common case — the
    reference's own examples use integer allele codes).  Returns
    (allele_grid int64[n_lines, n_allele_cols], n_lines) or None."""
    from instruct_tpu_torch import native
    tok = native.tokenize_file(path)
    if tok is None:
        return None
    values, per_line = tok
    if per_line.size == 0 or not (per_line == per_line[0]).all():
        return None
    cols = int(per_line[0])
    if cols <= meta_cols:
        return None
    grid = values.reshape(per_line.size, cols)[:, meta_cols:]
    if (grid == native.NONINT).any():
        return None
    return grid


def _meta_columns(path: str, meta_cols: int) -> List[List[str]]:
    """Only the leading meta tokens of each line (cheap maxsplit scan)."""
    out = []
    with open(path) as fh:
        for ln in fh:
            parts = ln.split(None, meta_cols)
            if parts:
                out.append(parts[:meta_cols])
    return out


def _recode_columns_fast(col: np.ndarray, missing_val: Optional[int]):
    """First-appearance-order integer recode of one locus column
    (transform_data semantics, data_interface.c:510-547), vectorized."""
    mask = (col != missing_val) if missing_val is not None \
        else np.ones(col.shape, bool)
    obs = col[mask]
    if obs.size == 0:
        return np.zeros_like(col, dtype=np.int32), ~mask, []
    uniq, first = np.unique(obs, return_index=True)
    order = np.argsort(np.argsort(first))     # rank by first appearance
    pos = np.searchsorted(uniq, col)
    pos = np.clip(pos, 0, uniq.size - 1)
    codes = order[pos].astype(np.int32)
    codes[~mask] = 0
    types = [str(v) for v in uniq[np.argsort(first)]]
    return codes, ~mask, types


def read_data(
    path: str,
    ploid: int = 2,
    missing: str = "-9",
    label: int = 1,
    popdata: int = 1,
    n_extra_col: int = 0,
    markername: int = 0,
    data_fmt: int = 0,
    log=sys.stdout,
) -> Panel:
    """Parse a genotype file into a :class:`Panel` (read_data,
    data_interface.c:36-86)."""
    global last_parse
    meta_cols_early = label + popdata + n_extra_col
    if ploid == 2 and not markername:
        fast = _fast_read_diploid(path, missing, label, popdata,
                                  n_extra_col, data_fmt, log)
        if fast is not None:
            last_parse = "native"
            return fast

    last_parse = "python"
    rows = _tokenize(path)
    marker_names = None
    if markername:
        marker_names = rows[0]
        rows = rows[1:]

    meta_cols = meta_cols_early
    if data_fmt == 0 and ploid == 2:
        n_loci_raw = len(rows[0]) - meta_cols
        if len(rows) % ploid != 0:
            raise ValueError(
                "Some individuals do not have two copies of haplotype!")
        n_indv = len(rows) // ploid
        alleles = np.empty((n_indv, n_loci_raw, ploid), dtype=object)
        names, pops = [], []
        for i in range(n_indv):
            block = rows[i * ploid:(i + 1) * ploid]
            for c, line in enumerate(block):
                if len(line) != meta_cols + n_loci_raw:
                    raise ValueError(
                        "The lines of input files do not have the same "
                        "number of tokens!")
                alleles[i, :, c] = line[meta_cols:]
            if label:
                if block[1][0] != block[0][0]:
                    raise ValueError(
                        "Some individuals have different number of "
                        "haplotypes!")
                names.append(block[0][0])
            if popdata:
                pops.append(block[0][label])
    else:
        n_loci_raw = (len(rows[0]) - meta_cols) // ploid
        n_indv = len(rows)
        alleles = np.empty((n_indv, n_loci_raw, ploid), dtype=object)
        names, pops = [], []
        for i, line in enumerate(rows):
            if len(line) != meta_cols + n_loci_raw * ploid:
                raise ValueError(
                    "The lines of input files do not have the same number "
                    "of tokens!")
            toks = line[meta_cols:]
            for j in range(n_loci_raw):
                # loci-major: copies of locus j are consecutive
                # (data_interface.c:330-334)
                alleles[i, j, :] = toks[j * ploid:(j + 1) * ploid]
            if label:
                names.append(line[0])
            if popdata:
                pops.append(line[label])

    pop_names: List[str] = []
    pop_index = None
    if popdata:
        pop_index = np.zeros(n_indv, dtype=np.int32)
        for i, pname in enumerate(pops):
            if pname not in pop_names:
                pop_names.append(pname)
            pop_index[i] = pop_names.index(pname)

    if ploid == 2:
        return _recode_diploid(alleles, missing, names, pop_index, pop_names,
                               marker_names, log)
    return _recode_tetra(alleles, missing, names, pop_index, pop_names,
                         marker_names, log)


def _fast_read_diploid(path, missing, label, popdata, n_extra_col,
                       data_fmt, log) -> Optional[Panel]:
    """Native-tokenizer fast path for integer-coded diploid panels; returns
    None (caller falls back to the Python path) for ragged lines,
    non-integer alleles, or a missing toolchain.  Produces a Panel
    identical to :func:`_recode_diploid` (tested)."""
    meta_cols = label + popdata + n_extra_col
    grid = _try_native_grid(path, meta_cols)
    if grid is None:
        return None
    try:
        missing_val: Optional[int] = int(missing)
    except ValueError:
        missing_val = None
    n_lines = grid.shape[0]
    if data_fmt == 0:
        if n_lines % 2:
            return None
        n = n_lines // 2
        l_raw = grid.shape[1]
        alleles3 = grid.reshape(n, 2, l_raw).transpose(0, 2, 1)
        meta_stride = 2
    else:
        n = n_lines
        if grid.shape[1] % 2:
            return None
        l_raw = grid.shape[1] // 2
        alleles3 = grid.reshape(n, l_raw, 2)
        meta_stride = 1

    names = pops = None
    if meta_cols:
        meta = _meta_columns(path, meta_cols)
        if len(meta) != n_lines:
            return None
        meta = meta[::meta_stride]
        if label:
            names = [m[0] for m in meta]
        if popdata:
            pops = [m[label] for m in meta]
    pop_names: List[str] = []
    pop_index = None
    if pops is not None:
        pop_index = np.zeros(n, dtype=np.int32)
        for i, pname in enumerate(pops):
            if pname not in pop_names:
                pop_names.append(pname)
            pop_index[i] = pop_names.index(pname)

    keep, geno_cols, miss_cols, allele_tables = [], [], [], []
    for j in range(l_raw):
        col = alleles3[:, j, :].reshape(-1)
        codes, miss_tok, types = _recode_columns_fast(col, missing_val)
        if len(types) < 2:
            print(f"The locus {j + 1} is not polymorphic.", file=log)
            continue
        keep.append(j)
        allele_tables.append(types)
        geno_cols.append(codes.reshape(n, 2))
        miss_cols.append(miss_tok.reshape(n, 2).any(axis=1))
    l = len(keep)
    print(f"The number of polymorphic loci is {l} now.", file=log)
    if l == 0:
        return None
    geno = np.stack(geno_cols, axis=1)
    miss = np.stack(miss_cols, axis=1)
    n_alleles = np.array([len(t) for t in allele_tables], np.int32)
    data = make_dataset(geno, miss, n_alleles)
    return Panel(data=data, indv_names=names, pop_index=pop_index,
                 pop_names=pop_names or None, marker_names=None,
                 allele_names=allele_tables, n_alleles=n_alleles)


def _recode_diploid(alleles, missing, names, pop_index, pop_names,
                    marker_names, log) -> Panel:
    """transform_data (data_interface.c:489-569): integer recode in order of
    first appearance, drop monomorphic loci."""
    n, l_raw, p = alleles.shape
    keep, geno_cols, miss_cols, allele_tables = [], [], [], []
    for j in range(l_raw):
        types: List[str] = []
        for i in range(n):
            for c in range(p):
                tok = alleles[i, j, c]
                if tok != missing and tok not in types:
                    types.append(tok)
        if len(types) < 2:
            print(f"The locus {j + 1} is not polymorphic.", file=log)
            continue
        keep.append(j)
        allele_tables.append(types)
        idx = {t: m for m, t in enumerate(types)}
        g = np.zeros((n, p), np.int32)
        m = np.zeros(n, bool)
        for i in range(n):
            for c in range(p):
                tok = alleles[i, j, c]
                if tok == missing:
                    m[i] = True
                else:
                    g[i, c] = idx[tok]
        geno_cols.append(g)
        miss_cols.append(m)
    l = len(keep)
    print(f"The number of polymorphic loci is {l} now.", file=log)
    geno = np.stack(geno_cols, axis=1)                       # [N, L, P]
    miss = np.stack(miss_cols, axis=1)                       # [N, L]
    n_alleles = np.array([len(t) for t in allele_tables], np.int32)
    data = make_dataset(geno, miss, n_alleles)
    return Panel(data=data, indv_names=names or None, pop_index=pop_index,
                 pop_names=pop_names or None,
                 marker_names=([marker_names[j] for j in keep]
                               if marker_names else None),
                 allele_names=allele_tables, n_alleles=n_alleles)


def _recode_tetra(alleles, missing, names, pop_index, pop_names,
                  marker_names, log) -> Panel:
    """transform_data2 (data_interface.c:571-669): keep every locus; store
    the sorted set of distinct observed alleles and its size (`alleleid`);
    a locus with no observed allele is missing (alleleid 0)."""
    n, l, p = alleles.shape
    allele_tables = []
    distinct = np.full((n, l, p), MISSING_CODE, np.int32)
    n_distinct = np.zeros((n, l), np.int32)
    n_alleles = np.zeros(l, np.int32)
    for j in range(l):
        types: List[str] = []
        for i in range(n):
            for c in range(p):
                tok = alleles[i, j, c]
                if tok != missing and tok not in types:
                    types.append(tok)
        allele_tables.append(types)
        n_alleles[j] = len(types)
        idx = {t: m for m, t in enumerate(types)}
        for i in range(n):
            seen = sorted({idx[alleles[i, j, c]] for c in range(p)
                           if alleles[i, j, c] != missing})
            n_distinct[i, j] = len(seen)
            for m, v in enumerate(seen):
                distinct[i, j, m] = v
    miss = n_distinct == 0
    geno = np.where(distinct == MISSING_CODE, 0, distinct)
    data = make_dataset(geno, miss, n_alleles, distinct=geno,
                        n_distinct=n_distinct)
    return Panel(data=data, indv_names=names or None, pop_index=pop_index,
                 pop_names=pop_names or None, marker_names=marker_names,
                 allele_names=allele_tables, n_alleles=n_alleles)


def write_panel(panel: Panel, path: str, data_fmt: int = 0,
                missing: str = "-9") -> None:
    """Serialize a Panel to the reference's input format (inverse of
    :func:`read_data` for ``data_fmt=0`` diploid and ``data_fmt=1`` files):
    allele code a is written as ``100 + a``, a missing site as ``missing``.
    Writes the same bytes as the JAX package's ``write_panel``, a line at a
    time from numpy rows."""
    geno = panel.data.geno3.astype(np.int64)
    site_valid = panel.data.site_valid.cpu().numpy()
    n, l, p = geno.shape
    if panel.data.n_distinct is not None:
        # tetraploid: only the first n_distinct slots are real alleles; pad
        # the rest by repeating the first allele (same distinct set, which
        # is all transform_data2 keeps -- data_interface.c:571-669)
        nd = panel.data.n_distinct.cpu().numpy()
        slot = np.arange(p)[None, None, :]
        geno = np.where(slot < nd[:, :, None], geno, geno[:, :, :1])
    names = panel.indv_names or [f"ind{i}" for i in range(n)]
    pops = (np.asarray(panel.pop_index) if panel.pop_index is not None
            else np.zeros(n, np.int32))
    pop_names = panel.pop_names or [f"pop{k}"
                                    for k in range(int(pops.max()) + 1)]

    def tokens(i, codes, valid):
        toks = np.where(valid, (100 + codes).astype(str), missing)
        return " ".join([names[i], pop_names[pops[i]], *toks.tolist()])

    with open(path, "w") as fh:
        for i in range(n):
            if data_fmt == 0:
                for c in range(p):
                    fh.write(tokens(i, geno[i, :, c], site_valid[i]) + "\n")
            else:
                # loci-major: copies of locus j are consecutive
                fh.write(tokens(i, geno[i].reshape(-1),
                                np.repeat(site_valid[i], p)) + "\n")


def read_init(path: Optional[str], n_chains: int, n_rates: int,
              rng: Optional[np.random.Generator] = None):
    """Initial S/F vectors per chain: `>name` blocks followed by one line of
    values (read_init, initial.c:38-126); chains beyond those listed (or all
    of them when path is None) get U(0,1) draws and names "Chain#i"."""
    rng = rng or np.random.default_rng(0)
    init = rng.uniform(size=(n_chains, n_rates)).astype(np.float32)
    names = [f"Chain#{i + 1}" for i in range(n_chains)]
    if path is None:
        return init, names
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    blocks = []
    i = 0
    while i < len(lines):
        if lines[i].startswith(">"):
            name = lines[i][1:].strip()
            vals = [float(x) for x in lines[i + 1].split()]
            blocks.append((name, vals))
            i += 2
        else:
            i += 1
    if len(blocks) > n_chains:
        raise ValueError("The number of chain starting points is greater "
                         "than the number of chains!")
    for c, (name, vals) in enumerate(blocks):
        if len(vals) != n_rates:
            raise ValueError(
                "The number of initial values for selfing rates is not "
                "equal the number of subpopulation assumed!")
        init[c] = vals
        names[c] = name
    return init, names
