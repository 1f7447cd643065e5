"""Tetraploid genotype combinatorics, built on the host as dense tables.

The port's own copy of ``instruct_tpu/tetra/combinatorics.py`` (numpy only;
the port imports nothing of the JAX package).

The reference enumerates unordered genotype classes per distinct-allele
count (auto_geno_num/list, allo_geno_num/list, poly_geno.c:1698-1800,
2031-2119), packs ordered genotypes as base-n integers, and does O(G)
`find_id` linear scans per lookup (poly_geno.c:2367-2381).  Here every
lookup becomes a precomputed dense table gathered on device:

  * genotype classes in the reference's canonical order (categories:
    auto {iiii, iiij, iijj, iijk, ijkl}; allo {(ii)(kk), (ii)(kl),
    (ij)(kk), (ij)(kl)}), with their canonical 4-tuples;
  * packed-code -> class-index lookup [n^4] (replaces find_id);
  * log-multiplicity per class (the distinct orderings: auto 1/4/6/12/24,
    allo 1/2/2/4 — the constants of cal_lkd_props, poly_geno.c:678-702);
  * the **selfing-transition matrix A** with A[g', g] = P(offspring class
    g' | selfed parent class g), generated from first-principles gamete
    enumeration — autotetraploid gametes are the 6 unordered pairs drawn
    from the parent's 4 allele copies (tetrasomic/bivalent inheritance),
    allotetraploid gametes take one allele per subgenome (disomic).  The
    reference hand-codes the induced coefficients in its staged
    back-substitution (auto_genfreq/allo_genfreq, poly_geno.c:1803-2304)
    and in a dead-code full-matrix routine (poly_geno.c:2671-3056); the
    generated A reproduces those coefficients exactly (tested) and lets the
    selfing equilibrium (I - s A) P = (1 - s) R be one batched linear
    solve instead of per-locus scalar recursions;
  * candidate-ordering patterns for the latent-genotype Gibbs move
    (two/tri/tetra_allele_{auto,allo}, poly_geno.c:2440-2638).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

# Ordering patterns: indices into the sorted distinct-allele list of an
# individual-locus observation, one row per candidate latent ordering.
# Transcribed from two_allele_auto (poly_geno.c:2440-2462) etc.
AUTO_PATTERNS = {
    1: np.array([[0, 0, 0, 0]]),
    2: np.array([[0, 0, 0, 1],        # A1A1A1A2
                 [1, 1, 1, 0],        # A2A2A2A1
                 [0, 0, 1, 1]]),      # A1A1A2A2
    3: np.array([[0, 0, 1, 2],        # A1A1A2A3
                 [1, 1, 0, 2],        # A2A2A1A3
                 [2, 2, 0, 1]]),      # A3A3A1A2
    4: np.array([[0, 1, 2, 3]]),
}
ALLO_PATTERNS = {
    1: np.array([[0, 0, 0, 0]]),
    2: np.array([[0, 0, 0, 1], [0, 1, 0, 0], [0, 0, 1, 1], [1, 1, 0, 0],
                 [0, 1, 1, 1], [1, 1, 0, 1], [0, 1, 0, 1]]),
    # (poly_geno.c:2465-2507: A1A1+A1A2, A1A2+A1A1, A1A1+A2A2, A2A2+A1A1,
    #  A1A2+A2A2, A2A2+A1A2, A1A2+A1A2)
    3: np.array([[0, 0, 1, 2], [1, 2, 0, 0], [1, 1, 0, 2], [0, 2, 1, 1],
                 [2, 2, 0, 1], [0, 1, 2, 2], [0, 1, 1, 2], [1, 2, 0, 1],
                 [1, 2, 0, 2], [0, 2, 1, 2], [0, 2, 0, 1], [0, 1, 0, 2]]),
    # (poly_geno.c:2533-2600)
    4: np.array([[0, 1, 2, 3], [2, 3, 0, 1], [0, 2, 1, 3], [1, 3, 0, 2],
                 [0, 3, 1, 2], [1, 2, 0, 3]]),
    # (poly_geno.c:2602-2638)
}
MAX_PATTERNS = {True: 3, False: 12}   # max candidate count (auto, allo)


def _auto_canonical(tup: Tuple[int, int, int, int]) -> Tuple[int, ...]:
    """Canonical ordered 4-tuple of an auto multiset, following the writing
    rules of check_rule_auto (poly_geno.c:1396-1421): iiii; iiij (triple
    first); iijj with i<j; iijk doubled first then j<k; ijkl ascending."""
    c = sorted(tup)
    counts = {a: c.count(a) for a in set(c)}
    distinct = sorted(counts)
    if len(distinct) == 1:
        return tuple(c)
    if len(distinct) == 2:
        a, b = distinct
        if counts[a] == 3:
            return (a, a, a, b)
        if counts[b] == 3:
            return (b, b, b, a)
        return (a, a, b, b)
    if len(distinct) == 3:
        dbl = [a for a in distinct if counts[a] == 2][0]
        rest = sorted(a for a in distinct if a != dbl)
        return (dbl, dbl, rest[0], rest[1])
    return tuple(sorted(tup))


def _allo_canonical(g1: Tuple[int, int], g2: Tuple[int, int]
                    ) -> Tuple[int, ...]:
    """Canonical allo 4-tuple: each subgenome pair sorted ascending
    (check_rule_allo, poly_geno.c:1451-1473); subgenomes NOT exchangeable
    (subgenome 1 -> freq, subgenome 2 -> freq2)."""
    return tuple(sorted(g1)) + tuple(sorted(g2))


def _pack(tup, n):
    v = 0
    for a in tup:
        v = v * n + a
    return v


def _auto_classes(n: int) -> List[Tuple[int, ...]]:
    """All auto genotype classes in the reference's list order
    (auto_geno_list, poly_geno.c:1718-1800): mono; simplex pairs
    (iiij, jjji per i<j); duplex (iijj); triples (iijk, jjik, kkij per
    i<j<k); quads ascending."""
    out = []
    for i in range(n):
        out.append((i, i, i, i))
    for i in range(n - 1):
        for j in range(i + 1, n):
            out.append((i, i, i, j))
            out.append((j, j, j, i))
    for i in range(n - 1):
        for j in range(i + 1, n):
            out.append((i, i, j, j))
    for i in range(n - 2):
        for j in range(i + 1, n - 1):
            for k in range(j + 1, n):
                out.append((i, i, j, k))
                out.append((j, j, i, k))
                out.append((k, k, i, j))
    for quad in itertools.combinations(range(n), 4):
        out.append(tuple(quad))
    return out


def _allo_classes(n: int) -> List[Tuple[int, ...]]:
    """Allo classes in the reference's order (allo_geno_list,
    poly_geno.c:2050-2119): (ii)(kk) all i,k; (ii)(kl) k<l; (ij)(kk) i<j;
    (ij)(kl) i<j, k<l."""
    out = []
    for i in range(n):
        for k in range(n):
            out.append((i, i, k, k))
    for i in range(n):
        for k in range(n - 1):
            for l in range(k + 1, n):
                out.append((i, i, k, l))
    for i in range(n - 1):
        for j in range(i + 1, n):
            for k in range(n):
                out.append((i, j, k, k))
    for i in range(n - 1):
        for j in range(i + 1, n):
            for k in range(n - 1):
                for l in range(k + 1, n):
                    out.append((i, j, k, l))
    return out


def _multiplicity_auto(tup) -> int:
    """Distinct orderings of the multiset: 24 / prod(count!)."""
    c = [tup.count(a) for a in set(tup)]
    denom = 1
    for x in c:
        f = 1
        for i in range(2, x + 1):
            f *= i
        denom *= f
    return 24 // denom


def _multiplicity_allo(tup) -> int:
    m = 1
    if tup[0] != tup[1]:
        m *= 2
    if tup[2] != tup[3]:
        m *= 2
    return m


def _selfing_matrix_auto(classes, class_of) -> np.ndarray:
    """A[g', g] = P(selfed offspring in class g' | parent class g):
    gametes are the 6 unordered pairs of the parent's 4 copies; two
    independent gametes form the offspring (tetrasomic inheritance).
    Reproduces the reference's staged coefficients (e.g. diag 10/36 for
    iijk, 1/6 for ijkl; poly_geno.c:1865, 1823)."""
    g_count = len(classes)
    a = np.zeros((g_count, g_count))
    pairs = list(itertools.combinations(range(4), 2))
    for gi, parent in enumerate(classes):
        for p1 in pairs:
            gam1 = (parent[p1[0]], parent[p1[1]])
            for p2 in pairs:
                gam2 = (parent[p2[0]], parent[p2[1]])
                child = _auto_canonical(gam1 + gam2)
                a[class_of[child], gi] += 1.0 / 36.0
    return a


def _selfing_matrix_allo(classes, class_of) -> np.ndarray:
    """Allo: a gamete takes one allele from each subgenome (disomic);
    offspring subgenome pairs recombine independently."""
    g_count = len(classes)
    a = np.zeros((g_count, g_count))
    for gi, parent in enumerate(classes):
        s1, s2 = parent[:2], parent[2:]
        gametes = [(x, y) for x in s1 for y in s2]     # 4, each 1/4
        for g1 in gametes:
            for g2 in gametes:
                child = _allo_canonical((g1[0], g2[0]), (g1[1], g2[1]))
                a[class_of[child], gi] += 1.0 / 16.0
    return a


@dataclasses.dataclass
class ClassTables:
    """Stacked, padded per-allele-count tables (device-ready NumPy)."""

    allele_counts: np.ndarray     # [C] distinct allele counts, ascending
    g_count: np.ndarray           # [C] genotypes per class set
    g_max: int
    n_max: int
    digits: np.ndarray            # [C, G_max, 4] canonical tuples (0 pad)
    valid: np.ndarray             # [C, G_max] genotype-slot mask
    log_mult: np.ndarray          # [C, G_max]
    lookup: np.ndarray            # [C, n_max^4] packed code -> class idx
    self_mat: np.ndarray          # [C, G_max, G_max] selfing transition A
    subgenome2: np.ndarray        # [4] bool: slots served by freq2 (allo)
    autopoly: bool

    def class_of_locus(self, n_alleles: np.ndarray) -> np.ndarray:
        """cls[l]: index into the table stack for each locus."""
        idx = np.searchsorted(self.allele_counts, n_alleles)
        idx = np.clip(idx, 0, len(self.allele_counts) - 1)
        return idx.astype(np.int32)


def build_class_tables(n_alleles: np.ndarray, autopoly: bool) -> ClassTables:
    counts = sorted(set(int(x) for x in np.asarray(n_alleles) if x >= 1))
    if not counts:
        counts = [2]
    n_max = max(max(counts), 2)
    all_classes = []
    for n in counts:
        cls = _auto_classes(n) if autopoly else _allo_classes(n)
        all_classes.append(cls)
    g_max = max(len(c) for c in all_classes)
    c_num = len(counts)

    digits = np.zeros((c_num, g_max, 4), np.int32)
    valid = np.zeros((c_num, g_max), bool)
    log_mult = np.zeros((c_num, g_max), np.float32)
    lookup = np.zeros((c_num, n_max ** 4), np.int32)
    self_mat = np.zeros((c_num, g_max, g_max), np.float32)
    g_count = np.zeros(c_num, np.int32)

    for ci, (n, classes) in enumerate(zip(counts, all_classes)):
        g = len(classes)
        g_count[ci] = g
        class_of: Dict[Tuple[int, ...], int] = {c: i
                                                for i, c in enumerate(classes)}
        for gi, tup in enumerate(classes):
            digits[ci, gi] = tup
            valid[ci, gi] = True
            mult = (_multiplicity_auto(tup) if autopoly
                    else _multiplicity_allo(tup))
            log_mult[ci, gi] = np.log(mult)
        # packed lookup over every ordered 4-tuple of alleles < n
        for tup in itertools.product(range(n), repeat=4):
            canon = (_auto_canonical(tup) if autopoly
                     else _allo_canonical(tup[:2], tup[2:]))
            lookup[ci, _pack(tup, n_max)] = class_of[canon]
        a = (_selfing_matrix_auto(classes, class_of) if autopoly
             else _selfing_matrix_allo(classes, class_of))
        self_mat[ci, :g, :g] = a

    return ClassTables(
        allele_counts=np.asarray(counts, np.int32),
        g_count=g_count, g_max=g_max, n_max=n_max,
        digits=digits, valid=valid, log_mult=log_mult, lookup=lookup,
        self_mat=self_mat,
        subgenome2=np.array([False, False, True, True]),
        autopoly=autopoly,
    )


def pack_codes(geno: np.ndarray, n_max: int) -> np.ndarray:
    """Base-n_max packed code of ordered genotypes [..., 4] -> [...]."""
    return (((geno[..., 0] * n_max + geno[..., 1]) * n_max
             + geno[..., 2]) * n_max + geno[..., 3])
