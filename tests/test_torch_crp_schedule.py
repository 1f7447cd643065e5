"""The seating kernel's order of work (``instruct_tpu_torch/csrc/crp.cu``)
emulated on the CPU and held bitwise to the plain version
``kernels/crp.py:crp_sweep_reference`` in its three variants.

The emulation follows the kernel's schedule: producer warps fill a ring of
``RING_DEPTH`` entries, row j's entry only once row j - ``RING_DEPTH`` has
been seated, with the noise columns 0 .. W_j (W_j = hi at step j -
RING_DEPTH + 1, plus RING_DEPTH - 1; hi_0 + j for the first rows) that fit
the ring's width, each Philox block giving its 4 consecutive elements; the
seater owns slot s by lane s % 32 (the first ``REG_SLOTS`` in registers,
their noise and the next row's header read a step ahead), removes, scores
each lane's slots in order (the first index keeps a tie inside a lane),
takes the maximum key
over the lanes and the least choice index holding it, the least first-empty
slot, reads the log counts from the ``logc`` table, and reads the columns
past the ring's width from the spill the producers wrote.  Every read of a
noise column is checked to have been produced.  Cases: N = 1, 2, 37 and
300, alpha 0.5, 10 and 10^4 (crowded), the plan's ring and a ring of 68
columns (spilled columns from table 68 on; the kernel keeps its register
slots' columns, 1..64, in the ring),
and injected noise planes with exact ties between tables and with the new
table.  Then the launch plan (``crp_plan``) for N up to 20 000 and the
latency floor's plain version.  No JAX: the plain version is held to the
JAX package in ``tests/test_torch_dpm.py``."""

import numpy as np
import pytest
import torch

from instruct_tpu_torch.kernels import crp
from instruct_tpu_torch.kernels import philox as px

C = 2
LANES = 32
NEG = np.float32(crp._NEG)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def order_key(x: np.ndarray) -> np.ndarray:
    """``csrc/crp.cu:order_key``: unsigned keys that order as the floats
    (-0 first made +0)."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def slog(x) -> np.ndarray:
    """The plain version's ``_slog`` (torch's float32 log)."""
    return crp._slog(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def gumbel_words(words: torch.Tensor) -> np.ndarray:
    return px.gumbel(words).numpy()


class Ring:
    """The noise ring of one chain: row j's columns as the producer of row
    j fills them, a Philox block at a time (or from an injected plane)."""

    def __init__(self, keys, step, chain, n, width, plane):
        self.keys, self.step, self.chain = keys, step, chain
        self.n, self.width, self.plane = n, width, plane
        self.rows = {}

    def produce(self, j: int, w: int):
        """Row j's columns 0..w: those below the width into the entry,
        the rest into its spill row."""
        n1 = self.n + 1
        last = w
        row = np.full(n1, np.nan, np.float32)
        made = np.zeros(n1, bool)
        if self.plane is not None:
            row[:last + 1] = self.plane[j, :last + 1]
        else:
            e0, e1 = j * n1, j * n1 + last
            blocks = torch.arange(e0 >> 2, (e1 >> 2) + 1, dtype=torch.int64)
            ck = int(self.keys.chain_key[self.chain])
            words = px.philox4x32_10(blocks, px.STREAM_DPM_SEAT, self.step,
                                     ck, self.keys.k0, self.keys.k1)
            noise = gumbel_words(torch.stack(words, 1).reshape(-1))
            el = np.arange(4 * (e0 >> 2), 4 * (e0 >> 2) + noise.size)
            take = (el >= e0) & (el <= e1)
            row[el[take] - e0] = noise[take]
        made[:last + 1] = True
        self.rows[j] = (row, made)

    def read(self, j: int, cols: np.ndarray) -> np.ndarray:
        row, made = self.rows[j]
        assert made[cols].all(), (f"row {j} reads ring columns "
                                  f"{cols[~made[cols]]}, not produced")
        return row[cols]

    def free(self, j: int):
        del self.rows[j]


def lane_of(choice: np.ndarray) -> np.ndarray:
    """The lane that scores a choice: slot s = choice - 1 is lane s % 32's;
    lane 0 also scores the new table (choice 0), first."""
    return np.where(choice == 0, 0, (choice - 1) % LANES)


def seater_emulation(keys, step, variant, values, counts, assign, log_new,
                     new_val, *, gen=None, ll_grid=None, new_idx=None,
                     gumbel=None, width=None, depth=crp.RING_DEPTH):
    """(values, counts, assign) as ``csrc/crp.cu`` seats them, chain by
    chain, and per chain the statistics {spill: columns read past the
    ring, ties: steps whose best key two choices hold, new_ties: those
    where one is the new table}."""
    c, n = log_new.shape
    m = ll_grid.shape[2] if variant == crp.INBREEDING else 0
    if width is None:
        width = crp.crp_plan(n, m, variant)["width"]
    logc = slog(np.arange(n + 1))
    zero = np.float32(0.0)
    out_v, out_c, out_a, stats = [], [], [], []
    for ci in range(c):
        if variant == crp.PRIOR:
            val = np.zeros(n, np.float32)
            cnt = np.zeros(n, np.int64)
            asg = np.zeros(n, np.int64)
        else:
            val = values[ci].numpy().copy()
            cnt = counts[ci].numpy().astype(np.int64)
            asg = assign[ci].numpy().astype(np.int64)
        y = logc[cnt]
        z = np.zeros(n, np.float32)
        w_ = np.zeros(n, np.float32)
        vidx = np.zeros(n, np.int64)
        if variant == crp.SELFING:
            z, w_ = slog(val), slog(np.float32(1.0) - val)
            g1 = (gen[ci].numpy() - 1).astype(np.float32)
        elif variant == crp.INBREEDING:
            vidx = np.clip((val * np.float32(m)).astype(np.int32), 0, m - 1)
            ll = ll_grid[ci].numpy()
        ln = log_new[ci].numpy()
        nv = new_val[ci].numpy()
        nlv, nl1v = slog(nv), slog(np.float32(1.0) - nv)
        ring = Ring(keys, step, ci, n, width,
                    None if gumbel is None else gumbel[ci].numpy())
        occupied = np.nonzero(cnt > 0)[0]
        hi = int(occupied[-1]) + 1 if occupied.size else 0
        hi_start = [hi]            # hi at the start of each step
        st = dict(spill=0, ties=0, new_ties=0)
        reg = np.arange(n) < crp.REG_SLOTS

        def produce(j):
            # the producer of row j, once row j - depth has been seated:
            # the columns 0 .. W_j + 1
            j0 = max(0, j - depth + 1)
            ring.produce(j, min(n, hi_start[j0] + (j - j0) + 1))

        def read_ahead(j, bound):
            # row j's column 0 and its register slots' columns below
            # bound + 1, occupied or not
            s = np.nonzero(reg[:bound])[0]
            ring.read(j, np.append(0, s + 1))
            return bound

        produce(0)
        ahead = read_ahead(0, min(n, hi + 1))
        for j in range(n):
            if j + 1 < n:
                produce(j + 1)
            if variant != crp.PRIOR:
                old = asg[j]
                cnt[old] -= 1
                y[old] = logc[cnt[old]]
            # each slot below hi + 1 scored by its owner lane
            lim = min(n, hi + 1)
            occ = cnt[:lim] > 0
            t = y[:lim].copy()
            if variant == crp.SELFING:
                t = t + (np.where(g1[j] > 0, g1[j] * z[:lim], zero)
                         + w_[:lim])
            elif variant == crp.INBREEDING:
                t = t + ll[j, vidx[:lim]]
            cols = np.arange(1, lim + 1)
            noise = np.zeros(lim, np.float32)
            # a register slot's noise was read a step ahead; the slots
            # past the registers read every column below lim + 1
            assert (cols[occ & reg[:lim]] <= ahead).all()
            ring.read(j, cols[~reg[:lim]])
            noise[occ] = ring.read(j, cols[occ])
            st["spill"] += int((occ & (cols >= width)).sum())
            if j + 1 < n:
                ahead = read_ahead(j + 1, min(n, hi + 2))
            score = np.where(occ, t + noise, NEG).astype(np.float32)
            keys_all = np.concatenate([order_key(ln[j] + ring.read(
                j, np.zeros(1, np.int64))), order_key(score)])
            choices = np.arange(lim + 1)
            lanes = lane_of(choices)
            # a lane: its choices in order, the first at its largest key;
            # then the largest key over the lanes and the least choice
            # holding it; the least first-empty slot
            best_key, best_idx, first_free = [], [], []
            for lane in range(LANES):
                mine = choices[lanes == lane]
                if mine.size:
                    i = int(np.argmax(keys_all[mine]))
                    best_key.append(keys_all[mine[i]])
                    best_idx.append(mine[i])
                empty = mine[(mine >= 1) & ~np.append(True, occ)[mine]]
                if empty.size:
                    first_free.append(empty[0] - 1)
            best_key = np.array(best_key, np.uint32)
            top = best_key.max()
            choice = int(np.array(best_idx)[best_key == top].min())
            free = int(min(first_free))
            hits = np.nonzero(keys_all == top)[0]
            st["ties"] += hits.size > 1
            st["new_ties"] += hits.size > 1 and hits[0] == 0
            slot = free if choice == 0 else choice - 1
            hi = max(hi, slot + 1)
            hi_start.append(hi)
            ring.free(j)
            if choice == 0:
                val[slot] = nv[j]
                z[slot], w_[slot] = nlv[j], nl1v[j]
                if variant == crp.INBREEDING:
                    vidx[slot] = new_idx[ci, j].item()
            cnt[slot] += 1
            y[slot] = logc[cnt[slot]]
            asg[j] = slot
        out_v.append(val)
        out_c.append(cnt)
        out_a.append(asg)
        stats.append(st)
    return (torch.from_numpy(np.stack(out_v)),
            torch.from_numpy(np.stack(out_c).astype(np.int32)),
            torch.from_numpy(np.stack(out_a).astype(np.int32))), stats


def sweep_case(variant, n, alpha, seed, m=16):
    """(args, kwargs) of one sweep of C chains from a numpy seed: a
    random table of up to 40 slots (none for the prior draw), selfing
    generations 1..11 or random grid curves, the new tables' scores and
    values as the DPM module computes them."""
    rng = np.random.default_rng(seed)
    keys = px.make_keys(seed, C, "cpu")
    la = np.float32(np.log(np.float32(alpha)))
    kw = {}
    if variant == crp.PRIOR:
        table = (None, None, None)
        log_new = np.full((C, n), la, np.float32)
    else:
        assign = rng.integers(0, min(n, 40), (C, n)).astype(np.int32)
        counts = np.stack([np.bincount(a, minlength=n) for a in assign])
        values = (rng.random((C, n)) * (counts > 0)).astype(np.float32)
        table = (torch.from_numpy(values),
                 torch.from_numpy(counts.astype(np.int32)),
                 torch.from_numpy(assign))
        if variant == crp.SELFING:
            gen = rng.integers(1, 12, (C, n)).astype(np.int32)
            gf = gen.astype(np.float32)
            log_new = (la - np.log(gf)) - np.log(gf + np.float32(1.0))
            kw["gen"] = torch.from_numpy(gen)
        else:
            ll = (rng.normal(0, 3, (C, n, m))
                  - rng.uniform(0, 40, (C, n, 1))).astype(np.float32)
            idx = rng.integers(0, m, (C, n)).astype(np.int32)
            log_new = la + ll.max(-1)
            kw.update(ll_grid=torch.from_numpy(ll),
                      new_idx=torch.from_numpy(idx))
    new_val = rng.random((C, n)).astype(np.float32)
    if variant == crp.INBREEDING:
        new_val = ((kw["new_idx"].numpy() + np.float32(0.5))
                   / np.float32(m)).astype(np.float32)
    return ((keys, 7, variant, *table,
             torch.from_numpy(log_new.astype(np.float32)),
             torch.from_numpy(new_val)), kw)


def assert_same(got, want):
    for name, a, b in zip(("values", "counts", "assign"), got, want):
        assert torch.equal(a, b), f"{name} differ"


@pytest.mark.parametrize("width", [None, 68], ids=["plan ring", "68 columns"])
@pytest.mark.parametrize("alpha", [0.5, 10.0, 1e4])
@pytest.mark.parametrize("n", [1, 2, 37, 300])
@pytest.mark.parametrize("variant", sorted(crp.VARIANTS),
                         ids=lambda v: crp.VARIANTS[v])
def test_schedule_seats_as_the_plain_version(variant, n, alpha, width):
    args, kw = sweep_case(variant, n, alpha, seed=n + int(alpha) % 97)
    occupied = []
    want = crp.crp_sweep_reference(*args, **kw, occupied=occupied)
    got, stats = seater_emulation(*args, **kw, width=width)
    assert_same(got, want)
    tables = int(torch.stack(occupied).max()) if occupied else 0
    if width == 68 and n == 300 and alpha == 1e4:
        # the crowded case reaches past the ring: spilled columns read
        assert tables > 100 and min(s["spill"] for s in stats) > 0
    if width is None:
        assert all(s["spill"] == 0 for s in stats)


def tie_case(variant, n, seed):
    """A sweep whose noise plane takes 4 values (0, 0.5, 1 and, a fifth
    of the time, 2^27, which rounds every score it is added to to 2^27),
    so that equal tables and the new table tie exactly: prior at alpha = 1 (log_new = 0 = log 1);
    selfing with everyone alone at a table of value 0.5, g = 1 and log_new
    a lone table's score, log(1 - 0.5); inbreeding with grid curves of 0
    and -1 and log_new 0."""
    rng = np.random.default_rng(seed)
    args, kw = sweep_case(variant, n, 1.0, seed)
    args = list(args)
    if variant == crp.SELFING:
        half = np.float32(0.5)
        args[3] = torch.full((C, n), 0.5)
        args[4] = torch.ones((C, n), dtype=torch.int32)
        args[5] = torch.arange(n, dtype=torch.int32).repeat(C, 1)
        kw["gen"] = torch.ones((C, n), dtype=torch.int32)
        args[6] = torch.from_numpy(np.full((C, n), slog(np.float32(1.0)
                                                        - half)))
        args[7] = torch.from_numpy(np.where(
            rng.random((C, n)) < 0.5, np.float32(0.25), half).astype(
                np.float32))
    elif variant == crp.INBREEDING:
        m = kw["ll_grid"].shape[2]
        kw["ll_grid"] = torch.from_numpy(
            -rng.integers(0, 2, (C, n, m)).astype(np.float32))
        args[6] = torch.zeros((C, n))
    plane = (rng.integers(0, 3, (C, n, n + 1)).astype(np.float32)
             * np.float32(0.5))
    # 2^27 absorbs every score below 8 in magnitude: the choices drawing it
    # tie exactly, the new table among them
    plane[rng.random(plane.shape) < 0.2] = np.float32(2.0 ** 27)
    return tuple(args), dict(kw, gumbel=torch.from_numpy(plane))


@pytest.mark.parametrize("width", [None, 68], ids=["plan ring", "68 columns"])
@pytest.mark.parametrize("n", [37, 300])
@pytest.mark.parametrize("variant", sorted(crp.VARIANTS),
                         ids=lambda v: crp.VARIANTS[v])
def test_schedule_breaks_exact_ties_as_the_plain_version(variant, n, width):
    args, kw = tie_case(variant, n, seed=3 * n + variant)
    want = crp.crp_sweep_reference(*args, **kw)
    got, stats = seater_emulation(*args, **kw, width=width)
    assert_same(got, want)
    assert sum(s["ties"] for s in stats) > 0
    assert sum(s["new_ties"] for s in stats) > 0


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("n", [1, 2, 37, 300, 1000, 2000, 5000, 8192, 8193,
                               10_000, 20_000])
def test_plan_fits_a_block(n, m):
    """The plan's shared memory (table where N <= SMEM_SLOTS, the log
    counts, the ring of RING_DEPTH entries of HEAD words, the grid row and
    the noise) stays within 227 KB in every variant; the ring holds all N
    + 1 columns up to N = 1000 at least, else a multiple of 4, at least
    512."""
    for variant in crp.VARIANTS:
        plan = crp.crp_plan(n, m, variant)
        ll = m if variant == crp.INBREEDING else 0
        assert plan["depth"] == crp.RING_DEPTH and plan["warps"] == 4
        assert plan["reg_slots"] == crp.REG_SLOTS == 64
        assert plan["smem_table"] == (n <= crp.SMEM_SLOTS)
        assert plan["stride"] == crp.HEAD + ll + -(-plan["width"] // 4) * 4
        table = 16 * n if plan["smem_table"] else 0
        assert plan["smem"] == (table + 4 * (-(-(n + 1) // 4) * 4)
                                + 4 * crp.RING_DEPTH * plan["stride"])
        assert plan["smem"] <= crp.SMEM_BUDGET
        if n <= 1000:
            assert plan["width"] == n + 1
        else:
            assert plan["width"] == n + 1 or (plan["width"] % 4 == 0
                                              and plan["width"] >= 512)


def test_plan_refuses_what_shared_memory_cannot_hold():
    crp.crp_plan(50_000, 256, crp.INBREEDING)
    with pytest.raises(ValueError, match="shared memory"):
        crp.crp_plan(60_000, 0, crp.SELFING)


@pytest.mark.parametrize("n", [0, 1, 40, 1000])
def test_warp_floor_reference_is_the_kernel_walk(n):
    """The latency floor's plain version against a scalar walk of the
    kernel's steps (32 rows of 32 words, the winner the least lane at the
    maximum, a linear congruential rewrite, the next row (max + lane) mod
    32)."""
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 31), 1 << 31, (2, 1024)).astype(np.int32)
    got = crp.warp_floor(torch.from_numpy(x), n).numpy()
    for c in range(2):
        buf = [int(v) & 0xFFFFFFFF for v in x[c]]
        row = 0
        for _ in range(n):
            v = buf[row * 32:(row + 1) * 32]
            mx = max(v)
            win = v.index(mx)
            buf[row * 32 + win] = (v[win] * 1664525 + 1013904223) \
                & 0xFFFFFFFF
            row = (mx + win) & 31
        want = np.array(buf + [row], dtype=np.uint32).view(np.int32)
        np.testing.assert_array_equal(got[c], want)
