"""The Z-marginalized log-lik kernel (``kernels/marg_loglik.py``,
``csrc/marg_loglik.cu``): its wrapper, launch plan and callers on the CPU,
and the kernel itself on the card.

On the CPU the wrapper runs the plain version
(``model/likelihood.py:marginal_indv_loglik``); an emulation of the
kernel's order of arithmetic holds each site's value bitwise to the plain
version's and its tile sums to the plain sum.  The card tests (skipped
without a CUDA device) hold the kernel to the plain version and to a
float64 evaluation at the benchmark cells' shapes and the headline, in
modes 1-5, through the packed plane and the allele codes; they import no
JAX, and run on the card with::

    python -m pytest --noconftest tests/test_torch_marg_kernel.py -q
"""

import gc

import numpy as np
import pytest
import torch

from instruct_tpu_torch import ModelSpec, Schedule, synthetic_panel
from instruct_tpu_torch.data.dataset import Dataset, packed_dataset
from instruct_tpu_torch.kernels import _build
from instruct_tpu_torch.kernels import marg_loglik as mk
from instruct_tpu_torch.mcmc import driver
from instruct_tpu_torch.mcmc.accumulators import init_accum
from instruct_tpu_torch.mcmc.state import init_state
from instruct_tpu_torch.mcmc.step import build_marg_loglik
from instruct_tpu_torch.model import likelihood as lk
from instruct_tpu_torch.samplers.potential import MarginalModel

MODES = (1, 2, 3, 4, 5)
GAP = 1e-6      # per-individual relative gap of the kernel on the card


def _panel(kind: str, n: int = 12, l: int = 70):
    a = 2 if kind == "packed" else 4
    data = synthetic_panel(n, l, n_pops=2, n_alleles=a, missing_rate=0.1,
                           seed=5).data
    assert (data.bits2 is not None) == (kind == "packed")
    return data


def _inputs(data, mode: int, k: int, c: int = 3, seed: int = 0,
            real_gen: bool = False):
    """freq, q, gen, rates of ``c`` chains; chain 0 keeps only its first
    ``max(1, k - 2)`` slots (the K grid's zero-q slots)."""
    g = torch.Generator().manual_seed(seed)
    n, l, a = data.n_indv, data.n_loci, data.max_alleles
    freq = torch._standard_gamma(torch.ones((c, k, l, a)), generator=g)
    freq = freq * data.allele_valid[None, None].to(torch.float32)
    freq = freq / freq.sum(-1, keepdim=True)
    q = torch._standard_gamma(torch.full((c, n, k), 0.5), generator=g)
    q[0, :, max(1, k - 2):] = 0.0
    q = q / q.sum(-1, keepdim=True)
    if real_gen:
        gen = 1.0 + 49.0 * torch.rand((c, n), generator=g)
    else:
        gen = torch.randint(1, 51, (c, n), generator=g, dtype=torch.int32)
    r = {4: k, 5: n}.get(mode, k)
    rates = torch.rand((c, r), generator=g)
    return freq, q, gen, rates


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("k", [1, 3, 8, 10])
@pytest.mark.parametrize("kind", ["packed", "codes"])
@pytest.mark.parametrize("mode", MODES)
def test_wrapper_on_the_cpu_is_the_plain_version(mode, kind, k):
    """On CPU tensors the wrapper is ``likelihood.marginal_indv_loglik``,
    with integer and real-valued generations and the K grid's empty
    slots."""
    data = _panel(kind)
    spec = ModelSpec(mode=mode, n_pops=k)
    for real_gen in (False, True):
        freq, q, gen, rates = _inputs(data, mode, k, real_gen=real_gen)
        got = mk.marg_indv_loglik(spec, data, freq, q, gen, rates)
        want = lk.marginal_indv_loglik(spec, data, freq, q, gen, rates)
        assert got.shape == (3, data.n_indv) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.isfinite(got).all()


def kernel_sites(spec, data, freq, q, gen, rates):
    """f32[C, N, L] each site's log-lik in the kernel's order of
    arithmetic (``csrc/marg_loglik.cu``: the pops in order; the selfing
    heterozygote as p0 p1 (2w), the inbreeding one as p0 p1 (2 (1 - F));
    mode 1's joint sum is its ``same`` sum), 0 at invalid sites."""
    l, mode = data.n_loci, spec.mode
    hom = data.hom[None]
    x0 = data.geno[:, :l].to(torch.int64)
    x1 = data.geno[:, l:].to(torch.int64)
    one = torch.ones((), dtype=torch.float32)
    if mode in (2, 3):
        w = torch.exp2(1.0 - gen.to(torch.float32))[:, :, None]
        ra, rc = 1.0 - w, 2.0 * w
    elif mode == 5:
        rb = rates[:, :, None]
        ra = 1.0 - rb
        rc = 2.0 * ra
    m0 = m1 = same = joint = torch.zeros((), dtype=torch.float32)
    for k in range(freq.shape[1]):
        pk = freq[:, k]                                     # [C, L, A]
        idx = torch.arange(l)
        p0 = pk[:, idx[None, :], x0]                        # [C, N, L]
        p1 = pk[:, idx[None, :], x1]
        qk = q[:, :, k, None]
        qk2 = qk * qk
        m0 = m0 + qk * p0
        m1 = m1 + qk * p1
        same = same + qk2 * (p0 * p1)
        if mode == 4:
            rb = rates[:, k, None, None]
            ra = 1.0 - rb
            rc = 2.0 * ra
        if mode in (2, 3):
            jk = torch.where(hom, p0 * p0 + (p0 * (1.0 - p0)) * ra,
                             (p0 * p1) * rc)
        elif mode in (4, 5):
            jk = torch.where(hom, (p0 * p0) * ra + p0 * rb, (p0 * p1) * rc)
        if mode != 1:
            joint = joint + qk2 * jk
    cross = m0 * m1 - same
    mult = torch.where(hom, one, 2.0 * one)
    prob = (same + cross) * mult if mode == 1 else joint + cross * mult
    site = torch.log(torch.where(prob < 1e-30, 1e-30 * one, prob))
    return torch.where(data.site_valid[None], site, torch.zeros_like(site))


def tile_sums(site, tile: int = mk.TILE):
    """The kernel's sum of f32[C, N, L]: each tile's lanes (sites lane,
    lane + 32, ...) in order, a butterfly over the warp's 32 lanes, then
    the tiles in order in float64."""
    c, n, l = site.shape
    tiles = -(-l // tile)
    pad = torch.zeros((c, n, tiles * tile), dtype=torch.float32)
    pad[..., :l] = site
    lanes = pad.reshape(c, n, tiles, tile // 32, 32)
    acc = torch.zeros((c, n, tiles, 32), dtype=torch.float32)
    for j in range(tile // 32):
        acc = acc + lanes[..., j, :]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(32) ^ o]
    return acc[..., 0].to(torch.float64).sum(-1).to(torch.float32)


@pytest.mark.parametrize("kind", ["packed", "codes"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_order_is_the_plain_version(mode, kind):
    """The kernel's order of arithmetic gives each site's value bitwise as
    the plain version does, and its tile sums (small tiles here, so a row
    has several) the plain per-individual sum within float32 rounding."""
    data = _panel(kind, l=150)
    spec = ModelSpec(mode=mode, n_pops=5)
    for real_gen in (False, True):
        freq, q, gen, rates = _inputs(data, mode, 5, real_gen=real_gen)
        got = kernel_sites(spec, data, freq, q, gen, rates)
        want = lk.marginal_site_loglik(spec, data, freq, q, gen, rates)
        assert torch.equal(got, want)
        total = want.to(torch.float64).sum(-1)
        gap = ((tile_sums(got, tile=64).to(torch.float64) - total).abs()
               / (total.abs() + 1.0))
        assert float(gap.max()) <= 1e-6


def test_plan_fits_a_block_for_every_k_and_a():
    """The launch plan's shared memory stays within a block's 232 448
    bytes for every K and A it takes; P is staged exactly where K * A <=
    STAGE_CELLS."""
    for k in list(range(1, 65)) + [100, 1000, 2592]:
        for a in range(2, mk.MAX_ALLELES + 1):
            plan = mk.marg_plan(4, 1307, 214_051, k, a)
            assert plan["smem"] <= mk.SMEM_MAX
            assert plan["stage"] == (k * a <= mk.STAGE_CELLS)
            assert plan["smem"] == (4 * k * a * mk.TILE if plan["stage"]
                                    else 0)
    plan = mk.marg_plan(4, 1307, 214_051, 8, 2)
    assert plan == dict(tile=512, strip=64, tiles=419, strips=21,
                        stage=True, smem=32768, scratch=(4, 419, 1307))
    assert mk.marg_plan(4, 938, 642_690, 7, 2)["scratch"] == (4, 1256, 938)


def test_plan_constants_are_the_kernels():
    """The plan's constants are those of ``csrc/marg_loglik.cu``."""
    import re
    src = (_build.CSRC / "marg_loglik.cu").read_text()
    for name, value in (("kTile", mk.TILE), ("kStrip", mk.STRIP),
                        ("kStageCells", mk.STAGE_CELLS),
                        ("kMaxA", mk.MAX_ALLELES), ("kMaxGrid", mk.MAX_GRID),
                        ("kMaxSmem", mk.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    for family in set(mk.FAMILY.values()):
        assert re.search(rf"constexpr int k\w+ = {family};", src)


@pytest.mark.parametrize("shape, words", [
    ((4, 100, 100, 3, 128), "alleles"),
    ((4, 100, 100, 3, 1), "alleles"),
    ((65_536, 100, 100, 3, 2), "chains"),
    ((4, 64 * 65_535 + 1, 100, 3, 2), "strips"),
    ((4, 100, 100, 0, 2), "at least one"),
    ((0, 100, 100, 3, 2), "at least one"),
])
def test_plan_refuses_what_the_kernel_does_not_take(shape, words):
    with pytest.raises(ValueError, match=words):
        mk.marg_plan(*shape)


class _Spy:
    """Records the calls of a function it stands in for."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("mode", [0, 1, 2, 4])
def test_refresh_and_plugin_pass_reach_the_wrapper(mode, monkeypatch):
    """``build_marg_loglik`` and ``_plugin_loglik`` compute modes 1-5
    through ``kernels/marg_loglik.py`` (mode 0 keeps its own mixture)."""
    data = _panel("packed")
    spec = ModelSpec(mode=mode, n_pops=3)
    sched = Schedule(n_iter=4, burnin=2, thinning=1, n_chains=2, ckrep=1,
                     nstep_check_empty_cluster=1)
    spy = _Spy(mk.marg_indv_loglik)
    monkeypatch.setattr(mk, "marg_indv_loglik", spy)
    state = init_state(1, spec, data, sched.n_chains, device="cpu")
    got = build_marg_loglik(spec, data)(state).loglik_marg
    assert spy.calls == (mode != 0)
    assert got.shape == (2, data.n_indv) and torch.isfinite(got).all()
    accum = init_accum(spec, sched, data, True, sched.n_chains, "cpu")
    accum = accum._replace(mean=accum.mean._replace(
        freq=state.freq, q=state.q, rates=state.rates,
        gen=state.gen.to(torch.float32)))
    plug = driver._plugin_loglik(spec, data, accum)
    assert spy.calls == 2 * (mode != 0)
    assert plug.shape == (2,) and np.isfinite(plug).all()


@pytest.mark.parametrize("mode", [4, 5])
def test_samplers_keep_the_plain_potential(mode, monkeypatch):
    """The gradient samplers' potential (modes 4, 5) differentiates
    through the plain version, never the wrapper (it has no backward)."""
    def refuse(*args, **kw):
        raise AssertionError("the samplers reached the kernel's wrapper")

    monkeypatch.setattr(mk, "marg_indv_loglik", refuse)
    spy = _Spy(lk.marginal_indv_loglik)
    monkeypatch.setattr(lk, "marginal_indv_loglik", spy)
    data = _panel("packed")
    model = MarginalModel(ModelSpec(mode=mode, n_pops=3), data)
    params = model.init(_Noise(), 2)
    params = params._replace(phi_q=params.phi_q.requires_grad_())
    ll = model.log_lik(params)
    ll.sum().backward()
    assert spy.calls >= 1 and ll.shape == (2,)
    assert torch.isfinite(params.phi_q.grad).all()


class _Noise:
    """Standard normals for ``MarginalModel.init``."""

    def init(self, shapes, n):
        g = torch.Generator().manual_seed(3)
        return [torch.randn((n,) + tuple(s), generator=g) for s in shapes]


# --------------------------------------------------------------- the card

# (id, N, L, K, A): the two benchmark cells' panels and the headline, the
# headline through the allele codes of A = 4, and at K = 10 (a run-time K;
# at A = 4 beyond the staged tile, P read through the cache)
CARD_SHAPES = [("regmap", 1307, 214_051, 8, 2), ("hgdp", 938, 642_690, 7, 2),
               ("headline", 1000, 10_000, 3, 2),
               ("headline_a4", 1000, 10_000, 3, 4),
               ("headline_k10", 1000, 10_000, 10, 2),
               ("headline_k10_a4", 1000, 10_000, 10, 4)]
CHAINS = 4
ROWS = 128       # individuals a block of the plain evaluations


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the kernel runs on a CUDA device only; none here")
    # an earlier test's job leaves reference cycles that hold device
    # memory; a cell job needs most of the card
    gc.collect()
    torch.cuda.empty_cache()
    return torch.device("cuda")


def card_panel(n: int, l: int, a: int, dev, seed: int = 7) -> Dataset:
    """A random diploid panel made on the card: the packed plane (A = 2,
    bits2 set) or the allele codes (A > 2), ~1% of sites missing, ~2% of
    loci monomorphic."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, a, (2, n, l), generator=g, device=dev,
                      dtype=torch.int8)
    seen = torch.rand((n, l), generator=g, device=dev) >= 0.01
    valid = seen & (torch.rand(l, generator=g, device=dev) >= 0.02)[None]
    x = x * seen[None]
    if a == 2:
        return packed_dataset((x[0] | (x[1] << 1)
                               | (valid.to(torch.int8) << 2)).contiguous())
    return Dataset(geno=torch.cat([x[0], x[1]], dim=1).contiguous(),
                   site_valid=valid,
                   allele_valid=torch.ones((l, a), dtype=torch.bool,
                                           device=dev),
                   hom=x[0] == x[1])


def card_inputs(data: Dataset, k: int, dev, seed: int):
    """freq, q (chain 0 with the K grid's empty slots), integer gen and
    rates of ``CHAINS`` chains, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c, n, l, a = CHAINS, data.n_indv, data.n_loci, data.max_alleles
    freq = torch._standard_gamma(torch.ones((c, k, l, a), device=dev),
                                 generator=g)
    freq = freq / freq.sum(-1, keepdim=True)
    q = torch._standard_gamma(torch.full((c, n, k), 0.3, device=dev),
                              generator=g)
    q[0, :, max(1, k - 2):] = 0.0
    q = q / q.sum(-1, keepdim=True)
    gen = torch.randint(1, 51, (c, n), generator=g, device=dev,
                        dtype=torch.int32)
    return freq, q, gen, torch.rand((c, max(n, k)), generator=g, device=dev)


def plain_by_rows(spec, data: Dataset, freq, q, gen, rates, dtype):
    """The plain version in ``dtype``, ``ROWS`` individuals at a time (its
    float64 planes at a cell's shape would not fit the card whole)."""
    out = []
    for lo in range(0, data.n_indv, ROWS):
        hi = min(data.n_indv, lo + ROWS)
        rows = Dataset(*[t if t is None or t.shape[0] != data.n_indv
                         or t is data.allele_valid else t[lo:hi]
                         for t in data])
        r = rates[:, lo:hi] if spec.mode == 5 else rates
        out.append(lk.marginal_indv_loglik(
            spec, rows, freq.to(dtype), q[:, lo:hi].to(dtype),
            gen[:, lo:hi], r.to(dtype)).to(torch.float64))
    return torch.cat(out, dim=1)


def gaps(got, want):
    """f64[C, N] per-individual gaps relative to |want| + 1 (the
    benchmark's ``llm_gap`` is their maximum)."""
    return (got.to(torch.float64) - want).abs() / (want.abs() + 1.0)


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=[s[0] for s in
                                                    CARD_SHAPES])
def test_kernel_on_the_card(card, shape):
    """At each shape, modes 1-5 (modes 2 and 3 also with real-valued
    generations), through the packed plane and the allele codes, on random
    states: the kernel within 1e-6 (relative, per individual) of the plain
    version, and as close to a float64 evaluation as the plain version is
    (these states are not posterior draws: heterozygous sites at 50
    generations of selfing and q near a corner make ``m0 m1 - same`` cancel
    in float32, which costs both versions alike); two launches bitwise
    equal; its plan the C plan."""
    import ctypes
    _, n, l, k, a = shape
    data = card_panel(n, l, a, card)
    kinds = [("packed", data), ("codes", data._replace(bits2=None))]
    if a != 2:
        kinds = kinds[1:]
    out = (ctypes.c_int * 6)()
    assert _build.library().marg_loglik_plan(CHAINS, n, l, k, a, out) == 0
    plan = mk.marg_plan(CHAINS, n, l, k, a)
    assert list(out) == [plan["tile"], plan["strip"], plan["tiles"],
                         plan["strips"], int(plan["stage"]), plan["smem"]]
    for mode in MODES:
        spec = ModelSpec(mode=mode, n_pops=k)
        freq, q, gen, rates = card_inputs(data, k, card, seed=mode)
        rates = rates[:, :n if mode == 5 else k].contiguous()
        gens = [gen] + ([gen.to(torch.float32) + 0.37] if mode in (2, 3)
                        else [])
        for g in gens:
            want = plain_by_rows(spec, data, freq, q, g, rates,
                                 torch.float64)
            for tag, d in kinds:
                _build.reset_launches()
                got = mk.marg_indv_loglik(spec, d, freq, q, g, rates)
                again = mk.marg_indv_loglik(spec, d, freq, q, g, rates)
                torch.cuda.synchronize()
                where = (mode, tag, str(g.dtype))
                assert _build.launches["marg_loglik"] == 2, where
                assert torch.equal(got, again), where
                plain = plain_by_rows(spec, d, freq, q, g, rates,
                                      torch.float32)
                assert float(gaps(got, plain).max()) <= GAP, where
                assert bool((gaps(got, want) <= gaps(plain, want) + GAP)
                            .all()), where


def cell_params(mode: int, state, k: int):
    """gen and rates of ``mode`` at a cell job's final state: its own
    where the job ran that mode's family (generations of mode 2), else
    those of a population that does not self (gen 1); F in equilibrium
    with the job's selfing rates, F = S / (2 - S), by pop or by individual
    (S of a mode-1 job: 0)."""
    c, n = state.q.shape[:2]
    dev = state.q.device
    gen = (state.gen if state.gen.shape[1] == n
           else torch.ones((c, n), dtype=torch.int32, device=dev))
    s = (state.rates if state.rates.shape[1] == k
         else torch.zeros((c, k), device=dev))
    if mode == 5:
        s = (state.q * s[:, None, :]).sum(-1)
    return gen, (s / (2.0 - s)).contiguous()


@pytest.mark.parametrize("cell", ["regmap.mode2", "hgdp.mode1"])
def test_cell_job_on_the_card(card, cell):
    """One job of a benchmark cell launches the kernel twice (its first and
    last stored steps refresh), and the last refresh is the kernel at the
    final state; at that state (a posterior draw) the kernel is within
    1e-6 of a float64 evaluation and of the plain version in modes 1-5,
    through the packed plane and the allele codes."""
    from perfbench import jobs, panel, run
    cfg = run.load_cell(cell)
    bits2 = panel.make_panel(cfg["cfg"], 2_147_000_301, card)
    data = packed_dataset(bits2)
    runner = jobs.Runner(cfg["mix"], data)
    _build.reset_launches()
    st = runner.run(jobs.job_seed(2_147_000_301, 1)).final_state
    torch.cuda.synchronize()
    assert _build.launches["marg_loglik"] == 2
    k = st.q.shape[2]
    assert torch.equal(st.loglik_marg, mk.marg_indv_loglik(
        runner.spec, data, st.freq, st.q, st.gen, st.rates))
    for mode in MODES:
        spec = ModelSpec(mode=mode, n_pops=k)
        gen, rates = cell_params(mode, st, k)
        want = plain_by_rows(spec, data, st.freq, st.q, gen, rates,
                             torch.float64)
        for tag, d in (("packed", data), ("codes", data._replace(
                bits2=None))):
            got = mk.marg_indv_loglik(spec, d, st.freq, st.q, gen, rates)
            plain = plain_by_rows(spec, d, st.freq, st.q, gen, rates,
                                  torch.float32)
            assert float(gaps(got, want).max()) <= GAP, (mode, tag)
            assert float(gaps(got, plain).max()) <= GAP, (mode, tag)
