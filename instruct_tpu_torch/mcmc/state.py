"""Sampler state and initialisation.

Counterpart of ``instruct_tpu/mcmc/state.py``.  The JAX package holds one
chain's state and ``vmap``s over chains; here the chains are a written-out
leading axis ``C`` on every tensor, and one kernel launch serves all chains.
Every field name is kept; fields a mode does not use are zero-size (or
``None`` where the JAX default is ``None``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from instruct_tpu_torch import spans
from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset


class McmcState(NamedTuple):
    """All chains' sampler state (cf. UPMCMC, mcmc.h)."""

    freq: torch.Tensor         # f32[C, K, L, A] P (allele freqs per pop/locus)
    z: torch.Tensor            # i8[C, N, S] per-copy pop assignments, flat,
    #   S = L * ploid, copy-major (i8[C, 0, 0] in mode 0)
    zz: torch.Tensor           # i32[C, N] one pop per individual (mode 0;
    #   i32[C, 0] otherwise)
    q: torch.Tensor            # f32[C, N, K] admixture proportions
    #   (f32[C, 0, 0] in mode 0)
    alpha: torch.Tensor        # f32[C] Dirichlet concentration of Q's prior
    rates: torch.Tensor        # f32[C, R] selfing rates S or inbreeding F
    #   (R = K for modes 2/4, N for 3/5, 0 for mode 1)
    ais_state: torch.Tensor    # i32[C, R] 3-state flag of the adaptive
    #   independence sampler (dt_stat, mcmc.c:1524-1546); carried unchanged
    #   under back-reflection
    gen: torch.Tensor          # i32[C, N] selfing generations (modes 2/3;
    #   i32[C, 0] otherwise)
    loglik_indv: torch.Tensor  # f32[C, N] cal_lkh per-individual log-lik
    loglik_total: torch.Tensor  # f32[C]
    dpm_values: torch.Tensor   # f32[C, N] the DPM prior's table
    dpm_counts: torch.Tensor   # i32[C, N]   (mcmc/dpm.py; f32/i32[C, 0]
    dpm_assign: torch.Tensor   # i32[C, N]   where the prior is not DPM)
    prior_mu: torch.Tensor     # f32[C] normal prior's mean (modes 3/5)
    prior_sigma2: torch.Tensor  # f32[C] and variance
    freq2: Optional[torch.Tensor] = None   # allotetraploid only
    geno: Optional[torch.Tensor] = None    # tetraploid only
    zcounts: Optional[torch.Tensor] = None  # f32[C, K, L, A] allele-pop
    #   counts of the current z, carried by the fused sweep so that its P
    #   update needs no pass over the site tensors; the unfused sweep
    #   recounts from z and leaves the field as it found it (None in mode 0)
    loglik_marg: Optional[torch.Tensor] = None  # f32[C, N] Z-marginalized
    #   per-individual log-lik, refreshed every Schedule.dic_every-th stored
    #   step; feeds the corrected DIC and WAIC
    active: Optional[torch.Tensor] = None  # f32[C, K] active-pop mask of
    #   the padded (chain x K) K-selection grid (kselect.py): 1.0 for the
    #   leading slots a chain uses, 0.0 for padding.  q (and so z and the
    #   counts) put exactly zero mass on inactive slots: the Q draw masks
    #   them (updates.mask_active) and the z inverse CDF never selects a
    #   zero-mass trailing slot.  None: every slot active.

    def to(self, device) -> "McmcState":
        """The same state with every tensor on ``device``."""
        return McmcState(*[None if t is None else t.to(device)
                           for t in self])


def _dt_stat(rates: torch.Tensor) -> torch.Tensor:
    """3-state classification of S/F: {0}, (0,1), {1} with eps=1e-3
    (dt_stat, mcmc.c:1524-1546)."""
    eps = 1e-3
    one = torch.ones_like(rates, dtype=torch.int32)
    return torch.where(rates <= eps, 0 * one,
                       torch.where(rates >= 1.0 - eps, 2 * one, one))


def masked_z_counts(z, data: Dataset, n_pops: int) -> torch.Tensor:
    """qqnum f32[C, N, K]: valid allele copies of each individual assigned
    to each pop (the Q-count loop of update_ZQ, mcmc.c:1176-1194)."""
    valid = data.site_valid.repeat(1, data.ploid)[None]      # [1, N, S]
    cols = [(valid & (z == kk)).sum(dim=-1).to(torch.float32)
            for kk in range(n_pops)]
    return torch.stack(cols, dim=-1)


def chain_generator(seed: int, chain_key: int, device) -> torch.Generator:
    """The generator of one chain's initial draws: a function of the run's
    seed and the chain's key only, so a retried chain (fresh key) starts
    elsewhere and a replayed chain starts where it did."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15
                   + (int(chain_key) + 1) * 0xD1B54A32D192ED03)
                  & 0x7FFFFFFFFFFFFFFF)
    return g


def init_state(seed: int, spec: ModelSpec, data: Dataset, n_chains: int,
               init_rates=None, device="cuda",
               chain_key: Optional[Sequence[int]] = None,
               tetra_tables=None, active=None, mesh=None) -> McmcState:
    """Draw the initial state of ``n_chains`` chains on ``device``.

    Mirrors the per-mode initialisation of the JAX package
    (``instruct_tpu/mcmc/state.py:77``) for the diploid modes 0-5: alpha ~
    U[0, alpha_prior_max]; S or F from ``init_rates`` f32[C, R] or U[0, 1]
    (R = ``spec.n_rates(N)``: K for modes 2/4, N for 3/5, none for modes
    0/1); G ~ Geom with a random success probability (mode 2) or
    Geom(1 - s_i) (mode 3), capped, none for the other modes; Z uniform,
    then Q | Z; P starts at the uniform simplex (the first sweep overwrites
    it before any use).  Mode 0 has one uniform ``zz`` per individual, empty
    z and q, alpha 0 and no ``zcounts``; elsewhere ``state.zcounts`` is
    seeded with the :func:`allele_counts` kernel.
    ``chain_key`` gives one integer key per chain (default ``range(C)``).
    ``active`` f32[C, K] (the K grid's mask, active slots leading) draws
    each chain's initial z over its active slots as ``floor(u * n_active)``
    and its Q over them (JAX ``state.py:108-120``), and is carried.
    Under the DPM prior (modes 3/5, ``mcmc/dpm.py``) the rates come from
    the CRP prior's table, one launch of the seating kernel for all
    chains at step ``INIT_STEP`` of the chain keys' Philox streams
    (``init_rates`` is then not read, as in JAX ``state.py:138-145``), and
    mode 3's G starts from them.
    Ploidy 4 runs the tetraploid engine's initialisation
    (``tetra/engine.py:init_tetra_state``, with the run's ``tetra_tables``
    when given).
    On a loci-sharded ``mesh`` (``data`` this rank's block) each chain's z
    draws from a generator of the shard's site seed
    (``kernels/philox.py:fold_seed``), its other draws from the chain's own
    generator, and the Q counts are summed over the shards first.
    The call is the span ``mcmc.init`` (``spans.py``).
    """
    with spans.span("mcmc.init", device):
        if spec.ploid == 4:
            from instruct_tpu_torch.tetra.engine import init_tetra_state
            return init_tetra_state(seed, spec, data, n_chains, init_rates,
                                    device, chain_key, tetra_tables, mesh)
        return _init_diploid(seed, spec, data, n_chains, init_rates, device,
                             chain_key, active, mesh)


def _init_diploid(seed: int, spec: ModelSpec, data: Dataset, n_chains: int,
                  init_rates, device, chain_key, active,
                  mesh) -> McmcState:
    """:func:`init_state` of the diploid modes 0-5."""
    from instruct_tpu_torch.kernels import philox as px
    from instruct_tpu_torch.kernels.fused_step import allele_counts
    from instruct_tpu_torch.mcmc import dpm
    from instruct_tpu_torch.mcmc import updates as up

    if spec.ploid != 2 or spec.mode not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"init_state: no model with mode {spec.mode} and "
                         f"ploidy {spec.ploid}")
    dev = torch.device(device)
    data = data.to(dev)
    c = n_chains
    n, l, p = data.n_indv, data.n_loci, data.ploid
    k = spec.n_pops
    a = data.max_alleles
    r = spec.n_rates(n)
    if chain_key is None:
        chain_key = range(c)
    chain_key = list(chain_key)
    if len(chain_key) != c:
        raise ValueError(f"chain_key: expected {c} keys")

    valid_f = data.allele_valid.to(torch.float32)
    freq = valid_f / torch.clamp_min(valid_f.sum(-1, keepdim=True), 1.0)
    freq = freq[None, None].expand(c, k, l, a).contiguous()

    f32 = dict(dtype=torch.float32, device=dev)
    admix = spec.has_admixture
    z = torch.empty((c, n, l * p) if admix else (c, 0, 0), dtype=torch.int8,
                    device=dev)
    zz = torch.empty((c, 0 if admix else n), dtype=torch.int32, device=dev)
    q = torch.empty((c, n, k) if admix else (c, 0, 0), **f32)
    alpha = torch.zeros((c,), **f32)
    rates = torch.empty((c, r), **f32)
    gen = torch.empty((c, n if spec.has_selfing else 0), dtype=torch.int32,
                      device=dev)
    lo, span = 1e-6, 1.0 - 2e-6
    given = (None if init_rates is None
             else torch.as_tensor(init_rates, **f32).reshape(c, r))
    if active is not None:
        active = torch.as_tensor(active, **f32).reshape(c, k)
    table = None
    if dpm.uses_dpm(spec):
        keys = px.make_keys(seed, c, dev, chain_key=chain_key)
        table = dpm.init_dpm(keys, px.INIT_STEP, spec.priors.alpha_dpm, n)
        given = torch.gather(table.values, 1, table.assign.to(torch.int64))

    def uniform_pops(ci, g, shape, dtype):
        """Initial labels uniform over chain ci's active slots."""
        if active is None:
            return torch.randint(0, k, shape, generator=g, device=dev,
                                 dtype=dtype)
        n_act = torch.clamp_min(active[ci].sum(), 1.0)
        u = torch.rand(shape, generator=g, device=dev)
        return torch.floor(u * n_act).clamp_max(n_act - 1).to(dtype)

    shard = None if mesh is None else mesh.shard
    gens = [chain_generator(seed, ck, dev) for ck in chain_key]
    if admix:
        for ci, ck in enumerate(chain_key):
            g = gens[ci]
            g_z = g if shard is None else chain_generator(
                px.fold_seed(seed, shard), ck, dev)
            z[ci] = uniform_pops(ci, g_z, (n, l * p), torch.int8)
            alpha[ci] = (torch.rand((), generator=g, device=dev)
                         * spec.alpha_prior_max)
        counts = up.psum(masked_z_counts(z, data, k), mesh)
    for ci, ck in enumerate(chain_key):
        g = gens[ci]
        if admix:
            q[ci] = up.dirichlet_from_counts(
                g, counts[ci] + alpha[ci],
                None if active is None else (active[ci] > 0)[None])
        else:
            zz[ci] = uniform_pops(ci, g, (n,), torch.int32)
        rates[ci] = torch.rand((r,), generator=g, device=dev)
        if given is not None:
            rates[ci] = given[ci]
        if not spec.has_selfing:
            continue
        u = torch.rand((n,), generator=g, device=dev) * span + lo
        if spec.mode == 2:
            # gen ~ Geom(ran1()): geometric with a random success prob
            # (mcmc.c:196-199)
            psucc = torch.rand((n,), generator=g, device=dev) * span + lo
        else:
            # mode 3: gen ~ Geom(1 - s_i) (mcmc.c:329-331)
            psucc = torch.clamp(1.0 - rates[ci], lo, 1.0 - lo)
        gi = 1 + torch.floor(torch.log(u) / torch.log1p(-psucc))
        gen[ci] = torch.clamp(gi, 1, spec.gen_cap).to(torch.int32)

    zcounts = None
    if admix:
        zcounts = allele_counts(z, data.geno, data.site_valid, n_pops=k,
                                max_alleles=a, bits2=data.bits2)
    zero = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    if table is None:
        table = dpm.DpmTable(zero(c, 0), zero(c, 0, dtype=torch.int32),
                             zero(c, 0, dtype=torch.int32))
    return McmcState(
        freq=freq, z=z, zz=zz, q=q, alpha=alpha,
        rates=rates, ais_state=_dt_stat(rates), gen=gen,
        loglik_indv=zero(c, n), loglik_total=zero(c),
        dpm_values=table.values, dpm_counts=table.counts,
        dpm_assign=table.assign,
        prior_mu=torch.full((c,), spec.priors.normal_mu0, **f32),
        prior_sigma2=torch.full((c,), spec.priors.normal_sigmasqr0, **f32),
        zcounts=zcounts, loglik_marg=zero(c, n), active=active)
