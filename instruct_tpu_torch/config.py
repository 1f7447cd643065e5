"""Typed configuration for models, priors and MCMC schedules.

The reference smuggles ~35 positional CLI flags into the `SEQDATA` struct
(reference: data_interface.h:12-59, InStruct.c:228-446).  Here configuration
is split into three frozen dataclasses (hashable, immutable).  This is the
PyTorch port's own copy of ``instruct_tpu/config.py`` — the port imports
nothing from the JAX package:

  * :class:`ModelSpec`   — which model / mode / likelihood variant.
  * :class:`Priors`      — prior family for S/F and hyperparameters.
  * :class:`Schedule`    — iteration counts, thinning, chain counts.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Mode(enum.IntEnum):
    """Inference mode, 1:1 with the reference's `-v` flag (InStruct.c:59-65).

    The tetraploid engine (reference poly_geno.c) is selected by
    ``ModelSpec.ploid == 4`` rather than by mode, exactly like the dispatch in
    mcmc.c:70-85.
    """

    NO_ADMIXTURE = 0         # structure without admixture (one z per indiv)
    ADMIXTURE = 1            # STRUCTURE-style admixture (P, Z, Q, alpha)
    POP_SELFING = 2          # + selfing rate S per subpop, generations G
    INDV_SELFING = 3         # + selfing rate S per individual
    POP_INBREEDING = 4       # + inbreeding coefficient F per subpop
    INDV_INBREEDING = 5     # + inbreeding coefficient F per individual


class PriorFamily(enum.Enum):
    """Prior on individual S/F for modes 3/5 (reference `-f` flag.

    The reference README advertises uniform/normal/DPM; in the C code
    prior_flag==1 is DPM (mcmc.c:310-341) and the normal prior survives only
    as the unused `sample_mu2` hierarchical-normal sampler (mcmc.c:1607-1626).
    We implement all three.
    """

    UNIFORM = "uniform"
    NORMAL = "normal"
    DPM = "dpm"


@dataclasses.dataclass(frozen=True)
class Priors:
    """Hyperparameters of the S/F prior.

    ``alpha_dpm`` is the DP concentration (reference `-h`, InStruct.c:44).
    The hierarchical-normal hyperparameters mirror `sample_mu2`'s arguments
    (mcmc.c:1607): mu ~ N(mu_0, sigma^2/kappa_0), sigma^2 ~ InvGamma(nu_0/2,
    nu_0*sigmasqr_0/2).
    """

    family: PriorFamily = PriorFamily.UNIFORM
    alpha_dpm: float = 10.0
    dp_truncation: int = 0             # 0 = exact sequential CRP sweep;
    #   T > 0 = blocked truncated-stick-breaking sampler with T components
    #   (parallel over individuals — the large-N path, mcmc/dpm.py)
    normal_mu0: float = 0.5
    normal_kappa0: float = 1.0
    normal_nu0: float = 3.0
    normal_sigmasqr0: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of the probabilistic model.

    Mirrors the model-defining subset of the reference's `SEQDATA` flags
    (data_interface.h:12-59).
    """

    mode: int = int(Mode.POP_SELFING)
    ploid: int = 2
    n_pops: int = 2                    # K, the assumed number of subpops
    type_freq: int = 1                 # genotype-frequency formulation, `-y`:
    #   0 = "expectation way": per-copy allele prob is the Q-mixture over pops
    #       (mcmc.c:1739-1749);
    #   1 = "structure way": use the sampled per-copy assignments Z
    #       (mcmc.c:1750-1768).
    back_refl: int = 1                 # `-e`: 1 = back-reflection random walk
    #   (mcmc.c:928-947); 0 = 3-state adaptive independence sampler
    #   (mcmc.c:1461-1593).
    priors: Priors = Priors()
    autopoly: bool = True              # tetraploid: auto (1) vs allo (0), `-ap`
    gen_cap: int = 50                  # hard cap on selfing generations
    #   (mcmc.c:198, 1076)
    marginalize_g: bool = False        # Rao-Blackwellized alternative: sum G
    #   out exactly over 1..gen_cap instead of sampling it (new capability,
    #   not in the reference)
    mh_step_s: float = 0.05            # delta0 random-walk half-width for S/F
    #   (mcmc.c:870, 919)
    s_subsweeps: int = 1               # inner MH sweeps of the S update per
    #   step (modes 2/3).  The S conditional given (Q, G) is O(N*K) — three
    #   orders cheaper than the site kernels — while the reference's single
    #   delta0=0.05 random-walk sweep per step dominates the S
    #   autocorrelation.  ~12 subsweeps saturate the S mixing at the
    #   coupling-through-G limit.  1 reproduces the reference's update
    #   schedule exactly.
    alpha_prior_max: float = 10.0      # alpha ~ U[0, 10] initialisation
    #   (mcmc.c:479); also used as the upper bound of the uniform prior in our
    #   (corrected) alpha MH update
    alpha_sd: float = 1.0              # alpha proposal sd (mcmc.c:1249)
    use_pallas: Optional[bool] = None  # which SWEEP runs; the name is kept
    #   from the JAX package so a reader finds the counterpart.  None/True:
    #   the fused sweep ("Z, then G | z" in one pass over the sites) for the
    #   diploid modes 1-5 with K <= 8 and K*A <= 64, the unfused sweep (the
    #   reference's "G or F, then Z" order) for everything else.  False: the
    #   unfused sweep always.  It never chooses whether a hand kernel runs:
    #   on CUDA tensors both sweeps launch the hand-written CUDA kernels, on
    #   CPU tensors their plain PyTorch versions (mcmc/step.py:use_fused).

    @property
    def rates_are_per_pop(self) -> bool:
        """True when S/F is one scalar per subpopulation."""
        return self.ploid == 4 or self.mode in (2, 4)

    @property
    def rates_are_per_indv(self) -> bool:
        return self.ploid == 2 and self.mode in (3, 5)

    @property
    def has_selfing(self) -> bool:
        """Modes with selfing-generation latents G (mcmc.c:529-530)."""
        return self.ploid == 2 and self.mode in (2, 3)

    @property
    def has_inbreeding(self) -> bool:
        return self.ploid == 2 and self.mode in (4, 5)

    @property
    def has_admixture(self) -> bool:
        """All modes except mode 0 carry (Z per copy, Q, alpha)."""
        return self.ploid == 4 or self.mode != 0

    def n_rates(self, n_indv: int) -> int:
        if self.rates_are_per_pop:
            return self.n_pops
        if self.rates_are_per_indv:
            return n_indv
        return 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    """MCMC schedule, 1:1 with the reference flags `-u -b -t -c -r -j`
    (defaults at InStruct.c:30-35, 47)."""

    n_iter: int = 1_000_000
    burnin: int = 500_000
    thinning: int = 10
    n_chains: int = 2
    ckrep: int = 20                    # stored iters used for Gelman-Rubin
    nstep_check_empty_cluster: int = 20
    dic_every: int = 10                # refresh cadence (in stored-step
    #   units) of the Z-marginalized log-lik that feeds the corrected DIC:
    #   the extra site pass runs every dic_every-th stored step and the
    #   value is held constant in between (an unbiased subsampled mean), so
    #   the hot loop pays ~1/(thinning*dic_every) of a site pass per step.

    def __post_init__(self):
        retained = (self.n_iter - self.burnin) // self.thinning
        if self.dic_every < 1:
            raise ValueError("dic_every must be >= 1")
        if self.burnin <= 0:
            raise ValueError("Burn-in should not be zero!")  # InStruct.c:299-300
        if self.ckrep > retained:
            raise ValueError(
                "ckrep exceeds the number of retained iterations"  # InStruct.c:437-440
            )
        if self.nstep_check_empty_cluster > retained:
            raise ValueError(
                "nstep_check_empty_cluster exceeds retained iterations"  # InStruct.c:441-444
            )

    @property
    def n_stored(self) -> int:
        """Number of retained (stored) samples (mcmc.c:104, 485)."""
        return (self.n_iter - self.burnin) // self.thinning
