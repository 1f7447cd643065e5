"""Differentiable marginalized posterior for the gradient samplers.

Counterpart of ``instruct_tpu/samplers/potential.py``.  The Gibbs engine
(``mcmc/``) keeps the reference's data augmentation (explicit Z, G); HMC,
NUTS, SVI and SMC instead sum the discrete latents out exactly:

  * Z (per-copy ancestry) per allele copy: p(a | q_i, P) = sum_k q_ik
    P[k, l, a], the "expectation way" genotype frequency (mcmc.c:1739-1749);
  * G (selfing generations, modes 2 and 3) over 1..gen_cap against its
    truncated geometric prior Geom(1 - sbar_i), sbar_i = sum_k q_ik s_k
    (mcmc.c:1063-1066) or s_i: a logsumexp over the curve that the
    ``gen_curve`` kernel computes (``kernels/gen_curve.py``).

The parameters are unconstrained, each with a leading batch axis B (the
chains, ELBO samples or particles; the JAX package's ``vmap`` written out):

  phi_p   f32[B, K, L, A]  masked softmax rows give P
  phi_q   f32[B, N, K]     softmax rows give Q
  phi_s   f32[B, R]        sigmoid gives S (modes 2, 4) or S_i / F_i (3, 5)
  phi_a   f32[B]           softplus gives alpha

The log-densities return f32[B], one value a row; the rows are
independent, so the gradient of ``potential(params).sum()`` holds each
chain's own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels.gen_curve import gen_curve
from instruct_tpu_torch.model import likelihood as lk

_EPS = 1e-30


class MarginalParams(NamedTuple):
    phi_p: torch.Tensor
    phi_q: torch.Tensor
    phi_s: torch.Tensor
    phi_a: torch.Tensor


def _batch_chunks(b: int, data: Dataset):
    """Row ranges of the batch whose [rows, N, L] float temporaries stay
    within ``likelihood.MARG_CHUNK_BYTES`` (the plain modes 1, 4 and 5)."""
    step = max(1, lk.MARG_CHUNK_BYTES // (4 * data.n_indv * data.n_loci))
    return [(lo, min(b, lo + step)) for lo in range(0, b, step)]


class MarginalModel:
    """log_joint / constrain / init for the marginalized admixture model
    family, modes 1-5 (diploid):

      mode 1: (P, Q, alpha)
      mode 2: + S per pop        -- G summed out over 1..gen_cap
      mode 3: + S per individual -- same G marginalization, sbar_i = s_i
      mode 4: + F per pop        -- Z marginalized exactly via the 2-copy
      mode 5: + F per individual    mixture (marginal_site_loglik)

    Mode 0 (one discrete assignment per individual) stays on the Gibbs
    engine, as do the DPM and normal priors; modes 3 and 5 put the flat
    U(0, 1) base prior on the per-individual rates.  ``data`` lies on the
    device the parameters will."""

    def __init__(self, spec: ModelSpec, data: Dataset):
        if spec.mode not in (1, 2, 3, 4, 5):
            raise ValueError(
                "marginalized potential supports the admixture modes 1-5 "
                "(mode 0's one-hot assignment model is Gibbs-only)")
        if spec.ploid != 2:
            raise ValueError("marginalized potential is diploid-only")
        self.spec = spec
        self.data = data
        self.gen_cap = spec.gen_cap
        self.n_rates = spec.n_rates(data.n_indv)

    def shapes(self):
        """Per-row shapes of the four parameters."""
        k = self.spec.n_pops
        return ((k, self.data.n_loci, self.data.max_alleles),
                (self.data.n_indv, k), (self.n_rates,), ())

    def init(self, noise, n: int) -> MarginalParams:
        """``n`` rows of 0.1 x standard normals (alpha's phi zero), drawn
        by ``noise.init``."""
        zp, zq, zs, _ = noise.init(self.shapes(), n)
        return MarginalParams(
            phi_p=0.1 * zp, phi_q=0.1 * zq, phi_s=0.1 * zs,
            phi_a=torch.zeros((n,), dtype=torch.float32,
                              device=zp.device))

    def constrain(self, params: MarginalParams):
        av = self.data.allele_valid[None, None]
        logits = torch.where(av, params.phi_p,
                             torch.full((), -1e30, device=av.device))
        p = torch.softmax(logits, dim=-1)
        q = torch.softmax(params.phi_q, dim=-1)
        s = torch.sigmoid(params.phi_s)
        # jax.nn.softplus: log(1 + e^x) without a threshold
        alpha = torch.logaddexp(params.phi_a,
                                torch.zeros_like(params.phi_a)) + 1e-3
        return p, q, s, alpha

    def _loglik_mode1(self, p, q) -> torch.Tensor:
        data = self.data
        hom, valid = data.hom[None], data.site_valid[None]
        out = []
        for lo, hi in _batch_chunks(p.shape[0], data):
            m = lk.mixture_copy_probs(p[lo:hi], data, q[lo:hi])
            m0, m1 = lk.split_copies(m, 2)
            site = torch.log(torch.clamp_min(
                torch.where(hom, m0 * m1, 2.0 * m0 * m1), _EPS))
            out.append(torch.where(valid, site, torch.zeros_like(site))
                       .sum(dim=(1, 2)))
        return torch.cat(out)

    def log_lik(self, params: MarginalParams) -> torch.Tensor:
        """Marginalized data log-likelihood f32[B] (Z and, in modes 2 and
        3, G summed out)."""
        spec, data = self.spec, self.data
        p, q, s, _alpha = self.constrain(params)
        if spec.mode == 1:
            return self._loglik_mode1(p, q)
        if spec.mode in (4, 5):
            # Z marginalized exactly by the rank-1 2-copy mixture, a chunk
            # of rows at a time (likelihood.marginal_indv_loglik)
            return lk.marginal_indv_loglik(spec, data, p, q, None,
                                           s).sum(dim=-1)
        # modes 2/3: ll_i = logsumexp_g [log Geom(g | 1 - sbar_i)
        #   + sum_l log genofreq(m0, m1, hom, g)]
        per_gen = gen_curve(q, p, data, self.gen_cap)         # [B, N, G]
        gens = torch.arange(1, self.gen_cap + 1, dtype=torch.float32,
                            device=q.device)
        # mode 2: sbar_i = sum_k q_ik s_k (mcmc.c:1063-1066); mode 3: s_i
        sbar = (q * s[:, None, :]).sum(-1) if spec.mode == 2 else s
        sbar = torch.clamp(sbar, 1e-6, 1.0 - 1e-6)            # [B, N]
        # truncated geometric prior on 1..cap, renormalized
        log_prior = ((gens - 1.0) * torch.log(sbar)[..., None]
                     + torch.log1p(-sbar)[..., None])
        log_prior = log_prior - torch.logsumexp(log_prior, dim=-1,
                                                keepdim=True)
        return torch.logsumexp(per_gen + log_prior, dim=-1).sum(dim=-1)

    def log_prior(self, params: MarginalParams) -> torch.Tensor:
        """Prior + change-of-variable terms in unconstrained space, f32[B]:
        P rows ~ Dir(1) (constant), q ~ Dir(alpha), s ~ U(0, 1) through the
        sigmoid's Jacobian, alpha ~ U(0, alpha_prior_max]; a weak Gaussian
        anchor keeps the softmaxes' flat directions integrable."""
        _p, q, s, alpha = self.constrain(params)
        k = self.spec.n_pops
        n = q.shape[1]
        lp_q = (n * (torch.lgamma(k * alpha) - k * torch.lgamma(alpha))
                + (alpha - 1.0)
                * torch.log(torch.clamp_min(q, _EPS)).sum(dim=(1, 2)))
        jac_s = torch.log(torch.clamp_min(s * (1 - s), _EPS)).sum(dim=-1)
        jac_a = torch.log(torch.clamp_min(torch.sigmoid(params.phi_a),
                                          _EPS))
        anchor = -0.5e-3 * ((params.phi_p ** 2).sum(dim=(1, 2, 3))
                            + (params.phi_q ** 2).sum(dim=(1, 2)))
        amax = self.spec.alpha_prior_max
        penal_alpha = torch.where(alpha > amax, -1e3 * (alpha - amax),
                                  torch.zeros_like(alpha))
        return lp_q + jac_s + jac_a + anchor + penal_alpha

    def log_joint(self, params: MarginalParams) -> torch.Tensor:
        return self.log_lik(params) + self.log_prior(params)

    def potential(self, params: MarginalParams) -> torch.Tensor:
        return -self.log_joint(params)

    def selfing_rates(self, params: MarginalParams) -> torch.Tensor:
        return torch.sigmoid(params.phi_s)

    def admixture(self, params: MarginalParams) -> torch.Tensor:
        return torch.softmax(params.phi_q, dim=-1)
