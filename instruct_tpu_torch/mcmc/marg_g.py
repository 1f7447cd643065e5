"""Rao-Blackwellized selfing-generation updates (``ModelSpec.marginalize_g``,
modes 2 and 3).

Counterpart of ``instruct_tpu/mcmc/marg_g.py``.  The per-individual
selfing-generation counts G leave the MH update (update_G,
mcmc.c:1053-1091) for each individual's log-likelihood CURVE over
g = 1..gen_cap:

  * G is an exact categorical Gibbs draw from its full conditional
    (truncated geometric prior x genotype likelihood), by Gumbel-argmax on
    the Philox stream ``STREAM_MARG_GEN``;
  * S (mode 2 per pop, mode 3 per individual) targets the G-marginal
    posterior sum_i logsumexp_g [log Geom_trunc(g | sbar_i) + ll_i(g)].

The curve factorizes through the (pop, allele) one-hot like the DPM's F
grid: with w_g = 2^(1-g) a hom same-z site contributes log p0 +
log(1 - (1 - p0) w_g), so the g-dependent part is K*A masked
``[N, L] @ [L, gen_cap]`` products (:func:`selfing_gtable`, full float32,
one chain at a time); het same-z sites add n_het (1 - g) log 2.  Needs the
structure way (``type_freq == 1``).  The S updates take their uniforms in
the layouts of the plain S updates (``StepDraws.s``).
"""

from __future__ import annotations

import torch

from instruct_tpu_torch.config import ModelSpec
from instruct_tpu_torch.data.dataset import Dataset
from instruct_tpu_torch.kernels import philox as px
from instruct_tpu_torch.mcmc import dpm
from instruct_tpu_torch.mcmc import updates as up
from instruct_tpu_torch.model import likelihood as lk

_EPS = 1e-30
_LOG2 = 0.6931471805599453


def _slog(x):
    return torch.log(torch.clamp_min(x, _EPS))


def selfing_gtable(data: Dataset, freq, z, gen_cap: int) -> torch.Tensor:
    """gtable f32[C, N, gen_cap]: the g-dependent part of each individual's
    log-likelihood at g = 1..gen_cap (the g-independent site terms are
    left out: only differences and logsumexps over g are used)."""
    dev = freq.device
    gens = torch.arange(1, gen_cap + 1, dtype=torch.float32, device=dev)
    w = torch.exp2(1.0 - gens)
    a = freq.shape[3]
    out = []
    for ci in range(freq.shape[0]):
        z0, z1 = lk.split_copies(z[ci], data.ploid)
        same = (z0 == z1) & data.site_valid
        hom_mask = same & data.hom
        n_het = (same & ~data.hom).sum(dim=1).to(torch.float32)
        base = n_het[:, None] * (1.0 - gens)[None, :] * _LOG2
        out.append(base + dpm.masked_products(
            freq[ci], dpm.hom_codes(data, z0, hom_mask, a),
            lambda fk: _slog(1.0 - (1.0 - fk) * w[None, :]), gen_cap))
    return torch.stack(out)


def selfing_gtable_dense(data: Dataset, freq, z, gen_cap: int,
                         rows: int = 64) -> torch.Tensor:
    """The dense [N, L, gen_cap] form of :func:`selfing_gtable` (each hom
    same-z site's log(1 - (1 - p0) w_g) summed over the loci), ``rows``
    individuals at a time: for the tests and the card's check only."""
    gens = torch.arange(1, gen_cap + 1, dtype=torch.float32,
                        device=freq.device)
    w = torch.exp2(1.0 - gens)
    out = []
    for ci in range(freq.shape[0]):
        p0, _ = lk.split_copies(
            lk.gather_freq_at_z(freq[ci:ci + 1], data, z[ci:ci + 1])[0],
            data.ploid)
        z0, z1 = lk.split_copies(z[ci], data.ploid)
        same = (z0 == z1) & data.site_valid
        hom_mask = same & data.hom
        n_het = (same & ~data.hom).sum(dim=1).to(torch.float32)
        parts = []
        for r0 in range(0, p0.shape[0], rows):
            p = p0[r0:r0 + rows, :, None]
            term = _slog(1.0 - (1.0 - p) * w)
            parts.append((term * hom_mask[r0:r0 + rows, :, None]).sum(dim=1))
        out.append(torch.cat(parts)
                   + n_het[:, None] * (1.0 - gens)[None, :] * _LOG2)
    return torch.stack(out)


def log_geom_trunc(sbar, gen_cap: int) -> torch.Tensor:
    """Normalized truncated-geometric log-pmf rows f32[..., gen_cap] over
    g = 1..gen_cap given sbar (the conditional prior of update_G,
    mcmc.c:1063-1069, made exact under the cap)."""
    s = torch.clamp(sbar, 1e-7, 1.0 - 1e-7)[..., None]
    gens = torch.arange(1, gen_cap + 1, dtype=torch.float32,
                        device=sbar.device)
    logs = torch.log(s)
    # log(1 - s^cap) = log(-expm1(cap log s)), stable for s -> 1
    log_norm = torch.log(-torch.expm1(gen_cap * logs))
    return (gens - 1.0) * logs + torch.log1p(-s) - log_norm


def gen_noise(keys, step: int, n: int, gen_cap: int) -> torch.Tensor:
    """f32[C, N, gen_cap] Gumbel noise of the exact G draw."""
    return dpm.gumbel_noise(keys, step, px.STREAM_MARG_GEN, (n, gen_cap))


def sample_gen_marginal(noise, gtable, sbar, gen_cap: int) -> torch.Tensor:
    """Exact Gibbs draw of G i32[C, N] from its full conditional
    (replaces the MH sweep, update_G, mcmc.c:1053-1091) by Gumbel-argmax
    with the noise f32[C, N, gen_cap]."""
    logits = gtable + log_geom_trunc(sbar, gen_cap)
    return (1 + torch.argmax(logits + noise, dim=-1)).to(torch.int32)


def _marginal_loglik(gtable, sbar, gen_cap: int):
    """f32[C, N] log p(data_i | sbar_i) with G summed out (up to the
    g-independent constant)."""
    return torch.logsumexp(gtable + log_geom_trunc(sbar, gen_cap), dim=-1)


def update_s_pop_marginal(u_prop, u_acc, spec: ModelSpec, q, gtable, rates,
                          ais_state, u_fresh=None):
    """Mode 2: the S update of :func:`updates.update_s_pop` (one pop at a
    time, the rank-1 sbar update, back-reflection or the
    adaptive-independence proposal) on the G-marginal target.  ``u_prop``,
    ``u_acc`` (and ``u_fresh``) f32[C, J, K] drive J sweeps over the pops.
    Returns (rates, ais_state)."""
    k, cap = spec.n_pops, spec.gen_cap
    logu = _slog(u_acc)
    sbar = up.mix_rates(q, rates)
    lml = _marginal_loglik(gtable, sbar, cap)
    for j in range(u_prop.shape[1]):
        prop, prop_states, log_hast = up._propose(
            spec, u_prop[:, j], None if u_fresh is None else u_fresh[:, j],
            rates, ais_state)
        r = [rates[:, kk] for kk in range(k)]
        accepts = []
        for kk in range(k):
            s_new = prop[:, kk]
            sbar_new = sbar + q[:, :, kk] * (s_new - r[kk])[:, None]
            lml_new = _marginal_loglik(gtable, sbar_new, cap)
            log_ratio = (lml_new - lml).sum(dim=1) + log_hast[:, kk]
            accept = logu[:, j, kk] < log_ratio
            accepts.append(accept)
            r[kk] = torch.where(accept, s_new, r[kk])
            sbar = torch.where(accept[:, None], sbar_new, sbar)
            lml = torch.where(accept[:, None], lml_new, lml)
        rates = torch.stack(r, dim=1)
        if spec.back_refl != 1:
            ais_state = torch.where(torch.stack(accepts, dim=1), prop_states,
                                    ais_state)
    return rates, ais_state


def update_s_ind_marginal(u_prop, u_acc, spec: ModelSpec, gtable, rates,
                          prior_mu=None, prior_sigma2=None):
    """Mode 3: the per-individual S random walk on the G-marginal target
    (uniform prior, or normal with ``prior_mu``, ``prior_sigma2`` f32[C]);
    ``u_prop``, ``u_acc`` f32[C, J, N] drive J updates in turn."""
    def lp(s):
        out = _marginal_loglik(gtable, s, spec.gen_cap)
        if prior_mu is not None:
            out = out + up.normal_prior(s, prior_mu, prior_sigma2)
        return out

    logu = _slog(u_acc)
    lp_cur = lp(rates)
    for j in range(u_prop.shape[1]):
        prop = up.propose_back_reflection(u_prop[:, j], rates, spec.mh_step_s)
        lp_prop = lp(prop)
        accept = logu[:, j] < lp_prop - lp_cur
        rates = torch.where(accept, prop, rates)
        lp_cur = torch.where(accept, lp_prop, lp_cur)
    return rates
