"""Work of one call of the site pass (K1), counted from the call's own
inputs: each operand read once, each result written once, the logs and
divisions counted from which sites are valid, homozygous and of one pop,
not from the most there could be.  A random word costs a quarter Philox
block (one block serves four words)."""

from __future__ import annotations

import torch

from perfbench.work import OPS_PHILOX, OPS_TRANSC


def site_masks(z: torch.Tensor, bits2: torch.Tensor) -> dict:
    """Site counts over all chains that the work depends on: ``z``
    int8[C, N, 2L] (the call's fresh or carried ancestries), ``bits2``
    int8[N, L] the packed panel."""
    l = bits2.shape[1]
    s = bits2.to(torch.int64)
    valid = (s & 4) != 0
    hom = (s & 1) == ((s >> 1) & 1)
    n_same = n_same_hom = 0
    for c in range(z.shape[0]):
        same = (z[c, :, :l] == z[c, :, l:]) & valid
        n_same += int(same.sum())
        n_same_hom += int((same & hom).sum())
    c = z.shape[0]
    return dict(n_valid=c * int(valid.sum()), n_same=n_same,
                n_same_hom=n_same_hom,
                n_valid_hom=c * int((valid & hom).sum()))


def site_work(fam: str, sample: bool, c: int, n: int, l: int, k: int,
              a: int, packed: bool, masks: dict, n_ll_cols: int,
              structure: bool = True):
    """(bytes, operations) of one call of the entry of family ``fam``
    (``sample``, ``gendiff``, ``gen``, ``loglik``, ``mode1``, ``find``,
    ``fpop``); ``n_ll_cols`` the log-lik columns it writes a row (0 for
    none)."""
    z_cond = not (fam in ("gen", "gendiff", "loglik") and not structure)
    n_valid = masks["n_valid"]
    n_same = masks["n_same"] if z_cond else n_valid
    n_diff = n_valid - n_same
    if fam == "sample":
        n_transc = 0
    elif fam == "gendiff":
        n_transc = 2 * (masks["n_same_hom"] if z_cond else
                        masks["n_valid_hom"])
    elif sample and fam in ("find", "fpop"):
        n_transc = 2 * n_same
    else:
        cols = 2 if fam == "gen" and sample else 1
        n_transc = (cols * n_same + 2 * n_diff if fam != "mode1"
                    else 2 * n_valid)
    need_hom = fam not in ("sample", "mode1")
    planes = n * l * (1 if packed else 3 + int(need_hom))
    n_in = 2 if sample else 1
    n_bytes = planes + c * k * l * a * 4
    if sample or not z_cond:
        n_bytes += c * n * k * 4
    if fam in ("gen", "gendiff", "loglik", "find"):
        n_bytes += c * n * n_in * 4
    if fam == "fpop":
        n_bytes += c * k * n_in * 4
    n_bytes += c * n * 2 * l                       # z, written or read
    if sample:
        n_bytes += c * n * k * 4 + c * k * l * a * 4     # qqnum, zcounts
    n_bytes += c * n * n_ll_cols * 4
    per_site = 0.0
    if sample:
        per_site = 4 * k + 2 * (OPS_PHILOX / 4 + 3 + 3 * (k - 1) + 3 * k)
    elif not z_cond:
        per_site = 4 * k
    n_ops = c * n * l * per_site + n_transc * OPS_TRANSC + n_valid * 8
    return n_bytes, n_ops
