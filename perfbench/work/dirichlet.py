"""Work of one call of the Dirichlet kernel (K3): each concentration read
and each draw written once (4 bytes each), the validity mask read once;
per cell a quarter Philox block a uniform (12 uniforms: three rejection
rounds of three, the fallback normal's two and the boost's one), 16
transcendentals and ~40 float operations."""

from __future__ import annotations

from perfbench.work import OPS_PHILOX, OPS_TRANSC

N_UNIFORMS = 12


def dirichlet_work(cells: int, valid_bytes: int = 0):
    """(bytes, operations) of a call over ``cells`` cells."""
    ops = cells * (N_UNIFORMS * OPS_PHILOX / 4 + 16 * OPS_TRANSC + 40)
    return cells * 8 + valid_bytes, ops
