"""Vector clocks as dense integer tensors.

A VC is an ``int32[max_dcs]`` row of logical per-DC commit counters; every
comparison is a lane-wise tensor op, so a batch of VC comparisons is one
call.  All functions broadcast over leading ``[..., D]`` dimensions.
"""

from __future__ import annotations

import torch

CLOCK_DTYPE = torch.int32


def zero(max_dcs: int, device=None) -> torch.Tensor:
    """The bottom clock."""
    return torch.zeros((max_dcs,), dtype=CLOCK_DTYPE, device=device)


def le(a, b):
    """a ≤ b in the partial order (all entries ≤)."""
    return torch.all(a <= b, dim=-1)


def eq(a, b):
    return torch.all(a == b, dim=-1)


def lt(a, b):
    """a ≤ b and a ≠ b (strict dominance)."""
    return le(a, b) & ~eq(a, b)


def concurrent(a, b):
    """Neither dominates."""
    return ~le(a, b) & ~le(b, a)


def merge(a, b):
    """Entry-wise max."""
    return torch.maximum(a, b)


def vmin(a, b):
    """Entry-wise min — the stable-snapshot merge."""
    return torch.minimum(a, b)


def increment(vc, dc_index: int):
    """Bump one DC's entry by 1 (returns a new tensor)."""
    out = vc.clone()
    out[..., dc_index] += 1
    return out


def dominates_ignoring(a, b, ignore_dc: int):
    """a ≥ b on every lane except ``ignore_dc`` (the inter-DC causal
    gate: the origin lane of a remote txn is not waited on)."""
    d = a.shape[-1]
    ignore = torch.arange(d, device=a.device) == ignore_dc
    return torch.all((a >= b) | ignore, dim=-1)
