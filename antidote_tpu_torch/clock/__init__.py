from antidote_tpu_torch.clock.vector import (
    concurrent,
    dominates_ignoring,
    eq,
    increment,
    le,
    lt,
    merge,
    vmin,
    zero,
)

__all__ = [
    "zero",
    "le",
    "lt",
    "eq",
    "concurrent",
    "merge",
    "vmin",
    "increment",
    "dominates_ignoring",
]
