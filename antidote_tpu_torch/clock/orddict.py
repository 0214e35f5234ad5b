"""Versioned-snapshot selection over a fixed ring of ``V`` snapshot
versions per key: ``snap_vc[..., V, D]`` clocks plus an insertion sequence
``snap_seq[..., V]`` (0 = empty slot).  Selection is a masked argmax over
the version axis."""

from __future__ import annotations

import torch

from antidote_tpu_torch.clock import vector as vc


def get_smaller(snap_vc, snap_seq, read_vc):
    """Newest valid snapshot version dominated by ``read_vc``.

    ``snap_vc`` int32[..., V, D], ``snap_seq`` int64[..., V], ``read_vc``
    int32[..., D].  Returns ``(idx int32[...], found bool[...])``; ``idx``
    is 0 when nothing matches."""
    ok = vc.le(snap_vc, read_vc.unsqueeze(-2)) & (snap_seq > 0)
    score = torch.where(ok, snap_seq, torch.full_like(snap_seq, -1))
    best, idx = torch.max(score, dim=-1)
    return idx.to(torch.int32), best > -1


def insert_slot(snap_seq):
    """Slot to overwrite for a new snapshot version: the oldest (min seq);
    empty slots (seq 0) come first."""
    return torch.argmin(snap_seq, dim=-1).to(torch.int32)
