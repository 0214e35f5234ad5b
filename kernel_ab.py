#!/usr/bin/env python3
"""An earlier commit's ``set_aw_fold`` and ``stable_min`` against this
tree's, timed in turns on one card.

    mkdir -p _proof/parent
    git archive <commit> antidote_tpu_torch | tar -x -C _proof/parent
    python3 kernel_ab.py _proof/parent

Run from the root of a checkout on a machine with a CUDA card.  The
earlier commit's ``antidote_tpu_torch/materializer/cuda_kernels.py`` is
loaded as a module of its own: it builds its own kernel source into its
own ``_build/`` and its wrappers keep their own launches (an output fill,
say), so the two are compared through the wrappers' signatures only.
``set_aw_fold`` (``chip_smoke.kernel_inputs``: B=16384, K=16, D=4, E=16
and 64) and ``stable_min`` (2048 x 4 and 1<<20 x 4) are first checked
equal between the two, then timed in turns earlier, this, this, earlier
with ``chip_smoke.time_ms`` (median device time, the L2 cache flushed
before every launch), ``stable_min`` beside one ``torch.amin(x, 0)``.
Then where this tree's ``set_aw_fold`` spends its time: the same state
with no ring (n_ops = 0: the state loaded and stored only) and with a full
ring of included ops, beside a clone of the state (the same state bytes
moved by three copy launches), each with the L2 flushed and warm (the
flush tensor cut to 16 bytes).  Prints one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from antidote_tpu_torch.materializer import cuda_kernels as ck

REPS = 50
FIELDS = ("elems", "addvc", "rmvc")
RING = ("ops_a", "ops_b", "ops_vc", "ops_origin", "n_ops", "base_vc",
        "read_vc")


def earlier_kernels(root: str):
    """The wrappers module of the checkout at ``root``."""
    path = Path(root, "antidote_tpu_torch", "materializer", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("earlier_cuda_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turns(earlier_fn, new_fn, flush) -> dict:
    t = [cs.time_ms(torch, f, REPS, flush)
         for f in (earlier_fn, new_fn, new_fn, earlier_fn)]
    return {"earlier_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
            "turns_ms": t}


def anatomy(state, ring, flushes) -> dict:
    no_ring = dict(ring, n_ops=torch.zeros_like(ring["n_ops"]))
    k = ring["ops_vc"].shape[1]
    # every op of a full ring past base_vc (< 3) and within read_vc (>= 4)
    all_in = dict(ring, n_ops=torch.full_like(ring["n_ops"], k),
                  ops_vc=torch.full_like(ring["ops_vc"], 3))
    out = {}
    for l2, fl in flushes.items():
        for name, r in (("path", ring), ("no_ring", no_ring),
                        ("all_included", all_in)):
            args = [r[n] for n in RING]
            out[f"{name}_{l2}_ms"] = cs.time_ms(
                torch, lambda: ck.set_aw_fold(state, *args), REPS, fl)
        out[f"state_clone_{l2}_ms"] = cs.time_ms(
            torch, lambda: [state[f].clone() for f in FIELDS], REPS, fl)
    return out


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    old = earlier_kernels(argv[1])
    flushes = {
        "flushed": torch.empty(64 << 20, dtype=torch.uint8, device=dev),
        "warm": torch.empty(16, dtype=torch.uint8, device=dev)}
    flush = flushes["flushed"]
    res = {"card": cs.card_line(), "set_aw_fold": {}, "stable_min": {}}
    for e in (cs.E, 4 * cs.E):
        state, ring = cs.kernel_inputs(torch, dev, e, seed=e)
        args = [ring[n] for n in RING]
        if cs.max_abs_err(torch, ck.set_aw_fold(state, *args),
                          old.set_aw_fold(state, *args)) != 0:
            raise AssertionError(f"set_aw_fold E={e}: the builds differ")
        res["set_aw_fold"][f"E={e}"] = {
            "variant": ck.set_aw_fold_variant(e, cs.D),
            **turns(lambda: old.set_aw_fold(state, *args),
                    lambda: ck.set_aw_fold(state, *args), flush),
            "anatomy": anatomy(state, ring, flushes)}
    rng = np.random.default_rng(5)
    for n in (cs.CL_SHARDS, 1 << 20):
        x = torch.as_tensor(rng.integers(0, 1 << 20, (n, cs.D),
                                         dtype=np.int32), device=dev)
        if cs.max_abs_err(torch, ck.stable_min(x), old.stable_min(x)) != 0:
            raise AssertionError(f"stable_min N={n}: the builds differ")
        rec = turns(lambda: old.stable_min(x), lambda: ck.stable_min(x),
                    flush)
        rec["amin_ms"] = cs.time_ms(torch, lambda: torch.amin(x, 0), REPS,
                                    flush)
        res["stable_min"][f"{n}x{cs.D}"] = rec
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
