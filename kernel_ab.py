#!/usr/bin/env python3
"""An earlier commit's ``orset_presence`` (the mask, and the mask followed
by ``compact_top``: the unfused resolve) and ``counter_fold`` against this
tree's, timed in turns on one card, under three states of the L2 cache.

    mkdir -p _proof/parent
    git archive <commit> antidote_tpu_torch | tar -x -C _proof/parent
    python3 kernel_ab.py _proof/parent

Run from the root of a checkout on a machine with a CUDA card.  The
earlier commit's ``antidote_tpu_torch/materializer/cuda_kernels.py`` is
loaded as a module of its own: it builds its own kernel source into its
own ``_build/`` and its wrappers keep their own launches, so the two are
compared through the wrappers' signatures only.  At the main path's
shapes (``chip_smoke.kernel_inputs``: B=16384, K=16, D=4, E=16 and 64)
each pair is first checked equal, then timed in turns earlier, this,
this, earlier with ``chip_smoke.time_ms`` (median device time), under
each L2 state:

* ``zeroed``: 64 MiB zeroed before every launch (``chip_smoke.py``'s
  timing): the cache holds none of the inputs, and dirty lines that the
  kernel's reads write back first;
* ``read``: a read of the same 64 MiB: none of the inputs, clean lines;
* ``warm``: no flush (a 16-byte tensor zeroed): the inputs in the cache.

Beside them, under each state, an empty kernel through the same launch
path (this tree's ``launch_floor``): the floor under every kernel's time.
And for each function, the device time of its kernels alone (``device``:
``torch.profiler``'s kernel durations per call, the flush's own kernels
left out, so no launch or event overhead) and how many kernels it runs.
The resolve pair is this tree's ``orset_resolve`` against the earlier
mask kernel followed by ``crdt.base.compact_top``.  Prints one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.crdt.base import compact_top
from antidote_tpu_torch.materializer import cuda_kernels as ck

REPS = 50
TOP = get_type("set_aw").resolve_top


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


def device_time(fn, flush) -> dict:
    """``fn``'s kernels as the profiler sees them, REPS calls each after
    ``flush``: device ms and kernels per call.  The kernels that the flush
    runs alone (profiled first) are left out."""
    from torch.profiler import ProfilerActivity, profile

    do_flush = flush if callable(flush) else flush.zero_

    def kernels(with_fn) -> dict:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                do_flush()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    fn()
    # the profiler now and then loses a share of a run's device events: the
    # flush's kernels are those of any of three runs of it alone, and a run
    # of fn whose kernels per call come out fractional is taken again (at
    # most three times)
    flush_keys = set().union(*(kernels(False) for _ in range(3)))
    for attempt in range(1, 4):
        mine = {k: v for k, v in kernels(True).items()
                if k not in flush_keys}
        n = sum(c for _, c in mine.values())
        if n and n % REPS == 0:
            break
    return {"ms": sum(t for t, _ in mine.values()) / REPS / 1e3,
            "kernels": n / REPS, "attempts": attempt}


def pairs(old, dev) -> dict:
    """name -> (earlier fn, this tree's fn), each pair checked equal."""
    out = {}
    for e in (cs.E, 4 * cs.E):
        state, ring = cs.kernel_inputs(torch, dev, e, seed=e)
        el, av, rv = state["elems"], state["addvc"], state["rmvc"]
        pres = (av, rv, el)
        if cs.max_abs_err(torch, ck.orset_presence(*pres),
                          old.orset_presence(*pres)) != 0:
            raise AssertionError(f"orset_presence E={e}: the builds differ")
        out[f"orset_presence E={e}"] = (lambda p=pres: old.orset_presence(*p),
                                        lambda p=pres: ck.orset_presence(*p))

        def unfused(p=pres, h=el):
            return compact_top(h, old.orset_presence(*p), TOP)

        def fused(h=el, a=av, r=rv):
            return ck.orset_resolve(h, a, r, TOP)

        if cs.max_abs_err(torch, fused(), unfused()) != 0:
            raise AssertionError(f"orset_resolve E={e}: differs from the "
                                 "earlier presence + compact_top")
        out[f"orset_resolve E={e}"] = (unfused, fused)
        if e != cs.E:
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        deltas = torch.randint(-2**40, 2**40, (cs.B, cs.K), generator=g,
                               device=dev, dtype=torch.int64)
        base = torch.randint(-2**40, 2**40, (cs.B,), generator=g, device=dev,
                             dtype=torch.int64)
        cargs = (base, deltas, ring["ops_vc"], ring["n_ops"],
                 ring["base_vc"], ring["read_vc"])
        if cs.max_abs_err(torch, ck.counter_fold(*cargs),
                          old.counter_fold(*cargs)) != 0:
            raise AssertionError("counter_fold: the builds differ")
        out["counter_fold"] = (lambda: old.counter_fold(*cargs),
                               lambda: ck.counter_fold(*cargs))
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
    big = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    small = torch.empty(16, dtype=torch.uint8, device=dev)
    flushes = {"zeroed": big, "read": lambda: big.sum(), "warm": small}
    res = {"card": cs.card_line(), "reps": REPS}
    for name, (earlier_fn, new_fn) in pairs(old, dev).items():
        res[name] = {l2: {**turns(earlier_fn, new_fn, fl),
                          "earlier_device": device_time(earlier_fn, fl),
                          "new_device": device_time(new_fn, fl)}
                     for l2, fl in flushes.items()}
    floor = lambda: ck.launch_floor(dev)  # noqa: E731
    res["launch_floor"] = {
        l2: {"ms": cs.time_ms(torch, floor, REPS, fl),
             "device": device_time(floor, fl)}
        for l2, fl in flushes.items()}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
