#!/usr/bin/env python3
"""Whole phases of an earlier commit's ``chip_smoke.py`` against this
tree's, in turns on one card: earlier, this, this, earlier.

    mkdir -p _proof/parent
    git archive <commit> | tar -x -C _proof/parent
    python3 phase_ab.py _proof/parent serving node
    python3 phase_ab.py --rounds 3 _proof/parent node node_cache

Run from the root of a checkout on a machine with a CUDA card.  Each turn
is a fresh process started in its checkout's root: it imports that
checkout's ``chip_smoke`` and ``antidote_tpu_torch`` (the kernels are
built into that checkout's ``_build/`` at the first turn and loaded from
there after) and runs the named phases one after the other, each on its
own data made from the phase's seed.  The phases are ``serve``, ``node``,
``serving``, ``cluster`` and ``node_cache`` (the serving phase's node
reads through the value cache, first, warm and cold, alone), which both
trees have, and ``durable``, which runs in this tree's turns only (an
earlier tree without it skips it).  ``--rounds N`` repeats the four turns
N times.  Prints one JSON line per turn: the tree, and per phase its wall
seconds and the result dict the phase returned.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CALLS = {"serve": "cs.serve_main_path(torch, dev)",
         "node": "cs.node_workload(dev)",
         "serving": "cs.serving_phase(torch, dev)",
         "cluster": "cs.cluster_workload(torch, dev)",
         "durable": "cs.durable_phase(torch, dev)",
         "node_cache": "cs.node_value_cache(torch, dev, cfg)"}

TURN = """
import json, sys, time
import torch
import chip_smoke as cs
from antidote_tpu_torch.config import AntidoteConfig
dev = torch.device("cuda", 0)
# the serving phase's configuration (its node reads go through ``cfg``)
cfg = AntidoteConfig(n_shards=8, max_dcs=cs.D, ops_per_key=cs.K,
                     snap_versions=2, set_slots=cs.E)
out = {}
for name, call in json.loads(sys.argv[1]):
    if not hasattr(cs, call[3:call.index("(")]):
        continue
    t = time.perf_counter()
    res = eval(call)
    torch.cuda.synchronize()
    out[name] = {"seconds": time.perf_counter() - t, "result": res}
print(json.dumps(out))
"""


def turn(root: str, phases) -> dict:
    """One process in ``root`` running ``phases``; its JSON line."""
    calls = json.dumps([(p, CALLS[p]) for p in phases])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run([sys.executable, "-c", TURN, calls],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=3000)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"the turn in {root} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    args = sys.argv[1:]
    rounds = 1
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    earlier, phases = args[0], args[1:]
    unknown = [p for p in phases if p not in CALLS]
    if unknown or not phases:
        raise SystemExit(f"phases are {sorted(CALLS)}; got {phases}")
    for tree, root in rounds * (("earlier", earlier), ("this", "."),
                                ("this", "."), ("earlier", earlier)):
        print(json.dumps({"tree": tree, **turn(root, phases)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
