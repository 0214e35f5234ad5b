#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (one card;
``nvcc`` under /usr/local/cuda or on PATH).  Phases, each fatal on failure:

1. report the card (nvidia-smi name and power limit) and build the
   kernels of ``antidote_tpu_torch/csrc/`` with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality: integer work) and time both; the
   ``set_aw_fold`` kernel also on ``SET_AW_CASES`` (E from 8 to 1024, D
   in {1, 3, 4, 8, 12}, K in {1, 16, 33}, an odd B, the edge rows of
   ``materializer/fold_cases.py``), which between them reach every
   variant its launcher can pick; ``orset_presence`` in both forms (the
   mask, and ``orset_resolve`` fused with the top-K compaction) on
   ``ORSET_CASES`` and ``counter_fold`` on ``COUNTER_CASES`` (edge rows,
   strided deltas, misaligned views); the ``stable_min`` kernel also at
   the edge shapes (2047 rows, 1<<20 rows, D in {1, 3, 8}, a ragged N,
   N = 0, all-INT32_MAX rows, negatives, a misaligned view); and time an
   empty kernel through the same launch path (the launch floor);
3. drive the port's main path: populate a 1M-key ``set_aw`` table (3 adds
   per key, removes on 10% of the keys) through ``TypedTable.append``,
   serve 60 Zipf(1.0) batches of 16384 keys through ``read_resolved_flat``
   (every fifth at the VC 60% through the add stream), check a sample
   against a host oracle built from the op stream, then run an
   ``AntidoteNode`` workload on ``set_aw`` and ``counter_pn`` against a
   host model, historical reads included; then the serving read plane
   (``serving``) on a 250,000-key ``set_aw`` store populated through
   ``KVStore.apply_effect_groups``: two copy publishes and ten scatters of
   serving epochs, 60 Zipf batches read through the epoch plane (pin,
   launch — one of them under the CUDA sync debug mode — finish, unpin)
   while a second thread commits through the manager, which publishes
   inline, every value held to the locked read at the epoch's clock (or,
   for a row since GC'd below the device's coverage there, to the host
   oracle); whole-batch snapshot-cache reads of the hot set; the table's
   rung 2 (no fold) and rung 3 (``set_aw_fold``); a node's Zipf-hot
   reads through the value cache, warm and cold;
4. drive a 4-member DC (``ClusterMember``/``ClusterNode`` over localhost
   RPC, 2048 shards, all on the card): populate 100,000 ``set_aw`` keys
   from every member's coordinator, remove on 2,000 keys through the
   owners' downstream, run mixed transactions from every coordinator
   (every start launches ``stable_min`` on the 2048 x 4 clock matrix),
   a segment of maps, rga and counter_b across the members, and check
   every key against a host model, at the stable snapshot and at an
   older one;
5. the other types (``types``): the nine device types other than set_aw
   and counter_pn, one 25,000-key table each at BASELINE widths, filled
   by a seeded three-lane stream and read fresh and historical, equal to
   the same table built on the CPU; then a node session over them and the
   maps against a host model (``bench_suite.py``'s map and rga workloads,
   counter_b refusals, concurrent writers, slot promotion, maps read at an
   older snapshot); and 1,024 keys' 4,096-op logs of the five
   assoc-capable types, ``assoc_fold`` and ``fold_long`` equal to
   ``fold_batch`` on the card;
6. durability (``durable``): an ``AntidoteNode`` with a log directory on
   the local disk (``tempfile``), at BASELINE's configuration with 30% of
   its keys: 300,000 ``set_aw`` keys
   (2 adds each, removes on 10%) and 100,000 ``counter_pn`` keys (2
   increments) committed through the manager in groups; a full
   checkpoint (its stamp's time under the commit lock against its copy
   bound); 32 rounds of 4,096 Zipf-distinct keys, then a delta link taken
   while a second thread commits; a WAL tail of 16 rounds; ``recover=True``
   on the card, equal to the live node in the recovery digest, every fresh
   value, every tail key at the clock inside the tail (which folds the
   recovered rings: ``set_aw_fold``, ``counter_fold``) and the heads at
   every row the directory references; a read below the image's stamp
   raises the compaction-horizon error; the replay-read ladder (``assoc``,
   ``serial``, ``long``) against a host model; commit latency under
   ``sync_log`` false and true.  Its figures print on a ``durable:`` line
   beside the card.  The node carries a cold tier with no budget, so its
   full image writes the cold sidecar, and the directory is kept for:
7. the cold tier and shard handoff (``cold``) on that directory: a
   recovery with 150,000 of its 400,000 rows resident (the rest evicted
   to the sidecar), 10 Zipf(1.0) batches of 16,384 keys over every key
   faulting cold keys in (every value equal to the durable phase's, beside
   the same batches on its all-resident node), writes to faulted-in keys
   and reads between them (``set_aw_fold``, ``counter_fold``), a burst of
   cold reads under a fault-rate cap and an injected ``coldtier.fault``
   (typed ``ColdMiss``, never a wrong value), a full image carrying the
   cold rows forward, a delta link after more evictions, a recovery with
   the cold keys registered, one shard exported (its cold keys faulted
   in), imported into a fresh durable node and dropped at the source (no
   key resurrects at the source's restart), and the destination, restarted,
   resharded from 8 to 16 shards (every value and route equal).  Its
   figures print on a ``cold:`` line beside the card;
8. the wire front end (``wire``): ``bench_wire.py``'s
   ``set_aw_zipf_north_star`` at its full size, 200,000 ``set_aw`` keys
   at BASELINE's widths populated through ``KVStore.apply_effect_groups``
   into an ephemeral ``AntidoteNode`` that a ``ProtocolServer`` with the
   JAX package's defaults serves over localhost: the server's launch
   stage under the CUDA sync debug mode; epoch reads launched on one
   thread and finished on another while a third commits and publishes,
   equal to the locked read at each epoch's clock; 32 workers in 2 client
   processes (``chip_smoke.py --wire-worker``; 90% static reads,
   Zipf(1.0)) for an untimed 3 s round and a timed 10 s window, the
   card's busy share over 2 s of the same load right after it; every
   touched key and 2,048 others
   read back over the wire at the join of the acknowledged clocks, equal
   to a host model; read-your-writes on 4 clients; an interactive session
   whose reads fold (``set_aw_fold``, ``counter_fold``) and a
   certification conflict (``RemoteAbort``), the apb dialect beside it; a
   second server with ``max_in_flight=4`` under a burst of 32 updates
   (every refusal a typed ``RemoteBusy``, no acknowledged write lost) and
   a 1 µs deadline (``RemoteDeadline``); the node status over the wire.
   Its figures print on a ``wire:`` line beside the card;
9. the native front end (``native``), the serve default: the wire phase's
   node, its Python-plane server closed, served by a
   ``ProtocolServer(native_frontend=True)`` with the same defaults (the
   C++ epoll plane and the native router build with g++ at first use):
   the same timed load, with the native plane's hit share, crossings per
   drain and mirror pushes over the window beside this call's wire
   figures; every key touched in either window and 2,048 others read back
   through the native plane, equal to the host model, with
   ``native_hits > 0`` and no fallback; clockless counter reads after
   each of 8 increments never past the committed total and converging;
   one whole-batch hit byte-equal to the Python plane's at one epoch id;
   the interactive session (``set_aw_fold``, ``counter_fold``) and the
   apb dialect; a burst of 32 updates against a native server with
   ``max_in_flight=4`` (every shed a typed ``RemoteBusy``); 1M string keys
   through the native router in batches of 16,384, a sample equal to the
   plain XXH64.  Its figures print on a ``native:`` line beside the card;
10. print one JSON line per kernel record, the card line, and last the
   ``{"ok": true, ...}`` line.

The launch counts are reset just before the serve, the node workload, the
serving plane, the cluster, the types phase, the durable phase, the cold
phase, the wire phase and the native phase, and read just after each; each
must show the kernels that ``PATH_KERNELS`` names for it, and a kernel
record's ``launches`` is the sum over the nine.
The serve must launch ``orset_presence`` exactly once per
``SetAW.resolve``, and a resolve on a CUDA state must call no torch sort.
Exits non-zero without a CUDA device, and outside a
checkout of the repository.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
OPS_PER_S = 67e12          # H100 SXM FP32 rate outside the tensor cores
SOURCE = "antidote_tpu_torch/csrc/materializer.cu"
REPLACES = {
    "orset_presence": "antidote_tpu/materializer/pallas_kernels.py:526",
    "counter_fold": "antidote_tpu/materializer/pallas_kernels.py:84",
    "set_aw_fold": "antidote_tpu/materializer/pallas_kernels.py:281",
    "stable_min": "antidote_tpu/materializer/pallas_kernels.py:223",
}
# main-path shapes: serve batch, ring, clock lanes, set slots
B, K, D, E = 16384, 16, 4, 16
N_KEYS, ADDS_PER_KEY, POP_BATCH = 1_000_000, 3, 16384
SERVE_BATCHES, HIST_EVERY = 60, 5
# the cluster: members, shards, keys, adds per key, updates per populate
# txn, removed keys, mixed txns per coordinator.  The keys are half of
# the repo benchmark's 200,000 (cut with the cold phase's arrival: the
# script's 600 s budget; the populate scales with them); the mixed
# transactions half of the 256 a coordinator of earlier runs (cut with the
# wire phase's arrival, the same budget)
CL_MEMBERS, CL_SHARDS, CL_KEYS, CL_ADDS = 4, 2048, 100_000, 3
CL_TXN, CL_REMOVES, CL_MIXED = 1024, 2000, 128
# set_aw_fold's edge cases (K, E, D) at an odd B: the tier widths, widths
# that fill no whole segment of lanes, 1 to 12 clock lanes, rings of one
# op and past one warp; together they reach every variant of the launcher
SET_AW_EDGE_B = 999
SET_AW_CASES = [
    (16, 8, 4), (16, 16, 4), (16, 17, 4), (16, 40, 4), (16, 64, 4),
    (16, 256, 4), (16, 16, 1), (16, 16, 3), (33, 40, 3), (16, 8, 8),
    (16, 16, 8), (16, 17, 8), (16, 64, 8), (16, 256, 8), (1, 16, 4),
    (33, 16, 4), (16, 1024, 4), (16, 16, 12),
]
# orset_presence's edge cases (E, D) at an odd B: the tier widths, widths
# that fill no whole group of lanes, 1 to 8 clock lanes
ORSET_EDGE_B = 999
ORSET_CASES = [(8, 4), (16, 4), (17, 4), (40, 4), (64, 4), (256, 4),
               (16, 1), (16, 3), (40, 3), (16, 8), (64, 8)]
# counter_fold's edge cases (K, D): a ring of one op, the path's, one past
# a warp
COUNTER_CASES = [(1, 4), (16, 4), (33, 4), (16, 1), (16, 3), (33, 8)]
# the types phase: the nine device types at BASELINE widths, one table of
# TY_KEYS keys each, TY_ROUNDS ops a key (every ring GCs once), historical
# reads at the cut after TY_CUT rounds.  25,000 keys a type, a quarter of
# the 100,000 of earlier runs (cut with the cold phase's arrival: the
# populate and its CPU twin scale with the keys)
TY_KEYS, TY_ROUNDS, TY_CUT, TY_SHARDS = 25_000, 20, 18, 8
MV_SLOTS, RGA_SLOTS = 4, 64
# the serving phase: keys (a quarter of BASELINE's 1M: halved with the
# cold phase's arrival and again with the wire phase's, for the 600 s
# budget; the populate through the store scales with them),
# element pool, publish rounds of SV_ROUND_KEYS keys x 4 effects,
# epoch-read batches, the concurrent writer's round size, the hot set;
# long logs of LL_OPS ops for LL_KEYS keys
SV_KEYS = 250_000
SV_POOL, SV_ROUNDS, SV_ROUND_KEYS, SV_BATCHES = 4096, 10, 4096, 60
SV_WRITE_KEYS, SV_HOT = 256, 1024
LL_KEYS, LL_OPS = 1024, 4096
# the durable phase: set_aw and counter_pn keys, transactions per commit
# group, delta rounds before the link and tail rounds after it (each of
# SV_ROUND_KEYS keys), the ladder's long logs (past its fold chunk of
# 1,024 ops; 5,000 past 4,096 before the cold phase came).  The set keys
# are 30% of BASELINE's 1M (half of it before the native phase came: at
# 500,000 the phase took 130-160 s on the card and, with the native phase,
# the whole script 588 s on a slower host; its populate, full image and
# whole-store reads grow with the keys, and so do the cold phase's
# evictions and export on the same directory)
DU_SET_KEYS, DU_CTR_KEYS, DU_GROUP = 300_000, 100_000, 4096
DU_ROUNDS, DU_TAIL_ROUNDS, DU_LADDER_LONG = 32, 16, 1500
# the cold phase, on the durable phase's directory: the resident budget
# (about the rows the delta link and the WAL tail wrote, which cannot go
# cold; a quarter of the 600,000 rows before the native phase's cut, now
# 150,000 of 400,000), Zipf read batches (10, half of earlier
# runs' 20: cut with the wire phase's arrival for the 600 s budget), the
# faulted-in keys of
# the write rounds, the rate cap's fault-ins a second and its burst, the
# sample of keys checked after the second recovery, the budget the delta
# link's evictions go down to, the shard moved by handoff and the
# reshard's shard count
CO_RESIDENT, CO_BATCHES, CO_ROUND_KEYS = 150_000, 10, 2048
CO_CAP, CO_BURST, CO_SAMPLE, CO_EVICT_TO = 10.0, 256, 2048, 100_000
CO_SHARD, CO_NEW_SHARDS = 3, 16
# the wire phase: bench_wire.py's set_aw_zipf_north_star (config 3) at its
# full size — keys, client processes, worker threads a process, the
# untimed round and the timed window (seconds), the read fraction, the
# sample of untouched keys read back; the three-thread check's batches and
# commit rounds; read-your-writes pairs a client; the interactive
# session's keys of each type; the overload burst
WI_KEYS, WI_PROCS, WI_THREADS = 200_000, 2, 16
WI_WARM_S, WI_WINDOW_S, WI_READ_FRAC, WI_SAMPLE = 3.0, 10.0, 0.9, 2048
# seconds of the same load after the window, untimed: the card's profile
WI_TAIL_S = 2.5
WI_TT_BATCHES, WI_TT_ROUNDS, WI_RYW_PAIRS, WI_TXN_KEYS = 16, 4, 50, 64
WI_BURST = 32
# the native phase, on the wire phase's node and at its load: the
# soundness check's increments, and the router's string keys and batch
NA_SOUND_ROUNDS = 8
NA_ROUTER_KEYS, NA_ROUTER_BATCH = 1_000_000, 16_384
# the kernels each path must launch: the serve resolves sets (presence)
# and folds the historical batches; the node session folds a set and a
# counter at older snapshots; every cluster transaction start merges the
# members' clock rows; the types session resolves map_rr memberships
# (sets) and reads maps at an older snapshot (membership sets and
# counter_pn fields); the serving plane resolves every epoch and rung-2
# gather (sets) and folds rung 3's stale rows; the durable node resolves
# every set read, and its reads at the clock inside the WAL tail fold the
# recovered rings (sets and counters); the cold phase resolves every set
# read, faulted-in keys included, and its reads between two writes to
# faulted-in keys fold the installed base (sets and counters); the wire
# server resolves every static read that misses the snapshot cache (one
# launch an epoch-read chunk), and its interactive session reads sets and
# counters at a snapshot older than other clients' writes (the folds); the
# native plane's drained reads that miss the mirror and the snapshot cache
# ride the same epoch-read chunks, and its session folds as the wire's does
PATH_KERNELS = {"serve": ("orset_presence", "set_aw_fold"),
                "node": ("counter_fold", "set_aw_fold"),
                "serving": ("orset_presence", "set_aw_fold"),
                "cluster": ("stable_min",),
                "types": ("orset_presence", "set_aw_fold", "counter_fold"),
                "durable": ("orset_presence", "set_aw_fold",
                            "counter_fold"),
                "cold": ("orset_presence", "set_aw_fold", "counter_fold"),
                "wire": ("orset_presence", "set_aw_fold", "counter_fold"),
                "native": ("orset_presence", "set_aw_fold", "counter_fold")}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of ``fn`` (CUDA events around each call), with
    the L2 cache flushed before every call: ``flush`` is a tensor to zero
    (64 MiB: every line of the cache evicted, and left dirty) or a callable
    that does the flushing.  A ~1 ms spin queued ahead of the start event
    keeps the wrapper's host-side work (checks, output allocation, the
    launch itself) out of the measured interval."""
    do_flush = flush if callable(flush) else flush.zero_
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        do_flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(torch, got, want) -> float:
    if isinstance(got, dict):
        return max(max_abs_err(torch, got[f], want[f]) for f in got)
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return float(diff.max()) if diff.numel() else 0.0


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_inputs(torch, dev, e: int, seed: int):
    """A set_aw ring batch like the serve path's stale rows: a warm base
    state, rings of adds and removes over a small handle pool per key,
    clocks around the base/read window."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    pool = ri(1, 2**62, (B, 24), torch.int64)
    pick = ri(0, 24, (B, e), torch.int64)
    elems = torch.gather(pool, 1, pick)
    elems[ri(0, 10, (B, e)) < 4] = 0
    state = {"elems": elems, "addvc": ri(0, 6, (B, e, D)),
             "rmvc": ri(0, 6, (B, e, D)), "ovf": ri(0, 2, (B,))}
    handles = torch.gather(pool, 1, ri(0, 24, (B, K), torch.int64))
    kind = (ri(0, 10, (B, K)) < 3).to(torch.int32)
    ops_b = torch.cat([kind[..., None], ri(0, 8, (B, K, D))], -1)
    ring = {
        "ops_a": handles[..., None].contiguous(),
        "ops_b": ops_b.contiguous(),
        "ops_vc": ri(0, 9, (B, K, D)),
        "ops_origin": ri(0, D, (B, K)),
        "n_ops": ri(0, K + 1, (B,)),
        "base_vc": ri(0, 3, (B, D)),
        "read_vc": ri(4, 9, (B, D)),
    }
    return state, ring


def check_set_aw_edges(torch, ck, dev, flush) -> dict:
    """``set_aw_fold`` against its plain version on every case of
    SET_AW_CASES; fails unless the cases reached every variant of the
    launcher.  Returns variant -> {case, ms} (the kernel's time on that
    case, L2 flushed)."""
    from antidote_tpu_torch.materializer.fold_cases import set_aw_edge_batch

    rng = np.random.default_rng(29)
    seen = {}
    for k, e, d in SET_AW_CASES:
        state, ring = set_aw_edge_batch(rng, SET_AW_EDGE_B, k, e, d)
        st = {f: torch.as_tensor(x, device=dev) for f, x in state.items()}
        args = [torch.as_tensor(x, device=dev) for x in ring]
        got = ck.set_aw_fold(st, *args)
        want = ck.set_aw_fold_plain(st, *args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        variant = ck.set_aw_fold_variant(e, d)
        if err != 0:
            raise AssertionError(f"set_aw_fold K={k} E={e} D={d} "
                                 f"({variant}) differs: {err}")
        case = f"B={SET_AW_EDGE_B} K={k} E={e} D={d}"
        ms = time_ms(torch, lambda: ck.set_aw_fold(st, *args), 5, flush)
        seen.setdefault(variant, {"case": case, "ms": ms})
        log(f"set_aw_fold {case} ({variant}): exact, {ms:.4f} ms")
    missing = sorted(set(ck.set_aw_fold_variants()) - set(seen))
    if missing:
        raise AssertionError(f"set_aw_fold variants never checked: {missing}")
    return seen


def included(torch, ring):
    """bool[B, K]: the slots the inclusion test admits (what the folds'
    data needs)."""
    v = ring["ops_vc"]
    slots = torch.arange(v.shape[1], device=v.device)
    return (~(v <= ring["base_vc"][:, None]).all(-1)
            & (v <= ring["read_vc"][:, None]).all(-1)
            & (slots[None] < ring["n_ops"][:, None]))


def check_kernels(torch, ck, dev) -> dict:
    """Each kernel against its plain version on the same card inputs.
    Returns name -> record (without launches)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    ring_order = ("ops_a", "ops_b", "ops_vc", "ops_origin", "n_ops",
                  "base_vc", "read_vc")
    for e in (E, 4 * E):
        state, ring = kernel_inputs(torch, dev, e, seed=e)
        inc = included(torch, ring)
        n_inc = int(inc.sum())
        visited = int(torch.clamp(ring["n_ops"], max=K).sum())
        args = [ring[n] for n in ring_order]
        got = ck.set_aw_fold(state, *args)
        want = ck.set_aw_fold_plain(state, *args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            raise AssertionError(f"set_aw_fold E={e} differs: {err}")
        per_op = 8 + 4 * (1 + D) + 4  # handle, kind + observed VC, origin
        n_b = (2 * nbytes(*state.values()) + visited * 4 * D
               + n_inc * per_op + 4 * B * (1 + 2 * D) + 4 * B)
        n_o = visited * 2 * D + n_inc * e * (2 * D + 3)
        bms, by = bound_ms(n_b, n_o)
        rec = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ck.set_aw_fold(state, *args), 20,
                          flush),
            "plain_ms": time_ms(torch, lambda: ck.set_aw_fold_plain(
                state, *args), 3, flush),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={B} K={K} D={D} E={e}, {n_inc} ops included",
        }
        log(f"set_aw_fold E={e}: exact; {rec}")
        if e != E:
            # the tier-1 width: a sub-record of the same kernel
            rec["variant"] = ck.set_aw_fold_variant(e, D)
            out["set_aw_fold"]["tier1"] = rec
            out["orset_presence"]["tier1"] = orset_records(torch, ck, state,
                                                           flush)
            continue
        out["set_aw_fold"] = rec
        rec["variant"] = ck.set_aw_fold_variant(e, D)
        rec["variants"] = check_set_aw_edges(torch, ck, dev, flush)
        out["orset_presence"] = orset_records(torch, ck, state, flush)
        out["orset_presence"]["edge_cases"] = check_orset_edges(torch, ck,
                                                                dev)
        # counter_fold over the same ring, int64 deltas past the i32 bound
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        deltas = torch.randint(-2**40, 2**40, (B, K), generator=g,
                               device=dev, dtype=torch.int64)
        base = torch.randint(-2**40, 2**40, (B,), generator=g, device=dev,
                             dtype=torch.int64)
        cargs = (base, deltas, ring["ops_vc"], ring["n_ops"],
                 ring["base_vc"], ring["read_vc"])
        err = max_abs_err(torch, ck.counter_fold(*cargs),
                          ck.counter_fold_plain(*cargs))
        if err != 0:
            raise AssertionError(f"counter_fold differs: {err}")
        n_b = (8 * B + visited * 4 * D + n_inc * 8 + 4 * B * (1 + 2 * D)
               + 12 * B)
        bms, by = bound_ms(n_b, visited * (2 * D + 2))
        out["counter_fold"] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ck.counter_fold(*cargs), 20, flush),
            "plain_ms": time_ms(torch, lambda: ck.counter_fold_plain(*cargs),
                                5, flush),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={B} K={K} D={D}, {n_inc} ops included",
        }
        out["counter_fold"]["edge_cases"] = check_counter_edges(torch, ck,
                                                                dev)
        log(f"counter_fold: exact; {out['counter_fold']}")
    return out


def orset_records(torch, ck, state, flush) -> dict:
    """``orset_presence`` (the mask form) at the state's shape, with its
    ``orset_resolve`` sub-record (presence fused with the resolve's top-K
    compaction), each exact against its plain version and timed beside it.
    The sub-record's ``library_ms`` is the unfused sequence it replaces:
    the mask kernel, then ``compact_top`` (argsort, where, gather, sum)."""
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.crdt.base import compact_top

    top = get_type("set_aw").resolve_top
    b, e = state["elems"].shape
    pres = (state["addvc"], state["rmvc"], state["elems"])
    err = max_abs_err(torch, ck.orset_presence(*pres),
                      ck.orset_presence_plain(*pres))
    if err != 0:
        raise AssertionError(f"orset_presence E={e} differs: {err}")
    ops = b * e * (2 * D + 2)
    bms, by = bound_ms(nbytes(*pres) + b * e, ops)
    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ck.orset_presence(*pres), 20, flush),
        "plain_ms": time_ms(torch, lambda: ck.orset_presence_plain(*pres),
                            5, flush),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": f"B={b} E={e} D={D}",
    }
    res = (state["elems"], state["addvc"], state["rmvc"], top)
    err = max_abs_err(torch, ck.orset_resolve(*res),
                      ck.orset_resolve_plain(*res))
    if err != 0:
        raise AssertionError(f"orset_resolve E={e} differs: {err}")
    calls = resolve_torch_calls(torch, state)
    if any("sort" in c for c in calls):
        raise AssertionError(f"SetAW.resolve on a CUDA state sorts: {calls}")
    bms, by = bound_ms(nbytes(*pres) + b * (8 * min(top, e) + 4), ops)
    rec["orset_resolve"] = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ck.orset_resolve(*res), 20, flush),
        "plain_ms": time_ms(torch, lambda: ck.orset_resolve_plain(*res), 5,
                            flush),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(torch, lambda: compact_top(
            state["elems"], ck.orset_presence(*pres), top), 20, flush),
        "library": "orset_presence mask kernel + compact_top (unfused)",
        "shape": f"B={b} E={e} D={D} top={top}",
        "resolve_torch_calls": sorted(set(calls)),
    }
    log(f"orset_presence E={e}: both forms exact; {rec}")
    return rec


def resolve_torch_calls(torch, state) -> list:
    """The names of the torch functions that one ``SetAW.resolve`` calls
    on ``state`` (a sort among them would be the compaction's argsort)."""
    from torch.overrides import TorchFunctionMode

    from antidote_tpu_torch.crdt import get_type

    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(getattr(func, "__name__", repr(func)))
            return func(*args, **(kwargs or {}))

    with Record():
        get_type("set_aw").resolve(None, state)
    return seen


def misaligned(torch, x):
    """A copy of ``x`` as a view one element into its allocation (an
    int32 view then sits 4 bytes past a 16-byte boundary)."""
    flat = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      x.reshape(-1)])
    return flat[1:].view(x.shape)


def check_orset_edges(torch, ck, dev) -> list:
    """Both forms of ``orset_presence`` against their plain versions on
    ORSET_CASES (``orset_edge_batch``: counts 0, top and past top, empty
    slots with present clocks, the special handles, negatives), with top
    0 and past E on the path's widths and misaligned clock views (the
    scalar-load form) at D = 4.  Returns the cases checked."""
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.materializer.fold_cases import orset_edge_batch

    top = get_type("set_aw").resolve_top
    rng = np.random.default_rng(31)
    done = []
    for e, d in ORSET_CASES:
        el, av, rv = (torch.as_tensor(x, device=dev)
                      for x in orset_edge_batch(rng, ORSET_EDGE_B, e, d, top))
        views = [("aligned", av, rv)]
        tops = [top]
        if d == 4 and e in (E, 4 * E):
            views.append(("misaligned", misaligned(torch, av),
                          misaligned(torch, rv)))
            tops += [0, e + 3]
        for view, a, r in views:
            err = max_abs_err(torch, ck.orset_presence(a, r, el),
                              ck.orset_presence_plain(a, r, el))
            for t in tops:
                err = max(err, max_abs_err(
                    torch, ck.orset_resolve(el, a, r, t),
                    ck.orset_resolve_plain(el, a, r, t)))
            torch.cuda.synchronize()
            case = f"B={ORSET_EDGE_B} E={e} D={d} {view} top={tops}"
            if err != 0:
                raise AssertionError(f"orset_presence {case} differs: {err}")
            done.append(case)
    log(f"orset_presence: both forms exact on {len(done)} edge cases")
    return done


def check_counter_edges(torch, ck, dev) -> list:
    """``counter_fold`` against its plain version on COUNTER_CASES
    (``counter_edge_batch``: n_ops 0 and past K, deltas past int32, all
    excluded), with the deltas contiguous and as lane 0 of a [B, K, 3]
    ring (a strided view), and at D = 4 with misaligned clock views (the
    scalar-load form).  Returns the cases checked."""
    from antidote_tpu_torch.materializer.fold_cases import counter_edge_batch

    rng = np.random.default_rng(37)
    done = []
    for k, d in COUNTER_CASES:
        args = [torch.as_tensor(x, device=dev)
                for x in counter_edge_batch(rng, ORSET_EDGE_B, k, d)]
        want = ck.counter_fold_plain(*args)
        wide = torch.zeros(args[1].shape + (3,), dtype=torch.int64,
                           device=dev)
        wide[..., 0] = args[1]
        forms = {"contiguous": args,
                 "strided": args[:1] + [wide[..., 0]] + args[2:]}
        if d == 4:
            forms["misaligned"] = ([args[0], wide[..., 0]]
                                   + [misaligned(torch, x) for x in args[2:]])
        for form, a in forms.items():
            err = max_abs_err(torch, ck.counter_fold(*a), want)
            torch.cuda.synchronize()
            case = f"B={ORSET_EDGE_B} K={k} D={d} {form}"
            if err != 0:
                raise AssertionError(f"counter_fold {case} differs: {err}")
            done.append(case)
    log(f"counter_fold: exact on {len(done)} edge cases")
    return done


def check_stable_min(torch, ck, dev) -> dict:
    """The ``stable_min`` kernel against its plain version, bit for bit, on
    the edge cases; timed at the cluster path's 2048 x 4 and at 1<<20 x 4
    beside the plain version and one ``torch.amin`` call (the library's),
    and at the path shape a whole ``stable_min_of`` round trip (host to
    device, kernel, device to host) beside the host numpy minimum."""
    from antidote_tpu_torch.store.kv import stable_min_of

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(5)
    i32max = 2**31 - 1

    def matrix(n, d, lo=-2**31, hi=i32max, max_share=0.3):
        x = rng.integers(lo, hi, size=(n, d), dtype=np.int64)
        x[rng.random(n) < max_share] = i32max  # identity rows
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    cases = {
        "path 2048x4": matrix(CL_SHARDS, D, 0, 1 << 20, 0.0),
        "2047x4 (below the threshold)": matrix(CL_SHARDS - 1, D),
        "1<<20x4": matrix(1 << 20, D),
        "D=1": matrix(1000, 1), "D=3": matrix(777, 3), "D=8": matrix(3001, 8),
        "ragged N=2125": matrix(2125, D),
        "N=0": torch.empty((0, D), dtype=torch.int32, device=dev),
        "all INT32_MAX": torch.full((4096, D), i32max, dtype=torch.int32,
                                    device=dev),
        "negative": matrix(5000, D, -2**31, 0, 0.0),
        # one word into an allocation: the grid takes 4-byte loads
        "misaligned view": torch.cat([
            torch.zeros(1, dtype=torch.int32, device=dev),
            matrix(1 << 20, D).reshape(-1)])[1:].view(1 << 20, D),
    }
    for name, x in cases.items():
        got, want = ck.stable_min(x), ck.stable_min_plain(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        host = x.cpu().numpy()
        ref = host.min(axis=0) if len(host) else np.full(x.shape[1], i32max)
        if err != 0 or not np.array_equal(got.cpu().numpy(), ref):
            raise AssertionError(f"stable_min {name} differs: {err}")
    log(f"stable_min: exact on {len(cases)} cases ({', '.join(cases)})")

    def record(x):
        n, d = x.shape
        bms, by = bound_ms(4 * n * d + 4 * d, n * d)
        return {
            "max_abs_err": max_abs_err(torch, ck.stable_min(x),
                                       ck.stable_min_plain(x)),
            "ms": time_ms(torch, lambda: ck.stable_min(x), 50, flush),
            "plain_ms": time_ms(torch, lambda: ck.stable_min_plain(x), 50,
                                flush),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(torch, lambda: torch.amin(x, 0), 50,
                                  flush),
            "shape": f"N={n} D={d}",
        }

    rec = record(cases["path 2048x4"])
    rec["stress"] = record(cases["1<<20x4"])
    # a whole stable-time merge, as a member runs it, beside the host
    # numpy min of the same matrix: at the path's shape and at larger row
    # counts, to place the crossover against the 2048-row threshold
    sweep = {}
    for n in (CL_SHARDS, 4 * CL_SHARDS, 16 * CL_SHARDS, 64 * CL_SHARDS):
        mat = rng.integers(0, 1 << 20, size=(n, D)).astype(np.int32)
        trips, host = [], []
        for _ in range(100):
            t0 = time.perf_counter()
            stable_min_of(mat, dev)
            t1 = time.perf_counter()
            mat.min(axis=0)
            host.append((time.perf_counter() - t1) * 1e3)
            trips.append((t1 - t0) * 1e3)
        sweep[n] = {"stable_min_of_ms": float(np.median(trips)),
                    "host_numpy_min_ms": float(np.median(host))}
    rec["stable_min_of_vs_host"] = sweep
    log(f"stable_min: {rec}")
    return rec


def profile_window(torch, step, steps) -> dict:
    """Where a path's time goes: ``torch.profiler`` over ``step(i)`` for i
    in ``steps`` (one serve round of HIST_EVERY batches, one historical;
    or a window of cluster transactions).  Reports the device's busy
    share of the wall time and the kernels with the most device time.
    The profiler's own host overhead inflates the wall time, so the busy
    share is a lower bound.  An observation, not a phase: a profiler that
    cannot start or read its trace is reported, not fatal; an error of a
    step ends the run like any other."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — reported, see docstring
        return {"error": repr(e)}
    t0 = time.perf_counter()
    for i in steps:
        step(i)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    try:
        prof.stop()
        # device-side events only (the host ops that launched them would
        # count the same time again)
        rows = [(e.self_device_time_total, e.key)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
    except Exception as e:  # noqa: BLE001 — reported, see docstring
        return {"error": repr(e)}
    busy_us = sum(t for t, _ in rows)
    by_name: dict = {}
    for t, k in rows:  # template instances share a truncated name
        by_name[k[:100]] = by_name.get(k[:100], 0.0) + t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_device_ms": {k: ms for k, ms in top if ms > 0}}


# ---------------------------------------------------------------------------
# phase 3a: the 1M-key OR-set populate + serve
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _zipf_cdf(n_keys):
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64)
    return np.cumsum(w / w.sum())


def zipf_keys(rng, n_keys, n):
    """``n`` Zipf(1.0) draws over ``n_keys`` keys (rank 0 the hottest)."""
    return np.minimum(np.searchsorted(_zipf_cdf(n_keys), rng.random(n)),
                      n_keys - 1)


def zipf_distinct(rng, n_keys, n):
    """``n`` distinct keys drawn by Zipf(1.0): a hot working set."""
    out = np.unique(zipf_keys(rng, n_keys, 4 * n))
    while len(out) < n:
        out = np.union1d(out, zipf_keys(rng, n_keys, 4 * n))
    return rng.permutation(out)[:n]


def orset_stream(rng, n_keys=N_KEYS) -> dict:
    """BASELINE's OR-set op stream: ADDS_PER_KEY adds per key in a
    shuffled order (random 62-bit elements), committed on lane 0 at
    stamps 1..total, then removes on a tenth of the keys at stamps past
    the adds, each observing the key's first add's dot.  Returns the keys
    and elements of the adds, their stamps (``lane0``), each key's first
    add (``first_idx``), the removed keys and each key's remove stamp
    (``rm_t``, 0 = none)."""
    keys = np.repeat(np.arange(n_keys, dtype=np.int64), ADDS_PER_KEY)
    rng.shuffle(keys)
    total = keys.shape[0]
    elems = rng.integers(1, 1 << 62, size=total, dtype=np.int64)
    lane0 = np.arange(1, total + 1, dtype=np.int32)  # commit order on lane 0
    first_idx = np.full(n_keys, -1, np.int64)
    rev = np.arange(total - 1, -1, -1)
    first_idx[keys[rev]] = rev
    rm_keys = rng.choice(n_keys, size=n_keys // 10,
                         replace=False).astype(np.int64)
    rm_t = np.zeros(n_keys, np.int64)
    rm_t[rm_keys] = total + 1 + np.arange(len(rm_keys))
    return {"keys": keys, "elems": elems, "lane0": lane0,
            "first_idx": first_idx, "rm_keys": rm_keys, "rm_t": rm_t}


def serve_main_path(torch, dev) -> dict:
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.store import TypedTable

    n_shards = 8
    cfg = AntidoteConfig(n_shards=n_shards, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=N_KEYS // n_shards)
    ty = get_type("set_aw")
    bw = ty.eff_b_width(cfg)
    table = TypedTable(ty, cfg, device=dev)
    table.used_rows[:] = N_KEYS // n_shards
    rng = np.random.default_rng(7)

    def srows(keys):
        return keys % n_shards, keys // n_shards

    st = orset_stream(rng)
    keys, elems, lane0 = st["keys"], st["elems"], st["lane0"]
    first_idx, rm_keys, rm_t = st["first_idx"], st["rm_keys"], st["rm_t"]
    total = keys.shape[0]
    t0 = time.perf_counter()
    for lo in range(0, total, POP_BATCH):
        hi = min(lo + POP_BATCH, total)
        m = hi - lo
        vcs = np.zeros((m, D), np.int32)
        vcs[:, 0] = lane0[lo:hi]
        ss, rr = srows(keys[lo:hi])
        table.append(ss, rr, elems[lo:hi, None], np.zeros((m, bw), np.int32),
                     vcs, np.zeros(m, np.int32))
    for lo in range(0, len(rm_keys), POP_BATCH):
        kk = rm_keys[lo:lo + POP_BATCH]
        m = len(kk)
        eff_b = np.zeros((m, bw), np.int32)
        eff_b[:, 0] = 1
        eff_b[:, 1] = lane0[first_idx[kk]]  # observes the first add's dot
        vcs = np.zeros((m, D), np.int32)
        vcs[:, 0] = rm_t[kk]
        ss, rr = srows(kk)
        table.append(ss, rr, elems[first_idx[kk], None], eff_b, vcs,
                     np.zeros(m, np.int32))
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t0
    final_t, mid_t = total + len(rm_keys), int(total * 0.6)
    log(f"populate: {total + len(rm_keys)} ops in {populate_s:.2f} s")

    # ---- serve: Zipf(1.0) batches, every fifth at the historical VC ----
    streams = [zipf_keys(rng, N_KEYS, B) for _ in range(37)]
    vc_final = np.zeros((B, D), np.int32)
    vc_final[:, 0] = final_t
    vc_mid = np.zeros((B, D), np.int32)
    vc_mid[:, 0] = mid_t

    def serve(i):
        ss, rr = srows(streams[i % len(streams)])
        hist = i % HIST_EVERY == HIST_EVERY - 1
        return table.read_resolved_flat(ss, rr, vc_mid if hist else vc_final)

    for i in range(2 * HIST_EVERY):  # warm-up: both VC variants
        serve(i)
    torch.cuda.synchronize()
    from antidote_tpu_torch.materializer import cuda_kernels as ck

    before = dict(ck.LAUNCHES)
    disp_before = dict(table.fold_dispatches)
    lat = {"fresh": [], "historical": []}
    t0 = time.perf_counter()
    for i in range(SERVE_BATCHES):
        t1 = time.perf_counter()
        resolved, fresh, complete = serve(i)
        torch.cuda.synchronize()
        kind = "historical" if i % HIST_EVERY == HIST_EVERY - 1 else "fresh"
        lat[kind].append((time.perf_counter() - t1) * 1e3)
        if not complete.all():
            raise AssertionError(f"serve batch {i}: incomplete rows")
    serve_s = time.perf_counter() - t0
    serve_launches = {n: ck.LAUNCHES[n] - before[n] for n in before}
    dispatches = {s: n - disp_before.get(s, 0)
                  for s, n in table.fold_dispatches.items()}
    profile = profile_window(torch, serve, range(HIST_EVERY))

    # ---- check: a 2,000-key sample at both VCs against the op stream ----
    sample = rng.choice(N_KEYS, size=2000, replace=False).astype(np.int64)
    pos = np.nonzero(np.isin(keys, sample))[0]
    adds = {int(k): [] for k in sample}
    for p in pos:
        adds[int(keys[p])].append((int(lane0[p]), int(elems[p])))
    for t_read in (final_t, mid_t):
        vcs = np.zeros((len(sample), D), np.int32)
        vcs[:, 0] = t_read
        ss, rr = srows(sample)
        res, _, complete = table.read_resolved(ss, rr, vcs)
        if not complete.all():
            raise AssertionError("sample read incomplete")
        for j, k in enumerate(sample.tolist()):
            want = {el for t, el in adds[k] if t <= t_read}
            if 0 < rm_t[k] <= t_read:
                want.discard(int(elems[first_idx[k]]))
            got = {int(h) for h in res["top"][j] if h != 0}
            if got != want or int(res["count"][j]) != len(want):
                raise AssertionError(
                    f"key {k} at t={t_read}: {sorted(got)} (count "
                    f"{int(res['count'][j])}) != oracle {sorted(want)}")
    log("serve: 2000-key sample matches the oracle at both VCs")
    all_lat = sorted(lat["fresh"] + lat["historical"])
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    return {
        "populate_s": populate_s,
        "serve_keys_per_s": SERVE_BATCHES * B / serve_s,
        "batch_p50_ms": pct(all_lat, 50), "batch_p99_ms": pct(all_lat, 99),
        "fresh_p50_ms": pct(lat["fresh"], 50),
        "historical_p50_ms": pct(lat["historical"], 50),
        "timed_loop_launches": serve_launches,
        "serve_fold_dispatches": dispatches,
        "profile": profile,
        "resident_gib": torch.cuda.memory_allocated(dev) / 2**30,
    }


# ---------------------------------------------------------------------------
# phase 3b: an AntidoteNode workload against a host model
# ---------------------------------------------------------------------------
def node_workload(dev) -> dict:
    from antidote_tpu_torch.api import AbortError, AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E, keys_per_table=4096)
    node = AntidoteNode(cfg, device=dev)
    rng = np.random.default_rng(11)
    S, C, Bk = "set_aw", "counter_pn", "b"
    model = {**{f"s{i}": set() for i in range(40)},
             **{f"c{i}": 0 for i in range(20)}}
    # ring fill and GC count per key: a read at an old snapshot is served
    # from the device (complete) iff the key was not GC'd since
    fill, gcs = {}, {}
    n_txn = 0

    def ring(key, m=1):
        f = fill.get(key, 0)
        if f + m > K:
            gcs[key] = gcs.get(key, 0) + 1
            f = 0
        fill[key] = f + m

    def objs_of(names):
        return [(k, S if k[0] in "sb" else C, Bk) for k in names]

    def check(names, vals, want, where):
        for k, v in zip(names, vals):
            w = sorted(want[k], key=repr) if isinstance(want[k], set) \
                else want[k]
            if v != w:
                raise AssertionError(f"{where}: {k} = {v!r}, want {w!r}")

    t0 = time.perf_counter()
    for i in range(200):  # static txns
        k = f"s{int(rng.integers(0, 40))}"
        c = f"c{int(rng.integers(0, 20))}"
        x = int(rng.integers(0, 30))
        n = int(rng.integers(1, 1000)) * (1 if i % 7 else 2**35)
        ups = [(k, S, Bk, ("add", x)), (c, C, Bk, ("increment", n))]
        model[k].add(x)
        if i % 5 == 4:
            y = sorted(model[k])[0]
            ups.append((k, S, Bk, ("remove", y)))
            model[k].discard(y)
        node.update_objects(ups)
        n_txn += 1
        model[c] += n
        ring(k, len(ups) - 1)
        ring(c)
    old = node.start_transaction()
    old_model, old_gcs = dict(model), dict(gcs)
    old_model.update({k: set(v) for k, v in model.items()
                      if isinstance(v, set)})
    # interactive txns with read-your-writes
    for i in range(40):
        t = node.start_transaction()
        k, c = f"s{i}", f"c{i % 20}"
        node.update_objects([(k, S, Bk, ("add", 100 + i)),
                             (c, C, Bk, ("decrement", 3))], txn=t)
        model[k].add(100 + i)
        model[c] -= 3
        check([k, c], node.read_objects(objs_of([k, c]), txn=t), model,
              "read-your-writes")
        node.commit_transaction(t)
        n_txn += 1
        ring(k)
        ring(c)
    # two racing read-modify-write txns: the second aborts
    t1, t2 = node.start_transaction(), node.start_transaction()
    for t in (t1, t2):
        node.read_objects(objs_of(["c0"]), txn=t)
        node.update_objects([("c0", C, Bk, ("increment", 1))], txn=t)
    node.commit_transaction(t1)
    model["c0"] += 1
    ring("c0")
    try:
        node.commit_transaction(t2)
        raise AssertionError("the second racing txn committed")
    except AbortError:
        pass
    n_txn += 2
    # tier promotion: one set past its 16 slots
    node.update_objects([("big", S, Bk, ("add_all", list(range(40))))])
    node.update_objects([("big", S, Bk,
                          ("remove_all", list(range(0, 40, 3))))])
    model["big"] = set(range(40)) - set(range(0, 40, 3))
    # a counter past the ring size (GC folds), then a historical reader
    model["hot"] = 0
    for i in range(40):
        node.update_objects([("hot", C, Bk, ("increment", i + 1))])
        model["hot"] += i + 1
    mid = node.start_transaction()
    mid_model = {"hot": model["hot"], "big": set(model["big"])}
    for i in range(5):
        node.update_objects([("hot", C, Bk, ("increment", 1000))])
        model["hot"] += 1000
    n_txn += 47
    txn_s = time.perf_counter() - t0
    names = list(model)
    check(names, node.read_objects(objs_of(names))[0], model, "latest")
    hist = [k for k in old_model if gcs.get(k, 0) == old_gcs.get(k, 0)]
    check(hist, node.read_objects(objs_of(hist), txn=old), old_model,
          "historical (old)")
    check(["hot", "big"], node.read_objects(objs_of(["hot", "big"]),
                                            txn=mid),
          mid_model, "historical (mid)")
    log(f"node: {n_txn} txns match the host model; {len(hist)} keys read "
        "at an older snapshot")
    return {"txns": n_txn, "txn_s": txn_s,
            "historical_keys": len(hist),
            "promotions": node.store.promotions,
            "fold_dispatches": {n: dict(t.fold_dispatches)
                                for n, t in node.store.tables.items()}}


# ---------------------------------------------------------------------------
# phase 3c: the serving read plane at BASELINE's size
# ---------------------------------------------------------------------------
def serving_phase(torch, dev, n_keys=SV_KEYS, batches=SV_BATCHES,
                  rounds=SV_ROUNDS, batch=B) -> dict:
    """The serving read plane on a ``set_aw`` store of ``n_keys``, all on the
    card: populate through ``KVStore.apply_effect_groups`` (BASELINE's
    stream, elements from an interned pool of SV_POOL values); publish
    serving epochs (two copies, then ``rounds`` scatters after commit
    rounds of SV_ROUND_KEYS x 4 effects); epoch reads of Zipf batches
    (pin, launch, finish, unpin) while a second thread commits 256-key
    rounds through the manager, which publishes inline — every batch
    equal to the locked read at its epoch's clock, a sample equal to the
    host oracle; whole-batch snapshot-cache reads of the hot set; the
    table's ladder (rung 2 at a table epoch's cap, rung 3 below it from
    the frozen source, launching ``set_aw_fold``); and a node whose
    Zipf-hot reads go through the value cache, warm against cold.  On a
    CPU device (a rehearsal at a small ``n_keys``) the card-only checks —
    the sync debug mode, peak memory — are skipped."""
    import threading

    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.materializer import cuda_kernels as ck
    from antidote_tpu_torch.obs import NodeMetrics
    from antidote_tpu_torch.store.kv import Effect, KVStore
    from antidote_tpu_torch.txn.manager import TransactionManager

    n_shards = 8
    cfg = AntidoteConfig(n_shards=n_shards, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=n_keys // n_shards)
    ty = get_type("set_aw")
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.synchronize(dev)  # the context exists before the reset
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    store = KVStore(cfg, device=dev)
    m = store.metrics = NodeMetrics()
    rng = np.random.default_rng(29)
    st = orset_stream(rng, n_keys)
    keys, lane0, first_idx = st["keys"], st["lane0"], st["first_idx"]
    rm_keys, rm_t = st["rm_keys"], st["rm_t"]
    total = len(keys)
    # elements: values 0..SV_POOL-1, interned, so reads decode
    pool_h = np.asarray([store.blobs.intern(v) for v in range(SV_POOL)],
                        np.int64)
    vals = (st["elems"] % SV_POOL).astype(np.int64)
    key_vals = np.zeros((n_keys, ADDS_PER_KEY), np.int64)
    occ = np.zeros(n_keys, np.int64)
    for i, k in enumerate(keys.tolist()):  # each key's values, in order
        key_vals[k, occ[k]] = vals[i]
        occ[k] += 1
    eff_a = pool_h[vals][:, None]
    add_b = np.zeros((1 + D,), np.int32)

    # ---- populate through the store's commit path ----------------------
    t0 = time.perf_counter()
    for lo in range(0, total, POP_BATCH):
        hi = min(lo + POP_BATCH, total)
        vcs = np.zeros((hi - lo, D), np.int32)
        vcs[:, 0] = lane0[lo:hi]
        effs = [Effect(k, "set_aw", "b", eff_a[lo + j], add_b)
                for j, k in enumerate(keys[lo:hi].tolist())]
        store.apply_effect_groups([(effs, list(vcs), [0] * (hi - lo))])
    for lo in range(0, len(rm_keys), POP_BATCH):
        kk = rm_keys[lo:lo + POP_BATCH]
        rb = np.zeros((len(kk), 1 + D), np.int32)
        rb[:, 0] = 1
        rb[:, 1] = lane0[first_idx[kk]]  # observes the first add's dot
        vcs = np.zeros((len(kk), D), np.int32)
        vcs[:, 0] = rm_t[kk]
        effs = [Effect(k, "set_aw", "b", eff_a[first_idx[k]], rb[j])
                for j, k in enumerate(kk.tolist())]
        store.apply_effect_groups([(effs, list(vcs), [0] * len(kk))])
    sync()
    populate_s = time.perf_counter() - t0
    table = store.tables["set_aw"]
    tbytes = table_bytes(table)
    slot_bytes = sum(x.numel() * x.element_size()
                     for x in list(table.head.values()) + [table.head_vc])
    log(f"serving: populated {total + len(rm_keys)} effects through the "
        f"store in {populate_s:.2f} s")
    txm = TransactionManager(store)
    txm.metrics = m
    # an adopted store: own-lane commits continue above every stamp
    txm.commit_counter = int(store.dc_max_vc()[0])
    # each key's first re-add stamp (lane 0), recorded under the commit
    # lock with the commit: the host oracle at any clock
    no_write = np.iinfo(np.int64).max
    write_t = np.full(n_keys, no_write, np.int64)
    gone = np.zeros(n_keys, bool)  # the remove took the first value away
    v0 = key_vals[:, 0]
    gone[rm_keys] = (key_vals[rm_keys, 1:] != v0[rm_keys, None]).all(-1)

    def oracle(k, t):
        """Key ``k``'s value at lane-0 clock ``t`` ≥ the populate's end."""
        want = set(key_vals[k].tolist())
        if gone[k] and write_t[k] > t:
            want.discard(int(v0[k]))
        return sorted(want, key=repr)

    def commit_round(kk, per_key):
        """One merged commit group of ``per_key`` re-adds of each key's own
        populate values (a removed element comes back; no key passes
        ADDS_PER_KEY elements), 256 updates a transaction."""
        ups = [(k, "set_aw", "b", ("add", int(key_vals[k, j % ADDS_PER_KEY])))
               for k in kk.tolist() for j in range(per_key)]
        txns, spans = [], []
        for lo in range(0, len(ups), 256):
            t = txm.start_transaction()
            txm.update_objects(ups[lo:lo + 256], t)
            txns.append(t)
            spans.append(np.asarray([u[0] for u in ups[lo:lo + 256]]))
        with txm.commit_lock:
            for r, ks in zip(txm.commit_transactions_group(txns), spans):
                if isinstance(r, Exception):
                    raise r
                np.minimum.at(write_t, ks, int(r[0]))

    def timed_publish():
        before = {md: m.epoch_publish.value(mode=md)
                  for md in ("copy", "scatter", "defer")}
        rows0 = {md: m.epoch_rows.value(mode=md) for md in ("copy",
                                                            "scatter")}
        sync()
        t1 = time.perf_counter()
        res = txm.publish_serving_epoch()
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        mode = [md for md, v in before.items()
                if m.epoch_publish.value(mode=md) > v]
        rows = sum(m.epoch_rows.value(mode=md) - rows0[md] for md in rows0)
        return {"result": res, "mode": mode[0] if mode else None,
                "rows": int(rows), "ms": ms}

    # ---- publishes: two copies, then scatters after commit rounds ------
    copy_bound = bound_ms(2 * slot_bytes, 0)[0]
    publishes = [timed_publish()]
    commit_round(zipf_distinct(rng, n_keys, SV_ROUND_KEYS), 4)
    publishes.append(timed_publish())
    for _ in range(rounds):
        t1 = time.perf_counter()
        commit_round(zipf_distinct(rng, n_keys, SV_ROUND_KEYS), 4)
        commit_s = time.perf_counter() - t1
        publishes.append(dict(timed_publish(), commit_s=commit_s))
    if [p["mode"] for p in publishes[:2]] != ["copy", "copy"] or any(
            p["mode"] != "scatter" for p in publishes[2:]):
        raise AssertionError(f"publish modes: {publishes}")
    row_bytes = slot_bytes / (n_shards * table.n_rows)
    for p in publishes:
        p["bound_ms"] = (copy_bound if p["mode"] == "copy"
                         else bound_ms(2 * p["rows"] * row_bytes, 0)[0])
    log(f"serving: publishes {json.dumps(publishes)}")

    # ---- epoch reads under writes ---------------------------------------
    dir_ = store.directory
    loc = np.asarray([dir_[(k, "b")][1:] for k in range(n_keys)], np.int64)
    batch_keys = [zipf_keys(rng, n_keys, batch) for _ in range(batches)]

    def objs_of(kk):
        return [(k, "set_aw", "b") for k in kk.tolist()]

    # one launch under the CUDA sync debug mode: any stream sync raises
    ep = store.pin_serving_epoch()
    sync()
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        pend, fb = store.epoch_read_launch(objs_of(batch_keys[0]), ep)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    store.epoch_read_finish(pend)
    store.unpin_serving_epoch(ep)
    txm.enable_serving_epochs()
    stop = threading.Event()
    errors: list = []
    w_rounds = [0]
    wrng = np.random.default_rng(31)

    def writer():
        try:
            while not stop.is_set():
                commit_round(zipf_distinct(wrng, n_keys, SV_WRITE_KEYS), 1)
                w_rounds[0] += 1
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errors.append(e)

    hit0 = m.snapshot_cache.value(event="hit")
    miss0 = m.snapshot_cache.value(event="miss")
    gather0 = m.serving_reads.value(path="gather")
    lat, fallbacks, epochs_seen = [], 0, set()
    checked = {"locked": 0, "oracle": 0}
    wt = threading.Thread(target=writer, name="serving-writer")
    wt.start()
    try:
        t0 = time.perf_counter()
        for i, kk in enumerate(batch_keys):
            objs = objs_of(kk)
            t1 = time.perf_counter()
            ep = store.pin_serving_epoch()
            try:
                pend, fb = store.epoch_read_launch(objs, ep)
                got = store.epoch_read_finish(pend)
            finally:
                store.unpin_serving_epoch(ep)
            lat.append((time.perf_counter() - t1) * 1e3)
            fallbacks += len(fb)
            epochs_seen.add(ep.id)
            # every value against the locked read at the epoch's clock;
            # a row the writer GC'd since the epoch is below the device's
            # retained coverage there (the durable log's replay serves it),
            # so it is held to the host oracle instead
            with txm.commit_lock:
                res, _, complete = table.read_resolved(
                    loc[kk, 0], loc[kk, 1], np.broadcast_to(ep.vc,
                                                            (len(kk), D)))
                for j, k in enumerate(kk.tolist()):
                    if complete[j]:
                        want = ty.value_from_resolved(
                            {f: x[j] for f, x in res.items()}, store.blobs,
                            cfg)
                        checked["locked"] += 1
                    else:
                        want = oracle(k, int(ep.vc[0]))
                        checked["oracle"] += 1
                    if got[j] != want:
                        raise AssertionError(
                            f"epoch read batch {i}: key {k} = {got[j]!r}, "
                            f"want {want!r} at {ep.vc}")
            if fb:
                raise AssertionError(f"epoch read batch {i}: fallbacks {fb}")
        read_s = sum(lat) / 1e3
    finally:
        stop.set()
        wt.join(120)
    if errors:
        raise errors[0]
    hits = m.snapshot_cache.value(event="hit") - hit0
    misses = m.snapshot_cache.value(event="miss") - miss0
    # a sample of the final state against the host oracle
    sample = rng.choice(n_keys, size=2000, replace=False)
    vals_now, snap = txm.read_objects_static(objs_of(sample))
    for k, v in zip(sample.tolist(), vals_now):
        if v != oracle(k, int(snap[0])):
            raise AssertionError(f"key {k}: {v!r}, oracle "
                                 f"{oracle(k, int(snap[0]))}")
    log(f"serving: {batches} epoch-read batches under {w_rounds[0]} "
        f"concurrent write rounds; every value checked: {checked}")

    # ---- whole-batch snapshot-cache reads of the hot set ----------------
    hot = objs_of(np.arange(SV_HOT))
    ep = store.pin_serving_epoch()
    try:
        first = store.epoch_cache_read(hot, ep)
        if first is None:  # fill the hot set at this epoch
            pend, _ = store.epoch_read_launch(hot, ep)
            store.epoch_read_finish(pend)
        t1 = time.perf_counter()
        whole = [store.epoch_cache_read(hot, ep) for _ in range(10)]
        cache_ms = (time.perf_counter() - t1) * 1e3 / 10
    finally:
        store.unpin_serving_epoch(ep)
    if any(w is None for w in whole):
        raise AssertionError("the hot set missed the snapshot cache")

    # ---- the table's ladder: rung 2 at a table epoch's cap, rung 3 below
    table.publish_epoch()
    cap = table.epochs[-1]["cap"].copy()
    commit_round(zipf_distinct(rng, n_keys, SV_WRITE_KEYS), 1)  # head moves
    disp0, slow0 = dict(table.fold_dispatches), table.slow_serves
    rung2_ms = []
    for kk in batch_keys[:10]:
        sync()
        t1 = time.perf_counter()
        res, fresh, complete = table.read_resolved_flat(
            loc[kk, 0], loc[kk, 1], np.broadcast_to(cap, (len(kk), D)))
        sync()
        rung2_ms.append((time.perf_counter() - t1) * 1e3)
    if table.fold_dispatches != disp0 or table.slow_serves != slow0:
        raise AssertionError("rung 2 reads dispatched a fold")
    mid_t = int(total * 0.6)
    mid = np.zeros(D, np.int32)
    mid[0] = mid_t
    cold = np.nonzero(write_t == no_write)[0]
    kk = rng.choice(cold, size=min(batch, len(cold)), replace=False)
    before = ck.LAUNCHES["set_aw_fold"]
    folds0 = table.fold_dispatches.get("kernel_set_aw", 0)
    sync()
    t1 = time.perf_counter()
    res, fresh, complete = table.read_resolved_flat(
        loc[kk, 0], loc[kk, 1], np.broadcast_to(mid, (len(kk), D)))
    sync()
    rung3_ms = (time.perf_counter() - t1) * 1e3
    if (fresh.all() or table.fold_dispatches["kernel_set_aw"] == folds0
            or (on_card and ck.LAUNCHES["set_aw_fold"] == before)):
        raise AssertionError("the rung-3 batch launched no set_aw_fold")
    if not complete.all():
        raise AssertionError("rung 3: incomplete rows")
    top = res["top"].cpu().numpy()
    pos = {}
    for i, k in enumerate(keys.tolist()):
        if lane0[i] <= mid_t:
            pos.setdefault(k, []).append(i)
    for j, k in enumerate(kk.tolist()):
        want = {int(pool_h[vals[i]]) for i in pos.get(k, [])}
        got = {int(h) for h in top[j] if h != 0}
        if got != want:
            raise AssertionError(f"rung 3 key {k}: {got} != {want}")

    # ---- a node's Zipf-hot reads through the value cache ----------------
    node_rec = node_value_cache(torch, dev, cfg)
    out = {
        "populate_s": populate_s, "table_bytes": tbytes,
        "slot_bytes": slot_bytes,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None),
        "copy_bound_ms": copy_bound, "publishes": publishes,
        "epoch_reads": {
            "keys_per_s": batches * batch / read_s,
            "batch_p50_ms": float(np.percentile(lat, 50)),
            "batch_p99_ms": float(np.percentile(lat, 99)),
            "snapshot_cache_hit_share": hits / max(hits + misses, 1),
            "gathers": m.serving_reads.value(path="gather") - gather0,
            "fallbacks": fallbacks, "epochs_seen": len(epochs_seen),
            "write_rounds": w_rounds[0], "values_checked": checked},
        "hot_set": {"keys": SV_HOT, "whole_batch_hits": len(whole),
                    "ms": cache_ms},
        "rung2_ms_p50": float(np.percentile(rung2_ms, 50)),
        "rung3_ms": rung3_ms, "rung3_stale_rows": int((~fresh).sum()),
        "node": node_rec,
        "materializer": store.materializer_status(),
    }
    return out


def node_value_cache(torch, dev, cfg) -> dict:
    """An AntidoteNode whose Zipf-hot static reads go through the decoded
    value cache: 4,096 keys (sets and counters) written against a host
    model, then 20 Zipf batches of 1,024 keys read twice; the hit share
    of the second pass, and its ms against the same batches read cold
    (``drop_cached_value`` first).  Every value equals the host model."""
    import dataclasses

    from antidote_tpu_torch.api import AntidoteNode

    node = AntidoteNode(dataclasses.replace(cfg, keys_per_table=1024),
                        device=dev)
    rng = np.random.default_rng(37)
    n, model = 4096, {}
    for lo in range(0, n, 256):
        ups = []
        for k in range(lo, lo + 256):
            if k % 2:
                model[k] = int(rng.integers(1, 1000))
                ups.append((k, "counter_pn", "b", ("increment", model[k])))
            else:
                model[k] = sorted({int(x) for x in rng.integers(0, 50, 3)},
                                  key=repr)
                ups.append((k, "set_aw", "b", ("add_all", model[k])))
        node.update_objects(ups)
    def objs(kk):
        return [(k, "counter_pn" if k % 2 else "set_aw", "b")
                for k in kk.tolist()]

    batches = [zipf_keys(rng, n, 1024) for _ in range(20)]
    computed = [0]
    orig = node.txm._values_resolved_uncached

    def counting(miss, txn):
        computed[0] += len(miss)
        return orig(miss, txn)

    node.txm._values_resolved_uncached = counting
    passes = {}
    for label in ("first", "warm", "cold"):
        if label == "cold":
            for k in range(n):
                node.store.drop_cached_value((k, "b"))
        computed[0] = 0
        ms = []
        for kk in batches:
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, _ = node.read_objects(objs(kk))
            ms.append((time.perf_counter() - t1) * 1e3)
            for k, v in zip(kk.tolist(), got):
                if v != model[k]:
                    raise AssertionError(f"node key {k}: {v!r}, model "
                                         f"{model[k]!r}")
            if label == "cold":
                for k in kk.tolist():
                    node.store.drop_cached_value((k, "b"))
        passes[label] = {"ms_p50": float(np.percentile(ms, 50)),
                         "hit_share": 1 - computed[0] / (20 * 1024)}
    return passes


def long_log_folds(torch, dev) -> dict:
    """``assoc_fold`` and ``fold_long`` on the card against ``fold_batch``
    on the card, for LL_KEYS keys' logs of LL_OPS ops of each
    assoc-capable type (sets from a bottom base, set_aw adds only); the
    three must be equal.  Returns each fold's ms per type."""
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.materializer import fold, longlog
    from antidote_tpu_torch.materializer.longlog_cases import (ASSOC_TYPES,
                                                               long_log)

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K, set_slots=E)
    out = {}
    for i, name in enumerate(ASSOC_TYPES):
        ty = get_type(name)
        state, ops = long_log(name, np.random.default_rng(40 + i), LL_KEYS,
                              LL_OPS, cfg)
        st = {f: torch.as_tensor(x, device=dev) for f, x in state.items()}
        args = [torch.as_tensor(x, device=dev) for x in ops]
        res, ms = {}, {}
        for label, fn in (
                ("assoc", lambda: longlog.assoc_fold(ty, cfg, st, *args)),
                ("long", lambda: longlog.fold_long(ty, cfg, st, *args,
                                                   chunk=1024)),
                ("serial", lambda: fold.fold_batch(ty, cfg, st, *args))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[label] = fn()
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) * 1e3
        for label in ("assoc", "long"):
            got, want = res[label], res["serial"]
            same = torch.equal(got[1], want[1]) and all(
                torch.equal(got[0][f], want[0][f]) for f in want[0])
            if not same:
                raise AssertionError(f"{name}: {label} fold != fold_batch")
        out[name] = {f"{k}_ms": v for k, v in ms.items()}
        out[name]["applied"] = int(res["serial"][1].sum())
    log(f"long logs: {LL_KEYS} x {LL_OPS}-op logs, assoc and fold_long "
        f"equal fold_batch on the card; {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 4: a 4-member DC on the card
# ---------------------------------------------------------------------------
def cluster_workload(torch, dev, n_shards=CL_SHARDS, n_keys=CL_KEYS,
                     n_removes=CL_REMOVES, n_mixed=CL_MIXED) -> dict:
    """Members over localhost RPC, one process, one card.  Populate: one
    add per key per round, CL_ADDS rounds, in transactions of CL_TXN
    updates from the coordinators in turn; then removes on ``n_removes``
    keys (observed-remove: downstream at the owner).  Mixed: ``n_mixed``
    transactions per coordinator (static cross-member adds,
    read-then-write, removes, read-only at the stable snapshot), every
    start checked to launch ``stable_min``; one first-committer-wins
    abort across members.  Checks: the stable VC never passes the
    sequencer's frontier nor claims a remote lane; every key equals the
    host model at the stable snapshot, and the keys the mixed phase
    touched equal it at the snapshot taken before that phase."""
    from antidote_tpu_torch.api import AbortError
    from antidote_tpu_torch.cluster import ClusterMember
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.materializer import cuda_kernels as ck

    cfg = AntidoteConfig(n_shards=n_shards, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E, keys_per_table=128)
    on_card = torch.device(dev).type == "cuda"
    members = [ClusterMember(cfg, 0, i, CL_MEMBERS, device=dev)
               for i in range(CL_MEMBERS)]
    try:
        for m in members:
            for p in members:
                if p is not m:
                    m.connect(p.member_id, *p.address)
        coords = [m.coordinator() for m in members]
        seq = members[0].seq
        S, Bk = "set_aw", "b"
        rng = np.random.default_rng(17)
        model = {k: set() for k in range(n_keys)}
        fill, gcs = {}, {}
        stats = {"aborts_retried": 0, "starts": 0, "stable_checks": 0}
        last = np.zeros(D, np.int32)  # the client session's causal clock

        def ring(key):  # ring fill per key: a full ring is GC'd first
            f = fill.get(key, 0) + 1
            if f > K:
                gcs[key] = gcs.get(key, 0) + 1
                f = 1
            fill[key] = f

        start_ms = []

        def start(c):
            before = ck.LAUNCHES["stable_min"]
            t1 = time.perf_counter()
            t = coords[c].start_transaction(clock=last)
            start_ms.append((time.perf_counter() - t1) * 1e3)
            stats["starts"] += 1
            if on_card and ck.LAUNCHES["stable_min"] == before:
                raise AssertionError("a transaction start did not launch "
                                     "stable_min")
            return t

        def commit(c, t):
            vc = coords[c].commit_transaction(t)
            np.maximum(last, vc, out=last)
            return vc

        def static(c, ops):
            """A static txn; a certification abort is retried (the
            cluster coordinator certifies every write)."""
            while True:
                t = start(c)
                try:
                    coords[c].update_objects(ops, txn=t)
                    return commit(c, t)
                except AbortError:
                    stats["aborts_retried"] += 1

        def check_stable():
            for m in members:
                m.refresh_peer_clocks()
            for m in members:
                st = m.stable_vc()
                if int(st[0]) > seq.counter or st[1:].any():
                    raise AssertionError(
                        f"member {m.member_id} stable {st} past the "
                        f"frontier {seq.counter} or on a remote lane")
                stats["stable_checks"] += 1

        def check(c, keys, txn=None, want=None):
            want = model if want is None else want
            objs = [(int(k), S, Bk) for k in keys]
            if txn is None:
                t = start(c)
                vals = coords[c].read_objects(objs, txn=t)
                commit(c, t)
            else:
                vals = coords[c].read_objects(objs, txn=txn)
            for k, v in zip(keys, vals):
                if v != sorted(want[int(k)], key=repr):
                    raise AssertionError(
                        f"key {k}: {v!r} != model {sorted(want[int(k)])}")
            return vals

        # ---- populate ---------------------------------------------------
        t0 = time.perf_counter()
        n_txn = 0
        for _ in range(CL_ADDS):
            keys = rng.permutation(n_keys)
            elems = rng.integers(0, 1000, n_keys)
            for lo in range(0, n_keys, CL_TXN):
                kk = keys[lo:lo + CL_TXN].tolist()
                static(n_txn % CL_MEMBERS,
                       [(k, S, Bk, ("add", int(elems[k]))) for k in kk])
                n_txn += 1
                for k in kk:
                    model[k].add(int(elems[k]))
                    ring(k)
        add_s = time.perf_counter() - t0
        rm_keys = rng.choice(n_keys, n_removes, replace=False).tolist()
        for lo in range(0, n_removes, 100):
            ops = [(k, S, Bk, ("remove", min(model[k])))
                   for k in rm_keys[lo:lo + 100]]
            static(n_txn % CL_MEMBERS, ops)
            n_txn += 1
            for k, _, _, (_, e) in ops:
                model[k].discard(e)
                ring(k)
        populate_s = time.perf_counter() - t0
        log(f"cluster populate: {n_txn} txns, "
            f"{CL_ADDS * n_keys + n_removes} ops in {populate_s:.2f} s")
        check_stable()
        old_c = 1 % CL_MEMBERS
        old = start(old_c)  # the snapshot before the mixed phase
        old_model = {k: set(v) for k, v in model.items()}
        old_gcs = dict(gcs)

        # ---- mixed transactions from every coordinator -----------------
        lat = []
        touched = set()

        def mixed(i):
            c, kind = i % CL_MEMBERS, (i // CL_MEMBERS) % 4
            t1 = time.perf_counter()
            if kind == 0:  # cross-member static adds
                kk = rng.choice(n_keys, 8, replace=False).tolist()
                ee = rng.integers(1000, 2000, 8).tolist()
                static(c, [(k, S, Bk, ("add", e)) for k, e in zip(kk, ee)])
                for k, e in zip(kk, ee):
                    model[k].add(e)
            elif kind == 1:  # interactive read-then-write
                kk = rng.choice(n_keys, 4, replace=False).tolist()
                t = start(c)
                vals = check(c, kk, txn=t)
                ee = [2000 + len(v) for v in vals]
                coords[c].update_objects(
                    [(k, S, Bk, ("add", e)) for k, e in zip(kk, ee)], txn=t)
                commit(c, t)
                for k, e in zip(kk, ee):
                    model[k].add(e)
            elif kind == 2:  # observed-remove at the owners
                kk = [k for k in rng.choice(n_keys, 3, replace=False).tolist()
                      if model[k]]
                ops = [(k, S, Bk, ("remove", max(model[k]))) for k in kk]
                static(c, ops)
                for k, _, _, (_, e) in ops:
                    model[k].discard(e)
            else:  # read-only at the stable snapshot
                kk = rng.choice(n_keys, 16, replace=False).tolist()
                check(c, kk)
            lat.append((time.perf_counter() - t1) * 1e3)
            if kind != 3:
                for k in kk:
                    touched.add(k)
                    ring(k)

        # the timed window holds the transactions only: the stable checks
        # between them (gossip rounds) stay outside it
        n_mixed_txns = n_mixed * CL_MEMBERS
        start_ms.clear()
        mixed_s = 0.0
        for i in range(n_mixed_txns):
            t0 = time.perf_counter()
            mixed(i)
            mixed_s += time.perf_counter() - t0
            if i % 16 == 15:
                check_stable()
        start_p = [float(np.percentile(start_ms, q)) for q in (50, 99)]
        window = range(n_mixed_txns, n_mixed_txns + 16)
        profile = None
        if on_card:
            profile = profile_window(torch, mixed, window)
        else:
            for i in window:
                mixed(i)
        n_mixed_txns += len(window)
        # one first-committer-wins abort across members: two coordinators
        # read-then-write one key that a third member owns
        key = next(k for k in range(n_keys)
                   if k % n_shards % CL_MEMBERS == 2 % CL_MEMBERS)
        ta, tb = start(0), start(1 % CL_MEMBERS)
        for c, t in ((0, ta), (1 % CL_MEMBERS, tb)):
            check(c, [key], txn=t)
            coords[c].update_objects([(key, S, Bk, ("add", 5000 + c))],
                                     txn=t)
        commit(0, ta)
        model[key].add(5000)
        touched.add(key)
        ring(key)
        try:
            commit(1 % CL_MEMBERS, tb)
            raise AssertionError("the second racing txn committed")
        except AbortError:
            pass
        log(f"cluster mixed: {n_mixed_txns + 2} txns; the racing txn "
            "aborted")
        types_stats = cluster_types_segment(coords, start, commit, static,
                                            check_stable)

        # ---- checks: every key at the stable snapshot, the touched keys
        # at the old one -------------------------------------------------
        check_stable()
        for lo in range(0, n_keys, 16384):
            check(lo // 16384 % CL_MEMBERS,
                  range(lo, min(lo + 16384, n_keys)))
        hist = sorted(k for k in touched
                      if gcs.get(k, 0) == old_gcs.get(k, 0))
        check(old_c, hist, txn=old, want=old_model)
        commit(old_c, old)
        log(f"cluster: {n_keys} keys match the model; {len(hist)} keys "
            "read at the older snapshot")
        pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
        return {
            "members": CL_MEMBERS, "shards": n_shards, "keys": n_keys,
            "populate_txns": n_txn, "populate_add_s": add_s,
            "populate_s": populate_s,
            "mixed_timed_txns": n_mixed * CL_MEMBERS, "mixed_s": mixed_s,
            "mixed_txns_per_s": n_mixed * CL_MEMBERS / mixed_s,
            "txn_p50_ms": pct(lat[:n_mixed * CL_MEMBERS], 50),
            "txn_p99_ms": pct(lat[:n_mixed * CL_MEMBERS], 99),
            "start_p50_ms": start_p[0], "start_p99_ms": start_p[1],
            "profile": profile,
            "historical_keys": len(hist), "sequencer_ts": seq.counter,
            "types_segment": types_stats,
            "resident_gib": (torch.cuda.memory_allocated(dev) / 2**30
                             if on_card else None),
            **stats,
        }
    finally:
        for m in members:
            m.close()


# ---------------------------------------------------------------------------
# phase 5: the other device types and the composites
# ---------------------------------------------------------------------------
def table_bytes(t) -> int:
    """Device bytes of a TypedTable's tensors."""
    tensors = list(t.snap.values()) + list(t.head.values()) + [
        t.snap_vc, t.snap_seq, t.ops_a, t.ops_b, t.ops_vc, t.ops_origin,
        t.head_vc]
    return sum(x.numel() * x.element_size() for x in tensors)


def types_tables(torch, dev, n_keys=TY_KEYS) -> dict:
    """Each of the nine device types as one TypedTable of ``n_keys`` keys at
    BASELINE widths, on the card and, by the same appends, on the CPU:
    a seeded three-lane stream with concurrent clocks
    (``type_cases.populate_stream``, TY_ROUNDS ops a key, so every ring
    GCs once), then resolved reads of every key in batches of B at the
    final clock (fresh: head gathers) and at the cut after TY_CUT rounds
    (historical: the ring fold over the GC'd version).  The card's reads
    must equal the CPU's exactly and be complete.  Returns, per type,
    populate seconds, fresh and historical keys/s and the table's bytes
    (card), and the CPU twin's populate seconds."""
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.crdt.type_cases import (DEVICE_TYPES,
                                                    populate_stream)
    from antidote_tpu_torch.store import TypedTable

    p = TY_SHARDS
    cfg = AntidoteConfig(n_shards=p, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E, mv_slots=MV_SLOTS,
                         rga_slots=RGA_SLOTS, keys_per_table=n_keys // p)
    cpu = torch.device("cpu")
    keys = np.arange(n_keys)
    out = {}
    for i, name in enumerate(DEVICE_TYPES):
        st = populate_stream(name, np.random.default_rng(100 + i), n_keys,
                             TY_ROUNDS, cfg)
        cuts = {"fresh": st["cum"][-1],
                "historical": st["cum"][TY_CUT * n_keys - 1]}
        runs = {}
        for where, d in (("card", torch.device(dev)), ("cpu", cpu)):
            sync = (torch.cuda.synchronize if d.type == "cuda"
                    else (lambda: None))
            t = TypedTable(get_type(name), cfg, device=d)
            t.used_rows[:] = n_keys // p
            t0 = time.perf_counter()
            for lo in range(0, len(st["keys"]), B):
                sl = slice(lo, lo + B)
                k = st["keys"][sl]
                t.append(k % p, k // p, st["eff_a"][sl], st["eff_b"][sl],
                         st["vcs"][sl], st["origins"][sl])
            sync()
            run = {"populate_s": time.perf_counter() - t0,
                   "bytes": table_bytes(t)}
            disp0 = dict(t.fold_dispatches)
            for kind, vc in cuts.items():
                vcs = np.broadcast_to(vc, (B, D))
                secs, parts, stale = 0.0, [], 0
                for lo in range(0, n_keys, B):
                    kk = keys[lo:lo + B]
                    t1 = time.perf_counter()
                    res, fresh, complete = t.read_resolved_flat(
                        kk % p, kk // p, vcs[:len(kk)])
                    sync()
                    secs += time.perf_counter() - t1
                    if not complete.all():
                        raise AssertionError(
                            f"{name} {kind} read on {where}: incomplete rows")
                    stale += int((~fresh).sum())
                    parts.append({f: x.cpu().numpy() for f, x in res.items()})
                run[kind] = {f: np.concatenate([x[f] for x in parts])
                             for f in parts[0]}
                run[f"{kind}_keys_per_s"] = n_keys / secs
                run[f"{kind}_stale_rows"] = stale
            run["fold_dispatches"] = {
                k: n - disp0.get(k, 0) for k, n in t.fold_dispatches.items()}
            if d.type == "cuda":
                # where a historical batch's time goes (serial fold, plain
                # resolve): device busy share and the top device kernels
                hv = np.broadcast_to(cuts["historical"], (B, D))

                def hist_batch(j):
                    kk = keys[j * B:(j + 1) * B]
                    return t.read_resolved_flat(kk % p, kk // p,
                                                hv[:len(kk)])

                run["historical_profile"] = profile_window(
                    torch, hist_batch, range(2))
            runs[where] = run
            del t
            if d.type == "cuda":
                torch.cuda.empty_cache()
        card, host = runs["card"], runs["cpu"]
        for kind in cuts:
            for f, want in host[kind].items():
                if not np.array_equal(card[kind][f], want):
                    bad = int((card[kind][f] != want).reshape(n_keys, -1)
                              .any(-1).sum())
                    raise AssertionError(
                        f"{name} {kind} {f}: {bad} keys differ from the CPU")
        if card["historical_stale_rows"] == 0:
            raise AssertionError(f"{name}: the historical cut folded no row")
        rec = {k: v for k, v in card.items() if k not in cuts}
        rec["cpu_populate_s"] = host["populate_s"]
        out[name] = rec
        log(f"types {name}: {n_keys} keys equal to the CPU twin, fresh and "
            f"historical; {json.dumps(rec)}")
    return out


def _expect(ftype, v):
    """A host model entry as the node returns it: sets sorted by repr, maps
    as dicts of their fields' expectations."""
    if ftype in ("set_aw", "set_rw", "set_go", "register_mv"):
        return sorted(v, key=repr)
    if ftype in ("map_rr", "map_go"):
        return {(f, ft): _expect(ft, x) for (f, ft), x in v.items()}
    return v


def types_node_session(dev) -> dict:
    """An AntidoteNode on the card over the other types and the maps,
    checked against a host model: ``bench_suite.py``'s map workload (400
    map_rr maps of counter_pn, register_lww and set_aw fields, here with a
    nested map_rr field too), field removes and an add-wins re-add, reads
    of every map at an older snapshot (map_rr memberships through
    ``set_aw_fold``, counter fields through ``counter_fold``); its rga
    workload (60 documents of 15 inserts each, single DC) with deletes and
    head inserts; counter_b spends inside and past the held rights (a
    typed refusal, the value never negative); counter_fat resets, both
    flags, set_rw and set_go, concurrent writers; and set_rw, register_mv
    and rga keys promoted past their slot widths."""
    import copy

    from antidote_tpu_torch.api import AbortError, AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.overload import InsufficientRightsError

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E, mv_slots=MV_SLOTS,
                         rga_slots=RGA_SLOTS, keys_per_table=4096)
    node = AntidoteNode(cfg, device=dev)
    rng = np.random.default_rng(23)
    Bk, M = "b", "map_rr"
    nocert = {"certify": False}
    model = {}  # (key, type) -> host value
    upd, start, commit = (node.update_objects, node.start_transaction,
                          node.commit_transaction)
    stats = {"txns": 0, "refusals": 0, "aborts": 0}

    def static(ups):
        stats["txns"] += 1
        return upd(ups)

    def check(objs, where, txn=None, want=None):
        want = model if want is None else want
        vals = (node.read_objects([(k, t, Bk) for k, t in objs], txn=txn)
                if txn is not None else
                node.read_objects([(k, t, Bk) for k, t in objs])[0])
        for (k, t), v in zip(objs, vals):
            w = _expect(t, want[(k, t)])
            if v != w:
                raise AssertionError(f"{where}: {k} ({t}) = {v!r}, want {w!r}")

    t0 = time.perf_counter()
    # ---- maps: bench_suite.py's map workload, with a nested map -----------
    n_maps = 400
    maps = [(f"m{i}", M) for i in range(n_maps)]
    for i in range(n_maps):
        static([(f"m{i}", M, Bk, ("update", {
            ("clicks", "counter_pn"): ("increment", i + 1),
            ("name", "register_lww"): ("assign", f"user{i}"),
            ("tags", "set_aw"): ("add", f"t{i % 7}"),
            ("meta", M): ("update", {("visits", "counter_pn"):
                                     ("increment", 1),
                                     ("seen", "flag_ew"): ("enable", None)}),
        }))])
        model[(f"m{i}", M)] = {
            ("clicks", "counter_pn"): i + 1,
            ("name", "register_lww"): f"user{i}",
            ("tags", "set_aw"): {f"t{i % 7}"},
            ("meta", M): {("visits", "counter_pn"): 1,
                          ("seen", "flag_ew"): True}}
    check(maps, "maps populate")
    old = start()
    old_model = copy.deepcopy(model)
    for i in range(0, n_maps, 2):
        static([(f"m{i}", M, Bk, ("update", {
            ("clicks", "counter_pn"): ("increment", 5),
            ("tags", "set_aw"): ("add", f"x{i}")}))])
        m = model[(f"m{i}", M)]
        m[("clicks", "counter_pn")] += 5
        m[("tags", "set_aw")].add(f"x{i}")
    for i in range(0, n_maps, 10):  # field removes
        static([(f"m{i}", M, Bk, ("remove", ("name", "register_lww")))])
        del model[(f"m{i}", M)][("name", "register_lww")]
    for i in range(1, n_maps, 40):
        # a remove and a concurrent update of one field, uncertified: the
        # update's membership add wins, the remove reset the old tags
        ta, tb = start(props=nocert), start(props=nocert)
        upd([(f"m{i}", M, Bk, ("update", {("tags", "set_aw"):
                                          ("add", "w")}))], txn=ta)
        upd([(f"m{i}", M, Bk, ("remove", ("tags", "set_aw")))], txn=tb)
        commit(tb)
        commit(ta)
        stats["txns"] += 2
        model[(f"m{i}", M)][("tags", "set_aw")] = {"w"}
    for i in range(0, n_maps, 20):  # a removed field re-added
        static([(f"m{i}", M, Bk, ("update", {("name", "register_lww"):
                                             ("assign", "back")}))])
        model[(f"m{i}", M)][("name", "register_lww")] = "back"
    check(maps, "maps at the older snapshot", txn=old, want=old_model)
    commit(old)
    check(maps, "maps latest")

    # ---- rga: bench_suite.py's documents (single DC) ----------------------
    docs = [(f"doc{d}", "rga") for d in range(60)]
    for key, _ in docs:
        doc = ["@"]
        static([(key, "rga", Bk, ("insert", (0, "@")))])
        ins = [(key, "rga", Bk, ("insert", (1, f"{key}:{j}")))
               for j in range(15)]
        static(ins)
        for j in range(15):
            doc.insert(1, f"{key}:{j}")
        k = int(rng.integers(0, len(doc)))
        static([(key, "rga", Bk, ("delete", k)),
                (key, "rga", Bk, ("insert", (0, "^")))])
        del doc[k]
        doc.insert(0, "^")
        model[(key, "rga")] = doc
    check(docs, "rga documents")

    # ---- counter_b: spends inside and past the rights ---------------------
    cbs = [(f"cb{i}", "counter_b") for i in range(10)]
    for key, _ in cbs:
        static([(key, "counter_b", Bk, ("increment", (100, 0)))])
        for _ in range(3):
            static([(key, "counter_b", Bk, ("decrement", (30, 0)))])
        model[(key, "counter_b")] = 10
        try:
            static([(key, "counter_b", Bk, ("decrement", (20, 0)))])
            raise AssertionError(f"{key}: a spend past the rights committed")
        except InsufficientRightsError:
            stats["refusals"] += 1
    # a commit group in which the first spend fits and the others do not
    group = [start(props=nocert) for _ in range(3)]
    for t in group:
        upd([("cb0", "counter_b", Bk, ("decrement", (6, 0)))], txn=t)
    res = node.txm.commit_transactions_group(group)
    stats["txns"] += 3
    if not (isinstance(res[0], np.ndarray)
            and all(isinstance(r, InsufficientRightsError) for r in res[1:])):
        raise AssertionError(f"escrow group: {res}")
    stats["refusals"] += 2
    model[("cb0", "counter_b")] = 4
    try:
        static([("cb1", "counter_b", Bk, ("decrement", (1, 1)))])
        raise AssertionError("a spend on another DC's lane committed")
    except AbortError:
        stats["aborts"] += 1
    check(cbs, "counter_b")
    if any(model[o] < 0 for o in cbs):
        raise AssertionError("a counter_b model value went negative")

    # ---- counter_fat, flags, set_rw, set_go ------------------------------
    for i in range(10):
        f, ew, dw = f"fat{i}", f"ew{i}", f"dw{i}"
        rw, go = f"rw{i}", f"go{i}"
        static([(f, "counter_fat", Bk, ("increment", 7 + i)),
                (ew, "flag_ew", Bk, ("enable", None)),
                (dw, "flag_dw", Bk, ("enable", None)),
                (rw, "set_rw", Bk, ("add_all", [1, 2, 3])),
                (go, "set_go", Bk, ("add_all", [i, i + 1]))])
        static([(f, "counter_fat", Bk, ("reset", None)),
                (rw, "set_rw", Bk, ("remove", 2))])
        static([(f, "counter_fat", Bk, ("increment", i)),
                (go, "set_go", Bk, ("add", 99))])
        # concurrent uncertified writers: enable vs disable, add vs remove
        ta, tb = start(props=nocert), start(props=nocert)
        upd([(ew, "flag_ew", Bk, ("enable", None)),
             (dw, "flag_dw", Bk, ("enable", None)),
             (rw, "set_rw", Bk, ("add", 3))], txn=ta)
        upd([(ew, "flag_ew", Bk, ("disable", None)),
             (dw, "flag_dw", Bk, ("disable", None)),
             (rw, "set_rw", Bk, ("remove", 3))], txn=tb)
        commit(ta)
        commit(tb)
        stats["txns"] += 5
        model.update({(f, "counter_fat"): i, (ew, "flag_ew"): True,
                      (dw, "flag_dw"): False, (rw, "set_rw"): {1},
                      (go, "set_go"): {i, i + 1, 99}})
    small = [o for o in model if o[1] in ("counter_fat", "flag_ew", "flag_dw",
                                          "set_rw", "set_go")]
    check(small, "counter_fat, flags, set_rw, set_go")

    # ---- slot promotion past the widths ----------------------------------
    static([("rwbig", "set_rw", Bk, ("add_all", list(range(40))))])
    static([("rwbig", "set_rw", Bk, ("remove_all", list(range(0, 40, 3))))])
    model[("rwbig", "set_rw")] = set(range(40)) - set(range(0, 40, 3))
    static([("mvbig", "register_mv", Bk, ("assign", "base"))])
    ts = [start(props=nocert) for _ in range(6)]
    for j, t in enumerate(ts):
        upd([("mvbig", "register_mv", Bk, ("assign", f"v{j}"))], txn=t)
    for t in ts:
        commit(t)
    stats["txns"] += 6
    model[("mvbig", "register_mv")] = {f"v{j}" for j in range(6)}
    # rga: a transaction's own inserts overlay the key at its current
    # width, so the inserts past RGA_SLOTS come one a transaction
    long_doc = []
    for r in range(RGA_SLOTS // 16 + 30):
        ups = []
        for j in range(15 if len(long_doc) + 15 <= RGA_SLOTS else 1):
            idx = int(rng.integers(0, len(long_doc) + 1))
            ups.append(("long", "rga", Bk, ("insert", (idx, f"L{r}.{j}"))))
            long_doc.insert(idx, f"L{r}.{j}")
        static(ups)
    model[("long", "rga")] = long_doc
    check([("rwbig", "set_rw"), ("mvbig", "register_mv"), ("long", "rga")],
          "promoted keys")
    promoted = sorted(n for n in node.store.tables if "#" in n)
    for base in ("set_rw", "register_mv", "rga"):
        if not any(n.startswith(base + "#") for n in promoted):
            raise AssertionError(f"no {base} key was promoted: {promoted}")
    session_s = time.perf_counter() - t0
    check(list(model), "every key, latest")
    log(f"types session: {stats['txns']} txns, {len(model)} keys match the "
        f"host model; promoted tables {promoted}")
    return {**stats, "session_s": session_s, "keys": len(model),
            "promotions": node.store.promotions, "promoted_tables": promoted,
            "fold_dispatches": {n: dict(t.fold_dispatches)
                                for n, t in node.store.tables.items()
                                if t.fold_dispatches}}


def cluster_types_segment(coords, start, commit, static, check_stable,
                          n_maps=32, n_docs=16, n_cb=8) -> dict:
    """Maps, rga and counter_b across the members, against a host model:
    map_rr maps with nested fields updated from every coordinator and a
    field removed from another, rga documents edited in interactive
    transactions (inserts and deletes, read-your-writes through the
    owners' overlays), counter_b spends at the key's owner (one past the
    lane's rights aborts, the value unchanged).  Every key is read back
    from every coordinator."""
    from antidote_tpu_torch.api import AbortError

    n_c = len(coords)
    Bk, M = "b", "map_rr"
    model = {}
    t0 = time.perf_counter()
    for i in range(n_maps):
        static(i % n_c, [(f"cm{i}", M, Bk, ("update", {
            ("clicks", "counter_pn"): ("increment", i + 1),
            ("tags", "set_aw"): ("add_all", [f"t{i}", "all"]),
            ("meta", M): ("update", {("n", "counter_fat"):
                                     ("increment", 2)})}))])
        model[(f"cm{i}", M)] = {
            ("clicks", "counter_pn"): i + 1,
            ("tags", "set_aw"): {f"t{i}", "all"},
            ("meta", M): {("n", "counter_fat"): 2}}
    for i in range(0, n_maps, 4):
        static((i + 1) % n_c, [(f"cm{i}", M, Bk, ("remove",
                                                   ("tags", "set_aw")))])
        del model[(f"cm{i}", M)][("tags", "set_aw")]
    for d in range(n_docs):
        c, key = d % n_c, f"cdoc{d}"
        t = start(c)
        coords[c].update_objects([(key, "rga", Bk, ("insert", (0, "a"))),
                                  (key, "rga", Bk, ("insert", (1, "b"))),
                                  (key, "rga", Bk, ("insert", (1, "c")))],
                                 txn=t)
        coords[c].update_objects([(key, "rga", Bk, ("delete", 0))], txn=t)
        got = coords[c].read_objects([(key, "rga", Bk)], txn=t)[0]
        if got != ["c", "b"]:
            raise AssertionError(f"{key} read-your-writes: {got}")
        commit(c, t)
        static((c + 1) % n_c, [(key, "rga", Bk, ("insert", (2, f"z{d}")))])
        model[(key, "rga")] = ["c", "b", f"z{d}"]
    refused = 0
    for i in range(n_cb):
        key = f"ccb{i}"
        static(i % n_c, [(key, "counter_b", Bk, ("increment", (50, 0)))])
        static((i + 1) % n_c, [(key, "counter_b", Bk,
                                ("decrement", (20, 0)))])
        t = start((i + 2) % n_c)
        try:
            coords[(i + 2) % n_c].update_objects(
                [(key, "counter_b", Bk, ("decrement", (40, 0)))], txn=t)
            raise AssertionError(f"{key}: a spend past the rights went "
                                 "through")
        except AbortError:
            refused += 1
        model[(key, "counter_b")] = 30
    check_stable()
    objs = sorted(model, key=repr)
    for c in range(n_c):
        t = start(c)
        vals = coords[c].read_objects([(k, ty, Bk) for k, ty in objs],
                                      txn=t)
        commit(c, t)
        for (k, ty), v in zip(objs, vals):
            if v != _expect(ty, model[(k, ty)]):
                raise AssertionError(f"cluster {k} ({ty}) from coordinator "
                                     f"{c}: {v!r} != {model[(k, ty)]!r}")
    log(f"cluster types: {len(objs)} map, rga and counter_b keys match the "
        f"model from every coordinator; {refused} spends refused")
    return {"keys": len(objs), "refused": refused,
            "segment_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 6: durability — WAL, checkpoints with a delta link, recovery
# ---------------------------------------------------------------------------
def _ms_pcts(ms) -> dict:
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))}


def _commit_group(node, updates_per_txn) -> list:
    """One commit group through the manager: one transaction per update
    list, one WAL append per touched shard, one barrier.  Raises on any
    refused member; returns the members' commit VCs."""
    txm = node.txm
    txns = []
    for ups in updates_per_txn:
        t = txm.start_transaction()
        txm.update_objects(ups, t)
        txns.append(t)
    out = txm.commit_transactions_group(txns)
    bad = [r for r in out if isinstance(r, Exception)]
    if bad:
        raise AssertionError(f"{len(bad)} commits refused: {bad[0]!r}")
    return out


def _recovery_digest(node) -> dict:
    """``tests/test_checkpoint.py``'s recovery digest."""
    return {"op_ids": node.store.log.op_ids.tolist(),
            "seqs": node.store.log.seqs.tolist(),
            "stable": [int(x) for x in node.stable_vc()],
            "commit_counter": int(node.txm.commit_counter),
            "keys": len(node.store.directory)}


def _read_all(node, objs, vc=None, batch=B) -> list:
    """Values of ``objs`` in batches: latest (``vc`` None) or at ``vc``."""
    out = []
    for lo in range(0, len(objs), batch):
        part = objs[lo:lo + batch]
        if vc is None:
            out.extend(node.read_objects(part)[0])
            continue
        txn = node.start_transaction()
        txn.snapshot_vc = np.asarray(vc, np.int32)
        try:
            out.extend(node.read_objects(part, txn))
        finally:
            node.abort_transaction(txn)
    return out


def _heads_equal(torch, live, rec) -> dict:
    """Each table's head fields and head_vc at every row the directory
    references, live against recovered (``torch.equal``); returns the rows
    compared per table and the keys the recovery placed elsewhere.  Rows a
    promotion vacated after the full image keep its bytes in the recovered
    table (the JAX package's install does the same), and no key references
    them.  A replay that applies several commits of a slotted key in one
    batch may promote it where the live node did not (both packages do):
    such a key is counted, and the fresh value check covers it."""
    by_table, moved = {}, 0
    for dk, loc in live.store.directory.items():
        if rec.store.directory.get(dk) != loc:
            moved += 1
            continue
        by_table.setdefault(loc[0], []).append(loc[1:])
    rows = {}
    for tname, pairs in by_table.items():
        lt, rt = live.store.tables[tname], rec.store.tables[tname]
        idx = torch.as_tensor(np.asarray(pairs, np.int64).T,
                              device=lt.device)
        for f in lt.head:
            if not torch.equal(lt.head[f][idx[0], idx[1]],
                               rt.head[f][idx[0], idx[1]]):
                raise AssertionError(f"{tname}.head[{f}] differs")
        if not torch.equal(lt.head_vc[idx[0], idx[1]],
                           rt.head_vc[idx[0], idx[1]]):
            raise AssertionError(f"{tname}.head_vc differs")
        rows[tname] = len(pairs)
    return {"rows": rows, "relocated_keys": moved}


def durable_phase(torch, dev, n_set=DU_SET_KEYS, n_ctr=DU_CTR_KEYS,
                  rounds=DU_ROUNDS, tail_rounds=DU_TAIL_ROUNDS,
                  round_keys=SV_ROUND_KEYS, group=DU_GROUP,
                  ladder_long=DU_LADDER_LONG, fold_chunk=1024,
                  keep=None, zipf_batches=CO_BATCHES,
                  zipf_batch=B) -> dict:
    """A durable ``AntidoteNode`` at BASELINE's configuration, all on the
    card: populate ``n_set`` ``set_aw`` keys (2 adds each, elements from a
    4,096-value pool, removes on 10%) and ``n_ctr`` ``counter_pn`` keys (2
    increments) through the manager in commit groups; a full checkpoint;
    ``rounds`` rounds of ``round_keys`` Zipf-distinct keys then a delta
    link, taken while a second thread commits 256-key rounds; a WAL tail of
    ``tail_rounds`` rounds over keys no round touched before; reference
    reads from the live node (every key fresh, every tail key at the clock
    after half the tail, the recovery digest); then ``recover=True`` on the
    card, which must equal the live node in digest, values and heads, raise
    the compaction-horizon error below the full image's stamp and mint a
    clock above the old ones.  Then the replay-read ladder on a small node
    in its own directory (long logs read at old clocks: ``assoc``,
    ``serial``, ``long``, held to a host model, and a whole-log recovery of
    that directory), and commit latency under ``sync_log`` false and
    true.

    The node carries a cold tier without a budget, so its full image
    writes the cold sidecar beside the image.  With ``keep`` (a dict) the
    log directory outlives the phase for the cold phase, which deletes it:
    ``keep`` receives the directory, the configuration, every object and
    its value after the phase's last write, and the batch times of the
    cold phase's Zipf reads on the recovered node, all of whose rows are
    resident."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=max(n_set // 8, 1024),
                         sync_log=False, wal_segments=1)
    on_card = torch.device(dev).type == "cuda"
    root = tempfile.mkdtemp(prefix="antidote_durable_")
    out = {"filesystem": " ".join(subprocess.run(
        ["df", "-T", root], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[-1].split())}
    log(f"durable: log directory on {out['filesystem']}")
    try:
        d = os.path.join(root, "main")
        node = AntidoteNode(cfg, log_dir=d, device=dev)
        if not all(seg.native for w in node.store.log.wals
                   for seg in w.segs):
            raise AssertionError("the WAL runs the Python writer, not the "
                                 "native one")
        rng = np.random.default_rng(41)
        pool = rng.permutation(SV_POOL)
        S, C = "s", "c"

        def sk(k):
            return (int(k), "set_aw", S)

        def ck(k):
            return (int(k), "counter_pn", C)

        # ---- populate ---------------------------------------------------
        # transactions of 16 set keys (32 adds), 64 removes, 32 counter
        # keys (64 increments)
        t0 = time.perf_counter()
        elems = rng.integers(0, SV_POOL, (n_set, 2))
        for lo in range(0, n_set, group * 16):
            ups = [(k, "set_aw", S, ("add_all", [int(elems[k, 0]),
                                                  int(elems[k, 1])]))
                   for k in range(lo, min(lo + group * 16, n_set))]
            _commit_group(node, [ups[j:j + 16]
                                 for j in range(0, len(ups), 16)])
        # each remove's downstream reads its key's state at the snapshot
        rm = rng.choice(n_set, n_set // 10, replace=False)
        rm_ups = [(int(k), "set_aw", S, ("remove", int(elems[k, 0])))
                  for k in rm]
        for lo in range(0, len(rm_ups), group * 64):
            part = rm_ups[lo:lo + group * 64]
            _commit_group(node, [part[j:j + 64]
                                 for j in range(0, len(part), 64)])
        incs = rng.integers(1, 100, (n_ctr, 2))
        ctr_ups = [(k, "counter_pn", C, ("increment", int(incs[k, i])))
                   for k in range(n_ctr) for i in (0, 1)]
        for lo in range(0, len(ctr_ups), group * 64):
            part = ctr_ups[lo:lo + group * 64]
            _commit_group(node, [part[j:j + 64]
                                 for j in range(0, len(part), 64)])
        if on_card:
            torch.cuda.synchronize()
        out["populate_s"] = time.perf_counter() - t0
        out["wal_records"] = int(node.store.log.seqs.sum())
        log(f"durable: populated {out['wal_records']} records in "
            f"{out['populate_s']:.1f} s")
        # ---- full checkpoint -------------------------------------------
        node.enable_cold_tier(0)  # no budget: the image writes a sidecar
        node.start_checkpointer(interval_s=0.0, rebase_every=64)
        full = node.checkpoint_now(full=True)
        # the bytes the stamp's clones move: each table's heads up to its
        # own used rows (the extent ``copy_head`` copies), read and written
        head_bytes = sum(
            x[:, :int(t.used_rows.max())].numel() * x.element_size()
            for t in node.store.tables.values()
            for x in list(t.head.values()) + [t.head_vc])
        clone_ms = None
        if on_card:
            # the device work the stamp issues (every table's head copy),
            # timed alone by CUDA events, L2 flushed
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            clone_ms = time_ms(torch, lambda: [
                t.copy_head(int(t.used_rows.max()))
                for t in node.store.tables.values()], 5, flush)
            del flush
        out["full"] = {"stamp_ms": full["held_ms"],
                       "barrier_ms": full["barrier_ms"],
                       "clone_ms": clone_ms,
                       "stamp_bound_ms": 2 * head_bytes / HBM_BYTES_PER_S
                       * 1e3,
                       "total_s": full["total_s"],
                       "image_bytes": full["image_bytes"],
                       "image_mb_s": full["image_bytes"] / 1e6
                       / full["total_s"],
                       "reclaimed_bytes": full["reclaimed_bytes"],
                       "sidecar_bytes": full["cold"]["bytes"],
                       "rows": full["n_rows"]}
        full_stamp = np.asarray(node.store.applied_vc.max(axis=0))
        log(f"durable: full checkpoint {json.dumps(out['full'])}")
        # ---- delta rounds, then a delta link beside a writer thread ----
        # the tail's keys are set aside first: no round touches them, so
        # each holds at most 3 + 1 ops and every tail read at the mid clock
        # stays inside the device's coverage on both nodes
        n_tail = min(tail_rounds * round_keys, n_set // 4)
        tail_keys = rng.choice(n_set, n_tail, replace=False)
        tail_ctrs = rng.choice(n_ctr, min(tail_rounds * 256, n_ctr // 4),
                               replace=False)
        hot = np.setdiff1d(np.arange(n_set), tail_keys)
        hot_c = np.setdiff1d(np.arange(n_ctr), tail_ctrs)
        rng.shuffle(hot)
        rng.shuffle(hot_c)

        def round_ups(keys, ctrs):
            """One op a key: an add (16 a transaction), or on 10% a remove
            (64 a transaction); one increment a counter (64 a
            transaction)."""
            adds, rms = [], []
            for k in keys.tolist():
                if rng.random() < 0.1:
                    rms.append((k, "set_aw", S, ("remove",
                                                 int(elems[k, 1]))))
                else:
                    adds.append((k, "set_aw", S, ("add", int(
                        pool[rng.integers(0, SV_POOL)]))))
            incs = [(k, "counter_pn", C, ("increment", 1))
                    for k in ctrs.tolist()]
            return ([adds[j:j + 16] for j in range(0, len(adds), 16)]
                    + [rms[j:j + 64] for j in range(0, len(rms), 64)]
                    + [incs[j:j + 64] for j in range(0, len(incs), 64)])

        for _ in range(rounds):
            _commit_group(node, round_ups(
                hot[zipf_distinct(rng, len(hot), round_keys)],
                hot_c[zipf_distinct(rng, len(hot_c), 256)]))
        stop = threading.Event()
        writer = {"rounds": 0, "error": None}

        def write_beside():
            wr = np.random.default_rng(43)
            try:
                while not stop.is_set():
                    kk = hot[wr.choice(len(hot), 256, replace=False)]
                    _commit_group(node, [[(int(k), "set_aw", S, (
                        "add", int(pool[wr.integers(0, SV_POOL)])))]
                        for k in kk])
                    writer["rounds"] += 1
            except Exception as e:  # surfaced below
                writer["error"] = e

        th = threading.Thread(target=write_beside, daemon=True)
        th.start()
        time.sleep(0.2)
        delta = node.checkpoint_now(full=False)
        stop.set()
        th.join(timeout=120)
        if th.is_alive() or writer["error"] is not None:
            raise AssertionError(f"the writer beside the checkpoint: "
                                 f"{writer['error']!r}")
        if delta["kind"] != "delta":
            raise AssertionError(f"the link is a {delta['kind']} image")
        out["delta"] = {"stamp_ms": delta["held_ms"],
                        "barrier_ms": delta["barrier_ms"],
                        "total_s": delta["total_s"],
                        "ms": delta["total_s"] * 1e3,
                        "image_bytes": delta["image_bytes"],
                        "rows": delta["n_rows"], "keys": delta["n_keys"],
                        "writer_rounds": writer["rounds"]}
        log(f"durable: delta link {json.dumps(out['delta'])}")
        # ---- the WAL tail ----------------------------------------------
        per = max(len(tail_keys) // tail_rounds, 1)
        per_c = max(len(tail_ctrs) // tail_rounds, 1)
        vc_mid = None
        for i in range(tail_rounds):
            vcs = _commit_group(node, round_ups(
                tail_keys[i * per:(i + 1) * per],
                tail_ctrs[i * per_c:(i + 1) * per_c]))
            if i == tail_rounds // 2 - 1:
                vc_mid = np.asarray(vcs[-1]).copy()
        # ---- reference reads from the live node ------------------------
        all_objs = ([sk(k) for k in range(n_set)]
                    + [ck(k) for k in range(n_ctr)])
        tail_objs = ([sk(k) for k in tail_keys]
                     + [ck(k) for k in tail_ctrs])
        t1 = time.perf_counter()
        want_fresh = _read_all(node, all_objs)
        out["live_read_keys_s"] = len(all_objs) / (time.perf_counter() - t1)
        want_mid = _read_all(node, tail_objs, vc_mid)
        want_digest = _recovery_digest(node)
        live_counter = node.txm.commit_counter
        node.store.log.close()
        # ---- recover on the card ---------------------------------------
        from antidote_tpu_torch.materializer import cuda_kernels as ck_mod

        t2 = time.perf_counter()
        rec = AntidoteNode(cfg, log_dir=d, recover=True, device=dev)
        if on_card:
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t2
        m = rec.metrics
        tail_s = m.recovery_seconds.value(phase="tail")
        out["recovery"] = {
            "total_s": rec_s,
            "checkpoint_s": m.recovery_seconds.value(phase="checkpoint"),
            "tail_s": tail_s,
            "records": rec.store.last_recovery_records,
            "tail_records_s": rec.store.last_recovery_records / tail_s}
        log(f"durable: recovery {json.dumps(out['recovery'])}")
        if _recovery_digest(rec) != want_digest:
            raise AssertionError(f"recovery digest {_recovery_digest(rec)} "
                                 f"!= live {want_digest}")
        if _read_all(rec, all_objs) != want_fresh:
            raise AssertionError("a fresh value differs after recovery")
        before = dict(ck_mod.LAUNCHES)
        got_mid = _read_all(rec, tail_objs, vc_mid)
        mid_launches = {n: ck_mod.LAUNCHES[n] - before[n] for n in before}
        if got_mid != want_mid:
            bad = next(i for i, (a, b) in enumerate(zip(got_mid, want_mid))
                       if a != b)
            raise AssertionError(f"{tail_objs[bad]} at the mid clock: "
                                 f"{got_mid[bad]!r}, live {want_mid[bad]!r}")
        if on_card and not (mid_launches["set_aw_fold"]
                            and mid_launches["counter_fold"]):
            raise AssertionError(f"the mid-clock reads launched "
                                 f"{mid_launches}")
        out["heads"] = _heads_equal(torch, node, rec)
        below = full_stamp.copy()
        below[0] = 1
        try:
            _read_all(rec, [sk(n_set - 1)], below)
        except RuntimeError as e:
            if "compaction horizon" not in str(e):
                raise
        else:
            raise AssertionError("a read below the image's stamp did not "
                                 "raise the compaction-horizon error")
        vc_new = rec.update_objects([(0, "counter_pn", C, ("increment", 1))])
        if int(vc_new[0]) <= live_counter:
            raise AssertionError(f"a commit after recovery minted "
                                 f"{vc_new}, not above {live_counter}")
        out["checked"] = {"fresh": len(all_objs), "mid": len(tail_objs),
                          "mid_launches": mid_launches}
        if keep is not None:
            want_fresh[n_set] = rec.read_objects([ck(0)])[0][0]
            # the cold phase's Zipf batches on this node, every row
            # resident, its value cache emptied first; their popularity is
            # the rounds' (the writer thread's and the tail's keys after)
            ranking = np.concatenate([
                _ranking(hot, n_set + hot_c),
                rng.permutation(np.concatenate([tail_keys,
                                                n_set + tail_ctrs]))])
            rec.store._value_cache.clear()
            keep.update(root=root, dir=d, cfg=cfg, objs=all_objs,
                        want=want_fresh, n_set=n_set, ranking=ranking,
                        resident_ms=_zipf_reads(
                            torch, rec, all_objs, want_fresh, ranking,
                            zipf_batches, zipf_batch)[0])
        rec.close()
        del node, rec
        # ---- the replay-read ladder ------------------------------------
        out["ladder"] = _replay_ladder(
            torch, dataclasses.replace(cfg, keys_per_table=64,
                                       fold_chunk=fold_chunk),
            os.path.join(root, "ladder"), dev, ladder_long)
        # ---- commit latency by durability ------------------------------
        lat = AntidoteNode(dataclasses.replace(cfg, keys_per_table=1024),
                           log_dir=os.path.join(root, "latency"), device=dev)
        for sync in (False, True):
            lat.set_sync_log(sync)
            ms = []
            for i in range(256):
                t3 = time.perf_counter()
                lat.update_objects([(i % 64, "counter_pn", C,
                                     ("increment", 1))])
                ms.append((time.perf_counter() - t3) * 1e3)
            out[f"commit_ms_sync_{str(sync).lower()}"] = _ms_pcts(ms)
        lat.close()
    finally:
        if keep is None or "dir" not in keep:
            shutil.rmtree(root, ignore_errors=True)
    return out


def _replay_ladder(torch, cfg, d, dev, n_long) -> dict:
    """Keys whose logs overrun the 16-op ring, each read at an old clock
    through the node (below the device's coverage: a replay of the log):
    a counter of ``n_long`` increments and a 64-add set (``assoc``), a
    64-op set with removes (``serial``), an ``n_long``-op set with removes
    (``long``, past ``fold_chunk``), a 64-op flag (``assoc``).  Each value
    equals a host model; a whole-log recovery of the directory gives the
    same digest."""
    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.crdt import get_type

    node = AntidoteNode(cfg, log_dir=d, device=dev)
    rng = np.random.default_rng(47)
    plan = {"lc": ("counter_pn", [("increment", int(x))
                                  for x in rng.integers(-50, 100, n_long)]),
            "ladd": ("set_aw", [("add", int(x))
                                for x in rng.integers(0, 12, 64)]),
            "lser": ("set_aw", [("remove", int(x)) if i % 4 == 3 else
                                ("add", int(x)) for i, x in
                                enumerate(rng.integers(0, 12, 64))]),
            "llong": ("set_aw", [("remove", int(x)) if i % 8 == 7 else
                                 ("add", int(x)) for i, x in
                                 enumerate(rng.integers(0, 12, n_long))]),
            "lflag": ("flag_ew", [("enable", ()) if x else ("disable", ())
                                  for x in rng.integers(0, 2, 64)])}
    t0 = time.perf_counter()
    want, at = {}, {}
    for key, (ty, ops) in plan.items():
        cut = len(ops) * 7 // 8 if len(ops) > 64 else 24
        model = 0 if ty == "counter_pn" else (set() if ty == "set_aw"
                                              else False)
        # one transaction an op; a run of blind ops (increments, adds,
        # enables) commits as one group, an op whose downstream reads the
        # key's state commits alone, after everything before it
        vcs, run = [], []
        for op in ops + [None]:
            if op is not None and not get_type(ty).require_state_downstream(
                    op):
                run.append(op)
                continue
            for lo in range(0, len(run), 256):
                vcs += _commit_group(node, [[(key, ty, "b", o)]
                                            for o in run[lo:lo + 256]])
            run = []
            if op is not None:
                vcs.append(node.update_objects([(key, ty, "b", op)]))
        for i, op in enumerate(ops):
            vc = vcs[i]
            if ty == "counter_pn":
                model += op[1]
            elif ty == "set_aw":
                (model.add if op[0] == "add" else model.discard)(op[1])
            else:
                model = op[0] == "enable"
            if i + 1 == cut:
                at[key] = np.asarray(vc).copy()
                want[key] = (sorted(model, key=repr)
                             if isinstance(model, set) else model)
    write_s = time.perf_counter() - t0
    out = {"write_s": write_s, "read_ms": {}}
    for key, (ty, _ops) in plan.items():
        txn = node.start_transaction()
        txn.snapshot_vc = at[key]
        t1 = time.perf_counter()
        got = node.read_objects([(key, ty, "b")], txn)[0]
        out["read_ms"][key] = (time.perf_counter() - t1) * 1e3
        node.abort_transaction(txn)
        if got != want[key]:
            raise AssertionError(f"ladder {key}: {got!r}, model "
                                 f"{want[key]!r}")
    folds = node.store.materializer_status()["replay_folds"]
    if folds != {"assoc": 3, "serial": 1, "long": 1}:
        raise AssertionError(f"replay folds {folds}")
    out["replay_folds"] = folds
    digest = _recovery_digest(node)
    node.close()
    t2 = time.perf_counter()
    rec = AntidoteNode(cfg, log_dir=d, recover=True, device=dev)
    out["whole_log_recovery_s"] = time.perf_counter() - t2
    out["whole_log_records"] = rec.store.last_recovery_records
    if _recovery_digest(rec) != digest:
        raise AssertionError("whole-log recovery digest differs")
    rec.close()
    return out


# ---------------------------------------------------------------------------
# phase 7: the cold tier and shard handoff
# ---------------------------------------------------------------------------
def _ranking(*ranked):
    """One popularity order over several ranked index arrays, each spread
    over the whole order in proportion to its length (rank r of a list of
    n lands at r / n)."""
    idx = np.concatenate(ranked)
    pos = np.concatenate([np.arange(len(x)) / max(len(x), 1)
                          for x in ranked])
    return idx[np.argsort(pos, kind="stable")]


def _zipf_plan(ranking, batches, batch):
    """The cold phase's read batches: Zipf(1.0) draws over ``ranking``,
    the durable phase's write popularity (its Zipf rounds' order), so the
    reads' hot keys are the writes' hot keys."""
    rng = np.random.default_rng(53)
    n = len(ranking)
    return [ranking[zipf_keys(rng, n, batch)] for _ in range(batches)]


def _zipf_reads(torch, node, objs, want, ranking, batches, batch):
    """The cold phase's Zipf batches through ``node.read_objects``, every
    value held to ``want``.  Returns (each batch's ms, each batch's share
    of cold keys among its distinct keys at its start)."""
    cold = node.store.cold
    on_card = node.store.device.type == "cuda"
    ms, shares = [], []
    for idx in _zipf_plan(ranking, batches, batch):
        if cold is not None:
            uniq = np.unique(idx)
            shares.append(sum(cold.is_cold((objs[i][0], objs[i][2]))
                              for i in uniq.tolist()) / len(uniq))
        t = time.perf_counter()
        vals = node.read_objects([objs[i] for i in idx])[0]
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        bad = [i for i, v in zip(idx.tolist(), vals) if v != want[i]]
        if bad:
            raise AssertionError(f"{len(bad)} Zipf reads differ, first "
                                 f"{objs[bad[0]]}")
    return ms, shares


def _stats(xs) -> dict:
    if not len(xs):
        return {"n": 0}
    xs = np.asarray(xs, np.float64)
    return {"n": int(len(xs)), "p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "mean": float(xs.mean()),
            "max": float(xs.max())}


class _ColdTimers:
    """Host-clock timers patched around the cold tier while the phase
    runs: each eviction batch (rows, ms with the card synchronized after
    it, resident rows at its start), each fault-in (µs) with its sidecar
    read and its row install apart, the sidecar write and the rebase's
    carry-forward."""

    def __init__(self, torch, on_card):
        from antidote_tpu_torch.log.checkpoint import Checkpointer
        from antidote_tpu_torch.store import coldtier
        from antidote_tpu_torch.store.typed_table import TypedTable

        self.evicts, self.faults, self.reads, self.installs = [], [], [], []
        self.faulted, self.spans = [], {}
        self._undo = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            setattr(owner, name, make(orig))
            self._undo.append((owner, name, orig))

        def timed_evict(orig):
            def evict_now(tier, max_rows=coldtier.ColdTier.EVICT_BATCH):
                before = tier.resident_rows()
                t = time.perf_counter()
                n = orig(tier, max_rows)
                if on_card:
                    torch.cuda.synchronize()
                if n:
                    self.evicts.append(
                        (n, (time.perf_counter() - t) * 1e3, before))
                return n
            return evict_now

        def timed_fault(orig):
            def fault_in(tier, dk, admit=True):
                n0 = tier.faults
                t = time.perf_counter()
                ent = orig(tier, dk, admit)
                if tier.faults > n0:
                    self.faults.append((time.perf_counter() - t) * 1e6)
                    self.faulted.append(dk)
                return ent
            return fault_in

        def timed_read(orig):
            def read_row(sc, tname, shard, row):
                t = time.perf_counter()
                out = orig(sc, tname, shard, row)
                self.reads.append((time.perf_counter() - t) * 1e6)
                return out
            return read_row

        def timed_install(orig):
            def install_rows(t_, shards, rows, head_rows, head_vc_rows):
                t = time.perf_counter()
                orig(t_, shards, rows, head_rows, head_vc_rows)
                if len(rows) == 1:
                    self.installs.append((time.perf_counter() - t) * 1e6)
            return install_rows

        def span(name):
            def make(orig):
                def run(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return orig(*a, **kw)
                    finally:
                        self.spans.setdefault(name, []).append(
                            time.perf_counter() - t)
                return run
            return make

        patch(coldtier.ColdTier, "evict_now", timed_evict)
        patch(coldtier.ColdTier, "fault_in", timed_fault)
        patch(coldtier.Sidecar, "read_row", timed_read)
        patch(TypedTable, "install_rows", timed_install)
        patch(coldtier, "write_sidecar", span("write_sidecar"))
        patch(Checkpointer, "_carry_cold", span("carry_cold"))

    def fault_summary(self) -> dict:
        """Fault-in µs a key since the last call, split into the sidecar's
        read and the row's install, and the eviction batches."""
        out = {"faults": len(self.faults), "fault_us": _stats(self.faults),
               "pread_us": _stats(self.reads),
               "install_us": _stats(self.installs),
               "evict_batches": len(self.evicts),
               "evict_rows": int(sum(e[0] for e in self.evicts)),
               "evict_batch_ms": _stats([e[1] for e in self.evicts])}
        self.faults, self.reads, self.installs, self.evicts = [], [], [], []
        return out

    def close(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def cold_phase(torch, dev, keep, budget=CO_RESIDENT, batches=CO_BATCHES,
               batch=B, round_keys=CO_ROUND_KEYS, cap=CO_CAP,
               burst=CO_BURST, sample=CO_SAMPLE, evict_to=CO_EVICT_TO,
               shard=CO_SHARD, new_shards=CO_NEW_SHARDS) -> dict:
    """The cold tier and shard handoff on the durable phase's directory
    (``keep``, which this phase deletes), all on the card:

    1. ``recover=True`` with ``resident_rows=budget``: the image's sidecar
       anchors every key, and the rows past the budget go cold;
    2. ``batches`` Zipf(1.0) batches of ``batch`` keys over every key
       (ranked by the durable phase's write popularity) with no fault-rate
       cap, every value equal to the durable phase's, beside the same
       batches on its all-resident node;
    3. two write rounds to ``round_keys`` faulted-in set keys and 256
       counters, then reads at the clock between them (the installed base
       folded with ``set_aw_fold`` and ``counter_fold``);
    4. a burst of cold reads under a fault-rate cap of ``cap`` a second,
       and an injected ``coldtier.fault``: typed ColdMiss, never a wrong
       value;
    5. a full image carrying the cold rows forward in its sidecar, more
       evictions (to ``evict_to``) recorded by a delta link, and a second
       recovery without a budget: the same keys come back cold and a
       sample of cold and resident keys reads equal;
    6. shard ``shard`` exported (its cold keys fault in), imported into a
       fresh durable node and dropped at the source; the moved values
       equal at the destination and none resurrects at the source's
       restart;
    7. the destination, restarted, resharded to ``new_shards`` shards:
       every value and every route equal.
    """
    import dataclasses
    import shutil

    from antidote_tpu_torch import faults
    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.materializer import cuda_kernels as ck_mod
    from antidote_tpu_torch.overload import ColdMiss
    from antidote_tpu_torch.store import handoff
    from antidote_tpu_torch.store.kv import key_to_shard

    cfg, d, objs = keep["cfg"], keep["dir"], keep["objs"]
    want, n_set = list(keep["want"]), keep["n_set"]
    n_keys = len(objs)
    index = {(o[0], o[2]): i for i, o in enumerate(objs)}
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def recover(**kw):
        t = time.perf_counter()
        n = AntidoteNode(cfg, log_dir=d, recover=True, device=dev, **kw)
        sync()
        m = n.metrics
        return n, {"total_s": time.perf_counter() - t,
                   "checkpoint_s": m.recovery_seconds.value(
                       phase="checkpoint"),
                   "tail_s": m.recovery_seconds.value(phase="tail"),
                   "tail_records": n.store.last_recovery_records}

    def check(node, idx, what):
        got = _read_all(node, [objs[i] for i in idx])
        bad = [i for i, v in zip(idx, got) if v != want[i]]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} values differ, first "
                                 f"{objs[bad[0]]}: {got[idx.index(bad[0])]!r}"
                                 f" != {want[bad[0]]!r}")

    timers = _ColdTimers(torch, on_card)
    out = {"keys": n_keys, "budget": budget}
    try:
        # ---- 1. recover with a resident budget ---------------------------
        node, out["recovery"] = recover(resident_rows=budget)
        cold = node.store.cold
        resident = cold.resident_rows()
        if not cold.cold_set or (resident > budget
                                 and cold.evict_now() != 0):
            raise AssertionError(f"the budget did not hold at recovery: "
                                 f"{resident} rows, {len(cold.cold_set)} "
                                 "cold")
        ev = timers.fault_summary()
        out["recovery"].update(
            resident_rows=resident, cold_keys=len(cold.cold_set),
            resident_before=max([e[2] for e in timers.evicts] or [resident]),
            evicted=ev["evict_rows"], evict_batches=ev["evict_batches"],
            evict_batch_ms=ev["evict_batch_ms"])
        log(f"cold: recovery {json.dumps(out['recovery'])}")
        # ---- 2. Zipf reads faulting cold keys in -----------------------
        timers.faulted = []
        ms, shares = _zipf_reads(torch, node, objs, want, keep["ranking"],
                                 batches, batch)
        out["zipf"] = {"batch_ms": _stats(ms),
                       "resident_batch_ms": _stats(keep["resident_ms"]),
                       "cold_share": [round(x, 4) for x in shares],
                       "resident_rows": cold.resident_rows(),
                       **timers.fault_summary()}
        log(f"cold: zipf {json.dumps(out['zipf'])}")
        # ---- 3. writes to faulted-in keys, reads inside them -----------
        # keys the Zipf reads faulted in; with a budget below the dirty
        # rows, later batches may have evicted them again, and a write
        # then faults them back in first
        faulted = [index[dk] for dk in dict.fromkeys(timers.faulted)]
        sets = [i for i in faulted if i < n_set][:round_keys]
        ctrs = [i for i in faulted if i >= n_set][:256]
        if len(sets) < 16 or len(ctrs) < 16:
            raise AssertionError(f"too few faulted-in keys: {len(sets)} "
                                 f"sets, {len(ctrs)} counters")
        round_objs = [objs[i] for i in sets + ctrs]

        def write_round(tag):
            adds = [(objs[i][0], "set_aw", objs[i][2],
                     ("add", tag + i)) for i in sets]
            incs = [(objs[i][0], "counter_pn", objs[i][2],
                     ("increment", 1)) for i in ctrs]
            vcs = _commit_group(node, [adds[j:j + 16]
                                       for j in range(0, len(adds), 16)]
                                + [incs[j:j + 64]
                                   for j in range(0, len(incs), 64)])
            return np.max(np.stack([np.asarray(v) for v in vcs]), axis=0)

        def model(rounds):
            return ([sorted(set(map(repr, want[i]))
                            | {repr(t + i) for t in rounds}) for i in sets]
                    + [want[i] + len(rounds) for i in ctrs])

        def as_model(vals):
            return ([sorted(map(repr, v)) for v in vals[:len(sets)]]
                    + vals[len(sets):])

        vc_a = write_round(1 << 20)
        vals_a = _read_all(node, round_objs)
        if as_model(vals_a) != model([1 << 20]):
            raise AssertionError("a faulted-in key's first write differs")
        write_round(2 << 20)
        before = dict(ck_mod.LAUNCHES)
        got = _read_all(node, round_objs, vc_a)
        inside = {n: ck_mod.LAUNCHES[n] - before[n] for n in before}
        if got != vals_a:
            raise AssertionError("a read inside the writes differs")
        if on_card and not (inside["set_aw_fold"]
                            and inside["counter_fold"]):
            raise AssertionError(f"the reads inside the writes launched "
                                 f"{inside}")
        latest = _read_all(node, round_objs)
        if as_model(latest) != model([1 << 20, 2 << 20]):
            raise AssertionError("a faulted-in key's second write differs")
        for i, v in zip(sets + ctrs, latest):
            want[i] = v
        out["writes"] = {"sets": len(sets), "counters": len(ctrs),
                         "inside_launches": inside}
        # ---- 4. the rate cap and an injected fault ---------------------
        node.enable_cold_tier(budget, cap)
        picks = sorted(index[dk] for dk in cold.cold_set)[:burst]
        ok, refused, hints = 0, [], []
        t = time.perf_counter()
        for i in picks:
            try:
                v = node.read_objects([objs[i]])[0][0]
            except ColdMiss as e:
                refused.append(i)
                hints.append(e.retry_after_ms)
                if e.permanent:
                    raise
                continue
            if v != want[i]:
                raise AssertionError(f"{objs[i]} under the cap: {v!r}")
            ok += 1
        burst_s = time.perf_counter() - t
        if not (ok and refused):
            raise AssertionError(f"the cap admitted {ok}, refused "
                                 f"{refused}")
        node.enable_cold_tier(budget, 0.0)
        # a refused key: still cold, and never in the value cache (a key
        # evicted by its own read's budget pass keeps its cached value,
        # which no write has invalidated)
        victim = refused[0]
        faults.install(faults.FaultPlan(seed=61).io_error("coldtier.fault",
                                                          times=1))
        try:
            node.read_objects([objs[victim]])
        except ColdMiss:
            pass
        else:
            raise AssertionError("an injected coldtier.fault served a read")
        finally:
            faults.uninstall()
        if node.read_objects([objs[victim]])[0][0] != want[victim]:
            raise AssertionError("the read after the injected fault differs")
        out["cap"] = {"cap_per_s": cap, "burst": len(picks), "admitted": ok,
                      "refused": len(refused), "seconds": burst_s,
                      "hint_ms": _stats(hints),
                      "refused_metric": node.metrics.coldtier_events.value(
                          event="refused")}
        timers.fault_summary()
        # ---- 5. a full image with the cold rows, a link, a recovery ----
        node.start_checkpointer(interval_s=0.0, rebase_every=64)
        full = node.checkpoint_now(full=True)
        side = full["cold"]["bytes"]
        write_s = timers.spans["write_sidecar"][-1]
        out["full"] = {"total_s": full["total_s"],
                       "stamp_ms": full["held_ms"],
                       "image_bytes": full["image_bytes"],
                       "sidecar_bytes": side, "cold_keys": full["cold_keys"],
                       "sidecar_write_s": write_s,
                       "sidecar_mb_s": side / 1e6 / write_s,
                       "carry_s": timers.spans["carry_cold"][-1],
                       "mb_s": (full["image_bytes"] + side) / 1e6
                       / full["total_s"]}
        log(f"cold: full image {json.dumps(out['full'])}")
        cold.budget = evict_to
        t = time.perf_counter()
        n_ev = cold.enforce_budget()
        sync()
        evict_s = time.perf_counter() - t
        delta = node.checkpoint_now(full=False)
        if delta["kind"] != "delta":
            raise AssertionError(f"the link is a {delta['kind']} image")
        out["delta"] = {"evicted": n_ev, "evict_s": evict_s,
                        "total_s": delta["total_s"],
                        "image_bytes": delta["image_bytes"],
                        "rows": delta["n_rows"],
                        **timers.fault_summary()}
        cold_keys = set(cold.cold_set)
        node.close()
        del node, cold
        n2, out["recovery_cold"] = recover()
        if n2.store.cold is None or set(n2.store.cold.cold_set) != cold_keys:
            raise AssertionError("the cold keys did not come back cold")
        rng = np.random.default_rng(59)
        cold_idx = sorted(index[dk] for dk in cold_keys)
        res_idx = sorted(set(range(n_keys)) - set(cold_idx))
        pick = sorted(rng.choice(cold_idx, min(sample, len(cold_idx)),
                                 replace=False).tolist()
                      + rng.choice(res_idx, min(sample, len(res_idx)),
                                   replace=False).tolist())
        check(n2, pick, "after the recovery with cold keys")
        out["recovery_cold"].update(cold_keys=len(cold_keys),
                                    checked=len(pick),
                                    **timers.fault_summary())
        log(f"cold: second recovery {json.dumps(out['recovery_cold'])}")
        # ---- 6. shard handoff ------------------------------------------
        moved = [i for i in range(n_keys)
                 if key_to_shard(objs[i][0], objs[i][2], cfg.n_shards)
                 == shard]
        t = time.perf_counter()
        pkg = handoff.export_shard(n2.store, shard)
        export_s = time.perf_counter() - t
        ex = timers.fault_summary()
        data = handoff.pack(pkg)
        del pkg
        dst = AntidoteNode(cfg, log_dir=os.path.join(keep["root"], "dst"),
                           device=dev)
        t = time.perf_counter()
        dst.receive_handoff(handoff.unpack(data))
        sync()
        import_s = time.perf_counter() - t
        t = time.perf_counter()
        handoff.drop_shard(n2.store, shard)
        sync()
        drop_s = time.perf_counter() - t
        check(dst, moved, "at the handoff's destination")
        dst.close()
        n2.close()
        del n2, dst
        n3, rec3 = recover()
        back = [i for i in moved
                if (objs[i][0], objs[i][2]) in n3.store.directory
                or n3.store.cold.is_cold((objs[i][0], objs[i][2]))]
        if back or len(n3.store.directory) + len(
                n3.store.cold.cold_set) != n_keys - len(moved):
            raise AssertionError(f"{len(back)} moved keys resurrected")
        out["handoff"] = {"shard": shard, "keys": len(moved),
                          "export_s": export_s, "export_faults":
                          ex["faults"], "package_mb": len(data) / 1e6,
                          "import_s": import_s, "drop_s": drop_s,
                          "restart_s": rec3["total_s"]}
        del data
        log(f"cold: handoff {json.dumps(out['handoff'])}")
        n3.close()
        del n3
        # ---- 7. reshard the restarted destination ----------------------
        t = time.perf_counter()
        dst = AntidoteNode(cfg, log_dir=os.path.join(keep["root"], "dst"),
                           recover=True, device=dev)
        sync()
        dst_recover_s = time.perf_counter() - t
        new_cfg = dataclasses.replace(cfg, n_shards=new_shards)
        t = time.perf_counter()
        new = handoff.reshard(dst.store, new_cfg, my_dc=0)
        sync()
        reshard_s = time.perf_counter() - t
        wrong = [dk for dk, ent in new.directory.items()
                 if ent[1] != key_to_shard(dk[0], dk[1], new_shards)]
        if wrong or len(new.directory) != len(moved):
            raise AssertionError(f"{len(wrong)} keys routed wrong, "
                                 f"{len(new.directory)} keys")
        dst.close()
        del dst
        t = time.perf_counter()
        check(AntidoteNode(store=new), moved, "after the reshard")
        out["reshard"] = {"shards": new_shards, "keys": len(new.directory),
                          "recover_s": dst_recover_s, "seconds": reshard_s,
                          "to_shards": sorted({e[1] for e in
                                               new.directory.values()}),
                          "check_s": time.perf_counter() - t}
        log(f"cold: reshard {json.dumps(out['reshard'])}")
        del new
    finally:
        timers.close()
        shutil.rmtree(keep["root"], ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the wire front end
# ---------------------------------------------------------------------------
def _wire_op(c, rng, k, is_read, acked, lat_r, lat_u):
    """``bench_wire.py``'s ``_op_set_aw`` on key ``k``, timed, with every
    acknowledged update recorded as (key, op, element, commit clock) and
    its latency as (start on the system's monotonic clock, ms)."""
    t0 = time.monotonic()
    if is_read:
        c.read_objects([(k, "set_aw", "b")])
        lat_r.append((time.monotonic() - t0) * 1e3)
        return
    op = "add" if rng.random() < 0.8 else "remove"
    elem = int(rng.integers(1 << 30))
    vc = c.update_objects([(k, "set_aw", "b", (op, elem))])
    lat_u.append((t0, (time.monotonic() - t0) * 1e3))
    acked.append((k, op, elem, [int(x) for x in vc]))


def wire_worker(argv) -> int:
    """One client process of the wire phase's load (``bench_wire.py``'s
    model: its workers are threads of a few client processes).  Runs
    ``threads`` workers of the Zipf(1.0) ``set_aw`` mix for an untimed
    round, prints ``{"warm": ...}``, waits for a line on stdin, runs the
    timed window and ``tail_s`` more seconds of the same load (untimed:
    the parent profiles the card then), and prints the window's counts
    and latencies and every acknowledged update of all rounds as one JSON
    line.  Any error is fatal."""
    import threading

    from antidote_tpu_torch.proto.client import AntidoteClient

    (host, port, n_keys, threads, seed, warm_s, window_s, tail_s,
     read_frac) = argv
    port, n_keys, threads, seed = int(port), int(n_keys), int(threads), \
        int(seed)
    warm_s, window_s, tail_s, read_frac = (float(warm_s), float(window_s),
                                           float(tail_s), float(read_frac))
    cdf = _zipf_cdf(n_keys)
    acked = [[] for _ in range(threads)]
    lat_r = [[] for _ in range(threads)]
    lat_u = [[] for _ in range(threads)]
    errs = []
    go = threading.Event()
    gate = {"stop": 0.0}
    counts = [[0, 0] for _ in range(threads)]  # ops: warm, timed

    def worker(i):
        rng = np.random.default_rng(seed + i)
        try:
            c = AntidoteClient(host, port, timeout=60)
            for phase in (0, 1):
                if phase:
                    go.wait(300)
                    lat_r[i].clear()
                    lat_u[i].clear()
                stop = (time.perf_counter() + warm_s if phase == 0
                        else gate["stop"] + tail_s)
                while (now := time.perf_counter()) < stop:
                    timed = phase == 0 or now < gate["stop"]
                    k = int(np.searchsorted(cdf, rng.random()))
                    _wire_op(c, rng, min(k, n_keys - 1),
                             rng.random() < read_frac, acked[i],
                             lat_r[i] if timed else [],
                             lat_u[i] if timed else [])
                    counts[i][phase] += timed
            c.close()
        except Exception as e:  # noqa: BLE001 — reported, fatal upstream
            errs.append(repr(e))
            go.set()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    time.sleep(warm_s)
    print(json.dumps({"warm": sum(c[0] for c in counts), "errs": errs}),
          flush=True)
    sys.stdin.readline()
    gate["stop"] = time.perf_counter() + window_s
    go.set()
    for t in ts:
        t.join(window_s + tail_s + 120)
    print(json.dumps({
        "ops": sum(c[1] for c in counts), "window_s": window_s,
        "lat_read_ms": [x for xs in lat_r for x in xs],
        "lat_update_ms": [x for xs in lat_u for _t, x in xs],
        "slow_updates": sorted((x for xs in lat_u for x in xs),
                               key=lambda tx: -tx[1])[:5],
        "acked": [a for xs in acked for a in xs], "errs": errs,
        "alive": sum(t.is_alive() for t in ts)}), flush=True)
    return 0


def _read_line(proc, timeout):
    """One stdout line of a child, or an AssertionError after ``timeout``
    seconds or at the child's exit."""
    import select

    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            raise AssertionError("a wire worker went silent")
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 1.0))
        if ready:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(
                    f"a wire worker exited (rc {proc.wait(10)})")
            return json.loads(line)


class _GcPauses:
    """The interpreter's garbage-collection pauses in this process while
    it is open, by generation (every thread waits for a collection)."""

    def __init__(self):
        import gc

        self._gc = gc
        self._t0 = 0.0
        self.ms: dict = {0: [], 1: [], 2: []}
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms[info["generation"]].append(
                (time.perf_counter() - self._t0) * 1e3)

    def close(self) -> None:
        if self._cb in self._gc.callbacks:
            self._gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {f"gen{g}": {"n": len(v), "sum": float(sum(v)),
                            "max": float(max(v, default=0.0))}
                for g, v in self.ms.items()}


def _stage_means(pre, post) -> dict:
    """Per-stage mean µs of the server pipeline over a window, from two
    ``_pipeline_status`` blocks."""
    out = {}
    for k, p2 in post["stages"].items():
        p1 = pre["stages"][k]
        n = p2["count"] - p1["count"]
        out[k] = {"count": n, "mean_us": ((p2["sum_ms"] - p1["sum_ms"])
                                          * 1e3 / n) if n else 0.0}
    return out


def _counter_deltas(pre, post, blk) -> dict:
    """The counters of a status block over a window (gauges left out)."""
    return {k: v - pre[blk].get(k, 0) for k, v in post[blk].items()
            if isinstance(v, (int, float)) and k not in ("size", "cap")}


def _busy_window(torch, seconds) -> dict:
    """The card's busy share over ``seconds`` of wall time while other
    threads (the server's) and processes (the clients) run the load, two
    ways: ``torch.profiler`` (CPU and CUDA activities) summing the device
    time of the kernels it traced, and ``nvidia-smi``'s ``utilization.gpu``
    (the share of each sample period in which a kernel ran) sampled every
    100 ms beside it.  An observation: a profiler or sampler that fails is
    reported, not fatal."""
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    started = True
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — reported, see docstring
        out["profiler_error"] = repr(e)
        started = False
    t0 = time.perf_counter()
    time.sleep(seconds)
    wall_us = (time.perf_counter() - t0) * 1e6
    smi.terminate()
    try:
        samples = [float(x) for x in smi.communicate(timeout=30)[0].split()]
    except (subprocess.TimeoutExpired, ValueError) as e:
        smi.kill()
        smi.wait(30)
        samples = []
        out["smi_error"] = repr(e)
    if samples:
        out["smi_util_pct"] = _stats(samples)
    if started:
        try:
            prof.stop()
            rows = [(e.self_device_time_total, e.key)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")]
        except Exception as e:  # noqa: BLE001 — reported, see docstring
            out["profiler_error"] = repr(e)
            return out
        busy_us = sum(t for t, _ in rows)
        by_name: dict = {}
        for t, k in rows:
            by_name[k[:80]] = by_name.get(k[:80], 0.0) + t / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out.update(wall_ms=wall_us / 1e3, device_ms=busy_us / 1e3,
                   device_busy_share=busy_us / wall_us,
                   top_device_ms={k: ms for k, ms in top if ms > 0})
    return out


def wire_phase(torch, dev, n_keys=WI_KEYS, procs=WI_PROCS,
               threads=WI_THREADS, warm_s=WI_WARM_S, window_s=WI_WINDOW_S,
               sample=WI_SAMPLE, burst=WI_BURST, keep=None) -> dict:
    """The wire front end on the card: ``bench_wire.py``'s
    ``set_aw_zipf_north_star`` (config 3) against an ephemeral
    ``AntidoteNode`` of BASELINE's widths served by a ``ProtocolServer``
    with the JAX package's defaults.  Populate ``n_keys`` keys in-process
    through ``KVStore.apply_effect_groups`` (3 adds a key, removes on a
    tenth); hold the server's launch stage under the CUDA sync debug mode
    and an epoch read launched on one thread, finished on another while a
    third commits and publishes, to the locked read at the epoch's clock;
    then ``procs`` client processes of ``threads`` workers each (90%
    static reads, Zipf(1.0)) for an untimed round and a timed window, the
    card's busy share over 2 s of the same load right after it; every
    touched key and ``sample``
    others read back over the wire at the join of the acknowledged
    clocks, equal to a host model; read-your-writes on 4 clients; an
    interactive session (``set_aw_fold``, ``counter_fold``) and a
    certification conflict, the apb dialect beside it; a second server
    with ``max_in_flight=4`` under a burst of ``burst`` updates (every
    refusal typed, no acknowledged write lost) and a deadline; the node
    status over the wire.  On a CPU device (a rehearsal at a small
    ``n_keys``) the card-only checks are skipped.  With ``keep`` (a dict)
    the node, the host model, the keys the window touched, the join of its
    acknowledged clocks and its load figures are left there for the
    native phase, which serves the same node."""
    import queue
    import threading

    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.proto.client import (AntidoteClient, ApbClient,
                                                 RemoteAbort, RemoteBusy,
                                                 RemoteDeadline)
    from antidote_tpu_torch.proto.server import ProtocolServer, _StaticWork
    from antidote_tpu_torch.store.kv import Effect, KVStore

    on_card = torch.device(dev).type == "cuda"
    out: dict = {"keys": n_keys, "procs": procs, "threads": threads,
                 "window_s": window_s}
    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=n_keys // 8)
    # ---- 1. populate ---------------------------------------------------
    t0 = time.perf_counter()
    store = KVStore(cfg, device=dev)
    st = orset_stream(np.random.default_rng(67), n_keys)
    keys, lane0, first_idx = st["keys"], st["lane0"], st["first_idx"]
    rm_keys, rm_t = st["rm_keys"], st["rm_t"]
    vals = (st["elems"] % SV_POOL).astype(np.int64)
    pool_h = np.asarray([store.blobs.intern(v) for v in range(SV_POOL)],
                        np.int64)
    eff_a = pool_h[vals][:, None]
    add_b = np.zeros((1 + D,), np.int32)
    for lo in range(0, len(keys), POP_BATCH):
        hi = min(lo + POP_BATCH, len(keys))
        vcs = np.zeros((hi - lo, D), np.int32)
        vcs[:, 0] = lane0[lo:hi]
        effs = [Effect(k, "set_aw", "b", eff_a[lo + j], add_b)
                for j, k in enumerate(keys[lo:hi].tolist())]
        store.apply_effect_groups([(effs, list(vcs), [0] * (hi - lo))])
    for lo in range(0, len(rm_keys), POP_BATCH):
        kk = rm_keys[lo:lo + POP_BATCH]
        rb = np.zeros((len(kk), 1 + D), np.int32)
        rb[:, 0] = 1
        rb[:, 1] = lane0[first_idx[kk]]
        vcs = np.zeros((len(kk), D), np.int32)
        vcs[:, 0] = rm_t[kk]
        effs = [Effect(k, "set_aw", "b", eff_a[first_idx[k]], rb[j])
                for j, k in enumerate(kk.tolist())]
        store.apply_effect_groups([(effs, list(vcs), [0] * len(kk))])
    if on_card:
        torch.cuda.synchronize()
    out["populate_s"] = time.perf_counter() - t0
    # the host model: each key's elements after the populate (a remove
    # takes the first add's element, unless another add of the key put
    # the same value in with its own dot)
    key_vals = np.zeros((n_keys, ADDS_PER_KEY), np.int64)
    occ = np.zeros(n_keys, np.int64)
    for i, k in enumerate(keys.tolist()):
        key_vals[k, occ[k]] = vals[i]
        occ[k] += 1
    model = [set(row) for row in key_vals.tolist()]
    v0 = vals[first_idx]
    for k in rm_keys.tolist():
        if (key_vals[k] == v0[k]).sum() == 1:
            model[k].discard(int(v0[k]))
    node = AntidoteNode(store=store)
    txm = node.txm
    log(f"wire: populated {n_keys} keys in {out['populate_s']:.1f} s")

    def objs_of(kk):
        return [(int(k), "set_aw", "b") for k in kk]

    # ---- 2. the launch stage never syncs; three threads, one batch -----
    txm.enable_serving_epochs()
    txm.publish_serving_epoch()
    probe = ProtocolServer(node, port=0, batch_static=False)
    try:
        rng = np.random.default_rng(71)
        works = [_StaticWork("read", objects=objs_of(
            zipf_keys(rng, n_keys, 64))) for _ in range(16)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            left = probe._launch_epoch_reads(works)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        if left:
            raise AssertionError(f"{len(left)} works left the epoch plane")
        n_checked = 0
        while not probe._writeback_q.empty():
            b = probe._writeback_q.get_nowait()
            got = store.epoch_read_finish(b.pending)
            store.unpin_serving_epoch(b.pending.ep)
            for w, (lo, hi) in zip(b.works, b.spans):
                if got[lo:hi] != node.read_objects(w.objects)[0]:
                    raise AssertionError("a probe epoch read differs")
                n_checked += hi - lo
    finally:
        probe.close()
    out["launch_stage"] = {"works": len(works), "objects": n_checked,
                           "sync_debug": "error" if on_card else None}
    launched: "queue.Queue" = queue.Queue()
    done = threading.Event()
    results, errors = [], []
    wrng = np.random.default_rng(73)
    t_rounds = [0]

    def launcher():
        r = np.random.default_rng(79)
        try:
            for _ in range(WI_TT_BATCHES):
                objs = objs_of(zipf_distinct(
                    r, n_keys, ProtocolServer.EPOCH_LAUNCH_CHUNK))
                ep = store.pin_serving_epoch()
                pend, fb = store.epoch_read_launch(objs, ep)
                if fb:
                    store.unpin_serving_epoch(ep)
                    raise AssertionError(f"fallbacks {fb}")
                launched.put((ep, pend, objs, ep.vc.copy()))
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errors.append(e)
        finally:
            launched.put(None)

    def finisher():
        try:
            while True:
                item = launched.get(timeout=300)
                if item is None:
                    return
                ep, pend, objs, vc = item
                try:
                    results.append((objs, vc, store.epoch_read_finish(pend)))
                finally:
                    store.unpin_serving_epoch(ep)
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errors.append(e)

    def publisher():
        try:
            while not done.is_set() and t_rounds[0] < WI_TT_ROUNDS:
                kk = np.unique(zipf_keys(wrng, n_keys, 256))
                node.update_objects([(int(k), "set_aw", "b",
                                      ("add", int(SV_POOL + t_rounds[0])))
                                     for k in kk])
                for k in kk.tolist():
                    model[k].add(SV_POOL + t_rounds[0])
                txm.publish_serving_epoch()
                t_rounds[0] += 1
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errors.append(e)

    ths = [threading.Thread(target=f, name=f"wire-{f.__name__}")
           for f in (launcher, finisher, publisher)]
    for t in ths:
        t.start()
    ths[0].join(300)
    ths[1].join(300)
    done.set()
    ths[2].join(300)
    if errors:
        raise errors[0]
    eps = set()
    for objs, vc, got in results:
        eps.add(tuple(int(x) for x in vc))
        if got != _read_all(node, objs, vc):
            raise AssertionError(f"a three-thread epoch read at {vc} "
                                 f"differs from the locked read")
    out["three_threads"] = {"batches": len(results), "epochs": len(eps),
                            "commit_rounds": t_rounds[0]}
    log(f"wire: launch stage and three-thread reads "
        f"{json.dumps(out['three_threads'])}")
    # ---- 3. the server and the timed load ------------------------------
    srv = ProtocolServer(node, port=0)
    try:
        probes = node.check_ready()
        if not all(probes.values()):
            raise AssertionError(f"the node is not ready: {probes}")
        status_c = AntidoteClient(srv.host, srv.port, timeout=60)
        out["load"], out["busy"], acked, _pre, _post = _wire_load(
            torch, srv, status_c, n_keys, procs, threads, warm_s, window_s)
        log(f"wire: load {json.dumps({k: out['load'][k] for k in ('ops_s', 'read_ms', 'update_ms')})}")
        # ---- 4. every acknowledged write reads back ---------------------
        out["check"], touched, join = _wire_readback(
            status_c, model, acked, (), np.zeros(D, np.int64), n_keys,
            sample, 83)
        if keep is not None:
            keep.update(node=node, model=model, touched=touched,
                        join=join, load=out["load"])
        # ---- 5. read-your-writes ----------------------------------------
        ryw = {"pairs": 0}
        rerr = []

        def ryw_client(i):
            try:
                c = AntidoteClient(srv.host, srv.port, timeout=60)
                r = np.random.default_rng(89 + i)
                for j in range(WI_RYW_PAIRS):
                    k = int(zipf_keys(r, n_keys, 1)[0])
                    e = (1 << 31) + 1000 * i + j
                    vc = c.update_objects([(k, "set_aw", "b", ("add", e))])
                    v, _ = c.read_objects([(k, "set_aw", "b")], clock=vc)
                    if e not in v[0]:
                        raise AssertionError(f"client {i} missed its write "
                                             f"of {e} to key {k}")
                    model[k].add(e)
                    ryw["pairs"] += 1
                c.close()
            except Exception as e:  # noqa: BLE001 — fatal, raised below
                rerr.append(e)

        rts = [threading.Thread(target=ryw_client, args=(i,))
               for i in range(4)]
        for t in rts:
            t.start()
        for t in rts:
            t.join(300)
        if rerr:
            raise rerr[0]
        out["read_your_writes"] = ryw
        # ---- 6. an interactive session and the apb dialect -------------
        out["session"] = _wire_session(srv, AntidoteClient, ApbClient,
                                       RemoteAbort, "w")
        # ---- 7. overload: typed sheds, no lost write, a deadline -------
        out["overload"] = _wire_overload(node, AntidoteClient, RemoteBusy,
                                         RemoteDeadline, ProtocolServer,
                                         burst, "w")
        # ---- 8. the status over the wire --------------------------------
        st = status_c.node_status(include_ready=True)
        if not all(st["ready"].values()):
            raise AssertionError(f"status ready {st['ready']}")
        pipe = st["pipeline"]
        need = {"overload", "pipeline", "tenants", "write_plane", "escrow",
                "net"}
        if not need <= set(st) or not pipe["epoch_reads"]:
            raise AssertionError(f"status blocks {sorted(st)}")
        out["status"] = {"reads": pipe["reads"],
                         "epoch_publish": pipe["epoch_publish"],
                         "serving_epoch_id": pipe["serving_epoch_id"],
                         "shed": st["overload"]["shed"],
                         "materializer": pipe["materializer"]}
        status_c.close()
    finally:
        srv.close()
    return out


def _wire_load(torch, srv, status_c, n_keys, procs, threads, warm_s,
               window_s, snap=None) -> tuple:
    """``bench_wire.py``'s timed load against ``srv``: ``procs`` client
    processes of ``threads`` workers (``chip_smoke.py --wire-worker``) for
    an untimed round and a timed window, then (on a card) the card's busy
    share over ``WI_TAIL_S - 0.5`` s of the same load.  Returns the load
    figures, the busy figures, every acknowledged update and the server's
    pipeline blocks before and after the window (with ``snap()`` under
    their ``"snap"`` key when given)."""
    on_card = srv.node.store.device.type == "cuda"
    children = []
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                             + os.pathsep + env.get("PYTHONPATH", ""))
        for p in range(procs):
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--wire-worker",
                 srv.host, str(srv.port), str(n_keys), str(threads),
                 str(1000 * (p + 1)), str(warm_s), str(window_s),
                 str(WI_TAIL_S if on_card else 0.0), str(WI_READ_FRAC)],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True))
        warm = [_read_line(c, 600) for c in children]
        if any(w["errs"] for w in warm):
            raise AssertionError(f"warm round errors: {warm}")
        pre = status_c.node_status()["pipeline"]
        if snap is not None:
            pre["snap"] = snap()
        gc_pauses = _GcPauses()
        for c in children:
            c.stdin.write("go\n")
            c.stdin.flush()
        t_go = time.perf_counter()
        busy: dict = {}
        if on_card:
            # the profile runs on the same load just after the timed
            # window: its stop processes the trace for seconds under the
            # interpreter lock, which inside the window stalled every
            # request
            time.sleep(window_s + 0.25)
            t_prof = time.monotonic()
            busy = _busy_window(torch, WI_TAIL_S - 0.5)
        res = [_read_line(c, window_s + 300) for c in children]
        load_s = time.perf_counter() - t_go
        gc_pauses.close()
        post = status_c.node_status()["pipeline"]
        if snap is not None:
            post["snap"] = snap()
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait(30)
    if any(r["errs"] or r["alive"] for r in res):
        raise AssertionError(f"load errors: "
                             f"{[r['errs'][:3] for r in res]}")
    ops = sum(r["ops"] for r in res)
    if on_card:
        # the window's slowest updates: start (s, against the profile's
        # start) and ms
        busy["slow_updates_s_ms"] = sorted(
            ((t - t_prof, ms) for r in res for t, ms in r["slow_updates"]),
            key=lambda tx: -tx[1])[:5]
    lr = [x for r in res for x in r["lat_read_ms"]]
    lu = [x for r in res for x in r["lat_update_ms"]]
    nm = srv.node.metrics
    load = {
        "warm_ops": sum(w["warm"] for w in warm), "ops": ops,
        "ops_s": ops / window_s, "wall_s": load_s,
        "read_ms": _stats(lr), "update_ms": _stats(lu),
        "stages_us": _stage_means(pre, post),
        "reads": _counter_deltas(pre, post, "reads"),
        "snapshot_cache": _counter_deltas(pre, post, "snapshot_cache"),
        "epoch_publish": _counter_deltas(pre, post, "epoch_publish"),
        # the node's commit rounds so far (the populate took none)
        "commit_round_ms": {k: v * 1e3 if k in ("mean", "p50", "p99")
                            else v for k, v in
                            nm.commit_seconds.summary().items()},
        "merge_width": nm.commit_merge_width.summary(),
        "gc_pauses_ms": gc_pauses.summary()}
    acked = [a for r in res for a in r["acked"]]
    return load, busy, acked, pre, post


def _wire_readback(c, model, acked, also, base_join, n_keys, sample,
                   seed) -> tuple:
    """Read back over ``c``, at the join of ``base_join`` and the
    acknowledged clocks: every key ``acked`` updated, every key of
    ``also`` and ``sample`` others, each equal to the host ``model`` (a
    key with an acknowledged remove of an element that an add put back
    may read either way: the remove's snapshot decides).  The model takes
    the values read, so it is exact for a later phase.  Returns the
    figures, the touched keys and the join."""
    join = np.asarray(base_join, np.int64).copy()
    by_key: dict = {}
    for k, op, elem, vc in acked:
        join = np.maximum(join, np.asarray(vc, np.int64))
        by_key.setdefault(k, []).append((op, elem, vc[0]))
    racy = 0
    expect = {}
    for k, ops_k in by_key.items():
        adds = {e for op, e, _ in ops_k if op == "add"}
        base = model[k] | adds
        hit = {e for op, e, _ in ops_k if op == "remove" and e in base}
        if hit:
            racy += 1
        expect[k] = (base, base - hit)
    for k in also:
        expect.setdefault(k, (model[k], model[k]))
    rest = np.setdiff1d(np.arange(n_keys), np.fromiter(expect, np.int64))
    pick = np.random.default_rng(seed).choice(
        rest, min(sample, len(rest)), replace=False)
    for k in pick.tolist():
        expect[k] = (model[k], model[k])
    chk = sorted(expect)
    got = []
    clock = [int(x) for x in join]
    for lo in range(0, len(chk), 512):
        v, _ = c.read_objects([(int(k), "set_aw", "b")
                               for k in chk[lo:lo + 512]], clock=clock)
        got.extend(v)
    bad = [k for k, v in zip(chk, got)
           if set(v) not in (expect[k][0], expect[k][1])]
    if bad:
        k = bad[0]
        raise AssertionError(
            f"{len(bad)} keys differ from the model after the load, "
            f"key {k}: {sorted(got[chk.index(k)])[:8]} against "
            f"{sorted(expect[k][1])[:8]}")
    for k, v in zip(chk, got):
        model[k] = set(v)
    return ({"acked_updates": len(acked), "touched_keys": len(by_key),
             "also_keys": len(set(also) - set(by_key)),
             "sampled_keys": len(pick), "racy_keys": racy},
            set(by_key), join)


def _wire_session(srv, AntidoteClient, ApbClient, RemoteAbort,
                  tag: str) -> dict:
    """Interactive transactions over the wire: a transaction started
    before other clients write its keys reads them at its snapshot (the
    ring folds: ``set_aw_fold``, ``counter_fold``), then commits; two
    read-bearing transactions on one counter: the second commit is
    ``RemoteAbort``.  The apb dialect: static writes and reads, and an
    interactive transaction whose conflict comes back as the JAX
    server's ``AbortError`` reply.  Every key starts with ``tag``."""
    from antidote_tpu_torch.proto import apb

    a = AntidoteClient(srv.host, srv.port, timeout=60)
    b = AntidoteClient(srv.host, srv.port, timeout=60)
    sets = [(f"{tag}tx{i}", "set_aw", "b") for i in range(WI_TXN_KEYS)]
    ctrs = [(f"{tag}tc{i}", "counter_pn", "b") for i in range(WI_TXN_KEYS)]
    try:
        a.update_objects([(k, t, bk, ("add", j)) for j, (k, t, bk)
                          in enumerate(sets)]
                         + [(k, t, bk, ("increment", 5)) for k, t, bk in ctrs])
        # one commit to a third table first: the transaction's snapshot is
        # then above the set and counter tables' own commit clocks, so no
        # table epoch the ticker froze since is pinned exactly at it (the
        # ladder's rung 2, which folds nothing): its reads fold the rings
        vc = a.update_objects([(f"{tag}tx-bump", "flag_ew", "b",
                                ("enable", None))])
        txn = a.start_transaction(clock=vc)
        for r in range(3):  # newer ops in every ring past the snapshot
            b.update_objects([(k, t, bk, ("add", 100 + r))
                              for k, t, bk in sets]
                             + [(k, t, bk, ("increment", 1))
                                for k, t, bk in ctrs])
        got = txn.read_objects(sets + ctrs)
        want = [[j] for j in range(len(sets))] + [5] * len(ctrs)
        if got != want:
            raise AssertionError(f"a transaction read {got[:3]}... at its "
                                 f"snapshot, want {want[:3]}...")
        txn.update_objects([(k, t, bk, ("add", 7)) for k, t, bk in sets])
        cvc = txn.commit()
        vals, _ = b.read_objects(sets + ctrs, clock=cvc)
        want = ([sorted({j, 7, 100, 101, 102}) for j in range(len(sets))]
                + [8] * len(ctrs))
        if [sorted(v) for v in vals[:len(sets)]] + vals[len(sets):] != want:
            raise AssertionError("the session's values after its commit")
        t1 = a.start_transaction()
        t2 = b.start_transaction()
        for t in (t1, t2):
            t.read_objects(ctrs[:1])
            t.update_objects([ctrs[0] + (("increment", 1),)])
        t1.commit()
        try:
            t2.commit()
        except RemoteAbort:
            conflict = "RemoteAbort"
        else:
            raise AssertionError("a certification conflict committed")
        # the apb dialect
        c = ApbClient(srv.host, srv.port, timeout=60)
        try:
            ka, kas = f"{tag}apb".encode(), f"{tag}apbs".encode()
            avc = c.update_objects([(ka, "counter_pn", b"b",
                                     ("increment", 3)),
                                    (kas, "set_aw", b"b",
                                     ("add", b"e1"))])
            v, _ = c.read_objects([(ka, "counter_pn", b"b"),
                                   (kas, "set_aw", b"b")], clock=avc)
            if v != [3, [b"e1"]]:
                raise AssertionError(f"apb static read {v}")
            bo = {"key": ka, "type": apb.TYPE_IDS["counter_pn"],
                  "bucket": b"b"}
            upd = {"boundobject": bo,
                   "operation": {"counterop": {"inc": 1}}}
            descs = []
            for _ in range(2):
                _n, r = c._call("ApbStartTransaction", {
                    "timestamp": apb._enc_clock(avc)})
                descs.append(r["transaction_descriptor"])
            for d in descs:
                _n, r = c._call("ApbReadObjects", {
                    "transaction_descriptor": d, "boundobjects": [bo]})
                if apb.read_resp_to_value(r["objects"][0]) != 3:
                    raise AssertionError("apb transaction read")
                c._call("ApbUpdateObjects", {"transaction_descriptor": d,
                                             "updates": [upd]})
            c._call("ApbCommitTransaction",
                    {"transaction_descriptor": descs[0]})
            try:
                c._call("ApbCommitTransaction",
                        {"transaction_descriptor": descs[1]})
            except Exception as e:  # noqa: BLE001 — checked below
                apb_conflict = str(e)
            else:
                raise AssertionError("an apb conflict committed")
            if "AbortError" not in apb_conflict:
                raise AssertionError(f"apb conflict reply {apb_conflict}")
        finally:
            c.close()
    finally:
        a.close()
        b.close()
    return {"keys": 2 * len(sets), "conflict": conflict,
            "apb_conflict": apb_conflict.split(":")[1].strip()}


def _wire_overload(node, AntidoteClient, RemoteBusy, RemoteDeadline,
                   ProtocolServer, burst, tag: str,
                   native: bool = False) -> dict:
    """A second server on the node with ``max_in_flight=4`` (on the native
    plane with ``native``): bursts of ``burst`` concurrent static updates
    until some are shed; every refusal is a typed ``RemoteBusy`` with a
    retry hint and one of the Python plane's details, and every
    acknowledged update reads back.  Then an update with
    ``deadline_ms=0.001`` is refused typed and never executes.  Every key
    starts with ``tag``."""
    import re
    import threading

    srv = ProtocolServer(node, port=0, max_in_flight=4,
                         native_frontend=native)
    acked, busy, other, details = [], [], [], set()
    try:
        for rnd in range(3):
            barrier = threading.Barrier(burst)

            def fire(i, rnd=rnd):
                try:
                    c = AntidoteClient(srv.host, srv.port, timeout=60)
                except OSError as e:
                    other.append(repr(e))
                    return
                try:
                    barrier.wait(60)
                    k = f"{tag}ovl{rnd}-{i}"
                    vc = c.update_objects([(k, "set_aw", "b", ("add", i))])
                    acked.append((k, i, vc))
                except RemoteBusy as e:
                    busy.append(e.retry_after_ms)
                    details.add(re.sub(r"\d+", "N", str(e)))
                except Exception as e:  # noqa: BLE001 — counted, fatal
                    other.append(repr(e))
                finally:
                    c.close()

            ts = [threading.Thread(target=fire, args=(i,))
                  for i in range(burst)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            if busy:
                break
        shapes = {"server at max_in_flight=N",
                  "client N.N.N.N at max_in_flight_per_client=N",
                  "server admission refused"}
        if other or not busy or min(busy) < 25 or not details <= shapes:
            raise AssertionError(f"burst: {len(acked)} acked, busy hints "
                                 f"{busy[:8]}, details {details}, other "
                                 f"{other[:3]}")
        c = AntidoteClient(srv.host, srv.port, timeout=60)
        try:
            join = np.max([vc for _k, _i, vc in acked], axis=0).tolist()
            vals, _ = c.read_objects([(k, "set_aw", "b")
                                      for k, _i, _vc in acked], clock=join)
            lost = [k for (k, i, _vc), v in zip(acked, vals) if v != [i]]
            if lost:
                raise AssertionError(f"acknowledged writes lost: {lost}")
            try:
                c.update_objects([(f"{tag}ovl-deadline", "set_aw", "b",
                                   ("add", 1))], deadline_ms=0.001)
            except RemoteDeadline:
                pass
            else:
                raise AssertionError("a 1 µs deadline was not refused")
            if c.read_objects([(f"{tag}ovl-deadline", "set_aw",
                                "b")])[0] != [[]]:
                raise AssertionError("the expired update executed")
        finally:
            c.close()
        res = {"burst": burst, "rounds": rnd + 1, "acked": len(acked),
               "busy": len(busy), "hint_ms": _stats(busy),
               "details": sorted(details), "deadline": "RemoteDeadline",
               "shed": {k: v for k, v in
                        node.status()["overload"]["shed"].items()}}
        if native:
            res["native_sheds"] = srv.native.stats()["sheds"]
        return res
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# phase 9: the native front end
# ---------------------------------------------------------------------------
def native_phase(torch, dev, keep, procs=WI_PROCS, threads=WI_THREADS,
                 warm_s=WI_WARM_S, window_s=WI_WINDOW_S, sample=WI_SAMPLE,
                 burst=WI_BURST, router_keys=NA_ROUTER_KEYS) -> dict:
    """The native front end on the card, the serve default: the wire
    phase's node (``keep``) served by a ``ProtocolServer(native_frontend=
    True)`` with the JAX package's defaults.  The same timed load as the
    wire phase (``bench_wire.py`` config 3), with the native plane's
    counters over the window beside this call's wire figures; every key
    touched in either window and ``sample`` others read back through the
    native plane at the join of the acknowledged clocks, equal to the host
    model; ``native_hits > 0`` and no fallback; clockless counter reads
    after each of ``NA_SOUND_ROUNDS`` increments never past the committed
    total and converging, and one whole-batch hit byte-equal to the Python
    plane's at one epoch id; the interactive session and the apb dialect
    through the native plane; a burst against a native server with
    ``max_in_flight=4`` (every shed typed); ``router_keys`` string keys
    routed by the native router, a sample equal to the plain XXH64."""
    from antidote_tpu_torch.obs.metrics import net_metrics
    from antidote_tpu_torch.proto.client import (AntidoteClient, ApbClient,
                                                 RemoteAbort, RemoteBusy,
                                                 RemoteDeadline)
    from antidote_tpu_torch.proto.server import ProtocolServer
    from antidote_tpu_torch.store import router

    node, model = keep["node"], keep["model"]
    n_keys = len(model)
    out: dict = {"keys": n_keys, "procs": procs, "threads": threads,
                 "window_s": window_s,
                 "wire_load": {k: keep["load"][k]
                               for k in ("ops_s", "read_ms", "update_ms")}}
    fb0 = net_metrics().frontend_fallback.value()
    srv = ProtocolServer(node, port=0, native_frontend=True)
    try:
        nf = srv.native
        if nf is None or node.store.native_mirror is not nf:
            raise AssertionError("the native plane does not feed on the "
                                 "store's mirror")
        c = AntidoteClient(srv.host, srv.port, timeout=60)
        # ---- 1. the timed load -----------------------------------------
        load, out["busy"], acked, pre, post = _wire_load(
            torch, srv, c, n_keys, procs, threads, warm_s, window_s,
            snap=lambda: dict(nf.pushes))
        nat = {k: v - pre["native"][k] for k, v in post["native"].items()
               if k not in ("mirror_size", "in_flight", "open_conns")}
        py_reads = sum(load["reads"].values())
        load["native"] = {
            **nat, "mirror_size": post["native"]["mirror_size"],
            "pushes": {k: v - pre["snap"][k]
                       for k, v in post["snap"].items()},
            # requests: one object a read in this traffic
            "hit_share": nat["native_hits"] / max(
                1, nat["native_hits"] + py_reads),
            "crossings_per_drain": nat["forwarded"] / max(1, nat["drains"])}
        out["load"] = load
        log(f"native: load {json.dumps({k: load[k] for k in ('ops_s', 'read_ms', 'update_ms')})}, "
            f"hit share {load['native']['hit_share']:.3f}")
        if nat["native_hits"] <= 0:
            raise AssertionError("the native plane served no hit in the "
                                 "window")
        # ---- 2. every acknowledged write of both windows reads back ----
        out["check"], _t, _j = _wire_readback(
            c, model, acked, keep["touched"], keep["join"], n_keys, sample,
            97)
        # ---- 3. the mirror never serves what Python would not ----------
        out["soundness"] = _native_soundness(node, srv, AntidoteClient,
                                             ProtocolServer)
        # ---- 4. an interactive session and the apb dialect -------------
        out["session"] = _wire_session(srv, AntidoteClient, ApbClient,
                                       RemoteAbort, "n")
        # ---- 5. overload on the native plane ---------------------------
        out["overload"] = _wire_overload(node, AntidoteClient, RemoteBusy,
                                         RemoteDeadline, ProtocolServer,
                                         burst, "n", native=True)
        out["status_native"] = c.node_status()["pipeline"]["native"]
        c.close()
    finally:
        srv.close()
    out["frontend_fallback"] = net_metrics().frontend_fallback.value() - fb0
    if out["frontend_fallback"]:
        raise AssertionError("the native plane fell back")
    # ---- 6. the native router ------------------------------------------
    out["router"] = _native_router(router, router_keys, NA_ROUTER_BATCH)
    return out


def _native_soundness(node, srv, AntidoteClient, ProtocolServer) -> dict:
    """Clockless counter reads through the native plane (a reader that
    never commits, beside a writer): after each of ``NA_SOUND_ROUNDS``
    increments no read exceeds the committed total, and the reads converge
    to it; then one whole-batch hit served by the C++ loop is byte-equal to
    the Python plane's reply at the same epoch id (a second server on the
    node, without the native plane)."""
    import socket
    import struct

    import msgpack

    from antidote_tpu_torch.proto.codec import MessageCode, read_frame

    nf = srv.native
    obj = [("nsound", "counter_pn", "b")]
    w = AntidoteClient(srv.host, srv.port, timeout=60)
    r = AntidoteClient(srv.host, srv.port, timeout=60)
    reads, h0 = 0, nf.stats()["native_hits"]
    try:
        for total in range(1, NA_SOUND_ROUNDS + 1):
            w.update_objects([obj[0] + (("increment", 1),)])
            deadline = time.monotonic() + 30
            while True:
                v = r.read_objects(obj)[0][0]
                reads += 1
                if v > total:
                    raise AssertionError(f"a clockless read gave {v} past "
                                         f"the committed {total}")
                if v == total:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"clockless reads stuck at {v} < "
                                         f"{total}")
                time.sleep(0.005)
            # past the ticker's next advance the C++ loop serves the key
            time.sleep(0.15)
            for _ in range(4):
                reads += 1
                if r.read_objects(obj)[0] != [total]:
                    raise AssertionError("a converged read moved")
    finally:
        w.close()
        r.close()
    out = {"rounds": NA_SOUND_ROUNDS, "reads": reads,
           "native_hits": nf.stats()["native_hits"] - h0}
    if not out["native_hits"]:
        raise AssertionError("no converged read was served natively")
    body = bytes([MessageCode.STATIC_READ_OBJECTS]) + msgpack.packb(
        {"objects": [list(obj[0])] + [[k, "set_aw", "b"] for k in range(8)],
         "clock": None}, use_bin_type=True)
    req = struct.pack(">I", len(body)) + body
    ps = ProtocolServer(node, port=0)
    try:
        for attempt in range(5):
            ep = node.store.serving_epoch
            s = socket.create_connection((srv.host, srv.port), timeout=60)
            try:
                h = nf.stats()["native_hits"]
                deadline = time.monotonic() + 30
                while nf.stats()["native_hits"] == h:
                    if time.monotonic() > deadline:
                        raise AssertionError("no whole-batch native hit")
                    s.sendall(req)
                    read_frame(s)
                s.sendall(req)
                native = read_frame(s)
            finally:
                s.close()
            s = socket.create_connection((ps.host, ps.port), timeout=60)
            try:
                s.sendall(req)
                python = read_frame(s)
            finally:
                s.close()
            if node.store.serving_epoch is ep:
                break
        else:
            raise AssertionError("the serving epoch moved in every attempt")
    finally:
        ps.close()
    if native != python:
        raise AssertionError(f"native hit bytes {native!r} differ from the "
                             f"Python plane's {python!r}")
    out.update(hit_bytes=len(native), epoch_id=int(ep.id), attempts=attempt + 1)
    return out


def _native_router(router, n, batch) -> dict:
    """``n`` string keys (``user:i``, bucket ``b``) routed to BASELINE's 8
    shards by the native router in batches of ``batch`` (host clock around
    each ``shard_batch``), and a random sample of ``batch`` keys equal to
    the plain XXH64."""
    keys = [f"user:{i}" for i in range(n)]
    buckets = ["b"] * batch
    ms, shards = [], np.empty(n, np.int64)
    for lo in range(0, n, batch):
        kk = keys[lo:lo + batch]
        t = time.perf_counter()
        shards[lo:lo + len(kk)] = router.shard_batch(kk, buckets[:len(kk)],
                                                     8)
        ms.append((time.perf_counter() - t) * 1e3)
    pick = np.random.default_rng(101).choice(n, min(batch, n), replace=False)
    plain = [router.xxh64(router.key_bytes(keys[i], "b")) % 8
             for i in pick.tolist()]
    if shards[pick].tolist() != plain:
        raise AssertionError("the native router differs from the plain "
                             "XXH64")
    counts = np.bincount(shards, minlength=8)
    return {"keys": n, "batch": batch, "shards": 8, "ms_per_batch": _stats(ms),
            "keys_per_s": n / (sum(ms) / 1e3), "sample": len(pick),
            "shard_min_max": [int(counts.min()), int(counts.max())]}


def count_resolves(fn):
    """``fn()`` with every ``SetAW.resolve`` call counted: (its result,
    the count)."""
    from antidote_tpu_torch.crdt.sets import SetAW

    orig = SetAW.resolve
    calls = [0]

    def counted(self, cfg, state):
        calls[0] += 1
        return orig(self, cfg, state)

    SetAW.resolve = counted
    try:
        return fn(), calls[0]
    finally:
        SetAW.resolve = orig


def main() -> int:
    if sys.argv[1:2] == ["--wire-worker"]:
        return wire_worker(sys.argv[2:])
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test runs on the card only")
        return 2
    from antidote_tpu_torch.materializer import cuda_kernels as ck

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # the g++ builds of the native planes (WAL, front end, router) run
    # beside nvcc
    import threading

    from antidote_tpu_torch import native_build

    gxx_err = []

    def gxx():
        try:
            for src, stem, _getter in native_build.MODULES:
                native_build.ensure(src, stem)
        except Exception as e:  # noqa: BLE001 — raised below
            gxx_err.append(e)

    gxx_thread = threading.Thread(target=gxx, name="g++")
    gxx_thread.start()
    lib, report = ck.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    gxx_thread.join()
    if gxx_err:
        raise gxx_err[0]
    log(f"native planes built by {time.perf_counter() - t0:.1f} s: "
        f"{native_build.check() or 'every library matches its source'}")
    for line in report.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log(f"ptxas: {line.strip()}")
    records = check_kernels(torch, ck, dev)
    records["stable_min"] = check_stable_min(torch, ck, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    floor_ms = time_ms(torch, lambda: ck.launch_floor(dev), 50, flush)
    log(f"launch floor (empty kernel, same path and timing): {floor_ms} ms")
    # each path's launches, counted from 0 just before it, and its seconds
    def run_path(fn):
        ck.reset_launches()
        t = time.perf_counter()
        res = fn()
        res["launches"] = dict(ck.LAUNCHES)
        res["seconds"] = time.perf_counter() - t
        return res

    resolves = [0]

    def serve_counted():
        res, resolves[0] = count_resolves(lambda: serve_main_path(torch, dev))
        return res

    serve = run_path(serve_counted)
    serve["set_aw_resolves"] = resolves[0]
    if serve["launches"]["orset_presence"] != resolves[0]:
        raise AssertionError(
            f"the serve launched orset_presence "
            f"{serve['launches']['orset_presence']} times in {resolves[0]} "
            "resolves (want one launch per resolve)")
    node = run_path(lambda: node_workload(dev))
    serving = run_path(lambda: serving_phase(torch, dev))
    cluster = run_path(lambda: cluster_workload(torch, dev))
    types = run_path(lambda: {"tables": types_tables(torch, dev),
                              "session": types_node_session(dev),
                              "long_logs": long_log_folds(torch, dev)})
    keep = {}
    durable = run_path(lambda: durable_phase(torch, dev, keep=keep))
    print(f"durable: {json.dumps(durable)} | card: {card}", flush=True)
    cold = run_path(lambda: cold_phase(torch, dev, keep))
    print(f"cold: {json.dumps(cold)} | card: {card}", flush=True)
    wire_keep = {}
    wire = run_path(lambda: wire_phase(torch, dev, keep=wire_keep))
    print(f"wire: {json.dumps(wire)} | card: {card}", flush=True)
    native = run_path(lambda: native_phase(torch, dev, wire_keep))
    wire_keep.clear()
    print(f"native: {json.dumps(native)} | card: {card}", flush=True)
    paths = {"serve": serve, "node": node, "serving": serving,
             "cluster": cluster, "types": types, "durable": durable,
             "cold": cold, "wire": wire, "native": native}
    for path, res in paths.items():
        log(f"{path}: {json.dumps(res)}")
        missing = [n for n in PATH_KERNELS[path] if res["launches"][n] == 0]
        if missing:
            raise AssertionError(f"the {path} path never launched {missing}")
    launches = {n: sum(res["launches"][n] for res in paths.values())
                for n in records}
    kernels = []
    for name, rec in records.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name], **rec})
    log(f"all phases done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(paths))
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
