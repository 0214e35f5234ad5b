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
   (``serving``) on a 50,000-key ``set_aw`` store populated through
   ``KVStore.apply_effect_groups``: two copy publishes and ten scatters of
   serving epochs, 8 Zipf batches read through the epoch plane (pin,
   launch — one of them under the CUDA sync debug mode — finish, unpin)
   while a second thread commits through the manager, which publishes
   inline, every value held to the locked read at the epoch's clock (or,
   for a row since GC'd below the device's coverage there, to the host
   oracle); whole-batch snapshot-cache reads of the hot set; the table's
   rung 2 (no fold) and rung 3 (``set_aw_fold``); a node's Zipf-hot
   reads through the value cache, warm and cold;
4. drive a 4-member DC (``ClusterMember``/``ClusterNode`` over localhost
   RPC, 2048 shards, all on the card): populate 12,500 ``set_aw`` keys
   from every member's coordinator, remove on 2,000 keys through the
   owners' downstream, run mixed transactions from every coordinator
   (every start launches ``stable_min`` on the 2048 x 4 clock matrix),
   a segment of maps, rga and counter_b across the members, and check
   every key against a host model, at the stable snapshot and at an
   older one;
5. the other types (``types``): the nine device types other than set_aw
   and counter_pn, one 4,000-key table each at BASELINE widths, filled
   by a seeded three-lane stream and read fresh and historical, equal to
   the same table built on the CPU; then a node session over them and the
   maps against a host model (``bench_suite.py``'s map and rga workloads,
   counter_b refusals, concurrent writers, slot promotion, maps read at an
   older snapshot); and 1,024 keys' 4,096-op logs of the five
   assoc-capable types, ``assoc_fold`` and ``fold_long`` equal to
   ``fold_batch`` on the card;
6. durability (``durable``): an ``AntidoteNode`` with a log directory on
   the local disk (``tempfile``), at BASELINE's configuration with 30% of
   its keys: 100,000 ``set_aw`` keys
   (2 adds each, removes on 10%) and 100,000 ``counter_pn`` keys (2
   increments) committed through the manager in groups; a full
   checkpoint (its stamp's time under the commit lock against its copy
   bound); 16 rounds of 4,096 Zipf-distinct keys, then a delta link taken
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
   recovery with 150,000 of its 200,000 rows resident (the rest evicted
   to the sidecar), 1 Zipf(1.0) batch of 16,384 keys over every key
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
   each of 8 increments at least the acknowledged total on the writer's
   connection, never past the committed total and converging;
   one whole-batch hit byte-equal to the Python plane's at one epoch id;
   the interactive session (``set_aw_fold``, ``counter_fold``) and the
   apb dialect; a burst of 32 updates against a native server with
   ``max_in_flight=4`` (every shed a typed ``RemoteBusy``); 1M string keys
   through the native router in batches of 16,384, a sample equal to the
   plain XXH64.  Its figures print on a ``native:`` line beside the card;
10. inter-DC replication (``interdc``): three single-node DCs at
   BASELINE's widths, each an ``AntidoteNode`` on the card with a WAL, its
   own ``TcpFabric`` (the native receive pump) and its own
   ``ProtocolServer(interdc=...)``, meshed through
   ``get_connection_descriptor``/``connect_to_dcs`` (msgpack on one pair,
   the apb dialect on the others); 100,000 ``set_aw`` keys populated
   through DC0's manager replicate over the sockets (the origin's
   records/s, each peer's seconds to cover the final clock); the geo load
   (``bench_wire.py`` config 3's mix at all three DCs, 8 workers a DC in
   one client process each, a 2 s untimed round and a 10 s window) with
   the visibility lag of probe writes read at another DC with their clock,
   the card's busy share; every acknowledged write and 2,048 untouched
   keys equal at all three DCs and to the host model; a causal chain
   across the three; concurrent counters summing exactly; an injected
   ``interdc.deliver`` drop repaired by catch-up; the flash sale of
   ``bench_wire.py`` (2,500 ``counter_b`` SKUs, 50 units over two lanes, 8
   shoppers a DC, a 5 s storm) with zero oversell, then a grant that must
   arrive on a SKU whose rights lie on DC0's lane only;
   then a GentleRain pair whose reads at the GST fold the rings
   (``set_aw_fold``, ``counter_fold``).  Its figures print on an ``interdc:`` line beside the card;
11. follower read replicas (``follower``): one owner at BASELINE's widths
   (a WAL, its own ``TcpFabric``, a ``DCReplica``, a
   ``ProtocolServer(interdc=...)`` on the native front end) and two
   followers (each a node with its own log directory and fabric, a
   ``FollowerReplica`` attached by descriptor over TCP and a
   ``ProtocolServer(follower=...)``); ``bench_wire.py`` config 3's 200,000
   ``set_aw`` keys and 10,000 counters populated through the owner's
   manager, a full image, a tail after it; both followers bootstrap by
   image (the image's MB, the ship's seconds and MB/s, the install's and
   the catch-up's seconds), the second through one injected ``ckpt.ship``
   fault, retried; the config 3 mix over the fleet through session
   clients whose writes a follower forwards (ops/s, read and update p50 /
   p99, reads served locally, proxied and redirected, forwarded writes,
   the card's busy share); every acknowledged write and 2,048 untouched
   keys equal at both followers, the owner and the host model; reads at a
   token inside the tail equal the owner's (they fold: ``set_aw_fold``,
   ``counter_fold``); every shard's Merkle root ``ok``; one corrupted row
   healed by fetching its leaf alone; a ``proxy.forward`` fault surfacing
   typed; follower 1 restarted from its directory in mode ``tail`` while a
   session keeps read-your-writes.  Its figures print on a ``follower:``
   line beside the card;
12. the cluster's durability and crash takeover (``takeover``): the
   cluster phase's deployment (4 members, 2048 shards, on the card) with a
   log directory a member, 12,500 ``set_aw`` and 2,048 ``counter_pn``
   keys; a transaction wedged after the sequencer with 64 commits
   buffered behind it, aborted by ``resolve_wedged`` (the zombie's late
   commit refused); a partial fan-out completed at every owner; member 2
   crashed with an undecided prep and a commit logged but not applied,
   recovered on the card; a never-sequenced prepare swept; a checkpoint
   on every member, member 1 recovered from its image and its compacted
   ``prepare.wal``; the DC resized 4 -> 3 offline (a member on a retired
   directory refuses); every key against a host model after the wedge,
   the rejoin, the image recovery and the resize, at the stable snapshot
   and an older one (the older reads fold; the cluster's own reads
   decode sets on the host, so ``orset_presence`` launches only in the
   check that reads each member's store through the serving path's
   resolve).  Its figures print on a
   ``takeover:`` line beside the card.  Its last segment (``live``, its
   launches counted from 0): every member's inter-DC endpoint on one
   ``TcpFabric``; member 3 boots empty and joins, then member 1 leaves,
   512 two-phase shard moves each while 2 workers commit; between the
   two, a follower of the clustered owner on the card attaches to the four
   members' descriptors (it composes their images: each one's ship and
   install seconds) and shadows the leave; after it the refusals, one map
   partitioning the shards, the check through the survivors'
   coordinators (the moved keys also at the snapshot before the join),
   the follower's digest clean on every shard against the shard's owner
   and its reads of every key of a shard moved in the leave and of the
   phase's sample equal to the owners' at their applied clock; the import
   seals' seconds and kind by member.  Its figures print on a ``live:``
   line beside the card;
13. the mesh serving plane (``mesh``): ``parallel.MeshServingPlane`` over
   every card of a machine with 2 or more that divide the 8 shards, else
   4 blocks of 2 shards on ``cuda:0`` (the device list printed first, and
   every kernel held against its plain version on every distinct device
   of the plane); an ``AntidoteNode`` at BASELINE's widths with a log
   directory and its tables placed by shard block, ``bench_wire.py`` config
   3's 200,000 ``set_aw`` keys plus 20,000 counters populated through
   ``KVStore.apply_effect_groups``, a sample of 16,384 keys equal to a
   twin node without a plane; copy and scatter publishes, the last after
   two bursts on one shard (``antidote_mesh_publish_total`` moves for that
   shard alone, by its dirty rows; the other blocks' slots untouched);
   ``stable_vc`` (``stable_min`` on each block) equal to the applied
   clocks' min after every commit round, cached; 8 Zipf batches through
   the epoch plane beside a committing thread, equal to the locked read;
   historical batches (``set_aw_fold`` on every block) and counters at an
   older clock (``counter_fold``); ``sharded_step_fn`` on the placed
   tables; 20,000-op logs of a set and a counter through the
   ``mesh_assoc`` rung equal to ``assoc``; 5 s of the north-star mix
   through a native-front-end server on the node, every acknowledged write
   read back, the status ``mesh`` block.  Its figures print on a
   ``mesh:`` line beside the card;
14. print one JSON line per kernel record, the card line, and last the
   ``{"ok": true, ...}`` line.

The launch counts are reset just before the serve, the node workload, the
serving plane, the cluster, the types phase, the durable phase, the cold
phase, the wire phase, the native phase, the interdc phase, the follower
phase, the takeover phase and its live segment, and the mesh phase, and
read just after each; each must show the kernels that ``PATH_KERNELS``
names for it (the mesh phase on every block and every distinct device of
its plane), and a kernel record's ``launches`` is the sum over the
fourteen.
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
# wire phase's arrival, the same budget); the keys halved again, to 50,000,
# with the interdc phase's arrival (the populate took 31.7 s of the phase's
# 60.9 s at 100,000), and the mixed transactions halved again, to 64 a
# coordinator (the whole script took 579 s on a slower host with them at
# 128, 16.0 s of the phase's 49.5 s); the keys halved again, to 25,000,
# with the follower phase's arrival (the script took 553.5 s with it, the
# populate 18.6 s of the phase's 38.2 s at 50,000), and again, to 12,500,
# with the takeover phase's (the phase took 28.7-37.4 s on two hosts)
CL_MEMBERS, CL_SHARDS, CL_KEYS, CL_ADDS = 4, 2048, 12_500, 3
CL_TXN, CL_REMOVES, CL_MIXED = 1024, 2000, 64
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
# reads at the cut after TY_CUT rounds.  12,000 keys a type: 100,000 in
# the first runs, 25,000 after the cold phase's arrival, halved again
# after the interdc phase's (the script took 553 s with the interdc storm
# cut to 5 s, which left its escrow transfers to chance; the types phase
# took 70.2 s, and its populate and CPU twin scale with the keys); 8,000
# with the follower phase's arrival (the script took 553.5 s with it);
# 4,000 with the takeover phase's (the script took 796.6 s with it on a
# slow host of an NVIDIA H100 80GB HBM3 at 700 W, the types phase 47.0-57.9
# s on two hosts)
TY_KEYS, TY_ROUNDS, TY_CUT, TY_SHARDS = 4_000, 20, 18, 8
MV_SLOTS, RGA_SLOTS = 4, 64
# the serving phase: keys (15% of BASELINE's 1M: halved with the cold
# phase's arrival and again with the wire phase's, for the 600 s budget,
# and 250,000 -> 150,000 with the interdc phase's, whose arrival left the
# script at 550 s against its 560 s, and 150,000 -> 100,000 with the
# follower phase's (553.5 s with it), and 100,000 -> 50,000 with the
# takeover phase's; the populate through the store scales with them),
# element pool, publish rounds of SV_ROUND_KEYS keys x 4 effects,
# epoch-read batches (8: 60 until the script took 579 s with the interdc
# phase on a slower host, 30 until it took 568 s with the follower phase,
# 15 until the takeover phase came),
# the concurrent writer's round size, the hot
# set; long logs of LL_OPS ops for LL_KEYS keys
SV_KEYS = 50_000
SV_POOL, SV_ROUNDS, SV_ROUND_KEYS, SV_BATCHES = 4096, 10, 4096, 8
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
# evictions and export on the same directory); 15% (150,000) since the
# interdc phase came: at 300,000 the durable phase took 121.6 s (its
# populate 47.4 s) and the cold phase 108.5 s, the whole script 700 s;
# the delta rounds 32 -> 16 when the script took 579 s on a slower host;
# 10% (100,000) since the follower phase came (the script took 568 s on a
# slower host, the durable phase 81.2 s, its populate 32.0 s, and the cold
# phase on its directory 59.7 s)
DU_SET_KEYS, DU_CTR_KEYS, DU_GROUP = 100_000, 100_000, 4096
DU_ROUNDS, DU_TAIL_ROUNDS, DU_LADDER_LONG = 16, 16, 1500
# the cold phase, on the durable phase's directory: the resident budget
# (about the rows the delta link and the WAL tail wrote, which cannot go
# cold; a quarter of the 600,000 rows before the native phase's cut, now
# 150,000 of 200,000), Zipf read batches (2: 20 in earlier runs, 10 after
# the wire phase's arrival, 3 after the interdc phase's, 2 since the
# follower phase's, ~1.6 s each on a slower host; their p50 / p99 is
# over these batches, so fewer than 2 gives no percentile), the
# faulted-in keys of
# the write rounds, the rate cap's fault-ins a second and its burst, the
# sample of keys checked after the second recovery, the budget the delta
# link's evictions go down to, the shard moved by handoff and the
# reshard's shard count
CO_RESIDENT, CO_BATCHES, CO_ROUND_KEYS = 150_000, 2, 2048
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
# the interdc phase: three single-node DCs at BASELINE's widths (the size
# of the multi-DC suites, tests/test_interdc.py), populated with half of
# bench_wire.py config 3's 200,000 keys (at 200,000 the populate alone took
# 128.9 s on the card's host, 4,811 records/s: three DCs share one
# interpreter; 100,000 is the phase's floor) through DC0's manager in
# transactions of IX_TXN_KEYS keys and commit groups of IX_GROUP (16,384
# keys a group); the geo load's workers a DC, untimed round and window; the
# GentleRain pair's keys and counters; bench_wire.py's FLASH_SALE (SKUs,
# inventory across both lanes, shoppers a DC, storm seconds, mint batch).
# The storm is cut to 5 s; a grant that must arrive is checked apart from
# it, on a SKU whose rights lie on one lane only.  The SKUs are cut to
# 5,000 since the follower phase came (the mint of 10,000 took 9.5 s of
# the phase's 155.8 s in a 568 s script on a slower host), and to 2,500
# since the takeover phase came
IX_KEYS, IX_TXN_KEYS, IX_GROUP = 100_000, 256, 64
IX_THREADS, IX_WARM_S, IX_WINDOW_S = 8, 2.0, 10.0
IX_GR_KEYS, IX_GR_CTRS = 16_384, 1024
FS_SKUS, FS_INVENTORY, FS_SHOPPERS, FS_STORM_S, FS_MINT_BATCH = (
    2_500, 50, 8, 5.0, 200)
# the follower phase: one owner and two followers at BASELINE's widths,
# bench_wire.py config 3's keyspace cut to 100,000 set_aw keys, the interdc
# phase's floor (at its full 200,000 the phase took 101.5 s against its 90 s:
# the populate 22.5 s, both followers' Merkle checks of every shard 21.0 s),
# plus counters, the load's session workers, the tail's keys a round
FO_KEYS, FO_CTRS, FO_THREADS, FO_TAIL_KEYS = 100_000, 10_000, 8, 2048
# the takeover phase: the cluster phase's deployment (4 members, 2048
# shards) with a log directory a member — its set keys (3 adds each;
# 12,500, cut from 25,000: at 25,000 the phase took 86.9 s against its
# 80 s, the populate 13.6 s of it), a counter key a shard (2 increments),
# updates a populate txn, the commits buffered behind the wedged hole, the
# timed mixed txns before and after the resize, untouched keys read at the
# older snapshot, and the members the DC resizes to
TK_SET_KEYS, TK_CTR_KEYS, TK_TXN = 12_500, 2048, 1024
TK_CHAIN, TK_MIXED, TK_SAMPLE, TK_NEW_MEMBERS = 64, 64, 2048, 3
# its live segment, on the resized members: the workers committing the
# phase's mixed transactions while member 3 joins and member 1 leaves (cut
# from 4 once the follower of the clustered owner came: with 4 the segment
# took 507.0 s against 223.2 s before the follower and the import seals'
# chain bound, over the 150 s more they were given)
TK_LIVE_THREADS = 2
# the mesh phase: bench_wire.py config 3's set_aw keys and counters at
# BASELINE's widths on a plane of 4 blocks of 2 shards on one card (every
# card of a machine with 2 or more that divide the 8 shards); its publish
# rounds of SV_ROUND_KEYS / 4 keys, Zipf epoch-read batches, historical
# batches, the giant-key fold's log length, the north-star window's
# workers and seconds, and the sample held against the twin and read back
MS_KEYS, MS_CTRS, MS_BLOCKS_ONE_CARD = 200_000, 20_000, 4
MS_ROUNDS, MS_BATCHES, MS_HIST_BATCHES, MS_LONG_OPS = 4, 8, 4, 20_000
MS_THREADS, MS_WINDOW_S, MS_SAMPLE = 8, 5.0, 16_384
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
# ride the same epoch-read chunks, and its session folds as the wire's does;
# the interdc phase's servers resolve sets the same way, and its GentleRain
# reads at the GST fold the rings of the rows written past it (sets and
# counters); the follower phase's servers resolve every set read and its
# digests every chunk of sets, and its reads at a token inside the tail fold
# the rings of the rows written after it (sets and counters); the takeover
# phase's transaction starts merge the 2048 shards' clock rows, and its
# reads at the older snapshot fold (sets and counters); its sets resolve
# on the card only in the check that reads each member's store through
# the serving path (the owners' reads decode sets on the host); its live
# segment's starts merge the clock rows during and after the moves, and
# its reads at the snapshot before the join fold the moved rings on their
# new owners (sets and counters), and the follower of the clustered owner's
# digest resolves the sets of every shard on both sides (the owner's and
# its own); the check's resolves are counted apart; the mesh plane
# resolves every routed epoch gather on every block (sets), folds the
# historical set batches and counters on every block, and runs stable_min
# on every block's clock rows
PATH_KERNELS = {"serve": ("orset_presence", "set_aw_fold"),
                "node": ("counter_fold", "set_aw_fold"),
                "serving": ("orset_presence", "set_aw_fold"),
                "cluster": ("stable_min",),
                "types": ("orset_presence", "set_aw_fold", "counter_fold"),
                "durable": ("orset_presence", "set_aw_fold",
                            "counter_fold"),
                "cold": ("orset_presence", "set_aw_fold", "counter_fold"),
                "wire": ("orset_presence", "set_aw_fold", "counter_fold"),
                "native": ("orset_presence", "set_aw_fold", "counter_fold"),
                "interdc": ("orset_presence", "set_aw_fold",
                            "counter_fold"),
                "follower": ("orset_presence", "set_aw_fold",
                             "counter_fold"),
                "takeover": ("stable_min", "set_aw_fold", "counter_fold",
                             "orset_presence"),
                "live": ("stable_min", "set_aw_fold", "counter_fold",
                         "orset_presence"),
                "mesh": ("orset_presence", "set_aw_fold", "counter_fold",
                         "stable_min")}


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


def _readable(stream, timeout: float) -> bool:
    """Whether ``stream`` has input within ``timeout`` seconds (``poll``:
    the takeover phase holds descriptors past ``select``'s limit)."""
    import select

    p = select.poll()
    p.register(stream, select.POLLIN)
    return bool(p.poll(int(timeout * 1000)))


def _read_line(proc, timeout):
    """One stdout line of a child, or an AssertionError after ``timeout``
    seconds or at the child's exit."""
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            raise AssertionError("a worker process went silent")
        if _readable(proc.stdout, min(left, 1.0)):
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(
                    f"a worker process exited (rc {proc.wait(10)})")
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


def _busy_window(torch, seconds, quiesce=None) -> dict:
    """The card's busy share over ``seconds`` of wall time while other
    threads (the server's) and processes (the clients) run the load, two
    ways: ``torch.profiler`` (CPU and CUDA activities) summing the device
    time of the kernels it traced, and ``nvidia-smi``'s ``utilization.gpu``
    (the share of each sample period in which a kernel ran) sampled every
    100 ms beside it.  ``quiesce()``, where given, stops the load at the
    window's end, before the profiler's stop digests its trace (seconds
    under the interpreter lock, which a load in the same process would
    see as a stalled server).  An observation: a profiler or sampler that
    fails is reported, not fatal."""
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
    if quiesce is not None:
        quiesce()
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
                   seed, peers=()) -> tuple:
    """Read back over ``c``, at the join of ``base_join`` and the
    acknowledged clocks: every key ``acked`` updated, every key of
    ``also`` and ``sample`` others, each equal to the host ``model`` (a
    key with an acknowledged remove of an element that an add put back
    may read either way: the remove's snapshot decides).  Each client of
    ``peers`` (other DCs) reads the same keys at the same clock and must
    answer exactly what ``c`` did.  The model takes the values read, so it
    is exact for a later phase.  Returns the figures, the touched keys and
    the join."""
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
    for i, pc in enumerate(peers):
        for lo in range(0, len(chk), 512):
            v, _ = pc.read_objects([(int(k), "set_aw", "b")
                                    for k in chk[lo:lo + 512]], clock=clock)
            if v != got[lo:lo + 512]:
                j = next(j for j, (a, b) in enumerate(zip(v, got[lo:]))
                         if a != b)
                raise AssertionError(
                    f"peer {i + 1} reads key {chk[lo + j]} as "
                    f"{sorted(v[j])[:8]} where the first DC reads "
                    f"{sorted(got[lo + j])[:8]}")
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
             "sampled_keys": len(pick), "racy_keys": racy,
             "dcs": 1 + len(peers)},
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
    increments the writer's next clockless read on its own connection
    returns at least the acknowledged total (read-your-writes), no read
    exceeds the committed total, and the reads converge to it; then one whole-batch hit served by the C++ loop is byte-equal to
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
            v = w.read_objects(obj)[0][0]  # clockless, after the ack
            reads += 1
            if v < total:
                raise AssertionError(f"read-your-writes: a clockless read "
                                     f"after the acknowledged {total} gave "
                                     f"{v}")
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


# ---------------------------------------------------------------------------
# inter-DC replication between single-node DCs
# ---------------------------------------------------------------------------
def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return buf


def _apb_call(host, port, name, payload) -> tuple:
    """One request of the apb dialect on a fresh connection: (reply
    message name, decoded reply)."""
    import socket
    import struct

    from antidote_tpu_torch.proto import apb

    body = apb.encode_frame_body(name, payload)
    with socket.create_connection((host, port), timeout=60) as s:
        s.sendall(struct.pack(">I", len(body)) + body)
        frame = _recv_exact(s, struct.unpack(">I", _recv_exact(s, 4))[0])
    rn = apb.CODE_TO_NAME[frame[0]]
    return rn, apb.decode_msg(rn, frame[1:])


def _ix_mesh(dev, cfg, n, meta=None, servers=True, log_root=None) -> list:
    """``n`` single-node DCs on ``dev``, each an ``AntidoteNode`` (with a
    WAL under ``log_root`` when given) with its own ``TcpFabric`` (the
    native receive pump), ``DCReplica``, pump loop and escrow loop, and
    (with ``servers``) a ``ProtocolServer(interdc=)`` with the serve
    default's native front end.  Nothing is connected."""
    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.interdc import DCReplica
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.server import ProtocolServer

    dcs = []
    for i in range(n):
        node = AntidoteNode(
            cfg, dc_id=i, device=dev, meta=None if meta is None else meta(),
            log_dir=None if log_root is None
            else os.path.join(log_root, f"dc{i}"))
        fabric = TcpFabric()
        rep = DCReplica(node, fabric, name=f"dc{i}")
        loops = [fabric.start_pump_loop(f"interdc-pump-{i}"),
                 rep.start_escrow_loop()]
        srv = (ProtocolServer(node, port=0, interdc=rep,
                              native_frontend=True) if servers else None)
        dcs.append({"node": node, "fabric": fabric, "rep": rep,
                    "srv": srv, "loops": loops})
    return dcs


def _ix_close(dcs) -> None:
    for d in dcs:
        for lp in d["loops"]:
            lp.stop()
        if d["srv"] is not None:
            d["srv"].close()
        d["fabric"].close()


def _ix_bootstrap(dcs, clients) -> dict:
    """The mesh through the wire only: each DC's descriptor fetched over
    its socket, DC0-DC1 cross-connected in the msgpack dialect, DC2 with
    the other two in the apb dialect (the descriptor an opaque blob)."""
    descs = [c.get_connection_descriptor() for c in clients[:2]]
    clients[0].connect_to_dcs([descs[1]])
    clients[1].connect_to_dcs([descs[0]])
    blobs = []
    for d in dcs:
        rn, r = _apb_call(d["srv"].host, d["srv"].port,
                          "ApbGetConnectionDescriptor", {})
        if rn != "ApbGetConnectionDescriptorResp" or not r["success"]:
            raise AssertionError(f"apb descriptor: {rn} {r}")
        blobs.append(r["descriptor"])
    for i, j in ((2, 0), (2, 1), (0, 2), (1, 2)):
        d = dcs[i]["srv"]
        rn, r = _apb_call(d.host, d.port, "ApbConnectToDCs",
                          {"descriptors": [blobs[j]]})
        if rn != "ApbOperationResp" or not r["success"]:
            raise AssertionError(f"apb connect dc{i} -> dc{j}: {r}")
    return {"msgpack_pairs": [[0, 1]], "apb_pairs": [[0, 2], [1, 2]],
            "addresses": [list(x["address"]) for x in descs]}


def _ix_populate(dcs, n_keys, seed) -> tuple:
    """``n_keys`` ``set_aw`` keys through DC0's manager (3 adds a key from
    the ``SV_POOL`` values, removes of the first add's element on a tenth),
    in transactions of ``IX_TXN_KEYS`` keys and commit groups of
    ``IX_GROUP``; the peers' coverage of the final clock polled beside it.
    Returns the figures and the host model."""
    import threading

    node = dcs[0]["node"]
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, SV_POOL, (n_keys, ADDS_PER_KEY))
    model = [set(r) for r in vals.tolist()]
    rm = rng.choice(n_keys, n_keys // 10, replace=False)
    target = [None]
    covered = {}
    t0 = time.perf_counter()

    def watch():
        while len(covered) < len(dcs) - 1:
            for i, d in enumerate(dcs[1:], 1):
                if (i not in covered and target[0] is not None
                        and int(d["node"].store.stable_vc()[0])
                        >= target[0]):
                    covered[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 900:
                return
            time.sleep(0.01)

    wt = threading.Thread(target=watch, name="ix-coverage")
    wt.start()
    records = 0
    try:
        for r in range(ADDS_PER_KEY):
            order = rng.permutation(n_keys)
            txns = [[(int(k), "set_aw", "b", ("add", int(vals[k, r])))
                     for k in order[lo:lo + IX_TXN_KEYS].tolist()]
                    for lo in range(0, n_keys, IX_TXN_KEYS)]
            for g in range(0, len(txns), IX_GROUP):
                _commit_group(node, txns[g:g + IX_GROUP])
            records += n_keys
        txns = [[(int(k), "set_aw", "b", ("remove", int(vals[k, 0])))
                 for k in rm[lo:lo + IX_TXN_KEYS].tolist()]
                for lo in range(0, len(rm), IX_TXN_KEYS)]
        for g in range(0, len(txns), IX_GROUP):
            _commit_group(node, txns[g:g + IX_GROUP])
        records += len(rm)
        origin_s = time.perf_counter() - t0
        target[0] = int(node.txm.commit_counter)
        wt.join(900)
    finally:
        target[0] = target[0] if target[0] is not None else 1 << 30
        wt.join(60)
    if len(covered) < len(dcs) - 1:
        raise AssertionError(f"peers never covered the populate: "
                             f"{covered}")
    for k in rm.tolist():
        model[k].discard(int(vals[k, 0]))
    return ({"keys": n_keys, "records": records,
             "txns": -(-n_keys // IX_TXN_KEYS) * ADDS_PER_KEY
             + -(-len(rm) // IX_TXN_KEYS),
             "origin_s": origin_s, "origin_records_s": records / origin_s,
             "final_clock": target[0],
             "peer_covered_s": {f"dc{i}": s for i, s in covered.items()},
             "peer_effects_s": {f"dc{i}": records / s
                                for i, s in covered.items()}}, model)


def _ix_load(torch, dcs, n_keys, threads, warm_s, window_s) -> tuple:
    """The geo load: one client process of ``threads`` workers a DC
    (``--wire-worker``: 90% reads, Zipf(1.0), 80% of updates adds of a
    random 30-bit int, 20% removes), all three at once, for an untimed
    round and a timed window; beside the window, one probe thread for each
    ordered pair of DCs writes at the first and reads at the second with
    the returned clock, timed until answered (the visibility lag: its
    count, median and largest; a window holds too few probes for a tail
    percentile); then (on a card) the card's busy share
    over 2 s of the same load."""
    import threading

    from antidote_tpu_torch.proto.client import AntidoteClient

    on_card = dcs[0]["node"].store.device.type == "cuda"
    tail = WI_TAIL_S if on_card else 0.0
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    children = []
    lag_ms, lag_err = [], []
    stop = threading.Event()

    def prober(i, j):
        try:
            src = AntidoteClient(dcs[i]["srv"].host, dcs[i]["srv"].port,
                                 timeout=120)
            dst = AntidoteClient(dcs[j]["srv"].host, dcs[j]["srv"].port,
                                 timeout=120)
            n = 0
            while not stop.is_set():
                key = ("ixlag", i, j, n % 16)
                vc = src.update_objects([(key, "counter_pn", "b",
                                          ("increment", 1))])
                t = time.perf_counter()
                dst.read_objects([(key, "counter_pn", "b")], clock=vc)
                lag_ms.append((time.perf_counter() - t) * 1e3)
                n += 1
            src.close()
            dst.close()
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            lag_err.append(e)

    def counters():
        return [(dict(d["node"].metrics.serving_reads.snapshot()),
                 dict(d["node"].store.replay_fold_dispatches)) for d in dcs]

    try:
        for p, d in enumerate(dcs):
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--wire-worker",
                 d["srv"].host, str(d["srv"].port), str(n_keys),
                 str(threads), str(5000 + 1000 * p), str(warm_s),
                 str(window_s), str(tail), str(WI_READ_FRAC)],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True))
        warm = [_read_line(c, 600) for c in children]
        if any(w["errs"] for w in warm):
            raise AssertionError(f"geo warm round errors: {warm}")
        pre = counters()
        for c in children:
            c.stdin.write("go\n")
            c.stdin.flush()
        probers = [threading.Thread(target=prober, args=(i, j),
                                    name=f"ix-lag-{i}-{j}")
                   for i in range(len(dcs)) for j in range(len(dcs))
                   if i != j]
        for pt in probers:
            pt.start()
        time.sleep(window_s)
        stop.set()
        for pt in probers:
            pt.join(120)
        busy: dict = {}
        if on_card:
            busy = _busy_window(torch, tail - 0.5)
        res = [_read_line(c, window_s + 300) for c in children]
        post = counters()
    finally:
        stop.set()
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait(30)
    if lag_err:
        raise lag_err[0]
    if any(r["errs"] or r["alive"] for r in res):
        raise AssertionError(f"geo load errors: "
                             f"{[r['errs'][:3] for r in res]}")
    per_dc = {f"dc{i}": {
        "ops_s": r["ops"] / window_s, "read_ms": _stats(r["lat_read_ms"]),
        "update_ms": _stats(r["lat_update_ms"]),
        # server-side reads by path (window and tail) and the log-replay
        # folds of reads below the device's retained versions
        "reads": {"/".join(k): v - pre[i][0].get(k, 0)
                  for k, v in post[i][0].items() if v - pre[i][0].get(k, 0)},
        "replay_folds": {k: v - pre[i][1].get(k, 0)
                         for k, v in post[i][1].items()
                         if v - pre[i][1].get(k, 0)}}
        for i, r in enumerate(res)}
    load = {"threads_per_dc": threads, "warm_s": warm_s,
            "window_s": window_s,
            "ops_s": sum(r["ops"] for r in res) / window_s,
            "per_dc": per_dc,
            "visibility_lag_ms": {
                "n": len(lag_ms),
                "median": float(np.median(lag_ms)) if lag_ms else None,
                "max": max(lag_ms, default=None)}}
    acked = [a for r in res for a in r["acked"]]
    return load, busy, acked


def _ix_converged(dcs, join, timeout=120.0) -> float:
    """Seconds until every DC's stable snapshot covers ``join`` (the
    heartbeats have passed)."""
    t0 = time.perf_counter()
    join = np.asarray(join, np.int64)
    while True:
        if all((d["node"].store.stable_vc().astype(np.int64) >= join).all()
               for d in dcs):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(
                f"stable snapshots {[d['node'].store.stable_vc().tolist() for d in dcs]} "
                f"never covered {join.tolist()}")
        time.sleep(0.01)


def _ix_causal_and_counters(dcs, clients) -> dict:
    """A causal chain across the three DCs (DC0 writes x; DC1 reads x at
    x's clock and writes y; DC2 reads y at y's clock and sees x), and
    concurrent ``counter_pn`` increments at all three DCs summing exactly
    at every DC."""
    import threading

    c0, c1, c2 = clients
    vx = c0.update_objects([("ix_x", "set_aw", "b", ("add", 7))])
    v, vr = c1.read_objects([("ix_x", "set_aw", "b")], clock=vx)
    if v != [[7]]:
        raise AssertionError(f"DC1 read x as {v} at x's clock")
    vy = c1.update_objects([("ix_y", "set_aw", "b", ("add", 8))], clock=vr)
    v, _ = c2.read_objects([("ix_y", "set_aw", "b"),
                            ("ix_x", "set_aw", "b")], clock=vy)
    if v != [[8], [7]]:
        raise AssertionError(f"DC2 at y's clock read (y, x) as {v}")
    per, errs, clocks = 40, [], []

    def bump(i):
        try:
            for n in range(per):
                clocks.append(clients[i].update_objects(
                    [("ix_ctr", "counter_pn", "b", ("increment", i + 1))]))
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errs.append(e)

    ts = [threading.Thread(target=bump, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    if errs:
        raise errs[0]
    join = np.max(np.asarray(clocks, np.int64), axis=0)
    got = [c.read_objects([("ix_ctr", "counter_pn", "b")],
                          clock=[int(x) for x in join])[0][0]
           for c in clients]
    want = per * (1 + 2 + 3)
    if got != [want] * 3:
        raise AssertionError(f"concurrent increments read {got}, want "
                             f"{want} at every DC")
    return {"causal_chain": True, "counter_sum": want,
            "counter_increments": 3 * per}


def _ix_drop_repaired(dcs, clients) -> dict:
    """One injected ``interdc.deliver`` drop on the DC0 -> DC2
    subscription, repaired by catch-up: DC2 reads the write at its clock
    and its catch-up queries grew.  A dropped frame that was a heartbeat
    leaves no gap; the attempt then repeats (up to 8 times)."""
    from antidote_tpu_torch import faults

    rep2 = dcs[2]["rep"]
    for attempt in range(1, 9):
        before = rep2.catchups
        inj = faults.install(faults.FaultPlan(seed=attempt).drop(
            "interdc.deliver", key=(0, 2), times=1))
        try:
            vc = clients[0].update_objects(
                [("ix_drop", "counter_pn", "b", ("increment", 1))])
            v, _ = clients[2].read_objects([("ix_drop", "counter_pn", "b")],
                                           clock=vc)
            fired = sum(r.fired for r in inj.plan.rules)
        finally:
            faults.uninstall()
        if v != [attempt]:
            raise AssertionError(f"DC2 read {v} after the drop, want "
                                 f"[{attempt}]")
        if fired and rep2.catchups > before:
            return {"attempts": attempt, "catchups": rep2.catchups - before}
    raise AssertionError("no dropped transaction was repaired by catch-up "
                         "in 8 attempts")


def _gst_snapshot(node) -> np.ndarray:
    """The snapshot a transaction started now would read at."""
    txn = node.start_transaction()
    node.abort_transaction(txn)
    return txn.snapshot_vc


def _ix_gentlerain(torch, dev, n_keys, n_ctrs) -> dict:
    """Two DCs with ``txn_prot=gr`` (their own mesh: GentleRain's scalar
    GST is the minimum over every lane, so lanes no DC feeds would pin it
    at 0).  G0 writes every key twice, in two rounds of transactions; at
    G1, whose own lane has not moved, the GST stays at 0 and none of it
    shows; G1 then commits until its lane (the GST) sits between the
    rounds, and reads at the GST fold the ring (``set_aw_fold``,
    ``counter_fold``) to exactly the first round plus the second round's
    transactions at or below the GST; G1's heartbeats then lift G0's GST
    to the same point, and once G1's lane passes the rounds every value is
    whole at both DCs."""
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.meta import MetaDataStore

    def gr_meta():
        m = MetaDataStore()
        m.set_env("txn_prot", "gr")
        return m

    cfg = AntidoteConfig(n_shards=8, max_dcs=2, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=max(1024, n_keys // 8))
    dcs = _ix_mesh(dev, cfg, 2, meta=gr_meta, servers=False)
    t0 = time.perf_counter()
    try:
        from antidote_tpu_torch.interdc import DCReplica

        reps = [d["rep"] for d in dcs]
        type(dcs[0]["fabric"]).interconnect([d["fabric"] for d in dcs])
        DCReplica.connect_all(reps)
        g0, g1 = dcs[0]["node"], dcs[1]["node"]
        if g1.txm.protocol != "gr":
            raise AssertionError("the GentleRain DC runs "
                                 f"{g1.txm.protocol}")
        per_txn = 1024
        rounds = []  # per key and round: the G0 counter of its commit
        stamp = np.zeros((2, n_keys), np.int64)
        cstamp = np.zeros((2, n_ctrs), np.int64)
        for r in range(2):
            for lo in range(0, n_keys, per_txn):
                ks = range(lo, min(lo + per_txn, n_keys))
                cs = [c for c in range(n_ctrs)
                      if lo * n_ctrs // n_keys <= c
                      < min(lo + per_txn, n_keys) * n_ctrs // n_keys]
                ups = ([(("g", k), "set_aw", "b", ("add", r)) for k in ks]
                       + [(("gc", c), "counter_pn", "b",
                           ("increment", r + 1)) for c in cs])
                vc = g0.update_objects(ups)
                stamp[r, lo:lo + len(ks)] = int(vc[0])
                cstamp[r, cs] = int(vc[0])
            rounds.append(int(g0.txm.commit_counter))
        objs = ([(("g", k), "set_aw", "b") for k in range(n_keys)]
                + [(("gc", c), "counter_pn", "b") for c in range(n_ctrs)])
        deadline = time.perf_counter() + 300
        while int(g1.store.dc_max_vc()[0]) < rounds[1]:
            if time.perf_counter() > deadline:
                raise AssertionError("G1 never applied G0's writes")
            time.sleep(0.01)
        # G1's own lane is 0: its GST is 0 and nothing of G0 shows
        lagged = _read_all(g1, objs[:256] + objs[n_keys:n_keys + 64])
        if any(lagged[i] for i in range(len(lagged))):
            raise AssertionError("a GentleRain read at GST 0 saw G0's "
                                 "writes")
        gst = (rounds[0] + rounds[1]) // 2
        n = 0
        while g1.txm.commit_counter < gst:
            g1.update_objects([(("g1own", n), "counter_pn", "b",
                                ("increment", 1))])
            n += 1
        snap = _gst_snapshot(g1)
        if int(snap[0]) != gst:
            raise AssertionError(f"G1's GST snapshot {snap.tolist()}, "
                                 f"want lane 0 at {gst}")

        def want_at(g):
            w = [sorted(r for r in range(2) if stamp[r, k] <= g)
                 for k in range(n_keys)]
            return w + [sum(r + 1 for r in range(2) if cstamp[r, c] <= g)
                        for c in range(n_ctrs)]

        def norm(vals):
            return [sorted(v) if isinstance(v, list) else v for v in vals]

        t_r = time.perf_counter()
        got = norm(_read_all(g1, objs))
        read_s = time.perf_counter() - t_r
        if got != want_at(gst):
            bad = next(i for i, (a, b) in enumerate(zip(got, want_at(gst)))
                       if a != b)
            raise AssertionError(f"G1 at GST {gst} reads {objs[bad]} as "
                                 f"{got[bad]}, want {want_at(gst)[bad]}")
        # G1's heartbeats lift G0's GST (min of G0's lane and lane 1)
        deadline = time.perf_counter() + 60
        while int(_gst_snapshot(g0)[1]) < gst:
            if time.perf_counter() > deadline:
                raise AssertionError("G1's heartbeats never lifted G0's "
                                     "GST")
            time.sleep(0.01)
        while g1.txm.commit_counter < rounds[1]:
            g1.update_objects([(("g1own", n), "counter_pn", "b",
                                ("increment", 1))])
            n += 1
        full = want_at(rounds[1])
        if norm(_read_all(g1, objs)) != full:
            raise AssertionError("G1's reads past both rounds are not "
                                 "whole")
        return {"keys": n_keys, "counters": n_ctrs, "g0_txns": rounds[1],
                "rounds_end": rounds, "gst": gst, "g1_commits": n,
                "stale_keys": int((stamp[1] > gst).sum()
                                  + (cstamp[1] > gst).sum()),
                "gst_read_s": read_s,
                "seconds": time.perf_counter() - t0}
    finally:
        _ix_close(dcs)


def flash_worker(argv) -> int:
    """One shopper process of the flash sale against ONE DC: ``threads``
    closed loops of single-unit ``counter_b`` decrements on lane ``lane``
    over Zipf(1.0) SKUs for ``duration`` seconds; a typed
    ``insufficient_rights`` refusal moves on (restocking is the escrow
    loop's job).  Prints the counts and the acknowledged units a SKU as
    one JSON line."""
    import threading

    from antidote_tpu_torch.proto.client import (AntidoteClient,
                                                 RemoteAbort, RemoteBusy,
                                                 RemoteInsufficientRights)

    host, port, skus, threads, lane, seed, duration = argv
    port, skus, threads, lane, seed = (int(port), int(skus), int(threads),
                                       int(lane), int(seed))
    cdf = _zipf_cdf(skus)
    stop = time.perf_counter() + float(duration)
    acked = [0] * threads
    refused = [0] * threads
    busy = [0] * threads
    aborts = [0] * threads
    per_sku: list = [{} for _ in range(threads)]
    errs = []

    def worker(i):
        rng = np.random.default_rng(seed + i)
        try:
            c = AntidoteClient(host, port, timeout=60)
            while time.perf_counter() < stop:
                r = int(np.searchsorted(cdf, rng.random()))
                try:
                    c.update_objects([(f"fs{r}", "counter_b", "b",
                                       ("decrement", (1, lane)))])
                except RemoteInsufficientRights:
                    refused[i] += 1
                    continue
                except RemoteBusy as e:
                    busy[i] += 1
                    time.sleep(min(e.retry_after_ms, 50.0) / 1e3)
                    continue
                except RemoteAbort:
                    aborts[i] += 1
                    continue
                acked[i] += 1
                per_sku[i][r] = per_sku[i].get(r, 0) + 1
            c.close()
        except Exception as e:  # noqa: BLE001 — reported, fatal upstream
            errs.append(repr(e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(float(duration) + 120)
    tot: dict = {}
    for d in per_sku:
        for r, k in d.items():
            tot[str(r)] = tot.get(str(r), 0) + k
    print(json.dumps({"acked": sum(acked), "refused": sum(refused),
                      "busy": sum(busy), "aborts": sum(aborts),
                      "per_sku": tot, "errs": errs,
                      "alive": sum(t.is_alive() for t in ts)}), flush=True)
    return 0


def _ix_flash_sale(dcs, clients, skus, inventory, shoppers, storm_s) -> dict:
    """``bench_wire.py``'s flash sale (``FLASH_SALE``) on DC0 and DC1 with
    their escrow loops running: each DC mints half of every SKU's
    inventory on its own lane, then ``shoppers`` shopper threads a DC (one
    client process each) decrement their own lane for ``storm_s`` seconds.
    Checks: no SKU acknowledged past its inventory; every SKU converges to
    inventory - acknowledged at both DCs.  The storm's refusals, transfer
    requests and grants are figures: both lanes drain the hot SKUs
    together, so most asks find no rights left.  Then ``_ix_one_grant``
    checks a typed refusal, a request and a grant that must arrive."""
    half = inventory // 2
    t0 = time.perf_counter()
    for dc in (0, 1):
        for lo in range(0, skus, FS_MINT_BATCH):
            clients[dc].update_objects([
                (f"fs{r}", "counter_b", "b", ("increment", (half, dc)))
                for r in range(lo, min(lo + FS_MINT_BATCH, skus))])
    mint_s = time.perf_counter() - t0
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--flash-worker",
         dcs[dc]["srv"].host, str(dcs[dc]["srv"].port), str(skus),
         str(shoppers), str(dc), str(3000 + 111 * dc), str(storm_s)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for dc in (0, 1)]
    res = []
    try:
        for p in procs:
            res.append(_read_line(p, storm_s + 300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
    if any(r["errs"] or r["alive"] for r in res):
        raise AssertionError(f"shopper errors: {[r['errs'][:3] for r in res]}")
    per_sku: dict = {}
    for r in res:
        for k, n in r["per_sku"].items():
            per_sku[int(k)] = per_sku.get(int(k), 0) + n
    over = {k: n for k, n in per_sku.items() if n > 2 * half}
    if over:
        raise AssertionError(f"OVERSELL: {sorted(over.items())[:5]}")
    # every SKU converges to inventory - acked at both DCs
    t_a = time.perf_counter()
    expect = [2 * half - per_sku.get(r, 0) for r in range(skus)]
    objs = [(f"fs{r}", "counter_b", "b") for r in range(skus)]
    while True:
        got = [[v for lo in range(0, skus, 2048)
                for v in c.read_objects(objs[lo:lo + 2048])[0]]
               for c in clients[:2]]
        if got[0] == expect and got[1] == expect:
            break
        if time.perf_counter() - t_a > 120:
            dc = 0 if got[0] != expect else 1
            r = next(i for i, (a, b) in enumerate(zip(got[dc], expect))
                     if a != b)
            raise AssertionError(f"flash sale: dc{dc} reads sku {r} as "
                                 f"{got[dc][r]}, want {expect[r]}")
        time.sleep(0.1)
    esc = [c.node_status()["escrow"] for c in clients[:2]]
    grants: dict = {}
    for e in esc:
        for role, v in e["grants"].items():
            grants[role] = grants.get(role, 0) + v
    sent = sum(e["requests_sent_total"] for e in esc)
    refused = sum(r["refused"] for r in res)
    acked = sum(r["acked"] for r in res)
    return {"skus": skus, "inventory": 2 * half, "shoppers_per_dc": shoppers,
            "storm_s": storm_s, "mint_s": mint_s, "acked": acked,
            "acked_s": acked / storm_s, "refused": refused,
            "busy": sum(r["busy"] for r in res),
            "aborts": sum(r["aborts"] for r in res),
            "skus_drained": sum(1 for n in per_sku.values()
                                if n >= 2 * half),
            "oversold_skus": 0, "converge_s": time.perf_counter() - t_a,
            "transfer": {"requests_sent": sent, "grants": grants},
            "one_grant": _ix_one_grant(clients)}


def _ix_one_grant(clients, timeout=60.0) -> dict:
    """A grant that must arrive: DC0 mints 10 units of a fresh SKU on its
    own lane; DC1 reads them at DC0's clock but holds no rights, so its
    decrement of 4 is refused typed and queued; DC1's escrow loop asks DC0,
    whose grant commits and replicates back, and DC1's retried decrement is
    acknowledged.  Both DCs then read 6 at its clock."""
    from antidote_tpu_torch.proto.client import RemoteInsufficientRights

    obj = ("fs-grant", "counter_b", "b")
    before = clients[1].node_status()["escrow"]
    vc = clients[0].update_objects([(*obj, ("increment", (10, 0)))])
    vals, vc = clients[1].read_objects([obj], clock=vc)
    if vals != [10]:
        raise AssertionError(f"one grant: dc1 reads {vals}, want [10]")
    t0 = time.perf_counter()
    refused = 0
    while True:
        try:
            vc = clients[1].update_objects(
                [(*obj, ("decrement", (4, 1)))], clock=vc)
            break
        except RemoteInsufficientRights:
            refused += 1
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"one grant: no rights reached dc1 in "
                                 f"{timeout} s ({refused} refusals)")
        time.sleep(0.05)
    grant_s = time.perf_counter() - t0
    if not refused:
        raise AssertionError("one grant: dc1 decremented rights it never "
                             "held (no typed insufficient_rights refusal)")
    for i, c in enumerate(clients[:2]):
        vals, _ = c.read_objects([obj], clock=vc)
        if vals != [6]:
            raise AssertionError(f"one grant: dc{i} reads {vals}, want [6]")
    after = clients[1].node_status()["escrow"]
    sent = after["requests_sent_total"] - before["requests_sent_total"]
    got = (after["grants"].get("requester", 0)
           - before["grants"].get("requester", 0))
    if sent <= 0 or got <= 0:
        raise AssertionError(f"one grant: {sent} requests, {got} grants "
                             f"at dc1: {after}")
    return {"refusals": refused, "requests_sent": sent, "grants": got,
            "grant_s": grant_s}


def interdc_phase(torch, dev, n_keys=IX_KEYS, threads=IX_THREADS,
                  warm_s=IX_WARM_S, window_s=IX_WINDOW_S, sample=WI_SAMPLE,
                  gr_keys=IX_GR_KEYS, gr_ctrs=IX_GR_CTRS, skus=FS_SKUS,
                  inventory=FS_INVENTORY, shoppers=FS_SHOPPERS,
                  storm_s=FS_STORM_S) -> dict:
    """Inter-DC replication between three single-node DCs on the card,
    at BASELINE's widths: each an ``AntidoteNode`` with its own
    ``TcpFabric`` (the native receive pump) and its own
    ``ProtocolServer(interdc=...)``, bootstrapped into a mesh over the
    wire in both dialects.  ``n_keys`` ``set_aw`` keys populated through
    DC0's manager replicate to the peers over the sockets; the geo load
    (``bench_wire.py`` config 3's mix at all three DCs at once, with the
    visibility lag of probe writes); after the heartbeats converge, every
    acknowledged write and ``sample`` other keys equal at all three DCs
    and to a host model, a causal chain across the three, concurrent
    counters summing exactly, an injected drop repaired by catch-up; then
    GentleRain on a pair of its own and the flash sale on DC0 and DC1."""
    import shutil
    import tempfile

    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.obs.metrics import net_metrics
    from antidote_tpu_torch.proto.client import AntidoteClient

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=max(1024, n_keys // 8))
    # each DC logs, as a deployed replica does: a read at the stable
    # snapshot of a key that remote and local writes keep folding (the
    # Zipf head) can fall below the device's retained versions, and only
    # the log serves it (without one the store raises, in both packages)
    log_root = tempfile.mkdtemp(prefix="antidote_interdc_")
    out: dict = {"dcs": 3, "config": "n_shards=8, max_dcs=4, ops_per_key=16, "
                 "snap_versions=2, set_slots=16"}
    nm = net_metrics()
    shed0 = nm.ingress_shed.value()
    rec0 = sum(nm.reconnects.snapshot().values())
    t0 = time.perf_counter()
    dcs = _ix_mesh(dev, cfg, 3, log_root=log_root)
    clients = []
    try:
        clients = [AntidoteClient(d["srv"].host, d["srv"].port, timeout=120)
                   for d in dcs]
        out["bootstrap"] = _ix_bootstrap(dcs, clients)
        out["setup_s"] = time.perf_counter() - t0
        # ---- 1. the populate through DC0's manager ---------------------
        out["populate"], model = _ix_populate(dcs, n_keys, 137)
        log(f"interdc: populate {json.dumps(out['populate'])}")
        # ---- 2. the geo load -------------------------------------------
        out["load"], out["busy"], acked = _ix_load(
            torch, dcs, n_keys, threads, warm_s, window_s)
        log(f"interdc: load {json.dumps(out['load'])}")
        # ---- 3. converged: equal at every DC and to the host model -----
        join = np.zeros(D, np.int64)
        for a in acked:
            join = np.maximum(join, np.asarray(a[3], np.int64))
        out["converge_s"] = _ix_converged(dcs, join)
        out["check"], _t, _j = _wire_readback(
            clients[0], model, acked, (), np.zeros(D, np.int64), n_keys,
            sample, 139, peers=clients[1:])
        out["causal"] = _ix_causal_and_counters(dcs, clients)
        out["drop"] = _ix_drop_repaired(dcs, clients)
        stats = [d["fabric"].native_stats() for d in dcs]
        if any(s is None for s in stats):
            raise AssertionError("a fabric runs without the native pump")
        out["replication"] = {
            "max_gate_depth": max(d["rep"].max_gate_depth for d in dcs),
            "catchups": sum(d["rep"].catchups for d in dcs),
            "ingress_shed": nm.ingress_shed.value() - shed0,
            "reconnects": sum(nm.reconnects.snapshot().values()) - rec0,
            "pump_frames_per_take": sum(s["frames"] for s in stats)
            / max(1, sum(s["takes"] for s in stats))}
        # ---- 4. the flash sale on DC0 and DC1 --------------------------
        out["flash_sale"] = _ix_flash_sale(dcs, clients, skus, inventory,
                                           shoppers, storm_s)
        log(f"interdc: flash sale {json.dumps(out['flash_sale'])}")
    finally:
        for c in clients:
            c.close()
        _ix_close(dcs)
        shutil.rmtree(log_root, ignore_errors=True)
    # ---- 5. GentleRain on a pair of its own -----------------------------
    out["gentlerain"] = _ix_gentlerain(torch, dev, gr_keys, gr_ctrs)
    return out


# ---------------------------------------------------------------------------
# the follower phase
# ---------------------------------------------------------------------------
def _fo_node(dev, cfg, log_dir, recover=False):
    from antidote_tpu_torch.api import AntidoteNode

    return AntidoteNode(cfg, dc_id=0, device=dev, log_dir=log_dir,
                        recover=recover)


def _fo_follower(dev, cfg, log_dir, owner_srv, desc, name, fid,
                 recover=False) -> dict:
    """One follower of the owner: an ``AntidoteNode`` on ``dev`` logging to
    ``log_dir``, its own ``TcpFabric`` (the native pump) and pump loop, a
    ``FollowerReplica`` with a ``ProtocolServer(follower=...)`` on the
    native front end, attached by the owner's descriptor over TCP."""
    from antidote_tpu_torch.interdc import FollowerReplica
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.server import ProtocolServer

    node = _fo_node(dev, cfg, log_dir, recover=recover)
    fabric = TcpFabric()
    fol = FollowerReplica(node, fabric, name, fabric_id=fid,
                          owner_client_addr=(owner_srv.host,
                                             owner_srv.port))
    srv = ProtocolServer(node, port=0, follower=fol, native_frontend=True)
    fol.client_addr = (srv.host, srv.port)
    t0 = time.perf_counter()
    mode = fol.attach(desc)
    attach_s = time.perf_counter() - t0
    loop = fabric.start_pump_loop(f"follower-pump-{name}")
    return {"node": node, "fab": fabric, "fol": fol, "srv": srv,
            "loop": loop, "mode": mode, "attach_s": attach_s,
            "addr": (srv.host, srv.port)}


def _fo_close(f) -> None:
    f["loop"].stop()
    f["srv"].close()
    f["fab"].close()
    f["node"].close()


def _fo_populate(node, n_keys, n_ctrs, seed) -> tuple:
    """``n_keys`` ``set_aw`` keys (one add each from the ``SV_POOL``
    values; a tenth of them get a second add and the first removed) and
    ``n_ctrs`` ``counter_pn`` keys through the owner's manager, in
    transactions of ``IX_TXN_KEYS`` keys and commit groups of
    ``IX_GROUP``.  Returns the figures and the host model of the sets."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, SV_POOL, (n_keys, 2))
    model = [{int(v)} for v in vals[:, 0].tolist()]
    re = rng.choice(n_keys, n_keys // 10, replace=False)
    t0 = time.perf_counter()
    records = 0
    rounds = [[(int(k), "set_aw", "b", ("add", int(vals[k, 0])))
               for k in rng.permutation(n_keys).tolist()],
              [(int(k), "set_aw", "b", ("add", int(vals[k, 1])))
               for k in re.tolist()],
              [(int(k), "set_aw", "b", ("remove", int(vals[k, 0])))
               for k in re.tolist()],
              [(f"c{k}", "counter_pn", "b", ("increment", k % 97 + 1))
               for k in range(n_ctrs)]]
    for ups in rounds:
        txns = [ups[lo:lo + IX_TXN_KEYS]
                for lo in range(0, len(ups), IX_TXN_KEYS)]
        for g in range(0, len(txns), IX_GROUP):
            _commit_group(node, txns[g:g + IX_GROUP])
        records += len(ups)
    for k in re.tolist():
        # the remove observes every tag of the first add's element, the
        # second add's too when both adds drew the same element
        model[k] = {int(vals[k, 1])} - {int(vals[k, 0])}
    s = time.perf_counter() - t0
    return {"set_keys": n_keys, "counter_keys": n_ctrs, "records": records,
            "seconds": s, "records_s": records / s}, model


def _fo_tail_keys(n_keys, n):
    """The tail's ``set_aw`` keys: the Zipf ranking's coldest, which the
    load seldom touches, so reads at a token inside the tail fold rings
    that the load did not wrap."""
    return list(range(n_keys - n, n_keys))


def _fo_tail(node, model, keys, n_ctrs, r) -> None:
    """One tail round, written after the image: each of ``keys`` gets an
    add (into the host ``model`` too) and as many counters an increment."""
    ups = [(k, "set_aw", "b", ("add", SV_POOL + r)) for k in keys]
    for k in keys:
        model[k].add(SV_POOL + r)
    ups += [(f"c{k}", "counter_pn", "b", ("increment", r + 1))
            for k in range(min(len(keys), n_ctrs))]
    _commit_group(node, [ups[lo:lo + IX_TXN_KEYS]
                         for lo in range(0, len(ups), IX_TXN_KEYS)])


def _fo_wait(fs, clock, timeout=120.0) -> float:
    """Seconds until every follower has applied ``clock`` on every shard
    (bounded)."""
    t0 = time.perf_counter()
    want = np.asarray(clock, np.int64)
    while not all((f["node"].store.applied_vc >= want).all() for f in fs):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(
                f"followers never applied {clock}: "
                f"{[f['node'].store.dc_max_vc().tolist() for f in fs]}")
        time.sleep(0.01)
    return time.perf_counter() - t0


class _Local:
    """A client whose reads a follower must serve itself: ``proxied``
    marks them as having crossed one hop, so the follower answers from
    its own tables (behind its token gate) and never proxies them."""

    def __init__(self, c):
        self.c = c

    def read_objects(self, objs, clock=None):
        return self.c.read_objects(objs, clock=clock, proxied=True)


def _fo_load(torch, fs, owner_addr, n_keys, threads, warm_s,
             window_s) -> tuple:
    """``bench_wire.py`` config 3's mix (90% reads, Zipf(1.0), 80% of
    updates adds) over the fleet: ``threads`` workers, each a
    ``SessionClient`` whose write endpoint is a follower (the writes are
    forwarded to the owner) and whose reads route over the two followers'
    ring; an untimed round, a timed window, then (on a card) the card's
    busy share over 2 s of the same load.  Every read must cover the
    session's own writes (read-your-writes) — the session token rides
    every request."""
    import threading

    from antidote_tpu_torch.proto.client import AntidoteClient, SessionClient

    stop = threading.Event()
    timing = threading.Event()
    errs, acked, lat_r, lat_u = [], [], [], []
    ryw = [0]

    def counts():
        return [dict(f["srv"].proxy.counts) for f in fs], [
            (f["node"].metrics.session_redirects.value(
                kind="lagging", dialect="native")) for f in fs]

    def worker(w):
        rng = np.random.default_rng(7000 + w)
        # writes enter at a follower, which forwards them to the owner;
        # their clocks fold into the session's token, which rides every
        # read over the followers' ring
        fc = AntidoteClient(*fs[w % len(fs)]["addr"], timeout=120)
        sc = SessionClient(owner_addr, [f["addr"] for f in fs],
                           timeout=120, seed=w)
        mine: dict = {}
        try:
            while not stop.is_set():
                k = int(zipf_keys(rng, n_keys, 1)[0])
                t0 = time.monotonic()
                if rng.random() < WI_READ_FRAC:
                    v, _ = sc.read_objects([(k, "set_aw", "b")])
                    if timing.is_set():
                        lat_r.append((time.monotonic() - t0) * 1e3)
                    if k in mine and mine[k][0] == "add" \
                            and mine[k][1] not in v[0]:
                        raise AssertionError(
                            f"read-your-writes broken on key {k}")
                    ryw[0] += k in mine
                    continue
                op = "add" if rng.random() < 0.8 else "remove"
                elem = int(rng.integers(1 << 30))
                vc = fc.update_objects([(k, "set_aw", "b", (op, elem))],
                                       clock=sc.token)
                sc.observe(vc)
                if timing.is_set():
                    lat_u.append((time.monotonic() - t0) * 1e3)
                mine[k] = (op, elem)
                acked.append((k, op, elem, [int(x) for x in vc]))
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errs.append(e)
        finally:
            sc.close()
            fc.close()
            with lock:
                stats.append(sc.stats())

    lock = threading.Lock()
    stats: list = []
    ws = [threading.Thread(target=worker, args=(w,), name=f"fo-load-{w}")
          for w in range(threads)]
    for t in ws:
        t.start()
    time.sleep(warm_s)
    pre = counts()
    n0 = len(lat_r) + len(lat_u)
    timing.set()
    time.sleep(window_s)
    timing.clear()
    post = counts()
    n_ops = len(lat_r) + len(lat_u) - n0

    def quiesce():
        # the workers' forwarded writes wait at most the proxy's 5 s for
        # the owner, which shares this interpreter with the profiler
        stop.set()
        for t in ws:
            t.join(120)

    busy = (_busy_window(torch, 2.0, quiesce)
            if fs[0]["node"].store.device.type == "cuda" else {})
    quiesce()
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ws):
        raise AssertionError("a load worker never stopped")
    proxied = sum(b["read"] - a["read"] for a, b in zip(pre[0], post[0]))
    lagging = sum(b - a for a, b in zip(pre[1], post[1]))
    reads = len(lat_r)
    client_redirects = sum(s["redirects"] for s in stats)
    load = {"threads": threads, "warm_s": warm_s, "window_s": window_s,
            "ops_s": n_ops / window_s,
            "read_ms": _ms_pcts(lat_r), "update_ms": _ms_pcts(lat_u),
            "reads": reads, "updates": len(lat_u),
            "reads_local": reads - proxied - client_redirects,
            "reads_proxied": proxied,
            "reads_redirected_lagging": lagging,
            "client_redirects": client_redirects,
            "client_failovers": sum(s["failovers"] for s in stats),
            "writes_forwarded": sum(b["write"] - a["write"]
                                    for a, b in zip(pre[0], post[0])),
            "ryw_reads_checked": ryw[0]}
    return load, busy, acked


def _fo_session_reads(fs, owner, objs, token) -> dict:
    """Reads at ``token`` (a clock between the image and the tail's end)
    on each follower and on the owner, through a transaction whose
    snapshot is the token: the rows written after it fold their rings
    (``set_aw_fold``, ``counter_fold``) on every side, and each follower
    answers what the owner does."""
    want = _read_all(owner, objs, vc=token, batch=4096)
    for i, f in enumerate(fs):
        got = _read_all(f["node"], objs, vc=token, batch=4096)
        if [sorted(v) if isinstance(v, list) else v for v in got] != [
                sorted(v) if isinstance(v, list) else v for v in want]:
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(
                f"follower {i + 1} reads {objs[j]} at the token as "
                f"{got[j]!r}, the owner {want[j]!r}")
    return {"keys": len(objs), "token": [int(x) for x in token]}


def _fo_divergence(fs, timeout=60.0) -> dict:
    """``check_divergence`` on every shard of each follower until every
    shard compares ``ok`` at equal clocks (a ``skipped`` shard — clocks
    unequal while pings land — is retried; a ``mismatch`` fails)."""
    out = {}
    t0 = time.perf_counter()
    for i, f in enumerate(fs):
        todo = list(range(f["node"].cfg.n_shards))
        while todo:
            res = f["fol"].check_divergence(todo)
            if "mismatch" in res.values():
                raise AssertionError(f"follower {i + 1} diverged: {res}")
            todo = [s for s, r in res.items() if r != "ok"]
            if todo and time.perf_counter() - t0 > timeout:
                raise AssertionError(
                    f"follower {i + 1}: shards {todo} never compared ok")
            if todo:
                time.sleep(0.05)
        out[f"f{i + 1}"] = dict(f["fol"].divergence_counts)
    out["seconds"] = time.perf_counter() - t0
    return out


def _fo_heal(torch, f, owner_c) -> dict:
    """One ``set_aw`` row corrupted on a follower's device: the Merkle walk
    finds it, only its leaf is fetched and re-installed, and the follower
    reads the owner's value again."""
    from antidote_tpu_torch.store.merkle import LEAVES

    node = f["node"]
    dk = next(dk for dk, ent in node.store.directory.items()
              if ent[0].startswith("set_aw") and isinstance(dk[0], int))
    tname, shard, row = node.store.directory[dk]
    t = node.store.tables[tname]
    with node.txm.commit_lock:
        t.head["addvc"][shard, row] = 0  # every element reads absent
        node.store.drop_cached_value(dk)
    before = f["fol"].healed_leaves
    t0 = time.perf_counter()
    deadline = t0 + 60
    while True:
        # a shard whose clock a ping is moving compares "skipped": retry
        res = f["fol"].check_divergence([shard])
        if res[shard] not in ("skipped", "unreachable") \
                or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    heal_s = time.perf_counter() - t0
    obj = [(dk[0], "set_aw", dk[1])]
    want, vc = owner_c.read_objects(obj)
    got = _read_all(node, obj, vc=vc)
    if res[shard] != "mismatch" or sorted(got[0]) != sorted(want[0]):
        raise AssertionError(f"the corrupted row was not healed: {res}, "
                             f"{got} against {want}")
    m = node.metrics
    return {"shard": shard, "result": res[shard],
            "leaves_fetched": f["fol"].healed_leaves - before,
            "leaves_per_shard": LEAVES, "seconds": heal_s,
            "range_heals": m.divergence_heals.value(mode="range"),
            "image_heals": m.divergence_heals.value(mode="image")}


def _fo_forward_fault(f, owner_addr) -> dict:
    """Every forwarding attempt of one write killed at the ``proxy.forward``
    site: the client gets the typed not_owner redirect naming the owner —
    and the write did not happen; with the plan gone it forwards again."""
    from antidote_tpu_torch import faults
    from antidote_tpu_torch.proto.client import (AntidoteClient,
                                                 RemoteNotOwner)
    from antidote_tpu_torch.proto.proxy import ProxyPlane

    c = AntidoteClient(*f["addr"], timeout=120)
    key = ("fo-fault", 0)
    try:
        faults.install(faults.FaultPlan(seed=5).error(
            "proxy.forward", key=f"{owner_addr[0]}:{owner_addr[1]}",
            times=ProxyPlane.FORWARD_ATTEMPTS))
        try:
            c.update_objects([(key, "counter_pn", "b", ("increment", 1))])
        except RemoteNotOwner as e:
            typed = {"error": "not_owner", "redirect": e.redirect}
        else:
            raise AssertionError("a forward with every attempt faulted "
                                 "was acknowledged")
        finally:
            faults.uninstall()
        vc = c.update_objects([(key, "counter_pn", "b", ("increment", 1))])
        v, _ = c.read_objects([(key, "counter_pn", "b")], clock=vc)
        if v != [1]:
            raise AssertionError(f"the refused forward executed: {v}")
    finally:
        c.close()
    if typed["redirect"] != list(owner_addr):
        raise AssertionError(f"redirect {typed} is not the owner")
    return typed


def _fo_restart(dev, cfg, fs, owner_srv, desc, log_dirs, keys) -> tuple:
    """Follower 1 closed and restarted from its own directory (it rejoins
    in mode ``tail``) while a session client keeps writing at the owner
    and reading over the fleet: every read covers the session's writes.
    Returns the figures and the new follower."""
    import threading

    from antidote_tpu_torch.proto.client import SessionClient

    from antidote_tpu_torch.proto.client import RemoteError

    stop = threading.Event()
    errs, pairs, retried = [], [0], [0]
    sc = SessionClient((owner_srv.host, owner_srv.port),
                       [f["addr"] for f in fs], timeout=120, seed=99)

    def read(k):
        for _attempt in range(3):
            try:
                return sc.read_objects([(k, "set_aw", "b")])[0]
            except RemoteError as e:
                # the closing follower answered an in-flight read with
                # its shutdown error: reads are idempotent, read again
                if "shutting down" not in str(e):
                    raise
                retried[0] += 1
        raise AssertionError("a read failed three times across the "
                             "restart")

    def session():
        n = 0
        try:
            while not stop.is_set():
                k = keys[n % len(keys)]
                sc.update_objects([(k, "set_aw", "b", ("add", n))])
                v = read(k)
                if n not in v[0]:
                    raise AssertionError(
                        f"read-your-writes broken across the restart: "
                        f"{n} not in {k}")
                n += 1
                pairs[0] = n
        except Exception as e:  # noqa: BLE001 — fatal, raised below
            errs.append(e)

    t = threading.Thread(target=session, name="fo-session")
    t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    _fo_close(fs[0])
    close_s = time.perf_counter() - t0
    nf = _fo_follower(dev, cfg, log_dirs[0], owner_srv, desc, "f1", 401,
                      recover=True)
    rejoin_s = time.perf_counter() - t0 - close_s
    # the session's reads come back to the rejoined follower
    served0 = sc.served_by.get(nf["addr"], 0)
    deadline = time.perf_counter() + 60
    sc._set_fleet([nf["addr"], fs[1]["addr"]])
    while sc.served_by.get(nf["addr"], 0) == served0 and not errs:
        if time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    time.sleep(0.5)
    stop.set()
    t.join(120)
    sc.close()
    if errs:
        raise errs[0]
    if nf["mode"] != "tail":
        raise AssertionError(f"the restarted follower bootstrapped in "
                             f"mode {nf['mode']}, not tail")
    return ({"mode": nf["mode"], "close_s": close_s, "rejoin_s": rejoin_s,
             "session_pairs": pairs[0], "redirects": sc.redirects,
             "failovers": sc.failovers, "reads_retried": retried[0],
             "served_by_rejoined": sc.served_by.get(nf["addr"], 0),
             "boot": dict(nf["fol"].boot_stats)}, nf)


def follower_phase(torch, dev, n_keys=FO_KEYS, n_ctrs=FO_CTRS,
                   threads=FO_THREADS, warm_s=IX_WARM_S,
                   window_s=IX_WINDOW_S, sample=WI_SAMPLE,
                   tail_keys=FO_TAIL_KEYS) -> dict:
    """Follower read replicas of one owner on the card, at BASELINE's
    widths: the owner an ``AntidoteNode`` with a WAL, its own
    ``TcpFabric`` (the native pump), a ``DCReplica`` and a
    ``ProtocolServer(interdc=...)`` on the native front end; two followers,
    each a node with its own log directory and fabric, a
    ``FollowerReplica`` attached by descriptor over TCP and a
    ``ProtocolServer(follower=...)``.  ``bench_wire.py`` config 3's
    keyspace (``n_keys`` ``set_aw`` keys) plus ``n_ctrs`` counters
    populated through the owner's manager; a full image, a tail after it;
    both followers bootstrap by image (one injected ``ckpt.ship`` fault on
    the second's first chunk, retried); the config 3 mix over the fleet
    through session clients; every acknowledged write and ``sample``
    untouched keys equal at both followers, the owner and the host model;
    session reads at a token inside the tail equal the owner's (they
    fold); every shard's Merkle root ``ok``; a corrupted row healed by its
    leaf; a ``proxy.forward`` fault surfacing typed; follower 1 restarted
    from its directory in mode ``tail`` under a session."""
    import shutil
    import tempfile

    from antidote_tpu_torch import faults
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.interdc import DCReplica
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=max(1024, (n_keys + n_ctrs) // 8
                                            + 1024))
    root = tempfile.mkdtemp(prefix="antidote_follower_")
    out: dict = {"config": "n_shards=8, max_dcs=4, ops_per_key=16, "
                           "snap_versions=2, set_slots=16", "followers": 2}
    owner = _fo_node(dev, cfg, os.path.join(root, "owner"))
    ofab = TcpFabric()
    orep = DCReplica(owner, ofab, "dc0")
    osrv = ProtocolServer(owner, port=0, interdc=orep, native_frontend=True)
    oloop = ofab.start_pump_loop("owner-pump")
    oc = AntidoteClient(osrv.host, osrv.port, timeout=120)
    fs: list = []
    log_dirs = [os.path.join(root, f"f{i}") for i in (1, 2)]
    try:
        # ---- 1. populate, image, tail; both followers bootstrap --------
        out["populate"], model = _fo_populate(owner, n_keys, n_ctrs, 211)
        t0 = time.perf_counter()
        man = owner.checkpoint_now(full=True)
        out["image"] = {"id": man["id"], "mb": man["image_bytes"] / 1e6,
                        "seconds": time.perf_counter() - t0}
        tkeys = _fo_tail_keys(n_keys, tail_keys)
        _fo_tail(owner, model, tkeys, n_ctrs, 0)
        token = [int(x) for x in owner.store.dc_max_vc()]
        _fo_tail(owner, model, tkeys, n_ctrs, 1)
        log(f"follower: populate {json.dumps(out['populate'])}, image "
            f"{json.dumps(out['image'])}")
        desc = oc.get_connection_descriptor()
        fs.append(_fo_follower(dev, cfg, log_dirs[0], osrv, desc, "f1", 301))
        inj = faults.install(faults.FaultPlan(seed=11).error(
            "ckpt.ship", key=f"ckpt_{man['id']}", times=1))
        try:
            fs.append(_fo_follower(dev, cfg, log_dirs[1], osrv, desc, "f2",
                                   302))
        finally:
            faults.uninstall()
        shipped_faults = inj.fired("ckpt.ship")
        if shipped_faults != 1:
            raise AssertionError(f"the ckpt.ship fault fired "
                                 f"{shipped_faults} times, not once")
        out["bootstrap"] = {}
        for i, f in enumerate(fs):
            b = dict(f["fol"].boot_stats)
            out["bootstrap"][f"f{i + 1}"] = {
                "mode": f["mode"], "attach_s": f["attach_s"],
                "ship_mb": b["ship_bytes"] / 1e6, "ship_s": b["ship_s"],
                "ship_mb_s": b["ship_bytes"] / 1e6 / b["ship_s"],
                "install_s": b["install_s"],
                "local_checkpoint_s": b["local_checkpoint_s"],
                "catch_up_s": b["catch_up_s"]}
            if f["mode"] != "image":
                raise AssertionError(f"follower {i + 1} bootstrapped in "
                                     f"mode {f['mode']}")
        out["ckpt_ship_fault"] = {
            "injected": 1, "fired": shipped_faults,
            "retried_to": fs[1]["mode"]}
        log(f"follower: bootstrap {json.dumps(out['bootstrap'])}")
        # ---- 2. the config 3 mix over the fleet -------------------------
        out["load"], out["busy"], acked = _fo_load(
            torch, fs, (osrv.host, osrv.port), n_keys, threads, warm_s,
            window_s)
        log(f"follower: load {json.dumps(out['load'])}")
        # ---- 3. checks ----------------------------------------------------
        join = np.zeros(D, np.int64)
        for a in acked:
            join = np.maximum(join, np.asarray(a[3], np.int64))
        out["converge_s"] = _fo_wait(fs, join)
        peers = [AntidoteClient(*f["addr"], timeout=120) for f in fs]
        try:
            out["check"], _t, _j = _wire_readback(
                oc, model, acked, (), np.zeros(D, np.int64), n_keys,
                sample, 223, peers=[_Local(c) for c in peers])
        finally:
            for c in peers:
                c.close()
        objs = ([(k, "set_aw", "b") for k in tkeys]
                + [(f"c{k}", "counter_pn", "b")
                   for k in range(min(tail_keys, n_ctrs))])
        out["session_reads"] = _fo_session_reads(fs, owner, objs, token)
        out["divergence"] = _fo_divergence(fs)
        # ---- 4. faults ------------------------------------------------------
        out["heal"] = _fo_heal(torch, fs[1], oc)
        out["proxy_forward_fault"] = _fo_forward_fault(
            fs[0], (osrv.host, osrv.port))
        out["restart"], nf = _fo_restart(
            dev, cfg, fs, osrv, desc, log_dirs,
            [("fo-ryw", i) for i in range(16)])
        fs[0] = nf
        log(f"follower: restart {json.dumps(out['restart'])}")
        out["replicas"] = orep.replica_status()["followers"]
    finally:
        faults.uninstall()
        oc.close()
        for f in fs:
            _fo_close(f)
        oloop.stop()
        osrv.close()
        ofab.close()
        owner.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the cluster's durability and crash takeover
# ---------------------------------------------------------------------------
def _tk_crash(m) -> None:
    """A member's death inside this process: its RPC server stops and its
    logs close without a clean shutdown (a failpoint's ``os._exit`` would
    end the script itself; those run only in member processes)."""
    m.rpc.close()
    if m.node.checkpointer is not None:
        m.node.checkpointer.stop()
    m.node.store.log.close()
    m._prep_wal.close()


def _tk_wire(members) -> None:
    for m in members:
        for p in members:
            if p is not m:
                m.connect(p.member_id, *p.address)


def _tk_wedge(coord, updates, seq=True):
    """A coordinator that dies after sequencing (``seq``) or before it:
    prepare at every owner, take the ts, stop — the crash of
    ``tests/test_takeover.py``'s helper.  Returns (txn, ts, prev)."""
    from antidote_tpu_torch.cluster.rpc import eff_to_wire
    from antidote_tpu_torch.store.kv import key_to_shard

    coord.member.invalidate_seq_cache()
    txn = coord.start_transaction()
    coord._update(updates, txn)
    by_owner, shards = {}, set()
    for eff in txn.writeset:
        shard = key_to_shard(eff.key, eff.bucket, coord.cfg.n_shards)
        shards.add(shard)
        by_owner.setdefault(coord._owner_of_shard(shard), []).append(eff)
    snap = int(txn.snapshot_vc[coord.dc_id])
    for owner, effs in by_owner.items():
        wires = [eff_to_wire(e) for e in effs]
        if owner is None:
            coord.member.m_prepare(txn.txid, wires, snap)
        else:
            coord.member.peers[owner].call("m_prepare", txn.txid, wires,
                                           snap)
    if not seq:
        return txn, None, None
    ts, prev = coord._seq(sorted(shards), txn.txid)
    return txn, int(ts), {int(k): int(v) for k, v in prev.items()}


def _tk_cfg(n_shards):
    """The takeover phase's configuration: the cluster phase's widths."""
    from antidote_tpu_torch.config import AntidoteConfig

    return AntidoteConfig(n_shards=n_shards, max_dcs=D, ops_per_key=K,
                          snap_versions=2, set_slots=E, keys_per_table=128)


def live_follower_worker(argv) -> int:
    """The live segment's follower of the clustered owner, in a process of
    its own as a deployment runs one: an ``AntidoteNode`` on ``device``
    logging to ``log_dir``, its own ``TcpFabric`` and pump loop, and a
    ``FollowerReplica`` attached to the members' descriptors (it composes
    their images), its catch-up requests counted by the member they went
    to.  Prints the attach as one JSON line; then, for the request line on
    stdin (``{"target", "objs", "owners"}``), waits until it has applied
    ``target``, runs its digest on every shard against the shard's owner
    (clock mismatches retried until the deadline), reads ``objs`` at
    ``target`` and checks its routes against ``owners``, and prints that
    as one JSON line with its values and every launch of this process.
    Any error is fatal."""
    import torch

    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.interdc import FollowerReplica
    from antidote_tpu_torch.interdc.messages import Descriptor
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.materializer import cuda_kernels as ck

    device, n_shards, log_dir, descs, timeout = argv
    n_shards, timeout = int(n_shards), float(timeout)
    node = AntidoteNode(_tk_cfg(n_shards), dc_id=0,
                        device=torch.device(device), log_dir=log_dir)
    fabric = TcpFabric()
    fol = FollowerReplica(node, fabric, "live-follower",
                          fabric_id=FollowerReplica.FID_BASE + 1)
    routed: dict = {}
    plain = fabric.query_log

    def counted(target, shard, origin, from_opid):
        routed[target >> 16] = routed.get(target >> 16, 0) + 1
        return plain(target, shard, origin, from_opid)

    fabric.query_log = counted
    t0 = time.perf_counter()
    mode = fol.attach([Descriptor.from_wire(d) for d in json.loads(descs)])
    attach_s = time.perf_counter() - t0
    loop = fabric.start_pump_loop("live-follower-pump")
    at_attach = dict(routed)
    print(json.dumps({"mode": mode, "attach_s": attach_s,
                      "boot": fol.boot_stats, "routed_at_attach": at_attach},
                     default=float), flush=True)
    try:
        req = json.loads(sys.stdin.readline())
        target = np.asarray(req["target"], np.int64)
        out: dict = {"routed_during_leave": {
            m: n - at_attach.get(m, 0) for m, n in sorted(routed.items())}}
        t0 = time.perf_counter()
        while not (node.store.stable_vc() >= target).all():
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(
                    f"the live follower never applied {target.tolist()}: "
                    f"{node.store.stable_vc().tolist()}")
            time.sleep(0.05)
        out["catch_up_s"] = time.perf_counter() - t0
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        pending, rounds = list(range(n_shards)), 0
        while pending:
            rounds += 1
            res = fol.check_divergence(pending)
            bad = {s: r for s, r in res.items() if r in ("mismatch",
                                                         "unsubscribed")}
            if bad:
                raise AssertionError(f"live follower digest: {bad}")
            pending = [s for s, r in res.items() if r != "ok"]
            if pending and time.perf_counter() - t0 > timeout:
                raise AssertionError(
                    f"live follower digest never compared {len(pending)} "
                    f"shards clean: {dict(list(res.items())[:8])}")
        out["digest_s"] = time.perf_counter() - t0
        out["digest_rounds"] = rounds
        out["divergence"] = dict(fol.divergence_counts)
        if fol.divergence_counts.get("mismatch", 0):
            raise AssertionError(f"live follower digest found a mismatch: "
                                 f"{fol.divergence_counts}")
        objs = [tuple(o) for o in req["objs"]]
        t0 = time.perf_counter()
        got = []
        for lo in range(0, len(objs), 8192):
            vals, _ = node.read_objects(objs[lo:lo + 8192], clock=target)
            got += vals
        out["read_s"] = time.perf_counter() - t0
        out["launches"] = {n: v - before[n] for n, v in ck.LAUNCHES.items()}
        out["values"] = [sorted(v) if isinstance(v, list) else v
                         for v in got]
        routes = {}
        for (_o, _s), (owner, epoch) in list(fol.shard_route.items()):
            ent = routes.setdefault(int(owner), [0, 0])
            ent[0] += 1
            ent[1] = max(ent[1], int(epoch))
        out["routes"] = {m: {"shards": n, "max_epoch": e}
                         for m, (n, e) in sorted(routes.items())}
        stale = [s for s in range(n_shards)
                 if fol._route(0, s) >> 16 != req["owners"][s]]
        if stale:
            raise AssertionError(f"the live follower routes {len(stale)} "
                                 f"shards away from their owners: "
                                 f"{stale[:8]}")
        out["process_launches"] = dict(ck.LAUNCHES)
        print(json.dumps(out, default=float), flush=True)
    finally:
        loop.stop()
        fabric.close()
        node.close()
    return 0


def _lf_attach(dev, n_shards, log_dir, reps, timeout=600.0) -> dict:
    """Start the live segment's follower of the clustered owner
    (``live_follower_worker``, a process on ``dev``) on the descriptors of
    ``reps`` and wait for its attach."""
    import subprocess

    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    descs = json.dumps([r.descriptor().to_wire() for r in reps])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--live-follower",
         str(dev), str(n_shards), log_dir, descs, "240"],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    f = {"proc": proc}
    try:
        f.update(_read_line(proc, timeout))
    except BaseException:
        _lf_close(f)
        raise
    f["process_s"] = time.perf_counter() - t0
    return f


def _lf_check(f, members, coord, objs, timeout=600.0) -> dict:
    """After the load: the follower process applies the members' clock, its
    digest is clean on every shard against the shard's owner, its routes
    name each shard's owner, and ``objs`` read through it at the members'
    applied clock equal the owners' values there, read through ``coord``
    (``live_follower_worker``).  Its ``launches`` are its digest's and its
    reads', its ``process_launches`` every launch of its process."""
    proc = f["proc"]
    for m in members:
        m.invalidate_seq_cache()
        m.refresh_peer_clocks()
    target = np.maximum.reduce([np.asarray(m.node.store.dc_max_vc())
                                for m in members])
    owners = {s: m.member_id for m in members for s in m.shards}
    proc.stdin.write(json.dumps({
        "target": [int(x) for x in target],
        "objs": [list(o) for o in objs],
        "owners": [owners[s] for s in range(len(owners))]}) + "\n")
    proc.stdin.flush()
    # the members' clocks keep moving on their ticks while the follower
    # catches up and compares
    deadline = time.monotonic() + timeout
    while not _readable(proc.stdout, 0.05):
        if time.monotonic() > deadline:
            raise AssertionError("the live follower went silent")
        for m in members:
            m.invalidate_seq_cache()
            m.refresh_peer_clocks()
    out = _read_line(proc, 1.0)
    log(f"takeover live: follower applied {target.tolist()} in "
        f"{out['catch_up_s']:.1f} s after the load")
    got = out.pop("values")
    want = []
    for lo in range(0, len(objs), 8192):
        vals, _ = coord.read_objects(objs[lo:lo + 8192], clock=target)
        want += vals
    for o, a, b in zip(objs, got, (sorted(v) if isinstance(v, list) else v
                                   for v in want)):
        if a != b:
            raise AssertionError(f"live follower read of {o[0], o[2]}: "
                                 f"{a!r}, owner {b!r}")
    if len(got) != len(objs):
        raise AssertionError(f"the live follower read {len(got)} of "
                             f"{len(objs)} keys")
    out["keys_read"] = len(objs)
    out["clock"] = [int(x) for x in target]
    return out


def _lf_close(f) -> None:
    proc = f["proc"]
    try:
        proc.stdin.close()
    except OSError:
        pass
    try:
        rc = proc.wait(60)
    except Exception:  # noqa: BLE001 — killed below
        rc = None
    if rc is None:
        proc.kill()
        proc.wait(10)


def takeover_phase(torch, dev, n_set=TK_SET_KEYS, n_ctr=TK_CTR_KEYS,
                   n_shards=CL_SHARDS, chain_txns=TK_CHAIN,
                   mixed=TK_MIXED, sample=TK_SAMPLE, live=True) -> dict:
    """The cluster phase's deployment with durability: 4 members over
    localhost RPC, each an ``AntidoteNode`` on ``dev`` with a log directory
    (``sync_log=False``), ``n_set`` ``set_aw`` keys (3 adds each) and
    ``n_ctr`` ``counter_pn`` keys (2 increments) populated through the
    coordinators in transactions of TK_TXN updates.  Then: a transaction
    spanning all four members wedged after the sequencer with
    ``chain_txns`` commits buffered behind its hole, aborted by member 0's
    ``resolve_wedged`` (the buffered commits drain, the zombie's late
    commit refused); a commit delivered to one owner only, completed at
    every owner by the takeover; member 2 crashed with one undecided
    sequenced prep and one commit logged but not applied, recovered on
    ``dev`` (the prep's lock back, the torn commit re-applied, the prep
    settled); a never-sequenced prepare swept; a checkpoint on every
    member, ``mixed`` timed transactions, member 1's prepare log compacted
    and the member crashed and recovered from its image, the tail and the
    compacted log; the 4 members closed and resized to 3 (``resize_dc``),
    the 3 booted with ``recover=True`` (a member on a retired directory
    refuses) and ``mixed`` timed transactions on them.  After the wedge,
    the rejoin, the image recovery and the resize, every key equals the
    host model at the stable snapshot (through the coordinators), and the
    keys written since the older snapshot plus ``sample`` others at it
    (through the coordinators, whose older reads fold, and, as a check of
    the members' tables on the card, through each member's own store by
    the serving path's resolve); the older snapshot is taken after the
    populate and again after each image (a read below an image's stamp is
    refused).  No entry point of the cluster resolves a set on the card:
    the owners' reads (``m_read_values``) decode sets on the host, as the
    JAX package's do, so the phase's ``orset_presence`` launches are that
    check's, one a member and a check.  Last (``live``), the live segment
    (``live_segment``): its launches are counted from 0, and the result's
    ``takeover_launches`` are the phase's before it."""
    import gc
    import resource
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from antidote_tpu_torch.api import AbortError
    from antidote_tpu_torch.cluster import ClusterMember
    from antidote_tpu_torch.cluster.resize import resize_dc
    from antidote_tpu_torch.log import LogDirMismatch
    from antidote_tpu_torch.log.wal import replay
    from antidote_tpu_torch.materializer import cuda_kernels as ck
    from antidote_tpu_torch.store.kv import key_to_shard

    on_card = torch.device(dev).type == "cuda"
    n_mem, n_new = CL_MEMBERS, TK_NEW_MEMBERS
    # every member's log holds one WAL file a shard: the old members and
    # the new nodes of the resize are open at once
    need = n_shards * (n_mem + n_new) + 4096
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        if hard != resource.RLIM_INFINITY and hard < need:
            raise RuntimeError(f"the takeover phase needs {need} open "
                               f"files; the hard limit is {hard}")
        resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))
    cfg = _tk_cfg(n_shards)
    S, C, Bs, Bc = "set_aw", "counter_pn", "b", "c"
    root = tempfile.mkdtemp(prefix="antidote_takeover_")
    dirs = [os.path.join(root, f"m{i}") for i in range(n_mem)]
    new_dirs = [os.path.join(root, f"n{i}") for i in range(n_new)]
    rng = np.random.default_rng(23)
    smodel = {k: set() for k in range(n_set)}
    cmodel = {k: 0 for k in range(n_ctr)}
    ops = {}  # (key, bucket) -> ring ops written (a full ring is GC'd)
    touched = set()  # (key, bucket) written after the older snapshot
    st = {"aborts_retried": 0, "checks": 0, "old_reads": 0,
          "member_reads": 0, "checks_s": 0.0}
    start_ms, lat_before, lat_after = [], [], []
    members: list = []
    coords: list = []
    member_check_launches: dict = {}

    def note(k, b):
        ops[(k, b)] = ops.get((k, b), 0) + 1
        if old:
            touched.add((k, b))

    def snap_old():
        """Take the older snapshot the checks read at (again after each
        image: a read below an image's stamp is refused by the
        checkpoint's contract), with the host model as of it."""
        settle()
        t = start(0)
        old["vc"] = t.snapshot_vc.copy()
        coords[0].abort_transaction(t)
        old["s"] = {k: set(v) for k, v in smodel.items()}
        old["c"] = dict(cmodel)
        touched.clear()

    def start(c):
        before = ck.LAUNCHES["stable_min"]
        t1 = time.perf_counter()
        t = coords[c].start_transaction()
        start_ms.append((time.perf_counter() - t1) * 1e3)
        if on_card and n_shards >= 2048 and (
                ck.LAUNCHES["stable_min"] == before):
            raise AssertionError("a transaction start did not launch "
                                 "stable_min")
        return t

    def static(c, updates):
        while True:
            t = start(c)
            try:
                coords[c].update_objects(updates, txn=t)
                return coords[c].commit_transaction(t)
            except AbortError:
                st["aborts_retried"] += 1
                coords[c].member.invalidate_seq_cache()

    def settle():
        for m in members:
            m.invalidate_seq_cache()
            m.refresh_peer_clocks()

    def want_of(k, b, model_s, model_c):
        return sorted(model_s[k]) if b == Bs else model_c[k]

    def got_of(v):
        return sorted(v) if isinstance(v, list) else v

    def check(tag, extra_old=()):
        """Every key at the stable snapshot through the coordinators; the
        keys written since the older snapshot plus ``sample`` others (and
        ``extra_old``) at it, through the coordinators and the owning
        members.  The launches of the members' own reads are counted in
        ``member_check_launches``: they are the check's, not the path's."""
        t_check = time.perf_counter()
        settle()
        objs = ([(k, S, Bs) for k in range(n_set)]
                + [(k, C, Bc) for k in range(n_ctr)])
        for i, lo in enumerate(range(0, len(objs), 8192)):
            batch = objs[lo:lo + 8192]
            c = i % len(coords)
            t = start(c)
            vals = coords[c].read_objects(batch, txn=t)
            coords[c].commit_transaction(t)
            for (k, _, b), v in zip(batch, vals):
                if got_of(v) != want_of(k, b, smodel, cmodel):
                    raise AssertionError(
                        f"{tag}: {(k, b)} = {v!r}, model "
                        f"{want_of(k, b, smodel, cmodel)!r}")
        st["checks"] += 1
        hist = sorted(kb for kb in touched if ops[kb] <= K)
        rest = [kb for kb in ((int(k), Bs) for k in
                              rng.choice(n_set, sample, replace=False))
                if kb not in touched]
        seen = set(rest)
        # (the touched ones are in hist already, when their ring holds)
        rest += [kb for kb in extra_old if kb not in touched
                 and kb not in seen]
        hist_objs = [(k, S if b == Bs else C, b) for k, b in hist + rest]
        old_vc, old_s, old_c = old["vc"], old["s"], old["c"]
        t = start(0)
        t.snapshot_vc = old_vc.copy()
        vals = coords[0].read_objects(hist_objs, txn=t)
        coords[0].abort_transaction(t)
        for (k, _, b), v in zip(hist_objs, vals):
            if got_of(v) != want_of(k, b, old_s, old_c):
                raise AssertionError(f"{tag} at the older snapshot: "
                                     f"{(k, b)} = {v!r}")
        st["old_reads"] += len(hist_objs)
        before = dict(ck.LAUNCHES)
        for m in members:
            # the member's own store, through the serving path's device
            # resolve: a check, not the cluster's read path (which decodes
            # sets on the host); its set batch is one orset_presence launch
            own = [o for o in hist_objs
                   if key_to_shard(o[0], o[2], n_shards) in m.shards]
            with m._lock:
                got = m.node.store.read_values_resolved(own, old_vc)
            for (k, _, b), v in zip(own, got):
                if got_of(v) != want_of(k, b, old_s, old_c):
                    raise AssertionError(f"{tag} at member {m.member_id}: "
                                         f"{(k, b)} = {v!r}")
            st["member_reads"] += len(own)
        for n, v in ck.LAUNCHES.items():
            member_check_launches[n] = (member_check_launches.get(n, 0)
                                        + v - before[n])
        st["checks_s"] += time.perf_counter() - t_check

    def mixed_txns(n, lat):
        for i in range(n):
            c, kind = i % len(coords), i % 4
            t1 = time.perf_counter()
            if kind == 0:
                kk = rng.choice(n_set, 4, replace=False).tolist()
                ee = rng.integers(3000, 4000, 4).tolist()
                static(c, [(k, S, Bs, ("add", e)) for k, e in zip(kk, ee)])
                for k, e in zip(kk, ee):
                    smodel[k].add(e)
                    note(k, Bs)
            elif kind == 1:
                kk = [k for k in rng.choice(n_set, 2, replace=False).tolist()
                      if smodel[k]]
                ups = [(k, S, Bs, ("remove", max(smodel[k]))) for k in kk]
                static(c, ups)
                for k, _, _, (_, e) in ups:
                    smodel[k].discard(e)
                    note(k, Bs)
            elif kind == 2:
                kk = rng.choice(n_ctr, 2, replace=False).tolist()
                static(c, [(k, C, Bc, ("increment", 3)) for k in kk])
                for k in kk:
                    cmodel[k] += 3
                    note(k, Bc)
            else:
                kk = rng.choice(n_set, 8, replace=False).tolist()
                t = start(c)
                vals = coords[c].read_objects([(k, S, Bs) for k in kk],
                                              txn=t)
                coords[c].commit_transaction(t)
                for k, v in zip(kk, vals):
                    if sorted(v) != sorted(smodel[k]):
                        raise AssertionError(f"mixed read of {k}: {v!r}")
            lat.append((time.perf_counter() - t1) * 1e3)

    def live_segment(threads=TK_LIVE_THREADS) -> dict:
        """Member 3 boots empty on ``dev`` with its own log and joins, then
        member 1 (a middle id) leaves, one two-phase shard move at a time
        (``cluster/join.py``), while ``threads`` workers commit the phase's
        mixed transactions through coordinators 0-2, each on its own keys
        (no certification conflict between them), every acknowledgement
        in the host model.  Then the refusals (a departed id, member 0's
        leave), one map on every member with owned sets partitioning the
        shards, and the phase's check through the survivors' coordinators,
        the joiner's included, with every key of a moved shard read at the
        snapshot before the join.

        Every member runs its inter-DC endpoint (``attach_interdc`` on one
        ``TcpFabric``; the joiner's from its boot).  Between the join and
        the leave, a follower of the clustered owner on ``dev``
        (``FollowerReplica``, its own log and fabric) attaches to all four
        members' descriptors, composing their images, and shadows the
        leave's moves under the load; after it, its digest is clean on
        every shard against the shard's owner and its reads of every key
        of a shard that moved in the leave, and of the phase's sample,
        equal the owners' at the members' applied clock
        (``_lf_check``)."""
        from antidote_tpu_torch.cluster import attach_interdc
        from antidote_tpu_torch.interdc.tcp import TcpFabric
        from antidote_tpu_torch.supervise import ThreadLoop

        out: dict = {}
        # the endpoints come up on members with history: their chains
        # resume from their logs
        t0 = time.perf_counter()
        ifab = TcpFabric()
        reps = []
        for m in members:
            reps.append(attach_interdc(m, ifab))
            reps[-1].restore_from_log()
        # the members' endpoints subscribe to nothing, so their fabric has
        # nothing to deliver: their loop is the tick alone, once a second,
        # each tick a heartbeat of every owned shard whose safe time moved.
        # The four members share this interpreter, where member processes
        # would have one each; a tick at the serving loop's cadence would
        # ping every shard of every member each ~20 ms (and a pump call
        # ticks up to three times)
        iloop = ThreadLoop(lambda: [r.maybe_heartbeat() for r in reps],
                           interval_s=1.0, name="live-interdc-tick").start()
        out["endpoints_s"] = time.perf_counter() - t0
        box: dict = {}
        try:
            return live_moves(out, ifab, reps, box, threads)
        finally:
            if "follower" in box:
                _lf_close(box["follower"])
            iloop.stop()
            ifab.close()

    def live_moves(out, ifab, reps, box, threads) -> dict:
        import threading

        nonlocal members, coords
        from antidote_tpu_torch.cluster import attach_interdc
        from antidote_tpu_torch.cluster.join import live_join, live_leave

        t0 = time.perf_counter()
        joiner = ClusterMember(cfg, 0, n_new, n_new + 1,
                               log_dir=os.path.join(root, "j"), shards=[],
                               device=dev)
        reps.append(attach_interdc(joiner, ifab))
        out["joiner_boot_s"] = time.perf_counter() - t0
        members = members + [joiner]
        _tk_wire(members)
        snap_old()
        lock = threading.Lock()
        stop, moving = threading.Event(), threading.Event()
        acked_ms, errs = [], []

        def worker(w):
            wr = np.random.default_rng(500 + w)
            mine_s = np.arange(w, n_set, threads)
            mine_c = np.arange(w, n_ctr, threads)
            c = w % n_new
            i = 0
            while not stop.is_set():
                kind, i = i % 4, i + 1
                t1 = time.perf_counter()
                try:
                    if kind == 0:
                        kk = wr.choice(mine_s, 4, replace=False).tolist()
                        ee = wr.integers(20_000, 30_000, 4).tolist()
                        static(c, [(k, S, Bs, ("add", e))
                                   for k, e in zip(kk, ee)])
                        with lock:
                            for k, e in zip(kk, ee):
                                smodel[k].add(e)
                                note(k, Bs)
                    elif kind == 1:
                        kk = wr.choice(mine_s, 2, replace=False).tolist()
                        with lock:
                            ups = [(k, S, Bs, ("remove", max(smodel[k])))
                                   for k in kk if smodel[k]]
                        static(c, ups)
                        with lock:
                            for k, _, _, (_, e) in ups:
                                smodel[k].discard(e)
                                note(k, Bs)
                    elif kind == 2:
                        kk = wr.choice(mine_c, 2, replace=False).tolist()
                        static(c, [(k, C, Bc, ("increment", 3))
                                   for k in kk])
                        with lock:
                            for k in kk:
                                cmodel[k] += 3
                                note(k, Bc)
                    else:
                        kk = wr.choice(mine_s, 8, replace=False).tolist()
                        t = start(c)
                        vals = coords[c].read_objects(
                            [(k, S, Bs) for k in kk], txn=t)
                        coords[c].commit_transaction(t)
                        with lock:
                            want = [sorted(smodel[k]) for k in kk]
                        if [sorted(v) for v in vals] != want:
                            raise AssertionError(
                                f"live read of {kk}: {vals!r}")
                except Exception as e:  # noqa: BLE001 — raised below
                    errs.append(f"worker {w}: {e!r}")
                    return
                if moving.is_set():
                    with lock:
                        acked_ms.append((time.perf_counter() - t1) * 1e3)

        move_ms, moved, moved_in = [], set(), {"join": set(), "leave": set()}
        last = [0.0]
        phase = ["join"]

        def progress(shard, _src, _dst, _done, _total):
            now = time.perf_counter()
            move_ms.append((now - last[0]) * 1e3)
            last[0] = now
            moved.add(int(shard))
            moved_in[phase[0]].add(int(shard))

        # the mover's calls by handler (its thread's only): a move's
        # export, import with its seal, relinquish and broadcasts
        from antidote_tpu_torch.cluster.rpc import RpcClient

        mover = threading.get_ident()
        rpc_ms: dict = {}
        plain_call = RpcClient.call

        def timed_call(cli, method, *args):
            t1 = time.perf_counter()
            try:
                return plain_call(cli, method, *args)
            finally:
                if threading.get_ident() == mover:
                    rpc_ms.setdefault(method, []).append(
                        (time.perf_counter() - t1) * 1e3)

        # every import's seal by member: its own time and its kind (a
        # full image or a delta link)
        from antidote_tpu_torch.log.checkpoint import Checkpointer

        seal_ms: dict = {}
        plain_seal = Checkpointer.seal

        def timed_seal(ckpt):
            t1 = time.perf_counter()
            man = plain_seal(ckpt)
            with lock:
                seal_ms.setdefault((id(ckpt), man["kind"]), []).append(
                    (time.perf_counter() - t1) * 1e3)
            return man

        rpcs = {m.member_id: tuple(m.address) for m in members}
        ths = [threading.Thread(target=worker, args=(w,), name=f"live{w}")
               for w in range(threads)]
        for t in ths:
            t.start()
        RpcClient.call = timed_call
        Checkpointer.seal = timed_seal
        try:
            moving.set()
            for what, fn, arg in (("join", live_join, n_new),
                                  ("leave", live_leave, 1)):
                if what == "leave":
                    # the follower of the clustered owner attaches to all
                    # four members between the moves, under the load
                    moving.clear()
                    fo = box["follower"] = _lf_attach(
                        dev, n_shards, os.path.join(root, "follower"), reps)
                    out["follower"] = {
                        k: fo[k] for k in ("mode", "attach_s", "boot",
                                           "routed_at_attach", "process_s")}
                    log(f"takeover live: follower attached in "
                        f"{fo['attach_s']:.1f} s (mode {fo['mode']}; its "
                        f"process up and attached in {fo['process_s']:.1f} "
                        "s)")
                    moving.set()
                phase[0] = what
                t1 = last[0] = time.perf_counter()
                out[f"{what}_moves"] = fn(rpcs, arg, progress=progress)
                out[f"{what}_s"] = time.perf_counter() - t1
                log(f"takeover live: {what} moved {out[f'{what}_moves']} "
                    f"shards in {out[f'{what}_s']:.1f} s")
            moving.clear()
        finally:
            RpcClient.call = plain_call
            Checkpointer.seal = plain_seal
            stop.set()
            for t in ths:
                t.join(timeout=120)
        out["move_rpc_ms"] = {
            m: _ms_pcts(v) for m, v in sorted(rpc_ms.items())
            if m in ("m_export_shard", "m_import_shard",
                     "m_relinquish_shard", "m_set_owner")}
        by_ckpt = {id(m.node.checkpointer): m for m in members
                   if m.node.checkpointer is not None}
        out["seal_ms"] = {
            f"{by_ckpt[c].member_id}/{kind}": dict(_ms_pcts(v), n=len(v),
                                                   total_s=sum(v) / 1e3)
            for (c, kind), v in sorted(seal_ms.items(), key=lambda kv: (
                by_ckpt[kv[0][0]].member_id, kv[0][1]))}
        out["chain_len"] = {m.member_id: m.node.checkpointer.chain_len
                            for m in members
                            if m.node.checkpointer is not None}
        if errs:
            raise AssertionError(f"live load failed: {errs[:3]}")
        # a departed id is never reused; the sequencer cannot leave
        for fn, args, want in (
                (live_join, ({0: rpcs[0], 1: ("127.0.0.1", 1)}, 1),
                 "never be reused"),
                (live_leave, ({m: a for m, a in rpcs.items() if m != 1}, 0),
                 "sequencer")):
            try:
                fn(*args)
                raise AssertionError(f"{fn.__name__}{args[1:]} was let "
                                     "through")
            except ValueError as e:
                if want not in str(e):
                    raise
        leaver = members[1]
        members = [m for m in members if m is not leaver]
        leaver.close()
        maps = [m.shard_map for m in members]
        if any(mp != maps[0] for mp in maps):
            raise AssertionError("the members' shard maps differ")
        owned = sorted(s for m in members for s in m.shards)
        if owned != list(range(n_shards)):
            raise AssertionError("the owned sets do not partition the "
                                 "shards")
        if {o for o in maps[0].values()} != {m.member_id for m in members}:
            raise AssertionError("the map names a member that left")
        out["retries"] = {k: sum(c.move_retries[k] for c in coords)
                          for k in ("busy", "not_owner")}
        coords = [m.coordinator() for m in members]
        moved_keys = ([(k, Bs) for k in range(n_set)
                       if key_to_shard(k, Bs, n_shards) in moved]
                      + [(k, Bc) for k in range(n_ctr)
                         if key_to_shard(k, Bc, n_shards) in moved])
        check("live", extra_old=moved_keys)
        # the follower against the owners after the load
        left = moved_in["leave"]
        objs = ([(k, S, Bs) for k in range(n_set)
                 if key_to_shard(k, Bs, n_shards) in left]
                + [(k, C, Bc) for k in range(n_ctr)
                   if key_to_shard(k, Bc, n_shards) in left])
        seen = {(k, b) for k, _, b in objs}
        objs += [(int(k), S, Bs) for k in rng.choice(n_set, sample,
                                                     replace=False)
                 if (int(k), Bs) not in seen]
        fchk = _lf_check(box["follower"], members, coords[0], objs)
        out["follower"].update(fchk)
        log(f"takeover live: follower digest clean on {n_shards} shards in "
            f"{fchk['digest_s']:.1f} s, {fchk['keys_read']} keys equal")
        out["moved_shards"] = len(moved)
        out["moved_keys_read_old"] = len(moved_keys)
        out["move_ms"] = _ms_pcts(move_ms)
        out["moves"] = len(move_ms)
        out["acked_during_moves"] = len(acked_ms)
        out["acked_ms"] = _ms_pcts(acked_ms) if acked_ms else None
        out["seals"] = {m.member_id: m.node.checkpointer.last["id"]
                        for m in members if m.node.checkpointer is not None
                        and m.node.checkpointer.last is not None}
        out["member_ids"] = [m.member_id for m in members]
        return out

    def recover(i, n):
        """Member ``i`` of ``n`` back on its directory: (member, parts)."""
        t1 = time.perf_counter()
        m = ClusterMember(cfg, 0, i, n, log_dir=dirs[i], recover=True,
                          device=dev)
        total = time.perf_counter() - t1
        parts = dict(m.recovery_s)
        parts["store"] = total - sum(parts.values())
        parts["total"] = total
        return m, parts

    def replace(i, m):
        """Member ``i`` rejoined as ``m``: rewire, drop the dead one."""
        members[i] = m
        for p in members:
            if p is not m:
                m.connect(p.member_id, *p.address)
                p.connect(i, *m.address)
        coords[i] = m.coordinator()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    old: dict = {}
    res: dict = {"members": n_mem, "shards": n_shards, "set_keys": n_set,
                 "counter_keys": n_ctr}
    try:
        t0 = time.perf_counter()
        members = [ClusterMember(cfg, 0, i, n_mem, log_dir=dirs[i],
                                 device=dev) for i in range(n_mem)]
        _tk_wire(members)
        coords = [m.coordinator() for m in members]
        res["boot_s"] = time.perf_counter() - t0
        # ---- 1. populate ------------------------------------------------
        t0 = time.perf_counter()
        stream = []
        for _ in range(3):
            elems = rng.integers(0, 1000, n_set)
            stream += [(int(k), S, Bs, ("add", int(elems[k])))
                       for k in rng.permutation(n_set)]
        for _ in range(2):
            stream += [(int(k), C, Bc, ("increment", int(k % 7 + 1)))
                       for k in rng.permutation(n_ctr)]
        n_txn = 0
        for lo in range(0, len(stream), TK_TXN):
            chunk = stream[lo:lo + TK_TXN]
            static(n_txn % n_mem, chunk)
            n_txn += 1
            for k, _, b, (op, x) in chunk:
                if b == Bs:
                    smodel[k].add(x)
                else:
                    cmodel[k] += x
                note(k, b)
        res["populate_s"] = time.perf_counter() - t0
        res["populate_txns"] = n_txn
        res["populate_records_per_s"] = len(stream) / res["populate_s"]
        recs = [sum(1 for _ in replay(os.path.join(d, "prepare.wal")))
                for d in dirs]
        res["prepare_wal_records"] = recs
        res["prepare_wal_bytes"] = [
            os.path.getsize(os.path.join(d, "prepare.wal")) for d in dirs]
        log(f"takeover populate: {n_txn} txns, {len(stream)} updates in "
            f"{res['populate_s']:.2f} s; prepare.wal records {recs}")
        # ---- 2. the older snapshot --------------------------------------
        snap_old()
        # four shards, one a member, with a counter key and set keys each
        by_shard: dict = {}
        for k in range(n_set):
            by_shard.setdefault(key_to_shard(k, Bs, n_shards), []).append(k)
        ctr_on: dict = {}
        for k in range(n_ctr):
            ctr_on.setdefault(key_to_shard(k, Bc, n_shards), []).append(k)
        wsh = [next(s for s in range(m, n_shards, n_mem)
                    if len(by_shard.get(s, ())) >= 2 and s in ctr_on)
               for m in range(n_mem)]
        wck = [ctr_on[s][0] for s in wsh]
        # ---- 3. wedged after the sequencer ------------------------------
        txw, tsw, prevw = _tk_wedge(coords[1], [
            (k, C, Bc, ("increment", 1000)) for k in wck])
        for i in range(chain_txns):
            kk = [by_shard[s][i % len(by_shard[s])] for s in wsh]
            static(i % n_mem, [(k, S, Bs, ("add", 10_000 + i)) for k in kk])
            for k in kk:
                smodel[k].add(10_000 + i)
                note(k, Bs)
        buffered = sum(len(members[s % n_mem].chain_wait[s]) for s in wsh)
        if buffered < chain_txns:
            raise AssertionError(f"only {buffered} links buffered behind "
                                 "the hole")
        t0 = time.perf_counter()
        members[0].resolve_wedged()
        res["abort_decision_ms"] = (time.perf_counter() - t0) * 1e3
        if members[0].seq.resolutions[txw.txid][0] != "abort":
            raise AssertionError("the wedged txn was not aborted")
        for s in wsh:
            m = members[s % n_mem]
            if m.chain_wait[s] or m.applied_ts[s] <= tsw:
                raise AssertionError(f"shard {s}'s chain did not drain")
        res["chains_drained"] = buffered
        vc = txw.snapshot_vc.copy()
        vc[0] = tsw
        try:
            members[2].m_commit(txw.txid, [int(x) for x in vc], prevw)
            raise AssertionError("the zombie's late commit was applied")
        except RuntimeError as e:
            if "resolved-aborted" not in str(e):
                raise
        log(f"takeover: wedge aborted in {res['abort_decision_ms']:.1f} ms,"
            f" {buffered} buffered links drained")
        check("wedge")
        # ---- 4. a partial fan-out ---------------------------------------
        txp, tsp, prevp = _tk_wedge(coords[2], [
            (k, C, Bc, ("increment", 7)) for k in wck])
        vc = txp.snapshot_vc.copy()
        vc[0] = tsp
        members[3].m_commit(txp.txid, [int(x) for x in vc], prevp)
        t0 = time.perf_counter()
        members[1].resolve_wedged()
        res["commit_decision_ms"] = (time.perf_counter() - t0) * 1e3
        for k in wck:
            cmodel[k] += 7
            note(k, Bc)
        for s in wsh:
            if members[s % n_mem].applied_ts[s] < tsp:
                raise AssertionError(f"shard {s} missed the completion")
        # ---- 5. crash and rejoin member 2 -------------------------------
        s_a, s_b = [s for s in sorted(ctr_on) if s % n_mem == 2][:2]
        ck_a, ck_b = ctr_on[s_a][0], ctr_on[s_b][0]
        txu, _, _ = _tk_wedge(coords[0], [(ck_a, C, Bc, ("increment", 500))])
        txt, tst, prevt = _tk_wedge(coords[0],
                                    [(ck_b, C, Bc, ("increment", 33))])
        vc = txt.snapshot_vc.copy()
        vc[0] = tst
        members[2]._prep_append({"ev": "commit", "txid": int(txt.txid),
                                 "vc": [int(x) for x in vc],
                                 "prev": prevt})
        _tk_crash(members[2])
        m2, res["recovery_s"] = recover(2, n_mem)
        replace(2, m2)
        if txu.txid not in m2.staged or m2.applied_ts[s_b] < tst:
            raise AssertionError("the rejoin lost the prep or the torn "
                                 "commit")
        cmodel[ck_b] += 33
        note(ck_b, Bc)
        t = start(1)
        coords[1].update_objects([(ck_a, C, Bc, ("increment", 1))], txn=t)
        try:
            coords[1].commit_transaction(t)
            raise AssertionError("the recovered prepare lock let a write "
                                 "through")
        except AbortError:
            pass
        res["rejoin_resolved"] = m2.resolve_wedged()
        if txu.txid in m2.staged:
            raise AssertionError("the recovered prep was not settled")
        static(1, [(ck_a, C, Bc, ("increment", 1))])
        cmodel[ck_a] += 1
        note(ck_a, Bc)
        log(f"takeover: member 2 rejoined ({res['recovery_s']})")
        check("rejoin")
        # ---- 6. a never-sequenced prepare, swept ------------------------
        s_c = next(s for s in sorted(ctr_on) if s % n_mem == 3)
        ck_s = ctr_on[s_c][0]
        _tk_wedge(coords[1], [(ck_s, C, Bc, ("increment", 900))], seq=False)
        t0 = time.perf_counter()
        swept = members[3].sweep_stale_prepared(grace_s=0.0)
        res["sweep_ms"] = (time.perf_counter() - t0) * 1e3
        if swept != 1:
            raise AssertionError(f"the sweep settled {swept} txns")
        static(0, [(ck_s, C, Bc, ("increment", 1))])
        cmodel[ck_s] += 1
        note(ck_s, Bc)
        # ---- 7. checkpoint, compact, crash, recover member 1 ------------
        # the members checkpoint at once, as member processes would
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_mem) as ex:
            ids = [m["id"] for m in ex.map(
                lambda m: m.coordinator().checkpoint_now(), members)]
        res["checkpoint_s"] = time.perf_counter() - t0
        if ids != [1] * n_mem:
            raise AssertionError(f"checkpoint ids {ids}")
        snap_old()
        mixed_txns(mixed, lat_before)
        path = os.path.join(dirs[1], "prepare.wal")
        before = os.path.getsize(path)
        t0 = time.perf_counter()
        members[1]._compact_prepare_log()
        res["compaction_s"] = time.perf_counter() - t0
        res["compaction_bytes"] = [before, os.path.getsize(path)]
        _tk_crash(members[1])
        m1, res["image_recovery_s"] = recover(1, n_mem)
        replace(1, m1)
        log(f"takeover: member 1 recovered from its image "
            f"({res['image_recovery_s']})")
        check("image")
        # ---- 8. resize 4 -> 3 -------------------------------------------
        t0 = time.perf_counter()
        for m in members:
            m.close()
        members, coords = [], []
        gc.collect()
        res["close_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["resize_parts_s"] = resize_dc(dirs, new_dirs, cfg=cfg,
                                          device=dev)
        res["resize_s"] = time.perf_counter() - t0
        res["resize_ms_per_shard"] = res["resize_s"] / n_shards * 1e3
        try:
            ClusterMember(cfg, 0, 0, n_mem, log_dir=dirs[0], recover=True,
                          device=dev)
            raise AssertionError("a member booted on a retired directory")
        except LogDirMismatch:
            res["retired_refused"] = True
        # the new members boot at once, as member processes would
        t0 = time.perf_counter()
        dirs = new_dirs
        with ThreadPoolExecutor(n_new) as ex:
            members = list(ex.map(
                lambda i: ClusterMember(cfg, 0, i, n_new, log_dir=dirs[i],
                                        recover=True, device=dev),
                range(n_new)))
        _tk_wire(members)
        coords = [m.coordinator() for m in members]
        res["resize_boot_s"] = time.perf_counter() - t0
        snap_old()
        mixed_txns(mixed, lat_after)
        check("resize")
        log(f"takeover: resized 4 -> 3 in {res['resize_s']:.1f} s "
            f"({res['resize_parts_s']})")
        # ---- 9. live join and leave under load --------------------------
        # the takeover path's launches end here; the live segment counts
        # its own from 0, and the members' own reads of its check apart
        res["takeover_launches"] = dict(ck.LAUNCHES)
        res["member_check_launches"] = dict(member_check_launches)
        if live:
            member_check_launches.clear()
            ck.reset_launches()
            t0 = time.perf_counter()
            seg = live_segment()
            seg["check_launches"] = dict(member_check_launches)
            # the follower's process launched its own (its attach, digest
            # and reads): they are the path's too
            fol_launches = seg["follower"].pop("process_launches")
            seg["launches"] = {n: v - member_check_launches.get(n, 0)
                               + fol_launches.get(n, 0)
                               for n, v in ck.LAUNCHES.items()}
            seg["seconds"] = time.perf_counter() - t0
            res["live"] = seg
        res["txn_ms_before_resize"] = _ms_pcts(lat_before)
        res["txn_ms_after_resize"] = _ms_pcts(lat_after)
        res["start_ms"] = _ms_pcts(start_ms)
        res["sequencer_ts"] = members[0].seq.counter
        res["resident_gib"] = (torch.cuda.memory_allocated(dev) / 2**30
                               if on_card else None)
        res.update(st)
        return res
    finally:
        for m in members:
            try:
                m.close()
            except (OSError, RuntimeError) as e:
                log(f"takeover: closing member {m.member_id}: {e}")
        shutil.rmtree(root, ignore_errors=True)


def mesh_devices(torch) -> list:
    """The mesh phase's plane: every visible card when there are two or
    more and they divide the 8 shards, else 4 blocks on ``cuda:0``."""
    n = torch.cuda.device_count()
    if n >= 2 and 8 % n == 0:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * MS_BLOCKS_ONE_CARD


def mesh_phase(torch, devices, n_keys=MS_KEYS, n_ctrs=MS_CTRS,
               rounds=MS_ROUNDS, batches=MS_BATCHES, batch=B,
               hist_batches=MS_HIST_BATCHES, long_ops=MS_LONG_OPS,
               procs=1, threads=MS_THREADS, window_s=MS_WINDOW_S,
               sample=MS_SAMPLE) -> dict:
    """The mesh serving plane (``parallel.MeshServingPlane``) over
    ``devices``: an ``AntidoteNode`` at BASELINE's widths with a log
    directory whose tables are placed in shard blocks, one block a device,
    and a twin node without a plane fed the same groups.  Populate
    ``n_keys`` ``set_aw`` keys (3 adds a key from SV_POOL values, removes on
    a tenth) and ``n_ctrs`` counters (2 increments) through
    ``KVStore.apply_effect_groups``; a sample of the heads equal to the
    twin's; two copy publishes, ``rounds`` scatters, then two bursts on one
    shard whose publish moves ``antidote_mesh_publish_total`` for that shard
    alone, by its dirty rows, and leaves the other blocks' slot tensors
    untouched; ``stable_vc`` after every commit round equal to the applied
    clocks' min, the unchanged clocks a cache hit; ``batches`` Zipf batches
    through the epoch plane while a second thread commits 256-key rounds,
    each value equal to the locked read at its epoch's clock; historical
    batches at the clock 60% through the adds (``set_aw_fold`` on every
    block) and counters between their two increments (``counter_fold``);
    ``sharded_step_fn`` on the placed tables; ``long_ops``-op logs of one
    add-only set key and one counter through the ``mesh_assoc`` rung, equal
    to the ``assoc`` rung; a ``window_s`` window of the north-star mix
    through a native-front-end ``ProtocolServer`` on the node, every
    acknowledged write read back equal to the host model.  Every kernel
    must launch on every block and every distinct device of the plane."""
    import tempfile
    import threading

    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.materializer import cuda_kernels as ck
    from antidote_tpu_torch.parallel import MeshServingPlane, sharded_step_fn
    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.server import ProtocolServer
    from antidote_tpu_torch.store.kv import Effect

    devices = [torch.device(d) for d in devices]
    distinct = list(dict.fromkeys(devices))
    on_card = devices[0].type == "cuda"
    n_blocks = len(devices)

    def sync():
        if on_card:
            for d in distinct:
                torch.cuda.synchronize(d)

    out: dict = {"devices": [str(d) for d in devices], "keys": n_keys,
                 "counters": n_ctrs}
    log(f"mesh: plane over {out['devices']}")
    cfg = AntidoteConfig(n_shards=8, max_dcs=D, ops_per_key=K,
                         snap_versions=2, set_slots=E,
                         keys_per_table=n_keys // 8)
    tmp = tempfile.TemporaryDirectory(prefix="antidote_mesh_")
    plane = MeshServingPlane(cfg, n_blocks, devices=devices)
    node = AntidoteNode(cfg, log_dir=os.path.join(tmp.name, "mesh"),
                        device=devices[0], sharding=plane.sharding)
    plane.metrics = node.metrics
    plane.attach(node.store)
    twin = AntidoteNode(cfg, device=devices[0])
    store, txm, m = node.store, node.txm, node.metrics
    srv = None
    try:
        # ---- populate both nodes with the same groups --------------------
        st = orset_stream(np.random.default_rng(83), n_keys)
        keys, lane0, first_idx = st["keys"], st["lane0"], st["first_idx"]
        rm_keys, rm_t = st["rm_keys"], st["rm_t"]
        vals = (st["elems"] % SV_POOL).astype(np.int64)
        pool_h = np.asarray([store.blobs.intern(v) for v in range(SV_POOL)],
                            np.int64)
        for h in pool_h.tolist():
            twin.store.blobs.intern_bytes(h, store.blobs.bytes_of(h))
        refs = [((h, store.blobs.bytes_of(h)),) for h in pool_h.tolist()]
        eff_a = pool_h[vals][:, None]
        add_b = np.zeros((1 + D,), np.int32)
        ctr_t0 = int(rm_t.max()) + 1
        cty = get_type("counter_pn")
        c_a = np.zeros((2, n_ctrs, cty.eff_a_width(cfg)), np.int64)
        c_a[0, :, 0] = np.arange(n_ctrs) % 7 + 1
        c_a[1, :, 0] = np.arange(n_ctrs) % 5 + 2
        c_b = np.zeros((cty.eff_b_width(cfg),), np.int32)
        groups = []
        for lo in range(0, len(keys), POP_BATCH):
            hi = min(lo + POP_BATCH, len(keys))
            vcs = np.zeros((hi - lo, D), np.int32)
            vcs[:, 0] = lane0[lo:hi]
            groups.append(([Effect(k, "set_aw", "b", eff_a[lo + j], add_b,
                                   blob_refs=refs[vals[lo + j]])
                            for j, k in enumerate(keys[lo:hi].tolist())],
                           list(vcs), [0] * (hi - lo)))
        for lo in range(0, len(rm_keys), POP_BATCH):
            kk = rm_keys[lo:lo + POP_BATCH]
            rb = np.zeros((len(kk), 1 + D), np.int32)
            rb[:, 0] = 1
            rb[:, 1] = lane0[first_idx[kk]]
            vcs = np.zeros((len(kk), D), np.int32)
            vcs[:, 0] = rm_t[kk]
            groups.append(([Effect(k, "set_aw", "b", eff_a[first_idx[k]],
                                   rb[j]) for j, k in enumerate(kk.tolist())],
                           list(vcs), [0] * len(kk)))
        for r in range(2):
            for lo in range(0, n_ctrs, POP_BATCH):
                hi = min(lo + POP_BATCH, n_ctrs)
                vcs = np.zeros((hi - lo, D), np.int32)
                vcs[:, 0] = ctr_t0 + r * n_ctrs + np.arange(lo, hi)
                groups.append(([Effect(k, "counter_pn", "ctr", c_a[r, k],
                                       c_b) for k in range(lo, hi)],
                               list(vcs), [0] * (hi - lo)))
        t0 = time.perf_counter()
        for g in groups:
            store.apply_effect_groups([g])
        sync()
        out["populate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for g in groups:
            twin.store.apply_effect_groups([g])
        sync()
        out["twin_populate_s"] = time.perf_counter() - t0
        del groups
        txm.commit_counter = int(store.dc_max_vc()[0])
        log(f"mesh: populated {len(keys) + len(rm_keys) + 2 * n_ctrs} "
            f"effects in {out['populate_s']:.1f} s (twin "
            f"{out['twin_populate_s']:.1f} s)")
        set_t = store.tables["set_aw"]
        ctr_t = store.tables["counter_pn"]
        if not (set_t.placed and ctr_t.placed
                and [b.device for b in set_t.blocks] == devices):
            raise AssertionError("the node's tables are not placed")
        loc = np.asarray([store.directory[(k, "b")][1:]
                          for k in range(n_keys)], np.int64)
        cloc = np.asarray([store.directory[(k, "ctr")][1:]
                           for k in range(n_ctrs)], np.int64)
        # the host model of the sets
        key_vals = np.zeros((n_keys, ADDS_PER_KEY), np.int64)
        occ = np.zeros(n_keys, np.int64)
        for i, k in enumerate(keys.tolist()):
            key_vals[k, occ[k]] = vals[i]
            occ[k] += 1
        v0 = vals[first_idx]
        gone = np.zeros(n_keys, bool)
        gone[rm_keys] = (key_vals[rm_keys] == v0[rm_keys, None]).sum(-1) == 1
        no_write = np.iinfo(np.int64).max
        write_t = np.full(n_keys, no_write, np.int64)

        def oracle(k, t):
            want = set(key_vals[k].tolist())
            if gone[k] and write_t[k] > t:
                want.discard(int(v0[k]))
            return want

        # ---- a sample against the twin ------------------------------------
        rng = np.random.default_rng(89)
        pick = rng.choice(n_keys, size=min(sample, n_keys), replace=False)
        cpick = rng.choice(n_ctrs, size=min(sample // 8, n_ctrs),
                           replace=False)
        tw = twin.store.tables
        for name, t, ks, bucket in (("set_aw", set_t, pick, "b"),
                                    ("counter_pn", ctr_t, cpick, "ctr")):
            tl = np.asarray([twin.store.directory[(k, bucket)][1:]
                             for k in ks.tolist()], np.int64)
            ml = np.asarray([store.directory[(k, bucket)][1:]
                             for k in ks.tolist()], np.int64)
            vc_now = np.broadcast_to(store.dc_max_vc(), (len(ks), D))
            a, fa = t.read_latest(ml[:, 0], ml[:, 1], vc_now)
            b, fb = tw[name].read_latest(tl[:, 0], tl[:, 1], vc_now)
            for f in a:
                if not np.array_equal(a[f], b[f]):
                    raise AssertionError(f"mesh {name}.{f} differs from "
                                         "the twin's")
        objs = [(int(k), "set_aw", "b") for k in pick]
        got = store.read_values(objs, store.dc_max_vc())
        if got != twin.store.read_values(objs, store.dc_max_vc()):
            raise AssertionError("mesh values differ from the twin's")
        for k, v in zip(pick.tolist(), got):
            if set(v) != oracle(k, 0):
                raise AssertionError(f"mesh key {k}: {v} != model")
        out["twin_sample"] = len(pick) + len(cpick)
        twin.close()
        twin = None

        # ---- publishes, stable time ---------------------------------------
        stable_checks = {"rounds": 0, "cache_hits": 0}

        def check_stable():
            sync()
            t1 = time.perf_counter()
            got = store.stable_vc()
            us = (time.perf_counter() - t1) * 1e6
            if not np.array_equal(got, store.applied_vc.min(0)):
                raise AssertionError(f"stable_vc {got} != host min")
            n0 = plane.stable_collectives
            store.stable_vc()
            if plane.stable_collectives != n0:
                raise AssertionError("an unchanged clock missed the cache")
            stable_checks["rounds"] += 1
            stable_checks["cache_hits"] += 1
            return us

        def commit_round(kk):
            """Re-adds of every populate value of each key (a removed
            element comes back), 256 updates a transaction, merged."""
            ups = [(int(k), "set_aw", "b", ("add", int(v)))
                   for k in kk.tolist() for v in key_vals[k].tolist()]
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

        def publish():
            sync()
            t1 = time.perf_counter()
            res = txm.publish_serving_epoch()
            sync()
            return res, (time.perf_counter() - t1) * 1e3

        stable_us = [check_stable()]
        pubs = [publish()]
        commit_round(zipf_distinct(rng, n_keys, SV_ROUND_KEYS // 4))
        stable_us.append(check_stable())
        pubs.append(publish())
        for _ in range(rounds):
            commit_round(zipf_distinct(rng, n_keys, SV_ROUND_KEYS // 4))
            stable_us.append(check_stable())
            pubs.append(publish())
        # two bursts on one shard: the second publish's scatter holds that
        # shard's rows alone (the scatter set spans both windows)
        hot = 3
        hot_keys = np.nonzero(loc[:, 0] == hot)[0]
        burst = [rng.choice(hot_keys, size=128, replace=False)
                 for _ in range(2)]
        commit_round(burst[0])
        pubs.append(publish())
        commit_round(burst[1])
        stable_us.append(check_stable())
        hot_blk, _ = set_t.block_of(hot)
        spare = set_t.serving_spare()
        before_slot = {b: (spare["head_vc"][b].clone(),
                           {f: x.clone() for f, x in spare["head"][b].items()})
                       for b in range(n_blocks) if b != hot_blk.i}
        pub0 = dict(m.mesh_publish.snapshot())
        pubs.append(publish())
        delta = {k: v - pub0.get(k, 0)
                 for k, v in m.mesh_publish.snapshot().items()}
        delta = {k[0]: int(v) for k, v in delta.items() if v}
        dirty = len(set(loc[np.concatenate(burst), 1].tolist()))
        if delta != {str(hot): dirty}:
            raise AssertionError(f"burst publish moved {delta}, want only "
                                 f"shard {hot} by {dirty}")
        slot = set_t.serving_slot()
        for b, (hvc, head) in before_slot.items():
            if not torch.equal(hvc, slot["head_vc"][b]) or any(
                    not torch.equal(x, slot["head"][b][f])
                    for f, x in head.items()):
                raise AssertionError(f"the burst publish wrote block {b}")
        del before_slot
        modes = [p[0] for p in pubs]
        if any(r != "published" for r in modes):
            raise AssertionError(f"publishes: {modes}")
        out["publish"] = {
            "copy_ms": [round(p[1], 3) for p in pubs[:2]],
            "scatter_ms": [round(p[1], 3) for p in pubs[2:]],
            "burst_shard": hot, "burst_rows": dirty,
            "publish_by_shard": plane.status()["publish_by_shard"]}
        out["stable_vc_us"] = _stats(stable_us)

        # ---- epoch reads under writes --------------------------------------
        txm.enable_serving_epochs()
        txm.publish_serving_epoch()
        stop = threading.Event()
        errors: list = []
        w_rounds = [0]
        wrng = np.random.default_rng(97)

        def writer():
            try:
                while not stop.is_set():
                    commit_round(zipf_distinct(wrng, n_keys, SV_WRITE_KEYS))
                    w_rounds[0] += 1
            except Exception as e:  # noqa: BLE001 — fatal, raised below
                errors.append(e)

        lat, checked, epochs = [], {"locked": 0, "oracle": 0}, set()
        gathers0 = plane.epoch_gathers
        wt = threading.Thread(target=writer, name="mesh-writer")
        wt.start()
        try:
            for i in range(batches):
                kk = zipf_keys(rng, n_keys, batch)
                objs = [(int(k), "set_aw", "b") for k in kk]
                t1 = time.perf_counter()
                ep = store.pin_serving_epoch()
                try:
                    pend, fb = store.epoch_read_launch(objs, ep)
                    got = store.epoch_read_finish(pend)
                finally:
                    store.unpin_serving_epoch(ep)
                lat.append((time.perf_counter() - t1) * 1e3)
                if fb:
                    raise AssertionError(f"epoch batch {i}: fallbacks")
                epochs.add(ep.id)
                ty = get_type("set_aw")
                with txm.commit_lock:
                    res, _, complete = set_t.read_resolved(
                        loc[kk, 0], loc[kk, 1],
                        np.broadcast_to(ep.vc, (len(kk), D)))
                    for j, k in enumerate(kk.tolist()):
                        if complete[j]:
                            want = ty.value_from_resolved(
                                {f: x[j] for f, x in res.items()},
                                store.blobs, cfg)
                            checked["locked"] += 1
                        else:
                            want = oracle(k, int(ep.vc[0]))
                            checked["oracle"] += 1
                        if set(got[j]) != set(want):
                            raise AssertionError(
                                f"mesh epoch batch {i}: key {k} = "
                                f"{got[j]!r}, want {want!r}")
        finally:
            stop.set()
            wt.join(120)
        if errors:
            raise errors[0]
        out["epoch_reads"] = {
            "batch_ms": _stats(lat), "keys_per_s": batches * batch
            / (sum(lat) / 1e3), "write_rounds": w_rounds[0],
            "epochs_seen": len(epochs),
            "routed_gathers": plane.epoch_gathers - gathers0,
            "values_checked": checked}
        log(f"mesh: {batches} epoch batches under {w_rounds[0]} write "
            f"rounds, p50 {out['epoch_reads']['batch_ms']['p50']:.2f} ms")

        # ---- historical reads: set_aw_fold and counter_fold per block -----
        mid_t = int(len(keys) * 0.6)
        mid = np.zeros(D, np.int32)
        mid[0] = mid_t
        pos: dict = {}
        for i, k in enumerate(keys.tolist()):
            if lane0[i] <= mid_t:
                pos.setdefault(k, []).append(i)
        cold = np.nonzero(write_t == no_write)[0]
        hist_ms = []
        for _ in range(hist_batches):
            kk = rng.choice(cold, size=min(batch, len(cold)), replace=False)
            sync()
            t1 = time.perf_counter()
            res, fresh, complete = set_t.read_resolved_flat(
                loc[kk, 0], loc[kk, 1], np.broadcast_to(mid, (len(kk), D)))
            top = res["top"].cpu().numpy()
            hist_ms.append((time.perf_counter() - t1) * 1e3)
            if fresh.all() or not complete.all():
                raise AssertionError("historical batch: no stale rows, or "
                                     "incomplete ones")
            for j, k in enumerate(kk.tolist()):
                want = {int(pool_h[vals[i]]) for i in pos.get(k, [])}
                if {int(h) for h in top[j] if h != 0} != want:
                    raise AssertionError(f"historical key {k}")
        cvc = np.zeros(D, np.int32)
        cvc[0] = ctr_t0 + n_ctrs - 1  # after every first increment
        sync()
        t1 = time.perf_counter()
        res, fresh, complete = ctr_t.read_resolved_flat(
            cloc[:, 0], cloc[:, 1], np.broadcast_to(cvc, (n_ctrs, D)))
        cnt = res["value"].cpu().numpy()
        ctr_ms = (time.perf_counter() - t1) * 1e3
        if fresh.all() or not (cnt == c_a[0, :, 0]).all():
            raise AssertionError("counters at the older clock")
        cur = store.read_values([(k, "counter_pn", "ctr")
                                 for k in range(0, n_ctrs, 97)],
                                store.dc_max_vc())
        if cur != (c_a[0, ::97, 0] + c_a[1, ::97, 0]).tolist():
            raise AssertionError("counters now")
        out["historical"] = {"set_batch_ms": _stats(hist_ms),
                             "counter_batch_ms": ctr_ms}

        # ---- sharded_step_fn on the placed tables --------------------------
        out["step"] = {}
        step_rng = np.random.default_rng(101)
        for name, t, bucket in (("set_aw", set_t, "b"),
                                ("counter_pn", ctr_t, "ctr")):
            ty = get_type(name)
            p = cfg.n_shards
            ok = [np.nonzero(t.n_ops[s, :int(t.used_rows[s])] < K)[0]
                  for s in range(p)]
            mr = min(256, *(len(x) for x in ok))
            rows = np.stack([step_rng.choice(x, size=mr, replace=False)
                             for x in ok])
            slots = t.n_ops[np.arange(p)[:, None], rows].astype(np.int64)
            stamp = int(store.dc_max_vc()[0]) + 1
            app_a = np.zeros((p, mr, ty.eff_a_width(cfg)), np.int64)
            new_h = None
            if name == "set_aw":
                new_h = store.blobs.intern(10**9 + 7)
                app_a[..., 0] = new_h
            else:
                app_a[..., 0] = 3
            app_b = np.zeros((p, mr, ty.eff_b_width(cfg)), np.int32)
            app_vc = np.zeros((p, mr, D), np.int32)
            app_vc[..., 0] = stamp + np.arange(p * mr).reshape(p, mr)
            read_vcs = np.zeros((p, mr, D), np.int32)
            read_vcs[..., 0] = stamp + p * mr
            bl = t.blocks
            want_state, _ = t.read_latest(
                np.repeat(np.arange(p), mr), rows.reshape(-1),
                np.broadcast_to(store.dc_max_vc(), (p * mr, D)))
            sync()
            t1 = time.perf_counter()
            outs = sharded_step_fn(ty, cfg, plane.mesh)(
                [b.snap for b in bl], [b.snap_vc for b in bl],
                [b.snap_seq for b in bl], [b.ops_a for b in bl],
                [b.ops_b for b in bl], [b.ops_vc for b in bl],
                [b.ops_origin for b in bl], rows, slots, app_a, app_b,
                app_vc, np.zeros((p, mr), np.int32), rows,
                (slots + 1).astype(np.int32), read_vcs,
                store.applied_vc.copy())
            state = {f: torch.cat([x[f].cpu() for x in outs[4]]).numpy()
                     .reshape((p * mr,) + tuple(x.shape[2:]))
                     for f, x in outs[4][0].items()}
            step_ms = (time.perf_counter() - t1) * 1e3
            applied = torch.cat([x.cpu() for x in outs[5]]).numpy()
            new_applied = torch.cat([x.cpu() for x in outs[7]]).numpy()
            stable = torch.cat([x.cpu() for x in outs[8]]).numpy()
            if not (applied >= 1).all() or not (
                    stable == new_applied.min(0)).all():
                raise AssertionError(f"step {name}: applied / stable")
            if name == "counter_pn":
                if not (state["cnt"] == want_state["cnt"] + 3).all():
                    raise AssertionError("step counter_pn values")
            else:
                for j in range(0, p * mr, 61):
                    row = {f: x[j] for f, x in state.items()}
                    base = {f: x[j] for f, x in want_state.items()}
                    got = set(ty.value(row, store.blobs, cfg))
                    if got != set(ty.value(base, store.blobs, cfg)) | {
                            10**9 + 7}:
                        raise AssertionError(f"step set_aw row {j}")
            out["step"][name] = {"ms": step_ms, "rows": p * mr}

        # ---- the giant-key fold: mesh_assoc against assoc ------------------
        out["giant"] = {}
        grng = np.random.default_rng(103)
        for name in ("set_aw", "counter_pn"):
            ty = get_type(name)
            n = long_ops
            a = np.zeros((n, ty.eff_a_width(cfg)), np.int64)
            b = np.zeros((n, ty.eff_b_width(cfg)), np.int32)
            o = grng.integers(0, D, size=n).astype(np.int32)
            v = grng.integers(0, 4, size=(n, D)).astype(np.int32)
            if name == "set_aw":
                a[:, 0] = pool_h[grng.integers(0, 12, size=n)]
                v[np.arange(n), o] = np.arange(1, n + 1)
            else:
                a[:, 0] = grng.integers(-5, 6, size=n)
            read_vc = np.full(D, n, np.int32)
            res = {}
            for rung, mesh in (("mesh_assoc", plane), ("assoc", None)):
                store.mesh = mesh
                try:
                    sync()
                    t1 = time.perf_counter()
                    st_, strat = store._fold_over_ring(ty, cfg, a, b, v, o,
                                                       read_vc)
                    st_ = {f: x.cpu().numpy() for f, x in st_.items()}
                    ms = (time.perf_counter() - t1) * 1e3
                finally:
                    store.mesh = plane
                if strat != rung:
                    raise AssertionError(f"giant {name}: rung {strat}")
                res[rung] = (st_, ms)
            for f, x in res["assoc"][0].items():
                if not np.array_equal(x, res["mesh_assoc"][0][f]):
                    raise AssertionError(f"giant {name}.{f}: mesh_assoc "
                                         "differs from assoc")
            out["giant"][name] = {"ops": n, "mesh_assoc_ms":
                                  res["mesh_assoc"][1],
                                  "assoc_ms": res["assoc"][1]}

        # ---- the north-star mix through the native front end ---------------
        model = [oracle(k, 1 << 62) for k in range(n_keys)]
        srv = ProtocolServer(node, port=0, native_frontend=True)
        status_c = AntidoteClient(srv.host, srv.port, timeout=60)
        load, busy, acked, _pre, _post = _wire_load(
            torch, srv, status_c, n_keys, procs, threads, 1.0, window_s)
        c = AntidoteClient(srv.host, srv.port, timeout=120)
        rb, _touched, _join = _wire_readback(
            c, model, acked, (), store.dc_max_vc(), n_keys, sample, 107)
        c.close()
        st_ = status_c.node_status()
        status_c.close()
        if "mesh" not in st_:
            raise AssertionError("the node status has no mesh block")
        out["north_star"] = {"load": load, "busy": busy, "readback": rb,
                             "epoch_chunk": srv._epoch_chunk}
        out["status_mesh"] = st_["mesh"]
        log(f"mesh: status mesh block {json.dumps(st_['mesh'])}")
        out["materializer"] = store.materializer_status()
    finally:
        if srv is not None:
            srv.close()
        if twin is not None:
            twin.close()
        node.close()
        tmp.cleanup()
    out["launches_by_block"] = {
        f"{k}@{b}": n for (k, b), n in sorted(ck.LAUNCHES_BY_BLOCK.items())}
    out["launches_by_device"] = {
        f"{k}@cuda:{d}": n
        for (k, d), n in sorted(ck.LAUNCHES_BY_DEVICE.items())}
    if on_card:
        missing = [f"{k}@{b}" for k in PATH_KERNELS["mesh"]
                   for b in range(n_blocks)
                   if not ck.LAUNCHES_BY_BLOCK.get((k, b))]
        missing += [f"{k}@{d}" for k in PATH_KERNELS["mesh"]
                    for d in distinct
                    if not ck.LAUNCHES_BY_DEVICE.get((k, d.index or 0))]
        if missing:
            raise AssertionError(f"the mesh path never launched {missing}")
    return out


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
    if sys.argv[1:2] == ["--flash-worker"]:
        return flash_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--live-follower"]:
        return live_follower_worker(sys.argv[2:])
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
        log(f"phase done in {res['seconds']:.1f} s (script "
            f"{time.perf_counter() - t_start:.1f} s)")
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
    interdc = run_path(lambda: interdc_phase(torch, dev))
    print(f"interdc: {json.dumps(interdc)} | card: {card}", flush=True)
    follower = run_path(lambda: follower_phase(torch, dev))
    print(f"follower: {json.dumps(follower)} | card: {card}", flush=True)
    takeover = run_path(lambda: takeover_phase(torch, dev))
    # the takeover phase ran its live segment last, with the launches
    # counted from 0 just before it: two paths
    live = takeover.pop("live")
    takeover["launches"] = takeover.pop("takeover_launches")
    takeover["seconds"] -= live["seconds"]
    print(f"takeover: {json.dumps(takeover)} | card: {card}", flush=True)
    print(f"live: {json.dumps(live)} | card: {card}", flush=True)
    # the mesh plane: every kernel held against its plain version on every
    # distinct device of the plane first (cuda:0's above), then the path
    mdevs = mesh_devices(torch)
    checked_on = [str(dev)]
    for d in dict.fromkeys(mdevs):
        if d != dev:
            check_kernels(torch, ck, d)
            check_stable_min(torch, ck, d)
            checked_on.append(str(d))
    print(f"mesh devices: {json.dumps([str(d) for d in mdevs])}; kernels "
          f"held to their plain versions on {json.dumps(checked_on)}",
          flush=True)
    mesh = run_path(lambda: mesh_phase(torch, mdevs))
    mesh["kernels_checked_on"] = checked_on
    print(f"mesh: {json.dumps(mesh)} | card: {card}", flush=True)
    paths = {"serve": serve, "node": node, "serving": serving,
             "cluster": cluster, "types": types, "durable": durable,
             "cold": cold, "wire": wire, "native": native,
             "interdc": interdc, "follower": follower,
             "takeover": takeover, "live": live, "mesh": mesh}
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
