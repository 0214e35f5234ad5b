"""Live cluster membership change: join and leave while the DC serves.

The riak_core staged join and ownership handoff (AntidoteDB's
``antidote_dc_manager`` plans and commits over node names; the
materializer's handoff fold moves a vnode while the others serve).  The
unit of handoff is the SHARD (a slice of every device table plus its WAL
chain), and the protocol moves shards one at a time.

Routing truth is the members' explicit shard→(owner, epoch) map — the
riak_core ring analogue — NOT the modular formula: modular is only the
layout members BOOT with.  Joins and leaves therefore move the MINIMUM
of shards (only to a joiner / off a leaver, balanced by load) instead
of re-deriving a ring-wide modular remap, and ANY member id except the
sequencer (member 0) can live-leave — departing leaves a gap in the id
space, which is fine because nothing routes modularly once the map
exists.

Join:

  1. the joiner boots EMPTY (``ClusterMember(..., shards=[])``) and is
     wired to every member (operator / ctl_wire);
  2. every member learns the joiner + new id-space bound (m_join_begin),
     and ``live_join`` seeds the joiner with the CURRENT authoritative map
     (m_seed_map — the joiner's boot-time modular guess may predate
     earlier joins/leaves);
  3. ``plan_join_moves`` streams shards from the most-loaded members to
     the joiner until the layout is balanced (max-min load ≤ 1): the
     source exports a copy of each under its locks (refusing, retryably,
     while staged txns or chain holes touch the shard), the destination
     imports it, the source then relinquishes it, and everyone else
     learns the new owner with the move's epoch.

Leave (the inverse, for ANY member id except 0 — member 0 is the DC's
commit sequencer and needs the offline resize to hand that role over):
``plan_leave_moves`` streams each of the leaver's shards to the
least-loaded survivor, then ``m_forget_member`` drops the departed peer
everywhere.  Survivor ids keep their numbers — no renumbering.

While a shard is mid-move, coordinators hitting it get retryable
``not_owner``/``busy`` replies and re-route off a refreshed shard map —
the move blocks ONE shard briefly, never the cluster (riak_core vnode
handoff has the same per-vnode pause).  A member crash mid-move
recovers from its prepare log: ownership changes are durable "own"
events, so rejoin comes back with the moved layout.  Geo-replication
follows the moves live: the inter-DC egress/ingress chain state rides
in the handoff package, and publishers gossip per-shard ownership
epochs to remote DCs (interdc/replica.py), so remote catch-up re-routes
to the new owner without a reconnect.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch.cluster.rpc import RpcClient

log = logging.getLogger(__name__)

#: per-shard move retry budget (a staged txn pins a shard only for the
#: prepare→commit window; 400 × 25 ms rides out seconds of contention)
_MOVE_TRIES = 400

#: (shard, src, dst, done, total) — operator progress feedback
ProgressFn = Callable[[int, int, int, int, int], None]


def _retry_call(cli: RpcClient, method: str, *args, tries: int = _MOVE_TRIES):
    last = None
    for _ in range(tries):
        try:
            return cli.call(method, *args)
        except RuntimeError as e:
            if "busy" in str(e):
                last = e
                time.sleep(0.025)
                continue
            raise
    raise TimeoutError(f"{method}: shard stayed busy") from last


def _move_shard(clients: Dict[int, RpcClient], shard: int, src: int,
                dst: int, n_members: int) -> None:
    """Two-phase move: export a COPY, confirm the import landed, then
    relinquish the source.  The source keeps the only durable copy (and
    ownership) until the relinquish, so a crash of the mover at ANY point
    leaves a live copy: before relinquish the source still serves (after
    a cancel/restart clears the volatile mid-move mark); at/after
    relinquish the import has already been confirmed."""
    t0 = time.monotonic()
    data = _retry_call(clients[src], "m_export_shard", shard, dst)
    t_exp = time.monotonic()
    last = None
    for _ in range(10):
        try:
            clients[dst].call("m_import_shard", data)
            break
        except (OSError, RuntimeError) as e:  # transient (idempotent)
            last = e
            time.sleep(0.1)
    else:
        # import never landed: reopen the source shard and give up —
        # nothing was dropped, no data is at risk
        try:
            clients[src].call("m_cancel_export", shard)
        except (OSError, RuntimeError):
            pass  # source crash/unreachable: its restart clears the mark
        raise RuntimeError(
            f"shard {shard} import at member {dst} kept failing"
        ) from last
    # phase 2: the import is confirmed durable at dst — now (and only
    # now) drop the source copy; idempotent, so retry transient errors
    last = None
    for _ in range(10):
        try:
            epoch = clients[src].call("m_relinquish_shard", shard, dst)
            break
        except (OSError, RuntimeError) as e:
            last = e
            time.sleep(0.1)
    else:
        raise RuntimeError(
            f"shard {shard} relinquish at member {src} kept failing "
            "(both members now hold a copy; re-run the move)"
        ) from last
    # broadcast carries the move's epoch so stale maps can't clobber it
    for m, c in clients.items():
        if m not in (src, dst):
            c.call("m_set_owner", shard, dst, n_members, epoch)
    t_done = time.monotonic()
    log.info("moved shard %d: %d -> %d (export wait %.3fs, "
             "import+relinquish+broadcast %.3fs)",
             shard, src, dst, t_exp - t0, t_done - t_exp)


def _loads(shard_map: Dict[int, int], members=None) -> Dict[int, List[int]]:
    """member -> [owned shards] in shard order (deterministic plans).
    ``members`` adds ids that may own NOTHING right now — a zero-shard
    survivor is invisible in the map but must still be a placement
    candidate (it is the least-loaded one by definition)."""
    loads: Dict[int, List[int]] = {int(m): [] for m in (members or ())}
    for s, o in sorted(shard_map.items()):
        loads.setdefault(int(o), []).append(int(s))
    return loads


def plan_moves(shard_map: Dict[int, int], n_new: int
               ) -> List[Tuple[int, int, int]]:
    """(shard, src, dst) for every shard whose owner changes under the
    modular layout of ``n_new`` members — the INITIAL-layout remap, kept
    for the offline resize tool and tests.  Live join/leave use the
    minimal-move planners below instead."""
    return [(s, o, s % n_new) for s, o in sorted(shard_map.items())
            if o != s % n_new]


def plan_join_moves(shard_map: Dict[int, int], new_id: int,
                    members=None) -> List[Tuple[int, int, int]]:
    """Minimal balanced plan for a join: stream shards from the
    most-loaded members to the (empty) joiner until max-min load ≤ 1.
    Only the joiner receives shards — survivors never shuffle among
    themselves (the consistent-hashing property modular remaps lack)."""
    loads = _loads(shard_map, members)
    loads.setdefault(int(new_id), [])
    moves: List[Tuple[int, int, int]] = []
    while True:
        src = max(loads, key=lambda m: (len(loads[m]), -m))
        if src == new_id or len(loads[src]) - len(loads[new_id]) < 2:
            return moves
        s = loads[src].pop(0)
        loads[new_id].append(s)
        moves.append((s, src, new_id))


def plan_leave_moves(shard_map: Dict[int, int], leaving_id: int,
                     members=None) -> List[Tuple[int, int, int]]:
    """Drain plan for a leave: each of the leaver's shards goes to the
    currently least-loaded survivor (ties to the lowest id).  Pass
    ``members`` (every live id incl. the leaver) so a survivor that
    owns nothing yet still receives its fair share."""
    loads = _loads(shard_map, members)
    mine = loads.pop(int(leaving_id), [])
    if not loads:
        raise ValueError("cannot drain the only member of a DC")
    moves: List[Tuple[int, int, int]] = []
    for s in mine:
        dst = min(loads, key=lambda m: (len(loads[m]), m))
        loads[dst].append(s)
        moves.append((s, leaving_id, dst))
    return moves


def _check_covers(memb: dict, rpcs: Dict[int, Tuple[str, int]]) -> None:
    """Every member the cluster knows must be in the caller's rpcs map
    (the protection the old contiguous-0..n-1 check provided): a
    forgotten member would miss the durable join/forget broadcasts —
    half-committing a join, or leaving a survivor gossiping with a dead
    peer forever."""
    missing = sorted(int(m) for m in memb["members"] if int(m) not in rpcs)
    if missing:
        raise ValueError(
            f"rpcs must cover every live member: the cluster knows "
            f"member(s) {missing} that are not listed (members "
            f"{sorted(int(m) for m in memb['members'])})")


def live_join(rpcs: Dict[int, Tuple[str, int]], new_id: int,
              progress: Optional[ProgressFn] = None) -> int:
    """Join member ``new_id`` (already booted empty and wired) into a
    serving cluster.  ``rpcs``: member_id -> RPC address for EVERY
    member including the joiner.  Ids need not be contiguous (earlier
    live leaves may have opened gaps), but the joiner must take a FRESH
    id above every current one — reusing a departed id could collide
    with its durable state on a later recover.  Returns the number of
    shards moved."""
    ids = sorted(rpcs)
    if new_id != ids[-1] or len(ids) < 2:
        raise ValueError(
            f"joiner id must be the highest (fresh) member id of at "
            f"least one existing member (got members {ids}, "
            f"joiner {new_id})")
    if 0 not in rpcs:
        raise ValueError("member 0 (the DC sequencer) must be in rpcs")
    n_space = new_id + 1  # id-space bound, not the live member count
    clients = {m: RpcClient(*a) for m, a in rpcs.items()}
    try:
        # freshness is checked against the CLUSTER's monotone id-space
        # bound, not just the caller's rpcs map: after a leave the
        # departed id is absent from rpcs but its durable state (and
        # the routes remote DCs learned for it) still exists — handing
        # the id out again would alias them onto the new member.  An id
        # the cluster still KNOWS as a live peer is fine: that is the
        # re-run of an interrupted join, not a reuse (departed members
        # are dropped from the peer set by m_forget_member).
        memb = clients[0].call("m_membership")
        if new_id in [int(m) for m in memb.get("departed", ())]:
            # the DURABLE check: catches reuse even when the operator
            # already wired the reused id into the peer set (which makes
            # it look "live" to the secondary check below)
            raise ValueError(
                f"member id {new_id} previously live-LEFT this cluster "
                "and can never be reused (its durable state and the "
                "routes remote DCs learned for its fabric id would "
                f"alias the new member); pick a fresh id >= "
                f"{memb['n_members']}")
        if (new_id < int(memb["n_members"])
                and new_id not in [int(m) for m in memb["members"]]):
            raise ValueError(
                f"joiner id {new_id} is inside the cluster's used id "
                f"space (bound {memb['n_members']}) but is not a live "
                "member — a departed member may have held it; pick a "
                f"fresh id >= {memb['n_members']}")
        _check_covers(memb, rpcs)
        for m, c in clients.items():
            c.call("m_join_begin", new_id, list(rpcs[new_id]), n_space)
        # seed the joiner with the CURRENT authoritative map: its
        # boot-time modular guess predates any earlier joins/leaves,
        # and epoch-guarded refreshes would never overwrite same-epoch
        # entries of a wrong guess
        cur_ent = {int(s): [int(e[0]), int(e[1])]
                   for s, e in clients[0].call("m_shard_map").items()}
        clients[new_id].call("m_seed_map", cur_ent, n_space)
        cur = {s: e[0] for s, e in cur_ent.items()}
        moves = plan_join_moves(cur, new_id, members=set(rpcs))
        for i, (shard, src, dst) in enumerate(moves):
            _move_shard(clients, shard, src, dst, n_space)
            if progress is not None:
                progress(shard, src, dst, i + 1, len(moves))
        return len(moves)
    finally:
        for c in clients.values():
            c.close()


def live_leave(rpcs: Dict[int, Tuple[str, int]], leaving_id: int,
               progress: Optional[ProgressFn] = None) -> int:
    """Drain ANY member's shards to the survivors and drop it from the
    cluster; the caller shuts the leaver down afterwards.  The one
    exception is member 0: it is the DC's commit sequencer, so its
    departure needs the offline resize (which carries the ledger over).
    Survivors keep their ids — a mid-id leave leaves a gap in the id
    space, which the explicit ownership map routes around."""
    if leaving_id not in rpcs:
        raise ValueError(f"leaving member {leaving_id} not in rpcs")
    if leaving_id == 0:
        raise ValueError(
            "member 0 is the DC sequencer and cannot live-leave; use "
            "the offline resize tool to hand the sequencer role over")
    if 0 not in rpcs:
        raise ValueError("member 0 (the DC sequencer) must be in rpcs")
    n_space = max(rpcs) + 1
    clients = {m: RpcClient(*a) for m, a in rpcs.items()}
    try:
        _check_covers(clients[0].call("m_membership"), rpcs)
        cur = {int(s): int(e[0])
               for s, e in clients[0].call("m_shard_map").items()}
        moves = plan_leave_moves(cur, leaving_id, members=set(rpcs))
        for i, (shard, src, dst) in enumerate(moves):
            _move_shard(clients, shard, src, dst, n_space)
            if progress is not None:
                progress(shard, src, dst, i + 1, len(moves))
        for m, c in clients.items():
            if m != leaving_id:
                # drop the departed peer everywhere (its client closes;
                # gossip rows go with it).  The id-space bound is passed
                # UNCHANGED — it is monotone, so the departed id can
                # never be handed out again (live_join checks it)
                c.call("m_forget_member", leaving_id, n_space)
        return len(moves)
    finally:
        for c in clients.values():
            c.close()
