"""Seeded inputs for the device types other than ``set_aw`` and
``counter_pn``, numpy only: batches of states and of one effect per row
that hold each type's edges (``state_batch``, ``effect_batch``,
``edge_states``), and a bulk commit-ordered op stream over many keys from
several DC lanes with concurrent clocks (``populate_stream``).  The CPU
tests hold the port to the JAX package on them
(``tests/test_torch_types.py``); the card tests and ``chip_smoke.py`` hold
the CUDA path to the CPU path."""

from __future__ import annotations

import numpy as np

from antidote_tpu_torch.crdt import get_type

#: the device types this module makes inputs for
DEVICE_TYPES = ("counter_fat", "counter_b", "register_lww", "register_mv",
                "set_rw", "set_go", "flag_ew", "flag_dw", "rga")


def packed_ids(rng, shape, lanes: int, lo=1, hi=2**20):
    """register_mv entry ids ``(ts << 8) | dc``."""
    return ((rng.integers(lo, hi, shape).astype(np.int64) << 8)
            | rng.integers(0, lanes, shape))


def clock_batch(rng, b: int, cfg, hi=2**20):
    """(commit VCs int32[b, D], origins int32[b])."""
    d = cfg.max_dcs
    return (rng.integers(0, hi, (b, d)).astype(np.int32),
            rng.integers(0, d, b).astype(np.int32))


def _pool(rng, b, n=12):
    hs = rng.integers(1, 2**62, (b, n))
    hs[:, :3] = [1 << 32, -(1 << 32), -1]  # zero low halves, negatives
    return hs


def state_batch(name: str, rng, b: int, cfg) -> dict:
    """``b`` seeded states of a type: random lanes, with empty slots and
    full rows in the slotted types (rga starts empty: its states come
    from applying its effects)."""
    d, e, mv, s = cfg.max_dcs, cfg.set_slots, cfg.mv_slots, cfg.rga_slots
    if name == "counter_fat":
        return {"amt": rng.integers(-2**40, 2**40, (b, d)),
                "epoch": rng.integers(0, 4, (b, d)).astype(np.int32)}
    if name == "counter_b":
        return {"rights": rng.integers(0, 2**20, (b, d, d)),
                "used": rng.integers(0, 2**20, (b, d))}
    if name == "register_lww":
        return {"val": rng.integers(1, 2**62, b),
                "ts": rng.integers(0, 100, b)}
    if name == "register_mv":
        ids = packed_ids(rng, (b, mv), d)
        ids[rng.random((b, mv)) < 0.4] = 0
        ids[::5] = packed_ids(rng, (len(ids[::5]), mv), d)  # full rows
        return {"vals": np.where(ids != 0, rng.integers(1, 2**62, (b, mv)),
                                 0),
                "ids": ids, "ovf": rng.integers(0, 2, b).astype(np.int32)}
    if name in ("set_rw", "set_go"):
        elems = np.take_along_axis(_pool(rng, b),
                                   rng.integers(0, 12, (b, e)), 1)
        elems[rng.random((b, e)) < 0.3] = 0
        elems[::6] = rng.integers(1, 2**62, (len(elems[::6]), e))  # full
        st = {"elems": elems, "ovf": rng.integers(0, 2, b).astype(np.int32)}
        if name == "set_rw":
            st["addvc"] = rng.integers(0, 6, (b, e, d)).astype(np.int32)
            st["rmvc"] = rng.integers(0, 6, (b, e, d)).astype(np.int32)
        return st
    if name in ("flag_ew", "flag_dw"):
        return {"envc": rng.integers(0, 6, (b, d)).astype(np.int32),
                "disvc": rng.integers(0, 6, (b, d)).astype(np.int32)}
    if name == "rga":
        return {"uid": np.zeros((b, s), np.int64),
                "elem": np.zeros((b, s), np.int64),
                "tomb": np.zeros((b, s), np.int32),
                "ovf": np.zeros(b, np.int32)}
    raise KeyError(name)


def effect_batch(name: str, rng, st: dict, cfg):
    """One effect per row of ``st`` (eff_a int64[b, A], eff_b int32[b,
    Bw]), holding the type's edges by row index."""
    d, mv = cfg.max_dcs, cfg.mv_slots
    b = len(next(iter(st.values())))
    rows = np.arange(b)
    if name == "counter_fat":
        a = np.zeros((b, 1 + d), np.int64)
        eb = np.zeros((b, 1 + d), np.int32)
        a[:, 0] = rng.integers(-2**35, 2**35, b)
        eb[:, 0] = rng.random(b) < 0.5
        # live rows observe the state, stale rows an older epoch (a second
        # reset of the same epoch is a no-op on that lane)
        a[:, 1:] = st["amt"] - rng.integers(0, 5, (b, d))
        eb[:, 1:] = st["epoch"] - (rng.random((b, d)) < 0.3)
        return a, eb
    if name == "counter_b":
        eb = np.zeros((b, 3), np.int32)
        eb[:, 0] = rows % 3  # increment, decrement, transfer
        eb[:, 1:] = rng.integers(0, d, (b, 2))
        # lanes past either end: -1 wraps to the last lane, D and -D-1 drop
        eb[::11, 1] = -1
        eb[5::13, 2] = d
        eb[7::17, 1] = -d - 1
        return rng.integers(1, 2**30, (b, 1)), eb
    if name == "register_lww":
        a = np.zeros((b, 2), np.int64)
        a[:, 0] = rng.integers(1, 2**62, b)
        a[:, 1] = rng.integers(0, 100, b)
        tie = rows % 3 == 0  # timestamp ties break on the handle
        a[tie, 1] = st["ts"][tie]
        a[::9, 0] = st["val"][::9]  # a full tie: unchanged
        a[::9, 1] = st["ts"][::9]
        return a, np.zeros((b, 1), np.int32)
    if name == "register_mv":
        a = np.zeros((b, 1 + mv), np.int64)
        a[:, 0] = rng.integers(1, 2**62, b)
        # observed ids: all of the state's (a sequential assign), some
        # (concurrent with the others), none (a full row overflows), or
        # ids never present
        keep = (rng.random((b, mv))
                < np.where(rows % 4 == 0, 1.0, 0.5)[:, None])
        a[:, 1:] = np.where(keep, st["ids"], 0)
        a[1::5, 1:] = 0
        a[2::7, 1:] = packed_ids(rng, (len(a[2::7]), mv), d)
        return a, np.zeros((b, 1), np.int32)
    if name in ("set_rw", "set_go"):
        pool = np.concatenate([st["elems"], _pool(rng, b)], 1)
        a = np.take_along_axis(pool, rng.integers(0, pool.shape[1], (b, 1)),
                               1)
        a[a == 0] = 5
        if name == "set_go":
            return a, np.zeros((b, 1), np.int32)
        eb = np.zeros((b, 1 + d), np.int32)
        eb[:, 0] = rng.random(b) < 0.4
        eb[:, 1:] = rng.integers(0, 8, (b, d))
        eb[eb[:, 0] == 1, 1:] = 0  # removes observe nothing
        return a, eb
    if name in ("flag_ew", "flag_dw"):
        eb = np.zeros((b, 1 + d), np.int32)
        eb[:, 0] = rng.random(b) < 0.5
        eb[:, 1:] = rng.integers(0, 8, (b, d))
        # concurrent enable and disable: the observed row misses a lane
        eb[::4, 1:] = np.maximum(st["envc"][::4] - 1, 0)
        return np.zeros((b, 1), np.int64), eb
    if name == "rga":
        return _rga_effects(rng, st["uid"])
    raise KeyError(name)


def _rga_effects(rng, uid):
    """Inserts after a present uid, at the head, or after a uid never
    inserted; deletes of a present or a missing uid."""
    b = len(uid)
    a = np.zeros((b, 2), np.int64)
    eb = np.zeros((b, 2), np.int32)
    for r in range(b):
        present = uid[r][uid[r] != 0]
        pick = rng.random()
        kind = 1 if (pick < 0.2 and present.size) else 0
        eb[r] = [kind, rng.integers(0, 300)]
        if kind == 1:
            a[r, 0] = (rng.choice(present) if rng.random() < 0.9
                       else (12345 << 24) | 1)
            continue
        a[r, 0] = rng.integers(1, 2**62)
        if present.size and pick < 0.8:
            a[r, 1] = rng.choice(present)
        elif pick < 0.95:
            a[r, 1] = 0  # head insert
        else:
            a[r, 1] = (99999 << 24) | 2  # an origin never inserted
    return a, eb


def edge_states(name: str, rng, st: dict, cfg) -> dict:
    """{"full": every slot taken (the ovf path: the argmax of an all-false
    row), "empty": nothing taken (argmax ties: the first slot)}."""
    d, e, mv, s = cfg.max_dcs, cfg.set_slots, cfg.mv_slots, cfg.rga_slots
    b = len(next(iter(st.values())))
    full = {f: x.copy() for f, x in st.items()}
    if name in ("set_rw", "set_go"):
        full["elems"] = rng.integers(1, 2**62, (b, e))
    elif name == "register_mv":
        full["ids"] = packed_ids(rng, (b, mv), d)
        full["vals"] = rng.integers(1, 2**62, (b, mv))
    elif name == "rga":
        full["uid"] = np.sort(packed_ids(rng, (b, s), d) << 16,
                              axis=1)[:, ::-1].copy()
        full["elem"] = rng.integers(1, 2**62, (b, s))
    return {"full": full,
            "empty": {f: np.zeros_like(x) for f, x in st.items()}}


# ---------------------------------------------------------------------------
# a bulk op stream
# ---------------------------------------------------------------------------
def populate_stream(name: str, rng, n_keys: int, rounds: int, cfg,
                    lanes: int = 3) -> dict:
    """A commit-ordered stream of ``rounds`` ops on each of ``n_keys``
    keys: round r gives every key one op, in a shuffled key order.  Op t
    commits at origin lane o_t (of ``lanes``) with own-lane stamp the
    count of lane-o_t ops so far; its other lanes are those counts as of a
    random earlier point up to two rounds back, so ops of one key from
    different lanes are concurrent.  The clock after op t is the cut
    ``cum[t]``: a read at it sees exactly ops 0..t.

    Effects follow each type's downstream shape: rga inserts name an
    earlier insert of the key (or the head) as origin and deletes an
    earlier uid, register_mv assigns observe earlier ids of the key, with
    the uids and ids these ops' clocks give.  Returns {"keys", "eff_a",
    "eff_b", "vcs", "origins", "cum"} (``cum`` int32[T, D])."""
    d = cfg.max_dcs
    t_all = n_keys * rounds
    keys = np.concatenate([rng.permutation(n_keys) for _ in range(rounds)])
    origins = rng.integers(0, lanes, t_all).astype(np.int32)
    onehot = np.zeros((t_all, d), np.int32)
    onehot[np.arange(t_all), origins] = 1
    cum = np.cumsum(onehot, axis=0, dtype=np.int32)
    seen = np.maximum(np.arange(t_all) - rng.integers(0, 2 * n_keys, t_all),
                      0)
    vcs = cum[seen]
    own = cum[np.arange(t_all), origins]
    vcs[np.arange(t_all), origins] = own
    # the round and position of each key's op in each round: [rounds, K]
    pos = np.empty((rounds, n_keys), np.int64)
    for r in range(rounds):
        pos[r, keys[r * n_keys:(r + 1) * n_keys]] = np.arange(
            r * n_keys, (r + 1) * n_keys)
    ty = get_type(name)
    a = np.zeros((t_all, ty.eff_a_width(cfg)), np.int64)
    b = np.zeros((t_all, ty.eff_b_width(cfg)), np.int32)
    if name == "counter_fat":
        a[:, 0] = rng.integers(-1000, 1000, t_all)
        b[:, 0] = rng.random(t_all) < 0.15
        a[:, 1:] = rng.integers(0, 2000, (t_all, d))
        b[:, 1:] = rng.integers(0, 3, (t_all, d))
    elif name == "counter_b":
        b[:, 0] = rng.integers(0, 3, t_all)
        b[:, 1] = origins
        b[:, 2] = rng.integers(0, lanes, t_all)
        a[:, 0] = rng.integers(1, 100, t_all)
    elif name == "register_lww":
        a[:, 0] = rng.integers(1, 2**62, t_all)
        a[:, 1] = np.arange(t_all) // 4  # ts ties break on the handle
    elif name in ("set_rw", "set_go"):
        pool = rng.integers(1, 2**62, (n_keys, 12))
        a[:, 0] = pool[keys, rng.integers(0, 12, t_all)]
        if name == "set_rw":
            b[:, 0] = rng.random(t_all) < 0.35
            b[:, 1:] = np.where(b[:, :1] == 1, 0,
                                rng.integers(0, 4, (t_all, d)))
    elif name in ("flag_ew", "flag_dw"):
        b[:, 0] = rng.random(t_all) < 0.5
        b[:, 1:] = vcs * (rng.random((t_all, 1)) < 0.7)
    elif name == "register_mv":
        a[:, 0] = rng.integers(1, 2**62, t_all)
        ids = (own.astype(np.int64) << 8) | origins
        for back in range(1, min(cfg.mv_slots, rounds - 1) + 1):
            # observe the key's op `back` rounds earlier, or miss it (a
            # concurrent assign)
            cur, prev = pos[back:], pos[:-back]
            hit = rng.random(cur.shape) < 0.6
            a[cur[hit], back] = ids[prev[hit]]
    elif name == "rga":
        # one op a txn: op seq 0, so a uid is (stamp << 24) | origin
        uids = (own.astype(np.int64) << 24) | origins
        a[:, 0] = rng.integers(1, 2**62, t_all)
        deleted = np.zeros((rounds, n_keys), bool)  # round 0 inserts
        every = np.arange(n_keys)
        for r in range(1, rounds):
            # an earlier insert of the key: a random earlier round, or the
            # first when that round's op was a delete
            back_r = rng.integers(0, r, n_keys)
            back_r[deleted[back_r, every]] = 0
            back = pos[back_r, every]
            cur = pos[r]
            is_del = rng.random(n_keys) < 0.2
            deleted[r] = is_del
            b[cur[is_del], 0] = 1
            a[cur[is_del], 0] = uids[back[is_del]]
            ins = ~is_del & (rng.random(n_keys) >= 0.2)  # else at the head
            a[cur[ins], 1] = uids[back[ins]]
    return {"keys": keys, "eff_a": a, "eff_b": b, "vcs": vcs,
            "origins": origins, "cum": cum}
