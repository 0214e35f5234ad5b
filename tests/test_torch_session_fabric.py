"""The session fabric of the port: the cases of ``tests/test_session_fabric.py``
on the port's modules, then the rings held against the JAX package's.

Three algebras with seeded randomized sweeps: the session-token algebra
(``codec.merge_clock`` commutative, associative, idempotent and monotone,
and its agreement with the follower's per-shard applied gate); the apb
typed-error round trip (lagging/not_owner redirects riding the errmsg);
the hash-ring algebra (fleet-wide agreement on arc owners, arc-only
shedding when an endpoint dies, per-client seeded fallback orders).
Across the packages: the port's ``HashRing`` gives the JAX ring's preferred
endpoint, failover order and arc shares for the same fleet and seed, and
the errmsg with its ``fleet=`` hint is the same text.  Tolerance: exact
equality (arc shares are computed from equal integers).
"""

import numpy as np
import pytest

from antidote_tpu.proto import apb as japb
from antidote_tpu.proto.client import HashRing as JRing
from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto.client import HashRing
from antidote_tpu_torch.proto.codec import merge_clock

# ---------------------------------------------------------------------------
# session-token algebra
# ---------------------------------------------------------------------------
def _rand_clock(rng, max_len=6):
    if rng.random() < 0.1:
        return None
    n = int(rng.integers(1, max_len + 1))
    return [int(x) for x in rng.integers(0, 50, size=n)]


def _norm(c, width):
    out = [0] * width
    if c:
        out[: len(c)] = [int(x) for x in c]
    return out


def test_merge_clock_commutative_associative_idempotent():
    rng = np.random.default_rng(11)
    for _ in range(500):
        a, b, c = (_rand_clock(rng) for _ in range(3))
        ab, ba = merge_clock(a, b), merge_clock(b, a)
        assert ab == ba, (a, b)
        assert merge_clock(merge_clock(a, b), c) \
            == merge_clock(a, merge_clock(b, c)), (a, b, c)
        aa = merge_clock(a, a)
        assert aa == (None if a is None else [int(x) for x in a])
        # identity: None is the empty token
        assert merge_clock(a, None) == (
            None if a is None else [int(x) for x in a])


def test_merge_clock_monotone_entrywise():
    """merge(a, b) dominates both inputs entry-wise (padded) — the
    property that makes the token a least-upper-bound accumulator:
    folding any observation never loses causal coverage."""
    rng = np.random.default_rng(12)
    for _ in range(500):
        a, b = _rand_clock(rng), _rand_clock(rng)
        m = merge_clock(a, b)
        if m is None:
            assert a is None and b is None
            continue
        w = len(m)
        na, nb = _norm(a, w), _norm(b, w)
        assert all(x >= y for x, y in zip(m, na))
        assert all(x >= y for x, y in zip(m, nb))
        assert m == [max(x, y) for x, y in zip(na, nb)]


def test_merge_clock_monotone_vs_applied_gate():
    """The follower gate admits a token iff the per-shard applied clock
    dominates it.  Monotonicity of the merge means: the MERGED token is
    admitted ⟺ every constituent clock is admitted — so folding more
    observations into a session can only tighten (never corrupt) the
    gate decision, and an admitted merged token proves RYW for every
    observation folded in."""
    rng = np.random.default_rng(13)
    width = 4
    for _ in range(300):
        applied = np.asarray(
            [int(x) for x in rng.integers(0, 30, size=width)], np.int64)
        a = _rand_clock(rng, max_len=width)
        b = _rand_clock(rng, max_len=width)
        m = merge_clock(a, b)

        def admitted(c):
            return (applied >= np.asarray(_norm(c, width),
                                          np.int64)).all()

        assert admitted(m) == (admitted(a) and admitted(b)), (
            applied, a, b, m)


# ---------------------------------------------------------------------------
# apb typed-error round-trips
# ---------------------------------------------------------------------------
def test_apb_error_text_round_trips():
    rng = np.random.default_rng(21)
    hosts = ["127.0.0.1", "owner.example.com", "10.0.0.7", "::1"]
    for _ in range(300):
        kind = ["lagging", "not_owner", "busy", "deadline",
                "read_only"][int(rng.integers(5))]
        retry = int(rng.integers(0, 600))
        redirect = None
        if rng.random() < 0.6:
            redirect = [hosts[int(rng.integers(len(hosts)))],
                        int(rng.integers(1, 65536))]
        detail = ["follower f1 is healing",
                  "behind the token after a 100 ms park",
                  "weird: detail: with colons",
                  "multi\nline detail"][int(rng.integers(4))]
        text = apb.error_text(kind, detail, retry, redirect)
        out = apb.parse_error_text(text)
        assert out["kind"] == kind
        assert out["retry_after_ms"] == retry
        assert out["redirect"] == redirect
        assert out["detail"] == detail


def test_apb_error_frame_round_trips_through_wire_encoding():
    """The full wire path: typed exception -> _error_resp -> proto2
    ApbErrorResp frame bytes -> decode -> parse_error_text recovers the
    typed fields the session client keys its failover on."""
    from antidote_tpu_torch.overload import NotOwnerError, ReplicaLagging

    cases = [
        ReplicaLagging("behind the token", retry_after_ms=175,
                       redirect=("owner-host", 8087)),
        NotOwnerError(redirect=("10.1.2.3", 9001)),
    ]
    for e in cases:
        name, body = apb._error_resp(e)
        assert name == "ApbErrorResp"
        frame = apb.encode_frame_body(name, body)
        rname, resp = apb.decode_frame_body(frame)
        assert rname == "ApbErrorResp"
        out = apb.parse_error_text(resp["errmsg"])
        if isinstance(e, ReplicaLagging):
            assert out["kind"] == "lagging"
            assert out["retry_after_ms"] == 175
            assert out["redirect"] == ["owner-host", 8087]
        else:
            assert out["kind"] == "not_owner"
            assert out["redirect"] == ["10.1.2.3", 9001]
    # an untyped reference-style error parses as the catch-all
    out = apb.parse_error_text(b"KeyError: unknown transaction")
    assert out["kind"] == "error" and out["redirect"] is None
    # malformed param values from a foreign server never crash — the
    # field falls back to its default
    out = apb.parse_error_text(b"busy retry_after_ms=unknown: full")
    assert out["kind"] == "busy" and out["retry_after_ms"] == 0
    out = apb.parse_error_text(b"not_owner redirect=host:none: go away")
    assert out["kind"] == "not_owner" and out["redirect"] is None


def test_apb_update_and_value_bridges_round_trip():
    """The client-side bridges invert the server-side ones for the
    wire-expressible ops: native update tuple -> ApbUpdateOp -> the
    server's ops_from_update_operation recovers the op, and
    value_to_read_resp -> read_resp_to_value recovers the value."""
    ups = [
        (b"k", "counter_pn", b"b", ("increment", 5)),
        (b"k", "counter_pn", b"b", ("decrement", 2)),
        (b"s", "set_aw", b"b", ("add", b"x")),
        (b"s", "set_rw", b"b", ("remove_all", [b"x", b"y"])),
        (b"r", "register_lww", b"b", ("assign", b"v1")),
        (b"f", "flag_ew", b"b", ("enable", None)),
    ]
    for key, t, bucket, op in ups:
        wire = apb.update_op_from_native((key, t, bucket, op))
        frame = apb.encode_msg("ApbUpdateOp", wire)
        back = apb.decode_msg("ApbUpdateOp", frame)
        got = apb.updates_from_update_ops([back])
        assert got[0][0] == key and got[0][1] == t and got[0][2] == bucket
        kind, arg = got[0][3][0], got[0][3][1]
        if op[0] == "decrement":
            # plain counters ride a negative increment on the wire
            assert (kind, arg) == ("increment", -2)
        elif op[0] in ("add", "remove_all"):
            vals = [op[1]] if op[0] == "add" else list(op[1])
            assert kind.endswith("_all") and list(arg) == vals
        elif op[0] == "enable":
            assert kind == "enable"
        else:
            assert (kind, arg) == op
    vals = [("counter_pn", 7), ("set_aw", [b"a", b"b"]),
            ("register_lww", b"v"), ("flag_dw", True)]
    for t, v in vals:
        resp = apb.value_to_read_resp(t, v)
        frame = apb.encode_msg("ApbReadObjectResp", resp)
        back = apb.decode_msg("ApbReadObjectResp", frame)
        assert apb.read_resp_to_value(back) == v


def test_apb_map_ops_ride_the_mapop_lane():
    """Map-CRDT field ops encode through mapop (nested updates /
    removedKeys), never the set lanes — the server-side decoder
    recovers the exact field ops."""
    up = (b"m", "map_rr", b"b",
          ("update", [((b"f", "counter_pn"), ("increment", 3)),
                      ((b"g", "register_lww"), ("assign", b"v"))]))
    wire = apb.update_op_from_native(up)
    back = apb.decode_msg("ApbUpdateOp",
                          apb.encode_msg("ApbUpdateOp", wire))
    got = apb.updates_from_update_ops([back])
    assert got == [(b"m", "map_rr", b"b",
                    ("update", [((b"f", "counter_pn"),
                                 ("increment", 3)),
                                ((b"g", "register_lww"),
                                 ("assign", b"v"))]))], got
    rm = (b"m", "map_rr", b"b",
          ("remove_all", [(b"f", "counter_pn")]))
    wire = apb.update_op_from_native(rm)
    back = apb.decode_msg("ApbUpdateOp",
                          apb.encode_msg("ApbUpdateOp", wire))
    got = apb.updates_from_update_ops([back])
    assert got == [(b"m", "map_rr", b"b",
                    ("remove_all", [(b"f", "counter_pn")]))], got
    with pytest.raises(ValueError, match="no apb wire form"):
        apb._op_to_operation("map_rr", ("weird_op", None))


# ---------------------------------------------------------------------------
# hash-ring algebra
# ---------------------------------------------------------------------------
def _fleet(n):
    return [(f"10.0.0.{i}", 8000 + i) for i in range(n)]


def test_ring_fleet_wide_agreement_and_determinism():
    """Placement is seed-independent (every client agrees on each key's
    arc owner) and deterministic across rebuilds."""
    eps = _fleet(8)
    r1 = HashRing(eps, seed=1)
    r2 = HashRing(list(reversed(eps)), seed=999)
    for k in range(200):
        assert r1.preferred(k, "b") == r2.preferred(k, "b")
    # and the full order is deterministic per seed
    r1b = HashRing(eps, seed=1)
    for k in range(50):
        assert r1.order(k, "b") == r1b.order(k, "b")


def test_ring_death_sheds_only_its_arcs():
    """Removing one endpoint remaps ONLY the keys it owned: every other
    key keeps its preferred replica (the O(1)-failover property a
    modular map does not have)."""
    eps = _fleet(8)
    full = HashRing(eps)
    dead = eps[3]
    survivors = HashRing([e for e in eps if e != dead])
    moved = 0
    for k in range(2000):
        before = full.preferred(k, "b")
        after = survivors.preferred(k, "b")
        if before == dead:
            moved += 1
            assert after != dead
        else:
            assert after == before, k
    # the dead endpoint owned roughly 1/8 of the keyspace
    assert 0 < moved < 2000 * 0.3


def test_ring_arc_shares_roughly_balanced():
    shares = HashRing(_fleet(8), vnodes=64).arc_share()
    assert abs(sum(shares.values()) - 1.0) < 1e-9
    for ep, s in shares.items():
        assert 0.02 < s < 0.35, (ep, s)


def test_ring_fallback_is_seeded_jittered_per_client():
    """The anti-stampede satellite: different clients order the
    fallback tail differently (so a dead arc's load spreads), while one
    client's order stays deterministic and always starts at the common
    preferred replica."""
    eps = _fleet(8)
    rings = [HashRing(eps, seed=s) for s in range(6)]
    diverged = 0
    for k in range(100):
        orders = [r.order(k, "b") for r in rings]
        heads = {tuple(o[:1]) for o in orders}
        assert len(heads) == 1  # common preferred
        tails = {tuple(o[1:]) for o in orders}
        if len(tails) > 1:
            diverged += 1
        for o in orders:
            assert sorted(o) == sorted(eps)  # a permutation, no loss
    # with 6 seeds over 7! tail orders, essentially every key diverges
    assert diverged > 90


def test_session_client_seeds_differ_without_explicit_seed():
    from antidote_tpu_torch.proto.client import SessionClient

    seeds = set()
    for _ in range(8):
        sc = SessionClient(("127.0.0.1", 1), _fleet(4))
        seeds.add(sc.seed)
        sc.close()
    assert len(seeds) == 8


def test_session_client_empty_read_routes_to_owner():
    """An empty objects list has no routing key: the candidate walk
    degenerates to the owner alone instead of crashing on objects[0]."""
    from antidote_tpu_torch.proto.client import SessionClient

    sc = SessionClient(("127.0.0.1", 1), _fleet(4))
    assert list(sc._read_candidates([])) == [("127.0.0.1", 1)]
    sc.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,vnodes,seed", [(1, 64, 0), (3, 64, 7),
                                           (8, 64, 12345), (5, 16, 2**63)])
def test_ring_arcs_equal_the_jax_ring(n, vnodes, seed):
    eps = _fleet(n)
    mine, theirs = HashRing(eps, vnodes, seed), JRing(eps, vnodes, seed)
    assert mine._points == theirs._points
    assert mine.arc_share() == theirs.arc_share()
    assert mine.arc_share_by_name() == theirs.arc_share_by_name()
    rng = np.random.default_rng(seed % (2**32))
    keys = ([int(k) for k in rng.integers(0, 1 << 40, 200)]
            + [f"user:{i}" for i in range(100)] + [b"raw", ("t", 1)])
    for k in keys:
        assert mine.preferred(k, "b") == theirs.preferred(k, "b")
        assert mine.order(k, "b") == theirs.order(k, "b")


def test_errmsg_with_fleet_hint_equals_the_jax_text():
    for args in (("lagging", "behind", 40, ["h", 1]),
                 ("not_owner", "go", 0, ["10.0.0.1", 8087]),
                 ("forward_failed", "died", 0, None)):
        for fleet in (None, [["fa", 10], ["fb", 11]]):
            mine = apb.error_text(*args, fleet=fleet)
            assert mine == japb.error_text(*args, fleet=fleet)
            assert apb.parse_error_text(mine) == japb.parse_error_text(mine)
