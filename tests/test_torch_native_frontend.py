"""The port's native serving front end on the CPU, against its own Python
plane and the JAX package's native plane.

Counterparts of ``tests/test_native_frontend.py``: stats, whole-batch hit
bytes, mirror convergence without overshoot, the frame-fuzz corpus,
admission-shed parity, the kill switch, the ``frontend.recv`` faults on
the native path and the SIGKILL storm over ``console serve --device
cpu``.  Then the port's own cases: no fallback (an injected
``native_frontend.load`` fault raises where the JAX package serves from
its Python plane), a key born on a row the cold tier freed is never
served from the mirror, ``_native_lag_raised`` stops clockless native
hits until the next advance, and a fill that lands after its key's
invalidation is not carried to the next epoch (the JAX copy carries it).

The JAX package's native library is built into a private directory for
this module, so a concurrent build by its own tests is never loaded.
"""

from __future__ import annotations

import json
import os
import random
import select
import selectors
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import msgpack
import numpy as np
import pytest

from antidote_tpu import faults as jfaults
from antidote_tpu.api.node import AntidoteNode as JNode
from antidote_tpu.config import AntidoteConfig as JConfig
from antidote_tpu.proto.client import AntidoteClient as JClient
from antidote_tpu.proto.server import ProtocolServer as JServer
from antidote_tpu_torch import faults
from antidote_tpu_torch.api.node import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.obs.metrics import net_metrics
from antidote_tpu_torch.proto.client import AntidoteClient
from antidote_tpu_torch.proto.codec import (MAX_FRAME, MessageCode, decode,
                                            read_frame)
from antidote_tpu_torch.proto.native_frontend import (
    NativeFrontend, NativeFrontendUnavailable)
from antidote_tpu_torch.proto.server import ProtocolServer

ROOT = Path(__file__).resolve().parent.parent
_HDR = struct.Struct(">I")
KW = dict(n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
          set_slots=8, rga_slots=16, keys_per_table=64)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native front end, its library built into this
    module's own directory."""
    from antidote_tpu.proto import native_frontend as jnf

    mp = pytest.MonkeyPatch()
    mp.setattr(jnf, "_SO", tmp_path_factory.mktemp("jaxfe") / "_frontend.so")
    mp.setattr(jnf, "_lib", None)
    mp.setattr(jnf, "_lib_tried", False)
    yield jnf
    mp.undo()


def _port(native: bool, **kw):
    node = AntidoteNode(AntidoteConfig(**KW), device="cpu")
    return node, ProtocolServer(node, port=0, native_frontend=native, **kw)


def _jax(jnf, **kw):
    node = JNode(JConfig(batch_buckets=(8, 64), **KW))
    srv = JServer(node, port=0, native_frontend=True, **kw)
    assert srv.native is not None, "the JAX native plane did not load"
    return node, srv


def _raw_frame(code: int, body) -> bytes:
    payload = bytes([code]) + msgpack.packb(body, use_bin_type=True)
    return _HDR.pack(len(payload)) + payload


def _probe(port: int, raw: bytes, timeout: float = 10.0):
    """Send raw bytes on a fresh conn, half-close, and report ("reply",
    frame) or ("closed", None)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    try:
        s.sendall(raw)
        s.shutdown(socket.SHUT_WR)
        try:
            return ("reply", read_frame(s))
        except (ConnectionError, OSError):
            return ("closed", None)
    finally:
        s.close()


def _native_hit_reply(srv, req: bytes, timeout: float = 20.0) -> bytes:
    """Send ``req`` on one connection until the native plane has served
    one whole-batch hit, then once more: that reply is native-served."""
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    s.settimeout(10)
    try:
        deadline = time.monotonic() + timeout
        hits0 = srv.native.stats()["native_hits"]
        while srv.native.stats()["native_hits"] == hits0:
            assert time.monotonic() < deadline, \
                "the native plane never served a whole-batch hit"
            s.sendall(req)
            read_frame(s)
        hits1 = srv.native.stats()["native_hits"]
        s.sendall(req)
        out = read_frame(s)
        assert srv.native.stats()["native_hits"] == hits1 + 1
        return out
    finally:
        s.close()


# ---------------------------------------------------------------------------
# basic serving + observability
# ---------------------------------------------------------------------------
def test_native_plane_serves_and_reports_stats():
    node, srv = _port(True)
    c = AntidoteClient(port=srv.port)
    try:
        c.update_objects([("k", "counter_pn", "b", ("increment", 5))])
        vals, clock = c.read_objects([("k", "counter_pn", "b")])
        # clocked read-your-writes still holds through the native accept
        vals2, _ = c.read_objects([("k", "counter_pn", "b")], clock=clock)
        assert vals == vals2 == [5]
        st = srv.native.stats()
        assert set(st) == set(NativeFrontend.STAT_FIELDS)
        assert st["accepted"] >= 1 and st["frames"] >= 3
        assert srv._pipeline_status()["native"]["open_conns"] >= 1
        assert node.store.native_mirror is srv.native
    finally:
        c.close()
        srv.close()
    assert node.store.native_mirror is None


# ---------------------------------------------------------------------------
# whole-batch hit bytes: the port's native plane, its Python plane and the
# JAX native plane, on one seeded script
# ---------------------------------------------------------------------------
def _hit_script(seed: int):
    rng = random.Random(seed)
    ups, objs = [], []
    for i in range(6):
        ups.append((f"c{i}", "counter_pn", "b",
                    ("increment", rng.randrange(1, 50))))
        ups.append((f"s{i}", "set_aw", "b",
                    ("add_all", [rng.randrange(1000) for _ in range(3)])))
        ups.append((f"f{i}", "flag_ew", "b", ("enable", None)))
        objs += [(f"c{i}", "counter_pn", "b"), (f"s{i}", "set_aw", "b"),
                 (f"f{i}", "flag_ew", "b")]
    objs.append(("never", "set_aw", "b"))  # a never-written key: bottom
    return ups, objs


def test_whole_batch_hit_bytes_match_python_and_jax(jax_native):
    ups, objs = _hit_script(0xB17E)
    req = _raw_frame(MessageCode.STATIC_READ_OBJECTS,
                     {"objects": [list(o) for o in objs], "clock": None})
    replies = {}
    for name in ("port_native", "port_python", "jax_native"):
        if name == "jax_native":
            node, srv = _jax(jax_native, epoch_tick_ms=25)
        else:
            node, srv = _port(name == "port_native", epoch_tick_ms=25)
        try:
            c = (JClient if name == "jax_native" else AntidoteClient)(
                port=srv.port)
            try:
                c.update_objects(ups)
            finally:
                c.close()
            # quiescent: the ticker re-advances one clock from here on
            time.sleep(0.5)
            if srv.native is not None:
                replies[name] = _native_hit_reply(srv, req)
            else:
                replies[name] = _probe(srv.port, req)[1]
        finally:
            srv.close()
    assert replies["port_native"] == replies["port_python"] \
        == replies["jax_native"], replies
    code, body = decode(replies["port_native"])
    assert code == MessageCode.READ_OBJECTS_RESP
    assert body["values"][-1] == [] and body["commit_clock"] == [1, 0]


# ---------------------------------------------------------------------------
# write invalidation: clockless reads through the mirror converge and never
# overshoot
# ---------------------------------------------------------------------------
def test_native_mirror_invalidation_converges_and_never_overshoots():
    node, srv = _port(True, epoch_tick_ms=25)
    c = AntidoteClient(port=srv.port)
    try:
        total = 0
        for round_ in range(8):
            total += 1
            c.update_objects([("wk", "counter_pn", "b", ("increment", 1))])
            deadline = time.monotonic() + 20
            while True:
                vals, _ = c.read_objects([("wk", "counter_pn", "b")])
                assert vals[0] <= total, (round_, vals[0], total)
                if vals[0] == total:
                    break
                assert time.monotonic() < deadline, \
                    f"clockless read stuck at {vals[0]} < {total}"
                time.sleep(0.01)
            for _ in range(4):
                vals, _ = c.read_objects([("wk", "counter_pn", "b")])
                assert vals == [total]
        assert srv.native.stats()["native_hits"] > 0
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# frame-fuzz parity: one seeded corpus of wrecked frames, identical answers
# from the three planes
# ---------------------------------------------------------------------------
def _fuzz_corpus():
    rng = random.Random(0xF00D)
    corpus = [
        ("valid-read", _raw_frame(
            MessageCode.STATIC_READ_OBJECTS,
            {"objects": [["fz", "counter_pn", "b"]], "clock": None})),
        ("valid-read-miss", _raw_frame(
            MessageCode.STATIC_READ_OBJECTS,
            {"objects": [["nope", "counter_pn", "b"]], "clock": None})),
        ("bcounter-mint", _raw_frame(
            MessageCode.STATIC_UPDATE_OBJECTS,
            {"updates": [["bz", "counter_b", "b", ["increment", [3, 0]]]],
             "clock": None})),
        ("bcounter-overdraw", _raw_frame(
            MessageCode.STATIC_UPDATE_OBJECTS,
            {"updates": [["bz", "counter_b", "b", ["decrement", [9, 0]]]],
             "clock": None})),
    ]
    for i in range(6):
        junk = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40)))
        payload = bytes([MessageCode.STATIC_READ_OBJECTS]) + junk
        corpus.append((f"garbage-body-{i}", _HDR.pack(len(payload)) + payload))
    corpus.append(("wrong-shape", _raw_frame(
        MessageCode.STATIC_READ_OBJECTS, {"objects": 42})))
    corpus.append(("unknown-code", _HDR.pack(2) + bytes([251]) + b"\xc0"))
    corpus.append(("zero-length", _HDR.pack(0) + b"\x00"))
    corpus.append(("oversized-length", _HDR.pack(MAX_FRAME + 1)))
    corpus.append(("truncated-header", b"\x00\x00"))
    corpus.append(("empty-conn", b""))
    for i in range(4):
        n = rng.randrange(8, 200)
        sent = rng.randrange(0, n - 3)
        corpus.append((f"mid-frame-close-{i}", _HDR.pack(n) + bytes(sent)))
    return corpus


def test_frame_fuzz_corpus_parity(jax_native):
    planes = {"port_native": _port(True), "port_python": _port(False),
              "jax_native": _jax(jax_native)}
    try:
        for name, (_node, srv) in planes.items():
            c = (JClient if name == "jax_native" else AntidoteClient)(
                port=srv.port)
            c.update_objects([("fz", "counter_pn", "b", ("increment", 3))])
            c.close()
        time.sleep(0.4)
        mismatches = []
        for name, raw in _fuzz_corpus():
            outs = {p: _probe(srv.port, raw)
                    for p, (_n, srv) in planes.items()}
            kinds = {o[0] for o in outs.values()}
            if len(kinds) != 1:
                mismatches.append((name, {p: o[0] for p, o in outs.items()}))
                continue
            if kinds == {"closed"}:
                continue
            decoded = {p: decode(o[1]) for p, o in outs.items()}
            codes = {c for c, _b in decoded.values()}
            if len(codes) != 1:
                mismatches.append((name, codes))
            elif codes == {MessageCode.ERROR_RESP}:
                # typed errors byte for byte: name, detail, layout
                if len({o[1] for o in outs.values()}) != 1:
                    mismatches.append((name, {p: b for p, (_c, b)
                                              in decoded.items()}))
            elif len({json.dumps(b.get("values"))
                      for _c, b in decoded.values()}) != 1:
                mismatches.append((name, {p: b.get("values") for p, (_c, b)
                                          in decoded.items()}))
        assert not mismatches, mismatches
    finally:
        for _n, srv in planes.values():
            srv.close()


# ---------------------------------------------------------------------------
# admission-shed parity: the same typed busy reply from the three planes
# ---------------------------------------------------------------------------
def _shed_bytes(node, srv, in_flight):
    """Wedge the commit plane, park one admitted update, and capture the
    raw busy frame a second same-host connection receives."""
    a = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    a.settimeout(30)
    b = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    b.settimeout(10)
    try:
        with node.txm.commit_lock:
            a.sendall(_raw_frame(MessageCode.STATIC_UPDATE_OBJECTS, {
                "updates": [["sk", "counter_pn", "b", ["increment", 1]]],
                "clock": None}))
            deadline = time.monotonic() + 20
            while in_flight() < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            b.sendall(_raw_frame(MessageCode.STATIC_READ_OBJECTS, {
                "objects": [["cold", "counter_pn", "b"]], "clock": None}))
            busy = read_frame(b)
        _code, body = decode(read_frame(a))
        assert "commit_clock" in body, body
        return busy
    finally:
        a.close()
        b.close()


def test_admission_shed_busy_reply_parity(jax_native):
    caps = dict(max_in_flight=64, max_in_flight_per_client=1)
    out = {}
    node, srv = _port(True, **caps)
    try:
        out["port_native"] = _shed_bytes(
            node, srv, lambda: srv.native.stats()["in_flight"])
        assert srv.native.stats()["sheds"] >= 1
    finally:
        srv.close()
    node, srv = _port(False, **caps)
    try:
        out["port_python"] = _shed_bytes(node, srv, srv.admission.in_flight)
    finally:
        srv.close()
    node, srv = _jax(jax_native, **caps)
    try:
        out["jax_native"] = _shed_bytes(
            node, srv, lambda: srv.native.stats()["in_flight"])
    finally:
        srv.close()
    assert len(set(out.values())) == 1, out
    code, body = decode(out["port_native"])
    assert code == MessageCode.ERROR_RESP and body["error"] == "busy"
    assert body["detail"] == "client 127.0.0.1 at max_in_flight_per_client=1"
    assert body["retry_after_ms"] >= 25


# ---------------------------------------------------------------------------
# the operator's switch, no fallback, fault sites
# ---------------------------------------------------------------------------
def test_env_kill_switch_serves_the_python_plane_and_counts(monkeypatch):
    monkeypatch.setenv("ANTIDOTE_NATIVE_FRONTEND", "off")
    before = net_metrics().frontend_fallback.value()
    node, srv = _port(True)
    c = AntidoteClient(port=srv.port)
    try:
        assert srv.native is None and node.store.native_mirror is None
        assert net_metrics().frontend_fallback.value() == before + 1
        c.update_objects([("e", "counter_pn", "b", ("increment", 2))])
        assert c.read_objects([("e", "counter_pn", "b")])[0] == [2]
        assert "native" not in srv._pipeline_status()
    finally:
        c.close()
        srv.close()


def test_injected_load_failure_raises_where_jax_falls_back(jax_native):
    for pkg in (faults, jfaults):
        plan = pkg.FaultPlan(seed=3)
        plan.error("native_frontend.load")
        pkg.install(plan)
    node = AntidoteNode(AntidoteConfig(**KW), device="cpu")
    threads = {t.name for t in threading.enumerate()}
    with pytest.raises(NativeFrontendUnavailable, match="native_frontend"):
        ProtocolServer(node, port=0, native_frontend=True)
    # nothing of the refused server keeps running
    assert {t.name for t in threading.enumerate()} <= threads
    assert node.store.native_mirror is None
    jnode = JNode(JConfig(batch_buckets=(8, 64), **KW))
    jsrv = JServer(jnode, port=0, native_frontend=True)
    try:
        assert jsrv.native is None  # the JAX package serves on, silently
    finally:
        jsrv.close()


def test_unbindable_port_raises():
    node, srv = _port(True)
    try:
        with pytest.raises(NativeFrontendUnavailable, match="bind"):
            ProtocolServer(AntidoteNode(AntidoteConfig(**KW), device="cpu"),
                           port=srv.port, native_frontend=True)
    finally:
        srv.close()


def test_frontend_recv_faults_fire_on_native_path():
    """frontend.recv drop/truncate rules apply per drained frame on the
    native plane too, and an armed frontend.* rule turns fast-serve off at
    boot, so no frame dodges the plan through a C++ hit."""
    plan = faults.FaultPlan(seed=11)
    plan.drop("frontend.recv", times=1)
    plan.truncate("frontend.recv", times=1, keep=5)
    inj = faults.install(plan)
    node, srv = _port(True)
    try:
        assert node.store.native_mirror is None
        req = _raw_frame(MessageCode.STATIC_READ_OBJECTS, {
            "objects": [["k", "counter_pn", "b"]], "clock": None})
        assert _probe(srv.port, req)[0] == "closed"
        out = _probe(srv.port, req)
        assert out[0] == "reply" and decode(out[1])[0] == \
            MessageCode.ERROR_RESP
        out = _probe(srv.port, req)
        assert out[0] == "reply" and decode(out[1])[0] == \
            MessageCode.READ_OBJECTS_RESP
        assert inj.fired("frontend.recv") == 2
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the port's own mirror cases
# ---------------------------------------------------------------------------
def test_reused_row_after_eviction_is_never_served_from_the_mirror(tmp_path):
    """Evict keys the mirror serves, let a new key take a freed row, then
    read everything through the native plane: every value exact, before
    and after the next advance."""
    from antidote_tpu_torch.store.kv import key_to_shard

    cfg = AntidoteConfig(n_shards=4, max_dcs=3, ops_per_key=8,
                         snap_versions=2, set_slots=8, keys_per_table=64)
    node = AntidoteNode(cfg, log_dir=str(tmp_path / "w"),
                        resident_rows=1 << 30, device="cpu")
    store, txm = node.store, node.txm
    # the ticker never fires: the test advances the mirror itself
    srv = ProtocolServer(node, port=0, native_frontend=True,
                         epoch_tick_ms=600_000)
    c = AntidoteClient(port=srv.port)
    try:
        objs = [(("old", i), "set_aw", "b") for i in range(8)]
        for i, o in enumerate(objs):
            node.update_objects([(o[0], "set_aw", "b",
                                  ("add_all", [i, 100 + i]))])
        want_old = node.read_objects(objs)[0]
        node.checkpoint_now()
        t = store.tables["set_aw"]
        shard = key_to_shard(("old", 0), "b", cfg.n_shards)
        new = next(k for k in (("new", j) for j in range(10_000))
                   if key_to_shard(k, "b", cfg.n_shards) == shard)
        everything = objs + [(new, "set_aw", "b")]
        txm.publish_serving_epoch()
        srv._native_advance()
        hits = srv.native.stats()["native_hits"]
        for _ in range(3):  # the mirror learns the old keys and new's bottom
            assert c.read_objects(everything)[0] == want_old + [[]]
        assert srv.native.stats()["native_hits"] > hits
        assert srv.native.stats()["mirror_size"] == 9
        with txm.commit_lock:
            assert store.cold.evict_now(max_rows=8) == 8
        assert srv.native.stats()["mirror_size"] == 1  # new's bottom
        freed = set(t.free_rows.get(shard, ()))
        vc_new = node.update_objects([(new, "set_aw", "b", ("add", 7))])
        assert store.directory[(new, "b")][1:] in {(shard, r) for r in freed}
        assert srv.native.stats()["mirror_size"] == 0
        for _ in range(3):
            assert c.read_objects(everything)[0] == want_old + [[7]]
            assert c.read_objects(everything, clock=vc_new)[0] == \
                want_old + [[7]]
        # the faulted-in keys stay marked on the current epoch; a later
        # commit's epoch serves them again, from the mirror too
        node.update_objects([(("other", 0), "counter_pn", "b",
                              ("increment", 1))])
        assert txm.publish_serving_epoch() in ("published", "noop")
        srv._native_advance()
        hits = srv.native.stats()["native_hits"]
        for _ in range(3):
            assert c.read_objects(everything)[0] == want_old + [[7]]
        assert srv.native.stats()["native_hits"] > hits
    finally:
        c.close()
        srv.close()
        node.close()


def test_native_lag_raised_stops_clockless_hits_until_the_next_advance():
    node, srv = _port(True, epoch_tick_ms=600_000)
    c = AntidoteClient(port=srv.port)
    obj = [("lag", "counter_pn", "b")]
    try:
        c.update_objects([("lag", "counter_pn", "b", ("increment", 4))])
        node.txm.publish_serving_epoch()
        srv._native_advance()

        def hits():
            return srv.native.stats()["native_hits"]

        assert c.read_objects(obj)[0] == [4]  # fills
        h = hits()
        assert c.read_objects(obj)[0] == [4]
        assert hits() == h + 1
        node.txm._native_lag_raised()
        for _ in range(3):
            assert c.read_objects(obj)[0] == [4]
        assert hits() == h + 1  # every read crossed to Python
        srv._native_advance()
        assert c.read_objects(obj)[0] == [4]
        assert hits() == h + 2
    finally:
        c.close()
        srv.close()


def _mirror_serves(nf, key) -> bool:
    """True when the native plane answers a clockless read of ``key``
    itself; False when the frame crosses to Python."""
    req = _raw_frame(MessageCode.STATIC_READ_OBJECTS,
                     {"objects": [[key, "counter_pn", "b"]], "clock": None})
    s = socket.create_connection(("127.0.0.1", nf.port), timeout=10)
    s.settimeout(2)
    try:
        s.sendall(req)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if select.select([s], [], [], 0.05)[0]:
                read_frame(s)
                return True
            if any(k == nf.K_FRAME for _c, k, _a, _p in nf.take_batch(50)):
                return False
        raise AssertionError("no reply and no crossing")
    finally:
        s.close()


def test_fill_after_invalidation_is_not_carried_to_the_next_epoch(
        jax_native):
    """A writeback's fill can land after the commit that invalidated its
    key: the port's mirror serves it at its own epoch and drops it at the
    next advance; the JAX copy re-stamps it and serves the pre-write value
    at an epoch that covers the write."""
    planes = {"port": NativeFrontend.create("127.0.0.1", 0, 64, 64, 64),
              "jax": jax_native.NativeFrontend.create("127.0.0.1", 0, 64,
                                                      64, 64)}
    served = {}
    try:
        for name, nf in planes.items():
            nf.advance(1, [1, 0], True)
            nf.invalidate("k", "b")  # a commit at epoch 1 -> 2
            nf.fill("k", "b", "counter_pn", 5, 1)  # late: read at 1
            assert _mirror_serves(nf, "k")  # right at 1
            nf.advance(2, [2, 0], True)
            served[name] = _mirror_serves(nf, "k")
    finally:
        for nf in planes.values():
            nf.close()
    assert served == {"port": False, "jax": True}


def _late_fill_after_ack(node, srv, client_cls):
    """The read-your-writes reproduction: increment by 4, publish,
    advance and read three times; keep the snapshot-cache entry of epoch
    E; increment by 3 (acknowledged); land the old value as a late fill
    stamped E; read three times more on the native port."""
    c = client_cls(port=srv.port)
    obj = [("ryw", "counter_pn", "b")]
    try:
        c.update_objects([("ryw", "counter_pn", "b", ("increment", 4))])
        node.txm.publish_serving_epoch()
        srv._native_advance()
        assert [c.read_objects(obj)[0] for _ in range(3)] == [[4]] * 3
        dk = ("ryw", "b")
        ep_e = node.store.serving_epoch
        _eid, loc, old = node.store.snapshot_cache[dk]
        time.sleep(0.05)  # past the inline publish's idle-rate window
        c.update_objects([("ryw", "counter_pn", "b", ("increment", 3))])
        node.store.snapshot_cache_fill(dk, ep_e, loc, old)
        return [c.read_objects(obj)[0][0] for _ in range(3)]
    finally:
        c.close()
        srv.close()


def test_acked_write_is_read_after_a_late_fill_of_the_old_epoch(jax_native):
    """A fill of the pre-write value, stamped with the epoch before an
    acknowledged write, must not be served after the acknowledgement: the
    port advances its mirror on every publish, the inline one included,
    so the native plane answers 7.  The JAX package's native plane
    answers 4 until its next tick (its documented behaviour)."""
    node, srv = _port(True, epoch_tick_ms=600_000)
    assert _late_fill_after_ack(node, srv, AntidoteClient) == [7, 7, 7]
    jnode, jsrv = _jax(jax_native, epoch_tick_ms=600_000)
    assert _late_fill_after_ack(jnode, jsrv, JClient) == [4, 4, 4]


# ---------------------------------------------------------------------------
# chaos: SIGKILL under a socket storm over `console serve --device cpu`,
# seeded drop/truncate faults on the native accept path — acked ⊆ recovered
# ---------------------------------------------------------------------------
def test_sigkill_under_socket_storm_acked_subset_recovered(tmp_path):
    n_socks, n_keys = 256, 64
    log_dir = str(tmp_path / "wal")
    env = dict(os.environ, ANTIDOTE_FAULT_PLAN=json.dumps({
        "seed": 23, "rules": [
            {"site": "frontend.recv", "action": "drop", "p": 0.002,
             "times": 16},
            {"site": "frontend.recv", "action": "truncate", "p": 0.002,
             "times": 16, "arg": 6}]}))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "antidote_tpu_torch.console", "serve",
         "--device", "cpu", "--port", "0", "--shards", "2", "--max-dcs",
         "2", "--keys-per-table", "256", "--log-dir", log_dir, "--sync-log",
         "--wal-segments", "3", "--max-connections", str(n_socks + 64),
         "--max-in-flight-per-client", "512"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    acked = [0] * n_keys
    attempted = [0] * n_keys
    socks = []
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "serve printed no ready line"
        info = json.loads(proc.stdout.readline())
        port = info["port"]

        def upd_frame(key_i):
            return _raw_frame(MessageCode.STATIC_UPDATE_OBJECTS, {
                "updates": [[f"s{key_i}", "counter_pn", "b",
                             ["increment", 1]]], "clock": None})

        sel = selectors.DefaultSelector()
        for i in range(n_socks):
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            socks.append(s)
            sel.register(s, selectors.EVENT_READ, [bytearray(), i % n_keys])
            attempted[i % n_keys] += 1
            s.sendall(upd_frame(i % n_keys))
        t_end = time.monotonic() + 4.0
        while time.monotonic() < t_end and sum(acked) < 2000:
            for sk, _ in sel.select(timeout=0.2):
                st = sk.data
                try:
                    data = sk.fileobj.recv(1 << 16)
                except OSError:
                    data = b""
                if not data:  # a fault-dropped conn: dead, not wedged
                    sel.unregister(sk.fileobj)
                    continue
                st[0] += data
                while len(st[0]) >= 4:
                    (n,) = _HDR.unpack(st[0][:4])
                    if len(st[0]) < 4 + n:
                        break
                    code, body = decode(bytes(st[0][4:4 + n]))
                    del st[0][:4 + n]
                    if code != MessageCode.ERROR_RESP:
                        assert "commit_clock" in body, body
                        acked[st[1]] += 1
                    attempted[st[1]] += 1
                    try:
                        sk.fileobj.sendall(upd_frame(st[1]))
                    except OSError:
                        sel.unregister(sk.fileobj)
                        break
        assert sum(acked) >= 100, f"only {sum(acked)} acks"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=15)
        eof_deadline = time.monotonic() + 15
        for s in socks:
            s.settimeout(max(0.1, eof_deadline - time.monotonic()))
            try:
                while s.recv(1 << 16):
                    pass
            except socket.timeout:
                pytest.fail("a connection wedged past the server's death")
            except OSError:
                pass
    finally:
        for s in socks:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
    rcfg = AntidoteConfig(n_shards=2, max_dcs=2, keys_per_table=256,
                          wal_segments=3)
    objs = [(f"s{i}", "counter_pn", "b") for i in range(n_keys)]
    recovered = []
    for _ in range(2):
        node = AntidoteNode(rcfg, log_dir=log_dir, recover=True,
                            device="cpu")
        recovered.append(node.read_objects(objs)[0])
        node.close()
    assert recovered[0] == recovered[1]
    for i in range(n_keys):
        assert acked[i] <= recovered[0][i] <= attempted[i], (
            i, acked[i], recovered[0][i], attempted[i])
    assert np.sum(recovered[0]) >= sum(acked)
