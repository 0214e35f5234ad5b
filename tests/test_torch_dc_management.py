"""Protocol-driven DC mesh bootstrap over ``console serve --interdc``.

The cases of ``tests/test_dc_management.py`` on the port: two
``console serve --interdc --device cpu`` processes, nothing
pre-connected; a client fetches each DC's descriptor over the socket,
cross-connects them over the socket, and replication then flows both
ways — in the msgpack dialect and in the apb dialect.  A multi-node
create_dc is refused.  Tolerance: exact values.
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest

from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto.client import AntidoteClient

ROOT = Path(__file__).resolve().parent.parent


def _spawn_serve(*args, timeout=120.0):
    """``console serve --device cpu`` in a subprocess; returns the process
    and its parsed ready line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "antidote_tpu_torch.console", "serve",
         "--device", "cpu", "--port", "0", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0 or proc.poll() is not None:
            _stop(proc)
            pytest.fail(f"serve printed no ready line (rc {proc.returncode})")
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 1.0))
        if ready:
            line = proc.stdout.readline()
            if line.strip():
                return proc, json.loads(line)


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=15)


@pytest.fixture
def duo():
    """Two DC deployments as processes, each with its inter-DC fabric."""
    procs = []
    try:
        for i in range(2):
            procs.append(_spawn_serve("--interdc", "--dc-id", str(i),
                                      "--shards", "2", "--max-dcs", "3"))
        yield [info for _p, info in procs]
    finally:
        for p, _info in procs:
            _stop(p)


def _poll_read(client, obj, expect, timeout=20.0):
    deadline = time.time() + timeout
    vals = None
    while time.time() < deadline:
        vals, _ = client.read_objects([obj])
        if vals[0] == expect:
            return
        time.sleep(0.05)
    raise AssertionError(f"never saw {expect!r} for {obj!r} (last {vals})")


def test_msgpack_dialect_mesh_bootstrap(duo):
    i0, i1 = duo
    assert "escrow" in i0 and i0["escrow"]["loop"] is True
    c0 = AntidoteClient(i0["host"], i0["port"])
    c1 = AntidoteClient(i1["host"], i1["port"])
    try:
        c0.create_dc(["dc0"])  # single-node DC: acknowledged
        d0 = c0.get_connection_descriptor()
        d1 = c1.get_connection_descriptor()
        assert d0["address"] and d1["address"]
        assert (d0["dc_id"], d1["dc_id"]) == (0, 1)
        c0.connect_to_dcs([d1])
        c1.connect_to_dcs([d0])
        vc = c0.update_objects([("k", "counter_pn", "b", ("increment", 7))])
        _poll_read(c1, ("k", "counter_pn", "b"), 7)
        # a read at the write's clock waits for replication, then sees it
        vals, _ = c1.read_objects([("k", "counter_pn", "b")], clock=vc)
        assert vals == [7]
        c1.update_objects([("k2", "set_aw", "b", ("add", 3))])
        _poll_read(c0, ("k2", "set_aw", "b"), [3])
        st = c0.node_status()
        assert st["replicas"] == {"role": "owner", "followers": {}}
    finally:
        c0.close()
        c1.close()


def test_create_dc_multi_node_refused(duo):
    i0, _ = duo
    c0 = AntidoteClient(i0["host"], i0["port"])
    try:
        with pytest.raises(Exception):
            c0.create_dc(["dc0@host1", "dc0@host2"])
    finally:
        c0.close()


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed"
        buf += chunk
    return buf


def _apb_call(sock, name, payload: dict):
    body = apb.encode_frame_body(name, payload)
    sock.sendall(struct.pack(">I", len(body)) + body)
    n = struct.unpack(">I", _read_exact(sock, 4))[0]
    frame = _read_exact(sock, n)
    return apb.CODE_TO_NAME[frame[0]], apb.decode_msg(
        apb.CODE_TO_NAME[frame[0]], frame[1:])


def test_apb_dialect_mesh_bootstrap(duo):
    i0, i1 = duo
    k0 = socket.create_connection((i0["host"], i0["port"]))
    k1 = socket.create_connection((i1["host"], i1["port"]))
    try:
        rn, resp = _apb_call(k0, "ApbCreateDC", {"nodes": [b"dc0"]})
        assert rn == "ApbOperationResp" and resp["success"]
        rn, d0 = _apb_call(k0, "ApbGetConnectionDescriptor", {})
        assert rn == "ApbGetConnectionDescriptorResp" and d0["success"]
        rn, d1 = _apb_call(k1, "ApbGetConnectionDescriptor", {})
        assert d1["success"]
        # descriptors are opaque blobs, shipped back verbatim
        rn, resp = _apb_call(k0, "ApbConnectToDCs",
                             {"descriptors": [d1["descriptor"]]})
        assert rn == "ApbOperationResp" and resp["success"], resp
        rn, resp = _apb_call(k1, "ApbConnectToDCs",
                             {"descriptors": [d0["descriptor"]]})
        assert resp["success"]
        rn, resp = _apb_call(k0, "ApbStaticUpdateObjects", {
            "transaction": {},
            "updates": [{
                "boundobject": {"key": b"pk",
                                "type": apb.TYPE_IDS["counter_pn"],
                                "bucket": b"b"},
                "operation": {"counterop": {"inc": 9}},
            }],
        })
        assert rn == "ApbCommitResp" and resp["success"], resp
        deadline = time.time() + 20
        val = None
        while time.time() < deadline:
            rn, resp = _apb_call(k1, "ApbStaticReadObjects", {
                "transaction": {},
                "objects": [{"key": b"pk",
                             "type": apb.TYPE_IDS["counter_pn"],
                             "bucket": b"b"}],
            })
            val = resp["objects"]["objects"][0]["counter"]["value"]
            if val == 9:
                break
            time.sleep(0.05)
        assert val == 9, val
    finally:
        k0.close()
        k1.close()
