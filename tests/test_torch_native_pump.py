"""The port's native inter-DC receive pump (``interdc/cpp/pump.cc``).

The cases of ``tests/test_native_pump.py`` on the port's build:
partial-frame reassembly, multi-frame segments, EOF tail delivery with
the drop sentinel after it, a frame larger than the scratch buffer, and
a closed pump that stays inert.  The JAX file's fallback toggle becomes
the port's rule: the operator's ``ANTIDOTE_NATIVE_PUMP=off`` is logged
and counted in ``pump_fallback``, and a pump that cannot be built, loaded
or started — or an injected ``native_pump.load`` fault — raises
``NativePumpUnavailable``, from ``TcpFabric`` before any endpoint exists.
Last, the same byte stream gives the same frames through the port's pump
and through the JAX package's, built in this test's own directory.
Tolerance: exact bytes.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import pytest

from antidote_tpu_torch import faults, native_build
from antidote_tpu_torch.interdc import native_pump
from antidote_tpu_torch.interdc.native_pump import (NativePump,
                                                    NativePumpUnavailable)
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.obs.metrics import net_metrics

_HDR = struct.Struct(">IB")


def _frame(kind: int, payload: bytes) -> bytes:
    return _HDR.pack(len(payload) + 1, kind) + payload


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


@pytest.fixture
def pump():
    p = NativePump.create()
    yield p
    p.close()


def _drain(p, n, timeout=5.0, until_drop=False):
    got = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        got.extend(p.take_batch(200))
        if until_drop and any(k == 0 for _, k, _ in got):
            break
        if not until_drop and len(got) >= n:
            break
    return got


def test_reassembly_and_batching(pump):
    a, b = socket.socketpair()
    pump.add(b.detach(), tag=3)
    f1, f2, f3 = (_frame(2, b"x" * 10), _frame(2, b"y" * 1000),
                  _frame(7, b"z"))
    a.sendall(f1[:7])
    time.sleep(0.02)
    a.sendall(f1[7:] + f2 + f3)
    got = _drain(pump, 3)
    assert [(t, k, len(p)) for t, k, p in got] == [
        (3, 2, 10), (3, 2, 1000), (3, 7, 1)]
    assert pump.frames == 3 and pump.takes >= 1
    a.close()


def test_eof_tail_delivered(pump):
    a, b = socket.socketpair()
    pump.add(b.detach(), tag=9)
    a.sendall(_frame(2, b"final-1") + _frame(2, b"final-2"))
    a.close()
    got = _drain(pump, 0, until_drop=True)
    assert [p for _, k, p in got if k != 0] == [b"final-1", b"final-2"]
    assert [(t, k, p) for t, k, p in got if k == 0] == [(9, 0, b"")]
    assert got[-1][1] == 0


def test_large_frame_grows_buffer(pump):
    a, b = socket.socketpair()
    pump.add(b.detach(), tag=1)
    big = b"B" * (2 << 20)  # larger than the 1 MiB scratch buffer
    a.sendall(_frame(2, big))
    got = _drain(pump, 1, timeout=10.0)
    assert got[0][2] == big
    a.close()


def test_closed_pump_is_inert():
    p = NativePump.create()
    a, b = socket.socketpair()
    p.close()
    p.add(b.detach(), tag=1)  # fd closed, not leaked
    assert p.take(10) is None
    assert p.take_batch(10) == []
    assert p.queued() == 0
    p.close()  # idempotent
    a.close()


def test_off_switch_is_counted(monkeypatch):
    monkeypatch.setenv("ANTIDOTE_NATIVE_PUMP", "off")
    before = net_metrics().pump_fallback.value()
    assert NativePump.create() is None
    assert net_metrics().pump_fallback.value() == before + 1
    # the fabric then runs Python reader threads, and still replicates
    f = TcpFabric()
    try:
        assert f._np is None
    finally:
        f.close()


def test_injected_load_fault_raises_before_any_thread():
    faults.install(faults.FaultPlan(seed=1).error("native_pump.load"))
    before = threading.active_count()
    with pytest.raises(NativePumpUnavailable, match="native_pump.load"):
        TcpFabric()
    assert threading.active_count() == before


def test_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "pump.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_pump, "SOURCE", bad)
    monkeypatch.setattr(native_pump, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(NativePumpUnavailable, match="g\\+\\+ failed"):
        NativePump.create()


def test_pump_new_failure_raises(monkeypatch):
    lib = native_pump._load_lib()

    class _NoLoop:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def pump_new():
            return None

    monkeypatch.setattr(native_pump, "_lib", _NoLoop())
    with pytest.raises(NativePumpUnavailable, match="pump_new"):
        NativePump.create()


def test_frames_equal_the_jax_pump(tmp_path, monkeypatch):
    from antidote_tpu.interdc import native_pump as jnp_

    monkeypatch.setattr(jnp_, "_SO", tmp_path / "_pump.so")
    monkeypatch.setattr(jnp_, "_lib", None)
    monkeypatch.setattr(jnp_, "_lib_tried", False)
    jp = jnp_.NativePump.create()
    pp = NativePump.create()
    assert jp is not None
    stream = b"".join(_frame(k, bytes([k]) * n) for k, n in
                      [(2, 0), (2, 17), (5, 70000), (2, 3), (1, 1)])
    got = {}
    try:
        for name, p in (("jax", jp), ("port", pp)):
            a, b = socket.socketpair()
            p.add(b.detach(), tag=4)
            for i in range(0, len(stream), 4093):  # ragged segments
                a.sendall(stream[i:i + 4093])
            a.close()
            got[name] = _drain(p, 0, until_drop=True)
    finally:
        jp.close()
        pp.close()
    assert len(got["port"]) == 6 and got["port"] == got["jax"]


def test_two_draining_threads_get_every_frame_once(pump):
    """A reader waiting for a client clock pumps beside the pump loop: two
    threads draining one pump must together receive every frame exactly
    once (each crossing fills its own thread's scratch buffer)."""
    a, b = socket.socketpair()
    pump.add(b.detach(), tag=5)
    n = 4000
    sent = [struct.pack(">I", i) * (1 + i % 7) for i in range(n)]
    got = [[], []]
    stop = threading.Event()

    def drain(i):
        while not stop.is_set():
            got[i].extend(p for _t, k, p in pump.take_batch(5) if k == 2)

    ts = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    try:
        for i in range(0, n, 50):
            a.sendall(b"".join(_frame(2, p) for p in sent[i:i + 50]))
        deadline = time.time() + 20
        while len(got[0]) + len(got[1]) < n and time.time() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in ts:
            t.join(10)
        a.close()
    assert not any(t.is_alive() for t in ts)
    assert sorted(got[0] + got[1]) == sorted(sent)
