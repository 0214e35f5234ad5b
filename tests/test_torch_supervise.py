"""The port's supervision tree on the CPU: the counterparts of
``tests/test_supervise.py`` (the reference's antidote_sup one_for_one
parity — dead children restart in place; exceeding the restart intensity
of 5 restarts in 10 s shuts the tree down), the protocol listener
restarted on its port, and a ``console serve --device cpu`` process that
survives a hostile frame."""

import os
import time
from pathlib import Path

import pytest

from antidote_tpu_torch.api import AntidoteNode as _Node
from antidote_tpu_torch.supervise import Supervisor

ROOT = Path(__file__).resolve().parent.parent


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)

pytestmark = pytest.mark.smoke


class FakeService:
    def __init__(self):
        self.alive = True
        self.stopped = False

    def kill(self):
        self.alive = False

    def stop(self):
        self.stopped = True


def test_child_restarts_in_place():
    started = []

    def start():
        s = FakeService()
        started.append(s)
        return s

    sup = Supervisor(poll_s=0.02)
    sup.add("svc", start, alive=lambda s: s.alive, stop=lambda s: s.stop())
    sup.start()
    assert len(started) == 1
    started[0].kill()
    for _ in range(100):
        if len(started) == 2:
            break
        time.sleep(0.02)
    assert len(started) == 2, "dead child was not restarted"
    assert started[0].stopped, "dead child was not stopped before restart"
    assert started[1].alive
    assert sup.gave_up is None
    sup.shutdown()
    assert started[1].stopped


def test_restart_intensity_gives_up():
    """5 restarts in 10s (the reference's intensity) -> tree shutdown +
    escalation callback, not an infinite crash loop."""
    started = []
    gave = []

    def start():
        s = FakeService()
        s.alive = False  # born dead: flaps on every poll
        started.append(s)
        return s

    sup = Supervisor(poll_s=0.01, max_restarts=5, window_s=10.0,
                     on_giveup=gave.append)
    sup.add("flappy", start, alive=lambda s: s.alive,
            stop=lambda s: s.stop())
    sup.add("healthy", FakeService, alive=lambda s: s.alive,
            stop=lambda s: s.stop())
    sup.start()
    for _ in range(200):
        if gave:
            break
        time.sleep(0.02)
    assert gave == ["flappy"]
    assert sup.gave_up == "flappy"
    # intensity bound: initial start + max_restarts starts, then stop
    assert len(started) == 6
    # the healthy sibling was shut down too (tree shutdown, OTP rule)
    healthy = sup.children["healthy"]
    assert healthy.handle is None


def test_supervised_protocol_listener_restarts_on_same_port():
    """The console-serve wiring, in process: kill the protocol server
    (its accept thread exits); the supervisor rebuilds it via the
    start factory ON THE SAME PORT and clients keep working."""
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    node = AntidoteNode(AntidoteConfig(
        n_shards=4, max_dcs=2, keys_per_table=256))
    box = {}

    def start_proto():
        port = box["srv"].port if "srv" in box else 0
        box["srv"] = ProtocolServer(node, port=port)
        return box["srv"]

    sup = Supervisor(poll_s=0.05)
    sup.add("proto", start_proto, alive=lambda s: s.is_alive(),
            stop=lambda s: s.close())
    sup.start()
    first = box["srv"]
    port = first.port
    c = AntidoteClient("127.0.0.1", port, timeout=30)
    c.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    c.close()
    first._server.shutdown()  # the listener "crashes"
    for _ in range(100):
        if box["srv"] is not first and box["srv"].is_alive():
            break
        time.sleep(0.05)
    assert box["srv"] is not first, "supervisor never restarted the child"
    assert box["srv"].port == port, "restart must rebind the same port"
    c2 = AntidoteClient("127.0.0.1", port, timeout=30)
    vals, _ = c2.read_objects([("k", "counter_pn", "b")])
    assert vals == [1]
    c2.close()
    sup.shutdown()


def test_release_serve_survives_hostile_frames(tmp_path):
    """End to end resilience probe against a real `console serve`
    process: an oversized frame must not take the listener down."""
    import json
    import subprocess
    import sys

    from antidote_tpu_torch.proto.client import AntidoteClient

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "antidote_tpu_torch.console", "serve",
         "--device", "cpu", "--port", "0", "--shards", "4", "--max-dcs",
         "2"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        import select

        ready, _, _ = select.select([p.stdout], [], [], 120)
        assert ready, "serve printed no ready line in 120 s"
        line = p.stdout.readline().decode()
        info = json.loads(line)
        c1 = AntidoteClient(info["host"], info["port"], timeout=30)
        c1.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        c1.close()
        # crash the listener: a client sends a frame that explodes the
        # accept loop? — instead simulate by abusing the wire with a
        # huge frame length; the server must survive bad frames, so
        # this is a resilience probe, then confirm service continuity
        import socket
        import struct

        s = socket.create_connection((info["host"], info["port"]))
        s.sendall(struct.pack(">I", 0xFFFFFFF) + b"x")
        s.close()
        time.sleep(0.5)
        c2 = AntidoteClient(info["host"], info["port"], timeout=30)
        vals, _ = c2.read_objects([("k", "counter_pn", "b")])
        assert vals == [1]
        c2.close()
    finally:
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


def test_thread_loop_crash_restarts_under_the_supervisor():
    """A ``ThreadLoop`` whose call raises ends its thread; the supervisor
    sees the dead child and restarts it through its factory."""
    from antidote_tpu_torch.supervise import ThreadLoop

    calls = []

    def step():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("boom")

    loops = []

    def start():
        loops.append(ThreadLoop(step, interval_s=0.01, name="t").start())
        return loops[-1]

    sup = Supervisor(poll_s=0.02)
    sup.add("loop", start, alive=lambda lp: lp.is_alive(),
            stop=lambda lp: lp.stop())
    sup.start()
    try:
        for _ in range(200):
            if len(loops) >= 2 and loops[-1].is_alive():
                break
            time.sleep(0.02)
        assert len(loops) >= 2 and not loops[0].is_alive()
        assert loops[-1].is_alive() and len(calls) > 3
    finally:
        sup.shutdown()
    assert not any(lp.is_alive() for lp in loops)
