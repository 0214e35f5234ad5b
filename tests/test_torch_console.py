"""The port's console CLI and readiness probe, on the CPU.

Counterparts of ``tests/test_console.py`` (the reference's
``antidote_console`` / ``wait_init`` analogues: the readiness probes, the
status snapshot, the ``status``/``read``/``update``/``ready`` commands),
then ``python -m antidote_tpu_torch.console serve --device cpu`` as a real
subprocess: its ready line, the commands against it, and a durable serve
stopped and restarted with recovery on the same log directory; the
native front end as the serve default and ``--no-native-frontend``; and
the offline ``inspect`` / ``inspect-checkpoint`` commands, whose JSON
equals the JAX console's on one log directory written by either package;
a follower served with ``--follower-of`` (its ready line's role and
bootstrap mode, its refusals) and ``replica-status`` / ``replica-add`` /
``replica-remove`` against the owner.
"""

import json
import os
import select
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from antidote_tpu import console as jconsole
from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu_torch import console
from antidote_tpu_torch.api import AntidoteNode as _Node
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.proto.client import AntidoteClient
from antidote_tpu_torch.proto.server import ProtocolServer

pytestmark = pytest.mark.smoke

ROOT = Path(__file__).resolve().parent.parent


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)


@pytest.fixture
def node():
    return AntidoteNode(AntidoteConfig(
        n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=8, mv_slots=4, rga_slots=16, keys_per_table=64))


def test_check_ready_all_probes(node):
    probes = node.check_ready()
    assert set(probes) == {"types", "meta", "clocks", "log", "txn"}
    assert all(probes.values()), probes
    assert node.is_ready()


def test_ready_probe_leaves_no_state(node):
    node.check_ready()
    # the probe txn aborts: nothing committed, no value visible, and —
    # critically — no directory binding or table row allocated (reads of
    # never-written keys must not grow the tables or leak into handoffs)
    vals, _ = node.read_objects([("__ready__", "counter_pn", "__ready__")])
    assert vals == [0]
    assert node.store.locate("__ready__", "counter_pn", "__ready__",
                             create=False) is None
    assert len(node.store.directory) == 0
    # and the probe never skews op/abort dashboards
    assert node.metrics.aborted_transactions.value() == 0
    assert node.metrics.operations.value(type="update") == 0


def test_status_snapshot(node):
    node.update_objects([("k", "counter_pn", "b", ("increment", 2))])
    st = node.status()
    assert st["n_shards"] == node.cfg.n_shards
    assert st["keys"] >= 1
    assert st["tables"]["counter_pn"]["rows_used"] >= 1
    assert st["commit_counter"] == 1
    assert "ready" not in st  # passive by default (monitoring-poll safe)
    assert all(node.status(include_ready=True)["ready"].values())


def test_status_over_wire(node):
    from antidote_tpu_torch.proto.client import AntidoteClient

    server = ProtocolServer(node, port=0)
    try:
        c = AntidoteClient(server.host, server.port, timeout=30)
        st = c.node_status(include_ready=True)
        assert st["dc_id"] == node.dc_id and all(st["ready"].values())
        c.close()
    finally:
        server.close()


def test_console_status_read_update(node, capsys):
    from antidote_tpu_torch import console

    server = ProtocolServer(node, port=0)
    try:
        base = ["--host", server.host, "--port", str(server.port)]
        assert console.main(["update", *base, "k", "counter_pn", "b",
                             "increment", "5"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert "commit_clock" in out
        assert console.main(["read", *base, "k", "counter_pn", "b"]) == 0
        assert json.loads(capsys.readouterr().out)["value"] == 5
        assert console.main(["status", *base]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["keys"] >= 1
        assert console.main(["ready", *base]) == 0
    finally:
        server.close()


def _spawn_serve(*args, timeout=120.0):
    """``console serve --device cpu`` in a subprocess; returns the process
    and its parsed ready line (the first stdout line), or fails the test
    when none arrives within ``timeout`` seconds."""
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


def test_serve_subprocess_ready_line_and_commands(capsys):
    """The release smoke: boot the entrypoint as a real process, gate on
    its ready line, then the console's own commands against it."""
    proc, info = _spawn_serve("--shards", "4", "--max-dcs", "2")
    try:
        assert info["ready"] is True and info["port"] > 0
        base = ["--host", info["host"], "--port", str(info["port"])]
        assert console.main(["update", *base, "k", "counter_pn", "b",
                             "increment", "9"]) == 0
        assert json.loads(capsys.readouterr().out)["commit_clock"][0] >= 1
        assert console.main(["read", *base, "k", "counter_pn", "b"]) == 0
        assert json.loads(capsys.readouterr().out)["value"] == 9
        assert console.main(["status", *base]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["n_shards"] == 4 and st["keys"] == 1
        assert st["pipeline"]["epoch_reads"] is True
        assert console.main(["ready", *base]) == 0
        assert all(json.loads(capsys.readouterr().out).values())
    finally:
        _stop(proc)


def test_serve_subprocess_recovers_its_log_dir(tmp_path, capsys):
    """A durable serve: writes, a checkpoint, more writes; stopped and
    restarted on the same directory it recovers (image + WAL tail) and
    serves every value."""
    d = str(tmp_path / "dc0")
    proc, info = _spawn_serve("--log-dir", d, "--shards", "4",
                              "--max-dcs", "2", "--sync-log")
    try:
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        c.update_objects([("k", "counter_pn", "b", ("increment", 4)),
                          ("s", "set_aw", "b", ("add", 1))])
        c.close()
        base = ["--host", info["host"], "--port", str(info["port"])]
        assert console.main(["checkpoint-now", *base]) == 0
        assert json.loads(capsys.readouterr().out)["id"] == 1
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        c.update_objects([("k", "counter_pn", "b", ("increment", 3)),
                          ("s", "set_aw", "b", ("add", 2))])
        c.close()
    finally:
        _stop(proc)
    # no flags: the shape comes from the directory, recovery from its data
    proc, info = _spawn_serve("--log-dir", d)
    try:
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        vals, _ = c.read_objects([("k", "counter_pn", "b"),
                                  ("s", "set_aw", "b")])
        assert vals == [7, [1, 2]]
        st = c.node_status()
        assert st["n_shards"] == 4 and st["durable"] is True
        assert st["checkpoint"]["last_id"] == 1
        c.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        vals, _ = c.read_objects([("k", "counter_pn", "b")])
        assert vals == [8]
        c.close()
    finally:
        _stop(proc)


@pytest.mark.parametrize("flag", ["--pallas", "--mesh-devices=2"])
def test_serve_refuses_flags_without_a_port_meaning(flag, capsys):
    """``--pallas`` has no port meaning: argparse refuses it.
    ``--mesh-devices`` places the tables over that many cards; the CPU is
    one device, so a plane of 2 on ``--device cpu`` is refused at boot
    with the same exit code."""
    argv = ["serve", "--device", "cpu", flag]
    if flag == "--pallas":
        with pytest.raises(SystemExit) as ei:
            console.main(argv)
        assert ei.value.code == 2
    else:
        assert console.main(argv) == 2
        assert "1 are visible" in capsys.readouterr().err


def test_serve_on_cuda_without_a_card_exits_typed():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve --device cuda would serve")
    assert console.main(["serve", "--port", "0"]) == 2


def test_serve_runs_the_native_plane_by_default(capsys):
    """The client port belongs to the native front end unless the
    operator asks for the Python plane: the status carries the ``native``
    block, and a repeated clockless read is served by the C++ loop."""
    proc, info = _spawn_serve("--shards", "2", "--max-dcs", "2",
                              "--epoch-tick-ms", "25")
    try:
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        c.update_objects([("k", "counter_pn", "b", ("increment", 3))])
        c.close()
        time.sleep(0.4)
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        for _ in range(20):
            assert c.read_objects([("k", "counter_pn", "b")])[0] == [3]
        nat = c.node_status()["pipeline"]["native"]
        c.close()
        assert nat["native_hits"] > 0 and nat["accepted"] >= 2
    finally:
        _stop(proc)
    proc, info = _spawn_serve("--shards", "2", "--max-dcs", "2",
                              "--no-native-frontend")
    try:
        c = AntidoteClient(info["host"], info["port"], timeout=30)
        c.update_objects([("k", "counter_pn", "b", ("increment", 3))])
        assert c.read_objects([("k", "counter_pn", "b")])[0] == [3]
        assert "native" not in c.node_status()["pipeline"]
        c.close()
    finally:
        _stop(proc)


_INSPECT_KW = dict(n_shards=4, max_dcs=2, ops_per_key=8, snap_versions=2,
                   set_slots=8, keys_per_table=64, wal_segments=2)


def _inspect_dir(writer: str, d: str) -> None:
    """Commits, a full image, more commits: a log directory with a
    checkpoint and a WAL tail, written by either package."""
    if writer == "jax":
        node = JaxNode(JaxConfig(batch_buckets=(16, 64), **_INSPECT_KW),
                       log_dir=d)
    else:
        node = AntidoteNode(AntidoteConfig(**_INSPECT_KW), log_dir=d)
    rng = np.random.default_rng(3)
    for i in range(12):
        node.update_objects([
            (f"c{i % 5}", "counter_pn", "b",
             ("increment", int(rng.integers(1, 9)))),
            (f"s{i % 3}", "set_aw", "b", ("add", int(rng.integers(100))))])
        if i == 7:
            node.checkpoint_now()
    if node.checkpointer is not None:
        node.checkpointer.stop()
    node.store.log.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inspect_commands_print_the_jax_console_json(writer, tmp_path,
                                                     capsys):
    d = str(tmp_path / "dc0")
    _inspect_dir(writer, d)
    for cmd in ("inspect", "inspect-checkpoint"):
        assert console.main([cmd, "--log-dir", d]) == 0
        ours = json.loads(capsys.readouterr().out)
        assert jconsole.main([cmd, "--log-dir", d]) == 0
        theirs = json.loads(capsys.readouterr().out)
        assert ours == theirs, cmd
    assert ours["latest"]["verified"] is True and ours["published"]


def _poll(fn, timeout=30.0, every=0.2):
    """``fn()`` until it returns a truthy value, within ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(every)


def test_serve_follower_of_an_owner_and_the_replica_commands(tmp_path,
                                                             capsys):
    """An owner served with ``--interdc``, a checkpoint, then a follower
    served with ``--follower-of``: its ready line says ``role: follower``
    and ``bootstrap: image``; it serves the owner's values and forwards a
    write; ``replica-status`` shows it ``ok`` (exit 0), ``replica-add``
    pre-registers a name that shows ``down`` (exit 1), ``replica-remove``
    drops it again; restarted on its directory it rejoins in mode
    ``tail``."""
    owner, oinfo = _spawn_serve("--interdc", "--shards", "4", "--max-dcs",
                                "2", "--log-dir", str(tmp_path / "o"))
    procs = [owner]
    try:
        obase = ["--host", oinfo["host"], "--port", str(oinfo["port"])]
        oc = AntidoteClient(oinfo["host"], oinfo["port"], timeout=30)
        for i in range(5):
            oc.update_objects([("k", "counter_pn", "b", ("increment", 1)),
                               ("s", "set_aw", "b", ("add", i))])
        assert oc.checkpoint_now()["id"] == 1
        vc = oc.update_objects([("k", "counter_pn", "b", ("increment", 10))])
        fargs = ("--follower-of", f"{oinfo['host']}:{oinfo['port']}",
                 "--log-dir", str(tmp_path / "f"), "--replica-name", "f1",
                 "--divergence-check-s", "0.5")
        fol, finfo = _spawn_serve(*fargs)
        procs.append(fol)
        assert finfo["role"] == "follower" and finfo["bootstrap"] == "image"
        assert finfo["name"] == "f1"
        fc = AntidoteClient(finfo["host"], finfo["port"], timeout=30)
        vals, _ = fc.read_objects([("k", "counter_pn", "b"),
                                   ("s", "set_aw", "b")], clock=vc)
        assert vals == [15, [0, 1, 2, 3, 4]]
        vc = fc.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        assert oc.read_objects([("k", "counter_pn", "b")],
                               clock=vc)[0] == [16]
        st = fc.node_status()
        assert st["n_shards"] == 4 and st["replicas"]["role"] == "follower"
        fc.close()

        def ok():
            capsys.readouterr()
            rc = console.main(["replica-status", *obase])
            out = json.loads(capsys.readouterr().out)
            return rc == 0 and out["followers"]["f1"]["state"] == "ok" \
                and out

        out = _poll(ok)
        assert out["ring"]["size"] == 1
        assert console.main(["replica-add", *obase, "--name", "f2",
                             "--addr", "h:9"]) == 0
        added = json.loads(capsys.readouterr().out)
        assert added["followers"]["f2"]["state"] == "down"
        assert console.main(["replica-status", *obase]) == 1
        capsys.readouterr()
        assert console.main(["replica-remove", *obase, "--name", "f2"]) == 0
        assert "f2" not in json.loads(capsys.readouterr().out)["followers"]
        # the follower's own view
        fbase = ["--host", finfo["host"], "--port", str(finfo["port"])]
        assert console.main(["replica-status", *fbase]) == 0
        me = json.loads(capsys.readouterr().out)
        assert me["role"] == "follower" and me["state"] == "serving"
        # restart on its own directory: the local image and WAL carry it
        _stop(fol)
        procs.remove(fol)
        fol, finfo = _spawn_serve(*fargs)
        procs.append(fol)
        assert finfo["bootstrap"] == "tail"
        fc = AntidoteClient(finfo["host"], finfo["port"], timeout=30)
        assert fc.read_objects([("k", "counter_pn", "b")],
                               clock=vc)[0] == [16]
        fc.close()
        oc.close()
    finally:
        for p in procs:
            _stop(p)


def test_serve_follower_of_refusals(tmp_path, capsys):
    assert console.main(["serve", "--device", "cpu", "--follower-of",
                         "127.0.0.1:1"]) == 2  # no --log-dir
    assert console.main(["serve", "--device", "cpu", "--follower-of",
                         ",", "--log-dir",
                         str(tmp_path / "a")]) == 2  # no endpoint
    assert console.main(["serve", "--device", "cpu", "--follower-of",
                         "127.0.0.1:1", "--log-dir",
                         str(tmp_path / "b")]) == 2  # nobody there
