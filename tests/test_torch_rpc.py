"""The ``rpc.call`` fault site and the RPC server's endpoint registration
on the port's cluster RPC, beside the JAX package's: an injected error
reaches the caller as ``RpcError`` and a drop as ``RpcTimeout`` (the same
message in both packages), the failure counters move, and a server a
fault plan kills by name comes back on its port."""

import pytest

from antidote_tpu import faults as jfaults
from antidote_tpu.cluster import rpc as jrpc
from antidote_tpu_torch import faults
from antidote_tpu_torch.cluster import rpc
from antidote_tpu_torch.obs.metrics import net_metrics

PKGS = {"port": (faults, rpc), "jax": (jfaults, jrpc)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()
    jfaults.uninstall()


def _echo_server(mod):
    srv = mod.RpcServer()
    srv.register("echo", lambda x: x)
    srv.register("other", lambda x: -x)
    return srv


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_injected_error_and_drop_reach_the_caller(pkg):
    fmod, rmod = PKGS[pkg]
    plan = fmod.FaultPlan(seed=5)
    plan.error("rpc.call", key="echo", times=1)
    plan.drop("rpc.call", key="echo", times=1)
    plan.delay("rpc.call", key="other", times=1, seconds=0.05)
    inj = fmod.install(plan)
    srv = _echo_server(rmod)
    cli = rmod.RpcClient(srv.host, srv.port)
    try:
        with pytest.raises(rmod.RpcError,
                           match="^injected fault: rpc.call echo$"):
            cli.call("echo", 1)
        with pytest.raises(rmod.RpcTimeout,
                           match="^injected drop: rpc.call echo to "):
            cli.call("echo", 2)
        assert cli.call("echo", 3) == 3  # rules spent
        assert cli.call("other", 4) == -4  # delayed, then served
        assert inj.fired("rpc.call") == 3
    finally:
        cli.close()
        srv.close()


def test_drop_counts_a_deadline_like_the_jax_rpc():
    plan = faults.FaultPlan(seed=1)
    plan.drop("rpc.call", times=1)
    faults.install(plan)
    before = net_metrics().rpc_deadline_exceeded.value()
    srv = _echo_server(rpc)
    cli = rpc.RpcClient(srv.host, srv.port)
    try:
        with pytest.raises(rpc.RpcTimeout):
            cli.call("echo", 1)
        assert net_metrics().rpc_deadline_exceeded.value() == before + 1
    finally:
        cli.close()
        srv.close()


def test_server_registers_its_endpoint_and_restarts():
    inj = faults.install(faults.FaultPlan(seed=2))
    srv = _echo_server(rpc)
    cli = rpc.RpcClient(srv.host, srv.port)
    name = f"rpc.server.{srv.port}"
    try:
        assert name in inj.endpoints()
        assert cli.call("echo", 7) == 7
        inj.kill(name)
        with pytest.raises(rpc.RpcTimeout):
            cli.call("echo", 8)
        inj.restart(name)
        assert cli.call("echo", 9) == 9  # the client redials the reborn
    finally:
        cli.close()
        srv.close()
