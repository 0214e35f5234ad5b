"""Deterministic fault injection for the self-healing fabric.

The OTP reference earns its resilience claims with supervision trees and
riak_core handoff retries; this package earns ours with seeded chaos: a
:class:`FaultPlan` declares which messages die, stutter, rot, or stall at
named injection sites.  In this package the sites are the WAL
(``log/wal.py``: ``wal.append``, ``wal.fsync``), its checkpoint reclaim
(``log/__init__.py``: ``wal.truncate_below``) and the checkpoint writer
(``log/checkpoint.py``: ``ckpt.write``, ``ckpt.fsync``, ``ckpt.rename``)
and the wire server's inbound frames (``proto/server.py``:
``frontend.recv``); the inter-DC and RPC sites come with those planes.

Usage::

    from antidote_tpu_torch import faults

    plan = faults.FaultPlan(seed=42)
    plan.drop("interdc.deliver", key=(0, 1), p=0.3)   # lossy link 0->1
    inj = faults.install(plan)
    inj.sever(0, 1)       # full partition (stream + query channel)
    ...
    inj.heal_all()
    faults.uninstall()    # disarm; sites return to zero-overhead no-ops

Sites pay one module-global read when no plan is armed, so production
paths are unaffected.
"""

from antidote_tpu_torch.faults.plan import (
    ACTIONS,
    PLAN_ENV,
    Decision,
    FaultInjector,
    FaultPlan,
    FaultRule,
    armed_prefix,
    get_injector,
    hit,
    install,
    install_from_env,
    is_severed,
    plan_from_env,
    uninstall,
)

__all__ = [
    "ACTIONS", "PLAN_ENV", "Decision", "FaultInjector", "FaultPlan",
    "FaultRule", "armed_prefix", "get_injector", "hit", "install",
    "install_from_env", "is_severed", "plan_from_env", "uninstall",
]
