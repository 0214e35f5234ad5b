"""The GentleRain protocol on the port (``txn_prot=gr``).

The four cases of ``tests/test_gr.py`` on port nodes (``device="cpu"``):
snapshots are scalar global-stable-time points, so a remote write becomes
visible only once every lane's clock has passed it; ClockSI stays the
default.  Tolerance: exact values.
"""


from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, LoopbackHub
from antidote_tpu_torch.meta import MetaDataStore


def cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16
    )


def gr_meta():
    m = MetaDataStore()
    m.set_env("txn_prot", "gr")
    return m


def test_gr_single_dc_roundtrip():
    """On one DC the GST degenerates to the local clock: reads see own
    commits immediately (single-dc gr_SUITE cases)."""
    node = AntidoteNode(AntidoteConfig(
        n_shards=2, max_dcs=1, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16
    ), meta=gr_meta(), device="cpu")
    assert node.txm.protocol == "gr"
    node.update_objects([("k", "counter_pn", "b", ("increment", 2))])
    vals, _ = node.read_objects([("k", "counter_pn", "b")])
    assert vals[0] == 2


def test_gr_snapshot_lags_until_gst_advances():
    """Two DCs: after DC0 commits, DC1's GST is still 0 (its own lane has
    not advanced), so a gr read misses the write; once DC1 commits, GST
    covers DC0's write and it becomes visible."""
    hub = LoopbackHub()
    nodes = [AntidoteNode(cfg(), dc_id=i, meta=gr_meta(), device="cpu") for i in range(2)]
    reps = [DCReplica(n, hub, f"dc{i}") for i, n in enumerate(nodes)]
    DCReplica.connect_all(reps)
    nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 5))])
    hub.pump()
    # the remote write is applied at DC1 (clocksi would see it)...
    assert nodes[1].store.dc_max_vc()[0] == 1
    # ...but the gr snapshot floor (GST) is min(1, 0) = 0
    vals, _ = nodes[1].read_objects([("k", "counter_pn", "b")])
    assert vals[0] == 0
    # DC1's own commit lifts its lane; GST now covers the remote write
    nodes[1].update_objects([("other", "counter_pn", "b", ("increment", 1))])
    vals, _ = nodes[1].read_objects([("k", "counter_pn", "b")])
    assert vals[0] == 5


def test_gr_snapshot_is_scalar():
    hub = LoopbackHub()
    nodes = [AntidoteNode(cfg(), dc_id=i, meta=gr_meta(), device="cpu") for i in range(2)]
    reps = [DCReplica(n, hub, f"dc{i}") for i, n in enumerate(nodes)]
    DCReplica.connect_all(reps)
    for _ in range(3):
        nodes[0].update_objects([("a", "counter_pn", "b", ("increment", 1))])
    hub.pump()
    nodes[1].update_objects([("b", "counter_pn", "b", ("increment", 1))])
    txn = nodes[1].start_transaction()
    # all remote lanes pinned to one scalar (own lane = commit counter)
    assert txn.snapshot_vc[0] == min(3, 1)
    assert txn.snapshot_vc[1] == 1
    nodes[1].abort_transaction(txn)


def test_clocksi_remains_default():
    node = AntidoteNode(cfg(), device="cpu")
    assert node.txm.protocol == "clocksi"
