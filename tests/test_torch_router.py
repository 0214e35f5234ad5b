"""The port's native key→shard router against its plain XXH64 and the JAX
package's router: published vectors, the native hash bit for bit over many
lengths and seeds, and ``shard_batch`` over int, str, bytes and tuple keys
at many shard counts, equal to the JAX package's placement.  A store's
construction loads the library and raises when it cannot be built."""

import numpy as np
import pytest

from antidote_tpu.store import router as jrouter
from antidote_tpu_torch import native_build
from antidote_tpu_torch.store import router

pytestmark = pytest.mark.smoke


def test_xxh64_known_vectors():
    # published XXH64 reference vectors (seed 0), both implementations
    for data, want in ((b"", 0xEF46DB3751D8E999), (b"a", 0xD24EC4F1A98C6E5B),
                       (b"abc", 0x44BC2CF5AD770999)):
        assert router.xxh64(data) == want
        assert router.hash64(data) == want


def test_native_matches_plain_bit_for_bit():
    rng = np.random.default_rng(11)
    for ln in list(range(0, 40)) + [63, 64, 65, 100, 1000]:
        data = rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes()
        for seed in (0, 1, 0xDEADBEEF):
            assert router.hash64(data, seed) == router.xxh64(data, seed) \
                == jrouter.xxh64_py(data, seed), (ln, seed)


def _mixed_keys(n: int):
    rng = np.random.default_rng(5)
    keys, buckets = [], []
    for i in range(n):
        r = i % 4
        if r == 0:
            keys.append(int(rng.integers(-(1 << 40), 1 << 40)))
        elif r == 1:
            keys.append(f"user:{i}")
        elif r == 2:
            keys.append(rng.integers(0, 256, size=i % 50,
                                     dtype=np.uint8).tobytes())
        else:
            keys.append(("composite", i, f"f{i % 7}"))
        buckets.append(f"b{i % 3}")
    return keys, buckets


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 8, 16, 64, 1000, 2048,
                                      65536])
def test_shard_batch_agrees_with_plain_and_jax(n_shards):
    keys, buckets = _mixed_keys(2000)
    got = router.shard_batch(keys, buckets, n_shards)
    plain = [k % n_shards if isinstance(k, int)
             else router.xxh64(router.key_bytes(k, b)) % n_shards
             for k, b in zip(keys, buckets)]
    assert got.tolist() == plain
    assert got.tolist() == jrouter.shard_batch(keys, buckets,
                                               n_shards).tolist()
    assert [router.shard_of(k, b, n_shards)
            for k, b in zip(keys[:200], buckets[:200])] == plain[:200]


def test_int_fast_path_and_store_routing():
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.store.kv import KVStore, key_to_shard

    assert router.shard_of(42, "any", 16) == 42 % 16
    assert key_to_shard("k", "b", 8) == jrouter.shard_of("k", "b", 8)
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, ops_per_key=4,
                         snap_versions=2, keys_per_table=16)
    store = KVStore(cfg, device="cpu")
    objs = [(f"key-{i}", "counter_pn", "bk") for i in range(40)]
    objs += [(i, "counter_pn", "bk") for i in range(10)]
    store.locate_many(objs)
    for key, _t, bucket in objs:
        assert store.directory[(key, bucket)][1] == jrouter.shard_of(
            key, bucket, cfg.n_shards)


def test_a_router_that_cannot_build_fails_the_store(monkeypatch):
    """No fallback to the plain hash: a store whose router cannot be built
    is not constructed."""
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.store.kv import KVStore

    def no_compiler(src, stem):
        raise native_build.NativeBuildError("g++ not found")

    monkeypatch.setattr(router, "_lib", None)
    monkeypatch.setattr(native_build, "ensure", no_compiler)
    with pytest.raises(router.RouterUnavailable, match="g\\+\\+"):
        KVStore(AntidoteConfig(n_shards=2, max_dcs=2, keys_per_table=16),
                device="cpu")
