"""Merkle-split divergence digests.

The flat :func:`~antidote_tpu_torch.store.kv.shard_digest` compares one
hash per shard: cheap to compare, but a single corrupted row costs a
full-shard digest to detect and a whole-store re-install to heal.  This
module splits each shard's content hash into a fixed-fanout tree over
``LEAVES`` key buckets:

  * two replicas at EQUAL applied clocks compare roots; on a mismatch the
    checker walks mismatching children level by level —
    ``O(fanout · log n)`` hash comparisons localize the diverged key range
    to one (or a few) leaves;
  * the heal then fetches ONLY those leaves' key states from the owner (a
    range-restricted image fetch) instead of quarantining the whole store
    behind a full re-install.

Leaf digests are pure functions of the CURRENT materialized values (the
flat digest's canonical encoding), so they are maintained incrementally:
a write dirties exactly its key's leaf, and a check recomputes only the
dirty leaves.  A recompute reads the values of every dirty leaf of a shard
in one chunked pass through the resolved read (a chunk of ``set_aw`` keys
is one ``orset_resolve`` launch on a card), then hashes leaf by leaf: the
bytes hashed are the JAX package's, so roots, nodes and leaves are equal
across the packages.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Set

import numpy as np

#: leaf buckets per shard and tree fanout (root -> FANOUT nodes -> LEAVES
#: leaves with the defaults: depth 2)
LEAVES = 256
FANOUT = 16
#: the hash of a leaf without keys
_EMPTY_LEAF = hashlib.sha256().digest()


def leaf_of(key, bucket: str, n_leaves: int = LEAVES) -> int:
    """Stable cross-process leaf index of one key (canonical msgpack bytes
    -> sha256 -> bucket)."""
    import msgpack as _mp

    h = hashlib.sha256(_mp.packb([key, bucket], use_bin_type=True,
                                 default=repr)).digest()
    return int.from_bytes(h[:4], "big") % n_leaves


class MerkleIndex:
    """Per-store incremental hash tree over each shard's keys.

    Membership (which keys live in which leaf) and leaf digests are built
    lazily: the first :meth:`root` of a shard partitions the directory and
    the cold index in one pass; after that, writes dirty single leaves via
    :meth:`mark`, which also re-derives the leaf's membership on its next
    recompute.  Cold keys are members like any other — recomputing a leaf
    that holds one faults it in through the read (both replicas hash the
    same VALUES, so a key cold on one side and resident on the other
    digests identically).  Every method runs under the commit lock."""

    def __init__(self, store, n_leaves: int = LEAVES, fanout: int = FANOUT):
        self.store = store
        self.n_leaves = int(n_leaves)
        self.fanout = int(fanout)
        n = self.fanout
        while n < self.n_leaves:
            n *= self.fanout
        if n != self.n_leaves:
            raise ValueError(f"n_leaves ({n_leaves}) must be a power of "
                             f"fanout ({fanout})")
        #: shard -> leaf hashes (None = never computed)
        self._leaves: Dict[int, List[Optional[bytes]]] = {}
        #: shard -> dirty leaf indices (absent = unbuilt)
        self._dirty: Dict[int, Set[int]] = {}
        #: shard -> leaf -> member keys (None = re-derive)
        self._members: Dict[int, List[Optional[Set[tuple]]]] = {}
        #: shard -> leaf -> (the members' digest objects in canonical
        #: order, each one's packed hash-record prefix), rebuilt with the
        #: membership: a rescan re-reads the values only
        self._objs: Dict[int, List[Optional[tuple]]] = {}

    # -- maintenance hooks ----------------------------------------------
    def mark(self, shard: int, dk) -> None:
        """A key's value (or membership) changed: dirty its leaf."""
        shard = int(shard)
        d = self._dirty.get(shard)
        if d is None:
            return  # unbuilt: the first root() builds everything anyway
        leaf = leaf_of(dk[0], dk[1], self.n_leaves)
        d.add(leaf)
        mem = self._members.get(shard)
        if mem is not None:
            mem[leaf] = None  # a birth or a heal's drop: re-derive
            self._objs[shard][leaf] = None

    def mark_all(self, shard: int) -> None:
        """Out-of-band mutation (install, heal, handoff): rebuild the
        shard's tree from scratch on the next check."""
        shard = int(shard)
        self._leaves.pop(shard, None)
        self._dirty.pop(shard, None)
        self._members.pop(shard, None)
        self._objs.pop(shard, None)

    def rescan(self, shard: int) -> None:
        """Force every leaf to rehash from the LIVE device state on the
        next :meth:`root` (membership kept).  Divergence checks call this
        before the root compare: silent corruption bypasses the
        incremental marks, so detection must re-read the data — the tree's
        win is the comparison walk and the leaf-restricted heal."""
        d = self._dirty.get(int(shard))
        if d is not None:
            d.update(range(self.n_leaves))

    # -- (re)computation ------------------------------------------------
    def _shard_keys(self, shard: int) -> Set[tuple]:
        store = self.store
        keys = set(store.directory.shard_keys(shard))
        if store.cold is not None:
            keys |= set(store.cold.shard_cold_keys(shard))
        return keys

    def _leaf_members(self, shard: int, leaf: int) -> Set[tuple]:
        return {dk for dk in self._shard_keys(shard)
                if leaf_of(dk[0], dk[1], self.n_leaves) == leaf}

    def _build_members(self, shard: int) -> List[Optional[Set[tuple]]]:
        mem: List[Optional[Set[tuple]]] = [set()
                                           for _ in range(self.n_leaves)]
        for dk in self._shard_keys(shard):
            mem[leaf_of(dk[0], dk[1], self.n_leaves)].add(dk)
        return mem

    def _leaf_objs(self, shard: int, leaf: int, mem) -> tuple:
        """One leaf's digest objects in canonical order with each one's
        packed hash-record prefix: a record is the msgpack array ``[key,
        bucket, type, value]``, i.e. the 4-array header followed by its
        elements packed one by one, so the first three pack once here."""
        import msgpack as _mp

        from antidote_tpu_torch.store.kv import _canon, digest_objects

        objs = digest_objects(self.store, mem)
        pre = [b"\x94" + b"".join(_mp.packb(x, use_bin_type=True,
                                            default=repr)
                                  for x in (_canon(key), bucket, tname))
               for key, tname, bucket in objs]
        return objs, pre

    def _refresh(self, shard: int) -> List[bytes]:
        """Bring one shard's leaf hashes current (recompute the dirty
        leaves only, their values read in one chunked pass)."""
        import msgpack as _mp

        from antidote_tpu_torch.store.kv import _canon, DIGEST_CHUNK

        shard = int(shard)
        leaves = self._leaves.get(shard)
        mem = self._members.get(shard)
        dirty = self._dirty.get(shard)
        if leaves is None or mem is None or dirty is None:
            mem = self._build_members(shard)
            self._members[shard] = mem
            self._objs[shard] = [None] * self.n_leaves
            leaves = [None] * self.n_leaves
            self._leaves[shard] = leaves
            dirty = set(range(self.n_leaves))
            self._dirty[shard] = dirty
        if not dirty:
            return leaves  # type: ignore[return-value]
        store = self.store
        cache = self._objs[shard]
        per_leaf = []
        flat: list = []
        for leaf in sorted(dirty):
            if mem[leaf] is None:
                mem[leaf] = self._leaf_members(shard, leaf)
                cache[leaf] = None
            if not mem[leaf]:
                # an empty leaf hashes nothing (most of a shard's 256
                # leaves when it holds a few keys)
                leaves[leaf] = _EMPTY_LEAF
                continue
            if cache[leaf] is None:
                cache[leaf] = self._leaf_objs(shard, leaf, mem[leaf])
            objs, pre = cache[leaf]
            per_leaf.append((leaf, pre))
            flat.extend(objs)
        vc = store.applied_vc[shard]
        vals: list = []
        for lo in range(0, len(flat), DIGEST_CHUNK):
            vals.extend(store.read_values_resolved(
                flat[lo:lo + DIGEST_CHUNK], vc))
        at = 0
        packb = _mp.packb
        for leaf, pre in per_leaf:
            h = hashlib.sha256()
            for p, v in zip(pre, vals[at:at + len(pre)]):
                h.update(p + packb(_canon(v), use_bin_type=True,
                                   default=repr))
            at += len(pre)
            leaves[leaf] = h.digest()
        dirty.clear()
        return leaves  # type: ignore[return-value]

    # -- tree views -----------------------------------------------------
    def depth(self) -> int:
        n, lv = 1, 0
        while n < self.n_leaves:
            n *= self.fanout
            lv += 1
        return lv

    def node_hash(self, leaves: List[bytes], level: int, index: int) -> bytes:
        """Hash of the tree node at (level, index): level 0 is the root,
        level ``depth()`` the leaves themselves."""
        if level >= self.depth():
            return leaves[index]
        h = hashlib.sha256()
        for child in range(self.fanout):
            h.update(self.node_hash(leaves, level + 1,
                                    index * self.fanout + child))
        return h.digest()

    def root(self, shard: int) -> str:
        """Current root hash (hex) of one shard, with the applied clock
        hashed in as the flat digest does: equal clocks and equal state
        give equal roots."""
        leaves = self._refresh(shard)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.store.applied_vc[int(shard)],
                                      dtype=np.int64).tobytes())
        h.update(self.node_hash(leaves, 0, 0))
        return h.hexdigest()

    def children(self, shard: int, level: int, index: int) -> List[str]:
        """Hex hashes of one node's children — the walk step a follower
        compares against its own (the root's children are level 1)."""
        leaves = self._refresh(shard)
        return [self.node_hash(leaves, level + 1,
                               index * self.fanout + child).hex()
                for child in range(self.fanout)]

    def leaf_keys(self, shard: int, leaf: int) -> Set[tuple]:
        """The keys currently in one leaf (the range-restricted heal)."""
        self._refresh(shard)
        mem = self._members[int(shard)]
        if mem[int(leaf)] is None:
            mem[int(leaf)] = self._leaf_members(int(shard), int(leaf))
        return set(mem[int(leaf)])


def get_merkle(store) -> MerkleIndex:
    """The store's (lazily built) divergence tree."""
    if store.merkle is None:
        store.merkle = MerkleIndex(store)
    return store.merkle


__all__ = ["MerkleIndex", "get_merkle", "leaf_of", "LEAVES", "FANOUT"]
