"""Parity of the port's vector-clock and snapshot-version functions with
``antidote_tpu.clock`` on seeded random clocks (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu.clock import orddict as jax_orddict
from antidote_tpu.clock import vector as jax_vc
from antidote_tpu_torch.clock import orddict, vector


def _clocks(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=shape).astype(np.int32),
            rng.integers(0, 4, size=shape).astype(np.int32))


@pytest.mark.parametrize("seed,fn", enumerate(
    ["le", "lt", "eq", "concurrent", "merge", "vmin"]))
def test_binary_vc_ops_match_jax(seed, fn):
    a, b = _clocks(seed, (32, 5, 3))
    want = getattr(jax_vc, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(vector, fn)(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("lane", [0, 2])
def test_increment_and_dominates_ignoring_match_jax(lane):
    a, b = _clocks(7 + lane, (40, 3))
    np.testing.assert_array_equal(
        np.asarray(jax_vc.increment(jnp.asarray(a), lane)),
        vector.increment(torch.as_tensor(a), lane).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_vc.dominates_ignoring(jnp.asarray(a), jnp.asarray(b),
                                             lane)),
        vector.dominates_ignoring(torch.as_tensor(a), torch.as_tensor(b),
                                  lane).numpy())
    np.testing.assert_array_equal(np.asarray(jax_vc.zero(3)),
                                  vector.zero(3).numpy())


def test_get_smaller_and_insert_slot_match_jax():
    rng = np.random.default_rng(3)
    m, v, d = 64, 3, 3
    snap_vc = rng.integers(0, 5, size=(m, v, d)).astype(np.int32)
    snap_seq = rng.integers(0, 6, size=(m, v)).astype(np.int64)
    snap_seq[rng.random((m, v)) < 0.3] = 0  # empty version slots
    read_vc = rng.integers(0, 5, size=(m, d)).astype(np.int32)
    idx, found = jax_orddict.get_smaller(
        jnp.asarray(snap_vc), jnp.asarray(snap_seq), jnp.asarray(read_vc))
    t_idx, t_found = orddict.get_smaller(
        torch.as_tensor(snap_vc), torch.as_tensor(snap_seq),
        torch.as_tensor(read_vc))
    np.testing.assert_array_equal(np.asarray(found), t_found.numpy())
    # the index is meaningful only where a version was found (0 otherwise)
    np.testing.assert_array_equal(np.asarray(idx), t_idx.numpy())
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jax_orddict.insert_slot(jnp.asarray(snap_seq))),
        orddict.insert_slot(torch.as_tensor(snap_seq)).numpy())
