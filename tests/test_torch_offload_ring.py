"""The offload ring over devices (``ops/offload.py``'s
``PrefetchRing(devices=)`` and ``offloaded_streamed_topk(devices=)``)
held against the JAX package's ring over two of the forced CPU devices
(``tests/ops/test_offload.py``'s cases): puts, misses, evictions and each
slot's device (its index in ``devices``) equal; the offloaded search's
indices bit-equal to JAX's (its values within rtol 1e-5, as
``tests/test_torch_offload.py`` holds them: the two frameworks sum a
score in other orders) and bit-equal, values too, to the one-device
ring's."""

import jax
import numpy as np
import pytest
import torch

from dgmc_tpu.ops import offload as jax_offload
from dgmc_tpu_torch.ops import offload


def test_ring_round_robins_like_jax():
    devs = jax.devices()[:2]
    table = np.arange(8, dtype=np.float32).reshape(8, 1)
    jring = jax_offload.PrefetchRing(table, depth=3, devices=devs)
    ring = offload.PrefetchRing(table, depth=3, devices=['cpu', 'cpu'])
    for i in (0, 1, 2, 5, 6, 7):
        got, want = ring.get(i), jring.get(i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        (dev,) = want.devices()
        assert devs.index(dev) == ring.slot(i) == i % 2
        assert ring.device_of(i) == ring.devices[ring.slot(i)]
        assert (ring.puts, ring.misses, ring.evictions, ring.in_flight) \
            == (jring.puts, jring.misses, jring.evictions, jring.in_flight)


def test_offloaded_search_over_devices_equals_jax_and_one_device():
    rng = np.random.RandomState(6)
    h_s = rng.randn(2, 24, 4).astype(np.float32)
    h_t = rng.randn(2, 16, 4).astype(np.float32)
    jv, ji, jstats = jax_offload.offloaded_streamed_topk(
        h_s, h_t, 3, 4, block=4, depth=3, devices=jax.devices()[:2])
    v, i, stats = offload.offloaded_streamed_topk(
        h_s, h_t, 3, 4, block=4, depth=3, devices=['cpu', 'cpu'])
    v1, i1, stats1 = offload.offloaded_streamed_topk(
        h_s, h_t, 3, 4, block=4, depth=3, device='cpu')
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5)
    assert torch.equal(i, i1) and torch.equal(v, v1)
    assert stats.devices == jstats.devices == 2 and stats1.devices == 1
    assert (stats.ring_misses, stats.ring_evictions, stats.chunks) == \
        (jstats.ring_misses, jstats.ring_evictions, jstats.chunks)


def test_device_and_devices_are_exclusive():
    with pytest.raises(ValueError, match='device or devices'):
        offload.PrefetchRing(np.zeros((2, 1)), device='cpu',
                             devices=['cpu'])
    with pytest.raises(ValueError, match='device or devices'):
        offload.offloaded_streamed_topk(np.zeros((1, 4, 2), np.float32),
                                        np.zeros((1, 4, 2), np.float32), 1,
                                        2, device='cpu', devices=['cpu'])
