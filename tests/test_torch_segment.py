"""The port's segment reductions by segment ids (dgmc_tpu_torch/ops/
segment.py) held against the JAX package's (dgmc_tpu/ops/segment.py) on
the CPU: the cases of tests/ops/test_segment.py, then seeded random ones
(empty segments, ids outside the range, bf16 and integer data, weights).

Tolerances: exact on the small integer-valued cases (as JAX's tests);
rtol 1e-6 / atol 1e-6 against JAX on random float32 rows (the same
float32 terms summed in another order; the port sums each segment in the
ids' stable order, in float32); bf16 data within one bf16 rounding of
JAX's float32 sum of the same rows. Repeats bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.ops import segment_mean as jax_segment_mean
from dgmc_tpu.ops import segment_sum as jax_segment_sum
from dgmc_tpu_torch.ops import segment_mean, segment_sum


def test_segment_sum():
    data = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    out = segment_sum(data, torch.tensor([0, 2, 0]), 3)
    assert out.tolist() == [[6.0, 8.0], [0.0, 0.0], [3.0, 4.0]]


def test_segment_mean():
    data = torch.tensor([[2.0], [4.0], [6.0]])
    out = segment_mean(data, torch.tensor([1, 1, 0]), 3)
    assert out.tolist() == [[6.0], [3.0], [0.0]]


def test_segment_mean_weighted():
    data = torch.tensor([[2.0], [4.0], [6.0]])
    w = torch.tensor([1.0, 1.0, 0.0])   # mask out the last edge
    out = segment_mean(data, torch.tensor([0, 0, 0]), 1, weights=w)
    assert out.tolist() == [[3.0]]


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('shape', [(300,), (300, 7), (300, 3, 5)])
def test_random_segments_match_jax(seed, shape):
    """Empty segments, ids past the last segment and negative ids (both
    dropped, as ``jax.ops.segment_sum`` drops them)."""
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    ids = rng.randint(-3, 45, shape[0]).astype(np.int32)
    n = 40
    want = np.asarray(jax_segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                      n))
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, segment_sum(torch.from_numpy(data),
                                        torch.from_numpy(ids), n))
    if len(shape) == 2:
        w = (rng.rand(shape[0]) > 0.3).astype(np.float32)
        for weights in (None, w):
            want = np.asarray(jax_segment_mean(
                jnp.asarray(data), jnp.asarray(ids), n,
                weights=None if weights is None else jnp.asarray(weights)))
            got = segment_mean(torch.from_numpy(data),
                               torch.from_numpy(ids), n,
                               weights=None if weights is None
                               else torch.from_numpy(weights))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
            empty = ~np.isin(np.arange(n), ids)
            assert not got.numpy()[empty].any()


def test_bf16_and_integer_data():
    rng = np.random.RandomState(5)
    data = rng.randn(500, 4).astype(np.float32)
    ids = rng.randint(0, 8, 500)
    bf = torch.from_numpy(data).to(torch.bfloat16)
    got = segment_sum(bf, torch.from_numpy(ids), 8)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_segment_sum(jnp.asarray(bf.float().numpy()),
                                      jnp.asarray(ids), 8))
    # Summed in float32, rounded to bf16 once.
    want = torch.from_numpy(np.array(want))
    assert ((got.float() - want).abs() <= want.abs() * 2 ** -8 + 1e-6).all()
    ints = rng.randint(-5, 6, (500, 3))
    got = segment_sum(torch.from_numpy(ints), torch.from_numpy(ids), 8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_segment_sum(
        jnp.asarray(ints), jnp.asarray(ids), 8)))
