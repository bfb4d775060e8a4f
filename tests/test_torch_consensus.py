"""The port's dense consensus update held against the JAX package on the
CPU: the plain forward and the tile-recompute backward against
``consensus_update(..., interpret=True)`` (the Pallas kernel in interpret
mode, with its ``lax.scan`` backward) and the unfused reference.

Tolerances: the port sums through the factored form
``relu(u_s - u_t) @ W2`` with ``u = o @ W1``, the JAX kernel through the
per-pair ``(o_s - o_t) @ W1``; the float32 sums of O(1) terms differ by a
few ulps, so the forward agrees to rtol/atol 1e-5. The gradients add up
N_s * N_t such terms: rtol 1e-4 with atol 1e-4 (the JAX package's own
kernel test), or 1e-5 of the tensor's largest |gradient| where that is
larger (at 80 x 80, R = 64 gradients reach ~2e3 and differ by ~2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.ops.pallas import consensus_update as jax_consensus
from dgmc_tpu.ops.pallas import consensus_update_reference as jax_reference
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.consensus import (MAX_THREADS, MICRO,
                                                  TILE_MAX, TILE_T,
                                                  consensus_fwd,
                                                  consensus_update,
                                                  launch_plan,
                                                  plain_consensus)


def _case(B=2, Ns=20, Nt=37, R=8, seed=0):
    """``tests/ops/test_consensus_pallas.py``'s inputs: o_s, o_t, W1, b1,
    W2, b2."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Ns, R).astype(np.float32),
            rng.randn(B, Nt, R).astype(np.float32),
            (0.3 * rng.randn(R, R)).astype(np.float32),
            (0.1 * rng.randn(R)).astype(np.float32),
            (0.3 * rng.randn(R, 1)).astype(np.float32),
            (0.1 * rng.randn(1)).astype(np.float32))


# Nt = 37 spans two backward tiles with a ragged last one; 80 x 80 at
# R = 64 is the training path's per-pair shape.
SHAPES = {'ragged': dict(), 'one_tile': dict(Ns=5, Nt=TILE_T - 3, R=4),
          'train_width': dict(B=1, Ns=80, Nt=80, R=64, seed=3)}


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_forward_matches_jax_kernel(name):
    args = _case(**SHAPES[name])
    want = jax_consensus(*map(jnp.asarray, args), True)
    t_args = [torch.from_numpy(a) for a in args]
    dispatch.reset()
    got = consensus_fwd(*t_args)
    assert dispatch.decisions()['consensus_fwd']['reason'] == 'device=cpu'
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(plain_consensus(*t_args).numpy(),
                                  got.numpy())


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_gradients_match_jax_kernel(name):
    args = _case(**SHAPES[name])
    j_args = tuple(map(jnp.asarray, args))

    def loss_ker(a):
        return (jax_consensus(*a, True) ** 2).sum()

    want = jax.grad(loss_ker)(j_args)
    want_ref = jax.grad(lambda a: (jax_reference(*a) ** 2).sum())(j_args)
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (consensus_update(*t_args) ** 2).sum().backward()
    for a, w, wr in zip(t_args, want, want_ref):
        atol = max(1e-4, 1e-5 * float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=atol)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(wr),
                                   rtol=1e-4, atol=atol)


def test_backward_equals_autograd_of_plain_form():
    """The tile recompute and autograd through the factored plain form
    compute the same gradients (only the reduction order differs)."""
    args = _case(B=3, Ns=11, Nt=70, R=6, seed=7)
    a1 = [torch.from_numpy(a).requires_grad_(True) for a in args]
    a2 = [torch.from_numpy(a).requires_grad_(True) for a in args]
    g = torch.from_numpy(np.random.RandomState(8).randn(3, 11, 70).astype(
        np.float32))
    (consensus_update(*a1) * g).sum().backward()
    (plain_consensus(*a2) * g).sum().backward()
    for x, y in zip(a1, a2):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_shape_errors_raise():
    o_s, o_t, w1, b1, w2, b2 = map(torch.from_numpy, _case())
    with pytest.raises(ValueError):
        consensus_fwd(o_s, o_t[..., :-1], w1, b1, w2, b2)
    with pytest.raises(ValueError):
        consensus_fwd(o_s, o_t, w1[:-1], b1, w2, b2)


@pytest.mark.parametrize('shape', [(64, 80, 80), (1, 1, 1), (2, 20, 37),
                                   (2, 33, 65), (1, 500, 700),
                                   (8, 128, 128), (3, 129, 5),
                                   (1, 3000, 3000)])
@pytest.mark.parametrize('sms', [132, 1])
def test_launch_plan_is_the_cheapest_legal_tile(shape, sms):
    """The pair kernel's tile: sides a multiple of MICRO up to TILE_MAX,
    at most MAX_THREADS threads, no larger than needed (one more row of
    micro-tiles per cut would not lower the tile count), and no legal
    tile has fewer waves times block cost (padded pairs plus staged
    rows), then fewer blocks."""
    B, N_s, N_t = shape
    TS, TT = launch_plan(B, N_s, N_t, sms)

    def legal(ts, tt):
        return (ts % MICRO == tt % MICRO == 0 and MICRO <= ts <= TILE_MAX
                and MICRO <= tt <= TILE_MAX
                and (ts // MICRO) * (tt // MICRO) <= MAX_THREADS)

    def cost(ts, tt):
        blocks = B * -(-N_s // ts) * -(-N_t // tt)
        return -(-blocks // sms) * (ts * tt + 2 * (ts + tt)), blocks

    assert legal(TS, TT)
    for ts in range(MICRO, TILE_MAX + 1, MICRO):
        for tt in range(MICRO, TILE_MAX + 1, MICRO):
            if legal(ts, tt):
                assert cost(TS, TT) <= cost(ts, tt), (ts, tt)
    if shape == (64, 80, 80) and sms == 132:
        assert (TS, TT) in ((40, 80), (80, 40))
