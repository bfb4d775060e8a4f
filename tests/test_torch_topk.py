"""The port's top-k (dgmc_tpu_torch.ops.topk, ops/kernels/topk.py) held
against the JAX package's dense_topk, chunked_topk and the Pallas kernel
(interpret mode), on the cases of tests/ops/test_pallas_topk.py.

Tolerances: indices must be equal on every case. Values are bit-equal on
integer-valued inputs (every product and partial sum is an exact small
integer in float32); on continuous inputs the two frameworks sum the
channels in different orders, so values agree to rtol 1e-5 (a few float32
ulps of C <= 16 terms), and the seeds give no near-ties for the indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.ops.pallas.topk import pallas_topk
from dgmc_tpu.ops.topk import chunked_topk as jax_chunked
from dgmc_tpu.ops.topk import dense_topk as jax_dense
from dgmc_tpu_torch.ops import topk as port
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.topk import (BLOCK_OVERHEAD_TILES, K_MAX,
                                             ROW_TILES, TARGETS_PER_TILE,
                                             blocks_per_sm, launch_plan,
                                             plain_topk, streaming_topk)


def _case(name):
    """(h_s, h_t, mask, k, integer_valued) as numpy, made from a seed."""
    if name == 'continuous':
        rng = np.random.RandomState(0)
        return (rng.randn(2, 130, 16).astype(np.float32),
                rng.randn(2, 1100, 16).astype(np.float32), None, 10, False)
    if name == 'ties_mask':
        rng = np.random.RandomState(1)
        return (rng.randint(0, 3, (2, 300, 8)).astype(np.float32),
                rng.randint(0, 3, (2, 700, 8)).astype(np.float32),
                rng.rand(2, 700) > 0.3, 7, True)
    if name == 'k_exceeds_valid':
        rng = np.random.RandomState(2)
        return (rng.randn(1, 40, 4).astype(np.float32),
                rng.randn(1, 20, 4).astype(np.float32),
                np.arange(20)[None] < 5, 9, False)
    n_s, n_t = {'tile_small': (5, 17), 'tile_exact': (256, 512),
                'tile_64': (64, 64), 'tile_65': (65, 65)}[name]
    rng = np.random.RandomState(4)
    return (rng.randint(-2, 3, (1, n_s, 8)).astype(np.float32),
            rng.randint(-2, 3, (1, n_t, 8)).astype(np.float32), None, 3,
            True)


CASES = ['continuous', 'ties_mask', 'k_exceeds_valid', 'tile_small',
         'tile_exact', 'tile_64', 'tile_65']


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize('name', CASES)
def test_dense_topk_matches_jax(name):
    h_s, h_t, mask, k, _ = _case(name)
    want = np.asarray(jax_dense(_jax(h_s), _jax(h_t), k, _jax(mask)))
    got = port.dense_topk(_torch(h_s), _torch(h_t), k, _torch(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('block', [4, 256])
@pytest.mark.parametrize('name', CASES)
def test_chunked_topk_matches_jax_scan_and_pallas(name, block):
    h_s, h_t, mask, k, exact = _case(name)
    want_v, want_i = jax_chunked(_jax(h_s), _jax(h_t), k, _jax(mask),
                                 return_values=True, pallas=False)
    pal_v, pal_i = pallas_topk(_jax(h_s), _jax(h_t), k, t_mask=_jax(mask),
                               return_values=True, interpret=True)
    got_v, got_i = port.chunked_topk(_torch(h_s), _torch(h_t), k,
                                     _torch(mask), return_values=True)
    blk_v, blk_i = plain_topk(_torch(h_s), _torch(h_t), k, _torch(mask),
                              block=block)
    assert torch.equal(blk_i, got_i) and torch.equal(blk_v, got_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))
    if exact:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(pal_v))
    else:
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-5)


def test_masked_values_and_carry_rule():
    """Masked targets score finfo.min (strictly above the -inf carry), so
    with k > valid targets the masked tail comes out in index order."""
    h_s, h_t, mask, k, _ = _case('k_exceeds_valid')
    vals, idx = plain_topk(_torch(h_s), _torch(h_t), k, _torch(mask),
                           block=4)
    assert (vals[..., 5:] == torch.finfo(torch.float32).min).all()
    np.testing.assert_array_equal(idx[0, :, 5:].numpy(),
                                  np.tile(np.arange(5, 9), (40, 1)))


def test_cpu_wrapper_takes_plain_path_and_records_it():
    dispatch.reset()
    h_s, h_t, mask, k, _ = _case('ties_mask')
    streaming_topk(_torch(h_s), _torch(h_t), k, _torch(mask))
    d = dispatch.decisions()['topk']
    assert (d['path'], d['reason']) == ('plain', 'device=cpu')
    assert dispatch.launch_counts()['topk'] == 0
    assert K_MAX >= 64


@pytest.mark.parametrize('k', [0, 21])
def test_k_outside_targets_raises(k):
    h_s, h_t, _, _, _ = _case('k_exceeds_valid')
    with pytest.raises(ValueError):
        streaming_topk(_torch(h_s), _torch(h_t), k)


def test_search_carries_no_gradient():
    h_s = torch.randn(1, 6, 4, requires_grad=True)
    h_t = torch.randn(1, 9, 4, requires_grad=True)
    vals, _ = port.chunked_topk(h_s, h_t, 3, return_values=True)
    assert not vals.requires_grad


# (B, N_s, N_t, SM count): the small serve queries (16, 32, 64 rows and
# row counts just past a tile), one row, the whole DBP15K source KG, the
# CPU comparison's 1500 x 2000, a batch of 2, fewer targets than a tile
# and a smaller card.
PLANS = [(1, 16, 20000, 132), (1, 32, 20000, 132), (1, 64, 20000, 132),
         (1, 17, 20000, 132), (1, 33, 20000, 132), (1, 1, 20000, 132),
         (1, 15000, 20000, 132), (1, 1500, 2000, 132), (2, 130, 1100, 132),
         (1, 40, 20, 132), (1, 16, 20000, 80)]


def _plan_segments(N_t, tiles_per_seg, nseg):
    n_tiles = -(-N_t // TARGETS_PER_TILE)
    return [list(range(s * tiles_per_seg,
                       min((s + 1) * tiles_per_seg, n_tiles)))
            for s in range(nseg)]


@pytest.mark.parametrize('plan', PLANS)
def test_launch_plan_sizes_the_row_tile_and_covers_targets_in_order(plan):
    B, N_s, N_t, sms = plan
    ts, nseg, tiles_per_seg = launch_plan(B, N_s, N_t, sms)
    # The smallest row tile that holds the query: no padding-row tile.
    assert ts == min([t for t in ROW_TILES if t >= N_s] or [128])
    # Every target tile exactly once, segments in index order, none empty.
    segs = _plan_segments(N_t, tiles_per_seg, nseg)
    assert all(segs)
    assert [t for seg in segs for t in seg] == list(
        range(-(-N_t // TARGETS_PER_TILE)))
    blocks = B * -(-N_s // ts) * nseg
    if N_s <= 64 and N_t >= 2 * sms * TARGETS_PER_TILE:
        assert blocks >= sms          # a small query fills the card
    # No other segment length gives fewer waves x (tiles + the block's
    # own cost).
    n_tiles = len(_plan_segments(N_t, 1, -(-N_t // TARGETS_PER_TILE)))
    slots = sms * blocks_per_sm(ts)

    def cost(tps):
        waves = -(-B * -(-N_s // ts) * -(-n_tiles // tps) // slots)
        return waves * (tps + BLOCK_OVERHEAD_TILES)
    assert cost(tiles_per_seg) == min(cost(t) for t in range(1, n_tiles + 1))


@pytest.mark.parametrize('plan', [(1, 16, 1100, 132), (2, 130, 1100, 132),
                                  (1, 40, 20, 132)])
@pytest.mark.parametrize('name', ['ties_mask', 'continuous'])
def test_segment_lists_merged_by_key_match_jax(plan, name):
    """The kernel's split: each segment's own top-k (the plain scan over
    its targets), then a merge of the lists by value descending and index
    ascending, gives JAX's top-k, ties included."""
    B, N_s, N_t, sms = plan
    rng = np.random.RandomState(N_s + N_t)
    k = 7
    if name == 'ties_mask':
        h_s = rng.randint(0, 3, (B, N_s, 8)).astype(np.float32)
        h_t = rng.randint(0, 3, (B, N_t, 8)).astype(np.float32)
        mask = rng.rand(B, N_t) > 0.6
    else:
        h_s = rng.randn(B, N_s, 8).astype(np.float32)
        h_t = rng.randn(B, N_t, 8).astype(np.float32)
        mask = None
    _, nseg, tiles_per_seg = launch_plan(B, N_s, N_t, sms)
    vals, idx = [], []
    for seg in _plan_segments(N_t, tiles_per_seg, nseg):
        lo = seg[0] * TARGETS_PER_TILE
        hi = min(N_t, (seg[-1] + 1) * TARGETS_PER_TILE)
        kk = min(k, hi - lo)
        v, i = plain_topk(_torch(h_s), _torch(h_t[:, lo:hi]), kk,
                          None if mask is None else _torch(mask[:, lo:hi]))
        vals.append(v)
        idx.append(i.long() + lo)
    v, i = torch.cat(vals, -1), torch.cat(idx, -1)
    by_index = torch.argsort(i, dim=-1, stable=True)
    v, i = v.gather(-1, by_index), i.gather(-1, by_index)
    order = torch.argsort(v, dim=-1, descending=True, stable=True)[..., :k]
    want_v, want_i = jax_chunked(_jax(h_s), _jax(h_t), k, _jax(mask),
                                 return_values=True, pallas=False)
    np.testing.assert_array_equal(i.gather(-1, order).numpy(),
                                  np.asarray(want_i))
    if name == 'ties_mask':
        np.testing.assert_array_equal(v.gather(-1, order).numpy(),
                                      np.asarray(want_v))
    else:
        np.testing.assert_allclose(v.gather(-1, order).numpy(),
                                   np.asarray(want_v), rtol=1e-5)
