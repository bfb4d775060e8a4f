"""The port's rank-sharded top-k (``dgmc_tpu_torch/parallel/topk.py``)
held against JAX's sharded searches (``dgmc_tpu.parallel``) on a 2- and
a 4-device mesh of the virtual CPU devices and against ``dense_topk``:
``sharded_topk_rows``, ``sharded_topk_cols`` and ``corr_sharded_topk``
(the whole targets here; the ring in ``test_torch_parallel_ring.py``) on
gloo ranks, each a CPU process.

The cases are those of ``tests/parallel/test_topk.py``: value ties
(duplicated target rows), masked columns, ragged rows (padded to the
rank count), a ragged batch (``None``) and ``cols`` refusing an
oversized ``k``; beside them, held against ``dense_topk`` alone,
all-equal scores and the rows streamed in chunks. Indices must be equal,
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dgmc_tpu import parallel as jpar
from dgmc_tpu.ops.topk import dense_topk as jax_dense_topk
from dgmc_tpu.parallel.topk import corr_sharded_topk as jax_corr_topk
from dgmc_tpu_torch.ops.topk import dense_topk
from dgmc_tpu_torch.parallel import mesh as tmesh
from dgmc_tpu_torch.parallel import topk as ttopk
from tests.torch_dist_worker import run_groups

WORLDS = (2, 4)


def _case(B=2, N_s=16, N_t=24, C=8, seed=0, ties=False):
    """``tests/parallel/test_topk.py``'s ``_case``."""
    rng = np.random.RandomState(seed)
    h_s = rng.randn(B, N_s, C).astype(np.float32)
    h_t = rng.randn(B, N_t, C).astype(np.float32)
    if ties:
        h_t = np.repeat(h_t[:, ::2], 2, axis=1)
    t_mask = np.ones((B, N_t), bool)
    t_mask[:, -3:] = False
    return h_s, h_t, t_mask


def ring_cases(world):
    """``test_ring_topk.py``'s ragged, tied and masked ring cases."""
    rng = np.random.RandomState(0)
    out = {}
    for n_t, k, chunk in [(29, 4, None), (32, 5, 8), (24, 6, 4)]:
        base = rng.randn(1, n_t, 8).astype(np.float32)
        base[0, n_t // 2:] = base[0, :n_t - n_t // 2]
        h_s = rng.randn(1, 16, 8).astype(np.float32)
        tm = rng.rand(1, n_t) > 0.3
        out[f'ring-nt{n_t}-k{k}-chunk{chunk}'] = (
            'ring', h_s, base, tm, k, {'block': 8, 'chunk': chunk})
    ones_s, ones_t = np.ones((1, 16, 4), np.float32), np.ones((1, 32, 4),
                                                              np.float32)
    out['ring-all-equal'] = ('ring', ones_s, ones_t, None, 5, {'block': 8})
    rng = np.random.RandomState(3)
    a = rng.randn(1, 16, 8).astype(np.float32)
    b = rng.randn(1, 24, 8).astype(np.float32)
    out['ring-k-above-shard'] = ('ring', a, b, None, 24 // world + 1,
                                 {'block': 8})
    return out


#: Cases held against ``dense_topk`` alone (no JAX search of their own).
DENSE_ONLY = ('rows-chunk5', 'rows-all-equal', 'cols-all-equal')


def cases(world):
    """``{name: (kind, h_s, h_t, t_mask, k, kw)}`` for ``world`` ranks."""
    out = {}
    for ties in (False, True):
        h_s, h_t, tm = _case(ties=ties)
        out[f'rows-ties{ties}'] = ('rows', h_s, h_t, tm, 5, {'block': 8})
        out[f'cols-ties{ties}'] = ('cols', h_s, h_t, tm, 3, {})
    h_s, h_t, tm = _case()
    out['rows-chunk5'] = ('rows', h_s, h_t, tm, 5, {'block': 8, 'chunk': 5})
    ones_s, ones_t = np.ones((1, 16, 4), np.float32), np.ones((1, 32, 4),
                                                              np.float32)
    out['rows-all-equal'] = ('rows', ones_s, ones_t, None, 5, {'block': 8})
    out['cols-all-equal'] = ('cols', ones_s, ones_t, None, 5, {})
    out['cols-oversized-k'] = ('cols_refuse', h_s, h_t, tm,
                               24 // world + 1, {})
    for n_s in (13, 15, 17):
        a, b, m = _case(B=1, N_s=n_s, ties=True)
        out[f'corr-ragged-rows{n_s}'] = ('corr', a, b, m, 5, {})
    z = np.zeros((3, 16, 8), np.float32)
    out['corr-ragged-batch'] = ('corr_batch', z, z, None, 5, {})
    return out


@pytest.fixture(scope='module')
def ranks():
    """Every case on 2 and on 4 ranks (the two groups side by side)."""
    results = run_groups([('tests.torch_parallel_jobs:topk_cases', w,
                           (cases(w),)) for w in WORLDS])
    return dict(zip(WORLDS, results))


def jax_search(world, kind, h_s, h_t, t_mask, k, kw):
    """JAX's same search on a ``world``-device mesh."""
    devices = jax.devices()[:world]
    a, b = jnp.asarray(h_s), jnp.asarray(h_t)
    m = None if t_mask is None else jnp.asarray(t_mask)
    if kind in ('rows', 'cols', 'cols_refuse'):
        mesh = jpar.make_mesh(data=1, model=world, devices=devices)
        if kind == 'rows':
            return jpar.sharded_topk_rows(mesh, a, b, k, t_mask=m, **kw)
        try:
            return jpar.sharded_topk_cols(mesh, a, b, k, t_mask=m, **kw)
        except ValueError as e:
            return str(e)
    if kind == 'corr_batch':
        mesh = jpar.make_mesh(data=2, model=world // 2, devices=devices)
        return jax_corr_topk(NamedSharding(mesh, P('data', 'model', None)),
                             a, b, k, m, **kw)
    if kind == 'corr':
        mesh = jpar.make_mesh(data=1, model=world, devices=devices)
        return jax_corr_topk(jpar.corr_sharding(mesh), a, b, k, m, **kw)
    mesh = jpar.make_mesh(data=world, model=1, devices=devices)
    return jax_corr_topk(NamedSharding(mesh, P(None, 'data')), a, b, k, m,
                         ring=True, **kw)


def hold(got, world, kind, h_s, h_t, t_mask, k, kw, with_jax=True):
    """Every rank's ``got`` equal to JAX's search on ``world`` devices
    (``with_jax``) and to ``dense_topk`` (both packages')."""
    want = (jax_search(world, kind, h_s, h_t, t_mask, k, kw) if with_jax
            else None)
    if kind == 'cols_refuse':
        assert want.startswith(f'k={k} exceeds columns per shard')
        assert got == [want] * world
        return
    if kind == 'corr_batch':
        assert want is None and got == [None] * world
        return
    dense = dense_topk(torch.from_numpy(h_s), torch.from_numpy(h_t), k,
                       None if t_mask is None else torch.from_numpy(t_mask))
    np.testing.assert_array_equal(
        np.asarray(jax_dense_topk(jnp.asarray(h_s), jnp.asarray(h_t), k,
                                  t_mask=None if t_mask is None
                                  else jnp.asarray(t_mask))),
        dense.numpy())
    for rank_out in got:
        if with_jax:
            np.testing.assert_array_equal(rank_out, np.asarray(want))
        np.testing.assert_array_equal(rank_out, dense.numpy())


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(cases(2)))
def test_sharded_topk_matches_jax_and_dense(ranks, world, name):
    hold([r[name] for r in ranks[world]], world, *cases(world)[name],
         with_jax=name not in DENSE_ONLY)


def test_one_process_mesh_runs_the_search_alone():
    """Without a process group the mesh is 1 x 1 with no groups: rows,
    columns and the ring run the plain search, the ring falling back to
    the whole targets, and the decision ``topk_embedded`` is recorded as
    JAX names it (``plain``, ``device=cpu`` here)."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    h_s, h_t, tm = (torch.from_numpy(x) for x in _case(ties=True))
    mesh = tmesh.make_mesh(device='cpu')
    assert mesh.size == 1 and mesh.group() is None
    want = dense_topk(h_s, h_t, 5, tm)
    dispatch.reset()
    torch.testing.assert_close(
        ttopk.sharded_topk_rows(mesh, h_s, h_t, 5, tm, gather=True), want)
    torch.testing.assert_close(ttopk.sharded_topk_cols(mesh, h_s, h_t, 5,
                                                       tm), want)
    sh = tmesh.NamedSharding(mesh, (None, 'data'))
    torch.testing.assert_close(
        ttopk.corr_sharded_topk(sh, h_s, h_t, 5, tm, ring=True), want)
    d = dispatch.decisions()['topk_embedded']
    assert (d['path'], d['reason'], d['counts']['plain']) == (
        'plain', 'device=cpu', 3)


@pytest.mark.parametrize('world', WORLDS)
def test_ring_moves_no_data(world):
    """Every rank holds the whole targets (ψ₁ runs whole on each), so the
    ring takes each rotation's shard from the rank's own copy: over a
    mesh whose groups refuse any use, each rank's block equals the dense
    search's rows, ties and a ragged ring included."""
    h_s, h_t, tm = (torch.from_numpy(x)
                    for x in _case(N_s=15, N_t=22, ties=True))
    want = dense_topk(h_s, h_t, 3, tm)

    class Ranks:
        def __init__(self, index):
            self.index = index

        def axis_size(self, axis):
            return 1 if axis is None else world

        def axis_index(self, axis):
            return 0 if axis is None else self.index

        def group(self, axis=None):
            raise AssertionError('the ring communicated')

    for me in range(world):
        sh = tmesh.NamedSharding(Ranks(me), (None, 'data'))
        got = ttopk.corr_sharded_topk(sh, h_s, h_t, 3, tm, ring=True)
        lo, hi, _ = ttopk.row_block(15, world, me)
        n = min(hi, 15) - lo
        torch.testing.assert_close(got[:, :n], want[:, lo:lo + n], rtol=0,
                                   atol=0)


def test_search_is_not_differentiable():
    """The search runs without a graph (JAX's ``_ad_opaque``): indices
    carry no gradient, and gathering by them still differentiates."""
    h_s, h_t, tm = (torch.from_numpy(x) for x in _case())
    h_s.requires_grad_(True)
    h_t.requires_grad_(True)
    mesh = tmesh.make_mesh(device='cpu')
    idx = ttopk.corr_sharded_topk(tmesh.NamedSharding(mesh, (None, 'data')),
                                  h_s, h_t, 4, tm, chunk=8, ring=True)
    assert not idx.requires_grad
    g = torch.gather(h_t, 1, idx.long().reshape(2, -1, 1).expand(-1, -1, 8))
    (g.sum() + h_s.sum()).backward()
    assert torch.isfinite(h_t.grad).all() and torch.isfinite(h_s.grad).all()


def test_row_block_pads_to_equal_blocks():
    assert [ttopk.row_block(13, 4, i) for i in range(4)] == [
        (0, 4, 16), (4, 8, 16), (8, 12, 16), (12, 16, 16)]
    assert ttopk.row_block(12, 3, 2) == (8, 12, 12)


def test_rows_refuses_rows_that_do_not_divide():
    class Two:
        def axis_size(self, axis):
            return 2

        def axis_index(self, axis):
            return 0
    h = torch.zeros(1, 5, 4)
    with pytest.raises(ValueError, match='not divisible by 2 shards'):
        ttopk.sharded_topk_rows(Two(), h, h, 2)
