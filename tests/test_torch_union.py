"""The port's pair union (``UnionPair``, dgmc_tpu_torch/ops/blocked.py)
and DGMC's ``batch_pair`` held against the JAX package's on the CPU,
flax weights carried across by dgmc_tpu_torch.convert and JAX's noise
captured at ψ₂ and injected.

Tolerances, stated per check:

- ``UnionPair``'s graph and merged JAX fields (``src``, ``dst_local``,
  ``mask``, ``range_id``, ``inv_degree``, ``x``, the endpoints and masks):
  equal bit for bit, dtypes included.
- the union's row table: compact per batch element, checked by the
  union's ``ordered_aggregate`` equal bit for bit to the two sides'
  results concatenated around the pad (zeros), and ``range_ptr`` naming
  each range's blocks.
- DGMC with ``batch_pair`` in {True, 'psi_1', 'psi_2'}, eval mode, k in
  {-1, 10}, float32: the correspondences within rtol 1e-4 / atol 1e-5 of
  JAX's union model (indices equal where sparse; the same float32 terms
  summed in other orders: 1.1e-5 apart at most, on values near 0.4, in
  the dense union), and within JAX's own test
  tolerance (rtol 5e-4, atol 5e-5; ``tests/ops/test_blocked.py:148-183``)
  of the port's two-call model on the same blocked graphs.
- the refusals: JAX's ``ValueError`` with JAX's wording, the same
  ``match=`` holding for both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import RelCNN as JaxRelCNN
from dgmc_tpu.ops import GraphBatch as JaxGraphBatch
from dgmc_tpu.ops import blocked as jb
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops import blocked as tb
from dgmc_tpu_torch.ops.graph import GraphBatch

STEPS, R = 2, 16


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: small tensors, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(rng, b, n, e, c, hub=False):
    """JAX's ``random_graph`` (tests/ops/test_blocked.py:21-32)."""
    senders = rng.randint(0, n, (b, e)).astype(np.int32)
    receivers = rng.randint(0, n, (b, e)).astype(np.int32)
    if hub:
        receivers[0, :e // 2] = 3
    return {'x': rng.randn(b, n, c).astype(np.float32), 'senders': senders,
            'receivers': receivers, 'node_mask': np.ones((b, n), bool),
            'edge_mask': rng.rand(b, e) > 0.15}


def _sides(seed, sizes=((300, 1700), (400, 2100)), c=(24, 24), b=1,
           rows=64, block_edges=128, blocked=(True, True), hub=False):
    """Both packages' graphs of one seeded pair (blocked as asked)."""
    rng = np.random.RandomState(seed)
    arrs = [_arrays(rng, b, n, e, ci, hub=hub and i == 0)
            for i, ((n, e), ci) in enumerate(zip(sizes, c))]
    jg, tg = [], []
    for a, blk in zip(arrs, blocked):
        j = JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                          edge_attr=None)
        if blk:
            j = jb.attach_blocks(j, rows=rows, block_edges=block_edges,
                                 min_nodes=1)
            a = tb.attach_blocks(a, rows=rows, block_edges=block_edges,
                                 min_nodes=1)
        jg.append(j)
        tg.append(GraphBatch.from_numpy(a, 'cpu'))
    return jg, tg


@pytest.mark.parametrize('case', ['two_elements', 'hub_ragged', 'aligned'])
def test_union_graph_and_tables_equal_jax(case):
    """Two batch elements with different edge counts (so the source's row
    table is padded for one), a hub side with a source count no multiple
    of the range, and a source of whole ranges (no pad)."""
    kw = {'two_elements': dict(b=2),
          'hub_ragged': dict(sizes=((130, 900), (70, 400)), rows=32,
                             block_edges=64, hub=True),
          'aligned': dict(sizes=((128, 600), (200, 900)))}[case]
    jg, tg = _sides(1, **kw)
    if case == 'two_elements':
        # Fewer real edges in element 1: a shorter row table.
        for g in tg:
            assert int(g.blocks_in.row_ptr[1, -1]) != int(
                g.blocks_in.row_ptr[0, -1])
    ju, tu = jb.UnionPair(*jg), tb.UnionPair(*tg)
    assert (tu.n_s, tu.n_t, tu.pad) == (ju.n_s, ju.n_t, ju.pad)
    assert (tu.pad == 0) == (case == 'aligned')
    for f in ('x', 'senders', 'receivers', 'node_mask', 'edge_mask'):
        want = np.asarray(getattr(ju.graph, f))
        got = getattr(tu.graph, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f)
    for d in ('blocks_in', 'blocks_out'):
        jbk, tbk = getattr(ju.graph, d), getattr(tu.graph, d)
        for f in ('src', 'dst_local', 'mask', 'range_id', 'inv_degree'):
            want = np.asarray(getattr(jbk, f))
            got = getattr(tbk, f).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f'{d}.{f}')
        assert (tbk.rows, tbk.num_ranges) == (jbk.rows, jbk.num_ranges)
        rid = tbk.range_id.numpy()
        real = tbk.mask.numpy().any(-1)
        for b in range(rid.shape[0]):
            ptr = tbk.range_ptr[b].numpy()
            for r in range(tbk.num_ranges):
                assert (rid[b, ptr[r]:ptr[r + 1]] == r).all()
                assert real[b, ptr[r]:ptr[r + 1]].all()
            side_s, side_t = (getattr(g, d) for g in tg)
            nr_s, nb_s = side_s.num_ranges, side_s.src.shape[1]
            np.testing.assert_array_equal(ptr[:nr_s],
                                          side_s.range_ptr[b, :nr_s])
            np.testing.assert_array_equal(ptr[nr_s:] - nb_s,
                                          side_t.range_ptr[b])


@pytest.mark.parametrize('case', ['two_elements', 'hub_ragged'])
def test_union_row_table_is_compact(case):
    """The union's ordered_aggregate equals the sides' results
    concatenated around the pad, bit for bit, both directions: no padded
    row sums anything, and each element's target rows read its own
    edges."""
    kw = {'two_elements': dict(b=2),
          'hub_ragged': dict(sizes=((130, 900), (70, 400)), rows=32,
                             block_edges=64, hub=True)}[case]
    _, (g_s, g_t) = _sides(2, c=(5, 5), **kw)
    u = tb.UnionPair(g_s, g_t)
    gen = torch.Generator().manual_seed(0)
    x_s = torch.randn(g_s.x.shape, generator=gen)
    x_t = torch.randn(g_t.x.shape, generator=gen)
    for d in ('blocks_in', 'blocks_out'):
        got = tb.ordered_aggregate(u._cat(x_s, x_t), getattr(u.graph, d))
        want_s = tb.ordered_aggregate(x_s, getattr(g_s, d))
        want_t = tb.ordered_aggregate(x_t, getattr(g_t, d))
        pad = torch.zeros(x_s.shape[0], u.pad, 5)
        assert torch.equal(got, torch.cat([want_s, pad, want_t], dim=1))
        e_s = getattr(g_s, d).row_ptr[:, -1]
        e_t = getattr(g_t, d).row_ptr[:, -1]
        row_src = getattr(u.graph, d).row_src
        for b in range(row_src.shape[0]):
            assert not row_src[b, int(e_s[b] + e_t[b]):].any()
    a, b = u.apply(lambda x, g: x * 2, x_s, x_t)
    assert torch.equal(a, x_s * 2) and torch.equal(b, x_t * 2)


def _jax_model(k, batch_pair, bn=False):
    return JaxDGMC(JaxRelCNN(24, 48, 2, batch_norm=bn),
                   JaxRelCNN(R, R, 2), num_steps=STEPS, k=k,
                   batch_pair=batch_pair)


def _port_model(k, batch_pair, params):
    tm = DGMC(RelCNN(24, 48, 2), RelCNN(R, R, 2), num_steps=STEPS, k=k,
              batch_pair=batch_pair)
    tm.load_state_dict(dgmc_from_flax(params))
    return tm.eval()


def _jax_forward(jm, params, jg):
    """JAX's eval forward and the indicator noise it drew, read at ψ₂:
    every step's from the channel-packed source call, or each step's
    source rows of its union call."""
    calls = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            calls.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    rngs = {'noise': jax.random.PRNGKey(7),
            'negatives': jax.random.PRNGKey(8)}
    with nn.intercept_methods(capture):
        S0, SL = jm.apply({'params': params}, *jg, rngs=rngs)
    n_s = jg[0].x.shape[1]
    if calls[0].shape[-1] == STEPS * R:     # packed source side
        r_s = calls[0].reshape(1, n_s, STEPS, R).transpose(2, 0, 1, 3)
    else:                                   # one union call a step
        assert len(calls) == STEPS
        r_s = np.stack([c[:, :n_s] for c in calls])
    return S0, SL, torch.from_numpy(np.ascontiguousarray(r_s))


_PARAMS = {}


def _params(k, jg):
    if k not in _PARAMS:
        _PARAMS[k] = jax.device_get(_jax_model(k, None).init(
            {'params': jax.random.PRNGKey(0),
             'noise': jax.random.PRNGKey(7),
             'negatives': jax.random.PRNGKey(8)}, *jg)['params'])
    return _PARAMS[k]


@pytest.mark.parametrize('batch_pair', [True, 'psi_1', 'psi_2'])
@pytest.mark.parametrize('k', [-1, 10])
def test_dgmc_batch_pair_matches_jax(k, batch_pair):
    jg, tg = _sides(6)
    params = _params(k, jg)
    S0_j, SL_j, r_s = _jax_forward(_jax_model(k, batch_pair), params, jg)
    tm = _port_model(k, batch_pair, params)
    two_call = _port_model(k, None, params)
    assert tm.packs_source(STEPS) == (batch_pair == 'psi_1')
    with torch.no_grad():
        S0_t, SL_t = tm(*tg, r_s=r_s)
        _, SL_p = two_call(*tg, r_s=r_s)
    for got, want in ((S0_t, S0_j), (SL_t, SL_j)):
        np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                                   rtol=1e-4, atol=1e-5)
        if k > 0:
            np.testing.assert_array_equal(got.idx.numpy(),
                                          np.asarray(want.idx))
    np.testing.assert_allclose(SL_t.val.numpy(), SL_p.val.numpy(),
                               rtol=5e-4, atol=5e-5)


def _raises_like_jax(jm, tm, jg, tg, match, **kw):
    with pytest.raises(ValueError, match=match):
        jm.init({'params': jax.random.PRNGKey(0),
                 'noise': jax.random.PRNGKey(1),
                 'negatives': jax.random.PRNGKey(2)}, *jg, **kw)
    with pytest.raises(ValueError, match=match):
        tm(*tg, **kw)


def _refusal(kind):
    """(JAX model, port model, graphs, match, forward kwargs) of one
    refusal."""
    sizes = ((60, 240), (80, 300))
    if kind == 'unknown':
        jg, tg = _sides(7, sizes=sizes)
        return (JaxDGMC(JaxRelCNN(24, 32, 2), JaxRelCNN(8, 8, 2), 1, k=4,
                        batch_pair='both'),
                DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2), 1, k=4,
                     batch_pair='both'), jg, tg, 'batch_pair', {})
    if kind == 'widths':
        jg, tg = _sides(7, sizes=sizes, c=(24, 16))
        return (JaxDGMC(JaxRelCNN(24, 32, 2), JaxRelCNN(8, 8, 2), 1, k=4,
                        batch_pair='psi_1'),
                DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2), 1, k=4,
                     batch_pair='psi_1'), jg, tg, 'widths differ', {})
    if kind == 'unblocked':
        jg, tg = _sides(7, sizes=sizes, blocked=(True, False))
        return (JaxDGMC(JaxRelCNN(24, 32, 2), JaxRelCNN(8, 8, 2), 1, k=4,
                        batch_pair=True),
                DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2), 1, k=4,
                     batch_pair=True), jg, tg, 'cannot be stacked', {})
    if kind == 'batch_norm':
        jg, tg = _sides(7, sizes=sizes)
        return (JaxDGMC(JaxRelCNN(24, 32, 2, batch_norm=True),
                        JaxRelCNN(8, 8, 2), 1, k=4, batch_pair='psi_1'),
                DGMC(RelCNN(24, 32, 2, batch_norm=True), RelCNN(8, 8, 2), 1,
                     k=4, batch_pair='psi_1'), jg, tg, 'BatchNorm', {})
    jg, tg = _sides(7, sizes=sizes)      # h_t with a merged ψ₂
    h_t = np.zeros((1, 80, 32), np.float32)
    return (JaxDGMC(JaxRelCNN(24, 32, 2), JaxRelCNN(8, 8, 2), 1, k=4,
                    batch_pair='psi_2'),
            DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2), 1, k=4,
                 batch_pair='psi_2'), jg, tg, 'incompatible',
            {'h_t': h_t})


@pytest.mark.parametrize('kind', ['unknown', 'widths', 'unblocked',
                                  'batch_norm', 'h_t'])
def test_batch_pair_refusals_match_jax(kind):
    jm, tm, jg, tg, match, kw = _refusal(kind)
    if kind == 'h_t':
        with pytest.raises(ValueError, match=match):
            jm.init({'params': jax.random.PRNGKey(0),
                     'noise': jax.random.PRNGKey(1)}, *jg,
                    h_t=jnp.asarray(kw['h_t']))
        with pytest.raises(ValueError, match=match):
            tm.eval()(*tg, h_t=torch.from_numpy(kw['h_t']))
        return
    _raises_like_jax(jm, tm.eval(), jg, tg, match)


def test_batch_pair_refusals_on_the_dense_variant():
    """The dense variant refuses an unblocked pair and batch norm the
    same way."""
    jg, tg = _sides(8, sizes=((60, 240), (80, 300)), blocked=(False, True))
    tm = DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2), 1, batch_pair='psi_2')
    with pytest.raises(ValueError, match='cannot be stacked'):
        tm.eval()(*tg)
    jg, tg = _sides(8, sizes=((60, 240), (80, 300)))
    tm = DGMC(RelCNN(24, 32, 2), RelCNN(8, 8, 2, batch_norm=True), 1,
              batch_pair=True)
    with pytest.raises(ValueError, match='BatchNorm'):
        tm.eval()(*tg)
