"""The port's graph ops, masked softmax and RelCNN held against the JAX
package on the same seeded inputs, with flax weights carried across by
dgmc_tpu_torch.convert.

Tolerances: aggregation sums the same float32 terms in another order
(receiver-sorted segment reduction vs XLA's segment_sum), so sums and
means agree to atol 1e-6 on O(1) messages; softmax to 1e-6. The RelCNN
forward chains float32 matrix products whose accumulation order differs
between the frameworks; atol 1e-5 on O(1) activations is a few hundred
ulps and fails on any wrong weight, layout or masking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
from dgmc_tpu.ops import graph as jgraph
from dgmc_tpu.ops.softmax import masked_softmax as jax_masked_softmax
from dgmc_tpu_torch.convert import dgmc_from_flax, relcnn_from_flax
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops import graph as tgraph
from dgmc_tpu_torch.ops.softmax import masked_softmax


def _graph_arrays(seed, B=2, N=13, E=40, C=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    # Nodes N-3.. have no incoming real edge: empty neighbourhoods.
    snd = rng.randint(0, N, (B, E)).astype(np.int32)
    rcv = rng.randint(0, N - 3, (B, E)).astype(np.int32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, N - 2:] = False
    edge_mask = rng.rand(B, E) > 0.2
    return {'x': x, 'senders': snd, 'receivers': rcv,
            'node_mask': node_mask, 'edge_mask': edge_mask}


def _jax_graph(a):
    return jgraph.GraphBatch(**{k: jnp.asarray(v) for k, v in a.items()})


@pytest.mark.parametrize('aggr', ['sum', 'mean'])
def test_scatter_to_nodes_matches_jax(aggr):
    a = _graph_arrays(0)
    msgs = np.random.RandomState(1).randn(2, 40, 6).astype(np.float32)
    want = jgraph.scatter_to_nodes(jnp.asarray(msgs),
                                   jnp.asarray(a['receivers']),
                                   jnp.asarray(a['edge_mask']), 13, aggr)
    g = tgraph.GraphBatch.from_numpy(a, 'cpu')
    got = tgraph.scatter_to_nodes(torch.from_numpy(msgs), g.receivers,
                                  g.edge_mask, 13, aggr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # Empty neighbourhoods aggregate to exactly zero.
    assert (got[:, -3:] == 0).all()


def test_degree_and_gather_match_jax():
    a = _graph_arrays(2)
    g = tgraph.GraphBatch.from_numpy(a, 'cpu')
    want = jgraph.degree(jnp.asarray(a['receivers']),
                         jnp.asarray(a['edge_mask']), 13)
    np.testing.assert_array_equal(
        tgraph.degree(g.receivers, g.edge_mask, 13).numpy(),
        np.asarray(want))
    want = jgraph.gather_nodes(jnp.asarray(a['x']),
                               jnp.asarray(a['senders']))
    np.testing.assert_array_equal(
        tgraph.gather_nodes(g.x, g.senders).numpy(), np.asarray(want))


def test_masked_softmax_matches_jax_and_zeroes_masked_rows():
    rng = np.random.RandomState(3)
    src = rng.randn(2, 6, 7).astype(np.float32) * 4
    mask = rng.rand(2, 6, 7) > 0.4
    mask[0, 2] = False       # fully masked row
    want = jax_masked_softmax(jnp.asarray(src), jnp.asarray(mask))
    got = masked_softmax(torch.from_numpy(src), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    assert (got[0, 2] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _relcnn_pair(streams):
    a = _graph_arrays(4, C=6)
    jm = JaxRelCNN(6, 8, 3, batch_norm=False, cat=True, lin=True)
    x = a['x']
    if streams > 1:
        x = np.random.RandomState(5).randn(2, 13, streams * 6).astype(
            np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(a['x']),
                     _jax_graph(a))['params']
    want = jm.apply({'params': params}, jnp.asarray(x), _jax_graph(a),
                    streams=streams)
    tm = RelCNN(6, 8, 3)
    tm.load_state_dict(relcnn_from_flax(jax.device_get(params)))
    tm.eval()
    g = tgraph.GraphBatch.from_numpy(a, 'cpu')
    with torch.no_grad():
        got = tm(torch.from_numpy(x), g, streams=streams)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize('streams', [1, 3])
def test_relcnn_forward_matches_jax(streams):
    got, want = _relcnn_pair(streams)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_streams_equal_separate_calls():
    """Channel packing is the same math as separate calls per group."""
    a = _graph_arrays(6, C=4)
    tm = RelCNN(4, 5, 2).eval()
    g = tgraph.GraphBatch.from_numpy(a, 'cpu')
    xs = [torch.randn(2, 13, 4, generator=torch.Generator().manual_seed(i))
          for i in range(3)]
    with torch.no_grad():
        packed = tm(torch.cat(xs, -1), g, streams=3).reshape(2, 13, 3, 5)
        for i, x in enumerate(xs):
            torch.testing.assert_close(packed[:, :, i], tm(x, g),
                                       rtol=0, atol=1e-6)


def test_dgmc_state_dict_conversion_covers_every_parameter():
    from dgmc_tpu.models import DGMC as JaxDGMC
    a = _graph_arrays(7, C=6)
    jm = JaxDGMC(JaxRelCNN(6, 8, 2), JaxRelCNN(4, 4, 2), num_steps=2, k=3)
    params = jm.init({'params': jax.random.key(1),
                      'noise': jax.random.key(2)},
                     _jax_graph(a), _jax_graph(a))['params']
    sd = dgmc_from_flax(jax.device_get(params))
    tm = DGMC(RelCNN(6, 8, 2), RelCNN(4, 4, 2), num_steps=2, k=3)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    tm.load_state_dict(sd)
    np.testing.assert_array_equal(
        tm.psi_1.convs[0].lin1.weight.detach().numpy(),
        np.asarray(params['psi_1']['conv_0']['lin1']['kernel']).T)


@pytest.mark.parametrize('key', ['senders', 'receivers'])
def test_graph_upload_rejects_endpoints_outside_the_graph(key):
    a = _graph_arrays(3)
    a[key] = a[key].copy()
    a[key][1, 5] = 13
    with pytest.raises(ValueError, match=key):
        tgraph.GraphBatch.from_numpy(a, 'cpu')


@pytest.mark.parametrize('gap', [None, 0, 5])
def test_graph_upload_takes_only_a_padded_tail_node_mask(gap):
    """Candidate validity and the negatives' draw take the real nodes as a
    prefix of each graph: a mask with a hole (padding before a real
    node) raises; padded tails, an empty graph and a full one pass."""
    a = _graph_arrays(4)
    mask = np.ones((2, 13), bool)
    mask[0, 9:] = False      # padded tail
    mask[1, :] = False       # an empty graph
    a['node_mask'] = mask
    if gap is not None:
        mask = mask.copy()
        mask[0, gap] = False  # padding before a real node
        a['node_mask'] = mask
        with pytest.raises(ValueError, match='node_mask'):
            tgraph.GraphBatch.from_numpy(a, 'cpu')
    else:
        g = tgraph.GraphBatch.from_numpy(a, 'cpu')
        assert torch.equal(g.node_mask, torch.from_numpy(mask))


def test_gather_gradient_is_a_sorted_segment_sum_matching_jax():
    """The gather's gradient sums each node's rows by the sorted segment
    reduction (``torch.gather``'s own backward, ``scatter_add_``, uses
    float atomics on CUDA), over every entry, padded edges included,
    whether it sorts them itself or takes the graph's cached order of
    every edge."""
    a = _graph_arrays(8, C=4)
    rng = np.random.RandomState(9)
    g = rng.randn(2, 40, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jgraph.gather_nodes(x, jnp.asarray(
        a['senders'])), jnp.asarray(a['x']))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    graph = tgraph.GraphBatch.from_numpy(a, 'cpu')
    for segs in (None, graph.csr('senders', masked=False)):
        x = graph.x.clone().requires_grad_()
        out = tgraph.gather_nodes(x, graph.senders, segs)
        assert type(out.grad_fn).__name__ == '_GatherNodesBackward'
        out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6)
