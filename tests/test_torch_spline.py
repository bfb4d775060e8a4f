"""The port's SplineConv pieces held against the JAX package on the CPU:
the open B-spline basis, the plain route_aggregate (forward, d_t, d_basis)
against the Pallas kernel run in interpret mode, and SplineCNN with flax
weights carried across by dgmc_tpu_torch.convert.

Tolerances: the basis is the same elementwise float32 arithmetic, so it
must be equal. Routing sums the same float32 products in another order
(receiver- or row-sorted segment sums against the kernel's one-hot
matmuls), so forward and gradients agree to atol 1e-5 on O(1) values.
SplineCNN chains float32 matrix products through two layers; atol 1e-5
on O(1) activations is a few hundred ulps and fails on any wrong weight,
layout or mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.models.spline import SplineCNN as JaxSplineCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu.ops.pallas.spline import route_aggregate as jax_route
from dgmc_tpu.ops.spline import open_spline_basis as jax_basis
from dgmc_tpu_torch.convert import splinecnn_from_flax
from dgmc_tpu_torch.models.spline import SplineCNN, SplineConv
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.spline import (Routing,
                                               plain_route_aggregate,
                                               plain_route_d_t,
                                               route_aggregate)
from dgmc_tpu_torch.ops.spline import open_spline_basis


def _problem(B=3, N=24, E=80, C=8, O=16, seed=0, mask_frac=0.2):
    """The JAX kernel tests' problem (``tests/ops/test_pallas_spline.py``)
    as numpy arrays: t, flat, basis, receivers, edge_mask."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    senders = rng.randint(0, N, (B, E)).astype(np.int32)
    receivers = rng.randint(0, N, (B, E)).astype(np.int32)
    emask = rng.rand(B, E) > mask_frac
    attr = rng.rand(B, E, 2).astype(np.float32)
    W = (rng.randn(25, C, O) * 0.1).astype(np.float32)
    t = (x @ W.transpose(1, 0, 2).reshape(C, 25 * O)).reshape(B, N * 25, O)
    basis, combo = jax_basis(jnp.asarray(attr), 5, 1)
    flat = np.asarray(senders[..., None] * 25 + np.asarray(combo))
    return (t.astype(np.float32), flat, np.array(basis), receivers, emask,
            N)


def _torch_args(t, flat, basis, rcv, em, N):
    routing = Routing(torch.from_numpy(flat), torch.from_numpy(rcv),
                      torch.from_numpy(em), N, t.shape[1])
    return torch.from_numpy(t), torch.from_numpy(basis), routing


@pytest.mark.parametrize('shape', [(5, 2), (3, 7, 3), (40, 1)])
def test_open_spline_basis_equals_jax(shape):
    rng = np.random.RandomState(len(shape))
    # Values outside [0, 1] and on the knots exercise the clamps.
    pseudo = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    pseudo.reshape(-1)[:3] = [0.0, 0.25, 1.0]
    want_b, want_i = jax_basis(jnp.asarray(pseudo), 5, 1)
    got_b, got_i = open_spline_basis(torch.from_numpy(pseudo), 5, 1)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# (seed, N, E, mask_frac): the JAX tests' forward, masked and M-padding
# cases (tests/ops/test_pallas_spline.py:41-78; 11 * 25 rows is no
# multiple of the kernel's 256-row M tile).
CASES = {'forward': (0, 24, 80, 0.2), 'all_masked': (2, 24, 80, 1.01),
         'm_padding': (3, 11, 40, 0.2)}


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_route_aggregate_matches_jax_kernel(name):
    seed, N, E, mask_frac = CASES[name]
    args = _problem(N=N, E=E, seed=seed, mask_frac=mask_frac)
    t, flat, basis, rcv, em, _ = args
    want = jax_route(*map(jnp.asarray, (t, flat, basis, rcv, em)), N, True)
    t_, basis_, routing = _torch_args(*args)
    got = plain_route_aggregate(t_, basis_, routing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if name == 'all_masked':
        assert (got == 0).all()


@pytest.mark.parametrize('name', sorted(CASES))
def test_route_gradients_match_jax_kernel(name):
    """d_t and d_basis of sum(out ** 2): the JAX kernel's custom VJP
    against the port's explicit plain d_t, autograd through the plain
    forward, and the port's autograd.Function (plain versions inside on
    the CPU)."""
    seed, N, E, mask_frac = CASES[name]
    args = _problem(N=N, E=E, seed=seed + 1, mask_frac=mask_frac)
    t, flat, basis, rcv, em, _ = args
    j = dict(zip(('flat', 'rcv', 'em'), map(jnp.asarray, (flat, rcv, em))))

    def loss(t, basis):
        out = jax_route(t, j['flat'], basis, j['rcv'], j['em'], N, True)
        return (out ** 2).sum()

    want_t, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(t),
                                                    jnp.asarray(basis))
    want_out = jax_route(*map(jnp.asarray, (t, flat, basis, rcv, em)), N,
                         True)
    t_, basis_, routing = _torch_args(*args)
    g = torch.from_numpy(2 * np.asarray(want_out))
    np.testing.assert_allclose(plain_route_d_t(g, basis_, routing).numpy(),
                               np.asarray(want_t), atol=1e-5)
    for fn in (plain_route_aggregate, route_aggregate):
        tt = t_.clone().requires_grad_(True)
        bb = basis_.clone().requires_grad_(True)
        (fn(tt, bb, routing) ** 2).sum().backward()
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_t),
                                   atol=1e-5)
        np.testing.assert_allclose(bb.grad.numpy(), np.asarray(want_b),
                                   atol=1e-5)


def test_route_aggregate_without_edges_gives_zeros():
    t = torch.randn(2, 6 * 25, 4)
    routing = Routing(torch.zeros(2, 0, 4, dtype=torch.int64),
                      torch.zeros(2, 0, dtype=torch.int64),
                      torch.zeros(2, 0, dtype=torch.bool), 6, 6 * 25)
    basis = torch.zeros(2, 0, 4)
    tt = t.clone().requires_grad_(True)
    out = route_aggregate(tt, basis, routing)
    assert out.shape == (2, 6, 4) and (out == 0).all()
    out.sum().backward()
    assert (tt.grad == 0).all()


def _spline_graph(seed, B=2, N=16, E=48):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(B, N, 3).astype(np.float32),
            'senders': rng.randint(0, N, (B, E)).astype(np.int32),
            'receivers': rng.randint(0, N, (B, E)).astype(np.int32),
            'node_mask': np.ones((B, N), bool),
            'edge_mask': rng.rand(B, E) > 0.2,
            'edge_attr': rng.rand(B, E, 2).astype(np.float32)}


@pytest.mark.parametrize('cat,lin', [(False, True), (True, True),
                                     (True, False)])
def test_splinecnn_forward_matches_jax(cat, lin):
    a = _spline_graph(4)
    jm = JaxSplineCNN(3, 8, 2, 2, cat=cat, lin=lin)
    jg = JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()})
    params = jm.init(jax.random.key(0), jg.x, jg)['params']
    want = jm.apply({'params': params}, jg.x, jg)
    tm = SplineCNN(3, 8, 2, 2, cat=cat, lin=lin)
    tm.load_state_dict(splinecnn_from_flax(jax.device_get(params)))
    g = GraphBatch.from_numpy(a, 'cpu')
    got = tm(g.x, g)
    assert tm.out_channels == jm.out_channels
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_splineconv_routes_through_wrapper_and_matches_plain():
    """SplineConv reaches the routing wrapper (its plain version on the
    CPU, recorded once) and equals the node GEMM, the plain routing, the
    root map and the bias composed by hand."""
    a = _spline_graph(5)
    g = GraphBatch.from_numpy(a, 'cpu')
    conv = SplineConv(3, 8, 2)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    dispatch.reset()
    got = conv(g.x, g)
    assert dispatch.decisions()['spline_route_fwd'] == {
        'path': 'plain', 'reason': 'device=cpu', 'dtype': 'float32',
        'counts': {'kernel': 0, 'plain': 1},
        'dtypes': {'plain:float32': 1}}
    B, N, _ = g.x.shape
    basis, combo = open_spline_basis(g.edge_attr, 5, 1)
    routing = Routing(g.senders[..., None] * 25 + combo, g.receivers,
                      g.edge_mask, N, N * 25)
    t = torch.einsum('bnc,kco->bnko', g.x, conv.weight).reshape(B, N * 25,
                                                                 8)
    want = (plain_route_aggregate(t, basis, routing) + g.x @ conv.root.weight.T
            + conv.bias)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)


def _receiver_degree(routing):
    """``max(deg, 1)`` per receiver node, as the ``d_t`` kernel reads it
    from the receiver CSR offsets."""
    _, offsets = routing.receiver_csr()
    B, N = routing.flat.shape[0], routing.num_nodes
    return (offsets[1:] - offsets[:-1])[:B * N].float().clamp(min=1)


def _records_d_t(g, routing, basis):
    """``d_t`` in plain PyTorch from what the ``d_t`` kernel reads: the
    slot records and the receivers' degrees; each row sums ``w *
    (g / deg)[node]`` over its records."""
    records, offsets = routing.slot_records(basis)
    B, N, O = g.shape
    M = routing.num_rows
    n = int(offsets[-1])
    node = records[:n, 0].long()
    w = records[:n, 1].view(torch.float32)
    g_norm = g.reshape(B * N, O) / _receiver_degree(routing)[:, None]
    contrib = w[:, None] * g_norm[node]
    rows = torch.repeat_interleave(torch.arange(B * M),
                                   (offsets[1:] - offsets[:-1]).long())
    return torch.zeros(B * M, O).index_add_(0, rows, contrib).reshape(
        B, M, O)


@pytest.mark.parametrize('name', sorted(CASES))
def test_slot_records_match_their_definition(name):
    seed, N, E, mask_frac = CASES[name]
    t_, basis_, routing = _torch_args(*_problem(N=N, E=E, seed=seed,
                                                mask_frac=mask_frac))
    records, offsets = routing.slot_records(basis_)
    order, slot_offsets = routing.slot_csr()
    B, E, A = routing.flat.shape
    assert records.dtype == offsets.dtype == torch.int32
    assert records.shape == (B * E * A, 2)
    assert torch.equal(offsets.long(), slot_offsets)
    edge = order // A
    b = edge // E
    rcv = routing.receivers.reshape(-1)[edge]
    assert torch.equal(records[:, 0].long(), b * N + rcv)
    assert torch.equal(records[:, 1].view(torch.float32),
                       basis_.reshape(-1)[order])
    deg = torch.zeros(B, N)
    for bb in range(B):
        for e in range(E):
            if routing.edge_mask[bb, e]:
                deg[bb, routing.receivers[bb, e]] += 1
    assert torch.equal(_receiver_degree(routing),
                       deg.clamp(min=1).reshape(-1))
    # Every slot of a row points at it; masked slots lie past the end.
    n = int(offsets[-1])
    assert n == int(routing.edge_mask.sum()) * A
    rows = torch.repeat_interleave(torch.arange(B * routing.num_rows),
                                   (offsets[1:] - offsets[:-1]).long())
    flat = routing.flat.reshape(-1)[order[:n]]
    assert torch.equal(rows, b[:n] * routing.num_rows + flat)


@pytest.mark.parametrize('name', sorted(CASES))
def test_d_t_from_slot_records_matches_jax_kernel(name):
    """The records carry everything d_t needs: summed per row in plain
    PyTorch they give the JAX kernel's gradient w.r.t. t (the cases and
    tolerance of test_route_gradients_match_jax_kernel)."""
    seed, N, E, mask_frac = CASES[name]
    args = _problem(N=N, E=E, seed=seed + 1, mask_frac=mask_frac)
    t, flat, basis, rcv, em, _ = args
    j = dict(zip(('flat', 'rcv', 'em'), map(jnp.asarray, (flat, rcv, em))))

    def loss(t):
        out = jax_route(t, j['flat'], jnp.asarray(basis), j['rcv'], j['em'],
                        N, True)
        return (out ** 2).sum()

    want = jax.grad(loss)(jnp.asarray(t))
    out = jax_route(*map(jnp.asarray, (t, flat, basis, rcv, em)), N, True)
    _, basis_, routing = _torch_args(*args)
    g = torch.from_numpy(2 * np.asarray(out))
    got = _records_d_t(g, routing, basis_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), plain_route_d_t(
        g, basis_, routing).numpy())


def test_slot_records_are_cached_per_basis():
    _, basis_, routing = _torch_args(*_problem(N=11, E=40, seed=3))
    records, offsets = routing.slot_records(basis_)
    again = routing.slot_records(basis_)
    assert again[0] is records and again[1] is offsets
    other = basis_.clone() * 2
    doubled, _ = routing.slot_records(other)
    assert torch.equal(doubled[:, 1].view(torch.float32),
                       2 * records[:, 1].view(torch.float32))
    basis_.mul_(3)                      # in place: a new version
    tripled, _ = routing.slot_records(basis_)
    assert torch.equal(tripled[:, 1].view(torch.float32),
                       3 * records[:, 1].view(torch.float32))


@pytest.mark.parametrize('name', sorted(CASES))
def test_edge_records_match_their_definition(name):
    """The forward kernel's records: edges in the receiver order, each
    edge's A slots in order, (row of t in the flattened batch, basis
    weight bits); offsets A times the receiver CSR's, int32."""
    seed, N, E, mask_frac = CASES[name]
    _, basis_, routing = _torch_args(*_problem(N=N, E=E, seed=seed,
                                               mask_frac=mask_frac))
    records, offsets = routing.edge_records(basis_)
    order, edge_offsets = routing.receiver_csr()
    B, E, A = routing.flat.shape
    M = routing.num_rows
    assert records.dtype == offsets.dtype == torch.int32
    assert records.shape == (B * E * A, 2)
    assert torch.equal(offsets.long(), A * edge_offsets)
    want_row = (order // E)[:, None] * M + routing.flat.reshape(B * E,
                                                               A)[order]
    assert torch.equal(records[:, 0].long(), want_row.reshape(-1))
    assert torch.equal(records[:, 1].view(torch.float32),
                       basis_.reshape(B * E, A)[order].reshape(-1))
    # Every slot of a receiver row comes from one of its real edges.
    n = int(offsets[B * N])
    assert n == int(routing.edge_mask.sum()) * A
    rows = torch.repeat_interleave(torch.arange(B * N),
                                   (offsets[1:B * N + 1]
                                    - offsets[:B * N]).long())
    edge = order[torch.arange(n) // A]
    assert torch.equal(rows, (edge // E) * N
                       + routing.receivers.reshape(-1)[edge])


def _records_route(t, routing, basis):
    """The forward in plain PyTorch from what its kernel reads: the edge
    records and slot offsets; each row sums its edges' blended rows in
    order, then divides by max(deg, 1)."""
    records, offsets = routing.edge_records(basis)
    B, M, O = t.shape
    N, A = routing.num_nodes, routing.flat.shape[2]
    out = torch.zeros(B * N, O)
    flat_t = t.reshape(B * M, O)
    for r in range(B * N):
        beg, end = int(offsets[r]), int(offsets[r + 1])
        rec = records[beg:end]
        w = rec[:, 1].view(torch.float32)[:, None]
        msgs = (w * flat_t[rec[:, 0].long()]).reshape(-1, A, O).sum(1)
        out[r] = msgs.sum(0) / max((end - beg) // A, 1)
    return out.reshape(B, N, O)


@pytest.mark.parametrize('name', sorted(CASES))
def test_route_from_edge_records_matches_jax_kernel(name):
    """The records carry everything the forward needs: summed per row in
    plain PyTorch they give the JAX kernel's output (the cases and
    tolerance of test_plain_route_aggregate_matches_jax_kernel)."""
    seed, N, E, mask_frac = CASES[name]
    args = _problem(N=N, E=E, seed=seed, mask_frac=mask_frac)
    t, flat, basis, rcv, em, _ = args
    want = jax_route(*map(jnp.asarray, (t, flat, basis, rcv, em)), N, True)
    t_, basis_, routing = _torch_args(*args)
    got = _records_route(t_, routing, basis_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_edge_records_are_cached_per_basis_and_plain_on_cpu():
    """Edge and slot records come from one build, cached per basis
    version; on the CPU it is the plain version, recorded as such."""
    _, basis_, routing = _torch_args(*_problem(N=11, E=40, seed=4))
    from dgmc_tpu_torch.ops.kernels.spline import build_records
    dispatch.reset()
    records, offsets = routing.edge_records(basis_)
    slots = routing.slot_records(basis_)
    assert routing.edge_records(basis_)[0] is records
    d = dispatch.decisions()['spline_records']
    assert (d['path'], d['reason'], d['counts']['plain']) == (
        'plain', 'device=cpu', 1)
    assert build_records.launches == 0
    assert all(map(torch.equal, build_records(routing, basis_),
                   (records, offsets, *slots)))
    basis_.mul_(2)                      # in place: a new version
    doubled, again = routing.edge_records(basis_)
    assert torch.equal(doubled[:, 1].view(torch.float32),
                       2 * records[:, 1].view(torch.float32))
    assert torch.equal(again, offsets)


def _dense_batch_and_model():
    """A small dense PascalPF batch (4 pairs at 24 nodes / 192 edges) and
    a dense DGMC over SplineCNN ψ₁ and ψ₂ at narrow widths, 3 steps."""
    from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
    from dgmc_tpu_torch.data.transforms import (Cartesian, Compose,
                                                Constant, KNNGraph)
    from dgmc_tpu_torch.models.dgmc import DGMC
    from dgmc_tpu_torch.utils.data import pad_pair_batch
    ds = RandomGraphPairs(8, 12, 0, 4, length=4, seed=2,
                          transform=Compose([Constant(), KNNGraph(k=8),
                                             Cartesian()]))
    batch = pad_pair_batch([ds[i] for i in range(4)], 24, 192)
    model = DGMC(SplineCNN(1, 8, 2, 2, cat=False),
                 SplineCNN(4, 4, 2, 2, cat=True), num_steps=3, k=-1,
                 generator=torch.Generator().manual_seed(1))
    return batch, model


def _forward_and_grads(batch, model):
    from dgmc_tpu_torch.train.steps import batch_to_device
    g_s, g_t, y, y_mask = batch_to_device(batch, 'cpu')
    model.zero_grad()
    S_0, S_L = model(g_s, g_t, noise_seed=5)
    (S_L.val.square().sum() + S_0.val.square().sum()).backward()
    return (S_0.val, S_L.val,
            {n: p.grad.clone() for n, p in model.named_parameters()})


def test_dense_forward_builds_each_graphs_routing_once(monkeypatch):
    """A dense DGMC forward and backward builds SplineCNN's routing once
    per graph batch: twice (source, target), not once per SplineCNN call
    (2 + 2 x 3 calls here; counted at the ``Routing`` constructor), and
    computes bit for bit what the uncached forward computes. On the card
    the routing's records are built as often (``chip_smoke.py``: 2
    launches a dense step)."""
    from dgmc_tpu_torch.models import spline as spline_model
    built = []

    class Counted(Routing):
        def __init__(self, *args):
            built.append(1)
            super().__init__(*args)

    monkeypatch.setattr(spline_model, 'Routing', Counted)
    batch, model = _dense_batch_and_model()
    dispatch.reset()
    S_0, S_L, grads = _forward_and_grads(batch, model)
    assert len(built) == 2
    assert dispatch.decisions()['spline_route_fwd']['counts']['plain'] == 16

    memo = GraphBatch.memo
    monkeypatch.setattr(GraphBatch, 'memo', lambda self, key, build: (
        build() if key[0] == 'spline_routing' else memo(self, key, build)))
    built.clear()
    U_0, U_L, u_grads = _forward_and_grads(batch, model)
    assert len(built) == 8
    assert torch.equal(S_0, U_0) and torch.equal(S_L, U_L)
    for name, g in grads.items():
        assert torch.equal(g, u_grads[name]), name


def test_routing_with_a_gradient_on_the_edge_attributes_is_not_cached():
    batch, _ = _dense_batch_and_model()
    graph = GraphBatch.from_numpy(batch.s, 'cpu')
    from dgmc_tpu_torch.models.spline import spline_routing
    assert spline_routing(graph, 5) is spline_routing(graph, 5)
    assert spline_routing(graph, 5) is not spline_routing(graph, 3)
    graph.edge_attr.requires_grad_(True)
    basis, _ = spline_routing(graph, 4)
    assert basis.requires_grad
    assert spline_routing(graph, 4) is not spline_routing(graph, 4)
