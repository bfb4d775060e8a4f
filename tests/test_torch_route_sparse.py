"""DGMC's ``route_sparse`` (the sparse consensus loop's sums routed
through dgmc_tpu_torch/ops/corr_route.py) held against the JAX package's
on the CPU, and the port's routed model against its default path.

JAX's draws are injected as in tests/test_torch_sparse_train.py: the
indicator noise captured at ψ₂'s first (channel-packed) call, the
negatives read back from JAX's ``S_0.idx[..., k:]``; ψ₁'s dropout is 0.

Tolerances, stated per check (those of tests/test_torch_sparse_train.py,
inside the 1e-4 of JAX's own ``tests/ops/test_corr_route.py:115-160``):

- the training forward against JAX's ``DGMC(route_sparse=True)``, with
  its default consensus form and with its narrow sparse-consensus kernel
  (``fused_sparse_consensus=True``, the ``use_sc and use_route`` branch):
  shortlists equal, probabilities atol 1e-5, the loss rtol 1e-5, each
  gradient within rtol 1e-4 and atol 1e-4 x its largest entry (the two
  analytically zero ones below 1e-6).
- the port's routed model against its default path, same weights and
  draws: the same tolerances; two train steps' losses within rtol 1e-4
  and their accuracies equal (JAX's on-against-off test).
- the serving call with a precomputed ``S_idx``: against JAX's routed
  model given the same ``S_idx`` and ``h_t``, atol 1e-5, indices equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import metrics as jmetrics
from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops import graph as tgraph
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import make_train_step
from dgmc_tpu_torch.utils.data import Graph, GraphPair, pad_pair_batch

B, N_S, N_T, E, C, K, R_IN = 2, 20, 26, 60, 12, 4, 8
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: small tensors, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _side(r, n, n_real):
    x = r.randn(B, n, C).astype(np.float32)
    x[:, n_real:] = 0
    mask = np.zeros((B, n), bool)
    mask[:, :n_real] = True
    return {'x': x, 'senders': r.randint(0, n_real, (B, E)).astype(np.int32),
            'receivers': r.randint(0, n_real, (B, E)).astype(np.int32),
            'node_mask': mask, 'edge_mask': r.rand(B, E) > 0.1}


def _jgraph(a):
    return JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                         edge_attr=None)


def _jax_model(fused):
    return JaxDGMC(JaxRelCNN(C, 16, 2, dropout=0.0),
                   JaxRelCNN(R_IN, R_IN, 2), num_steps=2, k=K,
                   fused_sparse_consensus=fused, route_sparse=True)


@pytest.fixture(scope='module')
def kg():
    """A padded KG pair batch (B = 2; the targets' last 3 nodes padding,
    the sources' last 2 rows padding) with partial ground truth and JAX
    parameters for it."""
    r = np.random.RandomState(0)
    s, t = _side(r, N_S, N_S - 2), _side(r, N_T, N_T - 3)
    y = np.stack([r.permutation(N_T - 3)[:N_S] for _ in range(B)])
    y_mask = (r.rand(B, N_S) > 0.3) & s['node_mask']
    y = np.where(y_mask, y, -1).astype(np.int32)
    params = jax.device_get(jax.jit(lambda g_s, g_t: _jax_model(None).init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        g_s, g_t))(_jgraph(s), _jgraph(t))['params'])
    return {'s': s, 't': t, 'y': y, 'y_mask': y_mask, 'params': params}


_JAX_RUNS = {}


def _jax_run(kg, fused):
    if fused not in _JAX_RUNS:
        jm = _jax_model(fused)
        g_s, g_t = _jgraph(kg['s']), _jgraph(kg['t'])
        y, y_mask = jnp.asarray(kg['y']), jnp.asarray(kg['y_mask'])
        rngs = {'noise': jax.random.key(3), 'negatives': jax.random.key(4),
                'dropout': jax.random.key(5)}

        def forward(params):
            seen = []

            def capture(next_fun, args, kwargs, context):
                if (context.module.name == 'psi_2'
                        and context.method_name == '__call__' and not seen):
                    seen.append(args[0])
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(capture):
                S_0, S_L = jm.apply({'params': params}, g_s, g_t, y=y,
                                    y_mask=y_mask, train=True, rngs=rngs)
            loss = jmetrics.nll_loss(S_L, y, y_mask)
            return loss, (S_0.val, S_0.idx, S_L.val, seen[0])

        (loss, (v0, idx, vL, packed)), grads = jax.jit(
            jax.value_and_grad(forward, has_aux=True))(kg['params'])
        r_s = np.array(packed).reshape(B, N_S, 2, R_IN).transpose(2, 0, 1, 3)
        _JAX_RUNS[fused] = {
            'loss': float(loss), 'v0': np.array(v0), 'idx': np.array(idx),
            'vL': np.array(vL), 'r_s': np.ascontiguousarray(r_s),
            'grads': dgmc_from_flax(jax.device_get(grads))}
    return _JAX_RUNS[fused]


def _port_run(kg, want, route_sparse):
    tm = DGMC(RelCNN(C, 16, 2), RelCNN(R_IN, R_IN, 2), num_steps=2, k=K,
              route_sparse=route_sparse)
    tm.load_state_dict(dgmc_from_flax(kg['params']))
    tm.train()
    g_s = tgraph.GraphBatch.from_numpy(kg['s'], 'cpu')
    g_t = tgraph.GraphBatch.from_numpy(kg['t'], 'cpu')
    y = torch.from_numpy(kg['y']).long()
    y_mask = torch.from_numpy(kg['y_mask'])
    S_0, S_L = tm(g_s, g_t, y=y, y_mask=y_mask,
                  r_s=torch.from_numpy(want['r_s']),
                  negatives=torch.from_numpy(want['idx'][..., K:]).long())
    loss = metrics.nll_loss(S_L, y, y_mask)
    loss.backward()
    return tm, S_0, S_L, loss


def _hold(got, want):
    """``got`` = (model, S_0, S_L, loss) against JAX's run (or another
    port run in the same form) at the tolerances stated above."""
    tm, S_0, S_L, loss = got
    np.testing.assert_array_equal(S_0.idx.numpy(), want['idx'])
    np.testing.assert_array_equal(S_L.idx.numpy(), want['idx'])
    np.testing.assert_allclose(S_0.val.detach().numpy(), want['v0'],
                               atol=1e-5)
    np.testing.assert_allclose(S_L.val.detach().numpy(), want['vL'],
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), want['loss'], rtol=1e-5)
    params = dict(tm.named_parameters())
    assert set(params) == set(want['grads'])
    for name, w in want['grads'].items():
        w = np.asarray(w)
        g = params[name].grad.numpy()
        if name in ZERO_GRAD:
            assert np.abs(g).max() < 1e-6 and np.abs(w).max() < 1e-6, name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize('fused', [None, True], ids=['jnp', 'narrow'])
def test_routed_training_forward_and_gradients_match_jax(kg, fused):
    want = _jax_run(kg, fused)
    assert want['idx'].shape == (B, N_S, 2 * K)
    dispatch.reset()
    got = _port_run(kg, want, True)
    _hold(got, want)
    d = dispatch.decisions()
    for name in ('corr_project', 'corr_gather_bwd', 'sparse_consensus_fwd',
                 'sparse_consensus_bwd'):
        assert d[name]['path'] == 'plain', name
    # Per forward: one projection a step; the gather's backward for h_t's
    # candidates and each step's o_t.
    assert d['corr_project']['counts']['plain'] == 2
    assert d['corr_gather_bwd']['counts']['plain'] == 3


def test_routed_model_matches_the_default_path(kg):
    want = _jax_run(kg, None)
    tm, S_0, S_L, loss = _port_run(kg, want, False)
    base = {'idx': S_0.idx.numpy(), 'v0': S_0.val.detach().numpy(),
            'vL': S_L.val.detach().numpy(), 'loss': loss.item(),
            'grads': {k: p.grad.clone() for k, p in tm.named_parameters()}}
    dispatch.reset()
    _hold(_port_run(kg, want, True), base)
    assert 'corr_project' in dispatch.decisions()


def _steps_pair(seed, n=24, e=60, c=8):
    r = np.random.RandomState(seed)

    def g():
        return Graph(edge_index=r.randint(0, n, (2, e)),
                     x=r.randn(n, c).astype(np.float32))

    return GraphPair(s=g(), t=g(), y_col=r.permutation(n).astype(np.int64))


def test_train_steps_route_on_against_off():
    """JAX's ``test_dgmc_route_forced_on_matches_off``: two train steps of
    the same model, routed and not, from one state and seeds."""
    batch = pad_pair_batch([_steps_pair(0)], 24, 60)
    base = DGMC(RelCNN(8, 12, 1), RelCNN(8, 8, 1), num_steps=2, k=4,
                generator=torch.Generator().manual_seed(0))
    outs = []
    for forced in (True, False):
        m = copy.deepcopy(base)
        m.route_sparse = forced
        step = make_train_step(m)
        state = create_train_state(m, 1e-2)
        for seed in (1, 2):
            state, out = step(state, batch, seed)
        outs.append((out['loss'].item(), out['acc'].item()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4,
                               atol=1e-4)
    assert outs[0][1] == outs[1][1]


def test_routed_serving_with_a_precomputed_shortlist_matches_jax(kg):
    """Evaluation with ``h_t`` and ``S_idx`` given (the serving offload
    tier's call): the route is built from the given shortlist."""
    jm = _jax_model(None)
    g_s, g_t = _jgraph(kg['s']), _jgraph(kg['t'])
    r = np.random.RandomState(3)
    h_t = r.randn(B, N_T, 16).astype(np.float32)
    S_idx = r.randint(0, N_T - 3, (B, N_S, K)).astype(np.int32)

    def forward(params, h_t, S_idx):
        seen = []

        def capture(next_fun, args, kwargs, context):
            if (context.module.name == 'psi_2'
                    and context.method_name == '__call__' and not seen):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(capture):
            S_0, S_L = jm.apply({'params': params}, g_s, g_t, h_t=h_t,
                                S_idx=S_idx,
                                rngs={'noise': jax.random.key(9)})
        return S_0, S_L, seen[0]

    S_0, S_L, packed = jax.jit(forward)(kg['params'], jnp.asarray(h_t),
                                        jnp.asarray(S_idx))
    r_s = np.array(packed).reshape(B, N_S, 2, R_IN).transpose(2, 0, 1, 3)
    tm = DGMC(RelCNN(C, 16, 2), RelCNN(R_IN, R_IN, 2), num_steps=2, k=K,
              route_sparse=True)
    tm.load_state_dict(dgmc_from_flax(kg['params']))
    with torch.no_grad():
        T0, TL = tm.eval()(
            tgraph.GraphBatch.from_numpy(kg['s'], 'cpu'),
            tgraph.GraphBatch.from_numpy(kg['t'], 'cpu'),
            h_t=torch.from_numpy(h_t), S_idx=torch.from_numpy(S_idx),
            r_s=torch.from_numpy(np.ascontiguousarray(r_s)))
    for got, want in ((T0, S_0), (TL, S_L)):
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                                   atol=1e-5)
