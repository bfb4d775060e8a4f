"""The port's sparse training slice held against the JAX package on the
CPU: the sparse DGMC forward in training mode (shortlist with random
negatives and the injected ground truth, ``S_0`` / ``S_L``, loss and every
gradient) against ``dgmc_tpu.models.DGMC(train=True)`` with and without
its fused sparse-consensus kernel, the repairs to ``to_dense`` and the
gather gradients, ``include_gt``, RelCNN's training dropout, the ports of
the JAX package's behaviour tests (detach, GT and negative injection,
``--pairs-per-step``, the sparse golden values, the two-phase quality
floors) and a tiny run of the port's ``dbp15k`` CLI.

JAX's random draws are injected: the indicator noise captured with
``flax.linen.intercept_methods`` on ψ₂'s first (channel-packed) call, the
negatives read back from JAX's ``S_0.idx[..., k:]`` (where JAX overwrote
the last slot with the ground truth, feeding that slot back yields the
same shortlist and the same entry mask). ψ₁'s dropout is 0 there.

Tolerances: shortlists must be equal. Probabilities after two consensus
steps of float32 products summed in other orders (the port's delta
gradient takes the factored form): atol 1e-5; the loss rtol 1e-5; each
gradient within rtol 1e-4 and atol 1e-4 x its largest entry, the two that
are zero analytically (``ZERO_GRAD``) below 1e-6 in both packages.
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
from dgmc_tpu.models.dgmc import Correspondence as JaxCorrespondence
from dgmc_tpu.models.dgmc import include_gt as jax_include_gt
from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.models import dgmc as dgmc_module
from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.models.dgmc import DGMC, Correspondence, include_gt
from dgmc_tpu_torch.models.rel import RelCNN, dropout
from dgmc_tpu_torch.ops import graph as tgraph
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels import sparse_consensus
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import (batch_to_device, loss_and_outputs,
                                        make_eval_step, make_train_step)
from dgmc_tpu_torch.utils.data import (Graph, GraphPair, PairBatch,
                                       pad_pair_batch)

B, N_S, N_T, E, C, K, R_IN = 2, 20, 26, 60, 12, 4, 8
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tensors here are small, and the suite's
    parallel workers would otherwise oversubscribe the cores (a training
    loop here ran ~40x slower with 8 threads per worker under load)."""
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


@pytest.fixture(scope='module')
def kg():
    """A padded KG pair batch (B = 2; the targets' last 3 nodes padding)
    with partial ground truth, JAX parameters for it, and the port's
    converted model."""
    r = np.random.RandomState(0)
    s, t = _side(r, N_S, N_S), _side(r, N_T, N_T - 3)
    y = np.stack([r.permutation(N_T - 3)[:N_S] for _ in range(B)])
    y_mask = r.rand(B, N_S) > 0.3
    y = np.where(y_mask, y, -1).astype(np.int32)
    jm = _jax_model(False)
    params = jax.device_get(jax.jit(lambda g_s, g_t: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        g_s, g_t))(_jgraph(s), _jgraph(t))['params'])
    return {'s': s, 't': t, 'y': y, 'y_mask': y_mask, 'params': params}


def _jax_model(fused):
    return JaxDGMC(JaxRelCNN(C, 16, 2, dropout=0.0),
                   JaxRelCNN(R_IN, R_IN, 2), num_steps=2, k=K,
                   fused_sparse_consensus=fused)


def _port_model(params):
    tm = DGMC(RelCNN(C, 16, 2), RelCNN(R_IN, R_IN, 2), num_steps=2, k=K)
    tm.load_state_dict(dgmc_from_flax(params))
    return tm.train()


_JAX_RUNS = {}


def _jax_run(kg, num_steps, detach, fused):
    """JAX's training forward (S_0, S_L, captured noise) and its loss and
    gradients, under one set of keys (computed once per case)."""
    key = (num_steps, detach, fused)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run_uncached(kg, num_steps, detach, fused)
    return _JAX_RUNS[key]


def _jax_run_uncached(kg, num_steps, detach, fused):
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
                                y_mask=y_mask, train=True,
                                num_steps=num_steps, detach=detach,
                                rngs=rngs)
        loss = jmetrics.nll_loss(S_L, y, y_mask)
        return loss, (S_0.val, S_0.idx, S_L.val, seen[0] if seen else None)

    (loss, (v0, idx, vL, packed)), grads = jax.jit(
        jax.value_and_grad(forward, has_aux=True))(kg['params'])
    r_s = None
    if packed is not None:   # [B, N_s, T * R_in], steps packed channel-wise
        r_s = np.array(packed).reshape(B, N_S, num_steps, R_IN).transpose(
            2, 0, 1, 3)
    return {'loss': float(loss), 'v0': np.array(v0), 'idx': np.array(idx),
            'vL': np.array(vL), 'r_s': r_s,
            'grads': dgmc_from_flax(jax.device_get(grads))}


def _port_run(kg, num_steps, detach, jax_out):
    tm = _port_model(kg['params'])
    g_s = tgraph.GraphBatch.from_numpy(kg['s'], 'cpu')
    g_t = tgraph.GraphBatch.from_numpy(kg['t'], 'cpu')
    y = torch.from_numpy(kg['y']).long()
    y_mask = torch.from_numpy(kg['y_mask'])
    r_s = None if jax_out['r_s'] is None else torch.from_numpy(
        jax_out['r_s'])
    neg = torch.from_numpy(jax_out['idx'][..., K:]).long()
    S_0, S_L = tm(g_s, g_t, y=y, y_mask=y_mask, num_steps=num_steps,
                  detach=detach, r_s=r_s, negatives=neg)
    loss = metrics.nll_loss(S_L, y, y_mask)
    loss.backward()
    return tm, S_0, S_L, loss


# (num_steps, detach, JAX with its fused sparse-consensus kernel); the
# fused kernel runs only in consensus steps.
MODEL_CASES = [(0, False, False), (2, False, True), (2, True, True),
               (2, False, False)]


@pytest.mark.parametrize('case', MODEL_CASES,
                         ids=[f'steps{s}-detach{d}-{"fused" if f else "jnp"}'
                              for s, d, f in MODEL_CASES])
def test_sparse_training_forward_and_gradients_match_jax(kg, case):
    num_steps, detach, fused = case
    want = _jax_run(kg, num_steps, detach, fused)
    assert want['idx'].shape == (B, N_S, 2 * K)
    tm, S_0, S_L, loss = _port_run(kg, num_steps, detach, want)
    np.testing.assert_array_equal(S_0.idx.numpy(), want['idx'])
    np.testing.assert_array_equal(S_L.idx.numpy(), want['idx'])
    np.testing.assert_allclose(S_0.val.detach().numpy(), want['v0'],
                               atol=1e-5)
    np.testing.assert_allclose(S_L.val.detach().numpy(), want['vL'],
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), want['loss'], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want['grads'])
    for name, w in want['grads'].items():
        w = w.numpy()
        p = got[name]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        if detach and name.startswith('psi_1.'):
            assert p.grad is None and not w.any(), name
            continue
        if name in ZERO_GRAD:
            assert np.abs(g).max() < 1e-6 and np.abs(w).max() < 1e-6, name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_sparse_forward_above_r_max_takes_the_recorded_plain_form(
        kg, monkeypatch):
    want = _jax_run(kg, 2, False, False)
    monkeypatch.setattr(sparse_consensus, 'R_MAX', R_IN // 2)
    dispatch.reset()
    _, _, S_L, _ = _port_run(kg, 2, False, want)
    d = dispatch.decisions()['sparse_consensus_fwd']
    assert (d['path'], d['reason']) == ('plain', f'R>{R_IN // 2}')
    assert 'sparse_consensus_bwd' not in dispatch.decisions()
    np.testing.assert_allclose(S_L.val.detach().numpy(), want['vL'],
                               atol=1e-5)


def test_to_dense_sums_duplicate_candidates_like_jax():
    r = np.random.RandomState(1)
    val = r.rand(2, 5, 6).astype(np.float32)
    idx = r.randint(0, 4, (2, 5, 6))
    idx[0, 0] = 2                     # one row: every slot the same column
    s_mask, t_mask = np.ones((2, 5), bool), np.ones((2, 9), bool)
    want = JaxCorrespondence(jnp.asarray(val), jnp.asarray(idx),
                             jnp.asarray(s_mask),
                             jnp.asarray(t_mask)).to_dense()
    got = Correspondence(torch.from_numpy(val), torch.from_numpy(idx),
                         torch.from_numpy(s_mask),
                         torch.from_numpy(t_mask)).to_dense()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_include_gt_matches_jax():
    """The JAX package's hand case (``test_dgmc.py:150``), then a random
    one with ``return_replaced``."""
    S_idx = np.array([[[0, 1], [1, 2]], [[1, 2], [0, 1]]])
    y = np.array([[1, 0], [0, 0]])
    y_mask = np.array([[True, False], [True, True]])
    out = include_gt(torch.from_numpy(S_idx), torch.from_numpy(y),
                     torch.from_numpy(y_mask))
    assert out.tolist() == [[[0, 1], [1, 2]], [[1, 0], [0, 1]]]
    r = np.random.RandomState(2)
    S_idx, y = r.randint(0, 6, (3, 8, 4)), r.randint(0, 6, (3, 8))
    y_mask = r.rand(3, 8) > 0.3
    w_out, w_rep = jax_include_gt(jnp.asarray(S_idx), jnp.asarray(y),
                                  jnp.asarray(y_mask), return_replaced=True)
    out, rep = include_gt(torch.from_numpy(S_idx), torch.from_numpy(y),
                          torch.from_numpy(y_mask), return_replaced=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(rep.numpy(), np.asarray(w_rep))


def _path_pair(n=4, c=32, B_=1, seed=0):
    """The JAX tests' directed path graph (``tests/helpers.py``)."""
    r = np.random.RandomState(seed)
    a = {'x': r.randn(B_, n, c).astype(np.float32),
         'senders': np.tile(np.arange(n - 1), (B_, 1)),
         'receivers': np.tile(np.arange(1, n), (B_, 1)),
         'node_mask': np.ones((B_, n), bool),
         'edge_mask': np.ones((B_, n - 1), bool)}
    return tgraph.GraphBatch.from_numpy(a, 'cpu')


def test_detach_cuts_psi1_gradients_and_keeps_its_dropout():
    """``test_dgmc.py:124`` for the sparse variant; ψ₁ stays in training
    mode under ``detach``: its dropout masks still move ``S_0``."""
    g = _path_pair()
    y = torch.arange(4)[None]
    tm = DGMC(RelCNN(32, 16, 2, dropout=0.5), RelCNN(8, 8, 2), num_steps=2,
              k=2, generator=torch.Generator().manual_seed(0)).train()
    S_0, S_L = tm(g, g, y=y, detach=True,
                  generator=torch.Generator().manual_seed(1))
    metrics.nll_loss(S_L, y).backward()
    assert all(p.grad is None for p in tm.psi_1.parameters())
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for p in tm.psi_2.parameters())
    with torch.no_grad():
        def s_0(seed):
            S_0, _ = tm(g, g, y=y, detach=True, num_steps=0,
                        generator=torch.Generator().manual_seed(seed))
            return S_0.idx, S_0.val
        (i1, v1), (i2, v2), (i3, v3) = s_0(1), s_0(1), s_0(2)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    assert not (torch.equal(i1, i3) and torch.allclose(v1, v3))


def test_sparse_train_injects_gt_and_negatives():
    """``test_dgmc.py:163``: k = 1 plus min(1, N - 1) = 1 negative, the
    ground truth in every row's candidates."""
    g = _path_pair(B_=2)
    y = torch.tensor([[3, 2, 1, 0], [0, 1, 2, 3]])
    tm = DGMC(RelCNN(32, 16, 2), RelCNN(8, 8, 2), num_steps=1, k=1,
              generator=torch.Generator().manual_seed(0)).train()
    S_0, S_L = tm(g, g, y=y)
    assert S_0.idx.shape == (2, 4, 2)
    assert bool((S_0.idx == y[..., None]).any(-1).all())
    loss = metrics.nll_loss(S_L, y)
    assert torch.isfinite(loss) and loss > 0


def _pp_pair(seed, n=12, e=30, c=16):
    r = np.random.RandomState(seed)

    def g():
        return Graph(edge_index=r.randint(0, n, (2, e)),
                     x=r.randn(n, c).astype(np.float32))

    return GraphPair(s=g(), t=g(), y_col=r.permutation(n).astype(np.int64))


def _pp_model():
    return DGMC(RelCNN(16, 12, 2), RelCNN(8, 8, 2), num_steps=2, k=4,
                generator=torch.Generator().manual_seed(0))


def test_batched_losses_match_independent_steps():
    """``test_pairs_per_step.py:52``: pair ``b`` of a batched step draws
    what a ``B = 1`` step at ``pair_offset = b`` draws (noise and
    negatives), so the per-pair losses agree."""
    pairs = [_pp_pair(s) for s in (1, 2, 3)]
    model = _pp_model()
    batched = pad_pair_batch(pairs, 12, 30)

    def step(m, batch, offset):
        m = copy.deepcopy(m)
        return make_train_step(m, pair_offset=offset)(
            create_train_state(m, 1e-2), batch, 7)[1]

    out = step(model, batched, 0)
    assert out['loss_per_pair'].shape == (3,)
    for i, p in enumerate(pairs):
        single = step(model, pad_pair_batch([p], 12, 30), i)
        np.testing.assert_allclose(out['loss_per_pair'][i].item(),
                                   single['loss'].item(), rtol=1e-5,
                                   atol=1e-6, err_msg=f'pair {i}')


def test_replicated_pairs_draw_independent_noise_and_negatives():
    """``test_pairs_per_step.py:124`` (and the collation half,
    ``pairs_per_step`` tiling)."""
    batch = pad_pair_batch([_pp_pair(11)], 12, 30, pairs_per_step=2)
    assert batch.s['x'].shape[0] == 2 and batch.y.shape == (2, 12)
    np.testing.assert_array_equal(batch.s['x'][0], batch.s['x'][1])
    np.testing.assert_array_equal(batch.y[0], batch.y[1])
    model = _pp_model().train()
    _, S_0, S_L, _, _ = loss_and_outputs(model, batch, noise_seed=5)
    assert not torch.equal(S_0.idx[0], S_0.idx[1])
    assert not torch.allclose(S_L.val[0], S_L.val[1])


class _IdentityPsi1(torch.nn.Module):
    def reset_parameters(self, generator=None):
        pass

    def forward(self, x, graph, generator=None):
        return x


class _DegreePsi2(torch.nn.Module):
    """Colours node i with its in-degree, ignoring its input; with
    channel-packed evaluation where ``supports_streams`` (JAX's
    ``DegreePsi2`` has none)."""
    in_channels = out_channels = 3

    def __init__(self, supports_streams=False):
        super().__init__()
        self.supports_streams = supports_streams

    def reset_parameters(self, generator=None):
        pass

    def forward(self, x, graph, streams=1, generator=None):
        deg = tgraph.degree(graph.receivers, graph.edge_mask,
                            graph.num_nodes)
        return deg[..., None].expand(*deg.shape, streams * 3)


def _line(feats):
    n = len(feats)
    return tgraph.GraphBatch.from_numpy({
        'x': np.asarray(feats, np.float32)[None],
        'senders': np.arange(n - 1)[None], 'receivers': np.arange(1, n)[None],
        'node_mask': np.ones((1, n), bool),
        'edge_mask': np.ones((1, n - 1), bool)}, 'cpu')


@pytest.mark.parametrize('streams', [True, False],
                         ids=['streams', 'no-streams'])
def test_consensus_iteration_golden_sparse(streams):
    """``test_golden.py:111``: the sparse path with k = N lands on the
    hand-computed dense values, with a ψ₂ with or without channel-packed
    evaluation."""
    g_s = _line([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    g_t = _line([[1.0, 1.0], [1.0, 0.0], [0.0, 2.0]])
    tm = DGMC(_IdentityPsi1(), _DegreePsi2(streams), num_steps=1,
              k=3).eval()
    with torch.no_grad():
        tm.mlp_hidden_kernel.copy_(torch.eye(3))
        tm.mlp_out_kernel.fill_(1.0 / 3)
        _, S_L = tm(g_s, g_t)
    dense = S_L.to_dense()[0].numpy()
    np.testing.assert_allclose(dense[1], [0.46831053, 0.06337894, 0.46831053],
                               atol=1e-6)
    np.testing.assert_allclose(dense[2], [0.66524096, 0.09003057, 0.24472847],
                               atol=1e-6)


def _alignment_problem(seed=0, n=300, e=1500, c=24):
    """``test_two_phase_quality.py``'s problem, the same arrays."""
    rng = np.random.RandomState(seed)
    x_s = rng.randn(n, c).astype(np.float32)
    snd = rng.randint(0, n, e).astype(np.int32)
    rcv = rng.randint(0, n, e).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    x_t = np.zeros_like(x_s)
    x_t[perm] = x_s + 0.9 * rng.randn(n, c).astype(np.float32)
    keep = rng.rand(e) < 0.85
    snd_t = np.where(keep, perm[snd], rng.randint(0, n, e))
    rcv_t = np.where(keep, perm[rcv], rng.randint(0, n, e))

    def side(x, s, r):
        return {'x': x[None], 'senders': s[None].astype(np.int32),
                'receivers': r[None].astype(np.int32),
                'node_mask': np.ones((1, n), bool),
                'edge_mask': np.ones((1, e), bool)}

    train = np.zeros(n, bool)
    train[:int(0.3 * n)] = True
    y_tr = np.where(train, perm, -1)[None]
    y_te = np.where(~train, perm, -1)[None]
    g_s, g_t = side(x_s, snd, rcv), side(x_t, snd_t, rcv_t)
    return (PairBatch(g_s, g_t, y_tr, y_tr >= 0),
            PairBatch(g_s, g_t, y_te, y_te >= 0))


def test_two_phase_schedule_matching_quality():
    """``test_two_phase_quality.py:80`` through the port's phase steps:
    50 phase-1 steps (num_steps 0), 25 phase-2 steps (5 consensus steps,
    ψ₁ detached); the same floors (phase-2 test Hits@1 >= 0.60 and at
    least 0.05 above phase 1)."""
    train, test = _alignment_problem()
    train, test = batch_to_device(train, 'cpu'), batch_to_device(test, 'cpu')
    model = DGMC(RelCNN(24, 64, 2, dropout=0.3), RelCNN(16, 16, 2),
                 num_steps=0, k=8, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, learning_rate=1e-2)
    p1, p2 = (make_train_step(model, num_steps=0),
              make_train_step(model, num_steps=5, detach=True))

    def hits1(num_steps, seed):
        out = make_eval_step(model, num_steps=num_steps)(test, seed)
        return float(out['correct']) / float(out['count'])

    for i in range(50):
        state, _ = p1(state, train, i)
    h1 = hits1(0, 1000)
    for i in range(25):
        state, _ = p2(state, train, 100 + i)
    h2 = hits1(5, 1001)
    assert h2 >= 0.60, f'two-phase matching quality regressed: {h2:.3f}'
    assert h2 >= h1 + 0.05, (f'refinement no longer improves on feature '
                             f'matching: phase1={h1:.3f} phase2={h2:.3f}')


def test_dropout_rate_scale_generator_and_eval():
    h = torch.ones(200, 300)
    out = dropout(h, 0.3, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.7))
    assert torch.equal(out, dropout(h, 0.3, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, dropout(h, 0.3,
                                        torch.Generator().manual_seed(1)))
    g = _path_pair(n=6, c=5)
    m = RelCNN(5, 7, 2, dropout=0.5)
    m.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = m(g.x, g, generator=torch.Generator().manual_seed(3))
        b = m(g.x, g, generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match='generator'):
            m(g.x, g)
        with pytest.raises(ValueError, match='streams'):
            m(torch.cat([g.x, g.x], -1), g, streams=2,
              generator=torch.Generator())
        m.eval()
        assert torch.equal(m(g.x, g), m(g.x, g, generator=torch.Generator()))


def test_indices_outside_the_targets_are_refused():
    """Ground truths on upload, and a precomputed shortlist or injected
    negatives at the forward: the kernels index target rows unchecked."""
    train, _ = _alignment_problem(n=40, e=80)
    train.y[0, 0] = 40
    with pytest.raises(ValueError, match='ground truth'):
        batch_to_device(train, 'cpu')
    g = _path_pair(B_=1)
    tm = DGMC(RelCNN(32, 16, 1), RelCNN(8, 8, 1), num_steps=1, k=1,
              generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='S_idx outside'):
        tm.eval()(g, g, S_idx=torch.full((1, 4, 1), 4))
    with pytest.raises(ValueError, match='negatives outside'):
        tm.train()(g, g, y=torch.arange(4)[None],
                   negatives=torch.full((1, 4, 1), -1))


def test_cli_trains_both_phases_on_cpu(capsys):
    """Tiny widths: phase 1's loss falls, the eval lines of both phases
    print, every step is finite."""
    losses = []

    def hook(kind, epoch, out):
        if kind == 'train':
            losses.append(float(out['loss']))

    dbp15k.main(['--device', 'cpu', '--f32', '--synthetic',
                 '--syn_nodes_s', '120',
                 '--syn_nodes_t', '150', '--syn_edges_s', '500',
                 '--syn_edges_t', '600', '--syn_dim', '24', '--dim', '16',
                 '--rnd_dim', '8', '--num_layers', '2', '--num_steps', '2',
                 '--epochs', '13', '--phase1_epochs', '10', '--lr', '0.01',
                 '--pairs-per-step', '2'], hook=hook)
    assert len(losses) == 13 and np.isfinite(losses).all()
    assert np.mean(losses[7:10]) < np.mean(losses[:3])
    out = capsys.readouterr().out
    assert 'Refine correspondence matrix...' in out
    for epoch in (10, 11, 13):
        assert f'{epoch:03d}: Loss: ' in out and 'Hits@10: ' in out


def test_cli_without_synthetic_exits_with_a_notice():
    """Neither ``--synthetic`` nor ``--category``: the JAX CLI's exit."""
    with pytest.raises(SystemExit, match='--category is required unless '
                                         '--synthetic'):
        dbp15k.main(['--device', 'cpu'])


def test_negatives_are_drawn_per_pair_and_valid():
    n_valid = torch.tensor([5, 9])
    neg = dgmc_module.draw_negatives(n_valid, 40, 3, seed=1, pair_offset=2)
    assert neg.shape == (2, 40, 3) and neg.dtype == torch.int64
    assert (neg[0] < 5).all() and (neg[1] < 9).all() and (neg >= 0).all()
    one = dgmc_module.draw_negatives(n_valid[1:], 40, 3, seed=1,
                                     pair_offset=3)
    assert torch.equal(one[0], neg[1])


def test_dbp15k_initial_weights_follow_jax_initializer():
    """The DBP15K CLI's model at its widths (RelCNN ψ₁ 300 → 256, ψ₂
    32 → 32, the consensus MLP) draws each parameter from the JAX CLI's
    distribution: over seeds 0-2 the same shapes, the biases zero, each
    kernel's standard deviation within five of its standard errors
    (``std / sqrt(2 n)`` over the ``n`` pooled entries) of JAX's, and no
    entry beyond flax's two-sigma truncation (to the same margin). (torch's generator and
    threefry draw different numbers from one seed; only the
    distributions can agree.)"""
    from dgmc_tpu.experiments import dbp15k as jax_dbp15k
    from dgmc_tpu.train.state import create_train_state as jax_state
    argv = ['--synthetic', '--syn_nodes_s', '40', '--syn_nodes_t', '50',
            '--syn_edges_s', '120', '--syn_edges_t', '150', '--f32']
    pooled = {}
    for seed in range(3):
        args = jax_dbp15k.parse_args(argv + ['--seed', str(seed)])
        batch, _, in_dim = jax_dbp15k.synthetic_batches(args)
        model = JaxDGMC(
            JaxRelCNN(in_dim, args.dim, args.num_layers, batch_norm=False,
                      cat=True, lin=True, dropout=0.5),
            JaxRelCNN(args.rnd_dim, args.rnd_dim, args.num_layers,
                      batch_norm=False, cat=True, lin=True, dropout=0.0),
            num_steps=args.num_steps, k=args.k)
        state = jax_state(model, jax.random.key(seed), batch,
                          learning_rate=args.lr)
        want = dgmc_from_flax(jax.device_get(state.params))
        targs = dbp15k.parse_args(argv + ['--seed', str(seed)])
        got = dbp15k.build(targs, in_dim).state_dict()
        assert set(got) == set(want)
        for name, t in got.items():
            j = torch.as_tensor(np.asarray(want[name]))
            assert tuple(j.shape) == tuple(t.shape), name
            pooled.setdefault(name, ([], []))
            pooled[name][0].append(j.double().flatten())
            pooled[name][1].append(t.detach().double().flatten())
    for name, (js, ts) in pooled.items():
        j, t = torch.cat(js), torch.cat(ts)
        if not j.any():
            assert not t.any(), name
            continue
        sj, st = float(j.std()), float(t.std())
        err = 5 / np.sqrt(2 * j.numel())
        assert abs(st - sj) <= err * sj, (name, st, sj)
        # Two standard deviations of the untruncated normal, whose
        # truncation at two leaves 0.8796 of its standard deviation.
        assert float(t.abs().max()) <= 2 * sj / 0.87962566 * (1 + err), name
