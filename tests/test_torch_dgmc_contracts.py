"""The port's DGMC with any ψ₂, held against the JAX package on the CPU.

- The packing decision (``DGMC.packs_source``): where the JAX package's
  ``prefetch_source`` packs ψ₂'s source side of all steps into one
  channel-packed call and where each step calls ψ₂ on each side, counted
  by ψ₂ calls in both packages, in every case of
  ``dgmc_tpu/models/dgmc.py:551-558``, on both variants.
- The ports of ``tests/models/test_dgmc.py:49,87,102`` on GIN (dense ≡
  sparse at ``k = N``, gradients in both variants) and of
  ``tests/models/test_golden.py:75`` (the dense golden iteration with a ψ₂
  without channel-packed evaluation).
- One training forward and backward of each variant with batch-norm and
  GIN ψ₂ against JAX (``train=True``, ``mutable=['batch_stats']``):
  the loss, every gradient and the running averages after the step; then
  the eval step on the updated running averages.
- The capture warm-up's snapshot restoring the model's buffers, and the
  corpus cache missing once the running averages change.

JAX's draws are injected: the indicator noise captured with
``flax.linen.intercept_methods`` on ψ₂'s source-side calls (every other
call when each step calls ψ₂ on each side), the negatives read back from
JAX's ``S_0.idx[..., k:]`` as ``test_torch_sparse_train.py`` does.

Tolerances: dense ≡ sparse and the golden values at JAX's atol 1e-6.
Against JAX: shortlists equal; correspondences atol 1e-5; the loss rtol
1e-5; each gradient within rtol 1e-4 and 1e-4 of its largest entry
(``test_torch_sparse_train.py``'s gate); a gradient that is zero
analytically (ψ₂'s final bias and the consensus MLP's output bias cancel
in ``o_s - o_t`` and the softmax) below 1e-5 of the largest gradient in
both; running averages within rtol 1e-5 and 1e-5 of their largest entry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import GIN as JaxGIN
from dgmc_tpu.models import RelCNN as JaxRelCNN
from dgmc_tpu.models import metrics as jmetrics
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.models import DGMC, GIN, RelCNN, metrics
from dgmc_tpu_torch.ops import graph as tgraph
from dgmc_tpu_torch.serve.corpus import load_or_build, synthetic_corpus
from dgmc_tpu_torch.train.state import create_train_state, snapshot
from dgmc_tpu_torch.train.steps import make_eval_step, make_train_step

from tests.helpers import path_graph
from tests.test_torch_sparse_train import _DegreePsi2, _IdentityPsi1, _line


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(g):
    """A JAX GraphBatch's arrays."""
    return {k: np.array(getattr(g, k)) for k in
            ('x', 'senders', 'receivers', 'node_mask', 'edge_mask')}


def _pair(arrays):
    return (JaxGraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          edge_attr=None),
            tgraph.GraphBatch.from_numpy(arrays, 'cpu'))


def _count_calls(module):
    calls = []
    module.register_forward_hook(lambda *_: calls.append(1))
    return calls


# ---- The packing decision ----

# (name, ψ₂ of each package, num_steps, training): what JAX's
# prefetch_source decides, case by case.
R = 4
PACK_CASES = {
    'packs': (lambda: JaxRelCNN(R, R, 1), lambda: RelCNN(R, R, 1), 2, True),
    'one-step': (lambda: JaxRelCNN(R, R, 1), lambda: RelCNN(R, R, 1), 1,
                 True),
    'batch-norm': (lambda: JaxRelCNN(R, R, 1, batch_norm=True),
                   lambda: RelCNN(R, R, 1, batch_norm=True), 2, True),
    'dropout': (lambda: JaxRelCNN(R, R, 1, dropout=0.5),
                lambda: RelCNN(R, R, 1, dropout=0.5), 2, True),
    'dropout-eval': (lambda: JaxRelCNN(R, R, 1, dropout=0.5),
                     lambda: RelCNN(R, R, 1, dropout=0.5), 2, False),
    'no-streams': (lambda: JaxGIN(R, R, 1), lambda: GIN(R, R, 1), 2, True),
}
PACKED = {'packs', 'dropout-eval'}


@pytest.mark.parametrize('k', [-1, 3], ids=['dense', 'sparse'])
@pytest.mark.parametrize('case', sorted(PACK_CASES))
def test_packing_decision_follows_jax(case, k):
    make_j, make_t, num_steps, train = PACK_CASES[case]
    g_j, g_t = _pair(_arrays(path_graph(n=5, c=6)))
    y = np.arange(5)[None]
    jm = JaxDGMC(JaxRelCNN(6, 8, 1), make_j(), num_steps=num_steps, k=k)
    rngs = {'noise': jax.random.key(1), 'negatives': jax.random.key(2),
            'dropout': jax.random.key(3)}
    seen = []

    def count(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            seen.append(1)
        return next_fun(*args, **kwargs)

    def run():
        v = jm.init({'params': jax.random.key(0), **rngs}, g_j, g_j)
        with nn.intercept_methods(count):
            return jm.apply(v, g_j, g_j, y=jnp.asarray(y), train=train,
                            rngs=rngs, mutable=['batch_stats'])

    # ψ₂'s calls are counted while JAX traces, so an abstract run does.
    jax.eval_shape(run)
    tm = DGMC(RelCNN(6, 8, 1), make_t(), num_steps=num_steps, k=k)
    tm.train(train)
    calls = _count_calls(tm.psi_2)
    want = num_steps + 1 if case in PACKED else 2 * num_steps
    assert tm.packs_source(num_steps) == (case in PACKED)
    with torch.no_grad():
        tm(g_t, g_t, y=torch.from_numpy(y), generator=torch.Generator())
    assert len(seen) == len(calls) == want


# ---- test_dgmc.py's contracts on GIN ----

N, C = 4, 32


def _gin_dgmc(k, num_steps=1, batch_norm=False):
    return DGMC(GIN(C, 16, 2, batch_norm=batch_norm),
                GIN(8, 8, 2, batch_norm=batch_norm), num_steps=num_steps,
                k=k, generator=torch.Generator().manual_seed(0))


def test_dense_sparse_equivalence_single_graph():
    """``test_dgmc.py:49``."""
    _, g = _pair(_arrays(path_graph(n=N, c=C)))
    y = torch.arange(N)[None]
    S1_0, S1_L = _gin_dgmc(-1).eval()(g, g, noise_seed=7)
    S2_0, S2_L = _gin_dgmc(N).eval()(g, g, y=y, noise_seed=7)
    assert S1_0.val.shape == (1, N, N)
    torch.testing.assert_close(S1_0.val, S2_0.to_dense(), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(S1_L.val, S2_L.to_dense(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(metrics.nll_loss(S1_0, y).item(),
                               metrics.nll_loss(S2_0, y).item(), rtol=1e-5,
                               atol=1e-6)
    acc1, acc2 = metrics.acc(S1_0, y), metrics.acc(S2_0, y)
    h1 = [metrics.hits_at_k(k, S1_0, y).item() for k in (1, 10, N)]
    h2 = [metrics.hits_at_k(k, S2_0, y).item() for k in (1, 10, N)]
    assert acc1.item() == acc2.item() == h1[0] == h2[0]
    assert h1[0] <= h1[1] == h2[1] <= h1[2]
    assert h1[2] == h2[2] == 1.0


@pytest.mark.parametrize('batch_norm', [False, True], ids=['gin', 'gin-bn'])
def test_dense_sparse_equivalence_batched(batch_norm):
    """``test_dgmc.py:87``; with batch norm in training mode (at k = N
    the sparse variant draws no negatives and the ground truth is
    already a candidate), the running averages agree too."""
    g_j = path_graph(n=N, c=C)
    a = _arrays(g_j)
    a = {k: np.concatenate([v, v]) for k, v in a.items()}
    _, g = _pair(a)
    y = torch.arange(N)[None].repeat(2, 1)
    dense, sparse = (_gin_dgmc(k, 2, batch_norm) for k in (-1, N))
    dense.train(batch_norm)
    sparse.train(batch_norm)
    S1_0, S1_L = dense(g, g, y=y, noise_seed=7)
    S2_0, S2_L = sparse(g, g, y=y, noise_seed=7)
    assert S1_0.val.shape == (2, N, N)
    torch.testing.assert_close(S1_0.val, S2_0.to_dense(), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(S1_L.val, S2_L.to_dense(), rtol=0,
                               atol=1e-6)
    for b1, b2 in zip(dense.buffers(), sparse.buffers()):
        torch.testing.assert_close(b1, b2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('k', [-1, N], ids=['dense', 'sparse'])
def test_gradients_flow_both_variants(k):
    """``test_dgmc.py:102``."""
    _, g = _pair(_arrays(path_graph(n=N, c=C)))
    y = torch.arange(N)[None]
    model = _gin_dgmc(k).train()
    S_0, S_L = model(g, g, y=y, noise_seed=7)
    (metrics.nll_loss(S_0, y) + metrics.nll_loss(S_L, y)).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g_).all() for g_ in grads)
    assert any(g_.abs().max() > 0 for g_ in grads)


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_consensus_iteration_golden():
    """``test_golden.py:75``: one dense consensus step by hand, with a ψ₂
    without channel-packed evaluation (as JAX's ``DegreePsi2``)."""
    x_s = [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]
    x_t = [[1.0, 1.0], [1.0, 0.0], [0.0, 2.0]]
    tm = DGMC(_IdentityPsi1(), _DegreePsi2(), num_steps=1, k=-1).eval()
    with torch.no_grad():
        tm.mlp_hidden_kernel.copy_(torch.eye(3))
        tm.mlp_out_kernel.fill_(1.0 / 3)
        S_0, S_L = tm(_line(x_s), _line(x_t))
    S_hat0 = np.asarray(x_s) @ np.asarray(x_t).T
    deg = np.array([0.0, 1.0, 1.0])
    want_SL = _softmax(S_hat0 + np.maximum(deg[:, None] - deg[None, :], 0))
    np.testing.assert_allclose(S_0.val[0].numpy(), _softmax(S_hat0),
                               atol=1e-6)
    np.testing.assert_allclose(S_L.val[0].numpy(), want_SL, atol=1e-6)
    np.testing.assert_allclose(want_SL[1], [0.46831053, 0.06337894,
                                            0.46831053], atol=1e-6)


# ---- One training step with batch-norm / GIN ψ₂ against JAX ----

B, N_S, N_T, E, C_IN, K, R_IN, STEPS = 2, 12, 15, 36, 8, 3, 4, 2


def _side(r, n, n_real):
    x = r.randn(B, n, C_IN).astype(np.float32)
    x[:, n_real:] = 0
    mask = np.zeros((B, n), bool)
    mask[:, :n_real] = True
    return {'x': x, 'senders': r.randint(0, n_real, (B, E)).astype(np.int32),
            'receivers': r.randint(0, n_real, (B, E)).astype(np.int32),
            'node_mask': mask, 'edge_mask': r.rand(B, E) > 0.1}


# (ψ₁, ψ₂) per case, each as (JAX, port) constructors; k. The sparse
# case's ψ₁ is the KG configuration's RelCNN with batch norm.
STEP_CASES = {
    'sparse-gin-bn': (
        (lambda: JaxRelCNN(C_IN, 16, 2, batch_norm=True),
         lambda: RelCNN(C_IN, 16, 2, batch_norm=True)),
        (lambda: JaxGIN(R_IN, R_IN, 1, batch_norm=True),
         lambda: GIN(R_IN, R_IN, 1, batch_norm=True)), K),
    'dense-gin-bn': (
        (lambda: JaxGIN(C_IN, 16, 2, batch_norm=True),
         lambda: GIN(C_IN, 16, 2, batch_norm=True)),
        (lambda: JaxGIN(R_IN, R_IN, 1, batch_norm=True),
         lambda: GIN(R_IN, R_IN, 1, batch_norm=True)), -1),
}


def _noise_capture(seen):
    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            seen.append(args[0])
        return next_fun(*args, **kwargs)
    return capture


def _jax_step(case):
    """JAX's training forward, its loss and gradients and the running
    averages after it; then its eval forward on those averages."""
    (j1, _), (j2, _), k = STEP_CASES[case]
    r = np.random.RandomState(0)
    s, t = _side(r, N_S, N_S), _side(r, N_T, N_T - 3)
    y = np.stack([r.permutation(N_T - 3)[:N_S] for _ in range(B)])
    y_mask = r.rand(B, N_S) > 0.2
    y = np.where(y_mask, y, -1).astype(np.int32)
    jm = JaxDGMC(j1(), j2(), num_steps=STEPS, k=k)
    g_s, _ = _pair(s)
    g_t, _ = _pair(t)
    rngs = {'noise': jax.random.key(3), 'negatives': jax.random.key(4),
            'dropout': jax.random.key(5)}
    v = jax.device_get(jm.init({'params': jax.random.key(0), **rngs},
                               g_s, g_t))

    def forward(params, stats, train):
        seen = []
        with nn.intercept_methods(_noise_capture(seen)):
            (S_0, S_L), upd = jm.apply(
                {'params': params, 'batch_stats': stats}, g_s, g_t,
                y=jnp.asarray(y), y_mask=jnp.asarray(y_mask), train=train,
                rngs=rngs, mutable=['batch_stats'])
        loss = jmetrics.nll_loss(S_L, jnp.asarray(y), jnp.asarray(y_mask))
        # Each step calls ψ₂ on the source, then on the target.
        r_s = jnp.stack(seen[0::2])
        return loss, (S_0.val, S_0.idx, S_L.val, S_L.idx, r_s,
                      upd['batch_stats'])

    (loss, (v0, idx, vL, _, r_s, stats)), grads = jax.jit(
        jax.value_and_grad(lambda p: forward(p, v['batch_stats'], True),
                           has_aux=True))(v['params'])
    _, (_, _, eval_vL, eval_idx, eval_r_s, _) = jax.jit(
        lambda p, st: forward(p, st, False))(v['params'], stats)
    return {'s': s, 't': t, 'y': y, 'y_mask': y_mask, 'k': k,
            'params': v['params'], 'stats0': v['batch_stats'],
            'loss': float(loss), 'v0': np.array(v0), 'idx': np.array(idx),
            'vL': np.array(vL), 'r_s': np.array(r_s),
            'stats': jax.device_get(stats),
            'grads': dgmc_from_flax(jax.device_get(grads)),
            'eval_vL': np.array(eval_vL), 'eval_idx': np.array(eval_idx),
            'eval_r_s': np.array(eval_r_s)}


_JAX_STEPS = {}


@pytest.fixture(params=sorted(STEP_CASES))
def step_case(request):
    if request.param not in _JAX_STEPS:
        _JAX_STEPS[request.param] = _jax_step(request.param)
    return request.param, _JAX_STEPS[request.param]


def _port_model(case, want):
    (_, t1), (_, t2), k = STEP_CASES[case]
    tm = DGMC(t1(), t2(), num_steps=STEPS, k=k)
    tm.load_state_dict(dgmc_from_flax(want['params'], want['stats0']))
    return tm


def _inputs(want):
    g_s = tgraph.GraphBatch.from_numpy(want['s'], 'cpu')
    g_t = tgraph.GraphBatch.from_numpy(want['t'], 'cpu')
    return (g_s, g_t, torch.from_numpy(want['y']).long(),
            torch.from_numpy(want['y_mask']))


def _hold_stats(tm, want, stats):
    ref = dgmc_from_flax(want['params'], stats)
    got = tm.state_dict()
    keys = [k for k in ref if k.endswith(('.mean', '.var'))]
    assert len(keys) == len(list(tm.buffers()))
    for key in keys:
        w = ref[key].numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


def test_training_step_with_batch_norm_matches_jax(step_case):
    case, want = step_case
    tm = _port_model(case, want).train()
    g_s, g_t, y, y_mask = _inputs(want)
    calls = _count_calls(tm.psi_2)
    neg = (torch.from_numpy(want['idx'][..., K:]).long()
           if want['k'] >= 1 else None)
    S_0, S_L = tm(g_s, g_t, y=y, y_mask=y_mask,
                  r_s=torch.from_numpy(want['r_s']), negatives=neg)
    assert len(calls) == 2 * STEPS
    loss = metrics.nll_loss(S_L, y, y_mask)
    loss.backward()
    if want['k'] >= 1:
        np.testing.assert_array_equal(S_L.idx.numpy(), want['idx'])
    np.testing.assert_allclose(S_0.val.detach().numpy(), want['v0'],
                               atol=1e-5)
    np.testing.assert_allclose(S_L.val.detach().numpy(), want['vL'],
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), want['loss'], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(want['grads'])
    top = max(float(w.abs().max()) for w in want['grads'].values())
    for name, w in want['grads'].items():
        w = w.numpy()
        g = got[name].grad.numpy()
        if np.abs(w).max() < 1e-5 * top:
            assert np.abs(g).max() < 1e-5 * top, name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    _hold_stats(tm, want, want['stats'])


def test_eval_step_reads_the_updated_running_averages(step_case):
    """The eval step (compiled; on the CPU its static-buffer path) after
    the step's running averages are loaded: the correspondences JAX's
    eval forward gives (``use_running_average``), and no average moves."""
    case, want = step_case
    tm = _port_model(case, want)
    tm.load_state_dict(dgmc_from_flax(want['params'], want['stats']))
    g_s, g_t, y, y_mask = _inputs(want)
    r_s = torch.from_numpy(want['eval_r_s'])
    with torch.no_grad():
        _, S_L = tm.eval()(g_s, g_t, r_s=r_s)
    np.testing.assert_allclose(S_L.val.numpy(), want['eval_vL'], atol=1e-5)
    if want['k'] >= 1:
        np.testing.assert_array_equal(S_L.idx.numpy(), want['eval_idx'])
    batch = (g_s, g_t, y, y_mask)
    from dgmc_tpu_torch.train.steps import DeviceBatch
    out = make_eval_step(tm, hits_ks=(1,))(DeviceBatch(*batch), 0, r_s=r_s)
    assert int(out['correct']) == int(metrics.acc(S_L, y, y_mask,
                                                  reduction='sum'))
    _hold_stats(tm, want, want['stats'])


# ---- Buffers under the capture's warm-up, and the corpus cache ----

def test_snapshot_restores_the_model_buffers():
    case = 'sparse-gin-bn'
    if case not in _JAX_STEPS:
        _JAX_STEPS[case] = _jax_step(case)
    want = _JAX_STEPS[case]
    tm = _port_model(case, want)
    from dgmc_tpu_torch.train.steps import DeviceBatch
    batch = DeviceBatch(*_inputs(want))
    state = create_train_state(tm, 1e-2)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    restore = snapshot(state, tm)
    make_train_step(tm, jit=False)(state, batch, 3)
    changed = [k for k, v in tm.state_dict().items()
               if not torch.equal(v, before[k])]
    assert any(k.endswith('.mean') for k in changed)
    restore()
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    # A compiled step's capture runs the step once and restores all of
    # it, buffers included; its first call then runs from there.
    step = make_train_step(tm, jit=True)
    step.capture(state, batch, 3)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    copy_ = copy.deepcopy(tm)
    eager_state = create_train_state(copy_, 1e-2)
    _, out = step(state, batch, 3)
    _, ref = make_train_step(copy_, jit=False)(eager_state, batch, 3)
    assert torch.equal(out['loss'], ref['loss'])
    for (k, v), w in zip(tm.state_dict().items(),
                         copy_.state_dict().values()):
        assert torch.equal(v, w), k


def test_corpus_cache_misses_once_the_running_averages_change(tmp_path):
    corpus = synthetic_corpus(30, 60, 6, seed=2)
    psi_1 = RelCNN(6, 4, 2, batch_norm=True).eval()
    cache = str(tmp_path / 'cache')
    assert load_or_build(cache, psi_1, corpus,
                         device='cpu')[1]['cache'] == 'miss:no-manifest'
    assert load_or_build(cache, psi_1, corpus,
                         device='cpu')[1]['cache'] == 'hit'
    params = {k: v.clone() for k, v in psi_1.named_parameters()}
    g = tgraph.GraphBatch.from_numpy(corpus.graph_arrays(dummy_x=False),
                                     'cpu')
    with torch.no_grad():
        psi_1.train()(g.x, g)
    psi_1.eval()
    assert all(torch.equal(v, params[k])
               for k, v in psi_1.named_parameters())
    index, info = load_or_build(cache, psi_1, corpus, device='cpu')
    assert info['cache'] == 'miss:params-mismatch'
    with torch.no_grad():
        h = psi_1(g.x, g)
    np.testing.assert_array_equal(index.h_t, h.numpy())
