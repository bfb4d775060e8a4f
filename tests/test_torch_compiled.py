"""The port's compiled steps (``train/compiled.py``) on the CPU, against
the eager steps and against the JAX package's jitted ones.

The JAX package is imported only by the tests that hold the port
against it (:func:`_jax`), so that this file also runs on a machine
without JAX, where its ``cuda`` tests run.

On the CPU a compiled step copies each call's inputs into static buffers
and runs eagerly on them, dropping the buffers' caches after each run:
the code a captured CUDA graph records on the card. The card's own
twins (graphs captured and replayed) are marked ``cuda`` and skip here.

Tolerances: the static-buffer path and the eager one run the same
operations on the same values, so they must agree bit for bit. Against
JAX, the steps' own tolerances: the loss and the per-pair losses within
rtol 1e-5 (``tests/test_torch_dense.py``'s and
``tests/test_torch_sparse_train.py``'s step tests), the accuracy equal.
"""

import copy
import json
import types

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            KNNGraph)
from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.models.spline import SplineCNN
from dgmc_tpu_torch.obs.memory import captured_memory, memory_snapshot
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.serve.client import sample_query
from dgmc_tpu_torch.serve.corpus import load_or_build, synthetic_corpus
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import QueryRouter
from dgmc_tpu_torch.train.compiled import Captured, Fixed, compiled
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import PairBatch, pad_pair_batch

N, E, B, STEPS, DIM, RND = 16, 128, 2, 2, 16, 8
MEMORY_KEYS = {'argument_bytes', 'output_bytes', 'temp_bytes',
               'total_bytes'}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tensors here are small, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs exist only on the card')
    return torch.device('cuda')


def _jax():
    """The JAX package's modules these tests hold the port against."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as nn

    from dgmc_tpu import data, models, train, utils
    from dgmc_tpu.models.rel import RelCNN
    from dgmc_tpu.models.spline import SplineCNN
    from dgmc_tpu.ops.graph import GraphBatch
    from dgmc_tpu.train.state import TrainState
    from dgmc_tpu.utils.data import PairBatch
    from dgmc_tpu_torch.convert import dgmc_from_flax
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, nn=nn, data=data, DGMC=models.DGMC,
        RelCNN=RelCNN, SplineCNN=SplineCNN, GraphBatch=GraphBatch,
        TrainState=TrainState, PairBatch=PairBatch,
        create_state=train.create_train_state,
        train_step=train.make_train_step,
        pad_pair_batch=utils.pad_pair_batch, from_flax=dgmc_from_flax)


def _torch_pairs(length, seed=3):
    """A small pair stream (5-10 inliers, 0-3 outliers, the PascalPF
    transforms)."""
    tt = Compose([Constant(), KNNGraph(k=8), Cartesian()])
    return RandomGraphPairs(5, 10, 0, 3, transform=tt, length=length,
                            seed=seed)


def _pairs(J, length, seed=3):
    """The same pair stream in both packages."""
    d = J.data
    jt = d.Compose([d.Constant(), d.KNNGraph(k=8), d.Cartesian()])
    return (d.RandomGraphPairs(5, 10, 0, 3, transform=jt, length=length,
                               seed=seed), _torch_pairs(length, seed))


def _dense_model(seed=0):
    return DGMC(SplineCNN(1, DIM, 2, 2, cat=False),
                SplineCNN(RND, RND, 2, 2, cat=True), num_steps=STEPS, k=-1,
                generator=torch.Generator().manual_seed(seed))


def _dense_batches(count):
    """``count`` different padded batches of B pairs."""
    tds = _torch_pairs(B * count)
    return [pad_pair_batch([tds[B * i + j] for j in range(B)], N, E)
            for i in range(count)]


def _state_of(model, state):
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f'{n} {k}'] = v.clone()
    return out


def _assert_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _three_dense_steps(device, jit):
    """Three train steps and an eval over three different batches in turn
    (a fresh batch each call on the eager path): each step's metrics, then
    the parameters and Adam state."""
    model = _dense_model().to(device)
    state = create_train_state(model, 1e-2)
    step = make_train_step(model, loss_on_s0=True, jit=jit)
    evals = make_eval_step(model, hits_ks=(1, 3), jit=jit)
    got = []
    for i, batch in enumerate(_dense_batches(3)):
        if not jit:
            batch = batch_to_device(batch, device)
        _, out = step(state, batch, 10 + i)
        got.append({k: v.clone() for k, v in out.items()})
        got.append({k: v.clone() for k, v in
                    evals(batch, 20 + i).items()})
    return got, _state_of(model, state)


def test_static_buffers_follow_each_batch_bit_for_bit():
    """(a) The static-buffer path over three different dense batches in
    turn equals eager steps on fresh batches, in every metric, parameter
    and Adam moment: the buffers' routing and CSR orders are rebuilt from
    each batch copied in, never the first one's."""
    got, state = _three_dense_steps('cpu', jit=True)
    want, want_state = _three_dense_steps('cpu', jit=False)
    for g, w in zip(got, want):
        _assert_identical(g, w)
    _assert_identical(state, want_state)
    # The batches differ, so a stale cache would have shown.
    assert len({float(g['loss']) for g in got[::2]}) == 3


def test_static_batch_refuses_a_stale_cache():
    g = GraphBatch.from_numpy(_dense_batches(1)[0].s, 'cpu')
    static = g.static_like('cpu')
    static.copy_from(g)
    static.csr('receivers')
    with pytest.raises(RuntimeError, match='clear_memo'):
        static.copy_from(g)
    static.clear_memo()
    static.copy_from(g)
    assert torch.equal(static.x, g.x)


@pytest.mark.cuda
def test_replayed_steps_follow_each_batch_bit_for_bit(cuda):
    """(a) on the card: captured graphs replayed over three batches
    against the eager steps there."""
    got, state = _three_dense_steps(cuda, jit=True)
    want, want_state = _three_dense_steps(cuda, jit=False)
    for g, w in zip(got, want):
        _assert_identical(g, w)
    _assert_identical(state, want_state)


def _jax_dense_noise(J, jm, params, jb, key):
    """JAX's indicator noise in the train step keyed ``key``: ψ₂'s
    source-side inputs under the step's noise key (the draw does not
    depend on the parameters)."""
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            seen.append(args[0])
        return next_fun(*args, **kwargs)

    with J.nn.intercept_methods(capture):
        jm.apply({'params': params}, jb.s, jb.t, y=jb.y, y_mask=jb.y_mask,
                 train=True, rngs={'noise': J.jax.random.split(key, 3)[0]})
    return torch.from_numpy(np.array(J.jnp.stack(seen[0::2])))


def _load_jax_state(J, model, state, jstate):
    """The port's parameters and Adam moments and count set, in place,
    to JAX's (optax's ``ScaleByAdamState``)."""
    model.load_state_dict(J.from_flax(J.jax.device_get(jstate.params)))
    adam = jstate.opt_state[0]
    if int(adam.count) == 0:
        return
    mu = J.from_flax(J.jax.device_get(adam.mu))
    nu = J.from_flax(J.jax.device_get(adam.nu))
    with torch.no_grad():
        for name, p in model.named_parameters():
            st = state.optimizer.state[p]
            st['exp_avg'].copy_(mu[name])
            st['exp_avg_sq'].copy_(nu[name])
            st['step'].fill_(int(adam.count))


def test_three_dense_steps_match_jax():
    """(b) Three dense steps at B = 2 through the static-buffer path, one
    batch after another, against JAX's jitted ``make_train_step``, JAX's
    noise injected. Before each step the port's parameters and Adam state
    are set to JAX's, so that each step is held at the step test's
    tolerance from one state: run freely, the two trajectories part by
    more than rtol 1e-5 by the third step (1.6e-5 in a per-pair loss),
    because Adam's first update moves every entry by about ±lr whatever
    its gradient's size, so entries whose gradients are rounding noise
    (the two that are zero analytically among them) move apart by 2 lr.
    Adam's own update is held against optax in
    ``tests/test_torch_dense.py``."""
    J = _jax()
    jds, tds = _pairs(J, 3 * B)
    jbs = [J.pad_pair_batch([jds[B * i + j] for j in range(B)], N, E,
                              native='never') for i in range(3)]
    tbs = [pad_pair_batch([tds[B * i + j] for j in range(B)], N, E)
           for i in range(3)]
    jm = J.DGMC(J.SplineCNN(1, DIM, 2, 2, cat=False, dropout=0.0),
                J.SplineCNN(RND, RND, 2, 2, cat=True, dropout=0.0),
                num_steps=STEPS, k=-1)
    jstate = J.create_state(jm, J.jax.random.key(0), jbs[0])
    params = J.jax.device_get(jstate.params)
    tm = _dense_model()
    state = create_train_state(tm)
    step = make_train_step(tm, loss_on_s0=True)
    jstep = J.train_step(jm, loss_on_s0=True)
    for i, (jb, tb) in enumerate(zip(jbs, tbs)):
        key = J.jax.random.key(7 + i)
        r_s = _jax_dense_noise(J, jm, params, jb, key)
        _load_jax_state(J, tm, state, jstate)
        jstate, jout = jstep(jstate, jb, key)
        _, out = step(state, tb, i, r_s=r_s)
        np.testing.assert_allclose(float(out['loss']), float(jout['loss']),
                                   rtol=1e-5, err_msg=f'step {i}')
        np.testing.assert_allclose(out['loss_per_pair'].numpy(),
                                   np.asarray(jout['loss_per_pair']),
                                   rtol=1e-5, err_msg=f'step {i}')
        assert float(out['acc']) == float(jout['acc'])
    assert state.step == 3 and len(step.jit.compiled.records) == 1


def _kg_side(r, n, n_real, c=12, e=60):
    x = r.randn(B, n, c).astype(np.float32)
    x[:, n_real:] = 0
    mask = np.zeros((B, n), bool)
    mask[:, :n_real] = True
    return {'x': x, 'senders': r.randint(0, n_real, (B, e)).astype(np.int32),
            'receivers': r.randint(0, n_real, (B, e)).astype(np.int32),
            'node_mask': mask, 'edge_mask': r.rand(B, e) > 0.1}


def test_kg_phase2_step_matches_jax():
    """(b) A KG phase-2 step (two consensus steps, ψ₁ detached) through
    the static-buffer path against JAX's jitted ``make_train_step``, JAX's
    noise and negatives injected."""
    J = _jax()
    jnp, jax = J.jnp, J.jax
    K, R_IN = 4, 8
    r = np.random.RandomState(0)
    s, t = _kg_side(r, 20, 20), _kg_side(r, 26, 23)
    y = np.stack([r.permutation(23)[:20] for _ in range(B)])
    y_mask = r.rand(B, 20) > 0.3
    y = np.where(y_mask, y, -1).astype(np.int32)
    jg = [J.GraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                       edge_attr=None) for a in (s, t)]
    jb = J.PairBatch(jg[0], jg[1], jnp.asarray(y), jnp.asarray(y_mask))
    jm = J.DGMC(J.RelCNN(12, 16, 2, dropout=0.0), J.RelCNN(R_IN, R_IN, 2),
                num_steps=2, k=K)
    params = jax.device_get(jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)},
        jg[0], jg[1])['params'])
    key = jax.random.key(5)
    k_noise, k_neg, k_drop = jax.random.split(key, 3)
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__' and not seen):
            seen.append(args[0])
        return next_fun(*args, **kwargs)

    with J.nn.intercept_methods(capture):
        S_0, _ = jm.apply({'params': params}, jb.s, jb.t, y=jb.y,
                          y_mask=jb.y_mask, train=True, num_steps=2,
                          detach=True, rngs={'noise': k_noise,
                                             'negatives': k_neg,
                                             'dropout': k_drop})
    r_s = torch.from_numpy(np.array(seen[0]).reshape(B, 20, 2, R_IN)
                           .transpose(2, 0, 1, 3))
    neg = torch.from_numpy(np.array(S_0.idx)[..., K:]).long()
    jstate = J.TrainState.create(apply_fn=jm.apply, params=params,
                                 tx=J.optax.adam(1e-3))
    _, jout = J.train_step(jm, num_steps=2, detach=True)(jstate, jb, key)
    tm = DGMC(RelCNN(12, 16, 2), RelCNN(R_IN, R_IN, 2), num_steps=2, k=K)
    tm.load_state_dict(J.from_flax(params))
    _, out = make_train_step(tm, num_steps=2, detach=True)(
        create_train_state(tm), PairBatch(s, t, y, y_mask), 0, r_s=r_s,
        negatives=neg)
    np.testing.assert_allclose(float(out['loss']), float(jout['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(out['loss_per_pair'].numpy(),
                               np.asarray(jout['loss_per_pair']), rtol=1e-5)
    assert float(out['acc']) == float(jout['acc'])


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_adds_the_captured_launches():
    """(c) ``launch_counts`` counts launches executed: a replay adds the
    launches its capture made, and the ledger the decisions."""
    dispatch.reset()
    before = dispatch.snapshot()
    dispatch.record('topk', 'kernel', 'auto-cuda', torch.float32)
    dispatch.record('rng', 'kernel', 'auto-cuda', torch.int64)
    launches, decisions = dispatch.changes(before, dispatch.snapshot())
    assert launches == {} and set(decisions) == {'topk', 'rng'}
    dispatch.restore(before)
    assert dispatch.decisions() == {}
    graph = _StandInGraph()
    out = {'loss': torch.zeros(())}
    rec = Captured(static=(), graph=graph, outputs=out,
                   launches={'rng': 2, 'topk': 1}, decisions=decisions)
    for _ in range(3):
        assert rec.replay() is out
    counts = dispatch.launch_counts()
    assert graph.replays == 3
    assert counts['rng'] == 6 and counts['topk'] == 3
    assert counts['sparse_consensus_fwd'] == 0
    d = dispatch.decisions()
    assert d['topk']['counts'] == {'kernel': 3, 'plain': 0}
    assert d['rng']['dtypes'] == {'kernel:int64': 3}
    dispatch.restore(before)
    assert dispatch.launch_counts()['rng'] == 0
    dispatch.reset()


def test_compiled_keeps_one_record_per_signature():
    """A record per input signature: shapes, which optional inputs are
    present and the identity of in-place inputs; ints become seed
    tensors."""
    seen = []

    def fn(fixed, x, seed, extra):
        seen.append((fixed, seed.dtype, extra is None))
        return {'y': x * 2 + seed}

    c = compiled(fn, 'cpu')
    a, b = torch.ones(3), torch.ones(4)
    assert torch.equal(c(Fixed(a), a, 5, None)['y'], a * 2 + 5)
    c(Fixed(a), torch.zeros(3), 6, None)
    c(Fixed(a), b, 5, None)
    c(Fixed(b), a, 5, None)
    c(Fixed(a), a, 5, torch.zeros(1))
    assert len(c.records) == 4
    assert seen[0] == (a, torch.int64, True)
    rec = c.capture(Fixed(a), a, 7, None)
    assert rec.graph is None and captured_memory(rec) == {
        'argument_bytes': 12 + 12 + 8, 'output_bytes': 12, 'temp_bytes': 0,
        'total_bytes': 44}


TINY_KG = ['--device', 'cpu', '--f32', '--synthetic', '--syn_nodes_s', '80',
           '--syn_nodes_t', '100', '--syn_edges_s', '300', '--syn_edges_t',
           '360', '--syn_dim', '16', '--dim', '16', '--rnd_dim', '8',
           '--num_layers', '2', '--num_steps', '2', '--epochs', '12',
           '--phase1_epochs', '10', '--lr', '0.01']


def _dbp15k_losses(argv):
    losses = []
    dbp15k.main(argv, hook=lambda k, e, o: losses.append(o['loss'].item())
                if k == 'train' else None)
    return losses


def test_dbp15k_aot_compile_logs_memory_and_keeps_the_losses(tmp_path,
                                                            capsys):
    """(d) ``--aot_compile`` on the CPU logs the four ``aot_memory_*``
    events and prints a line each; training from the same seed is
    unchanged by it."""
    path = tmp_path / 'metrics.jsonl'
    got = _dbp15k_losses(TINY_KG + ['--aot_compile', '--metrics_log',
                                    str(path)])
    printed = capsys.readouterr().out
    want = _dbp15k_losses(TINY_KG)
    assert got == want and len(got) == 12
    events = [json.loads(line) for line in path.read_text().splitlines()]
    aot = {e['event']: e for e in events if 'event' in e}
    names = ('phase1_step', 'eval1_step', 'train_step', 'eval_step')
    assert set(aot) == {f'aot_memory_{n}' for n in names}
    for name in names:
        e = aot[f'aot_memory_{name}']
        assert MEMORY_KEYS <= set(e) and e['argument_bytes'] > 0
        assert e['total_bytes'] == (e['argument_bytes'] + e['output_bytes']
                                    + e['temp_bytes'])
        assert f'# {name}: per-device static memory ' in printed


def test_dbp15k_aot_compile_captures_only_the_steps_that_run(tmp_path):
    """The JAX CLI's clamps: no phase-2 steps without phase-2 epochs, no
    eval1 without a tenth phase-1 epoch."""
    path = tmp_path / 'metrics.jsonl'
    argv = [a for a in TINY_KG]
    argv[argv.index('--epochs') + 1] = '9'
    dbp15k.main(argv + ['--aot_compile', '--metrics_log', str(path)])
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e['event'] for e in events if 'event' in e] == [
        'aot_memory_phase1_step']


def _engines(device, jit):
    corpus = synthetic_corpus(200, 600, 12, seed=0)
    model = DGMC(RelCNN(12, 16, 2), RelCNN(8, 8, 2), num_steps=3, k=5,
                 generator=torch.Generator().manual_seed(0)).eval()
    index, _ = load_or_build(None, copy.deepcopy(model.psi_1), corpus,
                             device=device)
    router = QueryRouter('16x48,32x96', corpus.num_nodes, corpus.num_edges)
    return corpus, [MatchEngine(copy.deepcopy(model), index, router,
                                max_results=3, device=device, jit=j)
                    for j in jit]


def _warm_and_answer(device):
    corpus, (engine, eager) = _engines(device, (True, False))
    report = engine.warm()
    eager.warm()
    assert set(report) == {engine.router.signature(b)
                           for b in engine.router.buckets}
    assert {r['bucket'] for r in report.values()} == {'16x48', '32x96'}
    for r in report.values():
        assert r['capture_s'] >= 0 and set(r['memory']) == MEMORY_KEYS
        assert r['memory']['argument_bytes'] > 0
    queries = [sample_query(corpus.x, n, 3 * n, seed=n)[0] for n in (12, 20)]
    gen = torch.Generator().manual_seed(1)
    for q in queries:
        n = 16 if q.num_nodes <= 16 else 32
        r_s = torch.randn(3, 1, n, 8, generator=gen)
        assert engine.match(q) == eager.match(q)
        assert engine.match(q, r_s=r_s) == eager.match(q, r_s=r_s)
    return report


def test_engine_warm_reports_capture_and_keeps_answers():
    """(e) ``warm`` reports each bucket's ``capture_s`` and static
    memory; answers, with the engine's noise and a query's own, equal the
    eager engine's."""
    report = _warm_and_answer('cpu')
    assert all(r['memory']['temp_bytes'] == 0 for r in report.values())


def test_concurrent_queries_share_the_static_buffers_safely():
    """The buckets' static buffers are shared by every caller: queries
    from many threads (a short switch interval) get the answers they get
    one at a time."""
    import sys
    import threading
    corpus, (engine,) = _engines('cpu', (True,))
    engine.warm()
    queries = [sample_query(corpus.x, n, 3 * n, seed=n)[0]
               for n in (10, 14, 20, 27)]
    want = [engine.match(q) for q in queries]
    got, errors = {}, []

    def worker(t):
        try:
            for i in range(len(queries)):
                j = (i + t) % len(queries)
                got[(t, j)] = engine.match(queries[j])
        except Exception as e:   # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(got) == 6 * len(queries)
    for (t, j), ans in got.items():
        assert ans == want[j], (t, j)


@pytest.mark.cuda
def test_engine_replays_match_the_eager_engine_on_the_card(cuda):
    """(e) on the card: one graph per bucket, and a second one for a
    query's own noise, replayed bit-identical to the eager engine."""
    report = _warm_and_answer(cuda)
    assert all(r['memory']['temp_bytes'] > 0 for r in report.values())


def test_memory_snapshot_has_the_jax_modules_keys():
    """(f) ``memory_snapshot``'s record, as ``dgmc_tpu/obs/memory.py``
    writes it."""
    snap = memory_snapshot('probe')
    assert set(snap) == {'tag', 'time', 'devices', 'host'}
    assert snap['tag'] == 'probe'
    assert {'rss_bytes', 'peak_rss_bytes'} <= set(snap['host'])
    assert snap['host']['rss_bytes'] > 0
    for dev in snap['devices']:
        assert {'id', 'kind', 'platform'} <= set(dev)
        assert 'bytes_in_use' in dev or dev['stats'] is None
