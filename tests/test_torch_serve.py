"""The port's serving slice end to end against the JAX package.

A small RelCNN pair (k=5, num_steps=3), a 200-node corpus and a 20-node
query: the port's corpus embeddings, DGMC forward and MatchEngine answer
(device='cpu', converted weights, JAX's own indicator noise injected)
against an eager JAX ``DGMC.apply(..., train=False, h_t=...)`` at the
same padded bucket shape.

Tolerances: shortlists and ranked candidates must be equal (indices).
Embeddings agree to atol 1e-5 (float32 products summed in another order);
probabilities to rtol 1e-4 / atol 1e-5, the float32 drift of three
consensus iterations of such products through softmax; the quality
fields, rounded to 6 decimals in the answer, to atol 2e-5.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.serve.client import sample_query
from dgmc_tpu_torch.serve.corpus import (CACHE_TABLE, compute_embeddings,
                                         load_or_build, synthetic_corpus)
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import (QueryRouter, UnknownBucketError,
                                         parse_buckets)
from dgmc_tpu_torch.utils.data import pad_graphs

K, STEPS, R_IN = 5, 3, 8
BUCKET = '32x96'
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jgraph(arrays):
    return JaxGraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope='module')
def pair():
    """JAX model + params, the converted torch model, corpus and query."""
    corpus = synthetic_corpus(200, 600, 12, seed=0)
    jm = JaxDGMC(JaxRelCNN(12, 16, 2), JaxRelCNN(R_IN, R_IN, 2),
                 num_steps=STEPS, k=K)
    t_arrays = corpus.graph_arrays(dummy_x=False)
    q, gt = sample_query(corpus.x, 20, 60, seed=3)
    q_arrays = pad_graphs([q], 32, 96)
    params = jm.init({'params': jax.random.key(0),
                      'noise': jax.random.key(1)},
                     _jgraph(q_arrays), _jgraph(t_arrays))['params']
    tm = DGMC(RelCNN(12, 16, 2), RelCNN(R_IN, R_IN, 2), num_steps=STEPS,
              k=K)
    tm.load_state_dict(dgmc_from_flax(jax.device_get(params)))
    return {'jm': jm, 'params': params, 'tm': tm.eval(), 'corpus': corpus,
            't_arrays': t_arrays, 'q': q, 'q_arrays': q_arrays}


@pytest.fixture(scope='module')
def jax_run(pair):
    """Eager JAX serving forward; captures the indicator noise ψ₂ sees."""
    jm, params = pair['jm'], pair['params']
    h_t = pair['jm'].psi_1.apply({'params': params['psi_1']},
                                 jnp.asarray(pair['t_arrays']['x']),
                                 _jgraph(pair['t_arrays']))
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__' and not seen):
            seen.append(np.array(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        S_0, S_L = jm.apply({'params': params}, _jgraph(pair['q_arrays']),
                            _jgraph(pair['t_arrays']), train=False,
                            rngs={'noise': jax.random.key(7)}, h_t=h_t)
    # The first ψ₂ call is the source side, all steps packed channel-wise.
    B, N_s = 1, 32
    r_s = seen[0].reshape(B, N_s, STEPS, R_IN).transpose(2, 0, 1, 3)
    return {'h_t': np.array(h_t), 'r_s': r_s,
            'S_0': (np.array(S_0.val), np.array(S_0.idx)),
            'S_L': (np.array(S_L.val), np.array(S_L.idx))}


def test_corpus_embeddings_match_jax(pair, jax_run):
    h_t = compute_embeddings(pair['tm'].psi_1, pair['corpus'], device='cpu')
    assert h_t.shape == (1, 200, 16) and h_t.dtype == np.float32
    np.testing.assert_allclose(h_t, jax_run['h_t'], atol=1e-5)


def test_model_forward_matches_jax(pair, jax_run):
    g_s = GraphBatch.from_numpy(pair['q_arrays'], 'cpu')
    g_t = GraphBatch.from_numpy(pair['corpus'].graph_arrays(), 'cpu')
    with torch.no_grad():
        S_0, S_L = pair['tm'](g_s, g_t, h_t=torch.from_numpy(jax_run['h_t']),
                              r_s=torch.from_numpy(jax_run['r_s']))
    for got, (val, idx) in ((S_0, jax_run['S_0']), (S_L, jax_run['S_L'])):
        np.testing.assert_array_equal(got.idx.numpy(), idx)
        np.testing.assert_allclose(got.val.numpy(), val, rtol=1e-4,
                                   atol=1e-5)


def _ranked_numpy(S_0, S_L, node_mask, r):
    """The engine's ``ranked`` block, re-derived in numpy."""
    (v0, i0), (vL, iL) = S_0, S_L
    pos = np.argsort(-vL, axis=-1, kind='stable')
    top_v = np.take_along_axis(vL, pos, -1)
    m = node_mask.astype(np.float32)

    def row_mean(x):
        return float((x * m).sum() / max(m.sum(), 1.0))

    def ent(S):
        h = -np.where(S > 0, S * np.log(np.maximum(S, 1e-12)), 0).sum(-1)
        return row_mean(h)

    k = vL.shape[-1]
    d = (vL - v0) * m[..., None]
    return {
        'cand_idx': np.take_along_axis(iL, pos[..., :r], -1),
        'initial_idx': np.take_along_axis(
            i0, np.argsort(-v0, -1, kind='stable')[..., :1], -1)[..., 0],
        'quality': {
            'entropy': ent(vL),
            'margin': row_mean(top_v[..., 0] - top_v[..., 1]),
            'correction': float(np.sqrt((d * d).sum(axis=(1, 2))).mean()),
            'saturation': row_mean(pos[..., 0] / (k - 1)),
            'saturated_frac': row_mean((pos[..., 0] == k - 1) * 1.0),
        }}


@pytest.fixture(scope='module')
def engine(pair):
    corpus = pair['corpus']
    index, _ = load_or_build(None, pair['tm'].psi_1, corpus, device='cpu')
    router = QueryRouter(f'16x48,{BUCKET}', corpus.num_nodes,
                         corpus.num_edges)
    eng = MatchEngine(pair['tm'], index, router, max_results=3,
                      device='cpu')
    report = eng.warm()
    assert set(report) == {router.signature(b) for b in router.buckets}
    assert {r['bucket'] for r in report.values()} == {'16x48', BUCKET}
    return eng


def test_engine_answer_matches_jax(pair, jax_run, engine):
    ans = engine.match(pair['q'], r_s=jax_run['r_s'])
    n = pair['q'].num_nodes
    assert ans['bucket'] == BUCKET and ans['nodes'] == n
    np.testing.assert_array_equal(
        np.array(ans['_audit']['shortlist_idx']), jax_run['S_L'][1][0, :n])
    want = _ranked_numpy(jax_run['S_0'], jax_run['S_L'],
                         pair['q_arrays']['node_mask'], 3)
    cands = np.array([[c[0] for c in m['candidates']]
                      for m in ans['matches']])
    np.testing.assert_array_equal(cands, want['cand_idx'][0, :n])
    np.testing.assert_array_equal([m['initial'][0] for m in ans['matches']],
                                  want['initial_idx'][0, :n])
    vL, iL = jax_run['S_L']
    for i, m in enumerate(ans['matches']):
        for t, p in m['candidates']:
            slot = list(iL[0, i]).index(t)
            np.testing.assert_allclose(p, vL[0, i, slot], rtol=1e-4,
                                       atol=1e-5)
    for key, val in want['quality'].items():
        np.testing.assert_allclose(ans['quality'][key], val, atol=2e-5,
                                   err_msg=key)


def test_engine_answer_signature_matches_jax_router(pair, engine):
    """An answer's ``signature`` is the JAX package's key for the same
    bucket (the recompile pass's hash of the bucket's telemetry row);
    its ``bucket`` stays the readable ``'NxE'``."""
    from tests.torch_jax_worker import jax_worker
    ans = engine.match(pair['q'])
    corpus = pair['corpus']
    with jax_worker('dgmc_tpu.serve.router') as m:
        router = m['router'].QueryRouter(f'16x48,{BUCKET}',
                                         corpus.num_nodes, corpus.num_edges)
        want = router.signature(router.route(pair['q'].num_nodes,
                                             pair['q'].num_edges))
    assert ans['bucket'] == BUCKET
    assert ans['signature'] == want and len(want) == 16


def test_repeat_query_gives_identical_answer(pair, engine):
    first = engine.match(pair['q'])
    assert engine.match(pair['q']) == first
    assert engine.bucket_stats()[parse_buckets(BUCKET)[0]] >= 2


def test_unknown_bucket_raises(pair, engine):
    big, _ = sample_query(pair['corpus'].x, 40, 100, seed=1)
    with pytest.raises(UnknownBucketError) as e:
        engine.match(big)
    assert e.value.payload['buckets'] == ['16x48', BUCKET]


def test_engine_needs_cuda_unless_cpu_is_asked(pair, engine):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default device is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        MatchEngine(pair['tm'], engine.index, engine.router)


def test_corpus_cache_rebuilds_on_changed_params_or_corrupt_table(tmp_path):
    corpus = synthetic_corpus(30, 60, 6, seed=2)
    psi_1 = RelCNN(6, 4, 1).eval()
    cache = str(tmp_path / 'cache')
    _, info = load_or_build(cache, psi_1, corpus, device='cpu')
    assert info['cache'] == 'miss:no-manifest'
    index, info = load_or_build(cache, psi_1, corpus, device='cpu')
    assert info['cache'] == 'hit' and index.h_t.shape == (1, 30, 4)
    with torch.no_grad():
        psi_1.final.bias.add_(1.0)
    _, info = load_or_build(cache, psi_1, corpus, device='cpu')
    assert info['cache'] == 'miss:params-mismatch'
    table = os.path.join(cache, CACHE_TABLE)
    with open(table, 'r+b') as f:
        f.seek(-4, os.SEEK_END)
        f.write(b'\x00\x01\x02\x03')
    _, info = load_or_build(cache, psi_1, corpus, device='cpu')
    assert info['cache'] == 'miss:sha256-mismatch:h_t.npy'


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, dirs, names in os.walk(os.path.join(REPO, 'dgmc_tpu_torch')):
        if '_build' in dirs:   # kernel build output, not the package
            dirs.remove('_build')
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    assert {os.path.join(REPO, 'dgmc_tpu_torch', 'models', f'{m}.py')
            for m in ('norm', 'mlp', 'gin', 'rel', 'dgmc')} <= set(files)
    assert {os.path.join(REPO, 'dgmc_tpu_torch', *m)
            for m in (('ops', 'blocked.py'), ('ops', 'offload.py'),
                      ('ops', 'kernels', 'blocked.py'),
                      ('resilience', '__init__.py'),
                      ('resilience', 'distributed_guard.py'),
                      ('resilience', 'faults.py'),
                      ('resilience', 'guard.py'),
                      ('resilience', 'supervisor.py'),
                      *(('serve', f'{m}.py') for m in (
                          '__init__', '__main__', 'service', 'audit',
                          'client', 'cli', 'engine')),
                      ('train', 'checkpoint.py'),
                      ('models', 'evalsum.py'),
                      ('data', 'transforms.py'),
                      ('datasets', '__init__.py'),
                      ('datasets', 'features.py'),
                      ('datasets', 'convert_vgg.py'),
                      ('datasets', 'pascal_voc.py'),
                      ('datasets', 'willow.py'),
                      ('datasets', 'pascal_pf.py'),
                      ('datasets', 'dbp15k.py'),
                      ('datasets', 'fixtures.py'),
                      ('experiments', 'pascal.py'),
                      ('experiments', 'willow.py'),
                      *(('analysis', f'{m}.py') for m in (
                          '__init__', 'findings', 'catalog', 'concurrency',
                          'source_rules', 'con_rules', 'recompile',
                          'lint', 'registry', 'trace_rules', 'liveness')),
                      *(('obs', f'{m}.py') for m in (
                          '__init__', 'observe', 'registry', 'live',
                          'watchdog', 'probes', 'quality', 'anomaly', 'slo',
                          'trace', 'run', 'memory', 'qtrace', 'capacity',
                          'goodput', 'stages', 'cost', 'trace_events',
                          'attribution', 'report', 'timeline', 'calibrate',
                          'diff', 'aggregate')))} <= set(files)
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'flax', 'dgmc_tpu'), \
                f'{os.path.relpath(path, REPO)} imports {mod}'


# -- serving a checkpoint -----------------------------------------------------

#: The serve CLI's DBP15K configuration cut to a CPU test's size (its
#: architecture kept: RelCNN ψ₁ and ψ₂, three layers).
SMALL_DBP15K = {'feat_dim': 12, 'dim': 16, 'rnd_dim': 8, 'num_steps': 2,
                'k': 5, 'nodes_s': 60, 'nodes_t': 150, 'edges_s': 200,
                'edges_t': 450}
SERVE_ARGV = ['--device', 'cpu', '--num-queries', '2', '--buckets',
              '16x48,64x192']


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """The serve CLI (small configuration) over: a checkpoint of other
    weights than the seeded ones (twice, then once more after a step of
    yet other weights is saved), an empty directory with
    ``--init-missing``, and no ``--ckpt_dir``."""
    import contextlib
    import io
    from dgmc_tpu_torch.serve import cli
    from dgmc_tpu_torch.train.checkpoint import Checkpointer
    from dgmc_tpu_torch.train.state import create_train_state
    root = tmp_path_factory.mktemp('serve')
    trained = str(root / 'trained')
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, 'DBP15K', dict(cli.DBP15K, **SMALL_DBP15K))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)

        def run(name, argv):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli.main(SERVE_ARGV + argv)
            answers = [json.loads(line) for line in
                       out.getvalue().splitlines()]
            for a in answers:
                a.pop('latency_ms')
            runs[name] = (answers, err.getvalue())

        try:
            other = cli.dbp15k_model(seed=7)
            Checkpointer(trained).save(3, other, create_train_state(other))
            runs['model_3'] = other
            run('first', ['--ckpt_dir', trained])
            with open(os.path.join(trained, 'corpus_cache',
                                   'manifest.json')) as f:
                runs['meta_first'] = json.load(f)
            run('second', ['--ckpt_dir', trained])
            newer = cli.dbp15k_model(seed=8)
            Checkpointer(trained).save(4, newer, create_train_state(newer))
            run('newer', ['--ckpt_dir', trained])
            run('init', ['--ckpt_dir', str(root / 'empty'),
                         '--init-missing'])
            run('seeded', [])
            with pytest.raises(SystemExit, match='--init-missing'):
                cli.main(SERVE_ARGV + ['--ckpt_dir', str(root / 'none')])
            runs['engine_3'] = _engine_answers(cli, trained, 3)
        finally:
            torch.set_num_threads(threads)
    runs['root'] = root
    return runs


def _engine_answers(cli, ckpt_dir, step):
    """The CLI's queries answered by a ``MatchEngine`` over the step's
    weights, read with ``torch.load`` (not through the restore)."""
    from dgmc_tpu_torch.serve.corpus import Corpus
    payload = torch.load(os.path.join(ckpt_dir, str(step), 'state.pt'),
                         weights_only=True)
    model = cli.dbp15k_model(seed=0)
    model.load_state_dict(payload['model'])
    kg = cli.dbp15k_kg(0)
    corpus = Corpus(kg.x_t, kg.senders_t, kg.receivers_t)
    index, _ = load_or_build(None, model.psi_1, corpus, device='cpu')
    router = QueryRouter('16x48,64x192', corpus.num_nodes, corpus.num_edges)
    engine = MatchEngine(model, index, router, max_results=5, device='cpu')
    engine.warm()
    rng = np.random.RandomState(0)
    answers = []
    for i in range(2):
        n = int(rng.randint(16, 65))
        graph, _ = sample_query(corpus.x, n, 3 * n, seed=1 + i)
        ans = engine.match(graph)
        # The CLI prints the audit rows as `shortlist`.
        ans['shortlist'] = ans.pop('_audit')['shortlist_idx']
        answers.append(ans)
    return answers


def test_serve_restores_the_trained_checkpoint(served):
    from dgmc_tpu_torch.serve.corpus import params_fingerprint
    answers, err = served['first']
    assert 'restored checkpoint step 3' in err
    for got, want in zip(answers, served['engine_3']):
        for key in ('matches', 'shortlist', 'quality', 'bucket'):
            assert got[key] == want[key], key
    assert answers != served['seeded'][0]
    meta = served['meta_first']
    assert meta['checkpoint_step'] == 3
    assert meta['params_fingerprint'] == params_fingerprint(
        served['model_3'].psi_1)


def test_serve_cache_records_the_step_and_misses_another_checkpoint(
        served):
    assert 'cache miss:no-manifest' in served['first'][1]
    assert 'cache hit' in served['second'][1]
    assert served['second'][0] == served['first'][0]
    assert 'restored checkpoint step 4' in served['newer'][1]
    assert 'cache miss:params-mismatch' in served['newer'][1]
    assert served['newer'][0] != served['first'][0]
    with open(os.path.join(served['root'], 'trained', 'corpus_cache',
                           'manifest.json')) as f:
        assert json.load(f)['checkpoint_step'] == 4


def test_serve_init_missing_saves_step_zero_and_answers_as_seeded(served):
    from dgmc_tpu_torch.train.checkpoint import Checkpointer
    answers, err = served['init']
    assert 'restored checkpoint step 0' in err
    assert Checkpointer(os.path.join(served['root'], 'empty')) \
        .all_steps() == [0]
    assert answers == served['seeded'][0]
