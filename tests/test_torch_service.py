"""The port's serving worker (``dgmc_tpu_torch/serve/service.py``) over
real HTTP on the CPU, and against the JAX package's worker.

A 256-node corpus (an ``.npz`` both workers load), RelCNN widths 16 / 8,
one layer, two consensus steps, ``k=5``, one ``8x16`` bucket, the shadow
audit at ``--audit-sample 1.0`` on the device tier. The cases of
``tests/serve/test_service.py``: answers, concurrent clients equal to
sequential ones, the structured 4xx / 503 / 405, ``/metrics`` under the
strict parser with every error class, ``trace_id`` / ``stages_ms`` and
the ``x-qtrace: off`` opt-out, the stage histograms, the quality block
and the audit (recall 1.0), the capacity families, ``/status``'s
``capacity`` and ``qtrace`` sections, ``capacity.json``, and a warm
restart that hits the corpus cache.

Against JAX's own ``ServeService`` (loaded through
:func:`tests.torch_jax_worker.jax_worker`), run in-process on the same
corpus, its step-0 parameters converted (``convert.dgmc_from_flax``) and
saved as the port's step 0: for each request the codes, the payload keys
and the ``error`` values are equal; for each 200 the keys of the answer,
of each match and of ``quality``; the metric family names are equal. The
parts of an answer without indicator noise (JAX draws it from a threefry
key torch cannot reproduce) are compared value by value: the ``initial``
match of each node (index equal, probability within rtol 1e-5: float32
scores summed in another order) and the audit's shortlist rows (equal).
Finally each ``/match`` answer equals the port's in-process
``MatchEngine.match`` on the same checkpoint bit for bit, less
``latency_ms`` and the trace fields.
"""

import argparse
import concurrent.futures
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.obs.qtrace import SERVE_SPAN_NAMES, format_traceparent
from dgmc_tpu_torch.obs.quality import QUALITY_SIGNALS, audit_keep
from dgmc_tpu_torch.serve.client import (confidence_of, get_json,
                                         post_match, query_payload,
                                         sample_query)
from dgmc_tpu_torch.serve.corpus import load_or_build, synthetic_corpus
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import QueryRouter
from dgmc_tpu_torch.serve.service import (ERROR_CLASSES, ServeService,
                                          add_serve_args)
from dgmc_tpu_torch.train.checkpoint import Checkpointer
from dgmc_tpu_torch.train.state import create_train_state
from tests.obs.test_live import parse_exposition
from tests.torch_jax_worker import jax_worker

CORPUS = dict(num_nodes=256, num_edges=1024, dim=16)
FLAGS = ['--dim', '16', '--rnd_dim', '8', '--num_layers', '1',
         '--num_steps', '2', '--k', '5', '--buckets', '8x16',
         '--max-results', '3', '--obs-port', '0', '--audit-sample', '1.0']
TRACE_KEYS = ('latency_ms', 'client_ms', 'trace_id', 'trace_ms',
              'stages_ms', 'server_traceparent')


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parse(add_args, argv):
    parser = argparse.ArgumentParser()
    add_args(parser)
    return parser.parse_args(argv)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp('service')
    c = synthetic_corpus(**CORPUS)
    np.savez(root / 'corpus.npz', x=c.x, senders=c.senders,
             receivers=c.receivers)
    return root


def _query(seed, nodes=6, edges=12):
    x = synthetic_corpus(**CORPUS).x
    g, _ = sample_query(x, nodes, edges, seed=seed)
    return g


@pytest.fixture(scope='module')
def jax_service(root):
    """JAX's worker on the same corpus (seeded step 0, saved by it)."""
    with jax_worker('dgmc_tpu.serve.service') as mods:
        args = _parse(mods['service'].add_serve_args,
                      ['--ckpt_dir', str(root / 'jax_ckpt'), '--init-missing',
                       '--corpus-npz', str(root / 'corpus.npz'),
                       '--obs-dir', str(root / 'jax_obs')] + FLAGS)
        svc = mods['service'].ServeService(args).start()
        try:
            yield svc
        finally:
            svc.stop()
            svc.close()


def _port_args(root, obs, *extra):
    return _parse(add_serve_args,
                  ['--ckpt_dir', str(root / 'ckpt'), '--corpus-npz',
                   str(root / 'corpus.npz'), '--obs-dir', str(root / obs),
                   '--device', 'cpu'] + FLAGS + list(extra))


@pytest.fixture(scope='module')
def service(root, jax_service):
    """The port's worker over JAX's step-0 parameters, converted."""
    import jax
    params = jax.device_get(jax_service.engine._variables['params'])
    _save_converted(root / 'ckpt', params)
    svc = ServeService(_port_args(root, 'obs')).start()
    yield svc
    svc.stop()
    svc.close()


def _port_model():
    from dgmc_tpu_torch.models.dgmc import DGMC
    from dgmc_tpu_torch.models.rel import RelCNN
    return DGMC(RelCNN(16, 16, 1, batch_norm=False, cat=True, lin=True,
                       dropout=0.0),
                RelCNN(8, 8, 1, batch_norm=False, cat=True, lin=True,
                       dropout=0.0), num_steps=2, k=5)


def _save_converted(ckpt_dir, params):
    model = _port_model()
    model.load_state_dict(dgmc_from_flax(params))
    Checkpointer(str(ckpt_dir)).save(0, model, create_train_state(model))


def _strip(resp):
    return {k: v for k, v in resp.items() if k not in TRACE_KEYS}


# -- tests/serve/test_service.py's cases ---------------------------------------

def test_match_answers(service):
    code, resp = post_match(service.port, query_payload(_query(0)))
    assert code == 200
    assert resp['bucket'] == '8x16' and resp['nodes'] == 6
    assert len(resp['matches']) == 6
    m = resp['matches'][0]
    assert set(m) == {'node', 'target', 'score', 'candidates', 'initial'}
    assert len(m['candidates']) == 3
    probs = [c[1] for c in m['candidates']]
    assert probs == sorted(probs, reverse=True)
    assert 0 <= m['target'] < CORPUS['num_nodes']
    assert resp['latency_ms'] > 0
    assert '_audit' not in resp


def test_concurrent_equals_sequential(service):
    queries = [query_payload(_query(seed)) for seed in range(6)]
    sequential = [_strip(post_match(service.port, q)[1]) for q in queries]
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        rounds = [list(ex.map(
            lambda q: _strip(post_match(service.port, q)[1]), queries))
            for _ in range(3)]
    for got in rounds:
        assert json.dumps(got, sort_keys=True) \
            == json.dumps(sequential, sort_keys=True)


def test_unknown_bucket_is_4xx(service):
    code, resp = post_match(service.port, query_payload(_query(5, 30, 60)))
    assert code == 400
    assert resp['error'] == 'unknown-bucket'
    assert resp['buckets'] == ['8x16']
    assert resp['query'] == {'nodes': 30, 'edges': 60}


def test_unwarmed_bucket_and_warming_are_structured_503(service):
    saved = dict(service.engine._exec)
    service.engine._exec.clear()
    try:
        code, resp = post_match(service.port, query_payload(_query(4)))
    finally:
        service.engine._exec.update(saved)
    assert code == 503 and resp['error'] == 'bucket-not-warm'
    assert '8x16' in resp['detail']
    service.ready = False
    try:
        code, resp = post_match(service.port, query_payload(_query(4)))
    finally:
        service.ready = True
    assert code == 503 and resp['error'] == 'warming-up'
    assert {'corpus_s', 'checkpoint_s', 'cache_s', 'warm_s',
            'ready_s'} <= set(resp['phases'])


def test_malformed_queries_are_4xx(service):
    req = urllib.request.Request(
        f'http://127.0.0.1:{service.port}/match', data=b'not json',
        method='POST')
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400
    assert json.loads(e.value.read())['error'] == 'bad-query'
    code, resp = post_match(service.port,
                            {'nodes': [[1.0, 2.0]], 'edges': []})
    assert code == 400 and 'feature width' in resp['detail']
    code, resp = get_json(service.port, '/match')
    assert code == 405 and 'schema' in resp


def test_metrics_strict_parse_and_gauges(service):
    post_match(service.port, query_payload(_query(1)))
    code, text = get_json(service.port, '/metrics')
    assert code == 200
    families = parse_exposition(text)
    assert families['dgmc_step_latency_seconds']['type'] == 'histogram'
    counts = [v for (name, _l, v)
              in families['dgmc_step_latency_seconds']['samples']
              if name.endswith('_count')]
    assert counts and float(counts[0]) >= 1
    code, health = get_json(service.port, '/healthz')
    assert code == 200
    gauges = health['gauges']
    assert gauges['serve_ready'] == 1 and gauges['serve_buckets_warm'] == 1
    assert gauges['corpus_cache_hit'] == 0
    assert gauges['queries_served'] >= 1
    assert gauges['serve_warmup_compiles'] >= 1


def test_trace_id_and_stages_in_response(service):
    sent_id = 'ab' * 16
    tp = f'00-{sent_id}-{"cd" * 8}-01'
    code, resp = post_match(service.port, query_payload(_query(6)),
                            traceparent=tp)
    assert code == 200 and resp['trace_id'] == sent_id
    assert resp['server_traceparent'].startswith(f'00-{sent_id}-')
    stages = resp['stages_ms']
    assert set(stages) == {'bucket_resolve', 'pad_and_stage',
                           'admission_queue_wait', 'device_execute',
                           'serialize'}
    assert sum(stages.values()) <= resp['trace_ms'] + 1e-6
    assert resp['client_ms'] > 0
    code, resp = post_match(service.port, query_payload(_query(6)),
                            traceparent='garbage-header')
    assert code == 200
    assert len(resp['trace_id']) == 32 and resp['trace_id'] != sent_id
    tracer = service.qtracer
    assert tracer.flush()
    with open(tracer.path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert lines and all(rec['kept'] for rec in lines)
    assert len(lines) <= (tracer.capacity + tracer.error_capacity
                          + tracer.slowest_k)


def test_qtrace_optout_header(service):
    before = service.qtracer.summary()['queries']
    code, resp = post_match(service.port, query_payload(_query(7)),
                            qtrace=False)
    assert code == 200
    assert not {'trace_id', 'stages_ms', 'server_traceparent'} & set(resp)
    assert service.qtracer.summary()['queries'] == before


def test_stage_histograms_in_metrics(service):
    post_match(service.port, query_payload(_query(3)))
    families = parse_exposition(get_json(service.port, '/metrics')[1])
    fam = families['dgmc_query_stage_seconds']
    assert fam['type'] == 'histogram'
    counts = {labels['stage']: value for (name, labels, value)
              in fam['samples'] if name.endswith('_count')}
    assert set(counts) == set(SERVE_SPAN_NAMES)
    assert counts['device_execute'] >= 1 and counts['serialize'] >= 1
    assert counts['shortlist_merge'] == 0      # the device tier
    kept = {labels['reason']: value for (_n, labels, value)
            in families['dgmc_qtrace_kept_total']['samples']}
    assert kept['slowest'] >= 1


def test_answer_carries_confidence(service):
    code, resp = post_match(service.port, query_payload(_query(12)))
    assert code == 200
    quality = confidence_of(resp)
    assert set(quality) == {'entropy', 'margin', 'correction',
                            'saturation', 'saturated_frac'}
    for name, v in quality.items():
        assert isinstance(v, float) and np.isfinite(v), name
    assert quality['entropy'] >= 0 and quality['margin'] >= 0
    assert 0 <= quality['saturation'] <= 1
    assert confidence_of({'error': 'bad-query'}) == {}


def test_quality_block_and_audit_on_device_tier(service):
    """Every served query is audited (rate 1.0): the audited ids are the
    deterministic keep set and recall is 1.0 (the same search)."""
    sent = []
    for i in range(4):
        tid = f'{i:032x}'
        code, resp = post_match(service.port, query_payload(_query(100 + i)),
                                traceparent=format_traceparent(tid, tid[:16]))
        assert code == 200
        sent.append(tid)
    assert service.auditor.drain(timeout_s=60.0)
    families = parse_exposition(get_json(service.port, '/metrics')[1])
    counts = {labels['signal']: value for (name, labels, value)
              in families['dgmc_query_quality']['samples']
              if name.endswith('_count')}
    assert set(counts) == set(QUALITY_SIGNALS)
    _, status = get_json(service.port, '/status')
    audit = status['quality']['serve']['audit']
    assert audit['audited'] == service.auditor.audited
    assert audit['audited'] >= 4
    assert all(audit_keep(0, t, 1.0) for t in sent)
    assert audit['recall_min'] == 1.0 and audit['recall_mean'] == 1.0
    assert audit['exact'] == audit['audited']
    assert service.auditor.dropped == 0 and service.auditor.errors == 0
    assert status['qtrace']['queries'] >= 4


def test_padding_buckets_in_status(service):
    post_match(service.port, query_payload(_query(2)))
    _, status = get_json(service.port, '/status')
    rows = [r for r in status.get('padding_buckets') or []
            if r.get('nodes') == f'8x{CORPUS["num_nodes"]}']
    assert rows and rows[0]['count'] >= 1
    assert rows[0]['real_nodes_t'] == rows[0]['count'] * CORPUS['num_nodes']


def test_capacity_metric_families_strict_parse(service):
    for seed in (11, 12):
        assert post_match(service.port, query_payload(_query(seed)))[0] \
            == 200
    families = parse_exposition(get_json(service.port, '/metrics')[1])
    assert families['dgmc_inflight']['type'] == 'gauge'
    assert families['dgmc_inflight']['samples'][0][2] == 0
    pads = {labels.get('bucket'): v for (_n, labels, v)
            in families['dgmc_pad_fraction']['samples']}
    assert 0.0 < pads['8x16'] < 1.0
    ratio = families['dgmc_goodput_ratio']['samples'][0][2]
    assert 0.0 < ratio < 1.0
    for fam in ('dgmc_lock_wait_seconds', 'dgmc_lock_hold_seconds'):
        assert families[fam]['type'] == 'histogram'
        counts = [v for (name, _l, v) in families[fam]['samples']
                  if name.endswith('_count')]
        assert counts[0] >= 2


def test_status_capacity_section_and_artifact(service):
    for seed in (13, 14):
        assert post_match(service.port, query_payload(_query(seed)))[0] \
            == 200
    _, status = get_json(service.port, '/status')
    cap = status['capacity']
    assert cap['queries'] >= 2 and cap['mean_service_ms'] > 0
    assert cap['saturation_qps'] == pytest.approx(
        1000.0 / cap['mean_service_ms'], rel=1e-3)
    assert cap['utilization'] == pytest.approx(
        cap['arrival_qps'] * cap['mean_service_ms'] / 1e3, abs=5e-3)
    for side in ('lock_wait_ms', 'lock_hold_ms'):
        assert cap[side]['p50_ms'] <= cap[side]['p95_ms'] \
            <= cap[side]['p99_ms']
    rec = cap['admission_reconciliation']
    assert rec['engine_count'] >= rec['qtrace_count'] >= 1
    service._flush_capacity()
    with open(os.path.join(service.obs.dir, 'capacity.json')) as f:
        disk = json.load(f)
    assert disk['queries'] == cap['queries']
    # Each bucket's ratio weighted by its counted stage FLOPs.
    assert {b['stages_source'] for b in disk['buckets'].values()} == {
        'counted'}
    assert 0 < disk['goodput_ratio'] <= 1


def test_warm_restart_hits_cache(root, service):
    """A second worker over the same checkpoint directory: every error
    class exported at 0 from the first scrape, a verified cache hit (the
    gauge at 1, the same table), captures counted apart from the cache,
    and the same answers."""
    svc = ServeService(_port_args(root, 'obs2')).start()
    try:
        fam = parse_exposition(get_json(svc.port, '/metrics')[1])[
            'dgmc_query_errors_total']
        assert {labels['class']: v for (_n, labels, v) in fam['samples']} \
            == dict.fromkeys(ERROR_CLASSES, 0)
        assert svc.cache_info['cache'] == 'hit'
        _, health = get_json(svc.port, '/healthz')
        assert health['gauges']['corpus_cache_hit'] == 1
        assert 'capture_s' in svc.phases and 'cache_s' in svc.phases
        np.testing.assert_array_equal(svc.engine.index.h_t,
                                      service.engine.index.h_t)
        q = query_payload(_query(3))
        assert _strip(post_match(svc.port, q)[1]) \
            == _strip(post_match(service.port, q)[1])
    finally:
        svc.stop()
        svc.close()


def test_error_classes_strict_parse(service):
    get_json(service.port, '/match')
    post_match(service.port, {'nodes': 'nope'})
    post_match(service.port, query_payload(_query(11, 30, 60)))
    saved = dict(service.engine._exec)
    service.engine._exec.clear()
    try:
        post_match(service.port, query_payload(_query(8)))
    finally:
        service.engine._exec.update(saved)
    orig = service.engine.match

    def boom(*_a, **_k):
        raise RuntimeError('boom')

    service.engine.match = boom
    try:
        code, resp = post_match(service.port, query_payload(_query(9)))
    finally:
        service.engine.match = orig
    assert code == 500 and resp['error'] == 'engine-fault'
    fam = parse_exposition(get_json(service.port, '/metrics')[1])[
        'dgmc_query_errors_total']
    assert fam['type'] == 'counter'
    counts = {labels['class']: v for (_n, labels, v) in fam['samples']}
    assert set(counts) == set(ERROR_CLASSES)
    for cls in ('method-405', 'bad-query-400', 'bucket-miss-400',
                'bucket-not-warm-503', 'engine-500', 'warming-503'):
        assert counts[cls] >= 1, cls


# -- against JAX's worker --------------------------------------------------------

def _requests():
    """(method, payload) pairs: answers, an unknown bucket, malformed
    bodies, a wrong width, a GET."""
    good = [('POST', query_payload(_query(s))) for s in (20, 21, 22)]
    return good + [
        ('POST', query_payload(_query(23, 30, 60))),
        ('POST', {'nodes': 'nope'}),
        ('POST', {'edges': []}),
        ('POST', {'nodes': [[1.0, 2.0]], 'edges': []}),
        ('POST', {'nodes': [1.0, 2.0]}),
        ('GET', None)]


def _send(port, method, payload):
    if method == 'GET':
        return get_json(port, '/match')
    return post_match(port, payload)


def test_codes_and_payload_keys_match_jax(service, jax_service):
    for method, payload in _requests():
        code, got = _send(service.port, method, payload)
        want_code, want = _send(jax_service.port, method, payload)
        assert code == want_code, (payload, got, want)
        assert set(got) == set(want), (payload, got, want)
        assert got.get('error') == want.get('error')
        if code == 200:
            assert [set(m) for m in got['matches']] \
                == [set(m) for m in want['matches']]
            assert set(got['quality']) == set(want['quality'])
            assert set(got['stages_ms']) <= set(SERVE_SPAN_NAMES)
            assert set(got['stages_ms']) == set(want['stages_ms'])
        if code == 400 and got['error'] == 'unknown-bucket':
            assert got['query'] == want['query']
            assert got['buckets'] == want['buckets']


def test_noise_free_fields_match_jax(service, jax_service):
    for seed in (20, 21, 22, 24):
        g = _query(seed)
        got = service.engine.match(g)
        want = jax_service.engine.match(g)
        assert got['_audit'] == want['_audit']
        assert [m['initial'][0] for m in got['matches']] \
            == [m['initial'][0] for m in want['matches']]
        np.testing.assert_allclose(
            [m['initial'][1] for m in got['matches']],
            [m['initial'][1] for m in want['matches']], rtol=1e-5)
        assert (got['bucket'], got['nodes']) \
            == (want['bucket'], want['nodes'])


def test_metric_family_names_match_jax(service, jax_service):
    q = query_payload(_query(20))
    post_match(service.port, q)
    post_match(jax_service.port, q)
    got = parse_exposition(get_json(service.port, '/metrics')[1])
    want = parse_exposition(get_json(jax_service.port, '/metrics')[1])
    assert set(got) == set(want)
    assert {n: f['type'] for n, f in got.items()} \
        == {n: f['type'] for n, f in want.items()}


def test_answers_equal_in_process_engine(root, service):
    """The HTTP answers are the in-process engine's over the same
    checkpoint, bit for bit."""
    model = _port_model()
    Checkpointer(str(root / 'ckpt')).restore(model)
    corpus = synthetic_corpus(**CORPUS)
    index, _ = load_or_build(None, model.psi_1, corpus, device='cpu')
    engine = MatchEngine(model, index,
                         QueryRouter('8x16', corpus.num_nodes,
                                     corpus.num_edges),
                         max_results=3, device='cpu')
    engine.warm()
    for seed in (30, 31, 32):
        g = _query(seed)
        want = engine.match(g)
        want.pop('_audit')
        code, got = post_match(service.port, query_payload(g))
        assert code == 200 and _strip(got) == want
