"""The port's run plane held against the JAX package's, on the CPU.

The live plane (``obs/live.py``: the exposition, the streaming
histogram, the flight recorder, the HTTP server), the watchdog, the SLO,
anomaly and quality planes, the Chrome-trace events and the probe
helpers, each driven by the same input in both packages, and the port's
own pieces: the dispatch feed and compile events of the registry, the
probe tape, and a train step's probe series (dense and sparse DGMC on
converted weights, JAX's own noise and negatives) against JAX's.

Tolerances: the copied modules' outputs are equal (JSON-equal payloads,
byte-equal exposition); the probe helpers within rtol 1e-6 of JAX's; a
train step's probe values within rtol 1e-5 (atol 1e-6 where the value
is near 0), its names, metadata and counts equal.
"""

import collections
import json
import math
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.obs import anomaly as j_anomaly
from dgmc_tpu.obs import live as j_live
from dgmc_tpu.obs import probes as j_probes
from dgmc_tpu.obs import quality as j_quality
from dgmc_tpu.obs import slo as j_slo
from dgmc_tpu.obs import watchdog as j_watchdog
from dgmc_tpu.obs.trace import chrome_events as j_chrome_events
from dgmc_tpu_torch.obs import anomaly, live, probes, quality, registry, slo
from dgmc_tpu_torch.obs import watchdog
from dgmc_tpu_torch.obs.trace import chrome_events, parse_step_window
from dgmc_tpu_torch.ops.kernels import dispatch


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the exposition and the streaming histogram ----------------------------

def _families(mod):
    h = mod.StreamingHistogram()
    for v in (0.0004, 0.0015, 0.003, 0.003, 0.7, 12.0, 5000.0):
        h.observe(v)
    return [
        ('dgmc_up', 'gauge', 'Run observer alive.', [('', {}, 1)]),
        ('dgmc weird-name', 'counter', 'help with \\ and\nnewline',
         [('', {'label': 'a"b\\c\nd', 'bad-key': 3}, 2.5),
          ('', {}, float('nan')), ('', {}, float('inf')),
          ('', {}, True)]),
        mod.histogram_family('dgmc_step_latency_seconds', 'Latency.',
                             h.snapshot()),
    ], h


def test_prometheus_exposition_is_byte_equal_to_jax():
    ours, h = _families(live)
    theirs, jh = _families(j_live)
    assert live.prometheus_exposition(ours) == \
        j_live.prometheus_exposition(theirs)
    assert h.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.95, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert live.DEFAULT_LATENCY_BOUNDS == j_live.DEFAULT_LATENCY_BOUNDS
    assert live.STALE_AFTER_FACTOR == j_live.STALE_AFTER_FACTOR
    assert live.StreamingHistogram().quantile(0.5) is None


def _strip(payload, keys=('time', 'pid', 'argv')):
    if isinstance(payload, dict):
        return {k: _strip(v, keys) for k, v in payload.items()
                if k not in keys}
    if isinstance(payload, list):
        return [_strip(v, keys) for v in payload]
    return payload


def test_flight_recorder_dump_schema_equals_jax(tmp_path):
    dumps = []
    for mod, name in ((live, 'port'), (j_live, 'jax')):
        fr = mod.FlightRecorder(str(tmp_path / f'{name}.json'), capacity=3)
        for i in range(5):
            fr.record('probe', name='grad_norm', value=float(i), step=i)
        fr.record('probe', name='loss', value=float('nan'))
        path = fr.dump('guard-rollback', extra={'consec_bad': 2})
        with open(path) as f:
            dumps.append(json.load(f))
        assert fr.counters() == {'events_seen': 6, 'events_recorded': 3,
                                 'events_truncated': 3, 'dumps': 1}
    assert _strip(dumps[0]) == _strip(dumps[1])
    assert dumps[0]['events'][-1]['value'] is None


# -- the HTTP plane ------------------------------------------------------------

def _get(port, path, data=None):
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_telemetry_server_endpoints_and_routes():
    state = {'healthy': True}

    def match(method, body):
        return 200, {'method': method, 'got': body.decode()}

    def match_headers(method, body, headers):
        return 201, {'trace': headers.get('x-trace')}, {'X-Echo': 'y'}

    srv = live.TelemetryServer(
        0, health_fn=lambda: dict(state), metrics_fn=lambda: 'dgmc_up 1\n',
        status_fn=lambda: {'steps': {}}, host='127.0.0.1',
        routes={'/match': match, '/h': match_headers}).start()
    try:
        assert _get(srv.port, '/healthz')[0] == 200
        state['healthy'] = False
        code, body = _get(srv.port, '/healthz')
        assert code == 503 and json.loads(body)['healthy'] is False
        assert _get(srv.port, '/metrics') == (200, 'dgmc_up 1\n')
        assert json.loads(_get(srv.port, '/status')[1]) == {'steps': {}}
        code, body = _get(srv.port, '/nope')
        assert code == 404 and '/match' in json.loads(body)['endpoints']
        code, body = _get(srv.port, '/match', data=b'q')
        assert code == 200 and json.loads(body) == {'method': 'POST',
                                                     'got': 'q'}
        req = urllib.request.Request(f'http://127.0.0.1:{srv.port}/h',
                                     headers={'X-Trace': 't1'})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201 and r.headers['X-Echo'] == 'y'
            assert json.loads(r.read()) == {'trace': 't1'}
        assert live.probe_healthz(srv.port)[0] == 503
    finally:
        srv.close()
    assert live.probe_healthz(srv.port, timeout_s=0.5) is None


# -- the watchdog ----------------------------------------------------------------

def _read(path):
    with open(path) as f:
        return json.load(f)


def test_watchdog_reports_equal_jax_keys(tmp_path):
    reports = {}
    for mod, name in ((watchdog, 'port'), (j_watchdog, 'jax')):
        d = tmp_path / name
        d.mkdir()
        dumped = threading.Event()
        wd = mod.Watchdog(str(d / 'hang_report.json'), deadline_s=0.2,
                          context_fn=lambda: {'steps_completed': 3},
                          heartbeat_path=str(d / 'heartbeat.json'),
                          advertise={'port': 1234, 'host': 'h'},
                          on_dump=lambda reason: dumped.set()).start()
        try:
            wd.beat('step', 3)
            assert dumped.wait(5.0)
            time.sleep(0.15)   # one more poll: a heartbeat with context
        finally:
            wd.close()
        reports[name] = (_read(d / 'hang_report.json'),
                         _read(d / 'heartbeat.json'))
    (rep, beat), (jrep, jbeat) = reports['port'], reports['jax']
    assert rep.keys() == jrep.keys()
    assert beat.keys() == jbeat.keys()
    assert rep['reason'] == 'deadline' and rep['in_flight']['name'] == 3
    assert rep['in_flight'].keys() == jrep['in_flight'].keys()
    assert rep['context'] == jrep['context'] == {'steps_completed': 3}
    assert beat['port'] == 1234 and beat['steps_completed'] == 3
    assert any(t['name'] == 'MainThread' for t in rep['threads'])


def test_watchdog_signal_dump_chains_to_previous_handler(tmp_path):
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    path = str(tmp_path / 'hang_report.json')
    wd = watchdog.Watchdog(path, deadline_s=None,
                           signals=(signal.SIGTERM,)).start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
        assert _read(path)['reason'] == 'signal:SIGTERM'
    finally:
        wd.close()
        signal.signal(signal.SIGTERM, prev)


# -- the SLO, anomaly and quality planes ------------------------------------------

SLO_SPEC = {'name': 'train', 'window_s': 60.0, 'bucket_s': 1.0,
            'availability': {'objective': 0.9},
            'latency': [{'name': 'step', 'threshold_ms': 50.0,
                         'objective': 0.8}],
            'burn_windows': {'fast': {'long_s': 30.0, 'short_s': 5.0,
                                      'threshold': 2.0}},
            'hits1_floor': 0.5}


def _slo_run(mod):
    clock = [1000.0]
    breaches = []
    tr = mod.SloTracker(mod.SloSpec(SLO_SPEC), time_fn=lambda: clock[0],
                        on_breach=lambda k, d: breaches.append(k))
    for i in range(40):
        clock[0] += 0.5
        tr.record(i % 7 != 0, latency_s=0.01 * (i % 9))
    tr.update_gauges(hits1=0.25, goodput=None)
    return tr.snapshot(), tr.metric_families(), breaches


def test_slo_tracker_snapshot_equals_jax():
    ours, theirs = _slo_run(slo), _slo_run(j_slo)
    assert ours == theirs
    assert ours[2]   # the floor and the budgets breached
    with pytest.raises(ValueError):
        slo.SloSpec({'name': 'x'})


def _anomaly_run(mod):
    clock = [0.0]
    fired = []
    w = mod.AnomalyWatch(capacity=1, time_fn=lambda: clock[0],
                         on_anomaly=fired.append)
    for i, v in enumerate([1.0] * 20 + [9.0] + [1.0] * 5 + [3.0] * 30):
        clock[0] += 1.0
        w.observe('step_latency_s', v)
        w.observe('compile_events', 0 if i != 40 else 3)
    return w.snapshot(), w.counters(), w.metric_families(), fired


def test_anomaly_watch_snapshot_equals_jax():
    ours, theirs = _anomaly_run(anomaly), _anomaly_run(j_anomaly)
    assert ours == theirs
    assert ours[0]['truncated'] > 0 and ours[3]


def _quality_run(mod):
    q = mod.QualityTracker()
    q.observe_eval('dbp15k', {'count': 100, 'loss': 2.0, 'hits1': 0.3,
                              'hits10': 0.6}, step=10)
    q.observe_eval('dbp15k', {'count': 100, 'loss': 1.5, 'hits1': 0.25,
                              'hits10': float('nan')}, step=11)
    for it, v in enumerate((1.0, 0.5, 0.04, 0.01)):
        q.observe_consensus(it, v)
    q.observe_query({'entropy': 1.2, 'margin': 0.3, 'correction': 0.01,
                     'saturation': 0.0, 'saturated_frac': 0.5})
    q.record_low_confidence()
    q.set_audit_params(0.5, 7)
    q.observe_audit('t1', 0.9, False)
    return q.payload(), q.metric_families(), [
        mod.audit_keep(7, f't{i}', 0.5) for i in range(20)]


def test_quality_tracker_snapshot_equals_jax():
    ours, theirs = _quality_run(quality), _quality_run(j_quality)
    assert ours == theirs
    assert ours[0]['consensus']['converged_at'] == 2


def test_chrome_events_equal_jax():
    kw = dict(
        step_spans=[(100.0, 0.5), (100.6, 0.25)],
        probe_records=[
            {'probe': 'corr_entropy', 'value': 1.5, 'time': 100.1,
             'stage': 'S0'},
            {'probe': 'nonfinite', 'value': 1.0, 'time': 100.2,
             'stage': 'grad', 'order': 1001},
            {'probe': 'nonfinite', 'value': 0.0, 'time': 100.2,
             'stage': 'psi1', 'order': 0},
            {'probe': 'grad_norm', 'value': float('nan'), 'time': 100.3}],
        compile_events=[{'time': 100.05, 'duration_s': 0.04,
                         'kind': 'capture', 'label': 'phase1'}],
        sections=[('eval', 100.9, 0.1)],
        device_fences=[(101.0, {'0': 0.3})])
    assert chrome_events(**kw) == j_chrome_events(**kw)
    assert chrome_events() == []


def test_parse_step_window():
    assert parse_step_window(' 2:5 ') == (2, 5)
    for bad in ('5:2', '3:3', 'a:b', '1-2'):
        with pytest.raises(ValueError):
            parse_step_window(bad)


# -- the probe helpers -------------------------------------------------------------

def test_probe_helpers_match_jax():
    r = np.random.RandomState(0)
    S = r.rand(2, 7, 9).astype(np.float32)
    S[:, :, 3] = 0.0
    S /= S.sum(-1, keepdims=True)
    S2 = S + 0.01 * r.randn(*S.shape).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 1, 1, 0], [1] * 7], bool)
    ts, ts2, tm = map(torch.from_numpy, (S, S2, mask))
    for m in (None, mask):
        tmask = None if m is None else tm
        np.testing.assert_allclose(
            float(probes.entropy(ts, tmask)),
            float(j_probes.entropy(jnp.asarray(S), m)), rtol=1e-6)
        for k in (1, 4, 20):
            np.testing.assert_allclose(
                float(probes.topk_mass(ts, k, tmask)),
                float(j_probes.topk_mass(jnp.asarray(S), k, m)), rtol=1e-6)
        np.testing.assert_allclose(
            float(probes.delta_norm(ts2, ts, tmask)),
            float(j_probes.delta_norm(jnp.asarray(S2), jnp.asarray(S), m)),
            rtol=1e-6)
    grads = [torch.randn(3, 4), torch.randn(5)]
    np.testing.assert_allclose(
        float(probes.global_norm(grads)),
        math.sqrt(sum(float((g * g).sum()) for g in grads)), rtol=1e-6)


# -- the probe tape ------------------------------------------------------------------

def test_probes_off_record_nothing_and_skip_thunks():
    assert not probes.enabled()
    called = []
    with probes.recording() as rec:
        probes.emit('x', lambda: called.append(1) or torch.ones(()))
        probes.check_finite('psi1', torch.ones(3))
    assert rec is None and called == []
    assert probes.take({'loss': 1}) == {'loss': 1}


def test_probe_tape_records_in_order_and_tags_steps():
    log = probes.ProbeLog()
    tags = []

    def sink(rec):
        log(rec)
        tags.append(probes.delivering_step())

    with probes.activated(sink):
        probes.set_step(4)
        with probes.recording() as rec:
            probes.emit('grad_norm', torch.tensor(2.5, dtype=torch.float64))
            probes.check_finite('loss', torch.tensor(float('nan')),
                                order=1000)
            probes.emit('corr_entropy', lambda: torch.tensor([0.5]),
                        stage='S0')
        tape = rec.tape()
        assert tape.values.dtype == torch.float32
        assert [n for n, _ in tape.layout] == ['grad_norm', 'nonfinite',
                                               'corr_entropy']
        out = probes.take({'loss': 1.0, probes.PROBE_KEY: tape})
        probes.set_step(None)
        probes.emit('outside', 3.0)    # no tape: delivered at once
    assert out == {'loss': 1.0}
    assert [(r['probe'], r['value']) for r in log.records] == [
        ('grad_norm', 2.5), ('nonfinite', 1.0), ('corr_entropy', 0.5),
        ('outside', 3.0)]
    assert log.records[1]['stage'] == 'loss'
    assert log.records[1]['order'] == 1000
    assert tags == [4, 4, 4, None]
    assert not probes.enabled() and probes.pending() == 0


# -- the registry: the dispatch feed and compile events --------------------------

def _dispatch_count(kernel, outcome, reason):
    return registry.REGISTRY.counter_value(
        registry.DISPATCH_COUNTER, kernel=kernel, outcome=outcome,
        reason=reason)


def test_dispatch_ledger_feeds_the_registry_per_executed_call():
    seen = []
    sink = lambda *a: seen.append(a)   # noqa: E731
    registry.add_dispatch_sink(sink)
    try:
        base = _dispatch_count('obs_test_gate', 'kernel', 'cuda')
        dispatch.record('obs_test_gate', 'kernel', 'cuda')
        assert _dispatch_count('obs_test_gate', 'kernel', 'cuda') == base + 1
        with dispatch.quiet():       # a capture's warm-up and capture
            dispatch.record('obs_test_gate', 'kernel', 'cuda')
        assert _dispatch_count('obs_test_gate', 'kernel', 'cuda') == base + 1
        recorded = {'obs_test_gate': {
            'path': 'kernel', 'reason': 'cuda', 'dtype': 'float32',
            'counts': {'kernel': 3, 'plain': 0},
            'dtypes': {'kernel:float32': 3}}}
        for _ in range(2):           # two replays of a capture
            dispatch.replay({}, recorded)
        assert _dispatch_count('obs_test_gate', 'kernel', 'cuda') == base + 7
        rows = [r for r in registry.dispatch_table()
                if r['kernel'] == 'obs_test_gate']
        assert rows == [{'kernel': 'obs_test_gate', 'outcome': 'kernel',
                         'reason': 'cuda', 'count': base + 7}]
    finally:
        registry.remove_dispatch_sink(sink)
    assert seen.count(('obs_test_gate', 'kernel', 'cuda')) == 3


def test_compiled_records_one_compile_event_per_signature():
    from dgmc_tpu_torch.train.compiled import compiled
    step = compiled(lambda x: {'y': x * 2}, 'cpu')
    with registry.CompileWatcher() as w:
        with w.label('phase1'):
            step(torch.ones(3))
            step(torch.ones(3))      # the same signature: no event
        with w.label('phase2'):
            step(torch.ones(4))
        registry.record_compile('nvcc', 1.5)
    summ = w.summary()
    assert summ['events'] == 3 and summ['cache_hits'] == 0
    assert {k: v['events'] for k, v in summ['by_label'].items()} == {
        'phase1': 1, 'phase2': 1, 'run': 1}
    assert [e['kind'] for e in w.events] == ['capture', 'capture', 'nvcc']


# -- a train step's probe series against JAX's ------------------------------------

def _side(rng, n, e, c=4, nan=False):
    x = rng.randn(1, n, c).astype(np.float32)
    if nan:
        x[0, 0, 0] = np.nan
    return {'x': x,
            'senders': rng.randint(0, n, (1, e)).astype(np.int32),
            'receivers': rng.randint(0, n, (1, e)).astype(np.int32),
            'node_mask': np.ones((1, n), bool),
            'edge_mask': np.ones((1, e), bool)}


def _pair(nan=False):
    """``tests/obs/test_probes.py``'s fixture: 8 / 10 nodes, 4 channels."""
    rng = np.random.RandomState(0)
    return (_side(rng, 8, 16, nan=nan), _side(rng, 10, 20),
            (np.arange(8, dtype=np.int32) % 10)[None],
            np.ones((1, 8), bool))


def _jax_series(k, num_steps=2):
    """JAX's train step under probes (its ProbeLog records), its initial
    parameters, and the noise and negatives its key draws."""
    from dgmc_tpu.models import DGMC as JDGMC
    from dgmc_tpu.models import RelCNN as JRelCNN
    from dgmc_tpu.ops.graph import GraphBatch as JGraphBatch
    from dgmc_tpu.train import create_train_state, make_train_step
    from dgmc_tpu.utils.data import PairBatch as JPairBatch
    s, t, y, y_mask = _pair()

    def jgraph(a):
        return JGraphBatch(**{k_: jnp.asarray(v) for k_, v in a.items()},
                           edge_attr=None)

    batch = JPairBatch(s=jgraph(s), t=jgraph(t), y=jnp.asarray(y),
                       y_mask=jnp.asarray(y_mask))
    model = JDGMC(JRelCNN(4, 8, num_layers=1), JRelCNN(4, 4, num_layers=1),
                  num_steps=num_steps, k=k)
    state = create_train_state(model, jax.random.key(0), batch,
                               learning_rate=1e-3)
    params = jax.device_get(state.params)
    key = jax.random.key(1)
    k_noise, k_neg, _ = jax.random.split(key, 3)
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        _, S_L = model.apply({'params': params}, batch.s, batch.t,
                             y=batch.y, y_mask=batch.y_mask, train=True,
                             rngs={'noise': k_noise, 'negatives': k_neg})
    R = 4
    if seen[0].shape[-1] == num_steps * R:      # the packed source side
        r_s = seen[0].reshape(1, 8, num_steps, R).transpose(2, 0, 1, 3)
    else:
        r_s = np.stack(seen[0::2])
    negatives = None if k < 1 else np.asarray(S_L.idx)[..., k:]
    log = j_probes.ProbeLog()
    with j_probes.activated(log):
        _, out = make_train_step(model)(state, batch, key)
        jax.block_until_ready(out['loss'])
        jax.effects_barrier()
    return log.records, params, r_s, negatives


def _port_series(k, params, r_s, negatives, jit, num_steps=2, nan=False):
    from dgmc_tpu_torch.convert import dgmc_from_flax
    from dgmc_tpu_torch.models import DGMC, RelCNN
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    from dgmc_tpu_torch.utils.data import PairBatch
    s, t, y, y_mask = _pair(nan=nan)
    model = DGMC(RelCNN(4, 8, 1), RelCNN(4, 4, 1), num_steps=num_steps,
                 k=k)
    model.load_state_dict(dgmc_from_flax(params))
    state = create_train_state(model, learning_rate=1e-3)
    log = probes.ProbeLog()
    with probes.activated(log):
        _, out = make_train_step(model, jit=jit)(
            state, PairBatch(s=s, t=t, y=y, y_mask=y_mask), 1,
            r_s=torch.from_numpy(np.ascontiguousarray(r_s)),
            negatives=(None if negatives is None
                       else torch.from_numpy(np.array(negatives)).long()))
    assert probes.PROBE_KEY not in out
    return log.records


def _key(rec):
    return (rec['probe'], str(rec.get('stage')), rec.get('iteration', -1),
            rec.get('order', -1))


def _meta(rec):
    return {k: v for k, v in rec.items() if k not in ('value', 'time')}


@pytest.mark.parametrize('k', [-1, 3], ids=['dense', 'sparse'])
def test_train_step_probe_series_matches_jax(k):
    want, params, r_s, negatives = _jax_series(k)
    for jit in (False, True):
        got = _port_series(k, params, r_s, negatives, jit)
        names = collections.Counter(r['probe'] for r in got)
        assert names == collections.Counter(r['probe'] for r in want)
        assert names == {'corr_entropy': 4, 'topk_mass': 2,
                         'consensus_delta': 2, 'grad_norm': 1,
                         'nonfinite': 6}
        got, exp = sorted(got, key=_key), sorted(want, key=_key)
        assert [_meta(r) for r in got] == [_meta(r) for r in exp]
        for a, b in zip(got, exp):
            np.testing.assert_allclose(a['value'], b['value'], rtol=1e-5,
                                       atol=1e-6, err_msg=str(_meta(a)))


def test_eval_step_emits_no_probes():
    from dgmc_tpu_torch.models import DGMC, RelCNN
    from dgmc_tpu_torch.train.steps import make_eval_step
    from dgmc_tpu_torch.utils.data import PairBatch
    s, t, y, y_mask = _pair()
    model = DGMC(RelCNN(4, 8, 1), RelCNN(4, 4, 1), num_steps=2, k=3,
                 generator=torch.Generator().manual_seed(0))
    log = probes.ProbeLog()
    with probes.activated(log):
        out = make_eval_step(model)(PairBatch(s=s, t=t, y=y, y_mask=y_mask),
                                    1)
    assert log.records == [] and probes.PROBE_KEY not in out
