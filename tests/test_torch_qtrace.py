"""The port's per-query tracer, capacity model and goodput account against
the JAX package's (``dgmc_tpu/obs/{qtrace,capacity,goodput}.py``).

Each case runs one scenario of ``tests/obs/test_qtrace.py``,
``test_capacity.py`` or ``test_goodput.py`` through both packages on the
same inputs and requires the same result: sampling decisions and
minted ids, the kept sets, the reservoir, summaries and gap attribution,
the Chrome events, the live summary and the artifact analysis, exactly
(wall-clock stamps removed); the ``/metrics`` exposition text byte for
byte, and it parses under the strict parser of ``tests/obs/test_live``.
JAX's modules load through :func:`tests.torch_jax_worker.jax_worker`.
"""

import contextlib
import io
import json
import math
import os

import pytest

from dgmc_tpu_torch.obs import capacity, goodput, live, qtrace
from tests.obs.test_live import parse_exposition
from tests.torch_jax_worker import jax_worker


@pytest.fixture(scope='module')
def jax_mods():
    with jax_worker('dgmc_tpu.obs.qtrace', 'dgmc_tpu.obs.capacity',
                    'dgmc_tpu.obs.goodput', 'dgmc_tpu.obs.live') as mods:
        yield mods


PORT = {'qtrace': qtrace, 'capacity': capacity, 'goodput': goodput,
        'live': live}


def _strip_time(obj):
    """Drop wall-clock stamps (``time_unix``, Chrome ``ts``) recursively."""
    if isinstance(obj, dict):
        return {k: _strip_time(v) for k, v in obj.items()
                if k not in ('time_unix', 'ts')}
    if isinstance(obj, (list, tuple)):
        return [_strip_time(v) for v in obj]
    return obj


def _trace(tracer, total_s):
    trace = tracer.start()
    for name, start_s, dur_s in (('bucket_resolve', 0.0, 0.001),
                                 ('device_execute', 0.001, total_s * 0.8),
                                 ('serialize', 0.001 + total_s * 0.8,
                                  0.001)):
        trace.record(name, start_s, dur_s)
    return trace


def _load(tracer, n=60, error_every=None):
    """``n`` queries with totals (seq + 1) ms; every ``error_every``-th
    finishes as a 500."""
    records = []
    for i in range(n):
        is_err = error_every is not None and i % error_every == 0
        records.append(tracer.finish(
            _trace(tracer, (i + 1) * 1e-3), status=500 if is_err else 200,
            bucket='16x48', error='engine-fault' if is_err else None,
            total_s=(i + 1) * 1e-3))
    return records


def _kept(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- qtrace scenarios --------------------------------------------------------

def q_vocabulary(m, tmp):
    qt = m['qtrace']
    tracer = qt.QueryTracer(path=None)
    trace = tracer.start()
    errors = []
    for bad in ('made_up_stage', 'psi1'):
        try:
            trace.record(bad, 0.0, 0.001)
        except ValueError:
            errors.append(bad)
    return [qt.SERVE_SPAN_NAMES, qt.SERVE_SPAN_STAGES, errors,
            qt.QTRACE_LATENCY_BOUNDS]


def q_traceparent(m, tmp):
    qt = m['qtrace']
    tid, sid = 'ab' * 16, 'cd' * 8
    return [qt.parse_traceparent(h) for h in (
        f'00-{tid}-{sid}-01', None, '', 'garbage', f'00-{tid}-{sid}',
        f'00-{"0" * 32}-{sid}-01', f'00-{tid}-{"0" * 16}-01',
        f'00-{tid[:-2]}-{sid}-01', f'00-{tid.upper()}-{sid}-01')] + [
        qt.format_traceparent(tid, sid),
        qt.format_traceparent(tid, sid, sampled=False)]


def q_start(m, tmp):
    tracer = m['qtrace'].QueryTracer(path=None, seed=7)
    traces = [tracer.start(f'00-{"12" * 16}-{"34" * 8}-01'),
              tracer.start('not-a-traceparent'), tracer.start()]
    return [(t.trace_id, t.span_id, t.seq, t.parent_id,
             t.response_traceparent()) for t in traces]


def q_sampling(m, tmp):
    out = []
    for seed in (42, 43):
        path = os.path.join(tmp, f'{seed}', 'qtrace.jsonl')
        tracer = m['qtrace'].QueryTracer(
            path=path, sample_rate=0.3, slowest_k=4, capacity=16,
            error_capacity=8, seed=seed)
        _load(tracer, n=80, error_every=9)
        assert tracer.flush()
        out.append(_kept(path))
    return out


def q_reservoir(m, tmp):
    path = os.path.join(tmp, 'qtrace.jsonl')
    tracer = m['qtrace'].QueryTracer(path=path, sample_rate=0.0,
                                     slowest_k=5, capacity=64, seed=0)
    _load(tracer, n=40)
    tracer.flush()
    return _kept(path)


def q_errors(m, tmp):
    path = os.path.join(tmp, 'qtrace.jsonl')
    tracer = m['qtrace'].QueryTracer(path=path, sample_rate=0.0,
                                     slowest_k=0, capacity=0,
                                     error_capacity=10, seed=0)
    _load(tracer, n=30, error_every=1)
    tracer.flush()
    return [_kept(path), tracer.summary()]


def q_slo(m, tmp):
    breached = []
    tracer = m['qtrace'].QueryTracer(path=None, slo_s=0.010,
                                     on_breach=breached.append)
    _load(tracer, n=20)
    return [tracer.summary(), breached]


def q_summary(m, tmp):
    qt = m['qtrace']
    tracer = qt.QueryTracer(path=os.path.join(tmp, 'qtrace.jsonl'),
                            sample_rate=1.0, slowest_k=2, seed=0)
    _load(tracer, n=50)
    tracer.flush()
    with open(tracer.summary_path) as f:
        summary = json.load(f)
    records, loaded, _ = qt.load_records(tmp)
    pct = qt.stage_percentiles(records)
    return [summary, loaded, pct, qt.gap_attribution(pct)]


def q_chrome(m, tmp):
    qt = m['qtrace']
    tracer = qt.QueryTracer(path=None, sample_rate=1.0)
    records = [tracer.finish(_trace(tracer, 0.02), total_s=0.02)
               for _ in range(3)]
    return qt.chrome_trace_events(records)


def q_metrics(m, tmp):
    tracer = m['qtrace'].QueryTracer(path=None, sample_rate=1.0,
                                     slo_s=0.010)
    _load(tracer, n=20, error_every=7)
    return m['live'].prometheus_exposition(tracer.metric_families())


def q_report(m, tmp):
    qt = m['qtrace']
    obs = os.path.join(tmp, 'obs')
    tracer = qt.QueryTracer(path=os.path.join(obs, 'qtrace.jsonl'),
                            sample_rate=1.0, slowest_k=2, seed=0)
    _load(tracer, n=12, error_every=5)
    tracer.flush()
    outs = []
    for argv in ([obs, '--slowest', '2'], [obs, '--json'],
                 [os.path.join(tmp, 'nowhere')]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = qt.main(argv)
        text = buf.getvalue().replace(tmp, '<tmp>')
        outs.append((rc, json.loads(text) if '--json' in argv else text))
    for attempt, n in (('attempt_0', 3), ('attempt_1', 7)):
        t = qt.QueryTracer(path=os.path.join(tmp, 'sup', attempt,
                                             'qtrace.jsonl'),
                           sample_rate=1.0, seed=0)
        _load(t, n=n)
        t.flush()
    records, summary, resolved = qt.load_records(os.path.join(tmp, 'sup'))
    return [outs, len(records), summary, os.path.relpath(resolved, tmp)]


# -- capacity scenarios ------------------------------------------------------

def _cap_stats():
    hold = {'count': 10, 'sum': 0.5,
            'buckets': [(0.05, 8), (0.1, 10), (math.inf, 10)]}
    wait = {'count': 10, 'sum': 1.0,
            'buckets': [(0.1, 5), (0.2, 10), (math.inf, 10)]}
    return {'inflight': 1, 'queries': 11, 'window_s': 2.0,
            'lock_hold': hold, 'lock_wait': wait,
            'pad_fraction': 0.125, 'goodput_ratio': 0.875,
            'buckets': {'8x16': {'queries': 11}}}


def c_queueing(m, tmp):
    c = m['capacity']
    snap = {'count': 10, 'sum': 0.5,
            'buckets': [(0.01, 2), (0.05, 8), (0.1, 10), (math.inf, 10)]}
    return [c.saturation_qps(0.05), c.saturation_qps(0),
            c.utilization(10.0, 0.05), c.utilization(30.0, 0.05),
            c.utilization(None, 0.05), c.mm1_wait_s(10.0, 0.05),
            c.mm1_wait_s(16.0, 0.05), c.mm1_wait_s(20.0, 0.05),
            c.hist_mean_s(snap), c.hist_quantile_s(snap, 0.5),
            c.hist_quantile_s(snap, 0.95),
            c.hist_quantile_s({'count': 4, 'sum': 1.0,
                               'buckets': [(0.1, 1), (math.inf, 4)]}, 0.99),
            c.hist_quantile_s(None, 0.5)]


def c_knee(m, tmp):
    c = m['capacity']
    return [c.knee_of([{'clients': 1, 'qps': 10.0},
                       {'clients': 2, 'qps': 19.0},
                       {'clients': 4, 'qps': 20.0},
                       {'clients': 8, 'qps': 21.0}]),
            c.knee_of([{'clients': 4, 'qps': 40.0},
                       {'clients': 1, 'qps': 10.0},
                       {'clients': 2, 'qps': 20.0}]),
            c.knee_of([]),
            c.batching_headroom({'1': 100.0, '2': 60.0, '4': 40.0},
                                target_qps=15.0),
            c.batching_headroom({'1': 100.0}, target_qps=99.0),
            c.batching_headroom({})]


def c_live_summary(m, tmp):
    c = m['capacity']
    qt_summary = {'stages': {'admission_queue_wait':
                             {'count': 7, 'p95_ms': 180.0}}}
    return [c.live_summary(_cap_stats()),
            c.live_summary(_cap_stats(), qt_summary)]


def c_analyze(m, tmp):
    c = m['capacity']
    record = {
        'ramp': {'levels': [{'clients': 1, 'qps': 10.0, 'p50_ms': 90.0,
                             'p95_ms': 100.0},
                            {'clients': 2, 'qps': 10.5, 'p50_ms': 170.0,
                             'p95_ms': 200.0}]},
        'capacity': {'saturation_qps': 12.0, 'utilization': 0.9},
        'goodput': {'serve': {'goodput_ratio': 0.97}},
        'result': {'sparse_dbp15k': {'pairs_sweep': {
            '1': {'step_ms_per_pair': 100.0},
            '4': {'step_ms_per_pair': 40.0}}}},
    }
    path = os.path.join(tmp, 'round.json')
    with open(path, 'w') as f:
        json.dump(record, f)
    obs = os.path.join(tmp, 'obs')
    os.makedirs(obs)
    with open(os.path.join(obs, 'qtrace_summary.json'), 'w') as f:
        json.dump({'end_to_end': {'count': 4, 'sum_ms': 200.0}}, f)
    with open(os.path.join(obs, 'goodput.json'), 'w') as f:
        json.dump({'goodput_ratio': 0.9, 'pad_fraction_max': 0.2}, f)
    reports = [c.analyze_paths([path], target_qps=20.0),
               c.analyze_paths([obs])]
    out = [json.loads(json.dumps(r).replace(tmp, '<tmp>'))
           for r in reports]
    out += [c.render(r).replace(tmp, '<tmp>') for r in reports]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = c.main([path, '--json'])
    return out + [rc, buf.getvalue().replace(tmp, '<tmp>')]


# -- goodput scenarios -------------------------------------------------------

def g_fills(m, tmp):
    g = m['goodput']
    side = {'nodes_real': 6, 'nodes_padded': 8, 'edges_real': 10,
            'edges_padded': 16}
    corpus = {'nodes_real': 256, 'nodes_padded': 256, 'edges_real': 1024,
              'edges_padded': 1024}
    fills = g.pair_fills(side, corpus)
    stages = {'psi1': {'flops': 100}, 'topk': {'flops': 300},
              'consensus_iter': {'flops': 600}, 'optimizer': {'flops': 50},
              'mystery': {'flops': 10}, 'empty': {'flops': 0}}
    return [[g.fill_fraction(*a) for a in ((3, 4), (5, 4), (1, 0),
                                           (None, 4), (float('nan'), 4))],
            side, fills, g.goodput_ratio(fills), g.goodput_ratio(fills,
                                                                 stages),
            g.goodput_ratio({'nodes': None, 'edges': None, 'corr': None}),
            g.STAGE_AXES]


def g_rows(m, tmp):
    g = m['goodput']
    rows = [{'batch': 4, 'nodes': '16x20', 'edges': '48x60', 'count': 3},
            {'batch': 1, 'nodes': '32x40', 'edges': '96x120', 'count': 2},
            {'batch': 2, 'nodes': '8x8', 'edges': '16x16', 'count': 1}]
    real = []
    for axis, vals in (('nodes_s', (150, 50)), ('nodes_t', (200, 70)),
                       ('edges_s', (400, 150)), ('edges_t', (500, 200))):
        for row, v in zip(rows[:2], vals):
            real.append({'batch': row['batch'], 'nodes': row['nodes'],
                         'edges': row['edges'], 'axis': axis, 'count': v})
    return [g.merge_real_rows(rows, real), g.merge_real_rows(rows, []),
            g.merge_real_rows([], real)]


CASES = {
    'qtrace-vocabulary': q_vocabulary,
    'qtrace-traceparent': q_traceparent,
    'qtrace-start-adopts-or-mints': q_start,
    'qtrace-sampling-deterministic': q_sampling,
    'qtrace-slowest-k-reservoir': q_reservoir,
    'qtrace-errors-ring': q_errors,
    'qtrace-slo-breach-hook': q_slo,
    'qtrace-summary-gap-attribution': q_summary,
    'qtrace-chrome-events': q_chrome,
    'qtrace-report-cli': q_report,
    'capacity-queueing-math': c_queueing,
    'capacity-knee-and-headroom': c_knee,
    'capacity-live-summary': c_live_summary,
    'capacity-analyze-paths': c_analyze,
    'goodput-fills-and-ratio': g_fills,
    'goodput-merge-real-rows': g_rows,
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_matches_jax(case, jax_mods, tmp_path):
    fn = CASES[case]
    os.makedirs(tmp_path / 'port')
    os.makedirs(tmp_path / 'jax')
    got = fn(PORT, str(tmp_path / 'port'))
    want = fn(jax_mods, str(tmp_path / 'jax'))
    assert _strip_time(json.loads(json.dumps(got))) \
        == _strip_time(json.loads(json.dumps(want)))


def test_metric_families_exposition_matches_jax(jax_mods):
    got = q_metrics(PORT, None)
    want = q_metrics(jax_mods, None)
    assert got == want
    families = parse_exposition(got)
    counts = {s[1]['stage']: s[2]
              for s in families['dgmc_query_stage_seconds']['samples']
              if s[0].endswith('_count')}
    assert set(counts) == set(qtrace.SERVE_SPAN_NAMES)
    assert counts['device_execute'] == 20 and counts['shortlist_merge'] == 0
    kept = {s[1]['reason']: s[2]
            for s in families['dgmc_qtrace_kept_total']['samples']}
    assert kept['error'] == 3
    assert families['dgmc_qtrace_slo_breaches_total']['samples'][0][2] == 10


def test_span_vocabulary_is_pinned():
    tracer = qtrace.QueryTracer(path=None)
    trace = tracer.start()
    with pytest.raises(ValueError, match='unknown serve span'):
        with trace.span('made_up_stage'):
            pass
    assert set(qtrace.SERVE_SPAN_STAGES) == set(qtrace.SERVE_SPAN_NAMES)
    assert live.prometheus_exposition(
        tracer.metric_families()).endswith('\n')
