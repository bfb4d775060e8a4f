"""Per-query tracing and tail-latency attribution for the serve path.

The port's copy of the JAX package's ``dgmc_tpu/obs/qtrace.py``. Every
``/match`` request carries a trace id — adopted from a W3C
``traceparent`` header or minted deterministically from the worker seed
— and decomposes into the fixed span vocabulary
:data:`SERVE_SPAN_NAMES` (``admission_queue_wait``, ``bucket_resolve``,
``pad_and_stage``, ``device_execute``, ``shortlist_merge``,
``consensus_rerank``, ``serialize``); :data:`SERVE_SPAN_STAGES` maps the
spans that wrap device work onto the model stages.
:meth:`QueryTrace.span` rejects names outside the vocabulary.

Retention is deterministic and bounded:

- **slowest-K reservoir** — the K slowest queries are always kept
  (min-heap on total latency);
- **every error** — kept in its own bounded ring with a truncation
  counter;
- **deterministic sample** of the rest — keep iff
  ``hash(seed, trace_id) < sample_rate``: a fixed seed replays to an
  identical kept-set.

Kept span trees land in a bounded ``qtrace.jsonl`` (rewritten atomically
from the in-memory rings) next to ``qtrace_summary.json``, the
full-population per-stage :class:`~dgmc_tpu_torch.obs.live.
StreamingHistogram` account. The same histograms export through
``/metrics`` (``dgmc_query_stage_seconds{stage=...}``), and an optional
SLO hook hands breaching span trees to the flight recorder.

``python -m dgmc_tpu_torch.obs.qtrace <obs-dir>`` renders the report:
per-stage p50/p95/p99 and the p95−p50 gap attributed to a named dominant
stage, plus Chrome trace-event export (:func:`chrome_trace_events`).
Touches no device: the report runs on any host.
"""

import argparse
import collections
import hashlib
import heapq
import json
import math
import os
import re
import threading
import time
from contextlib import contextmanager

from dgmc_tpu_torch.obs.live import StreamingHistogram, histogram_family
from dgmc_tpu_torch.obs.observe import percentile
from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['QueryTrace', 'QueryTracer', 'parse_traceparent',
           'format_traceparent', 'chrome_trace_events', 'load_records',
           'stage_percentiles', 'gap_attribution', 'render_report',
           'main', 'SERVE_SPAN_NAMES', 'SERVE_SPAN_STAGES',
           'QTRACE_LATENCY_BOUNDS']

#: Per-stage latency histogram bounds (seconds): ×1.25 rungs from
#: 0.1 ms to ~130 s. Serve spans live in the sub-ms..second range the
#: 2× step ladder (``DEFAULT_LATENCY_BOUNDS``) is too coarse for — a
#: p95−p50 gap attribution needs quantile error bounded by 25 %, not
#: 100 %.
QTRACE_LATENCY_BOUNDS = tuple(0.0001 * 1.25 ** i for i in range(64))

#: The serve span vocabulary: the fixed per-query spans a ``/match``
#: request decomposes into, in pipeline order (the JAX package keeps it
#: in ``dgmc_tpu/analysis/hlo_comm.py``; this is the port's copy).
SERVE_SPAN_NAMES = ('admission_queue_wait', 'bucket_resolve',
                    'pad_and_stage', 'device_execute', 'shortlist_merge',
                    'consensus_rerank', 'serialize')

#: The model stages each serve span covers. Host-only spans (queueing,
#: routing, padding, JSON) map to the empty tuple. ``device_execute`` is
#: the whole query on the device tier; the offload tier splits the
#: candidate gather (``shortlist_merge``) and the rerank
#: (``consensus_rerank``) from it.
SERVE_SPAN_STAGES = {
    'admission_queue_wait': (),
    'bucket_resolve': (),
    'pad_and_stage': (),
    'device_execute': ('psi1', 'initial_corr', 'topk'),
    'shortlist_merge': ('topk',),
    'consensus_rerank': ('consensus_iter', 'psi2'),
    'serialize': (),
}

_TRACEPARENT = re.compile(
    r'^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$')


def parse_traceparent(header):
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header;
    ``None`` when absent or malformed. A bad header mints a fresh trace
    instead of failing the query — trace plumbing must never cost a
    match answer."""
    if not header:
        return None
    m = _TRACEPARENT.match(str(header).strip().lower())
    if not m or m.group(2) == '0' * 32 or m.group(3) == '0' * 16:
        return None
    return m.group(2), m.group(3)


def format_traceparent(trace_id, span_id, sampled=True):
    """Render the W3C header the service echoes back (version 00)."""
    return f'00-{trace_id}-{span_id}-{"01" if sampled else "00"}'


class QueryTrace:
    """One in-flight query's span tree.

    Spans are recorded flat as ``(name, start_s, dur_s)`` relative to
    the trace start; the tree structure is the fixed pipeline order of
    :data:`SERVE_SPAN_NAMES` under one root, so a flat list loses
    nothing. Names outside the vocabulary raise — the no-third-dialect
    pin, enforced at record time.
    """

    def __init__(self, trace_id, span_id, seq, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.seq = int(seq)
        self.parent_id = parent_id
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        self.spans = []
        self.total_s = None

    @contextmanager
    def span(self, name):
        """Time one serve stage; records even when the body raises (an
        error trace with its partial span tree is exactly the trace
        worth keeping)."""
        if name not in SERVE_SPAN_STAGES:
            raise ValueError(
                f'unknown serve span {name!r}; the vocabulary is '
                f'{SERVE_SPAN_NAMES}')
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0 - self._t0,
                               time.perf_counter() - t0))

    def record(self, name, start_s, dur_s):
        """Append one pre-timed span (manual instrumentation and the
        determinism tests; same vocabulary pin as :meth:`span`)."""
        if name not in SERVE_SPAN_STAGES:
            raise ValueError(
                f'unknown serve span {name!r}; the vocabulary is '
                f'{SERVE_SPAN_NAMES}')
        self.spans.append((name, float(start_s), float(dur_s)))

    def close(self, total_s=None):
        """Stop the end-to-end clock (idempotent; ``total_s`` overrides
        the wall measurement — the tests' synthetic-latency hook)."""
        if total_s is not None:
            self.total_s = float(total_s)
        elif self.total_s is None:
            self.total_s = time.perf_counter() - self._t0
        return self.total_s

    def stage_ms(self):
        """Per-span-name total milliseconds (a name instrumented twice
        — e.g. host pad + device staging both under ``pad_and_stage`` —
        sums), the ``stages_ms`` payload field clients read."""
        out = {}
        for name, _start, dur in self.spans:
            out[name] = out.get(name, 0.0) + dur * 1e3
        return {k: round(v, 4) for k, v in out.items()}

    def response_traceparent(self):
        return format_traceparent(self.trace_id, self.span_id)


class QueryTracer:
    """Bounded, deterministic per-query trace retention for one worker.

    Args:
        path: ``qtrace.jsonl`` destination (``None`` disables the file
            tier; histograms and counters still run). The summary lands
            beside it as ``qtrace_summary.json``.
        sample_rate: keep fraction for non-error, non-reservoir traces,
            decided by ``hash(seed, trace_id)`` — deterministic, not
            ``random()``.
        slowest_k: always-keep reservoir size (min-heap on total
            latency).
        capacity: sampled-ring bound; with the error ring and the
            reservoir this bounds ``qtrace.jsonl`` at
            ``capacity + error_capacity + slowest_k`` records.
        error_capacity: error-ring bound. Errors are never *sampled*
            out; past the bound the OLDEST are evicted and counted
            (``errors_truncated``), never silently.
        seed: the worker seed — trace-id minting and sampling both
            derive from it, so a fixed seed replays an identical
            kept-set.
        slo_s: end-to-end SLO; a breaching query fires ``on_breach``
            with its record (the service wires this to a flight-
            recorder dump carrying the offending span tree).
    """

    def __init__(self, path=None, sample_rate=0.05, slowest_k=8,
                 capacity=256, error_capacity=256, seed=0, slo_s=None,
                 on_breach=None, bounds=QTRACE_LATENCY_BOUNDS,
                 flush_interval_s=1.0):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(f'sample_rate must be in [0, 1]: '
                             f'{sample_rate}')
        self.path = path
        self.sample_rate = float(sample_rate)
        self.slowest_k = max(0, int(slowest_k))
        self.capacity = max(0, int(capacity))
        self.error_capacity = max(1, int(error_capacity))
        self.seed = int(seed)
        self.slo_s = None if slo_s is None else float(slo_s)
        self.on_breach = on_breach
        self.flush_interval_s = float(flush_interval_s)
        self._lock = threading.Lock()
        self._seq = 0
        self._queries = 0
        self._errors_seen = 0
        self._slo_breaches = 0
        self._kept = collections.Counter()
        self._sampled = collections.deque(maxlen=self.capacity)
        self._errors = collections.deque(maxlen=self.error_capacity)
        self._slowest = []          # min-heap of (total_s, seq, record)
        self._hist_total = StreamingHistogram(bounds)
        self._hist_stage = {name: StreamingHistogram(bounds)
                            for name in SERVE_SPAN_NAMES}
        self._dirty = False
        self._last_flush = 0.0

    @property
    def summary_path(self):
        if not self.path:
            return None
        return os.path.join(os.path.dirname(self.path) or '.',
                            'qtrace_summary.json')

    def start(self, traceparent=None):
        """Open a trace: adopt the caller's W3C trace context when the
        header parses, mint a deterministic id otherwise."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        span_id = hashlib.sha256(
            f'{self.seed}:span:{seq}'.encode()).hexdigest()[:16]
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id = parsed
        else:
            trace_id = hashlib.sha256(
                f'{self.seed}:trace:{seq}'.encode()).hexdigest()[:32]
            parent_id = None
        return QueryTrace(trace_id, span_id, seq, parent_id)

    def _sample_keep(self, trace_id):
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = hashlib.sha256(
            f'{self.seed}:keep:{trace_id}'.encode()).digest()
        return int.from_bytes(h[:8], 'big') / 2.0 ** 64 \
            < self.sample_rate

    def finish(self, trace, status=200, bucket=None, error=None,
               total_s=None):
        """Close a trace and route it through retention; returns the
        record dict. Histograms see EVERY query; the file tiers see the
        deterministic kept-set."""
        total = trace.close(total_s)
        record = {
            'trace_id': trace.trace_id,
            'span_id': trace.span_id,
            'parent_id': trace.parent_id,
            'seq': trace.seq,
            'time_unix': trace.start_unix,
            'status': int(status),
            'bucket': bucket,
            'error': error,
            'total_ms': round(total * 1e3, 4),
            'spans': [{'name': n, 'start_ms': round(s * 1e3, 4),
                       'dur_ms': round(d * 1e3, 4)}
                      for n, s, d in trace.spans],
        }
        is_error = int(status) >= 400 or error is not None
        breach = self.slo_s is not None and total > self.slo_s
        by_name = {}
        for name, _start, dur in trace.spans:
            by_name[name] = by_name.get(name, 0.0) + dur
        with self._lock:
            self._queries += 1
            self._hist_total.observe(total)
            for name, dur in by_name.items():
                self._hist_stage[name].observe(dur)
            if is_error:
                self._errors_seen += 1
                self._errors.append(record)
                self._kept['error'] += 1
            if self.slowest_k:
                entry = (total, trace.seq, record)
                if len(self._slowest) < self.slowest_k:
                    heapq.heappush(self._slowest, entry)
                    self._kept['slowest'] += 1
                elif entry > self._slowest[0]:
                    heapq.heapreplace(self._slowest, entry)
                    self._kept['slowest'] += 1
            if not is_error and self.capacity \
                    and self._sample_keep(trace.trace_id):
                self._sampled.append(record)
                self._kept['sampled'] += 1
            if breach:
                self._slo_breaches += 1
            self._dirty = True
        if breach and self.on_breach is not None:
            self.on_breach(record)      # outside the lock: may dump
        return record

    # -- file tier ---------------------------------------------------

    def _records_locked(self):
        by_seq = {}

        def add(record, reason):
            entry = by_seq.setdefault(record['seq'],
                                      {'record': record, 'kept': []})
            entry['kept'].append(reason)

        for record in self._errors:
            add(record, 'error')
        for _total, _seq, record in self._slowest:
            add(record, 'slowest')
        for record in self._sampled:
            add(record, 'sampled')
        return [dict(e['record'], kept=sorted(set(e['kept'])))
                for _seq, e in sorted(by_seq.items())]

    def flush(self):
        """Atomically rewrite ``qtrace.jsonl`` + ``qtrace_summary.json``
        from the in-memory rings. The file never grows past the ring
        bounds because it IS the rings, serialized."""
        if not self.path:
            return False
        with self._lock:
            records = self._records_locked()
            summary = self._summary_locked()
        tmp = f'{self.path}.tmp.{os.getpid()}'
        try:
            os.makedirs(os.path.dirname(self.path) or '.',
                        exist_ok=True)
            with open(tmp, 'w') as f:
                for record in records:
                    f.write(json.dumps(record) + '\n')
            os.replace(tmp, self.path)
        except OSError:
            return False
        write_json_atomic(self.summary_path, summary, indent=1,
                          quiet=True)
        self._last_flush = time.time()
        self._dirty = False
        return True

    def maybe_flush(self, interval_s=None):
        """Time-throttled flush for the query path: cheap when clean or
        recently flushed, so per-query overhead stays in the noise."""
        if not self._dirty or not self.path:
            return False
        interval = self.flush_interval_s if interval_s is None \
            else float(interval_s)
        if time.time() - self._last_flush < interval:
            return False
        return self.flush()

    # -- summaries ---------------------------------------------------

    def _hist_quantiles_locked(self, hist):
        if not hist.count:
            return None
        return {
            'count': hist.count,
            'sum_ms': round(hist.sum * 1e3, 4),
            'p50_ms': round(hist.quantile(0.50) * 1e3, 4),
            'p95_ms': round(hist.quantile(0.95) * 1e3, 4),
            'p99_ms': round(hist.quantile(0.99) * 1e3, 4),
        }

    def _summary_locked(self):
        stages = {}
        for name in SERVE_SPAN_NAMES:
            q = self._hist_quantiles_locked(self._hist_stage[name])
            if q is not None:
                stages[name] = q
        end_to_end = self._hist_quantiles_locked(self._hist_total)
        gap = None
        if end_to_end is not None:
            by_stage = {
                name: round(max(0.0, q['p95_ms'] - q['p50_ms']), 4)
                for name, q in stages.items()}
            dominant = max(by_stage, key=by_stage.get) \
                if any(by_stage.values()) else None
            gap = {
                'p95_minus_p50_ms': round(
                    end_to_end['p95_ms'] - end_to_end['p50_ms'], 4),
                'by_stage_ms': by_stage,
                'dominant_stage': dominant,
            }
        slowest = [record for _total, _seq, record
                   in sorted(self._slowest, reverse=True)]
        return {
            'queries': self._queries,
            'errors': self._errors_seen,
            'errors_truncated': max(
                0, self._errors_seen - len(self._errors)),
            'slo_breaches': self._slo_breaches,
            'sample_rate': self.sample_rate,
            'slowest_k': self.slowest_k,
            'capacity': self.capacity,
            'seed': self.seed,
            'kept': dict(self._kept),
            'stage_vocabulary': list(SERVE_SPAN_NAMES),
            'end_to_end': end_to_end,
            'stages': stages,
            'gap_attribution': gap,
            'slowest': slowest,
        }

    def summary(self):
        """The full-population account (every query, histograms), the
        payload of ``qtrace_summary.json``."""
        with self._lock:
            return self._summary_locked()

    def metric_families(self):
        """Metric families for the ``/metrics`` exposition: per-stage
        latency histograms (``stage`` label), the end-to-end trace
        histogram, and the retention counters. Plugged into
        :meth:`~dgmc_tpu_torch.obs.run.RunObserver.add_metrics_provider`."""
        with self._lock:
            stage_snaps = {name: self._hist_stage[name].snapshot()
                           for name in SERVE_SPAN_NAMES}
            total_snap = self._hist_total.snapshot()
            kept = dict(self._kept)
            queries = self._queries
            breaches = self._slo_breaches
        samples = []
        for stage in SERVE_SPAN_NAMES:
            snap = stage_snaps[stage]
            for bound, cum in snap['buckets']:
                le = '+Inf' if math.isinf(bound) \
                    else repr(float(bound))
                samples.append(
                    ('_bucket', {'stage': stage, 'le': le}, cum))
            samples.append(('_sum', {'stage': stage}, snap['sum']))
            samples.append(('_count', {'stage': stage},
                            snap['count']))
        return [
            ('dgmc_query_stage_seconds', 'histogram',
             'Per-stage serve span latency (qtrace vocabulary).',
             samples),
            histogram_family(
                'dgmc_query_trace_seconds',
                'End-to-end /match latency (qtrace, every query).',
                total_snap),
            ('dgmc_qtrace_queries_total', 'counter',
             'Queries traced.', [('', {}, queries)]),
            ('dgmc_qtrace_kept_total', 'counter',
             'Trace-retention admissions by reason.',
             [('', {'reason': r}, kept.get(r, 0))
              for r in ('sampled', 'slowest', 'error')]),
            ('dgmc_qtrace_slo_breaches_total', 'counter',
             'Queries over the end-to-end SLO.', [('', {}, breaches)]),
        ]


# ---------------------------------------------------------------------------
# Offline analysis: records -> report / Chrome export
# ---------------------------------------------------------------------------

def load_records(path):
    """Read a ``qtrace.jsonl`` (or an obs dir holding one — supervised
    roots resolve to the LAST attempt, like ``report.load_run``).
    Returns ``(records, summary_or_None, resolved_path)``."""
    if os.path.isdir(path):
        candidates = [os.path.join(path, 'qtrace.jsonl')]
        attempts = sorted(
            d for d in os.listdir(path) if d.startswith('attempt_'))
        candidates = [os.path.join(path, a, 'qtrace.jsonl')
                      for a in reversed(attempts)] + candidates
        for cand in candidates:
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f'no qtrace.jsonl under {path} (or its attempt_*/)')
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    summary = None
    summary_path = os.path.join(os.path.dirname(path) or '.',
                                'qtrace_summary.json')
    try:
        with open(summary_path) as f:
            summary = json.load(f)
    except (OSError, ValueError):
        pass
    return records, summary, path


def stage_percentiles(records):
    """Exact per-stage and end-to-end percentiles over kept records
    (``{'end_to_end': {...}, 'stages': {name: {...}}}``). Exact —
    unlike the histogram summary — but over the KEPT set, which the
    slowest-K reservoir biases toward the tail; the report says which
    account it is printing."""
    def quant(values):
        values = sorted(values)
        return {'count': len(values),
                'p50_ms': round(percentile(values, 0.50), 4),
                'p95_ms': round(percentile(values, 0.95), 4),
                'p99_ms': round(percentile(values, 0.99), 4)}

    by_stage = collections.defaultdict(list)
    totals = []
    for record in records:
        totals.append(float(record.get('total_ms') or 0.0))
        per = {}
        for span in record.get('spans') or []:
            per[span['name']] = per.get(span['name'], 0.0) \
                + float(span['dur_ms'])
        for name, ms in per.items():
            by_stage[name].append(ms)
    out = {'end_to_end': quant(totals) if totals else None,
           'stages': {}}
    for name in SERVE_SPAN_NAMES:
        if by_stage.get(name):
            out['stages'][name] = quant(by_stage[name])
    return out


def gap_attribution(percentiles):
    """Attribute the end-to-end p95−p50 gap to stages: each stage's own
    p95−p50 spread, largest spread named dominant. ``None`` without an
    end-to-end account."""
    e2e = percentiles.get('end_to_end')
    if not e2e:
        return None
    by_stage = {
        name: round(max(0.0, q['p95_ms'] - q['p50_ms']), 4)
        for name, q in (percentiles.get('stages') or {}).items()}
    gap = round(e2e['p95_ms'] - e2e['p50_ms'], 4)
    dominant = max(by_stage, key=by_stage.get) \
        if any(by_stage.values()) else None
    share = None
    if dominant is not None and gap > 0:
        share = round(min(1.0, by_stage[dominant] / gap), 4)
    return {'p95_minus_p50_ms': gap, 'by_stage_ms': by_stage,
            'dominant_stage': dominant, 'dominant_share': share}


def chrome_trace_events(records):
    """Chrome trace-event payload for kept records: one thread row per
    query, ``ph: 'X'`` slices named by the serve span vocabulary with
    the mapped model stages in ``args``, viewable beside a profiler
    capture."""
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 0, 'tid': 0,
               'args': {'name': 'dgmc-qtrace'}}]
    for record in records:
        tid = int(record.get('seq') or 0)
        base_us = float(record.get('time_unix') or 0.0) * 1e6
        label = (f"query {str(record.get('trace_id') or '')[:8]} "
                 f"({record.get('status')})")
        events.append({'ph': 'M', 'name': 'thread_name', 'pid': 0,
                       'tid': tid, 'args': {'name': label}})
        for span in record.get('spans') or []:
            events.append({
                'ph': 'X', 'name': span['name'], 'pid': 0, 'tid': tid,
                'ts': base_us + float(span['start_ms']) * 1e3,
                'dur': float(span['dur_ms']) * 1e3,
                'args': {
                    'trace_id': record.get('trace_id'),
                    'stages': list(SERVE_SPAN_STAGES[span['name']]),
                }})
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


def _render_span_tree(record, indent='  '):
    lines = [f"trace {record.get('trace_id')} seq {record.get('seq')}: "
             f"{record.get('total_ms')} ms, status "
             f"{record.get('status')}"
             + (f", bucket {record['bucket']}"
                if record.get('bucket') else '')
             + (f", error {record['error']}"
                if record.get('error') else '')
             + (f" [kept: {','.join(record['kept'])}]"
                if record.get('kept') else '')]
    for span in record.get('spans') or []:
        end = span['start_ms'] + span['dur_ms']
        lines.append(f"{indent}{span['name']:<22} "
                     f"{span['start_ms']:9.3f} ..{end:9.3f} ms  "
                     f"({span['dur_ms']:.3f} ms)")
    return lines


def render_report(records, summary=None, slowest=1):
    """The human report: per-stage table, gap attribution, slowest span
    trees. Exact percentiles over the kept set; the full-population
    histogram account is quoted from the summary when present."""
    lines = []
    pct = stage_percentiles(records)
    gap = gap_attribution(pct)
    seen = summary.get('queries') if summary else None
    lines.append(f'qtrace: {len(records)} kept records'
                 + (f' of {seen} queries observed' if seen else ''))
    if summary and summary.get('errors'):
        trunc = summary.get('errors_truncated') or 0
        lines.append(f"errors: {summary['errors']}"
                     + (f' ({trunc} evicted by the error-ring bound)'
                        if trunc else ''))
    e2e = pct['end_to_end']
    if e2e is None:
        lines.append('no records — nothing to attribute')
        return '\n'.join(lines)
    lines.append(f"end-to-end (kept set): p50 {e2e['p50_ms']:.3f}  "
                 f"p95 {e2e['p95_ms']:.3f}  p99 {e2e['p99_ms']:.3f} ms")
    lines.append('')
    lines.append(f"{'stage':<22}{'count':>7}{'p50 ms':>10}"
                 f"{'p95 ms':>10}{'p99 ms':>10}{'p95-p50':>10}")
    for name in SERVE_SPAN_NAMES:
        q = pct['stages'].get(name)
        if q is None:
            lines.append(f'{name:<22}{"-":>7}{"-":>10}{"-":>10}'
                         f'{"-":>10}{"-":>10}')
            continue
        spread = max(0.0, q['p95_ms'] - q['p50_ms'])
        lines.append(f"{name:<22}{q['count']:>7}{q['p50_ms']:>10.3f}"
                     f"{q['p95_ms']:>10.3f}{q['p99_ms']:>10.3f}"
                     f"{spread:>10.3f}")
    lines.append('')
    if gap and gap['dominant_stage']:
        share = f" ({gap['dominant_share']:.0%} of the gap)" \
            if gap.get('dominant_share') is not None else ''
        lines.append(
            f"p95-p50 gap {gap['p95_minus_p50_ms']:.3f} ms; dominant "
            f"stage: {gap['dominant_stage']} "
            f"(+{gap['by_stage_ms'][gap['dominant_stage']]:.3f} ms"
            f"{share})")
    else:
        lines.append('p95-p50 gap: no stage spread to attribute')
    ranked = sorted(records,
                    key=lambda r: float(r.get('total_ms') or 0.0),
                    reverse=True)
    for record in ranked[:max(0, int(slowest))]:
        lines.append('')
        lines.extend(_render_span_tree(record))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.qtrace',
        description='Attribute serve tail latency (p95-p50) to stages '
                    'from a worker qtrace.jsonl.')
    parser.add_argument('path',
                        help='qtrace.jsonl, or an obs dir holding one '
                             '(supervised roots resolve to the last '
                             'attempt)')
    parser.add_argument('--slowest', type=int, default=1,
                        help='span trees to print for the slowest N '
                             'kept queries (default 1)')
    parser.add_argument('--json', action='store_true',
                        help='emit the machine-readable report instead '
                             'of text')
    parser.add_argument('--chrome', metavar='OUT',
                        help='also export kept records as Chrome '
                             'trace-event JSON to OUT')
    args = parser.parse_args(argv)
    try:
        records, summary, resolved = load_records(args.path)
    except (OSError, ValueError) as e:
        print(f'qtrace: {e}')
        return 1
    if args.chrome:
        write_json_atomic(args.chrome, chrome_trace_events(records))
        print(f'chrome trace: {args.chrome}')
    if args.json:
        pct = stage_percentiles(records)
        print(json.dumps({
            'path': resolved,
            'records': len(records),
            'percentiles': pct,
            'gap_attribution': gap_attribution(pct),
            'summary': summary,
        }, indent=1, sort_keys=True))
        return 0
    print(f'[{resolved}]')
    print(render_report(records, summary, slowest=args.slowest))
    return 0


if __name__ == '__main__':      # pragma: no cover
    raise SystemExit(main())
