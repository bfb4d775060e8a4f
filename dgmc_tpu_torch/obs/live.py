"""Live telemetry plane: ``/healthz`` + ``/metrics`` + ``/status``, the
streaming latency histogram, and the anomaly flight recorder.

The port's copy of the JAX package's ``dgmc_tpu/obs/live.py`` (the same
bucket bounds, staleness factor, exposition and ``DGMC_TPU_OBS_BIND``
variable), armed by ``--obs-port`` through
:func:`~dgmc_tpu_torch.obs.run.add_obs_flag`:

- ``GET /healthz`` — the watchdog heartbeat's age, the in-flight span,
  the guard's gauges. It answers **503 when the heartbeat is stale**:
  older than :data:`STALE_AFTER_FACTOR` x the watchdog deadline.
- ``GET /metrics`` — Prometheus text exposition: the step-latency
  streaming histogram (:class:`StreamingHistogram`, O(1) memory),
  throughput, compile counts per label, kernel-dispatch counters, probe
  gauges.
- ``GET /status`` — the live ``timings.json`` summary as JSON.

Alongside, the always-on **flight recorder** (:class:`FlightRecorder`):
a bounded ring of the last span completions, probe values,
kernel-dispatch decisions and compile events, dumped as ``flight.json``
on an anomaly (a watchdog trip, a guard rollback, a signal).

This module imports no torch (stdlib plus the port's atomic writer): the
server thread must answer while the main thread waits on the card (a
``torch.cuda.synchronize()`` or a ``.item()`` releases the interpreter
lock while it waits), and monitors import it without a device.
"""

import bisect
import collections
import http.server
import inspect
import json
import math
import os
import sys
import threading
import time

from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['StreamingHistogram', 'FlightRecorder', 'TelemetryServer',
           'prometheus_exposition', 'probe_healthz',
           'DEFAULT_LATENCY_BOUNDS', 'DEFAULT_FLIGHT_CAPACITY',
           'STALE_AFTER_FACTOR']

#: One health definition for everyone: a heartbeat older than
#: ``STALE_AFTER_FACTOR x the watchdog deadline`` means "wedged" (the
#: JAX package's run supervisor applies the same factor to the
#: heartbeat file, so a 503 and its ``heartbeat-stale`` kill are one
#: verdict).
STALE_AFTER_FACTOR = 2.0

#: Step-latency histogram bounds (seconds): powers of two from 1 ms to
#: ~35 min (sub-ms replays to minutes-long streamed steps); exponential
#: buckets keep the relative error of any quantile estimate bounded by
#: the factor-of-2 spacing.
DEFAULT_LATENCY_BOUNDS = tuple(0.001 * 2 ** i for i in range(22))

#: Flight-recorder ring capacity. At one span pair per step plus a
#: handful of probe/dispatch/compile events, 1024 events cover the
#: last few hundred steps — the trailing context a hang report lacks —
#: in a few hundred KiB of memory, always-on.
DEFAULT_FLIGHT_CAPACITY = 1024


class StreamingHistogram:
    """Fixed-bucket streaming histogram with O(1) memory.

    The per-step latency list ``StepTimer`` keeps grows without bound —
    fine for a 200-epoch training run, wrong for a serving process that
    must hold its p95 account over millions of queries. This histogram
    is the O(1) replacement: ``len(bounds)+1`` integer counters, a sum
    and a count, observed in O(log buckets) per event, rendered as a
    standard Prometheus cumulative histogram.

    Bucket semantics match Prometheus: bucket ``le=B`` counts
    observations ``<= B``; the implicit last bucket is ``+Inf``.
    """

    def __init__(self, bounds=DEFAULT_LATENCY_BOUNDS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError('histogram needs at least one bucket bound')
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError('bucket bounds must be strictly increasing: '
                             f'{bounds}')
        if not all(math.isfinite(b) for b in bounds):
            raise ValueError('bucket bounds must be finite '
                             '(+Inf is implicit)')
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        # First bound >= value, i.e. the smallest bucket whose
        # ``le`` covers it (Prometheus ``<=`` semantics).
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def snapshot(self):
        """``{'buckets': [(le, cumulative_count), ...], 'sum', 'count'}``
        with the final ``+Inf`` bucket equal to ``count`` — the exact
        shape the exposition renders."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            acc = self._sum
        buckets, cum = [], 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            buckets.append((bound, cum))
        buckets.append((math.inf, total))
        return {'buckets': buckets, 'sum': acc, 'count': total}

    def quantile(self, q):
        """Upper bucket edge containing the q-quantile (``None`` when
        empty) — a conservative estimate whose error is bounded by the
        bucket spacing, cross-checked against the exact
        :func:`~dgmc_tpu_torch.obs.observe.percentile` in tests."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f'quantile must be in [0, 1], got {q}')
        snap = self.snapshot()
        if not snap['count']:
            return None
        rank = q * snap['count']
        for bound, cum in snap['buckets']:
            if cum >= rank:
                return bound
        return math.inf


def _json_safe(obj):
    """Copy with non-finite floats replaced by ``None``: NaN/inf are not
    valid JSON and one poisoned probe value must not make the whole
    flight record unparseable — the poisoned run is the one worth
    reading (same contract as ``MetricLogger``)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded ring buffer of run events, dumped on anomaly.

    :meth:`record` is cheap (one dict build + deque append under a
    lock) so it stays on for the whole run; the ring keeps the LAST
    ``capacity`` events and counts what it evicted — a dump over a
    clipped window says so (``events_truncated``), never silently.

    :meth:`dump` is deliberately **lock-free** (snapshot reads only):
    it is called from the watchdog's signal path, where the interrupted
    main thread may hold any lock, including this recorder's. The
    record side takes the lock; the dump side never does.
    """

    def __init__(self, path=None, capacity=DEFAULT_FLIGHT_CAPACITY):
        self.path = path
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError(f'capacity must be positive: {capacity}')
        self._events = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.seen = 0
        self.dump_count = 0
        self.last_reason = None

    def record(self, kind, **fields):
        rec = {'time': time.time(), 'kind': kind}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)
            self.seen += 1

    @property
    def recorded(self):
        return len(self._events)

    @property
    def truncated(self):
        """Events evicted by the ring cap (seen - kept)."""
        return max(0, self.seen - len(self._events))

    def snapshot(self):
        return list(self._events)

    def counters(self):
        return {'events_seen': self.seen,
                'events_recorded': self.recorded,
                'events_truncated': self.truncated,
                'dumps': self.dump_count}

    def dump(self, reason, extra=None, path=None):
        """Write ``flight.json`` now; returns the path (``None`` when
        no path is configured or the write failed — a recorder must
        never raise into the run it records). Lock-free: safe from the
        signal path."""
        path = path or self.path
        if not path:
            return None
        # list(deque) without the lock: atomic enough in CPython, and
        # the signal path must not block on a lock the interrupted
        # thread may hold mid-record.
        events = list(self._events)
        payload = {
            'reason': reason,
            'time': time.time(),
            'pid': os.getpid(),
            'argv': sys.argv,
            'capacity': self.capacity,
            'events_seen': self.seen,
            'events_recorded': len(events),
            'events_truncated': max(0, self.seen - len(events)),
            'events': _json_safe(events),
        }
        if extra:
            payload.update(_json_safe(dict(extra)))
        if not write_json_atomic(path, payload, indent=1, quiet=True,
                                 default=str):
            return None
        self.dump_count += 1
        self.last_reason = reason
        return path


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _metric_name(name):
    """Sanitize to the metric-name grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (invalid chars become ``_``)."""
    out = ''.join(c if c.isascii() and (c.isalnum() or c in '_:')
                  else '_' for c in str(name))
    if not out or not (out[0].isalpha() or out[0] in '_:'):
        out = '_' + out
    return out


def _label_name(name):
    out = ''.join(c if c.isascii() and (c.isalnum() or c == '_')
                  else '_' for c in str(name))
    if not out or not (out[0].isalpha() or out[0] == '_'):
        out = '_' + out
    return out


def _escape_label_value(value):
    return (str(value).replace('\\', r'\\').replace('"', r'\"')
            .replace('\n', r'\n'))


def _escape_help(text):
    return str(text).replace('\\', r'\\').replace('\n', r'\n')


def _fmt_value(v):
    if isinstance(v, bool):
        return '1' if v else '0'
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isnan(v):
        return 'NaN'
    if math.isinf(v):
        return '+Inf' if v > 0 else '-Inf'
    return repr(v)


def _sample(name, labels, value):
    if not labels:
        return f'{name} {_fmt_value(value)}'
    inner = ','.join(
        f'{_label_name(k)}="{_escape_label_value(v)}"'
        for k, v in labels.items())
    return f'{name}{{{inner}}} {_fmt_value(value)}'


def prometheus_exposition(families):
    """Render metric families as the Prometheus text format (0.0.4).

    ``families`` is an iterable of ``(name, type, help, samples)`` where
    ``samples`` is a list of ``(suffix, labels_dict, value)`` — suffix
    is appended to the family name (``_bucket``/``_sum``/``_count`` for
    histograms, ``''`` otherwise). Names and label names are sanitized
    to the exposition grammar; label values and help text are escaped.
    Ends with the mandatory trailing newline.
    """
    lines = []
    for name, mtype, help_text, samples in families:
        name = _metric_name(name)
        if help_text:
            lines.append(f'# HELP {name} {_escape_help(help_text)}')
        lines.append(f'# TYPE {name} {mtype}')
        for suffix, labels, value in samples:
            lines.append(_sample(name + suffix, labels or {}, value))
    return '\n'.join(lines) + '\n'


def histogram_family(name, help_text, hist_snapshot):
    """One histogram family from a :meth:`StreamingHistogram.snapshot`
    (the ``le`` label rendering, ``+Inf`` spelling included)."""
    samples = []
    for bound, cum in hist_snapshot['buckets']:
        le = '+Inf' if math.isinf(bound) else _fmt_value(float(bound))
        samples.append(('_bucket', {'le': le}, cum))
    samples.append(('_sum', {}, hist_snapshot['sum']))
    samples.append(('_count', {}, hist_snapshot['count']))
    return (name, 'histogram', help_text, samples)


# ---------------------------------------------------------------------------
# HTTP plane
# ---------------------------------------------------------------------------

def _accepts_headers(handler):
    """Whether a route handler declares the optional third positional
    parameter (request headers). Decided ONCE at mount time from the
    signature — never by catching ``TypeError`` at call time, which
    would mask genuine arity bugs inside the handler."""
    try:
        sig = inspect.signature(handler)
    except (TypeError, ValueError):
        return True
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY,
                                p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 3


class TelemetryServer:
    """Threaded HTTP server for the three endpoints (plus app routes).

    Args:
        port: TCP port (0 = pick a free one; the chosen port is in
            :attr:`port` after :meth:`start` and is what the observer
            advertises in ``heartbeat.json``).
        health_fn: 0-arg callable returning the ``/healthz`` JSON dict;
            a falsy ``'healthy'`` key turns the response into a 503.
        metrics_fn: 0-arg callable returning the ``/metrics`` exposition
            text.
        status_fn: 0-arg callable returning the ``/status`` JSON dict.
        host: bind address (default all interfaces — an external
            prober/scraper is the point of the plane).
        routes: optional ``{path: handler}`` application endpoints
            mounted BESIDE the telemetry trio (the serving subsystem's
            ``/match`` joins ``/healthz``/``/metrics``/``/status`` on
            one port this way). A handler is called as
            ``handler(method, body_bytes)`` — GET arrives with
            ``body_bytes=b''`` — and returns ``(status_code,
            payload_dict)``; the payload is rendered as JSON. Returning
            a 4xx/5xx code is the structured-error path (the router's
            unknown-bucket 400). A handler that *raises* still yields
            the generic 500, like the telemetry callbacks.

            A handler that declares a THIRD positional parameter is
            additionally passed the request headers as a lowercase-keyed
            dict (``handler(method, body_bytes, headers)``) — how the
            serve plane receives ``traceparent`` — and any handler may
            return a 3-tuple ``(status_code, payload_dict,
            response_headers_dict)`` to attach extra response headers
            (the trace-context echo). Two-argument handlers and
            2-tuple returns keep working unchanged.

    A callback that raises yields a 500 carrying the error text; the
    serving thread itself must survive anything the callbacks do.
    """

    def __init__(self, port, health_fn=None, metrics_fn=None,
                 status_fn=None, host='', routes=None):
        self._requested_port = int(port)
        self._host = host
        self._health_fn = health_fn
        self._metrics_fn = metrics_fn
        self._status_fn = status_fn
        self._routes = dict(routes or {})
        self._route_takes_headers = {
            path: _accepts_headers(fn) for path, fn in self._routes.items()}
        self._server = None
        self._thread = None
        self.port = None

    def start(self):
        plane = self

        class Handler(http.server.BaseHTTPRequestHandler):
            server_version = 'dgmc-obs'
            protocol_version = 'HTTP/1.1'

            def log_message(self, *args):   # no stderr chatter per scrape
                pass

            def _respond(self, code, body, ctype, extra_headers=None):
                data = body.encode('utf-8')
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(str(k), str(v))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code, payload, extra_headers=None):
                self._respond(code, json.dumps(_json_safe(payload),
                                               indent=1),
                              'application/json; charset=utf-8',
                              extra_headers)

            def _endpoints(self):
                return (['/healthz', '/metrics', '/status']
                        + sorted(plane._routes))

            def _dispatch(self, method):
                path = self.path.split('?', 1)[0].rstrip('/') or '/'
                try:
                    if path in plane._routes:
                        n = int(self.headers.get('Content-Length') or 0)
                        body = self.rfile.read(n) if n else b''
                        handler = plane._routes[path]
                        if plane._route_takes_headers.get(path):
                            hdrs = {k.lower(): v
                                    for k, v in self.headers.items()}
                            out = handler(method, body, hdrs)
                        else:
                            out = handler(method, body)
                        if len(out) == 3:
                            code, payload, resp_hdrs = out
                        else:
                            code, payload = out
                            resp_hdrs = None
                        self._json(code, payload, resp_hdrs)
                    elif method != 'GET':
                        self._json(405, {
                            'error': f'{method} not supported on {path}',
                            'endpoints': self._endpoints()})
                    elif path == '/healthz' and plane._health_fn:
                        payload = plane._health_fn()
                        code = 200 if payload.get('healthy', True) \
                            else 503
                        self._json(code, payload)
                    elif path == '/metrics' and plane._metrics_fn:
                        self._respond(
                            200, plane._metrics_fn(),
                            'text/plain; version=0.0.4; charset=utf-8')
                    elif path == '/status' and plane._status_fn:
                        self._json(200, plane._status_fn())
                    else:
                        self._json(404, {
                            'error': f'no such endpoint: {path}',
                            'endpoints': self._endpoints()})
                except BrokenPipeError:
                    pass      # scraper went away mid-response
                except Exception as e:
                    try:
                        self._json(500, {
                            'error': f'{type(e).__name__}: {e}'})
                    except Exception:
                        pass

            def do_GET(self):
                self._dispatch('GET')

            def do_POST(self):
                self._dispatch('POST')

        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name='dgmc-telemetry', daemon=True)
        self._thread.start()
        return self

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def probe_healthz(port, host='127.0.0.1', timeout_s=2.0):
    """Scrape one ``/healthz`` endpoint.

    Returns ``(status_code, payload_dict)`` — 503 responses included,
    their JSON body intact — or ``None`` when the endpoint is
    unreachable (connection refused, timeout, non-JSON garbage): the
    caller falls back to file heartbeats, it does not condemn the run
    on a failed scrape. Shared by the run supervisor and
    :mod:`dgmc_tpu_torch.obs.aggregate` so both apply the same scrape
    semantics.
    """
    import urllib.error
    import urllib.request
    url = f'http://{host}:{int(port)}/healthz'
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            code = resp.status
            body = resp.read()
    except urllib.error.HTTPError as e:
        code = e.code
        try:
            body = e.read()
        except Exception:
            return None
    except Exception:
        return None
    try:
        payload = json.loads(body.decode('utf-8'))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(payload, dict):
        return None
    return code, payload
