"""Process-wide telemetry registry: counters, gauges, kernel-dispatch
outcomes and compile events.

The port of the JAX package's ``dgmc_tpu/obs/registry.py``. Everything
here is host-side and cheap (a dict increment under a lock), so it is
always on. :class:`~dgmc_tpu_torch.obs.run.RunObserver` snapshots it
into ``dispatch.json``, ``timings.json`` and ``/metrics``.

Counting semantics, where the port differs from JAX:

- **Dispatch counters** (:func:`record_dispatch`) are fed by the port's
  dispatch ledger (:func:`dgmc_tpu_torch.ops.kernels.dispatch.record`):
  one count per gate decision *executed*, with the port's outcomes
  (``kernel`` / ``plain``, and ``native`` / ``numpy`` for the host's
  collation). A captured step's replay runs no Python, so each replay
  adds the decisions its capture recorded
  (:func:`~dgmc_tpu_torch.ops.kernels.dispatch.replay`), and a run of
  10k replayed steps counts 10k decisions per site. JAX counts per
  traced program (one count per decision site however many steps run).
- **Compile events** (:class:`CompileWatcher`, :func:`record_compile`)
  are the port's two kinds of build: a record captured by
  :class:`~dgmc_tpu_torch.train.compiled.Compiled` (``capture``: its
  warm-up runs plus the capture's seconds, on the card; the static
  buffers alone on the CPU) and a kernel library compiled by ``nvcc``
  (``nvcc``, :func:`~dgmc_tpu_torch.ops.kernels.build.load_library`).
  A same-signature call after the first records none, so a warm steady
  state records zero events and a new input shape records one capture.
"""

import contextlib
import threading
import time

__all__ = ['Registry', 'REGISTRY', 'DISPATCH_COUNTER', 'record_dispatch',
           'add_dispatch_sink', 'remove_dispatch_sink', 'dispatch_table',
           'record_padding', 'padding_bucket_table', 'padding_real_table',
           'PADDING_REAL_AXES', 'record_compile', 'compile_event_count',
           'CompileWatcher']


class Registry:
    """Thread-safe labelled counters and gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted(labels.items())))

    def inc(self, name, value=1, **labels):
        with self._lock:
            k = self._key(name, labels)
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name, value, **labels):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def counter_value(self, name, **labels):
        with self._lock:
            return self._counters.get(self._key(name, labels), 0)

    def total(self, name):
        """Sum of a counter over all label combinations."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def snapshot(self):
        """JSON-ready dump: ``{'counters': [...], 'gauges': [...]}``."""
        with self._lock:
            return {
                'counters': [
                    {'name': n, 'labels': dict(ls), 'value': v}
                    for (n, ls), v in sorted(self._counters.items())],
                'gauges': [
                    {'name': n, 'labels': dict(ls), 'value': v}
                    for (n, ls), v in sorted(self._gauges.items())],
            }

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


#: The process-wide registry every call site records into.
REGISTRY = Registry()


# ---------------------------------------------------------------------------
# Kernel-dispatch outcomes
# ---------------------------------------------------------------------------

DISPATCH_COUNTER = 'kernel_dispatch'

#: Live dispatch sinks: callables ``(kernel, outcome, reason)`` called on
#: every decision recorded (the flight recorder's live view). A raising
#: sink is dropped from the event, never from the run.
_dispatch_lock = threading.Lock()
_dispatch_sinks = []


def add_dispatch_sink(fn):
    with _dispatch_lock:
        _dispatch_sinks.append(fn)


def remove_dispatch_sink(fn):
    with _dispatch_lock:
        if fn in _dispatch_sinks:
            _dispatch_sinks.remove(fn)


def record_dispatch(kernel, outcome, reason, count=1):
    """Record ``count`` executions of one kernel-dispatch decision.

    Args:
        kernel: the gate, e.g. ``'topk'``, ``'consensus_fwd'``,
            ``'sparse_consensus_fwd'``, ``'collate'``.
        outcome: ``'kernel'`` (the CUDA kernel launched) or ``'plain'``
            (the plain PyTorch version ran); ``'native'`` or ``'numpy'``
            for the collation.
        reason: why, e.g. ``'cuda'``, ``'cpu'``, ``'R>128'``.
        count: executions (a replay adds its capture's counts at once).
    """
    REGISTRY.inc(DISPATCH_COUNTER, value=count, kernel=kernel,
                 outcome=outcome, reason=reason)
    with _dispatch_lock:
        sinks = tuple(_dispatch_sinks)
    for fn in sinks:
        try:
            fn(kernel, outcome, reason)
        except Exception:
            pass


def dispatch_table():
    """Dispatch counts as sorted rows of
    ``{'kernel', 'outcome', 'reason', 'count'}``."""
    rows = []
    for rec in REGISTRY.snapshot()['counters']:
        if rec['name'] != DISPATCH_COUNTER:
            continue
        rows.append({**rec['labels'], 'count': rec['value']})
    return sorted(rows, key=lambda r: (r.get('kernel', ''),
                                       r.get('outcome', ''),
                                       r.get('reason', '')))


#: Real-size axes the collation accumulates per padding bucket: the
#: pre-padding node and edge totals of each pair side, a counter family
#: of its own beside ``padding_bucket`` (whose labels are the bucket's
#: identity).
PADDING_REAL_AXES = ('nodes_s', 'nodes_t', 'edges_s', 'edges_t')


def record_padding(batch, nodes, edges, real=None):
    """Count one collation into its padding bucket, optionally with the
    batch's real (pre-padding) totals per :data:`PADDING_REAL_AXES`."""
    labels = {'batch': batch, 'nodes': nodes, 'edges': edges}
    REGISTRY.inc('padding_bucket', **labels)
    for axis, value in (real or {}).items():
        if axis in PADDING_REAL_AXES and value is not None:
            REGISTRY.inc('padding_real', value=int(value), axis=axis,
                         **labels)


def padding_bucket_table():
    """Padding-bucket collation counts: one row per distinct (batch,
    nodes, edges) padding, the most used first (each is an input
    signature, so a captured graph, of the consuming step)."""
    rows = [dict(rec['labels'], count=rec['value'])
            for rec in REGISTRY.snapshot()['counters']
            if rec['name'] == 'padding_bucket']
    return sorted(rows, key=lambda r: -r['count'])


def padding_real_table():
    """Accumulated real-size totals per padding bucket and axis: rows of
    ``{'batch', 'nodes', 'edges', 'axis', 'count'}``."""
    rows = [dict(rec['labels'], count=rec['value'])
            for rec in REGISTRY.snapshot()['counters']
            if rec['name'] == 'padding_real']
    return sorted(rows, key=lambda r: (str(r.get('nodes')),
                                       str(r.get('edges')),
                                       r.get('axis', '')))


# ---------------------------------------------------------------------------
# Compile events
# ---------------------------------------------------------------------------

_listener_lock = threading.Lock()
_watchers = []


def record_compile(kind, duration_s):
    """Record one compile event (``kind`` ``'capture'`` or ``'nvcc'``)
    into the registry and every open :class:`CompileWatcher`."""
    REGISTRY.inc('compile_events')
    REGISTRY.inc('compile_seconds', value=duration_s)
    rec = {'time': time.time(), 'kind': kind,
           'duration_s': round(duration_s, 4)}
    with _listener_lock:
        for w in _watchers:
            w._record(rec)


def compile_event_count():
    """Process-lifetime compile-event count."""
    return REGISTRY.total('compile_events')


class CompileWatcher:
    """Scoped view over compile events, with phase labels.

    A watcher lets the caller bracket regions (``with w.label('phase2')``)
    and attributes every event inside the bracket to that label. Use as a
    context manager; events are collected between ``__enter__`` and
    ``close()``. ``on_event`` (optional) is called with each labelled
    event as it lands, under the watchers' lock: it must be cheap and
    must not re-enter this module; a raising callback is swallowed.
    """

    def __init__(self, on_event=None):
        self._events = []
        self._label = 'run'
        self._open = False
        self._on_event = on_event

    def _record(self, rec):
        if self._open:
            rec = dict(rec, label=self._label)
            self._events.append(rec)
            if self._on_event is not None:
                try:
                    self._on_event(rec)
                except Exception:
                    pass

    def __enter__(self):
        with _listener_lock:
            self._open = True
            _watchers.append(self)
        return self

    def close(self):
        with _listener_lock:
            self._open = False
            if self in _watchers:
                _watchers.remove(self)

    def __exit__(self, *exc):
        self.close()

    @contextlib.contextmanager
    def label(self, name):
        """Attribute compile events inside the block to ``name``."""
        prev, self._label = self._label, name
        try:
            yield
        finally:
            self._label = prev

    @property
    def events(self):
        with _listener_lock:
            return list(self._events)

    def count(self):
        return len(self.events)

    def summary(self):
        """``{'events', 'compile_s', 'cache_hits', 'by_label'}`` for
        ``timings.json`` (``cache_hits`` is always 0: the port has no
        persistent compilation cache; a kernel library found built is
        no event)."""
        evs = self.events
        by_label = {}
        for e in evs:
            d = by_label.setdefault(e['label'], {'events': 0,
                                                 'compile_s': 0.0})
            d['events'] += 1
            d['compile_s'] = round(d['compile_s'] + e['duration_s'], 4)
        return {
            'events': len(evs),
            'compile_s': round(sum(e['duration_s'] for e in evs), 4),
            'cache_hits': 0,
            'by_label': by_label,
        }
