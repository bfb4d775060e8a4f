"""Declarative SLOs, error budgets and multi-window burn rates.

The port's copy of the JAX package's ``dgmc_tpu/obs/slo.py`` (the
same schema, keys and metric families).

The measurement planes — latency histograms, quality headlines —
measure; this module judges them, with the standard SRE vocabulary:

- an **SLO spec** is a small JSON file (``--slo <file>`` on
  the experiment CLIs) declaring an availability
  objective, latency objectives (end-to-end and per serve stage, over
  the SAME span vocabulary qtrace records), and optional absolute
  floors on the quality plane's Hits@1 headline and the goodput ratio;
- the **error budget** of an objective is ``1 - objective``; budget
  *consumption* over the compliance window is
  ``bad_fraction / (1 - objective)`` — 1.0 means the window's budget is
  exactly spent;
- the **burn rate** over a window is the same ratio computed over that
  window: burn 1.0 spends the budget exactly at the sustainable rate,
  burn 14.4 spends a 30-day budget in 2 days. Alerts use the
  multi-window form (Google SRE workbook ch.5): a *fast* pair (long +
  short window, high threshold — pages on sudden cliffs without
  flapping) and a *slow* pair (longer windows, low threshold — catches
  quiet budget leaks).

Events stream into O(1)-memory time-bucketed rings
(:class:`WindowedRatio`): per objective, two counters per bucket,
ring length fixed by the longest configured window. No per-event
storage — the tracker holds its account over millions of queries.

Wiring (see :meth:`dgmc_tpu_torch.obs.run.RunObserver.attach_slo`): the
tracker joins ``/metrics`` as the ``dgmc_slo_*`` families
(strict-parser pinned in CI), joins ``/status`` as the ``slo`` section,
is flushed to ``slo.json`` by every ``RunObserver.flush``, and dumps
the flight recorder through ``on_breach`` when a budget exhausts or a
fast-burn alert fires — the trailing context is on disk before a human
looks.

Stdlib only (no torch): the tracker runs in serving workers and the
report path without a backend bring-up.
"""

import json
import math
import threading
import time

__all__ = ['SloSpec', 'SloTracker', 'WindowedRatio', 'load_slo_spec',
           'DEFAULT_BURN_WINDOWS', 'DEFAULT_SERVE_SPEC',
           'SLO_SCHEMA_VERSION']

SLO_SCHEMA_VERSION = 1

#: The multi-window multi-burn-rate alert pairs (SRE workbook ch.5
#: shape, scaled to this repo's minutes-long CI rounds rather than
#: 30-day product windows): the FAST pair pages on a cliff — budget
#: burning >= ``threshold``x sustainable over both the long leg and the
#: recent short leg (the short leg stops a recovered incident from
#: alerting for the rest of the hour); the SLOW pair catches a quiet
#: leak the fast thresholds ignore.
DEFAULT_BURN_WINDOWS = {
    'fast': {'long_s': 3600.0, 'short_s': 300.0, 'threshold': 14.4},
    'slow': {'long_s': 21600.0, 'short_s': 1800.0, 'threshold': 6.0},
}

#: The serving default a serving benchmark writes when no spec file is
#: given explicitly: availability 99.9%, an end-to-end latency
#: objective, and a device_execute stage objective over the qtrace
#: span vocabulary. Floors are deliberately absent here — they are
#: deployment-specific pins, not defaults.
DEFAULT_SERVE_SPEC = {
    'name': 'serve-default',
    'window_s': 3600.0,
    'availability': {'objective': 0.999},
    'latency': [
        {'name': 'query', 'threshold_ms': 1000.0, 'objective': 0.95},
        {'name': 'device_execute', 'stage': 'device_execute',
         'threshold_ms': 500.0, 'objective': 0.95},
    ],
    'burn_windows': DEFAULT_BURN_WINDOWS,
}


class WindowedRatio:
    """Good/total event counts over trailing windows, O(1) memory.

    A fixed ring of time buckets (``bucket_s`` wide, enough buckets to
    cover ``horizon_s``); :meth:`add` increments the current bucket,
    :meth:`ratio` sums the buckets covering a trailing window. Buckets
    older than the horizon are overwritten in place — the ring never
    grows, and there is no per-event storage.
    Thread-safe: serve handler threads add concurrently.
    """

    def __init__(self, horizon_s, bucket_s=None, time_fn=time.time):
        if bucket_s is None:
            # <= 64 buckets over the horizon, floor 1s: coarse enough
            # to stay O(1)-small, fine enough that a window quantizes
            # to within ~2% of its nominal span. Callers whose SHORTEST
            # window is much smaller than the horizon must pass a
            # matching bucket_s (SloTracker does).
            bucket_s = max(1.0, float(horizon_s) / 64.0)
        self.bucket_s = float(bucket_s)
        self.horizon_s = float(horizon_s)
        self._n = max(2, int(math.ceil(horizon_s / bucket_s)) + 1)
        self._bad = [0] * self._n
        self._total = [0] * self._n
        self._epoch = [None] * self._n  # bucket index each slot holds
        self._time = time_fn
        self._lock = threading.Lock()

    def _slot(self, now):
        """Ring slot for ``now``, clearing a stale slot on reuse."""
        epoch = int(now // self.bucket_s)
        i = epoch % self._n
        if self._epoch[i] != epoch:
            self._epoch[i] = epoch
            self._bad[i] = 0
            self._total[i] = 0
        return i

    def add(self, ok, now=None):
        now = self._time() if now is None else now
        with self._lock:
            i = self._slot(now)
            self._total[i] += 1
            if not ok:
                self._bad[i] += 1

    def counts(self, window_s, now=None):
        """``(bad, total)`` over the trailing ``window_s``."""
        now = self._time() if now is None else now
        window_s = min(float(window_s), self.horizon_s)
        oldest = int((now - window_s) // self.bucket_s)
        newest = int(now // self.bucket_s)
        bad = total = 0
        with self._lock:
            for epoch in range(max(oldest + 1, newest - self._n + 1),
                               newest + 1):
                i = epoch % self._n
                if self._epoch[i] == epoch:
                    bad += self._bad[i]
                    total += self._total[i]
        return bad, total

    def bad_fraction(self, window_s, now=None):
        """Bad/total over the window; ``None`` with no events (an
        empty window has no failure rate, not a zero one)."""
        bad, total = self.counts(window_s, now=now)
        if not total:
            return None
        return bad / total


def _require_fraction(value, what):
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(f'slo spec: {what} must be a number, '
                         f'got {value!r}')
    if not 0.0 < v < 1.0:
        raise ValueError(f'slo spec: {what} must be in (0, 1), got {v}')
    return v


class SloSpec:
    """One validated SLO spec (see :func:`load_slo_spec` for the file
    form). Objectives carry a stable ``name`` used in metric labels,
    ``slo.json`` keys and breach reasons."""

    def __init__(self, raw):
        if not isinstance(raw, dict):
            raise ValueError(f'slo spec: expected an object, '
                             f'got {type(raw).__name__}')
        self.raw = raw
        self.name = str(raw.get('name') or 'slo')
        self.window_s = float(raw.get('window_s') or 3600.0)
        if self.window_s <= 0:
            raise ValueError('slo spec: window_s must be positive')
        self.bucket_s = raw.get('bucket_s')

        self.objectives = []  # (name, kind, objective, threshold_s, stage)
        avail = raw.get('availability')
        if avail is not None:
            self.objectives.append({
                'name': 'availability', 'kind': 'availability',
                'objective': _require_fraction(
                    avail.get('objective'), 'availability.objective'),
                'threshold_s': None, 'stage': None})
        for i, lat in enumerate(raw.get('latency') or ()):
            stage = lat.get('stage')
            name = str(lat.get('name') or stage or f'latency_{i}')
            thr_ms = lat.get('threshold_ms')
            if not isinstance(thr_ms, (int, float)) or thr_ms <= 0:
                raise ValueError(f'slo spec: latency[{i}].threshold_ms '
                                 f'must be a positive number, '
                                 f'got {thr_ms!r}')
            self.objectives.append({
                'name': name, 'kind': 'latency',
                'objective': _require_fraction(
                    lat.get('objective'), f'latency[{i}].objective'),
                'threshold_s': float(thr_ms) / 1e3,
                'stage': str(stage) if stage else None})
        if not self.objectives:
            raise ValueError('slo spec: no objectives (need '
                             '"availability" and/or "latency")')
        names = [o['name'] for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f'slo spec: duplicate objective names '
                             f'{names}')

        self.burn_windows = {}
        for wname, w in (raw.get('burn_windows')
                         or DEFAULT_BURN_WINDOWS).items():
            long_s, short_s = float(w['long_s']), float(w['short_s'])
            if not 0 < short_s <= long_s:
                raise ValueError(f'slo spec: burn window {wname!r} '
                                 f'needs 0 < short_s <= long_s')
            self.burn_windows[str(wname)] = {
                'long_s': long_s, 'short_s': short_s,
                'threshold': float(w['threshold'])}

        #: Absolute floors on plane headlines (gauges, not event
        #: streams): breaching is reported, and counts as a breach
        #: event, but consumes no latency/availability budget.
        self.floors = {}
        for key in ('hits1_floor', 'goodput_floor'):
            if raw.get(key) is not None:
                self.floors[key[:-len('_floor')]] = float(raw[key])

    @property
    def horizon_s(self):
        longest = max([self.window_s]
                      + [w['long_s'] for w in self.burn_windows.values()])
        return longest

    @property
    def ring_bucket_s(self):
        """Bucket width for the shared rings: explicit ``bucket_s``
        if the spec pins one, else sized so the SHORTEST configured
        window spans >= 6 buckets (quantization error <= ~17% of the
        short burn leg, not 100% of it), floored at 1s."""
        if self.bucket_s is not None:
            return float(self.bucket_s)
        shortest = min([self.window_s]
                       + [w['short_s'] for w in self.burn_windows.values()])
        return max(1.0, shortest / 6.0)

    def describe(self):
        """The spec back as plain data (what ``slo.json`` embeds)."""
        return {
            'name': self.name,
            'window_s': self.window_s,
            'objectives': [dict(o) for o in self.objectives],
            'burn_windows': dict(self.burn_windows),
            'floors': dict(self.floors),
        }


def load_slo_spec(path):
    """Parse + validate an SLO spec file. Raises ``ValueError`` with
    the offending field named — a malformed SLO must fail the CLI at
    startup, not silently judge nothing."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise ValueError(f'slo spec: cannot read {path}: {e}')
    except json.JSONDecodeError as e:
        raise ValueError(f'slo spec: {path} is not valid JSON: {e}')
    return SloSpec(raw)


class SloTracker:
    """Live error-budget accounting for one :class:`SloSpec`.

    :meth:`record` feeds one event (a served query, or a training
    step): availability counts ``ok``; each latency objective counts
    the event's latency — end-to-end by default, or the named qtrace
    stage from ``stages_ms``. :meth:`check` (called at every observer
    flush) evaluates budgets and burn windows and fires ``on_breach``
    — rate-limited per breach kind — on budget exhaustion or a burning
    alert pair. All reads come from the same rings the exports read:
    ``/metrics``, ``/status`` and ``slo.json`` can never disagree.
    """

    #: Seconds between repeated ``on_breach`` calls for the same kind:
    #: the flight recorder needs the FIRST trailing context, not one
    #: dump per flush while the budget stays exhausted.
    BREACH_COOLDOWN_S = 60.0

    def __init__(self, spec, time_fn=time.time, on_breach=None):
        self.spec = spec
        self._time = time_fn
        self._on_breach = on_breach
        self._rings = {
            o['name']: WindowedRatio(spec.horizon_s,
                                     bucket_s=spec.ring_bucket_s,
                                     time_fn=time_fn)
            for o in spec.objectives}
        self._lock = threading.Lock()
        self._good = {o['name']: 0 for o in spec.objectives}
        self._bad = {o['name']: 0 for o in spec.objectives}
        self._gauges = {}          # hits1 / goodput headline values
        self._breach_counts = {}   # kind -> count
        self._breach_last = {}     # kind -> unix time of last on_breach
        self._last_breach = None

    # -- event intake ------------------------------------------------------

    def record(self, ok, latency_s=None, stages_ms=None, now=None):
        """One event: ``ok`` feeds availability; ``latency_s`` (and the
        per-stage ``stages_ms`` mapping, qtrace vocabulary) feed the
        latency objectives. A failed event with no latency counts as
        bad for every latency objective too — an error is not a fast
        success."""
        now = self._time() if now is None else now
        for o in self.spec.objectives:
            name = o['name']
            if o['kind'] == 'availability':
                good = bool(ok)
            else:
                if not ok:
                    good = False
                else:
                    if o['stage'] is not None:
                        val_ms = (stages_ms or {}).get(o['stage'])
                        val = None if val_ms is None else val_ms / 1e3
                    else:
                        val = latency_s
                    if val is None:
                        continue  # unmeasured: no evidence either way
                    good = val <= o['threshold_s']
            self._rings[name].add(good, now=now)
            with self._lock:
                if good:
                    self._good[name] += 1
                else:
                    self._bad[name] += 1

    def update_gauges(self, **values):
        """Refresh the floor-checked plane headlines (``hits1=``,
        ``goodput=``); ``None`` values clear — absence stays absent."""
        with self._lock:
            for key, val in values.items():
                if val is None:
                    self._gauges.pop(key, None)
                else:
                    self._gauges[key] = float(val)

    # -- judgment ----------------------------------------------------------

    def _objective_state(self, o, now):
        name = o['name']
        ring = self._rings[name]
        budget = 1.0 - o['objective']
        frac = ring.bad_fraction(self.spec.window_s, now=now)
        consumed = None if frac is None else frac / budget
        burn = {}
        for wname, w in self.spec.burn_windows.items():
            fl = ring.bad_fraction(w['long_s'], now=now)
            fs = ring.bad_fraction(w['short_s'], now=now)
            bl = None if fl is None else fl / budget
            bs = None if fs is None else fs / budget
            burn[wname] = {
                'long': bl, 'short': bs,
                'threshold': w['threshold'],
                # The multi-window AND: both legs over threshold. An
                # unmeasured leg cannot alert — no evidence, no page.
                'alerting': (bl is not None and bs is not None
                             and bl >= w['threshold']
                             and bs >= w['threshold']),
            }
        with self._lock:
            good, bad = self._good[name], self._bad[name]
        return {
            'kind': o['kind'],
            'objective': o['objective'],
            'threshold_ms': (None if o['threshold_s'] is None
                             else o['threshold_s'] * 1e3),
            'stage': o['stage'],
            'events': good + bad,
            'bad': bad,
            'window_bad_fraction': frac,
            'budget_consumed': consumed,
            'burn': burn,
        }

    def _breach(self, kind, detail, now):
        with self._lock:
            self._breach_counts[kind] = \
                self._breach_counts.get(kind, 0) + 1
            self._last_breach = {'kind': kind, 'time': now,
                                 'detail': detail}
            last = self._breach_last.get(kind)
            fire = last is None or now - last >= self.BREACH_COOLDOWN_S
            if fire:
                self._breach_last[kind] = now
        if fire and self._on_breach is not None:
            try:
                self._on_breach(kind, detail)
            except Exception:
                pass  # judging must never take the service down

    def check(self, now=None):
        """Evaluate every objective; fire breaches. Returns the full
        state dict (the ``slo.json`` / ``/status`` body)."""
        now = self._time() if now is None else now
        objectives = {}
        for o in self.spec.objectives:
            state = self._objective_state(o, now)
            objectives[o['name']] = state
            consumed = state['budget_consumed']
            if consumed is not None and consumed >= 1.0:
                self._breach(
                    f'budget-exhausted:{o["name"]}',
                    {'objective': o['name'],
                     'budget_consumed': round(consumed, 4),
                     'window_s': self.spec.window_s}, now)
            for wname, b in state['burn'].items():
                if b['alerting']:
                    self._breach(
                        f'burn:{wname}:{o["name"]}',
                        {'objective': o['name'], 'window': wname,
                         'burn_long': round(b['long'], 4),
                         'burn_short': round(b['short'], 4),
                         'threshold': b['threshold']}, now)

        floors = {}
        with self._lock:
            gauges = dict(self._gauges)
        for key, floor in self.spec.floors.items():
            value = gauges.get(key)
            breached = value is not None and value < floor
            floors[key] = {'floor': floor, 'value': value,
                           'breached': breached}
            if breached:
                self._breach(f'floor:{key}',
                             {'floor': floor, 'value': value}, now)

        with self._lock:
            breaches = {'counts': dict(self._breach_counts),
                        'last': (dict(self._last_breach)
                                 if self._last_breach else None)}
        return {
            'version': SLO_SCHEMA_VERSION,
            'slo': self.spec.name,
            'time': now,
            'spec': self.spec.describe(),
            'objectives': objectives,
            'floors': floors,
            'breaches': breaches,
        }

    # -- exports -----------------------------------------------------------

    def snapshot(self):
        """The ``slo.json`` body (alias of :meth:`check`: flushing IS
        a judgment pass, so a breach can never be newer than the
        artifact that records it)."""
        return self.check()

    def status(self):
        """The ``/status`` ``slo`` section: :meth:`check` without the
        spec echo (the scrape stays small; the spec is in slo.json)."""
        out = self.check()
        out.pop('spec', None)
        return out

    def metric_families(self):
        """The ``dgmc_slo_*`` families for ``/metrics``."""
        state = self.check()
        slo = self.spec.name
        consumed, burn, events, alerting = [], [], [], []
        for name, o in sorted(state['objectives'].items()):
            lbl = {'slo': slo, 'objective': name}
            if o['budget_consumed'] is not None:
                consumed.append(('', lbl, round(o['budget_consumed'], 6)))
            events.append(('', dict(lbl, outcome='good'),
                           o['events'] - o['bad']))
            events.append(('', dict(lbl, outcome='bad'), o['bad']))
            for wname, b in sorted(o['burn'].items()):
                for leg in ('long', 'short'):
                    if b[leg] is not None:
                        burn.append(
                            ('', dict(lbl, window=wname, leg=leg),
                             round(b[leg], 6)))
                alerting.append(('', dict(lbl, window=wname),
                                 1 if b['alerting'] else 0))
        families = [
            ('dgmc_slo_error_budget_consumed', 'gauge',
             'Error-budget consumption over the SLO compliance window '
             '(1.0 = spent).', consumed),
            ('dgmc_slo_burn_rate', 'gauge',
             'Error-budget burn rate per alert window leg '
             '(1.0 = sustainable).', burn),
            ('dgmc_slo_burn_alerting', 'gauge',
             'Multi-window burn alert state (both legs over '
             'threshold).', alerting),
            ('dgmc_slo_events_total', 'counter',
             'SLO events by objective and outcome.', events),
            ('dgmc_slo_breaches_total', 'counter',
             'Breach events (budget exhaustion, burn alerts, floor '
             'violations) by kind.',
             [('', {'slo': slo, 'kind': kind}, count)
              for kind, count in
              sorted(state['breaches']['counts'].items())] or
             [('', {'slo': slo, 'kind': 'none'}, 0)]),
        ]
        floors = [
            ('', {'slo': slo, 'floor': key},
             1 if f['breached'] else 0)
            for key, f in sorted(state['floors'].items())
            if f['value'] is not None]
        if floors:
            families.append(
                ('dgmc_slo_floor_breached', 'gauge',
                 'Plane-headline floor state (hits1/goodput below its '
                 'configured absolute floor).', floors))
        return families
