"""Streaming anomaly watch: EWMA z-scores + CUSUM changepoints, O(1) memory.

The port's copy of the JAX package's ``dgmc_tpu/obs/anomaly.py`` (the
same schema, keys and metric families).

The flight recorder captures trailing context *when asked* —
a watchdog fires, an SLO budget exhausts, a human hits ``/debug``. A
silent degradation (a slow drift in step latency, a quiet jump in
guard skips after a deploy) never asks. This module is the asking:
constant-memory detectors watch the signals the planes already
measure and arm the flight recorder the moment a signal leaves its
own recent history.

Two detectors run per signal, catching different shapes:

- **EWMA z-score**: exponentially-weighted running mean and variance
  (West 1979 incremental form); a sample more than ``z_threshold``
  robust deviations from the running mean flags a *spike*. Catches
  cliffs; forgets them at rate ``alpha``.
- **CUSUM** (Page 1954) on the standardized residuals:
  ``s+ = max(0, s+ + z - k)`` and the mirrored ``s-``; crossing ``h``
  flags a sustained *shift* — a mean change too small for any single
  sample to look odd. The classic tuning ``k = 0.5`` (sensitive to
  ~1-sigma shifts) with ``h = 5`` gives an in-control average run
  length of ~930 samples, i.e. under one false positive per thousand
  white-noise samples.

Events land in a **bounded** ring (explicit length check + oldest
eviction, ``truncated`` counter) flushed as
``anomalies.json`` by every RunObserver flush, and the rate-limited
``on_anomaly`` callback feeds ``RunObserver.flight_dump`` so the
trailing context of the FIRST excursion is on disk before anyone
looks.

Signal vocabulary (what the wiring feeds — the watch itself accepts
any name): ``step_latency_s``, ``query_latency_s``, ``qps``,
``compile_events``, ``guard_skips``, ``quality_margin``.

:func:`changepoints` is the same CUSUM run offline over a short
committed series — ``obs.timeline --trend`` uses it to mark the
round where a longitudinal metric shifted.

Stdlib only (no torch).
"""

import math
import threading
import time

__all__ = ['EwmaDetector', 'CusumDetector', 'AnomalyWatch',
           'changepoints', 'ANOMALY_SCHEMA_VERSION', 'WATCHED_SIGNALS']

ANOMALY_SCHEMA_VERSION = 1

#: The signals the standard wiring feeds (documentation + the
#: serve-bench boundedness gate iterates it); the watch accepts any
#: signal name.
WATCHED_SIGNALS = ('step_latency_s', 'query_latency_s', 'qps',
                   'compile_events', 'guard_skips', 'quality_margin')


class EwmaDetector:
    """Exponentially-weighted mean/variance with z-score spike checks.

    ``observe`` returns the standardized residual z of the sample
    against the *pre-update* state (a spike must not first inflate the
    variance it is judged by), then folds the sample in. The first
    ``warmup`` samples only train — cold stats flag everything.
    """

    def __init__(self, alpha=0.1, z_threshold=4.0, warmup=10,
                 min_sigma=1e-9):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f'alpha must be in (0, 1], got {alpha}')
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self.min_sigma = float(min_sigma)
        self.count = 0
        self.mean = 0.0
        self.var = 0.0

    def observe(self, value):
        """Fold in ``value``; return ``(z, spiked)`` — ``z`` is
        ``None`` during warmup."""
        value = float(value)
        z = None
        if self.count >= self.warmup:
            sigma = math.sqrt(max(self.var, 0.0))
            # A dead-flat history (constant signal) gets a floor
            # rather than an infinite z on the first wiggle.
            sigma = max(sigma, self.min_sigma,
                        abs(self.mean) * 1e-6)
            z = (value - self.mean) / sigma
        if self.count == 0:
            self.mean = value
        else:
            delta = value - self.mean
            self.mean += self.alpha * delta
            # West-style EWMA variance of the residuals.
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * delta * delta)
        self.count += 1
        spiked = z is not None and abs(z) >= self.z_threshold
        return z, spiked


class CusumDetector:
    """Two-sided CUSUM on standardized residuals.

    ``observe(z)`` accumulates ``s+ = max(0, s+ + z - k)`` and
    ``s- = max(0, s- - z - k)``; either crossing ``h`` signals a
    sustained shift, after which both sums reset (one changepoint per
    excursion, not one per sample while shifted).
    """

    def __init__(self, k=0.5, h=5.0):
        self.k = float(k)
        self.h = float(h)
        self.s_pos = 0.0
        self.s_neg = 0.0

    def observe(self, z):
        """Accumulate one standardized residual; return ``(shifted,
        direction)`` where direction is ``'up'``/``'down'``/``None``."""
        z = float(z)
        self.s_pos = max(0.0, self.s_pos + z - self.k)
        self.s_neg = max(0.0, self.s_neg - z - self.k)
        if self.s_pos >= self.h:
            self.s_pos = self.s_neg = 0.0
            return True, 'up'
        if self.s_neg >= self.h:
            self.s_pos = self.s_neg = 0.0
            return True, 'down'
        return False, None


class _SignalWatch:
    """One signal's detector pair + counters (internal)."""

    def __init__(self, alpha, z_threshold, warmup, k, h):
        self.ewma = EwmaDetector(alpha=alpha, z_threshold=z_threshold,
                                 warmup=warmup)
        self.cusum = CusumDetector(k=k, h=h)
        self.samples = 0
        self.spikes = 0
        self.shifts = 0
        self.last_value = None
        self.last_z = None


class AnomalyWatch:
    """The per-run anomaly account: many signals, one bounded ring.

    ``observe(signal, value)`` runs the detector pair and, on a spike
    or shift, appends an event to the ring (evicting the oldest past
    ``capacity`` and counting the truncation) and fires the
    rate-limited ``on_anomaly`` callback. Thread-safe — serve handler
    threads and the flush loop feed it concurrently.
    """

    #: Seconds between ``on_anomaly`` callbacks per signal: the flight
    #: recorder wants the FIRST excursion's trailing context, not a
    #: dump per sample while the signal stays strange.
    CALLBACK_COOLDOWN_S = 60.0

    def __init__(self, capacity=256, alpha=0.1, z_threshold=4.0,
                 warmup=10, cusum_k=0.5, cusum_h=5.0,
                 time_fn=time.time, on_anomaly=None):
        if capacity < 1:
            raise ValueError(f'capacity must be >= 1, got {capacity}')
        self.capacity = int(capacity)
        self._params = (float(alpha), float(z_threshold), int(warmup),
                        float(cusum_k), float(cusum_h))
        self._time = time_fn
        self._on_anomaly = on_anomaly
        self._lock = threading.Lock()
        self._signals = {}
        self._ring = []        # bounded: len() check + eviction below
        self._truncated = 0
        self._callback_last = {}

    def observe(self, signal, value, now=None):
        """Feed one sample; returns the event dict if it anomaled,
        else ``None``."""
        now = self._time() if now is None else now
        fire = None
        with self._lock:
            w = self._signals.get(signal)
            if w is None:
                w = self._signals[signal] = _SignalWatch(*self._params)
            z, spiked = w.ewma.observe(value)
            shifted, direction = (False, None)
            if z is not None:
                shifted, direction = w.cusum.observe(z)
            w.samples += 1
            w.last_value = float(value)
            w.last_z = z
            if not (spiked or shifted):
                return None
            kinds = []
            if spiked:
                w.spikes += 1
                kinds.append('spike')
            if shifted:
                w.shifts += 1
                kinds.append('shift')
            event = {
                'signal': signal,
                'kinds': kinds,
                'direction': (direction if shifted
                              else ('up' if z >= 0 else 'down')),
                'value': float(value),
                'z': round(z, 4),
                'mean': round(w.ewma.mean, 6),
                'sample': w.samples,
                'time': now,
            }
            # Bounded ring: evict the oldest past capacity
            # and account for the loss — the artifact says how much
            # history it dropped, never silently.
            self._ring.append(event)
            if len(self._ring) > self.capacity:
                del self._ring[0]
                self._truncated += 1
            last = self._callback_last.get(signal)
            if last is None or now - last >= self.CALLBACK_COOLDOWN_S:
                self._callback_last[signal] = now
                fire = event
        if fire is not None and self._on_anomaly is not None:
            try:
                self._on_anomaly(fire)
            except Exception:
                pass  # watching must never take the service down
        return event

    # -- exports -----------------------------------------------------------

    def counters(self):
        """Small per-signal account (the ``/status`` body)."""
        with self._lock:
            return {
                'signals': {
                    name: {'samples': w.samples, 'spikes': w.spikes,
                           'shifts': w.shifts,
                           'last_value': w.last_value,
                           'last_z': (None if w.last_z is None
                                      else round(w.last_z, 4))}
                    for name, w in sorted(self._signals.items())},
                'events': len(self._ring),
                'truncated': self._truncated,
            }

    def snapshot(self):
        """The ``anomalies.json`` body: bounded event ring + account."""
        with self._lock:
            return {
                'version': ANOMALY_SCHEMA_VERSION,
                'capacity': self.capacity,
                'truncated': self._truncated,
                'signals': {
                    name: {'samples': w.samples, 'spikes': w.spikes,
                           'shifts': w.shifts}
                    for name, w in sorted(self._signals.items())},
                'events': [dict(e) for e in self._ring],
            }

    def metric_families(self):
        """The ``dgmc_anomaly_*`` families for ``/metrics``."""
        with self._lock:
            spikes = [('', {'signal': name}, w.spikes)
                      for name, w in sorted(self._signals.items())]
            shifts = [('', {'signal': name}, w.shifts)
                      for name, w in sorted(self._signals.items())]
            truncated = self._truncated
        return [
            ('dgmc_anomaly_spikes_total', 'counter',
             'EWMA z-score spike detections by signal.',
             spikes or [('', {'signal': 'none'}, 0)]),
            ('dgmc_anomaly_shifts_total', 'counter',
             'CUSUM sustained-shift detections by signal.',
             shifts or [('', {'signal': 'none'}, 0)]),
            ('dgmc_anomaly_ring_truncated_total', 'counter',
             'Anomaly events evicted from the bounded ring.',
             [('', {}, truncated)]),
        ]


def changepoints(series, k=0.5, h=4.0, warmup=3):
    """Offline CUSUM over a short committed series (timeline rounds).

    Standardizes against the median and the MAD-derived robust sigma
    of the first ``warmup`` values (the baseline the trend is judged
    FROM — a late regression must not inflate the scale it is judged
    by), then runs the same two-sided CUSUM the live watch uses.
    Returns ``[{'index', 'direction', 'value'}, ...]``; ``None``
    entries in ``series`` are skipped without breaking the
    accumulation. Tuned looser than the live watch (``h=4``,
    ``warmup=3``) because committed rounds are few and each point is
    already an aggregate.
    """
    vals = [(i, float(v)) for i, v in enumerate(series) if v is not None]
    if len(vals) <= warmup:
        return []
    base = sorted(v for _, v in vals[:warmup])
    n = len(base)
    median = (base[n // 2] if n % 2 else
              0.5 * (base[n // 2 - 1] + base[n // 2]))
    abs_dev = sorted(abs(v - median) for v in base)
    mad = (abs_dev[n // 2] if n % 2 else
           0.5 * (abs_dev[n // 2 - 1] + abs_dev[n // 2]))
    sigma = 1.4826 * mad
    # A flat baseline (common with 3 rounds of a stable metric) gets
    # a relative floor so real shifts still standardize finitely.
    sigma = max(sigma, abs(median) * 0.01, 1e-12)
    det = CusumDetector(k=k, h=h)
    out = []
    for i, v in vals:
        shifted, direction = det.observe((v - median) / sigma)
        if shifted:
            out.append({'index': i, 'direction': direction, 'value': v})
            # Re-baseline at the new level: a sustained shift is ONE
            # changepoint, not one per subsequent round that stays
            # there (the CUSUM reset alone is not enough — the old
            # median would re-accumulate immediately).
            median = v
    return out
