"""Quality plane: the accuracy counterpart of the latency account.

The port's copy of the JAX package's ``dgmc_tpu/obs/quality.py`` (the
same schema, keys and metric families).

The obs plane can attribute a 152 ms tail to ``admission_queue_wait``
but, before this module, could not say whether the matcher's *answers*
got worse — Hits@1 (the paper's headline metric) was computed in the
eval loops and discarded. :class:`QualityTracker` is the missing
instrument, one tracker per :class:`~dgmc_tpu_torch.obs.run.RunObserver`,
fed from three directions:

* **Eval accounting** — the experiment CLIs push their per-epoch
  summaries (the :func:`dgmc_tpu_torch.models.evalsum.eval_summary` dict:
  Hits@1/@k, MRR, loss) through :meth:`QualityTracker.observe_eval`;
  the tracker keeps first/last/best per scenario and a run-level
  headline (the last eval observed).
* **Consensus convergence** — ``consensus_delta`` probe records (the
  per-iteration ``delta_norm`` emitted inside ``DGMC.__call__``) feed
  :meth:`observe_consensus`; the tracker derives iterations-to-converge
  (first refinement iteration whose mean correction fell under
  ``tol`` × the first iteration's).
* **Serve-side confidence** — the engine's cheap in-graph per-query
  proxies (row entropy, top-1/top-2 margin, final correction norm,
  shortlist saturation) land in streaming histograms exported as
  ``dgmc_query_quality{signal=...}``, beside the low-confidence breach
  counter and the shadow audit's recall account.

``RunObserver.flush`` writes :meth:`payload` as ``quality.json`` — a
schema-pinned artifact ``obs.report`` renders, ``obs.timeline`` grows
columns from, and ``obs.diff`` gates with ``--max-hits1-regression`` /
``--min-hits1``.

Like every obs reader, this module imports no torch.
"""

import hashlib
import math
import threading

from dgmc_tpu_torch.obs.live import StreamingHistogram

__all__ = ['QUALITY_SCHEMA_VERSION', 'QUALITY_SIGNALS', 'QUALITY_BOUNDS',
           'audit_keep', 'QualityTracker']

#: Bumped whenever quality.json's keyset changes; readers check it
#: before trusting field semantics.
QUALITY_SCHEMA_VERSION = 1

#: The per-query confidence proxies the serve engine computes in-graph.
QUALITY_SIGNALS = ('entropy', 'margin', 'correction', 'saturation')

#: Geometric bucket bounds for the quality histograms: the signals are
#: unitless and span entropy ~ln(k) down to correction norms ~1e-3, so
#: the grid runs 1e-3 .. ~1.2e3 at 25% resolution.
QUALITY_BOUNDS = tuple(0.001 * 1.25 ** i for i in range(64))

#: Cap on the audited-trace-id list carried in quality.json — the ids
#: pin sampling determinism in tests without growing the artifact
#: unboundedly on long-lived services.
AUDIT_TRACE_ID_CAP = 256

#: Convergence tolerance: the consensus loop counts as converged at the
#: first iteration whose mean ``delta_norm`` is under this fraction of
#: the first iteration's.
CONVERGE_TOL = 0.05


def audit_keep(seed, trace_id, rate):
    """Deterministic keep decision for the shadow audit — the qtrace
    retention discipline: a seeded hash of the trace id mapped to
    [0, 1) and compared against the sample rate, so the audited set is
    a pure function of (seed, trace ids) and byte-identical across
    runs, restarts and replicas."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(f'{seed}:audit:{trace_id}'.encode()).digest()
    return int.from_bytes(digest[:8], 'big') / 2.0 ** 64 < rate


def _finite(v):
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


class QualityTracker:
    """Run-level accuracy accounting; all methods thread-safe (probe
    callbacks, handler threads, the audit thread and the flush loop all
    feed one tracker)."""

    def __init__(self):
        self._lock = threading.Lock()
        # --- eval side -------------------------------------------------
        self._scenarios = {}
        self._headline = {'scenario': None, 'step': None, 'metrics': {}}
        # --- consensus side --------------------------------------------
        self._consensus = {}   # iteration -> [count, total, last]
        self._consensus_events = 0
        # --- serve side ------------------------------------------------
        self._hists = {s: StreamingHistogram(QUALITY_BOUNDS)
                       for s in QUALITY_SIGNALS}
        self._queries = 0
        self._saturated_queries = 0
        self._low_confidence = 0
        self._audit_rate = None
        self._audit_seed = None
        self._audited = 0
        self._audit_exact = 0
        self._audit_recall_sum = 0.0
        self._audit_recall_min = None
        self._audit_trace_ids = []
        self._audit_truncated = 0

    # --- eval accounting ----------------------------------------------

    def observe_eval(self, scenario, summary, step=None):
        """One eval-split summary (the ``eval_summary`` dict: ``count``
        plus named fractions / ``loss``). Keeps first/last/best per
        metric per scenario; the LAST call run-wide becomes the
        headline ``obs.report`` summarizes and ``obs.diff`` gates."""
        metrics = {k: _finite(v) for k, v in summary.items()
                   if k != 'count' and _finite(v) is not None}
        count = _finite(summary.get('count'))
        with self._lock:
            sc = self._scenarios.setdefault(
                scenario, {'evals': 0, 'count': None, 'step': None,
                           'metrics': {}})
            sc['evals'] += 1
            if count is not None:
                sc['count'] = count
            if step is not None:
                sc['step'] = step
            for name, v in metrics.items():
                m = sc['metrics'].setdefault(
                    name, {'first': v, 'last': v, 'best': v})
                m['last'] = v
                # 'best' is metric-aware: loss improves downward.
                m['best'] = (min(m['best'], v) if name == 'loss'
                             else max(m['best'], v))
            self._headline = {'scenario': scenario, 'step': step,
                              'metrics': dict(metrics)}

    # --- consensus convergence ----------------------------------------

    def observe_consensus(self, iteration, value):
        """One ``consensus_delta`` probe record: the mean row-wise
        correction norm at refinement ``iteration``."""
        v = _finite(value)
        if v is None or iteration is None:
            return
        i = int(iteration)
        with self._lock:
            self._consensus_events += 1
            slot = self._consensus.setdefault(i, [0, 0.0, 0.0])
            slot[0] += 1
            slot[1] += v
            slot[2] = v

    # --- serve-side confidence -----------------------------------------

    def observe_query(self, signals):
        """Per-query confidence proxies from the engine's answer
        (``signals`` carries the :data:`QUALITY_SIGNALS` scalars plus
        ``saturated_frac``)."""
        with self._lock:
            self._queries += 1
            for name in QUALITY_SIGNALS:
                v = _finite(signals.get(name))
                if v is not None:
                    self._hists[name].observe(v)
            sat = _finite(signals.get('saturated_frac'))
            if sat is not None and sat > 0:
                self._saturated_queries += 1

    def record_low_confidence(self):
        """A served answer fell under the ``--min-margin`` floor."""
        with self._lock:
            self._low_confidence += 1
            return self._low_confidence

    # --- shadow audit ---------------------------------------------------

    def set_audit_params(self, rate, seed):
        with self._lock:
            self._audit_rate = float(rate)
            self._audit_seed = int(seed)

    def observe_audit(self, trace_id, recall, exact):
        """One shadow-audited query: shortlist recall@k of the served
        answer against the exhaustive corpus scan."""
        r = _finite(recall)
        with self._lock:
            self._audited += 1
            if exact:
                self._audit_exact += 1
            if r is not None:
                self._audit_recall_sum += r
                self._audit_recall_min = (
                    r if self._audit_recall_min is None
                    else min(self._audit_recall_min, r))
            if len(self._audit_trace_ids) < AUDIT_TRACE_ID_CAP:
                self._audit_trace_ids.append(trace_id)
            else:
                self._audit_truncated += 1

    # --- artifact + exposition -----------------------------------------

    def payload(self):
        """The ``quality.json`` payload. The keyset is PINNED by
        ``tests/obs/test_quality.py`` — additions bump
        :data:`QUALITY_SCHEMA_VERSION`."""
        with self._lock:
            per_iter = {
                str(i): {'count': slot[0],
                         'mean': slot[1] / max(slot[0], 1),
                         'last': slot[2]}
                for i, slot in sorted(self._consensus.items())}
            first_mean = (per_iter[str(min(self._consensus))]['mean']
                          if self._consensus else None)
            final_mean = (per_iter[str(max(self._consensus))]['mean']
                          if self._consensus else None)
            converged_at = None
            if first_mean is not None and first_mean > 0:
                for i in sorted(self._consensus):
                    if per_iter[str(i)]['mean'] <= CONVERGE_TOL * first_mean:
                        converged_at = i
                        break
            signals = {}
            for name in QUALITY_SIGNALS:
                h = self._hists[name]
                signals[name] = (None if not h.count else {
                    'count': h.count,
                    'mean': h.sum / h.count,
                    'p50': h.quantile(0.5),
                    'p95': h.quantile(0.95)})
            return {
                'schema': QUALITY_SCHEMA_VERSION,
                'headline': {'scenario': self._headline['scenario'],
                             'step': self._headline['step'],
                             'metrics': dict(self._headline['metrics'])},
                'scenarios': {
                    name: {'evals': sc['evals'], 'count': sc['count'],
                           'step': sc['step'],
                           'metrics': {m: dict(v) for m, v
                                       in sc['metrics'].items()}}
                    for name, sc in self._scenarios.items()},
                'consensus': {
                    'events': self._consensus_events,
                    'iterations': len(self._consensus),
                    'per_iteration': per_iter,
                    'tol': CONVERGE_TOL,
                    'converged_at': converged_at,
                    'first_mean': first_mean,
                    'final_mean': final_mean,
                },
                'serve': {
                    'queries': self._queries,
                    'low_confidence': self._low_confidence,
                    'saturated_queries': self._saturated_queries,
                    'signals': signals,
                    'audit': {
                        'sample_rate': self._audit_rate,
                        'seed': self._audit_seed,
                        'audited': self._audited,
                        'exact': self._audit_exact,
                        'recall_mean': (
                            self._audit_recall_sum / self._audited
                            if self._audited else None),
                        'recall_min': self._audit_recall_min,
                        'trace_ids': list(self._audit_trace_ids),
                        'truncated': self._audit_truncated,
                    },
                },
            }

    def metric_families(self):
        """Metric families for ``/metrics``: the per-signal
        ``dgmc_query_quality`` histograms plus the breach and audit
        counters. Plugged into ``RunObserver.add_metrics_provider``."""
        with self._lock:
            snaps = {name: self._hists[name].snapshot()
                     for name in QUALITY_SIGNALS
                     if self._hists[name].count}
            low = self._low_confidence
            audited = self._audited
            exact = self._audit_exact
            recall_min = self._audit_recall_min
        samples = []
        for name in QUALITY_SIGNALS:
            snap = snaps.get(name)
            if snap is None:
                continue
            for bound, cum in snap['buckets']:
                le = '+Inf' if math.isinf(bound) else repr(float(bound))
                samples.append(
                    ('_bucket', {'signal': name, 'le': le}, cum))
            samples.append(('_sum', {'signal': name}, snap['sum']))
            samples.append(('_count', {'signal': name}, snap['count']))
        fams = [
            ('dgmc_query_quality', 'histogram',
             'Per-query answer-confidence proxies by signal (entropy, '
             'margin, correction, saturation).', samples),
            ('dgmc_quality_low_confidence_total', 'counter',
             'Served answers under the --min-margin confidence floor.',
             [('', {}, low)]),
            ('dgmc_quality_audited_total', 'counter',
             'Live queries re-scored by the shadow audit.',
             [('', {}, audited)]),
            ('dgmc_quality_audit_exact_total', 'counter',
             'Shadow-audited queries whose served shortlist matched the '
             'exhaustive scan exactly (recall 1.0).',
             [('', {}, exact)]),
        ]
        if recall_min is not None:
            fams.append(
                ('dgmc_quality_audit_recall_min', 'gauge',
                 'Worst shortlist recall@k the shadow audit has seen.',
                 [('', {}, recall_min)]))
        return fams
