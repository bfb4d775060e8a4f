"""The ``--obs-dir`` facade: one flag, one directory of run telemetry.

The port of the JAX package's ``dgmc_tpu/obs/run.py``.
:class:`RunObserver` bundles the metric sink, the step timer, the compile
watcher, memory snapshots, the dispatch counters, the probe sink, the
watchdog and the live plane behind one directory, with JAX's artifact
names and top-level keys:

- ``metrics.jsonl`` — one record per :meth:`RunObserver.log` call, plus
  (with probes on) one record per probe value.
- ``timings.json`` — step-time percentiles, the compile-event summary
  (captures and ``nvcc`` builds, :mod:`~dgmc_tpu_torch.obs.registry`),
  the run's wall clock, per-probe aggregates.
- ``memory.json`` — labelled device/host memory snapshots.
- ``dispatch.json`` — the kernel-dispatch table of this run.
- ``quality.json`` — the quality plane (:mod:`~dgmc_tpu_torch.obs.quality`).
- ``trace.json`` — the Chrome-trace timeline of steps, compiles and
  probe series (:mod:`~dgmc_tpu_torch.obs.trace`).
- ``anomalies.json`` / ``slo.json`` — the anomaly watch and, with
  ``--slo``, the SLO tracker.
- ``heartbeat.json`` / ``hang_report.json`` — with
  ``--watchdog-deadline`` (:mod:`~dgmc_tpu_torch.obs.watchdog`).
- ``flight.json`` — the flight recorder's dump on an anomaly
  (:mod:`~dgmc_tpu_torch.obs.live`).

- ``efficiency.json`` — the cost account of the programs
  :meth:`RunObserver.record_cost` counted (:mod:`~dgmc_tpu_torch.obs.cost`:
  FLOPs and bytes per stage), with the MFU from the run's observed step
  p50.
- ``goodput.json`` — pad waste and the goodput ratio of the run's padded
  batches (:mod:`~dgmc_tpu_torch.obs.goodput`), weighted by the stage
  FLOPs of the last efficiency account.

With ``--obs-port`` the observer serves the live plane (``/healthz``,
``/metrics`` with ``dgmc_mfu`` and ``dgmc_arith_intensity``, ``/status``)
and advertises the bound port in ``heartbeat.json``.

Every method is a no-op when constructed with a falsy directory, so CLIs
call the observer unconditionally::

    obs = RunObserver(args.obs_dir)      # None => disabled
    with obs:
        for batch in loader:
            with obs.step():
                state, out = step(state, batch, seed)
        obs.log(epoch, loss=loss)
        obs.snapshot_memory(f'epoch{epoch}')

Step times: without ``fence`` (no CLI passes one, as no JAX CLI does) a
step's time is the host's call, which for a captured step is the
replay's launch, not its execution (``timings.json``'s
``steps.fenced_steps`` is then 0). Probes reach the observer through
:mod:`~dgmc_tpu_torch.obs.probes`' tapes: drained at each step
boundary, at every :meth:`flush` and, waiting for the last copies, at
:meth:`close`.

Artifacts are rewritten on every :meth:`flush` (each ``log`` and
``snapshot_memory`` flushes), so a run killed by a timeout still leaves
its telemetry on disk.
"""

import collections
import contextlib
import json
import os
import socket
import sys
import threading
import time

from dgmc_tpu_torch.obs import anomaly as anomaly_mod
from dgmc_tpu_torch.obs import live as live_mod
from dgmc_tpu_torch.obs import probes as probes_mod
from dgmc_tpu_torch.obs import quality as quality_mod
from dgmc_tpu_torch.obs import slo as slo_mod
from dgmc_tpu_torch.obs import goodput as goodput_mod
from dgmc_tpu_torch.obs.memory import memory_snapshot
from dgmc_tpu_torch.obs.observe import MetricLogger, StepTimer, percentile
from dgmc_tpu_torch.obs.registry import (CompileWatcher, add_dispatch_sink,
                                         dispatch_table, padding_bucket_table,
                                         padding_real_table,
                                         remove_dispatch_sink)
from dgmc_tpu_torch.obs.trace import export_chrome_trace
from dgmc_tpu_torch.obs.watchdog import DEFAULT_SIGNALS, Watchdog

__all__ = ['add_obs_flag', 'RunObserver', 'MAX_TRACE_PROBES',
           'padding_baseline']


def add_obs_flag(parser):
    """Register the standard ``--obs-dir`` / ``--probes`` /
    ``--watchdog-deadline`` / ``--obs-port`` / ``--slo`` flags on an
    argparse parser (JAX's, without ``--fence-deadline``: the collective
    fence has no single-card counterpart)."""
    parser.add_argument(
        '--obs-dir', '--obs_dir', dest='obs_dir', type=str, default=None,
        help='write run telemetry (metrics.jsonl, timings.json, '
             'memory.json, dispatch.json, quality.json, trace.json, '
             'anomalies.json) into this directory')
    parser.add_argument(
        '--probes', action='store_true',
        help='stream in-graph numerics probes (correspondence entropy, '
             'top-k mass, consensus-delta norm, grad norm, non-finite '
             'detection) into the --obs-dir artifacts through a probe '
             'tape each train step writes on the device; off = the '
             'captured step has the launches and outputs of a probe-free '
             'build')
    parser.add_argument(
        '--watchdog-deadline', '--watchdog_deadline',
        dest='watchdog_deadline', type=float, default=None, metavar='SEC',
        help='arm the run-health watchdog: if no step/compile completes '
             'for SEC seconds, or the process receives SIGTERM/SIGALRM, '
             'dump <obs-dir>/hang_report.json (all-thread tracebacks, the '
             'in-flight activity, the last-completed span) and '
             'flight.json; heartbeat.json is rewritten every poll')
    parser.add_argument(
        '--obs-port', '--obs_port', dest='obs_port', type=int,
        default=None, metavar='PORT',
        help='serve the live telemetry plane on this port '
             '(dgmc_tpu_torch/obs/live.py): GET /healthz (200, or 503 '
             'when the watchdog heartbeat is stale), GET /metrics '
             '(Prometheus text exposition: streaming step-latency '
             'histogram, throughput, per-label compile counters, '
             'kernel-dispatch outcomes, probe gauges), GET /status (the '
             'live timings.json summary). 0 picks a free port; the '
             'chosen port is advertised in heartbeat.json. '
             'DGMC_TPU_OBS_BIND sets the bind address (default: all '
             'interfaces)')
    parser.add_argument(
        '--slo', dest='slo', type=str, default=None, metavar='FILE',
        help='judge the run against a declarative SLO spec (JSON: '
             'availability/latency objectives, optional hits@1 floor — '
             'see dgmc_tpu_torch/obs/slo.py): error-budget consumption '
             'and burn rates live in /metrics (dgmc_slo_*) and /status, '
             'flushed to <obs-dir>/slo.json; a budget exhaustion or '
             'fast-burn breach dumps the flight recorder; requires '
             '--obs-dir')
    return parser


def padding_baseline():
    """The padding account as it stands: pass it to
    :class:`RunObserver` as ``padding_since`` to make the collations
    since then the run's (a CLI that collates its batches before it
    builds the observer)."""
    return (RunObserver._count_index(padding_bucket_table()),
            RunObserver._count_index(padding_real_table()))


#: Probe records kept in memory for the trace timeline; past this the
#: oldest fall off (metrics.jsonl still holds the full series, and the
#: aggregates cover every event).
MAX_TRACE_PROBES = 20000


class RunObserver:
    """Facade collecting one run's telemetry into ``obs_dir``.

    ``probes=True`` turns on the in-graph probes
    (:mod:`~dgmc_tpu_torch.obs.probes`) and streams their records into
    ``metrics.jsonl`` (tagged with the observer's index of the step that
    made them), per-probe aggregates into ``timings.json`` and the series
    into ``trace.json``. Build the observer before the first step is
    captured: the switch is read when a graph is captured. The switch is
    flipped even when ``obs_dir`` is falsy (only the sink needs a
    directory). ``padding_since`` (:func:`padding_baseline`) counts the
    collations made since then as the run's; by default the run's are
    those made after the observer is built.
    """

    def __init__(self, obs_dir, probes=False, watchdog_deadline_s=None,
                 obs_port=None, routes=None, padding_since=None):
        self.dir = obs_dir
        self.enabled = bool(obs_dir)
        self.timer = StepTimer()
        self._t_start = time.time()
        self._snapshots = []
        self._watcher = None
        self._step_index = 0
        self._device_times = {}
        self._fence_records = []
        self._pending_compiles = []
        self.watchdog = None
        self._probe_sink = None
        # The probe sink runs where tapes are drained (the main thread);
        # the lock also covers the metrics file shared with log().
        self._probe_lock = threading.Lock()
        self._probe_agg = probes_mod.Aggregator()
        self._probe_records = collections.deque(maxlen=MAX_TRACE_PROBES)
        #: Probe records delivered (vs kept in the bounded timeline):
        #: published as ``probes_truncated``.
        self._probe_seen = 0
        self.first_nonfinite = None
        self._probes_enabled_by_me = False
        self.flight = None
        self.live_port = None
        self._live_hist = None
        self._server = None
        self._live_gauges = {}
        self._metrics_providers = []
        self._status_sections = {}
        self.quality = None
        self.slo = None
        self.anomaly = None
        self._anomaly_compiles_seen = 0
        self._anomaly_skips_seen = 0
        self._last_activity = time.time()
        self._dispatch_sink = None
        self._profiler = None
        self._costs = {}
        self._last_efficiency = None
        if probes:
            self._probes_enabled_by_me = not probes_mod.enabled()
            if self.enabled:
                self._probe_sink = self._on_probe
            probes_mod.enable(self._probe_sink)
        if watchdog_deadline_s and not self.enabled:
            # The hang report needs a directory to land in.
            print('RunObserver: --watchdog-deadline is ignored without '
                  '--obs-dir (hang_report.json needs an obs directory)',
                  file=sys.stderr)
        if obs_port is not None and not self.enabled:
            # The plane serves the obs-dir state; with none behind it an
            # empty run would report healthy forever.
            print('RunObserver: --obs-port is ignored without '
                  '--obs-dir (the live plane serves the obs-dir '
                  'telemetry)', file=sys.stderr)
        # mode='w': an obs dir describes ONE run.
        self._metrics = MetricLogger(
            os.path.join(obs_dir, 'metrics.jsonl') if self.enabled else None,
            mode='w')
        if self.enabled:
            os.makedirs(obs_dir, exist_ok=True)
            self.quality = quality_mod.QualityTracker()
            # Always-on: the trailing context must exist before anyone
            # knows an anomaly is coming.
            self.flight = live_mod.FlightRecorder(
                os.path.join(obs_dir, 'flight.json'))
            self._live_hist = live_mod.StreamingHistogram()
            # Registry counters are process-lifetime; baseline them so the
            # artifacts attribute only this run's activity.
            self._dispatch_base = self._count_index(dispatch_table())
            self._buckets_base, self._real_base = (
                padding_since or padding_baseline())
            self._watcher = CompileWatcher(
                on_event=self._on_compile_event).__enter__()
            self._dispatch_sink = self._on_dispatch
            add_dispatch_sink(self._dispatch_sink)
            if obs_port is not None:
                self._bind_plane(obs_port, routes)
            if watchdog_deadline_s:
                self.watchdog = Watchdog(
                    os.path.join(obs_dir, 'hang_report.json'),
                    deadline_s=watchdog_deadline_s,
                    context_fn=self._watchdog_context,
                    signals=DEFAULT_SIGNALS,
                    heartbeat_path=os.path.join(obs_dir, 'heartbeat.json'),
                    advertise=({'port': self.live_port,
                                'host': self._advertise_host()}
                               if self.live_port else None),
                    on_dump=self.flight_dump).start()
            self.snapshot_memory('start')

    def _bind_plane(self, obs_port, routes):
        """Start the live plane (before the watchdog, so the bound port
        is in every heartbeat). A taken fixed port moves the plane to an
        ephemeral one, re-advertised in ``heartbeat.json``; only a failed
        ephemeral bind leaves the run without a plane."""
        def bind(port):
            return live_mod.TelemetryServer(
                port, health_fn=self.health,
                metrics_fn=self.prometheus_metrics,
                status_fn=self.status, routes=routes,
                host=os.environ.get('DGMC_TPU_OBS_BIND', '')).start()

        try:
            self._server = bind(obs_port)
            self.live_port = self._server.port
        except OSError as e:
            if obs_port:
                try:
                    self._server = bind(0)
                    self.live_port = self._server.port
                    print(f'RunObserver: port {obs_port} is taken ({e}); '
                          f'live telemetry plane moved to ephemeral port '
                          f'{self.live_port} (advertised in '
                          f'heartbeat.json)', file=sys.stderr)
                except OSError as e2:
                    e = e2
            if self._server is None:
                print(f'RunObserver: could not bind the live telemetry '
                      f'plane on port {obs_port} ({e}); continuing '
                      f'without it', file=sys.stderr)

    # -- collection --------------------------------------------------------

    def attach_profiler(self, profiler):
        """Drive a :class:`~dgmc_tpu_torch.obs.trace.ProfileHandle` from
        this observer's step boundaries: each :meth:`step` entry calls
        ``profiler.on_step()`` and the step runs under
        ``profiler.step_annotation()``. Works with the observer disabled
        too."""
        self._profiler = profiler
        return profiler

    @contextlib.contextmanager
    def step(self, fence=None):
        """Time one training/eval step (the host's call; pass ``fence`` a
        device scalar to time its execution)."""
        prof = self._profiler
        if prof is not None:
            prof.on_step()
        ann = (prof.step_annotation(None if not self.enabled
                                    else self._step_index)
               if prof is not None else contextlib.nullcontext())
        if not self.enabled:
            with ann:
                yield
            return
        # Tapes of earlier steps whose copies have landed, before this
        # step's tag is set.
        probes_mod.drain()
        probes_mod.set_step(self._step_index)
        if self.watchdog is not None:
            self.watchdog.beat('step', self._step_index)
        if self.flight is not None:
            self.flight.record('span-start', phase='step',
                               step=self._step_index)
        self.timer.start()
        try:
            with ann:
                yield
        finally:
            dur = self.timer.stop(fence=fence)
            if self.flight is not None:
                self.flight.record('span-end', phase='step',
                                   step=self._step_index,
                                   duration_s=round(dur, 6))
            if self._live_hist is not None:
                self._live_hist.observe(dur)
            if self.anomaly is not None:
                self.anomaly.observe('step_latency_s', dur)
            if self.slo is not None:
                self.slo.record(True, latency_s=dur)
            self._last_activity = time.time()
            self._step_index += 1
            if self.watchdog is not None:
                self.watchdog.done()

    def fence_devices(self, value, tag=None, phase='epoch-fence'):
        """Step-completion probe of the one device: reads ``value`` (a
        device scalar of the step's outputs) to the host and records the
        time from the most recent step start to the read's end, per
        device (``timings.json``'s ``device_steps``, one ``metrics.jsonl``
        record, a ``trace.json`` counter). Call it where the loop reads
        the device anyway (an epoch or eval boundary). ``tag`` labels the
        fence (default: the step index). Returns ``{device: seconds}``,
        or ``None`` when disabled or ``value`` is not a tensor."""
        if not self.enabled:
            return None
        import torch
        if not torch.is_tensor(value):
            return None
        tag = self._step_index if tag is None else tag
        t0 = self.timer.last_start
        if t0 is None:
            t0 = time.perf_counter()
        if self.watchdog is not None:
            self.watchdog.beat('fence', f'{phase}@{tag}')
        if self.flight is not None:
            self.flight.record('span-start', phase='fence',
                               name=f'{phase}@{tag}')
        float(value)   # blocks until the device is done
        times = {str(value.device.index or 0): round(
            time.perf_counter() - t0, 6)}
        if self.flight is not None:
            self.flight.record('span-end', phase='fence',
                               name=f'{phase}@{tag}',
                               duration_s=max(times.values()))
        self._last_activity = time.time()
        for dev, dt in times.items():
            self._device_times.setdefault(dev, []).append(dt)
        self._fence_records.append((time.time(), times))
        with self._probe_lock:
            self._metrics.log(self._step_index, device_fence=times)
        if self.watchdog is not None:
            self.watchdog.done()
            self.watchdog.beat('idle')
        return times

    def record_cost(self, name, step, *args, step_time_s=None):
        """Register one program's cost account (``efficiency.json``):
        ``step`` a train step (its ``cost_pass`` is counted: one eager
        forward and backward that leaves the run as it was) or any
        callable, with its example ``*args``. Call it before the step's
        capture. MFU is derived at flush time from ``step_time_s`` when
        given, else from the run's observed step p50. A count that fails
        is recorded as ``{'error': ...}``, never raised. See
        :mod:`~dgmc_tpu_torch.obs.cost`."""
        if not self.enabled:
            return None
        from dgmc_tpu_torch.obs import cost as cost_mod
        if self.watchdog is not None:
            self.watchdog.beat('cost', name)
        try:
            summary = cost_mod.cost_summary(step, *args,
                                            step_time_s=step_time_s)
        except Exception as e:
            # A program the count refuses must not kill the run it
            # observes; record the refusal instead.
            summary = {'error': f'{type(e).__name__}: {e}'}
        self._costs[name] = summary
        if self.watchdog is not None:
            self.watchdog.done()
        self.flush()
        return summary

    def _on_probe(self, rec):
        """Probe sink: series -> metrics.jsonl, aggregates ->
        timings.json, timeline -> trace.json. Non-finite checks reach
        metrics.jsonl only when they fire. A record is attributed to the
        step whose tape carried it."""
        name = rec['probe']
        value = rec['value']
        step = probes_mod.delivering_step()
        if step is None:
            step = self._step_index
        with self._probe_lock:
            self._probe_agg.add(name, value)
            meta = {k: v for k, v in rec.items()
                    if k not in ('probe', 'value', 'time')}
            if name == 'nonfinite':
                if value:
                    # The first offender by (step, static pipeline
                    # order), never by arrival order.
                    cand = {'step': step,
                            'stage': rec.get('stage', '?'),
                            'order': rec.get('order', 1 << 30)}
                    cur = self.first_nonfinite
                    if cur is None or ((cand['step'], cand['order'])
                                       < (cur['step'],
                                          cur.get('order', 1 << 30))):
                        self.first_nonfinite = cand
                else:
                    return
            self._probe_records.append(rec)
            self._probe_seen += 1
            self._metrics.log(step, probe=name, value=value, **meta)
        if name == 'consensus_delta' and self.quality is not None:
            # The per-iteration correction norm feeds the quality
            # plane's iterations-to-converge account.
            self.quality.observe_consensus(meta.get('iteration'), value)
        if self.flight is not None:
            self.flight.record('probe', name=name, value=float(value),
                               **meta)

    def log(self, step, **metrics):
        """Append one record to ``metrics.jsonl`` and refresh the derived
        artifacts."""
        if not self.enabled:
            return
        with self._probe_lock:
            self._metrics.log(step, **metrics)
        self._last_activity = time.time()
        if self.watchdog is not None:
            # Epoch-boundary host work beats through its log calls, so
            # only genuine stalls trip the deadline.
            self.watchdog.beat('idle')
        self.flush()

    @contextlib.contextmanager
    def compile_label(self, name):
        """Attribute compile events (captures, kernel builds) inside the
        block to ``name`` in ``timings.json``'s ``by_label``."""
        if not self.enabled:
            yield
            return
        if self.watchdog is not None:
            self.watchdog.beat('compile', name)
        self._pending_compiles.append(name)
        try:
            with self._watcher.label(name):
                yield
        finally:
            if name in self._pending_compiles:
                self._pending_compiles.remove(name)
            if self.watchdog is not None:
                self.watchdog.done()

    def snapshot_memory(self, tag=''):
        """Record a labelled device/host memory snapshot."""
        if not self.enabled:
            return None
        snap = memory_snapshot(tag)
        self._snapshots.append(snap)
        self.flush()
        return snap

    # -- artifacts ---------------------------------------------------------

    @staticmethod
    def _count_index(rows):
        return {tuple(sorted((k, v) for k, v in r.items() if k != 'count')):
                r['count'] for r in rows}

    @staticmethod
    def _since(rows, base):
        """Rows with the baseline counts subtracted (drop zero rows)."""
        out = []
        for r in rows:
            key = tuple(sorted((k, v) for k, v in r.items()
                               if k != 'count'))
            delta = r['count'] - base.get(key, 0)
            if delta > 0:
                out.append(dict(r, count=delta))
        return out

    def _write(self, name, payload):
        path = os.path.join(self.dir, name)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)

    def write_artifact(self, name, payload):
        """Write one extra JSON artifact into the obs dir (atomic, like
        the built-in ones): the hook behind the serving worker's
        ``capacity.json``."""
        if self.enabled:
            self._write(name, payload)

    def probe_summary(self):
        """Per-probe aggregates ``{name: {count, mean, last, min, max}}``."""
        with self._probe_lock:
            return self._probe_agg.summary()

    def device_step_summary(self):
        """Per-device completion aggregates from :meth:`fence_devices`:
        ``{device_id: {count, mean_s, p50_s, max_s, last_s}}``."""
        out = {}
        for dev, times in sorted(self._device_times.items()):
            ts = sorted(times)
            out[dev] = {
                'count': len(ts),
                'mean_s': round(sum(ts) / len(ts), 6),
                'p50_s': round(percentile(ts, 0.5), 6),
                'max_s': round(ts[-1], 6),
                'last_s': round(times[-1], 6),
            }
        return out

    # -- live plane --------------------------------------------------------

    @staticmethod
    def _advertise_host():
        """Hostname peers should scrape this plane at (loopback when the
        hostname cannot be determined)."""
        try:
            return socket.gethostname() or '127.0.0.1'
        except OSError:
            return '127.0.0.1'

    def _on_dispatch(self, kernel, outcome, reason):
        """Registry dispatch sink: every decision executed lands in the
        flight recorder."""
        if self.flight is not None:
            self.flight.record('dispatch', kernel=kernel,
                               outcome=outcome, reason=reason)

    def _on_compile_event(self, rec):
        """CompileWatcher event sink (under the watchers' lock: one ring
        append)."""
        if self.flight is not None:
            self.flight.record('compile', compile_kind=rec.get('kind'),
                               duration_s=rec.get('duration_s'),
                               label=rec.get('label'))

    def set_gauge(self, name, value):
        """Publish one named live gauge (e.g. the guard's
        ``guard_skip_count`` / ``guard_consec_bad``): shown in
        ``/healthz`` and exported as ``dgmc_<name>`` in ``/metrics``."""
        if not self.enabled:
            return
        self._live_gauges[str(name)] = value

    def flight_dump(self, reason, extra=None):
        """Dump the flight recorder now (``flight.json``): the anomaly
        trigger of the watchdog and the rollback guard. No-op (``None``)
        when disabled; never raises, takes no lock (the watchdog may
        call it on the signal path)."""
        if self.flight is None:
            return None
        return self.flight.dump(reason, extra=extra)

    def attach_slo(self, spec_or_path):
        """Arm the SLO plane (:mod:`~dgmc_tpu_torch.obs.slo`) from a spec
        file path (``--slo``), a raw spec dict or an ``SloSpec``. ``None``
        or a disabled observer is a no-op; a malformed spec raises
        ``ValueError``."""
        if spec_or_path is None or not self.enabled:
            return None
        if isinstance(spec_or_path, slo_mod.SloSpec):
            spec = spec_or_path
        elif isinstance(spec_or_path, dict):
            spec = slo_mod.SloSpec(spec_or_path)
        else:
            spec = slo_mod.load_slo_spec(spec_or_path)
        self.slo = slo_mod.SloTracker(spec, on_breach=self._on_slo_breach)
        self.add_metrics_provider(self.slo.metric_families)
        self.add_status_section('slo', self.slo.status)
        return self.slo

    def _on_slo_breach(self, kind, detail):
        self.flight_dump(f'slo:{kind}', extra=detail)

    def attach_anomaly(self, capacity=256):
        """Arm the streaming anomaly watch
        (:mod:`~dgmc_tpu_torch.obs.anomaly`): :meth:`step` feeds
        ``step_latency_s``, :meth:`flush` the per-flush compile-event
        and guard-skip deltas and writes ``anomalies.json``; a spike or
        sustained shift dumps the flight recorder (rate-limited)."""
        if not self.enabled:
            return None
        self.anomaly = anomaly_mod.AnomalyWatch(capacity=capacity,
                                                on_anomaly=self._on_anomaly)
        self.add_metrics_provider(self.anomaly.metric_families)
        self.add_status_section('anomaly', self.anomaly.counters)
        return self.anomaly

    def _on_anomaly(self, event):
        self.flight_dump(f'anomaly:{event["signal"]}', extra=event)

    def health(self):
        """The ``/healthz`` payload. ``healthy`` goes false (503) when
        the watchdog heartbeat is older than ``STALE_AFTER_FACTOR x
        deadline``; without an armed deadline the plane reports
        healthy."""
        now = time.time()
        wd = self.watchdog
        deadline = wd.deadline_s if wd is not None else None
        last = wd._last_event if wd is not None else self._last_activity
        age = now - last
        stale_after = (live_mod.STALE_AFTER_FACTOR * deadline
                       if deadline else None)
        out = {
            'healthy': stale_after is None or age <= stale_after,
            'time': now,
            'pid': os.getpid(),
            'port': self.live_port,
            'heartbeat_age_s': round(age, 3),
            'stale_after_s': stale_after,
            'steps_completed': self._step_index,
        }
        if wd is not None:
            in_flight = dict(wd._in_flight)
            in_flight['since_s'] = round(now - in_flight.pop('since'), 3)
            out['in_flight'] = in_flight
            out['watchdog_deadline_s'] = deadline
            out['hang_dumps'] = wd.dump_count
        if self._live_gauges:
            out['gauges'] = dict(self._live_gauges)
        if self.flight is not None:
            out['flight'] = self.flight.counters()
        return out

    def _efficiency_headline(self):
        """``(mfu, arith_intensity)`` from the last flushed efficiency
        snapshot, the headline convention ``obs.report`` uses."""
        eff = self._last_efficiency or {}
        mfu = eff.get('mfu')
        intensity = None
        programs = eff.get('programs', {})
        for name in ('train_step', *sorted(programs)):
            ai = programs.get(name, {}).get('arith_intensity')
            if ai is not None:
                intensity = ai
                break
        return mfu, intensity

    def prometheus_metrics(self):
        """The ``/metrics`` exposition text (Prometheus 0.0.4)."""
        steps = self.timer.summary()
        health = self.health()
        families = [
            ('dgmc_up', 'gauge', 'Run observer alive.', [('', {}, 1)]),
            ('dgmc_healthy', 'gauge',
             'Health verdict (the /healthz 200-vs-503 bit).',
             [('', {}, 1 if health['healthy'] else 0)]),
            ('dgmc_heartbeat_age_seconds', 'gauge',
             'Seconds since the last watchdog heartbeat event.',
             [('', {}, health['heartbeat_age_s'])]),
            ('dgmc_steps_total', 'counter', 'Completed steps.',
             [('', {}, self._step_index)]),
            live_mod.histogram_family(
                'dgmc_step_latency_seconds',
                'Step wall-clock latency (streaming fixed buckets).',
                self._live_hist.snapshot()),
        ]
        if steps.get('mean_s'):
            families.append((
                'dgmc_step_throughput_steps_per_sec', 'gauge',
                'Reciprocal mean step time over the run.',
                [('', {}, 1.0 / steps['mean_s'])]))
        comp = self._watcher.summary() if self._watcher else {}
        by_label = comp.get('by_label') or {}
        if by_label:
            families.append((
                'dgmc_compile_events_total', 'counter',
                'Compile events (graph captures, kernel builds) per '
                'label.',
                [('', {'label': lb}, d['events'])
                 for lb, d in sorted(by_label.items())]))
            families.append((
                'dgmc_compile_seconds_total', 'counter',
                'Compile seconds per label.',
                [('', {'label': lb}, d['compile_s'])
                 for lb, d in sorted(by_label.items())]))
        rows = self._since(dispatch_table(), self._dispatch_base)
        if rows:
            families.append((
                'dgmc_kernel_dispatch_total', 'counter',
                'Kernel-dispatch decisions executed by site/outcome/'
                'reason.',
                [('', {'kernel': r.get('kernel', '?'),
                       'outcome': r.get('outcome', '?'),
                       'reason': r.get('reason', '?')}, r['count'])
                 for r in rows]))
        probe_summary = self.probe_summary()
        if probe_summary:
            last_samples, count_samples = [], []
            for name, agg in sorted(probe_summary.items()):
                count_samples.append(
                    ('', {'probe': name}, agg.get('count', 0)))
                if isinstance(agg.get('last'), (int, float)):
                    last_samples.append(
                        ('', {'probe': name}, agg['last']))
            families.append((
                'dgmc_probe_events_total', 'counter',
                'In-graph probe events per probe.', count_samples))
            if last_samples:
                families.append((
                    'dgmc_probe_last', 'gauge',
                    'Most recent value per in-graph probe.',
                    last_samples))
        mfu, intensity = self._efficiency_headline()
        if mfu is not None:
            families.append((
                'dgmc_mfu', 'gauge',
                'Model FLOPs utilization (last efficiency snapshot).',
                [('', {}, mfu)]))
        if intensity is not None:
            families.append((
                'dgmc_arith_intensity', 'gauge',
                'Achieved arithmetic intensity, FLOPs/byte (last '
                'efficiency snapshot).', [('', {}, intensity)]))
        if self.flight is not None:
            counters = self.flight.counters()
            families.append((
                'dgmc_flight_events_total', 'counter',
                'Events recorded by the flight recorder.',
                [('', {}, counters['events_seen'])]))
            families.append((
                'dgmc_flight_events_dropped_total', 'counter',
                'Flight-recorder events evicted by the ring cap.',
                [('', {}, counters['events_truncated'])]))
            families.append((
                'dgmc_flight_dumps_total', 'counter',
                'flight.json anomaly dumps.',
                [('', {}, counters['dumps'])]))
        for name, value in sorted(self._live_gauges.items()):
            if isinstance(value, (int, float)):
                families.append((
                    f'dgmc_{name}', 'gauge',
                    f'Run-published gauge {name}.', [('', {}, value)]))
        for provider in self._metrics_providers:
            families.extend(provider() or [])
        return live_mod.prometheus_exposition(families)

    def add_metrics_provider(self, provider):
        """Register a 0-arg callable returning extra metric families,
        appended to every ``/metrics`` scrape."""
        if not callable(provider):
            raise TypeError(f'metrics provider must be callable: '
                            f'{provider!r}')
        self._metrics_providers.append(provider)
        return self

    def add_status_section(self, name, fn):
        """Register a 0-arg callable whose payload joins every
        ``/status`` scrape under ``name`` (one that raises degrades to an
        ``{'error': ...}`` stub)."""
        if not callable(fn):
            raise TypeError(f'status section must be callable: {fn!r}')
        self._status_sections[name] = fn
        return self

    def quality_eval(self, scenario, summary=None, step=None, **metrics):
        """Record one eval summary on the quality plane (no-op without an
        obs dir): the ``eval_summary`` dict or named fractions."""
        if self.quality is None:
            return
        payload = dict(summary) if summary else {}
        payload.update(metrics)
        self.quality.observe_eval(scenario, payload, step=step)

    def status(self):
        """The ``/status`` payload: the timing account at the top level,
        the quality block and any registered sections."""
        out = self.timings()
        if self.quality is not None:
            out['quality'] = self.quality.payload()
        for name, fn in self._status_sections.items():
            try:
                out[name] = fn()
            except Exception as e:  # degrade, don't 500 the scrape
                out[name] = {'error': f'{type(e).__name__}: {e}'}
        return out

    def _watchdog_context(self):
        """Run-state snapshot for the hang report (called from the
        watchdog thread; cached there for the lock-free signal path)."""
        ctx = {
            'steps_completed': self._step_index,
            'steps': self.timer.summary(),
            'pending_compiles': list(self._pending_compiles),
            'compile_events': (self._watcher.count()
                               if self._watcher else 0),
            'dispatch_tail': self._since(dispatch_table(),
                                         self._dispatch_base)[-8:],
        }
        if self.timer.spans:
            t0, dur = self.timer.spans[-1]
            ctx['last_step_span'] = {'start': t0,
                                     'duration_s': round(dur, 6)}
        return ctx

    def _padding_rows(self):
        """This run's padding-bucket rows with their real totals
        joined."""
        return goodput_mod.merge_real_rows(
            self._since(padding_bucket_table(), self._buckets_base),
            self._since(padding_real_table(), self._real_base))

    def goodput_payload(self):
        """The ``goodput.json`` body for this run: pad waste and the
        goodput ratio from the merged padding rows, composed with the
        last efficiency snapshot's per-stage FLOPs (``train_step``
        first) when the run recorded a cost account. ``None`` when
        nothing recorded a real-size account."""
        programs = (self._last_efficiency or {}).get('programs') or {}
        stages = (programs.get('train_step') or {}).get('stages')
        if not stages:
            for p in programs.values():
                if p.get('stages'):
                    stages = p['stages']
                    break
        return goodput_mod.payload_from_rows(self._padding_rows(),
                                             stages=stages)

    def timings(self):
        out = {
            'wall_s': round(time.time() - self._t_start, 3),
            'argv': sys.argv,
            'steps': self.timer.summary(),
            'compile': self._watcher.summary() if self._watcher else {},
            'padding_buckets': self._padding_rows(),
        }
        if self._device_times:
            out['device_steps'] = self.device_step_summary()
        if self._probe_agg:
            out['probes'] = self.probe_summary()
            with self._probe_lock:
                out['probes_truncated'] = max(
                    0, self._probe_seen - len(self._probe_records))
        if self.flight is not None:
            counters = self.flight.counters()
            out['flight'] = counters
            out['events_truncated'] = counters['events_truncated']
        if self.first_nonfinite is not None:
            out['first_nonfinite'] = self.first_nonfinite
        return out

    def flush(self):
        """Deliver the probe tapes that have landed, then rewrite
        ``timings.json``, ``quality.json``, ``memory.json``,
        ``dispatch.json``, ``efficiency.json``, ``goodput.json``,
        ``anomalies.json``, ``slo.json`` and ``trace.json`` from the
        current state (atomic per file)."""
        if not self.enabled:
            return
        probes_mod.drain()
        self._write('timings.json', self.timings())
        quality_payload = None
        if self.quality is not None:
            quality_payload = self.quality.payload()
            self._write('quality.json', quality_payload)
        self._write('memory.json', {'snapshots': self._snapshots})
        self._write('dispatch.json', {'counts': self._since(
            dispatch_table(), self._dispatch_base)})
        if self._costs:
            from dgmc_tpu_torch.obs import cost as cost_mod
            payload = cost_mod.efficiency_payload(
                self._costs,
                fallback_step_time_s=self.timer.summary().get('p50_s'))
            # /metrics serves MFU and intensity from exactly what
            # efficiency.json last said.
            self._last_efficiency = payload
            self._write('efficiency.json', payload)
        # After the efficiency write, so the ratio composes with the
        # freshest stage FLOPs; no real-size account, no goodput.json.
        goodput = self.goodput_payload()
        if goodput is not None:
            self._write('goodput.json', goodput)
        if self.anomaly is not None:
            # Per-flush compile-event delta: 0 once warm, so a mid-run
            # capture burst stands out as a spike.
            events = self._watcher.count() if self._watcher else 0
            self.anomaly.observe(
                'compile_events', events - self._anomaly_compiles_seen)
            self._anomaly_compiles_seen = events
            skips = self._live_gauges.get('guard_skip_count')
            if isinstance(skips, (int, float)):
                self.anomaly.observe(
                    'guard_skips', skips - self._anomaly_skips_seen)
                self._anomaly_skips_seen = skips
        if self.slo is not None:
            headline = ((quality_payload or {}).get('headline')
                        or {}).get('metrics') or {}
            self.slo.update_gauges(
                hits1=headline.get('hits1'),
                goodput=(goodput or {}).get('goodput_ratio'))
            self._write('slo.json', self.slo.snapshot())
        if self.anomaly is not None:
            self._write('anomalies.json', self.anomaly.snapshot())
        with self._probe_lock:
            probe_records = list(self._probe_records)
            probes_truncated = max(
                0, self._probe_seen - len(probe_records))
        export_chrome_trace(
            os.path.join(self.dir, 'trace.json'),
            step_spans=self.timer.spans,
            probe_records=probe_records,
            compile_events=self._watcher.events if self._watcher else (),
            device_fences=self._fence_records,
            metadata={'argv': sys.argv,
                      'probes_truncated': probes_truncated})

    def close(self):
        # Probe teardown first, and independent of `enabled`: a disabled
        # observer still flipped the global switch in __init__.
        if self._probe_sink is not None or self._probes_enabled_by_me:
            # Deliver the last steps' tapes (possibly the run's only
            # non-finite) before the sink goes: the port's
            # jax.effects_barrier().
            probes_mod.drain(wait=True)
        if self._probe_sink is not None:
            probes_mod.remove_sink(self._probe_sink)
            self._probe_sink = None
        if self._probes_enabled_by_me:
            probes_mod.disable()
            self._probes_enabled_by_me = False
        if not self.enabled:
            return
        probes_mod.set_step(None)
        if self.watchdog is not None:
            self.watchdog.close()
            self.watchdog = None
        if self._dispatch_sink is not None:
            remove_dispatch_sink(self._dispatch_sink)
            self._dispatch_sink = None
        self.snapshot_memory('end')
        self.flush()
        self._metrics.close()
        self._watcher.close()
        if self._server is not None:
            # Last: the plane keeps answering through the final flush.
            self._server.close()
            self._server = None
        self.enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
