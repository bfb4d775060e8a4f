"""Run-health watchdog: turn a silent hang into a ``hang_report.json``.

The port's copy of the JAX package's ``dgmc_tpu/obs/watchdog.py``, armed
by :class:`~dgmc_tpu_torch.obs.run.RunObserver` (``--watchdog-deadline``):

- Call sites **beat** (:meth:`Watchdog.beat`) when an activity starts —
  a training step, a labelled compile region — and **complete**
  (:meth:`Watchdog.done`) when it finishes.
- A daemon thread watches staleness. When no beat/complete lands for
  ``deadline_s`` seconds, it dumps ``hang_report.json``: all-thread
  Python tracebacks (``sys._current_frames``), the in-flight activity,
  the last-completed one, and the run context the owner supplies (step
  count, pending compile labels, the kernel-dispatch tail).
- Optionally it also arms **signal handlers** (SIGTERM/SIGALRM, what
  ``timeout(1)`` sends) that write the same report before chaining to
  the previously installed handler.

Why a thread and not just signals: a main thread blocked in native code
(a ``torch.cuda.synchronize()`` behind a stalled stream, a ``.item()``,
an ``nvcc`` build) never returns to the interpreter, so a Python-level
signal handler never runs; those calls release the interpreter lock
while they wait, so a separate thread still runs, and
``sys._current_frames()`` shows where every thread is (the main one in
the synchronize).

Lock discipline: the *thread* path may take ordinary locks (the main
thread is blocked in C, not suspended mid-critical-section). The
*signal* path runs with the main thread interrupted at an arbitrary
bytecode, so it must not acquire any lock the main thread could hold —
it uses only the context snapshot the thread cached on its last poll,
plus ``sys._current_frames()`` (no Python locks) and a direct file
write.

This module imports no torch: arming a watchdog must work in any
process, and the report must be writable while the card is wedged.
"""

import json
import os
import signal
import sys
import threading
import time
import traceback

from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['Watchdog', 'DEFAULT_SIGNALS', 'thread_stacks']

#: Signals the watchdog arms by default: what ``timeout(1)`` (SIGTERM)
#: and ``timeout -s ALRM`` / alarm-based harnesses deliver. Callers that
#: use SIGALRM themselves (per-section time budgets) pass an
#: explicit subset.
DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGALRM)


def thread_stacks(names=None):
    """All-thread Python tracebacks, JSON-ready.

    ``sys._current_frames`` is a C-level snapshot needing no Python
    locks, but resolving thread NAMES via ``threading.enumerate()``
    takes threading's internal registry lock — which the interrupted
    main thread may hold (e.g. inside ``Thread.start()``). Signal-path
    callers therefore pass a pre-cached ``{ident: (name, daemon)}``
    mapping (see :class:`Watchdog`); only thread-context callers let
    this default to a live ``enumerate()``.
    """
    if names is None:
        names = {t.ident: (t.name, bool(t.daemon))
                 for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(sys._current_frames().items()):
        name, daemon = names.get(ident, ('?', None))
        out.append({
            'ident': ident,
            'name': name,
            'daemon': daemon,
            'stack': [ln.rstrip('\n') for ln in
                      traceback.format_stack(frame)],
        })
    return out


class Watchdog:
    """Heartbeat-armed hang reporter writing ``report_path`` on stall.

    Args:
        report_path: where ``hang_report.json`` goes (written atomically;
            a re-dump replaces it).
        deadline_s: staleness budget — seconds without a :meth:`beat` /
            :meth:`done` before the thread dumps. ``None``/``0`` disables
            the deadline (signal dumps still work).
        context_fn: 0-arg callable returning a JSON-able dict of run
            state (steps completed, sections, pending compiles, dispatch
            tail). Called from the watchdog thread under normal locking
            rules; its latest result is cached for the lock-free signal
            path.
        signals: iterable of signal numbers to arm (empty = none). The
            previous handler of each is chained after the dump and
            restored by :meth:`close`.
        poll_s: thread poll interval (default: ``deadline_s / 4`` clamped
            to [0.05, 1.0]).
        heartbeat_path: when set, the watchdog thread writes a small
            liveness file there on every poll (atomic tmp+rename):
            ``{time, pid, last_event, in_flight, steps_completed}``. An
            OUT-of-process monitor (a run supervisor) watches its age: a
            process too wedged to run even this thread goes stale, the
            layer below the in-process deadline dump.
        advertise: extra keys merged into every heartbeat payload —
            how the run advertises its live-telemetry ``port``
            (``--obs-port``) so the supervisor and
            :mod:`dgmc_tpu_torch.obs.aggregate` can discover per-attempt
            endpoints from the heartbeat file alone, without out-of-band
            configuration.
        on_dump: callable ``(reason)`` invoked after every hang-report
            dump (deadline and signal paths alike) — the flight
            recorder's anomaly trigger. Runs on the dumping thread,
            possibly the lock-free signal path, so it must not take
            locks the main thread could hold; exceptions are swallowed.
    """

    def __init__(self, report_path, deadline_s=None, context_fn=None,
                 signals=(), poll_s=None, heartbeat_path=None,
                 advertise=None, on_dump=None):
        self.report_path = report_path
        self.heartbeat_path = heartbeat_path
        self.advertise = dict(advertise or {})
        self._on_dump = on_dump
        self.deadline_s = deadline_s or None
        self._context_fn = context_fn
        self._signals = tuple(signals)
        if poll_s is None:
            poll_s = min(1.0, max(0.05, (deadline_s or 4.0) / 4.0))
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._prev_handlers = {}
        t = time.time()
        self._in_flight = {'phase': 'startup', 'name': None, 'since': t}
        self._last_completed = None
        self._last_event = t
        self._dumped_this_stall = False
        self._cached_context = {}
        self._cached_thread_names = {}
        self.dump_count = 0

    # -- heartbeat ---------------------------------------------------------

    def beat(self, phase, name=None):
        """Record the start of an activity (a step, a compile label, a
        timed section). Resets the staleness clock and re-arms the
        once-per-stall dump."""
        now = time.time()
        with self._lock:
            self._in_flight = {'phase': phase, 'name': name, 'since': now}
            self._last_event = now
            self._dumped_this_stall = False

    def done(self):
        """Record completion of the in-flight activity. A completion of
        the idle phase (nested beat/done pairs unwind through it) is a
        heartbeat only — it must not overwrite the last-completed span a
        hang report names."""
        now = time.time()
        with self._lock:
            fin = self._in_flight
            if fin['phase'] != 'idle':
                self._last_completed = {
                    'phase': fin['phase'], 'name': fin['name'],
                    'duration_s': round(now - fin['since'], 3)}
            self._in_flight = {'phase': 'idle', 'name': None, 'since': now}
            self._last_event = now
            self._dumped_this_stall = False

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Arm: install signal handlers (main thread only; skipped
        silently elsewhere) and start the heartbeat thread."""
        # Seed the name cache here (safe context) so a signal arriving
        # before the first poll still labels the threads it can.
        self._refresh_thread_names()
        for sig in self._signals:
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal)
            except ValueError:  # not the main thread
                break
        # First heartbeat immediately: the supervisor's staleness watch
        # starts from the moment the file exists, so it must exist as
        # soon as the watchdog is armed, not one poll later.
        self._write_heartbeat()
        if self.deadline_s or self.heartbeat_path:
            self._thread = threading.Thread(
                target=self._watch, name='dgmc-watchdog', daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Disarm: stop the thread and restore the signal handlers."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_s * 4 + 1.0)
            self._thread = None
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                break
        self._prev_handlers.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- dumping -----------------------------------------------------------

    def _refresh_thread_names(self):
        try:
            self._cached_thread_names = {
                t.ident: (t.name, bool(t.daemon))
                for t in threading.enumerate()}
        except Exception:
            pass

    def _write_heartbeat(self):
        """Liveness file for the out-of-process supervisor (thread path
        only; best-effort, never raises)."""
        if not self.heartbeat_path:
            return
        try:
            with self._lock:
                payload = {
                    'time': time.time(),
                    'pid': os.getpid(),
                    'last_event': self._last_event,
                    'in_flight': dict(self._in_flight),
                }
            ctx = self._cached_context or {}
            if 'steps_completed' in ctx:
                payload['steps_completed'] = ctx['steps_completed']
            if self.advertise:
                # The live-plane port (and anything else the owner
                # advertises): endpoint discovery rides the existing
                # liveness file instead of a side channel.
                payload.update(self.advertise)
            write_json_atomic(self.heartbeat_path, payload, quiet=True)
        except Exception:
            pass

    def _watch(self):
        while not self._stop.wait(self._poll_s):
            # Refresh the context + thread-name caches for the lock-free
            # signal path while everything is healthy (ordinary locks
            # are fine here).
            self._refresh_thread_names()
            if self._context_fn is not None:
                try:
                    self._cached_context = self._context_fn()
                except Exception:
                    pass
            self._write_heartbeat()
            if not self.deadline_s:
                continue
            with self._lock:
                stale = time.time() - self._last_event
                should = (stale > self.deadline_s
                          and not self._dumped_this_stall)
                if should:
                    self._dumped_this_stall = True
            if should:
                self.dump('deadline', use_locks=True)

    def _on_signal(self, signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        # Cached context only: the main thread is interrupted at an
        # arbitrary bytecode and may hold any lock (see module docstring).
        self.dump(f'signal:{name}', use_locks=False)
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # Re-deliver with the default disposition so the exit status
            # says "killed by signal", as it would have without us.
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def dump(self, reason, extra=None, use_locks=True):
        """Write ``hang_report.json`` now; returns the path (or ``None``
        if even the write failed — a watchdog must never raise into the
        run it observes)."""
        now = time.time()
        if use_locks:
            with self._lock:
                in_flight = dict(self._in_flight)
                last_completed = self._last_completed
                last_event = self._last_event
            context = self._cached_context
            if self._context_fn is not None:
                try:
                    context = self._context_fn()
                except Exception:
                    pass
        else:
            in_flight = dict(self._in_flight)      # dict reads are atomic
            last_completed = self._last_completed  # enough for a dump
            last_event = self._last_event
            context = self._cached_context
        in_flight['since_s'] = round(now - in_flight.pop('since'), 3)
        # Signal path: cached thread names only — threading.enumerate()
        # takes the registry lock the interrupted main thread may hold.
        names = None if use_locks else dict(self._cached_thread_names)
        report = {
            'reason': reason,
            'time': now,
            'pid': os.getpid(),
            'argv': sys.argv,
            'deadline_s': self.deadline_s,
            'stalled_for_s': round(now - last_event, 3),
            'in_flight': in_flight,
            'last_completed': last_completed,
            'context': context or {},
            'threads': thread_stacks(names),
        }
        if extra:
            report.update(extra)
        path = None
        try:
            tmp = f'{self.report_path}.tmp.{os.getpid()}'
            with open(tmp, 'w') as f:
                json.dump(report, f, indent=1, default=str)
            os.replace(tmp, self.report_path)
            path = self.report_path
            self.dump_count += 1
        except Exception:
            pass
        if self._on_dump is not None:
            # Anomaly fan-out (the flight recorder): fires even when
            # the report write itself failed — the trailing-context
            # record is independent evidence, and on the signal path
            # the callee must already be lock-free by contract.
            try:
                self._on_dump(reason)
            except Exception:
                pass
        return path
