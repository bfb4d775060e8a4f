"""Trace export: run telemetry as Chrome-trace/Perfetto JSON, and the
``--profile-dir`` / ``--profile-steps`` profiler flags.

The port of the JAX package's ``dgmc_tpu/obs/trace.py``. Two trace
sources:

1. **Host-side run trace** (:func:`export_chrome_trace`): the telemetry
   :class:`~dgmc_tpu_torch.obs.run.RunObserver` collects — step spans,
   compile events, sections, probe series — in the Chrome trace-event
   format (``<obs_dir>/trace.json``; open it in ui.perfetto.dev). The
   same events as JAX's for the same spans.
2. **Device-side profiler trace** (:class:`ProfileHandle` behind
   ``--profile-dir``, and ``--profile DIR`` through
   :func:`~dgmc_tpu_torch.obs.observe.trace`): ``torch.profiler`` over
   the run or a step window, exported as a Chrome trace
   (``<dir>/dgmc_torch.<pid>.<n>.pt.trace.json``). The model's stages
   run under ``record_function`` ranges of JAX's scope names (``psi1``,
   ``initial_corr``, ``topk``, ``consensus_iter``, ``psi2``) and each
   step under ``dgmc_step#<n>``. A captured step's stage ranges are
   host ranges recorded once, at its capture: a replay shows as the
   step's range, one graph launch and the kernels the graph runs, which
   are read by their names (``route_fwd``, ``route_dt``,
   ``consensus_pairs``, ``project_rows``, ``topk_tc``, ``sc_fwd``,
   ``blocked_aggregate``, ``draw`` ...: the ``__global__`` functions of
   ``dgmc_tpu_torch/csrc``).
   An eager step (``jit=False``) shows the stage ranges around its
   kernels.
"""

import argparse
import atexit
import contextlib
import json
import math
import os
import re
import sys

from dgmc_tpu_torch.obs.observe import profiler_span, settle_profiler
# JAX's name for the profiler context over a region (a no-op without a
# directory): the same function.
from dgmc_tpu_torch.obs.observe import trace as profile_span

__all__ = ['chrome_events', 'export_chrome_trace', 'add_profile_flag',
           'parse_step_window', 'profile_span', 'ProfileHandle',
           'start_profile', 'STEP_ANNOTATION', 'warmup_profile']

#: The per-step range name in a profiler trace (``dgmc_step#<n>``; the
#: JAX package's step annotation).
STEP_ANNOTATION = 'dgmc_step'

#: Where captured steps profile their last warm-up (the open
#: ``--profile-dir``), or None.
_warmup_dir = None

#: Track ids inside the single "dgmc run" process row.
_TID_STEPS = 1
_TID_COMPILE = 2
_TID_SECTIONS = 3
_PID = 1


def _us(t, origin):
    return round((t - origin) * 1e6, 1)


def chrome_events(step_spans=(), probe_records=(), compile_events=(),
                  sections=(), device_fences=()):
    """Build the ``traceEvents`` list from host telemetry.

    Args:
        step_spans: ``(epoch_start_s, duration_s)`` pairs
            (:attr:`StepTimer.spans <dgmc_tpu_torch.obs.observe.StepTimer>`).
        probe_records: probe record dicts (``probe``/``value``/``time``
            plus optional ``stage``/``iteration``), as delivered by
            :mod:`dgmc_tpu_torch.obs.probes` sinks.
        compile_events: :class:`~dgmc_tpu_torch.obs.registry.CompileWatcher`
            event dicts (``time`` is the event's END; ``duration_s``,
            ``kind``, ``label``).
        sections: ``(name, epoch_start_s, duration_s)`` triples (timed
            sections of a run).
        device_fences: ``(epoch_time_s, {device_id: completion_s})``
            pairs (``RunObserver.fence_devices``) — one counter track
            per device, so a straggler draws as the visibly-higher
            line.
    """
    starts = ([t for t, _ in step_spans]
              + [r['time'] for r in probe_records]
              + [e['time'] - e.get('duration_s', 0.0)
                 for e in compile_events]
              + [t for _, t, _ in sections]
              + [t for t, _ in device_fences])
    if not starts:
        return []
    origin = min(starts)

    events = [
        {'ph': 'M', 'pid': _PID, 'name': 'process_name',
         'args': {'name': 'dgmc run'}},
        {'ph': 'M', 'pid': _PID, 'tid': _TID_STEPS, 'name': 'thread_name',
         'args': {'name': 'steps'}},
        # The JAX package's track name, kept so that both exports read
        # alike (the port's compile events are captures and nvcc builds).
        {'ph': 'M', 'pid': _PID, 'tid': _TID_COMPILE, 'name': 'thread_name',
         'args': {'name': 'xla compile'}},
    ]
    if sections:
        events.append({'ph': 'M', 'pid': _PID, 'tid': _TID_SECTIONS,
                       'name': 'thread_name', 'args': {'name': 'sections'}})

    for i, (t0, dur) in enumerate(step_spans):
        events.append({'ph': 'X', 'pid': _PID, 'tid': _TID_STEPS,
                       'name': f'step {i}', 'cat': 'step',
                       'ts': _us(t0, origin), 'dur': round(dur * 1e6, 1)})

    for e in compile_events:
        dur = e.get('duration_s', 0.0)
        events.append({'ph': 'X', 'pid': _PID, 'tid': _TID_COMPILE,
                       'name': e.get('kind', 'compile'), 'cat': 'compile',
                       'ts': _us(e['time'] - dur, origin),
                       'dur': round(dur * 1e6, 1),
                       'args': {'label': e.get('label', '')}})

    for name, t0, dur in sections:
        events.append({'ph': 'X', 'pid': _PID, 'tid': _TID_SECTIONS,
                       'name': name, 'cat': 'section',
                       'ts': _us(t0, origin), 'dur': round(dur * 1e6, 1)})

    for t, per_device in device_fences:
        for dev, dt in sorted(per_device.items()):
            events.append({'ph': 'C', 'pid': _PID,
                           'name': f'device_step[{dev}]', 'cat': 'fence',
                           'ts': _us(t, origin),
                           'args': {'completion_ms': round(dt * 1e3, 3)}})

    for r in probe_records:
        name = r.get('probe', '?')
        if name == 'nonfinite':
            # Only actual failures are trace-worthy; the all-finite checks
            # would bury the timeline under no-op instants.
            if r.get('value'):
                events.append({'ph': 'i', 'pid': _PID, 'tid': _TID_STEPS,
                               'name': f'nonfinite@{r.get("stage", "?")}',
                               'cat': 'probe', 's': 'p',
                               'ts': _us(r['time'], origin)})
            continue
        v = r.get('value')
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            # NaN/inf are not valid JSON and would make the whole trace
            # unreadable in Perfetto — the very run worth reading. The
            # nonfinite instants above already mark the failure.
            continue
        track = name if 'stage' not in r else f'{name}[{r["stage"]}]'
        events.append({'ph': 'C', 'pid': _PID, 'name': track,
                       'cat': 'probe', 'ts': _us(r['time'], origin),
                       'args': {'value': v}})
    return events


def export_chrome_trace(path, step_spans=(), probe_records=(),
                        compile_events=(), sections=(), device_fences=(),
                        metadata=None):
    """Write a Chrome-trace JSON file; returns the number of events.

    Atomic (tmp + rename) so a run killed mid-flush leaves the previous
    complete trace, matching the other obs artifacts' contract.
    """
    events = chrome_events(step_spans=step_spans,
                           probe_records=probe_records,
                           compile_events=compile_events,
                           sections=sections,
                           device_fences=device_fences)
    payload = {'traceEvents': events, 'displayTimeUnit': 'ms'}
    if metadata:
        payload['otherData'] = metadata
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return len(events)


def add_profile_flag(parser):
    """Register the standard ``--profile-dir`` / ``--profile-steps``
    flags on an argparse parser (a ``torch.profiler`` capture: whole-run
    by default, a step window with ``--profile-steps``)."""
    parser.add_argument(
        '--profile-dir', '--profile_dir', dest='profile_dir', type=str,
        default=None,
        help='capture a torch.profiler trace into this directory, exported '
             'as a Chrome trace (open in ui.perfetto.dev). The stages run '
             'under psi1/initial_corr/topk/consensus_iter/psi2 ranges and '
             'each step under dgmc_step#<n>; a captured step records its '
             'stage ranges once, at its capture, and a replay shows as one '
             'graph launch and its kernels, read by name (route_fwd, '
             'consensus_pairs, topk_tc, sc_fwd, ...). Whole-run by '
             'default; see '
             '--profile-steps')
    parser.add_argument(
        '--profile-steps', '--profile_steps', dest='profile_steps',
        type=_step_window_arg, default=None, metavar='A:B',
        help='window the --profile-dir capture to steps [A, B): the '
             'trace starts at step boundary A and stops at boundary B. '
             'Pick A >= 1 to keep the first step\'s capture out of the '
             'window. The run ending early still writes a readable trace')
    return parser


def _step_window_arg(spec):
    """argparse ``type=`` wrapper: a malformed window fails at parse
    time with the parser's usage message."""
    try:
        return parse_step_window(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def parse_step_window(spec):
    """``'A:B'`` -> ``(A, B)``, the half-open step window ``[A, B)``.
    Raises ``ValueError`` on malformed or empty windows."""
    m = re.fullmatch(r'(\d+):(\d+)', str(spec).strip())
    if not m:
        raise ValueError(
            f'--profile-steps expects A:B step indices (e.g. 10:14), '
            f'got {spec!r}')
    a, b = int(m.group(1)), int(m.group(2))
    if b <= a:
        raise ValueError(f'--profile-steps window [{a}, {b}) is empty')
    return a, b


class ProfileHandle:
    """The CLI-shaped profiler switch behind ``--profile-dir`` /
    ``--profile-steps``.

    Whole-run mode (``steps=None``): the span is entered at construction
    and :meth:`close` (or process exit, through ``atexit``) ends it and
    writes the trace. Step-window mode (``steps='A:B'`` or ``(A, B)``):
    :meth:`on_step`, called at every step boundary
    (``RunObserver.attach_profiler`` wires it), enters the span at
    boundary ``A`` and stops it at boundary ``B``, so the capture covers
    steps ``[A, B)``; the window fires once. :meth:`step_annotation`
    wraps a step in a ``dgmc_step#<n>`` range while the span is open.
    """

    def __init__(self, profile_dir, steps=None):
        self._dir = profile_dir
        if isinstance(steps, str):
            steps = parse_step_window(steps)
        self._window = steps
        if steps is not None and not profile_dir:
            print('start_profile: --profile-steps is ignored without '
                  '--profile-dir (there is no capture to window)',
                  file=sys.stderr)
            self._window = None
        self._seen = 0
        self._stack = None
        self._fired = False
        #: The trace files written, in order.
        self.paths = []
        if self._dir:
            global _warmup_dir
            _warmup_dir = self._dir
        if self._dir and self._window is None:
            self._enter()
        atexit.register(self.close)

    @property
    def active(self):
        """True while the profiler span is open."""
        return self._stack is not None

    def _enter(self):
        if self._stack is None and not self._fired:
            self._fired = True
            stack = contextlib.ExitStack()
            self.paths.append(stack.enter_context(
                profiler_span(self._dir)))
            self._stack = stack

    def _exit(self):
        if self._stack is not None:
            stack, self._stack = self._stack, None
            stack.close()

    def on_step(self):
        """Advance the step counter; open/close the windowed span at its
        boundaries (a no-op switch in whole-run mode)."""
        i = self._seen
        self._seen += 1
        if not self._dir or self._window is None:
            return
        a, b = self._window
        if i >= b:
            self._exit()
        elif i >= a:
            self._enter()

    def step_annotation(self, step=None):
        """A ``dgmc_step#<step>`` range over one step while the span is
        open (a no-op context otherwise); ``step`` defaults to the
        handle's own boundary counter."""
        if self._stack is None:
            return contextlib.nullcontext()
        if step is None:
            step = max(self._seen - 1, 0)
        from torch.profiler import record_function
        return record_function(f'{STEP_ANNOTATION}#{step}')

    def close(self):
        """Finalize the trace if a span is open; captures no longer
        profile their warm-ups. Idempotent."""
        self._exit()
        global _warmup_dir
        if _warmup_dir == self._dir:
            _warmup_dir = None


@contextlib.contextmanager
def warmup_profile(key, device):
    """A captured step's warm-up runs: yields ``last()``, the range
    ``dgmc_warmup#<key>`` to run the last of them under. While a
    :class:`ProfileHandle` has a directory open but no profiler runs (a
    ``--profile-steps`` window that has not started), every warm-up run
    is profiled by a profiler of its own into
    ``<dir>/dgmc_warmup.<key>.pt.trace.json``, which names the stages of
    the replays' kernels (:mod:`~dgmc_tpu_torch.obs.trace_events`). The
    earlier runs are in it because the card's records of the first
    kernels after a profiler starts can be lost (on the H100 the first
    four of a dense step's warm-up were)."""
    import torch
    from torch.profiler import record_function
    from dgmc_tpu_torch.obs.trace_events import WARMUP_RANGE

    def last():
        return record_function(f'{WARMUP_RANGE}#{key}')
    if _warmup_dir is None or torch.autograd.profiler._is_profiler_enabled:
        yield last
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if torch.device(device).type == 'cuda':
            settle_profiler(torch)
        yield last
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
    os.makedirs(_warmup_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(_warmup_dir, f'{WARMUP_RANGE}.{key}.pt.trace.json'))


def start_profile(profile_dir, steps=None):
    """Build the profiler handle for a CLI: whole-run capture when
    ``steps`` is None, a ``[A, B)`` step window when ``steps`` is
    ``'A:B'`` / ``(A, B)`` (see :class:`ProfileHandle`)."""
    return ProfileHandle(profile_dir, steps=steps)
