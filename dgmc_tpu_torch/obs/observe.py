"""Observability primitives: per-step timing, metric logging, formatting.

The port of the JAX package's ``dgmc_tpu/obs/observe.py`` (its profiler
context, ``trace``, is here too, over ``torch.profiler``):

- :class:`StepTimer` — wall-clock per-step timing. A ``fence`` is a
  device scalar of the step's outputs read to the host, the step's one
  synchronization; without one the time is the host's call. A captured
  step's replay returns before the device finishes, so an unfenced time
  measures the replay call (the launch of the graph), not the step.
- :class:`MetricLogger` — the JSONL metric sink (``--metrics_log``).
- :func:`trace` — a ``torch.profiler`` capture of the enclosed steps
  exported as a Chrome trace (the JAX CLIs' ``--profile DIR``).
- :func:`percentile`, :func:`fmt_seconds`, :func:`fmt_si`,
  :func:`read_json_artifact` — the helpers the artifact readers share.
"""

import contextlib
import itertools
import json
import math
import os
import time

__all__ = ['MetricLogger', 'StepTimer', 'trace', 'percentile',
           'fmt_seconds', 'fmt_si', 'read_json_artifact', 'profiler_span',
           'settle_profiler']

_trace_files = itertools.count()


def settle_profiler(torch):
    """Let a profiler that has just started on the card settle before the
    profiled work: the card's records of the first kernels after a start
    can be lost (on the H100, the first 4 of a warm-up and the first 23
    of a replayed dense step), which would leave a replay unmatched to
    its warm-up. A few tiny kernels and 50 ms, with the card idle."""
    if not torch.cuda.is_available():
        return
    x = torch.zeros(1, device='cuda')
    for _ in range(64):
        x.add_(1)
    torch.cuda.synchronize()
    time.sleep(0.05)


@contextlib.contextmanager
def profiler_span(log_dir):
    """``torch.profiler`` over the enclosed block (host and, where there
    is a card, CUDA activity), exported on exit as a Chrome trace
    ``<log_dir>/dgmc_torch.<pid>.<n>.pt.trace.json``; yields the path.
    Ranges a replayed CUDA graph ran under are host ranges: a replay
    shows as one graph launch and the kernels it ran, each by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, f'dgmc_torch.{os.getpid()}.'
                                 f'{next(_trace_files)}.pt.trace.json')
    with profile(activities=activities) as prof:
        settle_profiler(torch)
        yield path
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed steps into ``log_dir`` (no-op if ``log_dir``
    is falsy): :func:`profiler_span`'s Chrome trace."""
    if not log_dir:
        yield
        return
    with profiler_span(log_dir):
        yield


def read_json_artifact(path):
    """Best-effort obs-artifact read: the parsed JSON, or ``None`` on a
    missing, torn or unparsable file (absence is data, never an
    exception)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fmt_seconds(v):
    """``41.2 ms`` / ``3.100 s`` / ``-``."""
    if v is None:
        return '-'
    if v >= 1.0:
        return f'{v:.3f} s'
    return f'{v * 1e3:.2f} ms'


def fmt_si(v):
    """``60.5 M``-style SI scaling (no unit suffix); ``-`` for None."""
    if v is None:
        return '-'
    for unit in ('', ' K', ' M', ' G', ' T', ' P'):
        if abs(v) < 1000 or unit == ' P':
            return f'{v:.3g}{unit}'
        v /= 1000


def percentile(sorted_times, q):
    """Linear-interpolated percentile (``q`` in [0, 1]) of an already
    sorted list: numpy's default 'linear' rule."""
    if not sorted_times:
        raise ValueError('percentile of an empty window')
    pos = q * (len(sorted_times) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_times) - 1)
    return sorted_times[lo] + (sorted_times[hi] - sorted_times[lo]) * (
        pos - lo)


class StepTimer:
    """Accumulates per-step wall-clock times.

    ``stop(fence=...)`` reads ``fence`` (a device scalar of the step's
    outputs) to the host before the clock stops, so the time covers the
    step's execution; without a fence it covers the host's call (for a
    captured step, the replay's launch). :meth:`summary` says how many
    steps were fenced (``fenced_steps``).
    """

    def __init__(self):
        self.times = []
        #: ``(epoch_start_s, duration_s)`` per step: the timeline view of
        #: ``times`` (the Chrome-trace export reads it).
        self.spans = []
        #: ``perf_counter`` of the most recent :meth:`start`, kept after
        #: :meth:`stop` (``RunObserver.fence_devices`` measures from it).
        self.last_start = None
        self.fenced = 0
        self._t0 = None
        self._wall0 = None

    def start(self):
        self._wall0 = time.time()
        self._t0 = self.last_start = time.perf_counter()

    def stop(self, fence=None):
        if self._t0 is None:
            raise RuntimeError(
                'StepTimer.stop() called without a matching start(); call '
                'start() before each timed step')
        if fence is not None:
            float(fence)
            self.fenced += 1
        self.times.append(time.perf_counter() - self._t0)
        self.spans.append((self._wall0, self.times[-1]))
        self._t0 = self._wall0 = None
        return self.times[-1]

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    def summary(self):
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            'steps': len(ts),
            'mean_s': self.mean,
            'p50_s': percentile(ts, 0.5),
            'p95_s': percentile(ts, 0.95),
            'max_s': ts[-1],
            'total_s': sum(ts),
            'fenced_steps': self.fenced,
        }


class MetricLogger:
    """Append-only JSONL metric sink (one object per ``log`` call).

    ``path=None`` disables it (every call is a no-op). ``mode='a'`` (the
    default) appends across invocations, the ``--metrics_log`` contract;
    :class:`~dgmc_tpu_torch.obs.run.RunObserver` passes ``'w'`` so that an
    obs directory holds one run. Values with ``__float__`` (device
    scalars, numpy types) are written as floats, bools and ints keep
    their type, and a non-finite float is written as ``null`` so that the
    file stays valid JSON.
    """

    def __init__(self, path, mode='a'):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, mode)

    def log(self, step, **metrics):
        if self._fh is None:
            return
        rec = {'step': step, 'time': time.time()}
        for k, v in metrics.items():
            if hasattr(v, '__float__') and not isinstance(v, (bool, int)):
                v = float(v)
            if isinstance(v, float) and not math.isfinite(v):
                v = None
            rec[k] = v
        self._fh.write(json.dumps(rec) + '\n')
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
