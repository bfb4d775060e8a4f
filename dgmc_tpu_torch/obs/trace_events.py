"""Trace-event parsing for the measured per-stage account (Kineto traces).

The port of the JAX package's ``dgmc_tpu/obs/trace_events.py``. The
port's ``--profile-dir`` (:class:`~dgmc_tpu_torch.obs.trace.ProfileHandle`)
writes ``torch.profiler``'s Chrome traces,
``<dir>/dgmc_torch.<pid>.<n>.pt.trace.json``: ``ph: 'X'`` slices with
microsecond timestamps of what the card (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset`` on the GPU's process) and each host
thread (``cpu_op``, ``user_annotation`` for the ``record_function``
ranges, ``cuda_runtime`` for the launches) spent its time on. This
module turns them into tracks and stages:

- :func:`read_trace_file` — one ``.json`` / ``.json.gz`` payload (gzip by
  magic bytes, not extension); corrupt or truncated content raises
  :class:`TraceParseError` with the reason.
- :func:`find_profiler_traces` — the trace files under a
  ``--profile-dir`` (the run's traces and the warm-up traces the captured
  steps write beside them, see below).
- :func:`build_tracks` — slices per ``(pid, tid)`` with the
  ``process_name`` / ``thread_name`` metadata resolved and the card's
  tracks flagged (a ``GPU <n>`` process, or device categories).
- Interval algebra (:func:`merge_intervals`, :func:`sum_intervals`,
  :func:`intersect_intervals`) — busy time as unions.
- :class:`StageResolver` — each device slice's stage.

**Stages.** A kernel's stage is that of the launch that put it on the
card: the trace links them by ``args.correlation`` (the runtime event
and the kernel carry the same id; ``ac2g`` flow events say the same).
An eager launch's stage is :func:`~dgmc_tpu_torch.obs.stages.stage_of`
over the ``record_function`` ranges open on its thread; a launch inside
an autograd backward node (``autograd::engine::evaluate_function: ...``
with its ``Sequence number``) takes the stage of the forward op that
made the node (the forward op carrying the same number), as the work
counter does.

A replayed CUDA graph shows one ``cudaGraphLaunch`` and the kernels the
graph runs, all under that one launch: its stage ranges were host ranges,
recorded once at the capture. So a captured step's stages come from the
eager warm-up that precedes its capture (``train/compiled.py``): the last
warm-up runs under the range ``dgmc_warmup#<key>`` (profiled on its own
into ``dgmc_warmup.<key>.pt.trace.json`` when no profiler is running
then) and each replay under ``dgmc_replay#<key>``. The k-th kernel of a
replay takes the stage of the k-th kernel of its warm-up, the names
checked one for one; a replay whose kernel names or count differ is
``unmatched``: its slices go to ``other``, never spread over the stages.
A graph captured on one stream replays in capture order, so a copy or
fill node of a matched replay takes the stage of the kernel before it
(copies are not matched one for one: a capture may turn one into
another, as the guard's select turned a 1 KB copy into a 16 KB fill on
the KG phase-2 step).
"""

import bisect
import collections
import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Tuple

from dgmc_tpu_torch.obs.stages import STAGE_NAMES, stage_of

__all__ = [
    'TraceParseError', 'Track', 'read_trace_file', 'find_profiler_traces',
    'build_tracks', 'merge_intervals', 'sum_intervals',
    'intersect_intervals', 'is_comm_event', 'is_host_wait_event',
    'is_device_event', 'StageResolver', 'STAGE_NAMES', 'DEVICE_CATS',
    'WARMUP_RANGE', 'REPLAY_RANGE',
]

#: Chrome-trace categories of work on the card.
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: The range of a capture's last eager warm-up and of each replay:
#: ``<name>#<key>``.
WARMUP_RANGE = 'dgmc_warmup'
REPLAY_RANGE = 'dgmc_replay'
#: Runtime calls that put work on the card (their correlation ids are
#: the kernels', copies' and fills').
_LAUNCHES = re.compile(r'^(cuda|cu)(LaunchKernel|LaunchKernelExC|'
                       r'LaunchCooperativeKernel|GraphLaunch|Memcpy|'
                       r'Memset)')
#: Host slices that mean "the host waits for the card".
_HOST_WAITS = ('cudastreamsynchronize', 'cudadevicesynchronize',
               'cudaeventsynchronize')
_DEVICE_PROCESS = re.compile(r'^GPU\b')
_BACKWARD = 'autograd::engine::evaluate_function'


class TraceParseError(ValueError):
    """One trace file could not be parsed; carries the path + reason."""

    def __init__(self, path, reason):
        super().__init__(f'{path}: {reason}')
        self.path = path
        self.reason = reason


@dataclasses.dataclass
class Track:
    """All ``ph: 'X'`` slices of one ``(pid, tid)`` row.

    ``slices`` are ``(ts_us, dur_us, name, args)`` tuples sorted by start
    time (``args`` carries the event's ``cat``); ``device`` marks the
    card's tracks.
    """
    pid: object
    tid: object
    process: str
    thread: str
    device: bool
    slices: List[Tuple[float, float, str, dict]]

    def busy_intervals(self):
        """Merged busy intervals of this track (handles nesting)."""
        return merge_intervals([(t, t + d) for t, d, _, _ in self.slices])


def read_trace_file(path):
    """Load one Chrome-trace JSON payload (gzipped or plain).

    Returns the payload dict (must carry a ``traceEvents`` list). Raises
    :class:`TraceParseError` on unreadable files, bad gzip streams,
    truncated or corrupt JSON, or payloads without events.
    """
    try:
        with open(path, 'rb') as f:
            raw = f.read()
    except OSError as e:
        raise TraceParseError(path, f'unreadable: {e}')
    if raw[:2] == b'\x1f\x8b':
        try:
            raw = gzip.decompress(raw)
        except (OSError, EOFError) as e:
            raise TraceParseError(path, f'bad gzip stream: {e}')
    try:
        payload = json.loads(raw.decode('utf-8', errors='replace'))
    except ValueError as e:
        raise TraceParseError(path, f'truncated or corrupt JSON: {e}')
    if not isinstance(payload, dict) \
            or not isinstance(payload.get('traceEvents'), list):
        raise TraceParseError(path, 'no traceEvents list in payload')
    return payload


def find_profiler_traces(profile_dir):
    """The Chrome traces in a ``--profile-dir`` (``*.json`` and
    ``*.json.gz``, sorted), the captures' warm-up traces included;
    ``[]`` when there are none."""
    d = os.fspath(profile_dir)
    return sorted(p for pattern in ('*.trace.json', '*.trace.json.gz')
                  for p in glob.glob(os.path.join(d, pattern)))


def is_device_event(args):
    """True for work on the card (:data:`DEVICE_CATS`)."""
    return args.get('cat') in DEVICE_CATS


def build_tracks(events):
    """Group trace events into per-``(pid, tid)`` :class:`Track` rows:
    ``process_name`` / ``thread_name`` metadata resolved, the card's
    tracks flagged (a ``GPU <n>`` process, or any device-category slice),
    only ``ph: 'X'`` slices with a numeric ``ts`` kept, sorted by start.
    The card's ``gpu_user_annotation`` slices (host ranges drawn on the
    device's rows) are left out: they are no device work."""
    process_names: Dict[object, str] = {}
    thread_names: Dict[Tuple[object, object], str] = {}
    slices: Dict[Tuple[object, object],
                 List[Tuple[float, float, str, dict]]] = {}
    for e in events:
        if not isinstance(e, dict):
            continue
        ph = e.get('ph')
        pid, tid = e.get('pid'), e.get('tid')
        if ph == 'M':
            args = e.get('args') or {}
            if e.get('name') == 'process_name':
                process_names[pid] = str(args.get('name', ''))
            elif e.get('name') == 'thread_name':
                thread_names[(pid, tid)] = str(args.get('name', ''))
            continue
        if ph != 'X' or e.get('cat') == 'gpu_user_annotation':
            continue
        ts, dur = e.get('ts'), e.get('dur', 0.0)
        if not isinstance(ts, (int, float)) \
                or not isinstance(dur, (int, float)) or dur < 0:
            continue
        args = dict(e.get('args') or {})
        if e.get('cat'):
            args.setdefault('cat', e['cat'])
        slices.setdefault((pid, tid), []).append(
            (float(ts), float(dur), str(e.get('name', '')), args))
    tracks = []
    for (pid, tid), rows in sorted(slices.items(),
                                   key=lambda kv: (str(kv[0][0]),
                                                   str(kv[0][1]))):
        process = process_names.get(pid, '')
        tracks.append(Track(
            pid=pid, tid=tid, process=process,
            thread=thread_names.get((pid, tid), ''),
            device=bool(_DEVICE_PROCESS.match(process))
            or any(is_device_event(a) for _, _, _, a in rows),
            slices=sorted(rows, key=lambda s: (s[0], -s[1]))))
    return tracks


# ---------------------------------------------------------------------------
# Interval algebra (all times in the trace's microsecond clock)
# ---------------------------------------------------------------------------


def merge_intervals(intervals):
    """Union of ``(start, end)`` intervals as a sorted disjoint list."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def sum_intervals(merged):
    """Total covered time of a merged interval list."""
    return sum(e - s for s, e in merged)


def intersect_intervals(a, b):
    """Merged intersection of two MERGED interval lists."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def is_comm_event(name, args):
    """True for communication between cards (NCCL kernels); a one-card
    run has none."""
    return 'nccl' in name.lower()


def is_host_wait_event(name):
    """True when a host slice means the host is blocked on the card
    (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
    ``cudaEventSynchronize``)."""
    low = name.lower()
    return any(marker in low for marker in _HOST_WAITS)


def _key_of(name, prefix):
    return name[len(prefix) + 1:] if name.startswith(prefix + '#') else None


class StageResolver:
    """Stages of the device slices of a set of trace payloads.

    Resolves every device slice of ``payloads`` and marks its ``args``
    with ``_stage`` and ``_stage_source``: ``'range'`` (an eager launch,
    or a backward node's forward op), ``'replay'`` (a replayed graph's
    kernel through its warm-up), ``'replay_copy'`` (a replay's copy or
    fill node, in the stage of the kernel before it), ``'unmatched'`` (a
    replay whose kernels do not match its warm-up's, or whose warm-up is
    missing) or ``'unlinked'`` (no launch found); :meth:`stage` reads
    them back.
    ``warmups``: payloads that only name the stages of replays (the
    captures' own warm-up traces). :attr:`replays` lists each replay's
    key, kernel count and verdict, with the first difference of an
    unmatched one.
    """

    def __init__(self, payloads, warmups=()):
        self.replays = []
        maps = {}
        parsed = []
        for p in (*warmups, *payloads):
            host, device = [], []
            for e in p.get('traceEvents', []):
                if not isinstance(e, dict) or e.get('ph') != 'X':
                    continue
                cat = e.get('cat')
                if cat in DEVICE_CATS:
                    device.append(e)
                elif cat in ('cpu_op', 'user_annotation', 'cuda_runtime',
                             'cuda_driver'):
                    host.append(e)
            launches = _Launches(host)
            by_corr = collections.defaultdict(list)
            for e in device:
                by_corr[(e.get('args') or {}).get('correlation')].append(e)
            for pid, key, start, end in launches.warmups:
                inside = [corr for corr, (lpid, ts) in launches.times.items()
                          if lpid == pid and start <= ts <= end
                          and corr not in launches.replay]
                lost = sum(corr not in by_corr for corr in inside)
                if lost:
                    # A launch without its device record: the map would
                    # be short.
                    maps[key] = f'the warm-up trace lost {lost} launches'
                    continue
                seq = sorted((e for corr in inside for e in by_corr[corr]
                              if e.get('cat') == 'kernel'),
                             key=lambda e: e['ts'])
                maps[key] = [(e.get('name', ''), launches.stage.get(
                    (e.get('args') or {}).get('correlation'), 'other'))
                    for e in seq]
            parsed.append((launches, by_corr, device))
        for launches, by_corr, device in parsed[len(warmups):]:
            for e in device:
                corr = (e.get('args') or {}).get('correlation')
                if corr in launches.stage:
                    _mark(e, launches.stage[corr], 'range')
                else:
                    _mark(e, 'other', 'unlinked')
            for corr, key in launches.replay.items():
                self._replay(key, sorted(by_corr.get(corr, ()),
                                         key=lambda e: e['ts']),
                             maps.get(key))

    def _replay(self, key, events, want):
        kernels = [e for e in events if e.get('cat') == 'kernel']
        names = [e.get('name', '') for e in kernels]
        verdict = {'key': key, 'kernels': len(names)}
        if want is None or isinstance(want, str):
            verdict.update(matched=False, reason=want or 'no warm-up trace')
        elif [n for n, _ in want] != names:
            i = next((i for i, (a, b) in enumerate(zip(want, names))
                      if a[0] != b), min(len(want), len(names)))
            verdict.update(matched=False, reason=(
                f'{len(names)} kernels against {len(want)} in the warm-up; '
                f'first difference at {i}: '
                f'{names[i] if i < len(names) else None!r} / '
                f'{want[i][0] if i < len(want) else None!r}'))
        else:
            verdict['matched'] = True
        if not verdict['matched']:
            for e in events:
                _mark(e, 'other', 'unmatched')
        else:
            # A copy or fill node takes the stage of the kernel captured
            # before it (the graph replays the capture's order).
            stage, i = (want[0][1] if want else 'other'), 0
            for e in events:
                if e.get('cat') == 'kernel':
                    stage = want[i][1]
                    i += 1
                    _mark(e, stage, 'replay')
                else:
                    _mark(e, stage, 'replay_copy')
        self.replays.append(verdict)

    @staticmethod
    def stage(args):
        """``(stage, source)`` of one resolved device slice (its
        ``args``)."""
        return (args.get('_stage', 'other'),
                args.get('_stage_source', 'unlinked'))


def _mark(event, stage, source):
    args = event.setdefault('args', {})
    args['_stage'], args['_stage_source'] = stage, source


class _Launches:
    """The launches of one payload's host events: ``stage`` (correlation
    → the stage of its launch), ``times`` (correlation → ``(pid, ts)``),
    ``replay`` (a graph launch's correlation → its record's key) and
    ``warmups`` (``(pid, key, start, end)`` of each warm-up range)."""

    def __init__(self, host):
        self.stage, self.times, self.replay = {}, {}, {}
        self.warmups = []
        by_thread = collections.defaultdict(list)
        for e in host:
            by_thread[(e.get('pid'), e.get('tid'))].append(e)
        fwd = {}                 # sequence number -> forward stage
        backward = []            # (correlation, sequence number)
        for (pid, tid), events in by_thread.items():
            events.sort(key=lambda e: (e['ts'], -e.get('dur', 0)))
            stack = []           # (end, name, cat, args) of open slices
            for e in events:
                ts, end = e['ts'], e['ts'] + e.get('dur', 0)
                while stack and stack[-1][0] <= ts:
                    stack.pop()
                name, cat = e.get('name', ''), e.get('cat')
                args = e.get('args') or {}
                ann = [n for _, n, c, _ in stack if c == 'user_annotation']
                if cat == 'user_annotation':
                    key = _key_of(name, WARMUP_RANGE)
                    if key is not None:
                        self.warmups.append((pid, key, ts, end))
                seq = args.get('Sequence number')
                if cat == 'cpu_op' and seq is not None and not any(
                        n.startswith(_BACKWARD)
                        for n in (name, *(f[1] for f in stack))):
                    # The last op holding a number made its node (ops
                    # before it that make none read the same number).
                    fwd[seq] = stage_of('/'.join(ann))
                if cat in ('cuda_runtime', 'cuda_driver') \
                        and _LAUNCHES.match(name):
                    corr = args.get('correlation')
                    self.times[corr] = (pid, ts)
                    node = next((a.get('Sequence number') for _, n, _, a
                                 in reversed(stack)
                                 if a.get('Sequence number') is not None
                                 and (n.startswith(_BACKWARD)
                                      or 'Backward' in n)), None)
                    if node is not None:
                        backward.append((corr, node))
                    else:
                        self.stage[corr] = stage_of('/'.join(ann))
                    if 'GraphLaunch' in name:
                        key = next((_key_of(n, REPLAY_RANGE)
                                    for _, n, c, _ in reversed(stack)
                                    if c == 'user_annotation'
                                    and _key_of(n, REPLAY_RANGE)), None)
                        if key is not None:
                            self.replay[corr] = key
                stack.append((end, name, cat, args))
        seqs = sorted(fwd)
        for corr, node in backward:
            if node in fwd:
                self.stage[corr] = fwd[node]
            else:
                i = bisect.bisect_right(seqs, node) - 1
                self.stage[corr] = fwd[seqs[i]] if i >= 0 else 'other'
