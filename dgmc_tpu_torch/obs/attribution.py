"""Measured per-stage account: what the card did, from profiler traces.

The port of the JAX package's ``dgmc_tpu/obs/attribution.py``, on the
Chrome traces of ``torch.profiler`` that ``--profile-dir`` writes
(:mod:`~dgmc_tpu_torch.obs.trace_events`):

- **Per-stage device time**: the card's slices (kernels, copies, fills)
  attributed to the pipeline stages (``psi1`` / ``initial_corr`` /
  ``topk`` / ``consensus_iter`` / ``psi2`` / ``loss`` / ``optimizer``)
  through the launch that put each on the card: the ``record_function``
  ranges around an eager launch, the forward op of a backward node, or,
  for a replayed CUDA graph, the same kernel of the warm-up before its
  capture (:class:`~dgmc_tpu_torch.obs.trace_events.StageResolver`;
  ``stage_sources`` counts each way, ``unmatched_share`` is the device
  time of replays whose kernels did not match their warm-up's).
- **Idle and waits**: the card's busy and idle time within the profiled
  window, and the host's time blocked in ``cuda*Synchronize``.
- **Static against measured**: the measured MFU from device-busy time
  per step against the static count in ``efficiency.json``.

The communication and overlap fields stay as JAX writes them for one
device: ``comm_busy_s`` 0 and ``measured_overlap_fraction`` ``None``
(absent, never 0). Results land as ``attribution.json``; the headline
fields merge into ``efficiency.json`` (a ``measured`` block and the
top-level ``measured_mfu`` / ``device_idle_fraction`` /
``idle_fraction``) for ``obs.report``.

On a trace without device slices (a CPU run) the account is the host's,
every device field named in ``unavailable`` rather than made up.

Usage::

    python -m dgmc_tpu_torch.obs.attribution <profile-dir> [--obs-dir RUN]
    python -m dgmc_tpu_torch.obs.attribution <obs-dir>         # host trace
"""

import argparse
import json
import os
import sys

from dgmc_tpu_torch.obs.observe import read_json_artifact as _read_json
from dgmc_tpu_torch.obs.stages import stage_of
from dgmc_tpu_torch.obs.trace import STEP_ANNOTATION
from dgmc_tpu_torch.obs.trace_events import (STAGE_NAMES, WARMUP_RANGE,
                                             StageResolver,
                                             TraceParseError, build_tracks,
                                             find_profiler_traces,
                                             intersect_intervals,
                                             is_comm_event,
                                             is_host_wait_event,
                                             merge_intervals,
                                             read_trace_file, sum_intervals)

__all__ = [
    'SCHEMA_VERSION', 'STEP_ANNOTATION', 'attribute_events',
    'reconcile', 'build_attribution', 'merge_into_efficiency',
    'render_attribution', 'main',
]

#: attribution.json schema version (pinned by the strict schema test).
SCHEMA_VERSION = 1

#: Device-side fields that go in the ``unavailable`` list when the
#: capture has no device tracks (the CPU-container degradation path).
_DEVICE_FIELDS = (
    'stages[device]', 'occupancy.device_active_s',
    'occupancy.device_idle_s', 'occupancy.device_idle_fraction',
    'occupancy.compute_busy_s', 'occupancy.comm_busy_s',
    'occupancy.overlapped_s', 'occupancy.measured_overlap_fraction',
    'per_step.device_active_s', 'reconciliation.measured_mfu',
    'reconciliation.measured_overlap_fraction',
)


def _r(v, nd=6):
    return None if v is None else round(v, nd)


def _is_step_slice(name, args):
    """A step's range: the profiler's ``dgmc_step#<n>`` (its host range,
    the card's copy of it is no slice here) or the obs run trace's
    ``cat: 'step'`` spans."""
    return (name == STEP_ANNOTATION or name.startswith(STEP_ANNOTATION + '#')
            or args.get('cat') == 'step')


def _stage_table(tracks, stage_fn):
    """Per-stage wall-clock over a track set: merged-union seconds per
    stage (nesting collapses), event counts, and the share of the summed
    stage wall-clock; ``stage_fn(name, args)`` names each slice's stage.
    Step ranges are bookkeeping, not stage work, and are excluded."""
    per_stage = {}
    for tr in tracks:
        for ts, dur, name, args in tr.slices:
            if _is_step_slice(name, args):
                continue
            st = stage_fn(name, args)
            row = per_stage.setdefault(st, {'intervals': [], 'events': 0})
            row['intervals'].append((ts, ts + dur))
            row['events'] += 1
    walls = {st: sum_intervals(merge_intervals(row['intervals'])) / 1e6
             for st, row in per_stage.items()}
    total = sum(walls.values())
    table = {}
    for st in (*STAGE_NAMES, 'other'):
        if st not in per_stage:
            continue
        table[st] = {
            'wall_s': _r(walls[st]),
            'events': per_stage[st]['events'],
            'share': _r(walls[st] / total, 4) if total else 0.0,
        }
    return table


def attribute_events(payloads, warmups=()):
    """The measured account from parsed trace payloads (a run's
    traces); ``warmups``, the captures' own warm-up traces, only name
    the stages of the replays' kernels.

    Returns a dict with ``device_available``, ``window_s``, ``steps``,
    ``stages`` (+ ``stage_source``, ``stage_sources``,
    ``unmatched_share``, ``replays``), ``occupancy``, ``per_step``,
    ``tracks`` and ``unavailable`` — every device field ``None`` (and
    named in ``unavailable``) when the capture has no device tracks,
    never a fabricated zero.
    """
    # The resolver first: it marks each replayed kernel with its index in
    # the replay, which the tracks' copies of the slices carry.
    resolver = StageResolver(payloads, warmups)
    tracks = []
    for p in payloads:
        tracks.extend(build_tracks(p.get('traceEvents', [])))
    device = [t for t in tracks if t.device]
    host = [t for t in tracks if not t.device]

    bounds = [(ts, ts + dur) for t in tracks for ts, dur, _, _ in t.slices]
    window_us = (max(e for _, e in bounds) - min(s for s, _ in bounds)) \
        if bounds else 0.0
    window_s = window_us / 1e6

    # -- step windows (profiler annotations or host-trace step spans) --
    step_ivs = [(ts, ts + dur)
                for t in host for ts, dur, name, args in t.slices
                if _is_step_slice(name, args)]
    steps = None
    if step_ivs:
        merged_steps = merge_intervals(step_ivs)
        steps = {
            'observed': len(step_ivs),
            'wall_s': _r(sum_intervals(merged_steps) / 1e6),
            'mean_s': _r(sum_intervals(merged_steps) / 1e6
                         / len(step_ivs)),
        }

    # -- device side -------------------------------------------------------
    occupancy = {
        'window_s': _r(window_s),
        'device_active_s': None,
        'device_idle_s': None,
        'device_idle_fraction': None,
        'compute_busy_s': None,
        'comm_busy_s': None,
        'overlapped_s': None,
        'measured_overlap_fraction': None,
        'host_busy_s': None,
        'host_wait_s': None,
        'host_wait_fraction': None,
        'idle_fraction': None,
        'idle_source': None,
    }
    per_step = None
    unavailable = []
    if device:
        dev_ivs, comp_ivs, comm_ivs = [], [], []
        for t in device:
            for ts, dur, name, args in t.slices:
                if _is_step_slice(name, args):
                    continue
                iv = (ts, ts + dur)
                dev_ivs.append(iv)
                (comm_ivs if is_comm_event(name, args)
                 else comp_ivs).append(iv)
        dev_u = merge_intervals(dev_ivs)
        comp_u = merge_intervals(comp_ivs)
        comm_u = merge_intervals(comm_ivs)
        active = sum_intervals(dev_u) / 1e6
        comm = sum_intervals(comm_u) / 1e6
        overlapped = sum_intervals(
            intersect_intervals(comm_u, comp_u)) / 1e6
        occupancy.update(
            device_active_s=_r(active),
            device_idle_s=_r(max(window_s - active, 0.0)),
            device_idle_fraction=_r(
                max(1.0 - active / window_s, 0.0) if window_s else 0.0,
                4),
            compute_busy_s=_r(sum_intervals(comp_u) / 1e6),
            comm_busy_s=_r(comm),
            overlapped_s=_r(overlapped),
            # None, not 0, when the window moved nothing between
            # devices: an overlap fraction over zero communication is
            # undefined, and 0.0 would read as "fully serialized".
            measured_overlap_fraction=(_r(overlapped / comm, 4)
                                       if comm else None),
        )
        if steps and active:
            per_step = {
                'device_active_s': _r(active / steps['observed']),
                'steps': steps['observed'],
            }
    else:
        unavailable.extend(_DEVICE_FIELDS)

    # -- host side ---------------------------------------------------------
    if host:
        # Profiler step ANNOTATIONS are bookkeeping, not host work —
        # each covers its whole step, so counting them would pin host
        # busy at 100% and blind the idle gate (the device path
        # excludes them too). The obs run-trace's cat:'step' spans DO
        # count: there they are the host-activity signal itself.
        host_ivs = [(ts, ts + dur)
                    for t in host for ts, dur, name, args in t.slices
                    if not _is_step_slice(name, args)
                    or args.get('cat') == 'step']
        wait_ivs = [(ts, ts + dur)
                    for t in host for ts, dur, name, _ in t.slices
                    if is_host_wait_event(name)]
        busy = sum_intervals(merge_intervals(host_ivs)) / 1e6
        wait = sum_intervals(merge_intervals(wait_ivs)) / 1e6
        occupancy.update(
            host_busy_s=_r(busy),
            host_wait_s=_r(wait),
            host_wait_fraction=_r(wait / window_s, 4) if window_s
            else 0.0)

    # One comparable idle headline per run: device idle when measured,
    # host idle otherwise — with the source named so
    # dgmc_tpu_torch.obs.diff refuses to compare a device-idle run
    # against a host-idle one (the same contract as the memory row).
    if occupancy['device_idle_fraction'] is not None:
        occupancy['idle_fraction'] = occupancy['device_idle_fraction']
        occupancy['idle_source'] = 'device'
    elif occupancy['host_busy_s'] is not None and window_s:
        occupancy['idle_fraction'] = _r(
            max(1.0 - occupancy['host_busy_s'] / window_s, 0.0), 4)
        occupancy['idle_source'] = 'host'

    stage_source = None
    stages = {}
    sources = {}
    unmatched_share = None
    if device:
        def device_stage(name, args):
            st, src = resolver.stage(args)
            sources[src] = sources.get(src, 0) + 1
            return st
        stages = _stage_table(device, device_stage)
        stage_source = 'device'
        busy = [(ts, ts + dur, resolver.stage(args)[1])
                for t in device for ts, dur, name, args in t.slices
                if not _is_step_slice(name, args)]
        unmatched_share = _r(
            sum_intervals(merge_intervals(
                [(a, b) for a, b, src in busy if src == 'unmatched']))
            / max(sum_intervals(merge_intervals(
                [(a, b) for a, b, _ in busy])), 1e-12), 4)
    elif host:
        stages = _stage_table(host, lambda name, args: stage_of(name))
        stage_source = 'host'

    return {
        'device_available': bool(device),
        'window_s': _r(window_s),
        'steps': steps,
        'stages': stages,
        'stage_source': stage_source,
        'stage_sources': sources,
        'unmatched_share': unmatched_share,
        'replays': {'count': len(resolver.replays),
                    'matched': sum(r['matched'] for r in resolver.replays),
                    'unmatched': [r for r in resolver.replays
                                  if not r['matched']][:8]},
        'occupancy': occupancy,
        'per_step': per_step,
        'tracks': [
            {'process': t.process, 'thread': t.thread,
             'device': t.device, 'events': len(t.slices),
             'busy_s': _r(sum_intervals(t.busy_intervals()) / 1e6)}
            for t in tracks],
        'unavailable': unavailable,
    }


def _static_headline(efficiency, key):
    """The static account's headline value for ``key`` — the shared
    :func:`dgmc_tpu_torch.obs.cost.headline_of` convention, so the two sides
    of the reconciliation pick the same program ``obs.report``
    summarizes."""
    from dgmc_tpu_torch.obs.cost import headline_of
    return headline_of(efficiency, key)


def reconcile(account, efficiency, timings=None):
    """Static-vs-measured reconciliation block.

    Static side: ``efficiency.json`` — the counted FLOPs and the
    host-step-time MFU (no modeled overlap on one card). Measured side:
    the trace account. Divergence fields are signed diagnostics, not
    gates.
    """
    eff = efficiency or {}
    occ = account.get('occupancy') or {}
    per_step = account.get('per_step') or {}
    rec = {
        'static_mfu': eff.get('mfu'),
        'measured_mfu': None,
        'mfu_ratio': None,
        'static_overlap_fraction': _static_headline(
            eff, 'overlap_fraction'),
        'measured_overlap_fraction': occ.get(
            'measured_overlap_fraction'),
        'overlap_divergence': None,
        'host_step_p50_s': ((timings or {}).get('steps') or {}).get(
            'p50_s'),
        'device_step_active_s': per_step.get('device_active_s'),
        'notes': [],
    }
    flops = _static_headline(eff, 'flops')
    peak = eff.get('peak_flops')
    dev_step = per_step.get('device_active_s')
    if flops and peak and dev_step:
        # MFU against device-ACTIVE time: utilization of the cycles
        # the chip actually spent, next to cost.py's utilization of
        # the host-observed step (which also pays dispatch + idle).
        rec['measured_mfu'] = float(f'{flops / (dev_step * peak):.4g}')
        if rec['static_mfu']:
            rec['mfu_ratio'] = _r(
                rec['measured_mfu'] / rec['static_mfu'], 4)
            rec['notes'].append(
                f'measured MFU {rec["measured_mfu"]:.4g} over device-'
                f'active time vs {rec["static_mfu"]:.4g} over host '
                f'step time: the gap is dispatch + device idle')
    if rec['measured_overlap_fraction'] is not None \
            and rec['static_overlap_fraction'] is not None:
        rec['overlap_divergence'] = _r(
            rec['measured_overlap_fraction']
            - rec['static_overlap_fraction'], 4)
        rec['notes'].append(
            f'measured overlap {rec["measured_overlap_fraction"]:.4f} '
            f'vs dependency-permitted '
            f'{rec["static_overlap_fraction"]:.4f}: the schedule '
            f'realized {rec["overlap_divergence"]:+.4f} of the model')
    return rec


# ---------------------------------------------------------------------------
# Artifact assembly
# ---------------------------------------------------------------------------




def _is_obs_dir(path):
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, name))
        for name in ('timings.json', 'metrics.jsonl', 'trace.json'))


def build_attribution(path, obs_dir=None):
    """Assemble the ``attribution.json`` payload for ``path`` (a
    ``--profile-dir`` capture or an obs dir).

    Profiler traces win when present; otherwise the obs dir's host-side
    ``trace.json`` is the (host-only) source. ``obs_dir``
    supplies the static account (``efficiency.json`` / ``timings.json``)
    for the reconciliation block; when ``path`` itself is an obs dir it
    defaults to it. Returns ``(payload, obs_dir)``; raises
    :class:`TraceParseError` only when NO source at all is readable.
    """
    errors = []
    trace_files = find_profiler_traces(path)
    if obs_dir is None and _is_obs_dir(path):
        obs_dir = path
    payloads, parsed_files, warmups = [], [], []
    for tf in trace_files:
        try:
            payload = read_trace_file(tf)
        except TraceParseError as e:
            # One corrupt trace must not discard the others: record the
            # reason, attribute what parsed.
            errors.append(str(e))
            continue
        # A capture's own warm-up trace names the replays' stages; it is
        # no part of the run's account.
        if os.path.basename(tf).startswith(WARMUP_RANGE + '.'):
            warmups.append(payload)
        else:
            payloads.append(payload)
            parsed_files.append(tf)
    source_kind = 'profiler'
    host_trace = os.path.join(obs_dir, 'trace.json') if obs_dir else None
    if not payloads:
        source_kind = 'host-trace'
        if host_trace and os.path.exists(host_trace):
            try:
                payloads.append(read_trace_file(host_trace))
                parsed_files.append(host_trace)
            except TraceParseError as e:
                errors.append(str(e))
        if not payloads:
            raise TraceParseError(
                path, 'no readable profiler trace '
                      '(*.pt.trace.json[.gz]) and no host-side '
                      'trace.json'
                      + (f'; errors: {"; ".join(errors)}'
                         if errors else ''))
    account = attribute_events(payloads, warmups)
    occ = account['occupancy']
    if occ.get('idle_source') == 'host' and source_kind == 'host-trace':
        # Host idle from the obs run trace (gaps between step/section
        # spans) and host idle from a profiler capture (python-tracer
        # coverage) are different quantities: name the source so
        # dgmc_tpu_torch.obs.diff refuses to compare them, the same way
        # it refuses device-vs-host memory peaks.
        occ['idle_source'] = 'host-trace'
    payload = {
        'schema': SCHEMA_VERSION,
        'source': {
            'kind': source_kind,
            'path': os.fspath(path),
            'trace_files': parsed_files,
            'warmup_traces': len(warmups),
            'obs_dir': obs_dir,
        },
        'errors': errors,
        **account,
        'reconciliation': None,
    }
    if obs_dir:
        efficiency = _read_json(os.path.join(obs_dir, 'efficiency.json'))
        timings = _read_json(os.path.join(obs_dir, 'timings.json'))
        if efficiency or timings:
            payload['reconciliation'] = reconcile(
                account, efficiency, timings)
    return payload, obs_dir


def merge_into_efficiency(obs_dir, payload):
    """Merge the measured headline into ``<obs_dir>/efficiency.json``.

    The full measured account lands under a ``measured`` block;
    headline fields (``measured_overlap_fraction``, ``measured_mfu``,
    ``device_idle_fraction``, ``idle_fraction``/``idle_source``) merge
    top-level ONLY when actually measured — an unavailable device
    field stays absent so :mod:`dgmc_tpu_torch.obs.report` and
    :mod:`dgmc_tpu_torch.obs.diff` see "no account", never a fabricated
    zero. Idempotent: a rerun replaces
    the measured block wholesale. Existing run rows are preserved
    verbatim (the same contract as ``obs.cost --obs-dir``).
    """
    path = os.path.join(obs_dir, 'efficiency.json')
    eff = _read_json(path) or {'programs': {}}
    occ = payload.get('occupancy') or {}
    rec = payload.get('reconciliation') or {}
    eff['measured'] = {
        'device_available': payload.get('device_available'),
        'source': payload.get('source'),
        'steps': payload.get('steps'),
        'occupancy': occ,
        'per_step': payload.get('per_step'),
        'reconciliation': payload.get('reconciliation'),
        'unavailable': payload.get('unavailable', []),
    }
    for key, value in (
            ('measured_overlap_fraction',
             occ.get('measured_overlap_fraction')),
            ('measured_mfu', rec.get('measured_mfu')),
            ('device_idle_fraction', occ.get('device_idle_fraction')),
            ('idle_fraction', occ.get('idle_fraction')),
            ('idle_source', occ.get('idle_source'))):
        if value is not None:
            eff[key] = value
        else:
            # A rerun that LOST a measurement must also lose the stale
            # headline — dgmc_tpu_torch.obs.diff's lost-account rule
            # needs absence to mean absence.
            eff.pop(key, None)
    os.makedirs(obs_dir, exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(eff, f, indent=1)
    os.replace(tmp, path)
    return eff


def _fmt_s(v):
    from dgmc_tpu_torch.obs.observe import fmt_seconds
    return fmt_seconds(v)


def render_attribution(payload):
    """Human-readable account (shared with ``obs.report``'s render)."""
    lines = ['== measured-runtime attribution ==']
    src = payload.get('source') or {}
    lines.append(f'  source           {src.get("kind")} '
                 f'({len(src.get("trace_files") or [])} trace file(s))')
    if not payload.get('device_available'):
        lines.append('  ** no device tracks in this capture: host-track '
                     'attribution only; device fields unavailable **')
    if payload.get('errors'):
        for err in payload['errors']:
            lines.append(f'  parse error      {err}')
    occ = payload.get('occupancy') or {}
    lines.append(f'  window           {_fmt_s(occ.get("window_s"))}')
    steps = payload.get('steps')
    if steps:
        lines.append(f'  steps observed   {steps["observed"]} '
                     f'(mean {_fmt_s(steps.get("mean_s"))})')
    if occ.get('device_active_s') is not None:
        lines.append(
            f'  device active    {_fmt_s(occ["device_active_s"])} '
            f'(idle {occ.get("device_idle_fraction", 0):.2%} of '
            f'window)')
        lines.append(
            f'  compute / comm   {_fmt_s(occ.get("compute_busy_s"))} / '
            f'{_fmt_s(occ.get("comm_busy_s"))}')
        if occ.get('measured_overlap_fraction') is not None:
            lines.append(f'  measured overlap '
                         f'{_fmt_s(occ.get("overlapped_s"))} = '
                         f'{occ["measured_overlap_fraction"]:.4f} '
                         f'of comm time')
    if occ.get('host_busy_s') is not None:
        lines.append(
            f'  host busy / wait {_fmt_s(occ["host_busy_s"])} / '
            f'{_fmt_s(occ.get("host_wait_s"))}')
    if occ.get('idle_fraction') is not None:
        lines.append(f'  idle fraction    {occ["idle_fraction"]:.2%} '
                     f'[{occ.get("idle_source")}]')
    stages = payload.get('stages') or {}
    if stages:
        lines.append(f'  -- per-stage wall-clock '
                     f'[{payload.get("stage_source")}] --')
        lines.append(f'  {"stage":<16} {"wall":>12} {"share":>8} '
                     f'{"events":>8}')
        for st, row in stages.items():
            lines.append(f'  {st:<16} {_fmt_s(row["wall_s"]):>12} '
                         f'{row["share"]:>8.2%} {row["events"]:>8}')
        replays = payload.get('replays') or {}
        if replays.get('count'):
            lines.append(f'  replays          {replays["count"]} '
                         f'({replays["matched"]} matched to their '
                         f'warm-up; unmatched share '
                         f'{payload.get("unmatched_share")})')
            for r in replays.get('unmatched', []):
                lines.append(f'    unmatched {r["key"]}: {r.get("reason")}')
    rec = payload.get('reconciliation')
    if rec:
        lines.append('  -- static vs measured --')
        for label, key in (('MFU (static)', 'static_mfu'),
                           ('MFU (measured)', 'measured_mfu'),
                           ('overlap (static)',
                            'static_overlap_fraction'),
                           ('overlap (measured)',
                            'measured_overlap_fraction')):
            v = rec.get(key)
            lines.append(f'  {label:<18} '
                         f'{v if v is not None else "unavailable"}')
        for note in rec.get('notes', []):
            lines.append(f'    {note}')
    if payload.get('unavailable'):
        lines.append('  unavailable      '
                     + ', '.join(payload['unavailable']))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.attribution',
        description='Measured per-stage account from a --profile-dir '
                    'capture (or an obs dir\'s host trace): per-stage '
                    'device time, idle analysis, static-vs-measured '
                    'reconciliation. Writes attribution.json and merges '
                    'the headline into efficiency.json.')
    parser.add_argument('path',
                        help='a --profile-dir capture, or an obs dir')
    parser.add_argument('--obs-dir', '--obs_dir', dest='obs_dir',
                        default=None,
                        help='obs run directory supplying the static '
                             'account (efficiency.json/timings.json) '
                             'and receiving attribution.json + the '
                             'efficiency merge (default: PATH when it '
                             'is an obs dir)')
    parser.add_argument('--out', default=None,
                        help='write attribution.json here instead of '
                             '<obs-dir>/attribution.json')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable payload')
    args = parser.parse_args(argv)

    if not os.path.exists(args.path):
        print(f'attribution: no such path: {args.path}', file=sys.stderr)
        return 2
    try:
        payload, obs_dir = build_attribution(args.path,
                                             obs_dir=args.obs_dir)
    except TraceParseError as e:
        print(f'attribution: {e}', file=sys.stderr)
        return 2

    out_path = args.out
    if out_path is None:
        root = obs_dir if obs_dir else os.fspath(args.path)
        out_path = os.path.join(root, 'attribution.json') \
            if os.path.isdir(root) else root
    tmp = out_path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, out_path)

    if obs_dir:
        merge_into_efficiency(obs_dir, payload)

    if args.json:
        print(json.dumps(payload, indent=1))
    else:
        print(render_attribution(payload))
        print(f'  -> {out_path}'
              + (f' (efficiency.json merged in {obs_dir})'
                 if obs_dir else ''))
    return 0


if __name__ == '__main__':
    sys.exit(main())
