"""Run report: render ``--obs-dir`` telemetry as a table and JSON.

The port of the JAX package's ``dgmc_tpu/obs/report.py``. Usage::

    python -m dgmc_tpu_torch.obs.report <obs_dir>            # table
    python -m dgmc_tpu_torch.obs.report <obs_dir> --json     # summary JSON
    python -m dgmc_tpu_torch.obs.report run1/ run2/          # several runs
    python -m dgmc_tpu_torch.obs.report metrics.jsonl        # bare metrics

The table shows throughput, step-time percentiles, compile events
(graph captures and ``nvcc`` builds) and their time, the card's
allocator peak (or the host's RSS), the cost and efficiency account
(``efficiency.json``), the measured attribution (``attribution.json``)
and the kernel-dispatch table. ``--json`` emits one summary object per
input (a list for several), with the JAX package's keys and meanings: the
dispatch counts read the port's outcomes, ``dispatch_pallas`` counting
``kernel`` (a CUDA kernel launched) and ``dispatch_fallback`` ``plain``.

Touches no device.
"""

import argparse
import json
import os
import sys


from dgmc_tpu_torch.obs.observe import read_json_artifact as _read_json


def _read_jsonl(path):
    recs = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    recs.append({'_unparsed': line[:200]})
    except OSError:
        pass
    return recs


#: Artifacts written AT a root dir by their tools (specimen-merged
#: efficiency.json, aggregate.json, recovery.json, the attribution
#: CLI's attribution.json) that must outrank the subdir's copies when a
#: root loads as one of its subruns.
_ROOT_ARTIFACTS = ('recovery', 'aggregate', 'efficiency', 'attribution')


def _load_as_subrun(run, root_path, subdir):
    """Load ``subdir`` as the run while keeping ``root_path`` as its
    identity and the root-level :data:`_ROOT_ARTIFACTS` on top."""
    root = {k: run[k] for k in _ROOT_ARTIFACTS}
    sub = load_run(os.path.join(root_path, subdir))
    sub['path'] = root_path
    for k in _ROOT_ARTIFACTS:
        sub[k] = root[k] or sub.get(k)
    return sub


def load_run(path):
    """Load one obs dir (or one bare JSONL file) into a run dict.

    A multi-host root (no artifacts of its own but ``host_<k>/``
    subdirectories, as the JAX package's aggregate writes them) loads as
    its ``host_0`` run, tagged with ``multi_host`` and the root's
    ``aggregate.json`` so summaries still carry the cross-host skew.

    A supervised root (``recovery.json`` + ``attempt_<k>/`` subdirs —
    see :mod:`dgmc_tpu_torch.resilience.supervisor`) loads as its LAST
    attempt's run, tagged with ``recovery``/``attempts``: the final
    attempt is the run's outcome, and earlier attempts' telemetry
    (including their hang reports) is recovery *history* the timeline
    renders, not the final state — a supervised run whose last attempt
    completed clean must not diff as hung.
    """
    if os.path.isdir(path):
        run = {
            'path': path,
            'metrics': _read_jsonl(os.path.join(path, 'metrics.jsonl')),
            'timings': _read_json(os.path.join(path, 'timings.json')),
            'memory': _read_json(os.path.join(path, 'memory.json')),
            'dispatch': _read_json(os.path.join(path, 'dispatch.json')),
            'efficiency': _read_json(os.path.join(path, 'efficiency.json')),
            'aggregate': _read_json(os.path.join(path, 'aggregate.json')),
            'hang': _read_json(os.path.join(path, 'hang_report.json')),
            'recovery': _read_json(os.path.join(path, 'recovery.json')),
            'flight': _read_json(os.path.join(path, 'flight.json')),
            'attribution': _read_json(
                os.path.join(path, 'attribution.json')),
            'qtrace': _read_json(
                os.path.join(path, 'qtrace_summary.json')),
            'quality': _read_json(os.path.join(path, 'quality.json')),
            'goodput': _read_json(os.path.join(path, 'goodput.json')),
            'capacity': _read_json(os.path.join(path, 'capacity.json')),
            'slo': _read_json(os.path.join(path, 'slo.json')),
            'anomalies': _read_json(os.path.join(path,
                                                 'anomalies.json')),
        }
        if run['timings'] is None and not run['metrics']:
            from dgmc_tpu_torch.resilience.supervisor import (
                ATTEMPT_PREFIX, is_attempt_dirname)
            attempts = sorted(
                (d for d in os.listdir(path)
                 if is_attempt_dirname(d)
                 and os.path.isdir(os.path.join(path, d))),
                key=lambda d: int(d[len(ATTEMPT_PREFIX):]))
            if attempts:
                run = _load_as_subrun(run, path, attempts[-1])
                run['attempts'] = len(attempts)
                return run
            hosts = sorted(
                d for d in os.listdir(path)
                if d.startswith('host_')
                and os.path.isdir(os.path.join(path, d)))
            if hosts:
                run = _load_as_subrun(run, path, hosts[0])
                run['multi_host'] = len(hosts)
                # A hang ANYWHERE is the run's hang: the straggling
                # non-coordinator host is precisely the evidence the
                # per-host layout exists for, and the diff gate's
                # "hung candidate always fails" must see it even when
                # host_0 finished clean.
                hung = []
                for h in hosts:
                    rep = _read_json(os.path.join(path, h,
                                                  'hang_report.json'))
                    if rep is not None:
                        hung.append(h)
                        if run['hang'] is None:
                            run['hang'] = dict(rep, host=h)
                if hung:
                    run['hung_hosts'] = hung
        return run
    return {'path': path, 'metrics': _read_jsonl(path), 'timings': None,
            'memory': None, 'dispatch': None, 'efficiency': None,
            'aggregate': None, 'hang': None, 'recovery': None,
            'flight': None, 'attribution': None, 'qtrace': None,
            'quality': None, 'goodput': None, 'capacity': None,
            'slo': None, 'anomalies': None}


def peak_memory(memory):
    """(bytes, source) — the maximum device allocator peak across all
    snapshots, else the host RSS high-water mark."""
    if not memory:
        return None, None
    dev_peak = host_peak = 0
    for snap in memory.get('snapshots', []):
        for d in snap.get('devices', []):
            dev_peak = max(dev_peak, d.get('peak_bytes_in_use', 0),
                           d.get('bytes_in_use', 0))
        host_peak = max(host_peak,
                        snap.get('host', {}).get('peak_rss_bytes', 0),
                        snap.get('host', {}).get('rss_bytes', 0))
    if dev_peak:
        return dev_peak, 'device'
    if host_peak:
        return host_peak, 'host'
    return None, None


def probe_aggregates_from_metrics(metrics):
    """Rebuild per-probe aggregates from the raw ``metrics.jsonl`` series
    — the fallback when ``timings.json`` predates the probe layer or only
    a bare metrics file was given. Uses the same accumulator the live
    sink does (``obs.probes.Aggregator``)."""
    from dgmc_tpu_torch.obs.probes import Aggregator
    agg = Aggregator()
    for rec in metrics or []:
        name = rec.get('probe')
        # 'nonfinite' is skipped by construction: only FIRING checks
        # reach metrics.jsonl, so a rebuild would see a different
        # population than the live sink's full-check statistics.
        if not name or name == 'nonfinite':
            continue
        v = rec.get('value')
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            agg.add(name, v)
        elif v is None and 'value' in rec:
            # MetricLogger writes non-finite values as null (NaN is not
            # valid JSON): feed NaN back so the rebuilt count and the
            # 'nonfinite_values' marker match the live sink's.
            agg.add(name, float('nan'))
    return agg.summary()


def summarize(run):
    """One machine-readable summary object for a loaded run."""
    out = {'path': run['path'],
           'metrics_records': len(run['metrics'] or [])}
    if run['metrics']:
        last = run['metrics'][-1]
        out['last_metrics'] = {k: v for k, v in last.items()
                               if k != '_unparsed'}
    t = run['timings'] or {}
    steps = t.get('steps') or {}
    if steps:
        out['steps'] = steps.get('steps')
        out['step_mean_s'] = round(steps.get('mean_s', 0.0), 6)
        out['step_p50_s'] = round(steps.get('p50_s', 0.0), 6)
        out['step_p95_s'] = round(steps.get('p95_s', 0.0), 6)
        out['step_max_s'] = round(steps.get('max_s', 0.0), 6)
        if steps.get('mean_s'):
            out['steps_per_sec'] = round(1.0 / steps['mean_s'], 3)
    if t.get('wall_s') is not None:
        out['wall_s'] = t['wall_s']
    comp = t.get('compile') or {}
    out['compile_events'] = comp.get('events', 0)
    out['compile_s'] = comp.get('compile_s', 0.0)
    if comp.get('by_label'):
        out['compile_by_label'] = comp['by_label']
    buckets = t.get('padding_buckets') or []
    if buckets:
        out['padding_buckets'] = len(buckets)
        out['padding_bucket_rows'] = buckets

    if t.get('device_steps'):
        out['device_steps'] = t['device_steps']

    probes = t.get('probes') or probe_aggregates_from_metrics(run['metrics'])
    if probes:
        out['probes'] = probes
    if t.get('first_nonfinite'):
        out['first_nonfinite'] = t['first_nonfinite']

    eff = run.get('efficiency') or {}
    if eff:
        if eff.get('mfu') is not None:
            out['mfu'] = eff['mfu']
        out['efficiency'] = {
            'peak_flops': eff.get('peak_flops'),
            'peak_flops_ref': eff.get('peak_flops_ref'),
            'peak_flops_source': eff.get('peak_flops_source'),
            'programs': eff.get('programs', {}),
        }
        ts = eff.get('programs', {}).get('train_step', {})
        if ts.get('flops'):
            out['flops_per_step'] = ts['flops']
        # Headline per-program fields (arithmetic intensity, the
        # modeled overlap fraction, the static peak-live bound): one
        # shared picking convention (cost.headline_of — train_step
        # first) so dgmc_tpu_torch.obs.diff and the attribution
        # reconciliation can never gate on different programs than this
        # summary reports.
        from dgmc_tpu_torch.obs.cost import headline_of
        for key in ('arith_intensity', 'overlap_fraction',
                    'static_peak_bytes'):
            val = headline_of(eff, key)
            if val is not None:
                out[key] = val
        # Measured headline (dgmc_tpu_torch.obs.attribution's
        # efficiency merge): the profiler-trace truth next to the static
        # models, so dgmc_tpu_torch.obs.diff can gate measured overlap
        # and idle growth from artifacts.
        # TOP-LEVEL keys only, deliberately: the merge pops a headline
        # whose measurement vanished, and falling back into the
        # `measured` block here would resurrect the stale value and
        # silence the diff's lost-account rule.
        for key in ('measured_overlap_fraction', 'measured_mfu',
                    'device_idle_fraction', 'idle_fraction',
                    'idle_source'):
            if eff.get(key) is not None:
                out[key] = eff[key]
        meas = eff.get('measured') or {}
        if meas:
            out['measured_device_available'] = meas.get(
                'device_available')

    qtrace = run.get('qtrace')
    if qtrace:
        # The serve plane's per-query account: per-stage quantiles for
        # dgmc_tpu_torch.obs.diff's --max-stage-p95-regression gate,
        # plus the gap attribution headline (the SERVE rows of
        # dgmc_tpu_torch.obs.timeline render its round-record form).
        out['qtrace_queries'] = qtrace.get('queries')
        out['qtrace_errors'] = qtrace.get('errors')
        e2e = qtrace.get('end_to_end') or {}
        for key in ('p50_ms', 'p95_ms', 'p99_ms'):
            if e2e.get(key) is not None:
                out[f'qtrace_{key}'] = e2e[key]
        stages = qtrace.get('stages') or {}
        if stages:
            out['qtrace_stages'] = {
                name: {k: q.get(k) for k in
                       ('count', 'p50_ms', 'p95_ms', 'p99_ms')}
                for name, q in stages.items()}
        gap = qtrace.get('gap_attribution') or {}
        if gap.get('dominant_stage'):
            out['qtrace_dominant_stage'] = gap['dominant_stage']
        if gap.get('p95_minus_p50_ms') is not None:
            out['qtrace_gap_ms'] = gap['p95_minus_p50_ms']

    quality = run.get('quality')
    if quality:
        # The quality plane (quality.json): the run's headline eval
        # metrics become FLAT summary keys — hits1/hits10/mrr/loss are
        # what dgmc_tpu_torch.obs.diff's --max-hits1-regression /
        # --min-hits1 gates read, and a run that stopped emitting them must LOSE the keys
        # (lost-account-fails), never inherit stale ones.
        headline = (quality.get('headline') or {}).get('metrics') or {}
        for key, val in headline.items():
            if val is not None:
                out[key] = val
        scenarios = quality.get('scenarios') or {}
        if scenarios:
            out['quality_scenarios'] = {
                name: {m: v.get('last')
                       for m, v in (sc.get('metrics') or {}).items()}
                for name, sc in scenarios.items()}
        consensus = quality.get('consensus') or {}
        if consensus.get('iterations'):
            out['consensus_iterations'] = consensus['iterations']
            out['consensus_converged_at'] = consensus.get('converged_at')
        serve_q = quality.get('serve') or {}
        if serve_q.get('queries'):
            out['quality_queries'] = serve_q['queries']
            out['quality_low_confidence'] = serve_q.get('low_confidence')
            out['quality_saturated_queries'] = serve_q.get(
                'saturated_queries')
        audit = serve_q.get('audit') or {}
        if audit.get('audited'):
            out['audit_queries'] = audit['audited']
            out['audit_recall_mean'] = audit.get('recall_mean')
            out['audit_recall_min'] = audit.get('recall_min')
            out['audit_exact'] = audit.get('exact')

    goodput = run.get('goodput')
    if goodput:
        # The capacity/goodput plane (goodput.json): flat keys so
        # dgmc_tpu_torch.obs.diff's --min-goodput / --max-pad-regression
        # gates read the same artifact the observer recorded — a run that stopped
        # writing the account loses the keys (lost-account-fails).
        if goodput.get('goodput_ratio') is not None:
            out['goodput_ratio'] = goodput['goodput_ratio']
        if goodput.get('pad_fraction_max') is not None:
            out['pad_fraction'] = goodput['pad_fraction_max']
        if goodput.get('buckets'):
            out['goodput_buckets'] = len(goodput['buckets'])
        if goodput.get('composed_with_stage_flops') is not None:
            out['goodput_composed'] = goodput['composed_with_stage_flops']

    capacity = run.get('capacity')
    if capacity:
        # The serve-side capacity model (capacity.json): Little's-law
        # utilization and the measured saturation ceiling, plus the
        # lock split the qtrace admission span reconciles against.
        for key in ('utilization', 'saturation_qps', 'arrival_qps',
                    'inflight', 'mean_service_ms', 'projected_wait_ms'):
            if capacity.get(key) is not None:
                out[f'capacity_{key}' if key != 'utilization'
                    else 'utilization'] = capacity[key]
        for side in ('lock_wait_ms', 'lock_hold_ms'):
            hist = capacity.get(side) or {}
            if hist.get('p95_ms') is not None:
                out[f'capacity_{side[:-3]}_p95_ms'] = hist['p95_ms']

    slo = run.get('slo')
    if slo:
        # The SLO plane (slo.json): the judged account — worst budget
        # consumption across objectives, any alerting burn windows and
        # the breach counts. Headline-sized; the full per-window burn
        # detail stays in the artifact.
        objectives = slo.get('objectives') or {}
        consumed = {name: o.get('budget_consumed')
                    for name, o in objectives.items()
                    if o.get('budget_consumed') is not None}
        out['slo'] = {
            'name': slo.get('slo'),
            'budget_consumed': consumed,
            'worst_budget_consumed': (round(max(consumed.values()), 6)
                                      if consumed else None),
            'alerting': sorted(
                f'{name}:{wname}'
                for name, o in objectives.items()
                for wname, b in (o.get('burn') or {}).items()
                if b.get('alerting')),
            'breaches': (slo.get('breaches') or {}).get('counts') or {},
        }

    anomalies = run.get('anomalies')
    if anomalies:
        # The anomaly watch (anomalies.json): totals plus only the
        # signals that actually fired — a quiet run summarizes quiet.
        sig = anomalies.get('signals') or {}
        out['anomaly'] = {
            'events': len(anomalies.get('events') or []),
            'truncated': anomalies.get('truncated', 0),
            'spikes': sum(s.get('spikes', 0) for s in sig.values()),
            'shifts': sum(s.get('shifts', 0) for s in sig.values()),
            'fired': {name: {'spikes': s.get('spikes', 0),
                             'shifts': s.get('shifts', 0)}
                      for name, s in sorted(sig.items())
                      if s.get('spikes') or s.get('shifts')},
        }

    flight = run.get('flight')
    if flight:
        out['flight'] = {
            'reason': flight.get('reason'),
            'events_recorded': flight.get('events_recorded'),
            'events_truncated': flight.get('events_truncated'),
        }
        events = flight.get('events') or []
        if events:
            out['flight']['last_event'] = events[-1]
            spans = [e for e in events
                     if str(e.get('kind', '')).startswith('span')]
            if spans:
                out['flight']['last_span'] = spans[-1]

    hang = run.get('hang')
    if hang:
        out['hang_report'] = {
            'reason': hang.get('reason'),
            'stalled_for_s': hang.get('stalled_for_s'),
            'in_flight': hang.get('in_flight'),
            'last_completed': hang.get('last_completed'),
        }
        if hang.get('host'):
            out['hang_report']['host'] = hang['host']
    if run.get('hung_hosts'):
        out['hung_hosts'] = run['hung_hosts']

    rec = run.get('recovery')
    if rec:
        out['recovery'] = {
            'outcome': rec.get('outcome'),
            'restarts': rec.get('restarts', 0),
            'degradations': [d.get('rung')
                             for d in rec.get('degradations', [])],
            'elastic': rec.get('elastic', []),
            'attempts': [
                {'attempt': at.get('attempt'),
                 'reason': at.get('reason'),
                 'rc': at.get('rc'),
                 'steps_completed': at.get('steps_completed'),
                 'duration_s': (
                     round(at['end_time'] - at['start_time'], 1)
                     if at.get('end_time') and at.get('start_time')
                     else None)}
                for at in rec.get('attempts', [])],
        }

    agg = run.get('aggregate')
    if agg and agg.get('skew'):
        out['skew'] = agg['skew']
        out['hosts'] = agg.get('hosts')
    if run.get('multi_host'):
        out['hosts'] = run['multi_host']

    peak, source = peak_memory(run['memory'])
    if peak is not None:
        out['peak_memory_bytes'] = peak
        out['peak_memory_gib'] = round(peak / 2 ** 30, 3)
        out['peak_memory_source'] = source

    rows = (run['dispatch'] or {}).get('counts', [])
    if rows:
        out['dispatch'] = rows
        # JAX's keys: a kernel launched (its 'pallas') and the plain
        # version (its 'fallback').
        out['dispatch_pallas'] = sum(r['count'] for r in rows
                                     if r.get('outcome') == 'kernel')
        out['dispatch_fallback'] = sum(r['count'] for r in rows
                                       if r.get('outcome') == 'plain')
    return out


def _fmt_bytes(n):
    if n is None:
        return '-'
    for unit in ('B', 'KiB', 'MiB', 'GiB', 'TiB'):
        if n < 1024 or unit == 'TiB':
            return f'{n:.2f} {unit}' if unit != 'B' else f'{n} B'
        n /= 1024


def _fmt_s(v):
    from dgmc_tpu_torch.obs.observe import fmt_seconds
    return fmt_seconds(v)


def _fmt_count(n):
    from dgmc_tpu_torch.obs.observe import fmt_si
    return fmt_si(n)


def render(run):
    """Human-readable report for one loaded run."""
    s = summarize(run)
    lines = [f'== run report: {run["path"]} ==']
    if s.get('hang_report'):
        h = s['hang_report']
        inf = h.get('in_flight') or {}
        lines.append(f'  ** RUN HUNG: {h.get("reason")} after '
                     f'{h.get("stalled_for_s")}s in '
                     f'{inf.get("phase")}:{inf.get("name")} '
                     f'(last completed: {h.get("last_completed")}) — '
                     f'see hang_report.json **')

    if s.get('recovery'):
        rec = s['recovery']
        lines.append('-- recovery timeline (supervised run) --')
        lines.append(f'  outcome          {rec.get("outcome")}   '
                     f'restarts: {rec.get("restarts", 0)}')
        if rec.get('degradations'):
            lines.append('  degradations     '
                         + ' -> '.join(rec['degradations']))
        for ev in rec.get('elastic') or []:
            lines.append(f'  elastic shrink   {ev.get("detail")} '
                         f'after {ev.get("reason")} '
                         f'(attempt {ev.get("attempt")})')
        for at in rec.get('attempts', []):
            dur = at.get('duration_s')
            steps_done = at.get('steps_completed')
            lines.append(
                f'  attempt {at.get("attempt")}: '
                f'{at.get("reason", "?")}'
                + (f' after {steps_done} step(s)'
                   if steps_done is not None else '')
                + (f' ({dur}s)' if dur is not None else ''))

    flight = run.get('flight')
    if flight:
        lines.append('-- flight recorder (trailing context) --')
        lines.append(
            f'  dumped on        {flight.get("reason")}   '
            f'({flight.get("events_recorded", 0)} events kept, '
            f'{flight.get("events_truncated", 0)} evicted by the ring)')
        events = flight.get('events') or []
        t_end = events[-1].get('time', 0.0) if events else 0.0
        for ev in events[-12:]:
            dt = (ev.get('time') or t_end) - t_end
            detail = ' '.join(
                f'{k}={v}' for k, v in ev.items()
                if k not in ('time', 'kind') and v is not None)
            lines.append(f'  {dt:+9.3f}s  {ev.get("kind", "?"):<10} '
                         f'{detail}'.rstrip())

    steps = s.get('steps')
    lines.append('-- step timing --')
    if steps:
        lines.append(f'  steps            {steps}')
        lines.append(f'  throughput       '
                     f'{s.get("steps_per_sec", "-")} steps/s')
        lines.append(f'  mean / p50 / p95 / max   '
                     f'{_fmt_s(s["step_mean_s"])} / '
                     f'{_fmt_s(s["step_p50_s"])} / '
                     f'{_fmt_s(s["step_p95_s"])} / '
                     f'{_fmt_s(s["step_max_s"])}')
    else:
        lines.append('  (no step timings recorded)')
    if 'wall_s' in s:
        lines.append(f'  run wall-clock   {_fmt_s(s["wall_s"])}')

    lines.append('-- compiles --')
    lines.append(f'  compile events   {s["compile_events"]}'
                 f'   (total {_fmt_s(s["compile_s"])})')
    for label, d in (s.get('compile_by_label') or {}).items():
        lines.append(f'    {label:<16} {d["events"]} events, '
                     f'{_fmt_s(d["compile_s"])}')
    if s.get('padding_buckets'):
        lines.append(f'  padding buckets  {s["padding_buckets"]} distinct')
        for b in s['padding_bucket_rows'][:5]:
            lines.append(f'    batch={b.get("batch")} '
                         f'nodes={b.get("nodes")} edges={b.get("edges")} '
                         f'x{b.get("count")}')

    lines.append('-- memory --')
    if 'peak_memory_bytes' in s:
        lines.append(f'  peak ({s["peak_memory_source"]})    '
                     f'{_fmt_bytes(s["peak_memory_bytes"])}')
    else:
        lines.append('  (no memory snapshots recorded)')

    if s.get('efficiency'):
        eff = s['efficiency']
        lines.append('-- cost / efficiency --')
        lines.append(f'  peak flops       '
                     f'{_fmt_count(eff.get("peak_flops"))}FLOP/s '
                     f'[{eff.get("peak_flops_source")}: '
                     f'{eff.get("peak_flops_ref")}]')
        if s.get('mfu') is not None:
            lines.append(f'  MFU              {s["mfu"]:.4%}')
        if s.get('overlap_fraction') is not None:
            lines.append(f'  overlap          '
                         f'{s["overlap_fraction"]:.4f} (modeled '
                         f'collective overlap)')
        if s.get('static_peak_bytes') is not None:
            lines.append(f'  static peak      '
                         f'{_fmt_bytes(s["static_peak_bytes"])} '
                         f'(liveness bound)')
        for name, p in eff.get('programs', {}).items():
            if 'error' in p:
                lines.append(f'  {name}: cost unavailable ({p["error"]})')
                continue
            mfu = f'  MFU {p["mfu"]:.4%}' if p.get('mfu') is not None \
                else ''
            lines.append(f'  {name}: {_fmt_count(p.get("flops"))}FLOP, '
                         f'{_fmt_bytes(p.get("bytes"))} accessed'
                         f'{mfu}')
            for stage, row in (p.get('stages') or {}).items():
                lines.append(
                    f'    {stage:<16} flops '
                    f'{_fmt_count(row.get("flops")):>9}  bytes '
                    f'{_fmt_bytes(row.get("bytes_out")):>11}  '
                    f'ops {row.get("ops", 0)}')
            coll = (p.get('collectives') or {}).get('ops') or {}
            for cname, row in coll.items():
                lines.append(f'    collective {cname:<14} x{row["count"]} '
                             f'{_fmt_bytes(row["bytes"])}')

    attribution = run.get('attribution')
    if attribution:
        # The measured account (profiler trace): the attribution CLI's
        # renderer, indented into the run report so the stage table,
        # occupancy and static-vs-measured reconciliation appear next
        # to the static cost/efficiency block they reconcile against.
        from dgmc_tpu_torch.obs.attribution import render_attribution
        lines.append('-- measured attribution (profiler trace) --')
        lines.extend(render_attribution(attribution).splitlines()[1:])

    if s.get('device_steps'):
        lines.append('-- per-device step completion --')
        lines.append(f'  {"device":>6} {"count":>6} {"mean":>12} '
                     f'{"p50":>12} {"max":>12}')
        for dev, a in s['device_steps'].items():
            lines.append(f'  {dev:>6} {a["count"]:>6} '
                         f'{_fmt_s(a["mean_s"]):>12} '
                         f'{_fmt_s(a["p50_s"]):>12} '
                         f'{_fmt_s(a["max_s"]):>12}')

    if s.get('skew'):
        sk = s['skew']
        lines.append('-- multi-device skew --')
        if s.get('hosts'):
            lines.append(f'  hosts            {s["hosts"]}')
        for key, label in (('step_time_ratio', 'step-time max/median'),
                           ('memory_ratio', 'memory max/median'),
                           ('wall_ratio', 'wall-clock max/median')):
            if sk.get(key) is not None:
                lines.append(f'  {label:<22} {sk[key]:.3f}x')

    lines.append('-- kernel dispatch --')
    rows = s.get('dispatch', [])
    if rows:
        lines.append(f'  {"kernel":<20} {"outcome":<10} {"reason":<18} '
                     f'{"count":>6}')
        for r in rows:
            lines.append(f'  {r.get("kernel", "?"):<20} '
                         f'{r.get("outcome", "?"):<10} '
                         f'{r.get("reason", "?"):<18} '
                         f'{r.get("count", 0):>6}')
        lines.append(f'  kernel taken: {s.get("dispatch_pallas", 0)}   '
                     f'plain: {s.get("dispatch_fallback", 0)}')
    else:
        lines.append('  (no dispatch decisions recorded)')

    if s.get('probes'):
        lines.append('-- probes --')
        lines.append(f'  {"probe":<18} {"count":>6} {"mean":>12} '
                     f'{"last":>12} {"min":>12} {"max":>12}')

        def g(v):
            return '-' if v is None else f'{v:.6g}'

        for name, a in s['probes'].items():
            nf = (f'  ({a["nonfinite_values"]} non-finite)'
                  if a.get('nonfinite_values') else '')
            lines.append(f'  {name:<18} {a["count"]:>6} {g(a["mean"]):>12} '
                         f'{g(a["last"]):>12} {g(a["min"]):>12} '
                         f'{g(a["max"]):>12}{nf}')
        if s.get('first_nonfinite'):
            fn = s['first_nonfinite']
            lines.append(f'  FIRST NON-FINITE at step {fn.get("step")} '
                         f'stage {fn.get("stage")!r}')

    quality = run.get('quality')
    if quality and (s.get('quality_scenarios') or s.get('quality_queries')
                    or s.get('consensus_iterations')):
        lines.append('-- quality plane --')
        for name, mets in (s.get('quality_scenarios') or {}).items():
            rendered = '  '.join(
                f'{m}={v:.4f}' for m, v in sorted(mets.items())
                if isinstance(v, (int, float)))
            lines.append(f'  {name:<16} {rendered}')
        if s.get('consensus_iterations'):
            conv = s.get('consensus_converged_at')
            lines.append(
                f'  consensus        {s["consensus_iterations"]} '
                f'iterations, converged at '
                f'{conv if conv is not None else "never (tol)"}')
        if s.get('quality_queries'):
            lines.append(
                f'  serve confidence {s["quality_queries"]} queries, '
                f'{s.get("quality_low_confidence", 0)} low-confidence, '
                f'{s.get("quality_saturated_queries", 0)} shortlist-'
                f'saturated')
        if s.get('audit_queries'):
            rmin = s.get('audit_recall_min')
            lines.append(
                f'  shadow audit     {s["audit_queries"]} audited, '
                f'{s.get("audit_exact", 0)} exact, recall min '
                f'{rmin if rmin is not None else "-"}')

    goodput = run.get('goodput')
    capacity = run.get('capacity')
    if goodput or capacity:
        lines.append('-- capacity / goodput plane --')
        if s.get('goodput_ratio') is not None:
            composed = ('FLOP-weighted' if s.get('goodput_composed')
                        else 'mask-only')
            lines.append(f'  goodput ratio    {s["goodput_ratio"]:.4f} '
                         f'(useful/executed FLOPs, {composed})')
        if s.get('pad_fraction') is not None:
            lines.append(f'  pad fraction     {s["pad_fraction"]:.4f} '
                         f'(worst bucket)')
        for b in (goodput or {}).get('buckets', [])[:5]:
            gr = b.get('goodput_ratio')
            lines.append(
                f'    batch={b.get("batch")} nodes={b.get("nodes")} '
                f'edges={b.get("edges")} x{b.get("count")}  '
                f'pad={b.get("pad_fraction", 0.0):.3f}'
                + (f'  goodput={gr:.3f}' if gr is not None else ''))
        if capacity:
            if s.get('utilization') is not None:
                lines.append(f'  utilization ρ    {s["utilization"]:.4f} '
                             f'(Little\'s law: arrival x service)')
            if s.get('capacity_saturation_qps') is not None:
                lines.append(f'  saturation QPS   '
                             f'{s["capacity_saturation_qps"]:.2f} '
                             f'(1 / mean service time)')
            if s.get('capacity_arrival_qps') is not None:
                lines.append(f'  arrival QPS      '
                             f'{s["capacity_arrival_qps"]:.2f}')
            wait = s.get('capacity_lock_wait_p95_ms')
            hold = s.get('capacity_lock_hold_p95_ms')
            if wait is not None or hold is not None:
                lines.append(f'  engine lock p95  '
                             f'wait {wait if wait is not None else "-"}ms / '
                             f'hold {hold if hold is not None else "-"}ms')
            rec_adm = capacity.get('admission_reconciliation')
            if rec_adm:
                lines.append(
                    f'  admission recon  qtrace '
                    f'{rec_adm.get("qtrace_count")}x '
                    f'p95={rec_adm.get("qtrace_p95_ms")}ms vs engine '
                    f'{rec_adm.get("engine_count")}x '
                    f'p95={rec_adm.get("engine_p95_ms")}ms')

    if s.get('slo') or s.get('anomaly'):
        lines.append('-- slo / anomaly plane --')
        slo_s = s.get('slo')
        if slo_s:
            worst = slo_s.get('worst_budget_consumed')
            lines.append(
                f'  slo {slo_s.get("name", "?"):<12} worst budget '
                f'consumed '
                f'{f"{worst:.4f}" if worst is not None else "-"}'
                + (f'  ALERTING: {", ".join(slo_s["alerting"])}'
                   if slo_s.get('alerting') else ''))
            for name, c in sorted(
                    (slo_s.get('budget_consumed') or {}).items()):
                lines.append(f'    {name:<16} budget {c:.4f}')
            if slo_s.get('breaches'):
                rendered = '  '.join(
                    f'{k}={v}' for k, v in
                    sorted(slo_s['breaches'].items()))
                lines.append(f'  breaches         {rendered}')
        an = s.get('anomaly')
        if an:
            lines.append(
                f'  anomalies        {an["events"]} in ring '
                f'({an["truncated"]} truncated), '
                f'{an["spikes"]} spikes / {an["shifts"]} shifts'
                + ('' if not an.get('fired') else '  ['
                   + ', '.join(
                       f'{name}: {f["spikes"]}s/{f["shifts"]}c'
                       for name, f in sorted(an['fired'].items()))
                   + ']'))

    lines.append('-- metrics --')
    lines.append(f'  records          {s["metrics_records"]}')
    if s.get('last_metrics'):
        lines.append(f'  last             '
                     f'{json.dumps(s["last_metrics"], sort_keys=True)}')
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.report',
        description='Render --obs-dir telemetry (or bare metric JSONL '
                    'files) as a report.')
    parser.add_argument('paths', nargs='+',
                        help='obs directories or metrics JSONL files')
    parser.add_argument('--json', action='store_true',
                        help='print only the machine-readable summary')
    args = parser.parse_args(argv)

    runs = []
    for p in args.paths:
        if not os.path.exists(p):
            print(f'report: no such path: {p}', file=sys.stderr)
            return 2
        runs.append(load_run(p))

    if args.json:
        summaries = [summarize(r) for r in runs]
        print(json.dumps(summaries[0] if len(summaries) == 1
                         else summaries, indent=1))
    else:
        for r in runs:
            print(render(r))
    return 0


if __name__ == '__main__':
    sys.exit(main())
