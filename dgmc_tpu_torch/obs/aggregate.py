"""Multi-device / multi-host obs aggregation: stragglers and skew.

The port's copy of the JAX package's ``dgmc_tpu/obs/aggregate.py`` (the
same ``aggregate.json``, table and exit codes)::

    python -m dgmc_tpu_torch.obs.aggregate <obs_dir>         # table + artifact
    python -m dgmc_tpu_torch.obs.aggregate <obs_dir> --json  # machine-readable
    python -m dgmc_tpu_torch.obs.aggregate <obs_dir> --scrape

A multi-process run writes one obs subdirectory per host
(``obs-dir/host_<k>/``), each holding the standard artifacts for that
process plus per-device step-completion series
(``RunObserver.fence_devices``) and per-device memory snapshots. This
module merges them into a straggler/skew summary — max/median device
step-time ratio, per-device memory-peak spread, per-host wall-clock
spread — that ``obs.report`` and ``obs.diff`` consume
(``aggregate.json`` is written next to the host subdirectories). A
single-host obs dir is treated as ``host_0``: a run on one card has one
host and one device, so its step-time ratio is exactly 1.0.

Skew semantics: the step-time ratio is ``max / median`` over the mean
per-device step-completion time (1.0 = perfectly balanced). The
completion series are cumulative-drain measurements — each device's
time is measured by reading its shard of the step output, in device
order, so a straggler inflates the recorded time of every device
read after it; the MAX (the straggler itself) is exact, the median
is an upper bound, making the reported ratio a *lower* bound on the
true skew. Memory spread is ``max / median`` over per-device allocator
peaks (device source only; host-RSS fallbacks compare across hosts
instead).

Touches no device: it merges artifacts from a dead run on any machine.
"""

import argparse
import json
import os
import re
import sys

from dgmc_tpu_torch.obs.observe import fmt_seconds as _fmt_s
from dgmc_tpu_torch.obs.observe import percentile
from dgmc_tpu_torch.obs.report import load_run, summarize

_HOST_DIR = re.compile(r'^host_(\d+)$')


def find_host_dirs(root):
    """``[(host_name, path)]`` — the ``host_<k>/`` subdirectories of
    ``root`` (sorted by host index), else ``root`` itself as ``host_0``
    when it holds run artifacts directly. Empty when neither."""
    hosts = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    for name in entries:
        m = _HOST_DIR.match(name)
        d = os.path.join(root, name)
        if m and os.path.isdir(d) and _has_artifacts(d):
            hosts.append((int(m.group(1)), name, d))
    if hosts:
        return [(name, d) for _, name, d in sorted(hosts)]
    if _has_artifacts(root):
        return [('host_0', root)]
    return []


def _has_artifacts(d):
    return (os.path.exists(os.path.join(d, 'timings.json'))
            or os.path.exists(os.path.join(d, 'metrics.jsonl')))


def _median(values):
    return percentile(sorted(values), 0.5) if values else None


def _ratio(mx, med):
    if mx is None or not med:
        return None
    return round(mx / med, 4)


def _spread(rows, key):
    """{'max', 'median', 'ratio_max_over_median', 'worst'} over
    ``rows`` (dicts carrying ``key`` plus identity fields)."""
    vals = [r[key] for r in rows if r.get(key)]
    if not vals:
        return None
    mx = max(vals)
    med = _median(vals)
    worst = max((r for r in rows if r.get(key)), key=lambda r: r[key])
    return {'max': mx, 'median': med,
            'ratio_max_over_median': _ratio(mx, med),
            'worst': {k: worst[k] for k in ('host', 'device') if k in worst}}


#: A heartbeat older than this with an unreachable endpoint reads as
#: "the run ENDED" (heartbeats refresh every watchdog poll, seconds
#: apart, while the process lives) — the post-hoc artifacts are then
#: authoritative and the host is NOT flagged live-unhealthy. A FRESH
#: heartbeat with a dead endpoint is the live anomaly.
ENDED_HEARTBEAT_AGE_S = 60.0


def _scrape_host(host_dir):
    """Live-endpoint probe for one host dir: the advertised host+port
    are read from the heartbeat file the watchdog already writes
    (``heartbeat.json`` carries them when ``--obs-port`` is armed),
    then ``/healthz`` is scraped. Returns ``None`` when the host never
    advertised a port; otherwise ``{'port', 'pid', 'healthy',
    'heartbeat_age_s', ...}``. An endpoint that does not answer (or
    answers without a verdict — an errored handler's 500) is
    ``'unreachable'`` only while the heartbeat is fresh; with a stale
    heartbeat it is ``'ended'`` — a completed run's leftover
    advertisement, not a live anomaly."""
    try:
        with open(os.path.join(host_dir, 'heartbeat.json')) as f:
            hb = json.load(f)
    except (OSError, ValueError):
        return None
    port = hb.get('port')
    if not port:
        return None
    out = {'port': port, 'pid': hb.get('pid')}
    from dgmc_tpu_torch.obs.live import probe_healthz
    res = probe_healthz(port, host=hb.get('host') or '127.0.0.1')
    verdict = None
    if res is not None:
        code, payload = res
        if 'healthy' in payload:
            verdict = bool(payload['healthy'])
        elif code == 200:
            verdict = True
        else:
            out['scrape_error'] = code
    if verdict is None:
        import time
        if time.time() - hb.get('time', 0) > ENDED_HEARTBEAT_AGE_S:
            out['ended'] = True
        else:
            out['unreachable'] = True
        return out
    out['healthy'] = verdict
    for k in ('heartbeat_age_s', 'steps_completed', 'in_flight',
              'gauges'):
        if res[1].get(k) is not None:
            out[k] = res[1][k]
    return out


def aggregate(root, scrape=False):
    """Merge ``root``'s host subdirectories into one skew summary.

    Returns ``None`` when ``root`` holds no run artifacts at all;
    otherwise a dict with ``hosts``, ``per_host``, ``devices`` (one row
    per (host, device) with mean step-completion time and memory peak),
    ``step_time``, ``memory``, ``wall`` spreads and the condensed
    ``skew`` block the report/diff layers read.

    ``scrape=True`` additionally probes each host's LIVE ``/healthz``
    endpoint (port discovered from its ``heartbeat.json``) — the
    distributed-run view of a run still in flight: per-host
    ``live`` blocks plus top-level ``live_unhealthy_hosts``.
    """
    hosts = find_host_dirs(root)
    if not hosts:
        return None

    per_host = {}
    device_rows = []
    mem_rows = []
    host_rows = []
    for name, d in hosts:
        run = load_run(d)
        s = summarize(run)
        per_host[name] = {k: s[k] for k in
                          ('steps', 'step_p50_s', 'step_p95_s', 'wall_s',
                           'steps_per_sec', 'compile_events',
                           'peak_memory_bytes', 'peak_memory_source',
                           'metrics_records')
                          if k in s}
        if s.get('hang_report'):
            per_host[name]['hang_report'] = s['hang_report']
        if scrape:
            live = _scrape_host(d)
            if live is not None:
                per_host[name]['live'] = live
        host_rows.append({'host': name,
                          'step_p50_s': s.get('step_p50_s'),
                          'wall_s': s.get('wall_s')})
        for dev_id, agg in (s.get('device_steps') or {}).items():
            device_rows.append({'host': name, 'device': dev_id,
                                'mean_step_s': agg.get('mean_s'),
                                'steps': agg.get('count')})
        mem_rows.extend(_device_memory_peaks(name, run['memory']))

    # Device step-time spread; when no per-device series exists (the
    # run predates fence_devices or never called it), fall back to the
    # per-host p50s so multi-host runs still get a straggler signal.
    step_spread = _spread(device_rows, 'mean_step_s')
    step_source = 'device_series'
    if step_spread is None:
        step_spread = _spread(
            [{'host': r['host'], 'mean_step_s': r['step_p50_s']}
             for r in host_rows], 'mean_step_s')
        step_source = 'host_p50'

    mem_spread = _spread(mem_rows, 'peak_bytes')
    mem_source = 'device'
    if mem_spread is None:
        host_mem = [{'host': name,
                     'peak_bytes': per_host[name].get('peak_memory_bytes')}
                    for name, _ in hosts]
        mem_spread = _spread(host_mem, 'peak_bytes')
        mem_source = 'host'

    wall_spread = _spread(
        [{'host': r['host'], 'wall_s': r['wall_s']} for r in host_rows],
        'wall_s')

    out = {
        'root': root,
        'hosts': len(hosts),
        'per_host': per_host,
        'devices': device_rows,
        'step_time': dict(step_spread or {}, source=step_source)
        if step_spread else None,
        'memory': dict(mem_spread or {}, source=mem_source)
        if mem_spread else None,
        'wall': wall_spread,
        'hung_hosts': [name for name, p in per_host.items()
                       if 'hang_report' in p],
    }
    if scrape:
        out['live_unhealthy_hosts'] = [
            name for name, p in per_host.items()
            if 'live' in p and (p['live'].get('unreachable')
                                or p['live'].get('healthy') is False)]
    attribution = {
        name: _attribute_hang(root, name, per_host[name]['hang_report'])
        for name in out['hung_hosts']}
    if attribution:
        out['hang_attribution'] = attribution
    out['skew'] = {
        'step_time_ratio': (step_spread or {}).get('ratio_max_over_median'),
        'memory_ratio': (mem_spread or {}).get('ratio_max_over_median'),
        'wall_ratio': (wall_spread or {}).get('ratio_max_over_median'),
    }
    return out


def _attribute_hang(root, host_name, hang_summary):
    """Attribute a hung host to its last completed fence/phase.

    "Hung" alone is not actionable; the attribution names (a) what the
    host was inside when it stalled (the hang report's in-flight span —
    for a fence-deadline report that names the fence phase/step and the
    missing peers), (b) the last span it COMPLETED, and (c) its last
    completed collective fence from the control-plane heartbeat
    (``<root>/control/host_<i>.json``) when one exists — the phase every
    surviving peer agrees this host reached.
    """
    out = {'reason': hang_summary.get('reason')}
    inf = hang_summary.get('in_flight') or {}
    if inf:
        out['in_flight'] = {k: inf.get(k) for k in ('phase', 'name')
                            if inf.get(k) is not None}
    if hang_summary.get('last_completed'):
        out['last_completed'] = hang_summary['last_completed']
    m = _HOST_DIR.match(host_name)
    if m is not None:
        # Read the control file directly: this module touches no
        # device and needs no channel object.
        path = os.path.join(root, 'control', f'host_{m.group(1)}.json')
        try:
            with open(path) as f:
                beat = json.load(f)
        except (OSError, ValueError):
            beat = None
        if beat:
            out['last_heartbeat'] = {
                k: beat.get(k) for k in ('phase', 'step', 'time')
                if beat.get(k) is not None}
            if beat.get('last_fence'):
                out['last_fence'] = beat['last_fence']
    return out


def _device_memory_peaks(host, memory):
    """Per-device allocator peaks across a host's snapshots (device
    source only — host RSS is compared per host, not per device)."""
    peaks = {}
    for snap in (memory or {}).get('snapshots', []):
        for d in snap.get('devices', []):
            peak = max(d.get('peak_bytes_in_use', 0),
                       d.get('bytes_in_use', 0))
            if peak:
                did = str(d.get('id', '?'))
                peaks[did] = max(peaks.get(did, 0), peak)
    return [{'host': host, 'device': did, 'peak_bytes': v}
            for did, v in sorted(peaks.items())]


def write_aggregate(root, summary):
    path = os.path.join(root, 'aggregate.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(summary, f, indent=1)
    os.replace(tmp, path)
    return path


def _fmt_ratio(v):
    return '-' if v is None else f'{v:.3f}x'


def render(summary):
    lines = [f'== obs aggregate: {summary["root"]} '
             f'({summary["hosts"]} host(s)) ==']
    lines.append(f'  {"host":<10} {"steps":>6} {"p50":>10} {"wall":>10} '
                 f'{"peak mem":>12}')
    for name, p in summary['per_host'].items():
        peak = p.get('peak_memory_bytes')
        peak = f'{peak / 2**30:.3f} GiB' if peak else '-'
        hang = '  ** HUNG **' if 'hang_report' in p else ''
        live = p.get('live')
        if live:
            if live.get('ended'):
                hang += f'  [live :{live["port"]} ended]'
            elif live.get('unreachable'):
                hang += f'  [live :{live["port"]} UNREACHABLE]'
            else:
                state = 'ok' if live.get('healthy') else 'STALE'
                hang += f'  [live :{live["port"]} {state}]'
        lines.append(f'  {name:<10} {p.get("steps", "-"):>6} '
                     f'{_fmt_s(p.get("step_p50_s")):>10} '
                     f'{_fmt_s(p.get("wall_s")):>10} {peak:>12}{hang}')
    st = summary.get('step_time')
    lines.append('-- step-time skew --')
    if st:
        lines.append(f'  max / median     {_fmt_s(st["max"])} / '
                     f'{_fmt_s(st["median"])}   '
                     f'ratio {_fmt_ratio(st["ratio_max_over_median"])} '
                     f'[{st["source"]}]')
        if st.get('worst'):
            lines.append(f'  straggler        {st["worst"]}')
    else:
        lines.append('  (no step series recorded)')
    if summary.get('devices'):
        lines.append(f'  {"host":<10} {"device":>6} {"mean step":>12} '
                     f'{"steps":>6}')
        for r in summary['devices']:
            lines.append(f'  {r["host"]:<10} {r["device"]:>6} '
                         f'{_fmt_s(r.get("mean_step_s")):>12} '
                         f'{r.get("steps", "-"):>6}')
    mem = summary.get('memory')
    lines.append('-- memory skew --')
    if mem:
        lines.append(f'  max / median     {mem["max"] / 2**30:.3f} GiB / '
                     f'{mem["median"] / 2**30:.3f} GiB   '
                     f'ratio {_fmt_ratio(mem["ratio_max_over_median"])} '
                     f'[{mem["source"]}]')
    else:
        lines.append('  (no memory peaks recorded)')
    if summary.get('live_unhealthy_hosts'):
        lines.append(f'  LIVE-UNHEALTHY HOSTS: '
                     f'{summary["live_unhealthy_hosts"]} '
                     f'(/healthz 503 or unreachable)')
    if summary.get('hung_hosts'):
        lines.append(f'  HUNG HOSTS: {summary["hung_hosts"]} '
                     f'(see their hang_report.json)')
        for name, att in (summary.get('hang_attribution') or {}).items():
            inf = att.get('in_flight') or {}
            fence = att.get('last_fence') or {}
            done = att.get('last_completed') or {}
            lines.append(
                f'    {name}: stuck in '
                f'{inf.get("phase", "?")}:{inf.get("name", "?")}'
                + (f', last completed '
                   f'{done.get("phase")}:{done.get("name")}'
                   if done else '')
                + (f', last fence {fence.get("phase")}@{fence.get("step")}'
                   if fence else ''))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.aggregate',
        description='Merge per-host obs subdirectories into a '
                    'straggler/skew summary (writes aggregate.json).')
    parser.add_argument('root', help='obs directory (holding host_<k>/ '
                                     'subdirs, or artifacts directly)')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable summary')
    parser.add_argument('--no-write', action='store_true',
                        help="don't write <root>/aggregate.json")
    parser.add_argument('--scrape', action='store_true',
                        help='also probe each host\'s live /healthz '
                             'endpoint (port discovered from its '
                             'heartbeat.json — the --obs-port '
                             'advertisement) and report per-host live '
                             'health for a run still in flight')
    args = parser.parse_args(argv)

    summary = aggregate(args.root, scrape=args.scrape)
    if summary is None:
        print(f'aggregate: no obs artifacts under {args.root}',
              file=sys.stderr)
        return 2
    if not args.no_write:
        write_aggregate(args.root, summary)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(render(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
