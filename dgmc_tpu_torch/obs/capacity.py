"""Capacity model: saturation QPS, Little's-law utilization, headroom.

The port's copy of the JAX package's ``dgmc_tpu/obs/capacity.py``::

    python -m dgmc_tpu_torch.obs.capacity <obs_dir | round.json> ...
    python -m dgmc_tpu_torch.obs.capacity obs/ --target-qps 50 --json

The serving engine runs one query at a time under its lock
(``serve/engine.py``), so its capacity model is the single-server queue:

- **saturation QPS** = 1 / E[service time] — the ceiling the measured
  service-time distribution (the engine's lock-hold histogram, or
  qtrace's end-to-end account) permits;
- **utilization** ρ = arrival rate × E[service time] (Little's law);
- **projected wait** ≈ ρ/(1−ρ) × E[service] (M/M/1);
- **knee** of a measured QPS-vs-concurrency ramp: the last concurrency
  whose marginal QPS gain still cleared the floor;
- **batching headroom** from a measured per-pair step time:
  projected QPS(B) = 1000 / step_ms_per_pair(B), and the smallest
  bucket batch that hits a target QPS.

Inputs are recorded artifacts (obs dirs, round JSONs); the module
touches no device.
"""

import argparse
import json
import math
import os
import sys

__all__ = ['saturation_qps', 'utilization', 'mm1_wait_s', 'knee_of',
           'hist_mean_s', 'hist_quantile_s', 'batching_headroom',
           'live_summary', 'analyze_paths', 'render', 'main']


def saturation_qps(mean_service_s):
    """The serialized executor's throughput ceiling: 1 / E[service]."""
    if not mean_service_s or mean_service_s <= 0:
        return None
    return 1.0 / float(mean_service_s)


def utilization(arrival_qps, mean_service_s):
    """Little's-law utilization ρ = λ × E[service] (may exceed 1 when
    the measured arrival rate outruns the ceiling — that IS the
    saturation signal, not an error)."""
    if arrival_qps is None or not mean_service_s or mean_service_s <= 0:
        return None
    return float(arrival_qps) * float(mean_service_s)


def mm1_wait_s(arrival_qps, mean_service_s):
    """Projected queue wait ρ/(1−ρ)·E[service] (M/M/1); ``None`` at or
    past saturation — an unstable queue has no stationary wait."""
    rho = utilization(arrival_qps, mean_service_s)
    if rho is None or rho >= 1.0:
        return None
    return rho / (1.0 - rho) * float(mean_service_s)


def hist_mean_s(snapshot):
    """Mean from a :meth:`StreamingHistogram.snapshot` dict."""
    if not snapshot or not snapshot.get('count'):
        return None
    return float(snapshot['sum']) / float(snapshot['count'])


def hist_quantile_s(snapshot, q):
    """Quantile from a histogram SNAPSHOT (cumulative ``buckets``
    rows) — the artifact-side twin of ``StreamingHistogram.quantile``,
    upper-bound convention: the smallest bucket bound whose cumulative
    count covers the rank."""
    if not snapshot or not snapshot.get('count'):
        return None
    rank = q * snapshot['count']
    prev_bound = 0.0
    for bound, cum in snapshot['buckets']:
        if cum >= rank:
            return float(bound) if math.isfinite(bound) else prev_bound
        if math.isfinite(bound):
            prev_bound = float(bound)
    return prev_bound


def knee_of(ramp, min_gain=0.10):
    """The measured saturation knee of a QPS-vs-concurrency ramp.

    ``ramp`` is a list of ``{'clients', 'qps'}`` rows (any order).
    Walking in increasing concurrency, the knee is the last level whose
    QPS still improved on the previous level by at least ``min_gain``
    (fractional); every level past it bought queueing, not throughput.
    ``saturated`` is False when the ramp never stopped scaling — the
    knee lies beyond the measured range.
    """
    rows = sorted((r for r in ramp or []
                   if r.get('clients') and r.get('qps') is not None),
                  key=lambda r: r['clients'])
    if not rows:
        return None
    knee = rows[0]
    saturated = False
    for prev, cur in zip(rows, rows[1:]):
        if prev['qps'] > 0 and \
                (cur['qps'] - prev['qps']) / prev['qps'] >= min_gain:
            knee = cur
        else:
            saturated = True
            break
    return {'clients': knee['clients'], 'qps': knee['qps'],
            'saturated': saturated, 'min_gain': min_gain}


def batching_headroom(step_ms_per_pair_by_b, target_qps=None):
    """Projected QPS per bucket batch size from bench ``pairs_sweep``'s
    measured per-pair step time, plus the smallest batch hitting
    ``target_qps`` (``None`` when out of reach — honesty over hope)."""
    per_batch = {}
    for b, ms in (step_ms_per_pair_by_b or {}).items():
        try:
            b = int(b)
            ms = float(ms)
        except (TypeError, ValueError):
            continue
        if ms > 0:
            per_batch[b] = round(1000.0 / ms, 3)
    if not per_batch:
        return None
    out = {
        'projected_qps_per_batch': {str(b): per_batch[b]
                                    for b in sorted(per_batch)},
        'best_batch': max(per_batch, key=per_batch.get),
        'best_qps': max(per_batch.values()),
    }
    if target_qps:
        out['target_qps'] = float(target_qps)
        fits = [b for b in sorted(per_batch)
                if per_batch[b] >= float(target_qps)]
        out['recommended_batch'] = fits[0] if fits else None
    return out


def live_summary(cap_stats, qtrace_summary=None):
    """The `/status` ``capacity`` section: the engine's
    :meth:`~dgmc_tpu_torch.serve.engine.MatchEngine.capacity_stats` account
    reduced to the queueing model, with the engine's lock-wait
    distribution reconciled against qtrace's ``admission_queue_wait``
    stage (same measured region, two recorders — the reconciliation
    block proves the two dialects agree)."""
    hold = cap_stats.get('lock_hold') or {}
    wait = cap_stats.get('lock_wait') or {}
    mean_service = hist_mean_s(hold)
    window = cap_stats.get('window_s')
    queries = cap_stats.get('queries') or 0
    arrival = (queries - 1) / window if window and queries > 1 else None
    out = {
        'inflight': cap_stats.get('inflight'),
        'queries': queries,
        'arrival_qps': round(arrival, 3) if arrival else None,
        'mean_service_ms': (round(mean_service * 1e3, 4)
                            if mean_service else None),
        'saturation_qps': _round3(saturation_qps(mean_service)),
        'utilization': _round3(utilization(arrival, mean_service)),
        'projected_wait_ms': _ms(mm1_wait_s(arrival, mean_service)),
        'lock_wait_ms': _hist_ms(wait),
        'lock_hold_ms': _hist_ms(hold),
        'pad_fraction': cap_stats.get('pad_fraction'),
        'goodput_ratio': cap_stats.get('goodput_ratio'),
        'buckets': cap_stats.get('buckets'),
    }
    stage = ((qtrace_summary or {}).get('stages') or {}).get(
        'admission_queue_wait')
    if stage:
        engine_p95 = hist_quantile_s(wait, 0.95)
        out['admission_reconciliation'] = {
            'qtrace_count': stage.get('count'),
            'qtrace_p95_ms': stage.get('p95_ms'),
            'engine_count': wait.get('count'),
            'engine_p95_ms': (round(engine_p95 * 1e3, 4)
                              if engine_p95 is not None else None),
            'note': 'same measured region (the engine lock acquire); '
                    'qtrace counts traced queries only, the engine '
                    'histogram counts all',
        }
    return out


def _round3(v):
    return None if v is None else round(v, 3)


def _ms(v):
    return None if v is None else round(v * 1e3, 4)


def _hist_ms(snapshot):
    if not snapshot or not snapshot.get('count'):
        return None
    return {
        'count': snapshot['count'],
        'mean_ms': _ms(hist_mean_s(snapshot)),
        'p50_ms': _ms(hist_quantile_s(snapshot, 0.50)),
        'p95_ms': _ms(hist_quantile_s(snapshot, 0.95)),
        'p99_ms': _ms(hist_quantile_s(snapshot, 0.99)),
    }


# ---------------------------------------------------------------------------
# Artifact-side analysis (the CLI)
# ---------------------------------------------------------------------------

def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _from_obs_dir(path, out):
    qtrace = _read_json(os.path.join(path, 'qtrace_summary.json'))
    if qtrace:
        e2e = qtrace.get('end_to_end') or {}
        count = e2e.get('count')
        mean_s = (e2e['sum_ms'] / count / 1e3
                  if count and e2e.get('sum_ms') else None)
        out['service_time'] = {
            'source': f'{path}/qtrace_summary.json end_to_end',
            'queries': count,
            'mean_ms': round(mean_s * 1e3, 4) if mean_s else None,
            'saturation_qps': _round3(saturation_qps(mean_s)),
        }
    goodput = _read_json(os.path.join(path, 'goodput.json'))
    if goodput:
        out['goodput'] = {'source': f'{path}/goodput.json',
                          'goodput_ratio': goodput.get('goodput_ratio'),
                          'pad_fraction_max':
                              goodput.get('pad_fraction_max')}


def _from_round(path, d, out, target_qps):
    cap = d.get('capacity') or {}
    ramp = (d.get('ramp') or {}).get('levels') or d.get('ramp')
    if isinstance(ramp, list) and ramp:
        out['ramp'] = {'source': os.path.basename(path),
                       'levels': ramp,
                       'knee': knee_of(ramp)}
    if cap:
        out['serve_capacity'] = dict(cap, source=os.path.basename(path))
    if d.get('goodput'):
        out.setdefault('goodput', {})
        out['goodput'].update(dict(d['goodput'],
                                   source=os.path.basename(path)))
    sweep = _pairs_sweep_of(d)
    if sweep:
        per_b = {b: v.get('step_ms_per_pair')
                 for b, v in sweep.items()
                 if isinstance(v, dict) and v.get('step_ms_per_pair')}
        headroom = batching_headroom(per_b, target_qps)
        if headroom:
            out['batching_headroom'] = dict(
                headroom, source=os.path.basename(path))


def _pairs_sweep_of(d):
    for holder in (d.get('result') or {}, d):
        for key in ('sparse_dbp15k', 'sparse'):
            sweep = (holder.get(key) or {}).get('pairs_sweep') \
                if isinstance(holder.get(key), dict) else None
            if sweep:
                return sweep
    return (d.get('result') or {}).get('pairs_sweep') \
        or d.get('pairs_sweep')


def analyze_paths(paths, target_qps=None):
    """One capacity report object from committed evidence: obs dirs
    (service-time distribution, goodput artifact) and/or round JSONs
    (serve rounds' ramp + capacity blocks, bench rounds'
    ``pairs_sweep`` for batching headroom)."""
    out = {'inputs': list(paths)}
    if target_qps:
        out['target_qps'] = float(target_qps)
    for p in paths:
        if os.path.isdir(p):
            _from_obs_dir(p, out)
            continue
        d = _read_json(p)
        if d is None:
            out.setdefault('unreadable', []).append(p)
            continue
        _from_round(p, d, out, target_qps)
    return out


def render(report):
    lines = ['== capacity model ==']
    st = report.get('service_time')
    if st:
        lines.append(f'  service time     mean {st.get("mean_ms")} ms '
                     f'over {st.get("queries")} queries '
                     f'[{st.get("source")}]')
        lines.append(f'  saturation QPS   {st.get("saturation_qps")}')
    cap = report.get('serve_capacity')
    if cap:
        lines.append(f'  serve capacity   [{cap.get("source")}]')
        for key in ('saturation_qps', 'utilization', 'arrival_qps',
                    'mean_service_ms', 'projected_wait_ms'):
            if cap.get(key) is not None:
                lines.append(f'    {key:<18} {cap[key]}')
    ramp = report.get('ramp')
    if ramp:
        lines.append(f'  concurrency ramp [{ramp.get("source")}]')
        lines.append(f'    {"clients":>7} {"QPS":>8} {"p50 ms":>9} '
                     f'{"p95 ms":>9}')
        for row in ramp['levels']:
            lines.append(f'    {row.get("clients", "-"):>7} '
                         f'{_f(row.get("qps")):>8} '
                         f'{_f(row.get("p50_ms")):>9} '
                         f'{_f(row.get("p95_ms")):>9}')
        knee = ramp.get('knee')
        if knee:
            beyond = '' if knee['saturated'] else \
                ' (beyond the measured range)'
            lines.append(f'    knee: {knee["clients"]} clients @ '
                         f'{knee["qps"]} QPS{beyond}')
    good = report.get('goodput')
    if good:
        lines.append(f'  goodput          ratio '
                     f'{good.get("goodput_ratio")}, max pad fraction '
                     f'{good.get("pad_fraction_max")} '
                     f'[{good.get("source", "?")}]')
    hr = report.get('batching_headroom')
    if hr:
        lines.append(f'  batching headroom [{hr.get("source")}]')
        for b, qps in hr['projected_qps_per_batch'].items():
            lines.append(f'    B={b:<3} projected {qps} QPS')
        if hr.get('target_qps'):
            rec = hr.get('recommended_batch')
            lines.append(f'    target {hr["target_qps"]} QPS -> '
                         + (f'B={rec}' if rec is not None
                            else 'out of reach at measured rates'))
    if len(lines) == 1:
        lines.append('  (no capacity evidence in the given paths)')
    return '\n'.join(lines)


def _f(v):
    return '-' if v is None else f'{v:.4g}'


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.capacity',
        description='Model serving capacity from committed evidence: '
                    'saturation QPS, Little\'s-law utilization, the '
                    'measured concurrency knee, and bench-seeded '
                    'batching headroom.')
    parser.add_argument('paths', nargs='+',
                        help='obs dirs and/or round JSONs '
                             '(SERVE_r*.json ramps, BENCH_r*.json '
                             'pairs_sweep)')
    parser.add_argument('--target-qps', type=float, default=None,
                        help='QPS target for the batching-headroom '
                             'recommendation')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable report')
    args = parser.parse_args(argv)

    for p in args.paths:
        if not os.path.exists(p):
            print(f'capacity: no such path: {p}', file=sys.stderr)
            return 2
    report = analyze_paths(args.paths, target_qps=args.target_qps)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
