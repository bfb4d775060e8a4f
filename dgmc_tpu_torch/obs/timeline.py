"""Longitudinal bench trajectory: the round records as one table.

The port's copy of the JAX package's ``dgmc_tpu/obs/timeline.py`` (the
same rows, table, ``--json`` and ``--trend``)::

    python -m dgmc_tpu_torch.obs.timeline DIR [DIR ...]          # table
    python -m dgmc_tpu_torch.obs.timeline DIR --json             # rows
    python -m dgmc_tpu_torch.obs.timeline DIR --trend            # + CUSUM

``obs.diff`` compares exactly two runs; a benchmark's HISTORY is its
round records: ``BENCH_r*.json`` (single device), ``MULTICHIP_r*.json``
(sharded), ``SCALE_r*.json`` (streamed million-entity) and
``SERVE_r*.json`` (the matching service's load rounds: query-latency
p50/p95, QPS, restart count and the warm restart-to-first-answer beside
the training families' columns). This CLI walks one or more directories
(default: the current one), parses every round record it finds (both
the structured schema of r06+ and the legacy ``{'cmd', 'rc', 'tail',
'parsed'}`` bench capture of r01–r05), and renders the trajectory per
family.

Columns are the headline series: throughput (pairs/s), step p50, MFU,
modeled overlap fraction, skew, device count, and the round's outcome
(``rc:124`` rounds show up as exactly that). SCALE rows additionally
carry the ``offload`` column (prefetch-ring depth + host-resident corpus
bytes) so a jump in rows reads as the layout change it is. Touches no
device.
"""

import argparse
import json
import os
import re
import sys

from dgmc_tpu_torch.obs.observe import fmt_seconds

__all__ = ['collect_rounds', 'parse_round', 'render', 'trend',
           'render_trend', 'main']

_ROUND_FILE = re.compile(r'^(BENCH|MULTICHIP|SCALE|SERVE)_r(\d+)\.json$')
#: Family render order (matches the chronology: single-chip first).
_FAMILIES = ('BENCH', 'MULTICHIP', 'SCALE', 'SERVE')


def _get(d, *path):
    for key in path:
        if not isinstance(d, dict):
            return None
        d = d.get(key)
    return d


def _first(*vals):
    for v in vals:
        if v is not None:
            return v
    return None


def parse_round(family, number, path):
    """One normalized row from a round record (any schema vintage).

    Returns ``{'family', 'round', 'file', 'outcome', 'devices',
    'pairs_per_sec', 'step_p50_ms', 'mfu', 'overlap', 'skew',
    'device'}`` — absent measurements are ``None``, never guessed.
    """
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError) as e:
        return {'family': family, 'round': number,
                'file': os.path.basename(path),
                'outcome': f'unreadable ({type(e).__name__})'}
    # r01-r05 bench captures keep the measurement under 'parsed';
    # r06+ structured records keep it under 'result' (BENCH) or at the
    # top level (MULTICHIP/SCALE).
    parsed = d.get('parsed') or {}
    result = d.get('result') or {}
    rc = d.get('rc')
    outcome = _first(_get(d, 'supervision', 'outcome'),
                     _get(d, 'supervision', 'outcome_8dev'),
                     d.get('outcome'))
    if outcome is None:
        if rc == 0 or d.get('ok'):
            outcome = 'completed'
        elif d.get('skipped'):
            outcome = 'skipped'
        elif rc is not None:
            outcome = f'rc:{rc}'
        else:
            outcome = '?'
    restarts = _first(_get(d, 'supervision', 'restarts'),
                      _get(d, 'supervision', 'restarts_8dev'))
    if restarts and family != 'SERVE':
        # SERVE rows carry restarts as their own column (the chaos kill
        # is part of the round's protocol, not an anomaly to flag).
        outcome = f'{outcome} ({restarts} restarts)'
    row = {
        'family': family,
        'round': number,
        'file': os.path.basename(path),
        'outcome': outcome,
        'devices': d.get('n_devices'),
        'device': _first(result.get('device'), parsed.get('device'),
                         _get(d, 'environment', 'platform')),
        'pairs_per_sec': _first(
            result.get('value') if result.get('metric')
            == 'train_pairs_per_sec' else None,
            parsed.get('value') if parsed.get('metric')
            == 'train_pairs_per_sec' else None),
        'step_p50_ms': _first(
            _get(d, 'timing', 'step_p50_ms_8dev'),
            _get(d, 'timing', 'step_p50_ms'),
            _get(result, 'sparse_dbp15k', 'f32', 'step_ms'),
            _get(result, 'sparse_dbp15k', 'step_ms'),
            _get(parsed, 'sparse_dbp15k', 'step_ms')),
        'mfu': _first(_get(result, 'dense_perf', 'mfu'),
                      _get(parsed, 'dense_perf', 'mfu'),
                      d.get('mfu')),
        'overlap': _first(
            _get(d, 'analysis_fields', 'overlap_fraction'),
            _get(result, 'dense_perf', 'overlap_fraction'),
            d.get('overlap_fraction'),
            _get(d, 'timing', 'overlap_fraction')),
        'skew': _get(d, 'timing', 'per_device_step_skew_ratio'),
        # Quality plane (PR 17+): rounds carrying a 'quality' block get
        # accuracy columns; older rounds simply render '-'.
        'hits1': _first(_get(d, 'quality', 'hits1'),
                        d.get('hits_at_1')),
    }
    off = d.get('offload') or {}
    if off:
        row['offload'] = {
            'rows': off.get('rows'),
            'prefetch_depth': off.get('prefetch_depth'),
            'host_resident_bytes': off.get('host_resident_bytes'),
            'outcome': off.get('outcome'),
        }
    if family == 'SERVE':
        # The serving rounds' headline series: per-query latency, QPS
        # under concurrent load, and how many supervised restarts the
        # round survived (the mid-run SIGKILL is part of the protocol —
        # 1 restart is the healthy shape, not a regression).
        lat = d.get('latency') or {}
        restart = d.get('restart') or {}
        # r02+ rounds carry a per-query trace account (obs.qtrace):
        # p99 and the stage the p95−p50 gap attributes to. Older
        # rounds simply lack the block — the columns render '-'.
        qt = d.get('qtrace') or {}
        # r03+ rounds add the quality account: per-query confidence
        # and the shadow audit's worst-case shortlist recall.
        quality = d.get('quality') or {}
        audit = quality.get('audit') or {}
        # r04+ rounds add the capacity/goodput account (obs.capacity /
        # obs.goodput): serve-path goodput ratio and the Little's-law
        # utilization ρ. Older rounds lack both blocks — the columns
        # render '-'.
        row.update({
            'audit_recall': audit.get('recall_min'),
            'saturated_frac': quality.get('saturated_frac'),
            'goodput': _first(
                _get(d, 'goodput', 'serve', 'goodput_ratio'),
                _get(d, 'goodput', 'goodput_ratio')),
            'utilization': _get(d, 'capacity', 'utilization'),
            'latency_p50_ms': _first(lat.get('server_p50_ms'),
                                     lat.get('client_p50_ms')),
            'latency_p95_ms': _first(lat.get('server_p95_ms'),
                                     lat.get('client_p95_ms')),
            'latency_p99_ms': qt.get('p99_ms'),
            'dominant_stage': qt.get('dominant_stage'),
            'qps': d.get('qps'),
            'clients': d.get('clients'),
            'restarts': _first(_get(d, 'supervision', 'restarts'), 0),
            'warm_restart_s': restart.get('warm_first_answer_s'),
        })
    # Truncate the long prose device/platform strings to their lead.
    if isinstance(row['device'], str):
        row['device'] = row['device'].split('(')[0].strip() or None
    return row


def collect_rounds(paths):
    """All round rows under ``paths`` (files or directories, searched
    non-recursively), sorted by (family, round). Duplicate
    family/round pairs keep every file (distinct directories can
    legitimately both hold a round — the table shows the file)."""
    rows = []
    for p in paths:
        if os.path.isfile(p):
            m = _ROUND_FILE.match(os.path.basename(p))
            if m:
                rows.append(parse_round(m.group(1), int(m.group(2)), p))
            continue
        try:
            names = sorted(os.listdir(p))
        except OSError:
            continue
        for name in names:
            m = _ROUND_FILE.match(name)
            if m:
                rows.append(parse_round(m.group(1), int(m.group(2)),
                                        os.path.join(p, name)))
    fam_rank = {f: i for i, f in enumerate(_FAMILIES)}
    rows.sort(key=lambda r: (fam_rank.get(r['family'], len(fam_rank)),
                             r['round'], r['file']))
    return rows


def _fmt(v, spec='{:.4g}'):
    return '-' if v is None else spec.format(v)


def _fmt_offload(off):
    """``d<depth>/<host GiB>`` — the ring depth and where the corpus
    lives; '-' for rows without an offload tier."""
    if not off:
        return '-'
    depth = off.get('prefetch_depth')
    host = off.get('host_resident_bytes')
    host = f'{host / 2**30:.1f}G' if host else '?'
    return f'd{depth if depth is not None else "?"}/{host}'


def _render_serve(fam_rows, lines):
    """SERVE rows carry a different headline set than the training
    families: per-query latency p50/p95/p99, sustained QPS, concurrent
    clients, warm restart-to-first-answer, restart count, and the
    stage the tail gap attributes to (``obs.qtrace``; rounds predating
    the trace account render '-')."""
    lines.append('== SERVE trajectory ==')
    lines.append(f'  {"round":>5} {"p50":>9} {"p95":>9} {"p99":>9} '
                 f'{"QPS":>7} {"clients":>7} {"warm rta":>9} '
                 f'{"restarts":>8} {"tail stage":>16} '
                 f'{"hits@1":>7} {"audit":>7} '
                 f'{"goodput":>7} {"util":>6}  outcome')
    for r in fam_rows:
        p50 = r.get('latency_p50_ms')
        p95 = r.get('latency_p95_ms')
        p99 = r.get('latency_p99_ms')
        lines.append(
            f'  {r["round"]:>5} '
            f'{fmt_seconds(p50 / 1e3) if p50 is not None else "-":>9} '
            f'{fmt_seconds(p95 / 1e3) if p95 is not None else "-":>9} '
            f'{fmt_seconds(p99 / 1e3) if p99 is not None else "-":>9} '
            f'{_fmt(r.get("qps")):>7} '
            f'{_fmt(r.get("clients"), "{:d}"):>7} '
            f'{_fmt(r.get("warm_restart_s"), "{:.2f}s"):>9} '
            f'{_fmt(r.get("restarts"), "{:d}"):>8} '
            f'{r.get("dominant_stage") or "-":>16} '
            f'{_fmt(r.get("hits1"), "{:.4f}"):>7} '
            f'{_fmt(r.get("audit_recall"), "{:.2f}"):>7} '
            f'{_fmt(r.get("goodput"), "{:.3f}"):>7} '
            f'{_fmt(r.get("utilization"), "{:.3f}"):>6}'
            f'  {r.get("outcome", "?")}')


def render(rows):
    lines = []
    for family in _FAMILIES:
        fam_rows = [r for r in rows if r['family'] == family]
        if not fam_rows:
            continue
        if family == 'SERVE':
            _render_serve(fam_rows, lines)
            continue
        offload_col = any(r.get('offload') for r in fam_rows)
        hits1_col = any(r.get('hits1') is not None for r in fam_rows)
        lines.append(f'== {family} trajectory ==')
        lines.append(f'  {"round":>5} {"pairs/s":>9} {"step p50":>11} '
                     f'{"MFU":>8} {"overlap":>8} {"skew":>7} '
                     f'{"dev":>4}'
                     + (f' {"offload":>9}' if offload_col else '')
                     + (f' {"hits@1":>7}' if hits1_col else '')
                     + '  outcome')
        for r in fam_rows:
            p50 = r.get('step_p50_ms')
            p50 = fmt_seconds(p50 / 1e3) if p50 is not None else '-'
            mfu = r.get('mfu')
            mfu = f'{mfu:.2%}' if mfu is not None else '-'
            lines.append(
                f'  {r["round"]:>5} {_fmt(r.get("pairs_per_sec")):>9} '
                f'{p50:>11} {mfu:>8} {_fmt(r.get("overlap")):>8} '
                f'{_fmt(r.get("skew"), "{:.3f}x"):>7} '
                f'{_fmt(r.get("devices"), "{:d}"):>4}'
                + (f' {_fmt_offload(r.get("offload")):>9}'
                   if offload_col else '')
                + (f' {_fmt(r.get("hits1"), "{:.4f}"):>7}'
                   if hits1_col else '')
                + f'  {r.get("outcome", "?")}')
    if not lines:
        lines.append('(no BENCH_r*/MULTICHIP_r*/SCALE_r*.json rounds '
                     'found)')
    return '\n'.join(lines)


#: Headline series the --trend changepoint scan walks per family.
_TREND_METRICS = {
    'BENCH': ('pairs_per_sec', 'step_p50_ms', 'mfu', 'overlap',
              'hits1'),
    'MULTICHIP': ('pairs_per_sec', 'step_p50_ms', 'mfu', 'overlap',
                  'skew'),
    'SCALE': ('pairs_per_sec', 'step_p50_ms', 'mfu'),
    'SERVE': ('latency_p50_ms', 'latency_p95_ms', 'qps', 'hits1',
              'goodput', 'utilization', 'warm_restart_s'),
}


def trend(rows):
    """CUSUM changepoints over each family's headline series
    (:func:`dgmc_tpu_torch.obs.anomaly.changepoints` — the offline form
    of the live watch). Returns ``[{'family', 'metric', 'rounds',
    'changepoints': [{'round', 'direction', 'value'}]}, ...]`` for
    every series with enough measured rounds to have a baseline; the
    changepoint index maps back to the ROUND NUMBER so "p95 shifted up
    at r04" reads straight off the table."""
    from dgmc_tpu_torch.obs.anomaly import changepoints
    out = []
    for family in _FAMILIES:
        fam_rows = [r for r in rows if r['family'] == family]
        if not fam_rows:
            continue
        for metric in _TREND_METRICS.get(family, ()):
            series = [r.get(metric) for r in fam_rows]
            measured = sum(1 for v in series if v is not None)
            if measured < 4:
                continue  # 3 baseline rounds + 1 to judge, minimum
            cps = changepoints(series)
            out.append({
                'family': family,
                'metric': metric,
                'rounds': measured,
                'changepoints': [
                    {'round': fam_rows[cp['index']]['round'],
                     'direction': cp['direction'],
                     'value': cp['value']}
                    for cp in cps],
            })
    return out


def render_trend(trends):
    lines = ['== trend changepoints (CUSUM over committed rounds) ==']
    if not trends:
        lines.append('  (no series with enough measured rounds — need '
                     '4+ per family/metric)')
        return '\n'.join(lines)
    shifted = [t for t in trends if t['changepoints']]
    for t in shifted:
        marks = ', '.join(
            f'r{cp["round"]:02d} {cp["direction"]} '
            f'(to {_fmt(cp["value"])})'
            for cp in t['changepoints'])
        lines.append(f'  {t["family"]:<9} {t["metric"]:<16} {marks}')
    stable = [t for t in trends if not t['changepoints']]
    if stable:
        lines.append(
            '  stable: ' + ', '.join(
                f'{t["family"]}.{t["metric"]}' for t in stable))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.timeline',
        description='Render the longitudinal trajectory of bench '
                    'rounds (BENCH_r*/MULTICHIP_r*/SCALE_r*/SERVE_r*.json) '
                    'across directories.')
    parser.add_argument('paths', nargs='*', default=None,
                        help='directories (or round files) to scan; '
                             'default: the current directory')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable rows')
    parser.add_argument('--trend', action='store_true',
                        help='append the CUSUM changepoint view: which '
                             'round each headline series shifted at '
                             '(obs.anomaly.changepoints over the '
                             'trajectory)')
    args = parser.parse_args(argv)

    paths = args.paths or ['.']
    rows = collect_rounds(paths)
    if args.json:
        payload = ({'rows': rows, 'trend': trend(rows)}
                   if args.trend else rows)
        print(json.dumps(payload, indent=1))
    else:
        print(render(rows))
        if args.trend:
            print(render_trend(trend(rows)))
    if not rows:
        print(f'timeline: no round records under {paths}',
              file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main())
