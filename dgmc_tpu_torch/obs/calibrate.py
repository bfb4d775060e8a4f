"""Variance calibration: noise floors for the regression gates.

The port's copy of the JAX package's ``dgmc_tpu/obs/calibrate.py`` (the
same fits, ``calibration.json`` body and rescaling).

A diff gate that compares two single runs against a fixed threshold
cannot tell run-to-run noise from a regression. This module measures
the noise:

- :func:`fit_calibration` fits per-metric **noise floors** — median
  and MAD (median absolute deviation), the robust pair that one bad
  run cannot drag — from two evidence sources: N repeat obs dirs of
  the same workload (``--obs-dir``, repeatable; metrics keyed by the
  ``obs.report`` summary vocabulary: ``step_p50_s``, ``hits1``, ...)
  and round records (``--rounds DIR``; keyed ``FAMILY.metric``:
  ``SERVE.hits1``, ``BENCH.step_p50_ms``). The robust sigma is
  ``1.4826 * MAD`` (normal-consistent), and
  ``rel_sigma = sigma / |median|`` is the unit the gates consume.
- :func:`apply_calibration` rescales ``obs.diff``'s RELATIVE
  regression thresholds to ``z * rel_sigma`` (z defaults to 3: a
  gate fires only on a shift three noise floors deep). Metrics
  without calibration (or with fewer than ``min_samples`` samples)
  keep their fixed threshold unchanged: a thin calibration file never
  silently widens every gate. Absolute floors (``--min-hits1`` etc.)
  stay explicit CLI values: a floor is a product decision, not a noise
  estimate.

CLI::

    python -m dgmc_tpu_torch.obs.calibrate \
        --obs-dir runs/rep1 --obs-dir runs/rep2 --obs-dir runs/rep3 \
        --out calibration.json

With three repeats the MAD is the smaller of two deviations from the
median, so a gate of ``z * rel_sigma`` is narrow by chance now and then:
fit over more repeats, or pass a larger ``--calibration-z`` to the diff.
Touches no device.
"""

import argparse
import json
import os
import sys

__all__ = ['fit_samples', 'fit_calibration', 'apply_calibration',
           'collect_obs_metrics', 'collect_round_metrics',
           'CALIBRATED_GATES', 'CALIBRATION_SCHEMA_VERSION', 'main']

CALIBRATION_SCHEMA_VERSION = 1

#: diff threshold key -> obs.report summary metric that calibrates it.
#: RELATIVE gates only — each of these thresholds is a fraction of the
#: baseline value, the same unit as ``rel_sigma``. Absolute gates
#: (compile-event counts, restart counts, min_* floors) are outside
#: calibration's writ by design.
CALIBRATED_GATES = {
    'step_p50': 'step_p50_s',
    'step_p95': 'step_p95_s',
    'throughput': 'steps_per_sec',
    'memory': 'peak_memory_bytes',
    'mfu': 'mfu',
    'intensity': 'arith_intensity',
    'static_peak': 'static_peak_bytes',
    'idle': 'idle_fraction',
    'hits1': 'hits1',
}


def fit_samples(values):
    """Robust location/scale for one metric's samples.

    Returns ``{'n', 'median', 'mad', 'sigma', 'rel_sigma', 'min',
    'max'}``; ``sigma = 1.4826 * MAD`` (consistent for normal noise),
    ``rel_sigma = sigma / |median|`` or ``None`` at median 0 (no
    relative scale exists there).
    """
    vals = sorted(float(v) for v in values)
    n = len(vals)
    if n == 0:
        raise ValueError('fit_samples: no samples')

    def _median(sorted_vals):
        m = len(sorted_vals)
        mid = m // 2
        if m % 2:
            return sorted_vals[mid]
        return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])

    median = _median(vals)
    mad = _median(sorted(abs(v - median) for v in vals))
    sigma = 1.4826 * mad
    rel_sigma = None if median == 0 else sigma / abs(median)
    return {'n': n, 'median': median, 'mad': mad,
            'sigma': sigma, 'rel_sigma': rel_sigma,
            'min': vals[0], 'max': vals[-1]}


def _numeric_items(mapping):
    for key, val in mapping.items():
        if isinstance(val, bool):
            continue
        if isinstance(val, (int, float)):
            yield key, float(val)


def collect_obs_metrics(obs_dirs):
    """``{metric: [value, ...]}`` across repeat obs dirs, keyed by the
    ``obs.report`` summary vocabulary (every numeric scalar the
    summary emits, plus per-stage qtrace p95s as
    ``qtrace_stage.<name>.p95_ms``)."""
    from dgmc_tpu_torch.obs.report import load_run, summarize
    metrics = {}
    for d in obs_dirs:
        summary = summarize(load_run(d))
        flat = dict(_numeric_items(summary))
        for name, q in (summary.get('qtrace_stages') or {}).items():
            if isinstance(q, dict) and q.get('p95_ms') is not None:
                flat[f'qtrace_stage.{name}.p95_ms'] = float(q['p95_ms'])
        for key, val in flat.items():
            metrics.setdefault(key, []).append(val)
    return metrics


def collect_round_metrics(paths):
    """``{'FAMILY.metric': [value, ...]}`` across the round records
    (``obs.timeline``'s normalized rows; numeric scalars
    only — the round number itself is an index, not a metric)."""
    from dgmc_tpu_torch.obs.timeline import collect_rounds
    metrics = {}
    for row in collect_rounds(paths):
        family = row.get('family') or '?'
        for key, val in _numeric_items(row):
            if key == 'round':
                continue
            metrics.setdefault(f'{family}.{key}', []).append(val)
    return metrics


def fit_calibration(obs_dirs=(), round_paths=(), min_samples=2):
    """The ``calibration.json`` body: per-metric fits from both
    evidence sources. Metrics with fewer than ``min_samples`` samples
    are dropped — one observation has no spread."""
    samples = {}
    if obs_dirs:
        samples.update(collect_obs_metrics(obs_dirs))
    if round_paths:
        samples.update(collect_round_metrics(round_paths))
    fitted = {key: fit_samples(vals)
              for key, vals in sorted(samples.items())
              if len(vals) >= min_samples}
    return {
        'version': CALIBRATION_SCHEMA_VERSION,
        'generated_by': 'python -m dgmc_tpu_torch.obs.calibrate',
        'sources': {'obs_dirs': [os.path.normpath(d) for d in obs_dirs],
                    'rounds': [os.path.normpath(p)
                               for p in round_paths]},
        'min_samples': min_samples,
        'metrics': fitted,
    }


def load_calibration(path):
    """Parse + validate a calibration file; raises ``ValueError`` (a
    malformed calibration must fail the diff at startup, not silently
    judge with fixed thresholds)."""
    try:
        with open(path) as f:
            cal = json.load(f)
    except OSError as e:
        raise ValueError(f'calibration: cannot read {path}: {e}')
    except json.JSONDecodeError as e:
        raise ValueError(f'calibration: {path} is not valid JSON: {e}')
    if not isinstance(cal, dict) or not isinstance(
            cal.get('metrics'), dict):
        raise ValueError(f'calibration: {path} has no "metrics" object')
    return cal


def apply_calibration(thresholds, calibration, z=3.0, min_samples=3,
                      floor=0.01):
    """Rescale the relative gates to ``z * rel_sigma``.

    Returns ``(new_thresholds, notes)``; ``notes`` is one record per
    rescaled gate (for the diff's table — a calibrated verdict must
    say what it was judged by). Pinned fallbacks: a gate whose metric
    is uncalibrated, under-sampled, or scale-free (``rel_sigma``
    ``None``) keeps its fixed threshold; a calibrated threshold is
    floored at ``floor`` (a dead-flat repeat set must not produce a
    zero-width gate that fails on the next run's least significant
    digit).
    """
    metrics = calibration.get('metrics') or {}
    out = dict(thresholds)
    notes = []
    for gate, metric in CALIBRATED_GATES.items():
        if out.get(gate) is None:
            continue  # gate not armed: calibration must not arm it
        stats = metrics.get(metric)
        if not stats:
            continue
        if stats.get('n', 0) < min_samples:
            continue
        rel_sigma = stats.get('rel_sigma')
        if rel_sigma is None:
            continue
        calibrated = max(z * float(rel_sigma), floor)
        notes.append({'gate': gate, 'metric': metric,
                      'fixed': out[gate], 'calibrated': calibrated,
                      'rel_sigma': float(rel_sigma),
                      'n': stats['n'], 'z': z})
        out[gate] = calibrated
    return out, notes


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.calibrate',
        description='Fit per-metric noise floors (median/MAD) from '
                    'repeat obs dirs and benchmark rounds; '
                    'write calibration.json for obs.diff '
                    '--calibration.')
    parser.add_argument('--obs-dir', action='append', default=[],
                        metavar='DIR',
                        help='one repeat-run obs dir (repeatable); '
                             'metrics keyed by the obs.report summary '
                             'vocabulary')
    parser.add_argument('--rounds', action='append', default=[],
                        metavar='DIR',
                        help='directory of *_r*.json round records '
                             '(repeatable); metrics keyed '
                             'FAMILY.metric')
    parser.add_argument('--out', default='calibration.json',
                        help='output path (default: %(default)s)')
    parser.add_argument('--min-samples', type=int, default=2,
                        help='drop metrics with fewer samples '
                             '(default: %(default)s)')
    args = parser.parse_args(argv)

    if not args.obs_dir and not args.rounds:
        parser.error('need at least one --obs-dir or --rounds')
    cal = fit_calibration(obs_dirs=args.obs_dir,
                          round_paths=args.rounds,
                          min_samples=args.min_samples)
    if not cal['metrics']:
        print('calibrate: no metric reached --min-samples '
              f'{args.min_samples}; nothing to write', file=sys.stderr)
        return 2
    tmp = args.out + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(cal, f, indent=1, sort_keys=True)
        f.write('\n')
    os.replace(tmp, args.out)
    gates = sorted(m for m in CALIBRATED_GATES.values()
                   if m in cal['metrics'])
    print(f'calibrate: {len(cal["metrics"])} metrics fitted '
          f'({len(gates)} feed diff gates: {", ".join(gates)}) '
          f'-> {args.out}')
    for key in gates:
        s = cal['metrics'][key]
        rel = ('n/a' if s['rel_sigma'] is None
               else f'{s["rel_sigma"]:.4f}')
        print(f'  {key}: n={s["n"]} median={s["median"]:.6g} '
              f'rel_sigma={rel}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
