"""Cross-run regression diff: compare two ``--obs-dir`` runs, gate CI.

The port's copy of the JAX package's ``dgmc_tpu/obs/diff.py`` (the same
rows, statuses, notes, JSON and exit codes on the same artifacts)::

    python -m dgmc_tpu_torch.obs.diff BASELINE CANDIDATE       # table + rc
    python -m dgmc_tpu_torch.obs.diff A B --json          # machine-readable
    python -m dgmc_tpu_torch.obs.diff A B --max-step-p50-regression 0.5

The diff compares the summaries :mod:`dgmc_tpu_torch.obs.report` builds —
throughput, step p50/p95, compile events, memory peak, the
kernel-dispatch table, probe aggregates, the cost, attribution,
goodput, capacity and recovery accounts — against configurable
regression thresholds. The kernel-dispatch gate reads the port's
outcomes: ``kernel`` (a CUDA kernel launched) where JAX's reads
``pallas``, ``plain`` (the plain PyTorch version ran) where JAX's reads
``fallback``.

What a row measures on the card: without a fence a step's time is the
host's call, and a captured step's call is the replay's launch, not its
execution (:class:`~dgmc_tpu_torch.obs.observe.StepTimer`). So the step
rows, ``steps_per_sec`` and the headline ``mfu`` (``efficiency.json``
divides by that same p50) compare launch times; the row that sees the
card's time is ``idle_fraction`` with ``idle_source`` ``device`` (from
``attribution.json``, merged by ``python -m
dgmc_tpu_torch.obs.attribution PROFILE --obs-dir DIR``). A run of several
ranks writes ``overlap_fraction`` and ``static_peak_bytes`` (the schedule
and liveness models over its counted step, ``obs/cost.py``), as do the
specimen rows of ``obs.cost``; a one-process run writes neither, and no
run writes ``measured_overlap_fraction`` on one card: the diff treats a
missing account as it treats any run without it (no row when both lack
one; a candidate that lost what the baseline had fails).

- **step p50 / p95** — relative increase above
  ``--max-step-p50-regression`` / ``--max-step-p95-regression`` fails.
- **throughput** — relative decrease above
  ``--max-throughput-regression`` fails.
- **compile events** — more than ``--max-new-compile-events`` extra
  events fails (padding-bucket churn shows up here).
- **memory peak** — relative increase above
  ``--max-memory-regression`` fails (only when both runs report the
  same source: device peaks and host RSS are not comparable).
- **kernel dispatch** — a kernel whose CUDA kernel launched in the
  baseline (outcome ``kernel``) but only ran its plain version in the
  candidate (``plain``), or whose decision the candidate never reached,
  fails (``--allow-kernel-fallback`` downgrades this to a note).
- **probes** — a candidate run that recorded a non-finite stage fails;
  numeric probe aggregates (entropy, consensus delta, grad norm) are
  reported as informational drift rows.
- **hang reports** — a candidate that left a ``hang_report.json`` the
  baseline did not have fails unconditionally: a run that hung must
  never diff as "fewer metrics, pass". Both-hung compares the rest
  and notes it; baseline-only-hung is the fix, not a regression.
- **restarts** — a supervised candidate (``recovery.json``, see
  ``dgmc_tpu_torch.resilience.supervisor``) that needed more restarts
  than the baseline plus ``--max-restarts-regression`` fails — a newly
  flaky path is a regression even when the final attempt's metrics look
  fine — and a candidate whose supervisor **gave up** fails
  unconditionally.
- **elastic shrinks** — a candidate whose supervisor performed more
  elastic mesh shrinks than the baseline fails: the run survived, but
  on fewer devices than it asked for, which invalidates every scaling
  number the surviving metrics report.
- **MFU** — relative decrease of the headline MFU
  (``efficiency.json``) above ``--max-mfu-regression`` fails, as does
  an MFU the baseline had but the candidate lost.
- **arithmetic intensity** — relative decrease of the headline achieved
  FLOPs/byte (``efficiency.json``) above
  ``--max-intensity-regression`` fails (a program that got
  byte-heavier per FLOP slid down the roofline even if wall-clock
  noise hides it); lost-from-candidate fails like MFU.
- **collective overlap** — the headline modeled overlap fraction
  (``efficiency.json``, from a schedule model) dropping below the
  ``--min-overlap`` floor fails: the chunk loop serialized, whatever
  wall-clock noise says. An absolute floor, not a ratio — 0.0 is a
  meaningful value and ratios against it are not. Lost-from-candidate fails.
- **static peak bytes** — relative increase of the liveness model's
  static peak-live bound (``efficiency.json``) above
  ``--max-peak-regression`` fails; unlike the runtime memory row it
  needs no matching measurement source, because the bound is computed
  from the compiled program alone. Lost-from-candidate fails.
- **measured overlap** — the *measured* comm/compute overlap fraction
  (``efficiency.json``, from the profiler-trace attribution
  ``obs.attribution``) dropping below the ``--min-measured-overlap``
  floor fails. Same absolute-floor / lost-account semantics as
  ``--min-overlap``: this is the runtime truth the static model only
  bounds — a candidate that lost the measurement the baseline had
  fails, and the floor only gates when configured (device-less CPU
  captures have no measured overlap to gate).
- **idle fraction** — the attribution plane's idle headline
  (``efficiency.json``: device idle inside the profiled window, or
  host idle on device-less captures) growing past
  ``--max-idle-regression`` fails; like the memory row, the two runs
  must report the same ``idle_source`` (device idle and host idle are
  not comparable). Lost-from-candidate fails; a zero-idle baseline
  gates the candidate's absolute idle fraction against the threshold
  directly (a ratio against 0 is undefined, and "we used to have no
  idle" is exactly the baseline worth defending).

- **skew** — the device step-time skew ratio (``aggregate.json``, see
  ``obs.aggregate``) growing past ``--max-skew-regression`` fails;
  runs without aggregation skip the row (the artifact is produced by a
  separate tool, so absence is not evidence of regression).
- **serve stage p95** — each serve stage's p95 latency
  (``qtrace_summary.json``, see ``obs.qtrace``) growing past
  ``--max-stage-p95-regression`` fails. Off unless configured (like
  ``--min-overlap``): training runs carry no qtrace account. When on,
  a serving candidate that LOST the per-stage account the baseline had
  fails — tail-latency attribution is itself a gated artifact.
- **goodput ratio** — the padding-waste account's useful-over-executed
  FLOPs ratio (``goodput.json``, see ``obs.goodput``) dropping below
  the ``--min-goodput`` floor fails. Absolute floor with
  ``--min-overlap`` semantics: a candidate that lost the goodput
  account the baseline carried fails unconditionally (the batcher that
  silently stopped accounting its padding must never read as a pass);
  the floor itself only gates when configured.
- **pad fraction** — the worst-bucket pad fraction (``goodput.json``)
  growing by more than ``--max-pad-regression`` fails. An ABSOLUTE
  increase bound, not a ratio: a 0.0 baseline (perfectly-filled
  buckets) is a meaningful value and exactly the one worth defending,
  and a ratio against it is undefined. Lost-from-candidate fails.
- **utilization** — the serve path's Little's-law ρ
  (``capacity.json``, see ``obs.capacity``: arrival rate × mean
  service time) exceeding the ``--max-utilization`` ceiling fails —
  a candidate running hotter than the ceiling has no headroom before
  the queue grows without bound, whatever its latency quantiles say.
  Absolute ceiling, off unless configured (training runs carry no
  capacity account); lost-from-candidate fails.

When a gated key is absent from one side, the row's note names WHICH
run lacks it and lists the gated keys that run *does* carry, so a CI
failure is diagnosable from the log alone (is the artifact missing, or
just this account?).

``--calibration <calibration.json>`` (see
:mod:`dgmc_tpu_torch.obs.calibrate`) rescales the RELATIVE thresholds
above to ``z * rel_sigma`` of each metric's fitted run-to-run noise
floor (``--calibration-z``, default 3): the gate fires on a shift three
noise floors deep instead of a hand-picked fraction. Pinned fallbacks:
metrics the calibration file does not cover (or covers with too few
samples) keep their fixed thresholds unchanged, absolute
floors/ceilings (``--min-*``, ``--max-utilization``, compile/restart
counts) are never rescaled, and every lost-account rule applies exactly
as before — calibration adjusts gate WIDTH, never gate existence. Each
rescaled gate is reported as a ``calibrated:`` info row naming the noise
floor it was judged by.

Exit codes: 0 = no regression, 1 = regression, 2 = usage/missing input.
Touches no device.
"""

import argparse
import json
import os
import sys

from dgmc_tpu_torch.obs.report import load_run, summarize

#: Default fractional/absolute thresholds; CLI flags override.
DEFAULT_THRESHOLDS = {
    'step_p50': 0.25,
    'step_p95': 0.40,
    'throughput': 0.25,
    'memory': 0.15,
    'new_compile_events': 5,
    'mfu': 0.25,
    'intensity': 0.40,
    'skew': 0.50,
    'restarts': 0,
    #: Absolute overlap-fraction floor; None = gate off unless asked
    #: (a run whose programs legitimately model 0.0 must not fail by
    #: default).
    'min_overlap': None,
    'static_peak': 0.25,
    #: Absolute measured-overlap floor (obs.attribution); None = gate
    #: off unless asked, same contract as min_overlap.
    'min_measured_overlap': None,
    #: Serve per-stage p95 regression (qtrace_summary.json); None =
    #: gate off unless asked — training runs carry no qtrace account.
    'stage_p95': None,
    #: Relative Hits@1 regression bound (quality.json headline); None =
    #: gate off unless asked. The lost-account rule still applies
    #: unconditionally: a candidate that stopped reporting the quality
    #: account the baseline had fails.
    'hits1': None,
    #: Absolute Hits@1 floor; None = gate off unless asked
    #: (min_overlap semantics — ROADMAP item 2's paper-parity pin).
    'min_hits1': None,
    'idle': 0.25,
    #: Absolute goodput-ratio floor (goodput.json); None = gate off
    #: unless asked, min_overlap semantics (lost account still fails).
    'min_goodput': None,
    #: Allowed ABSOLUTE increase of the worst-bucket pad fraction
    #: (goodput.json); None = gate off unless asked. Absolute, not a
    #: ratio: a zero-pad baseline is the one worth defending.
    'pad_regression': None,
    #: Absolute ceiling on the serve path's Little's-law utilization ρ
    #: (capacity.json); None = gate off unless asked — training runs
    #: carry no capacity account.
    'max_utilization': None,
    #: Logged metrics whose FINAL values must be exactly equal between
    #: the runs (tuple of keys; empty = gate off). The
    #: streamed-vs-offloaded equivalence gate: two layouts of the same
    #: forward must log the same loss/Hits, bit for bit.
    'require_equal': (),
}

#: Keys the gates read from a run summary — listed in missing-metric
#: notes so a failing CI log names what the lacking run DID record.
GATED_KEYS = (
    'step_p50_s', 'step_p95_s', 'steps_per_sec', 'compile_events',
    'peak_memory_bytes', 'mfu', 'arith_intensity', 'overlap_fraction',
    'static_peak_bytes', 'measured_overlap_fraction', 'idle_fraction',
    'hits1', 'goodput_ratio', 'pad_fraction', 'utilization',
)


def _missing_note(side, summary):
    """``'missing from candidate; candidate has: mfu, step_p50_s'`` —
    the diagnosable form of a lost-account failure: which side lacks
    the gated key, and which gated keys that run does carry."""
    have = [k for k in GATED_KEYS if summary.get(k) is not None]
    return (f'missing from {side}; {side} has: '
            + (', '.join(have) if have else 'no gated metrics at all'))


def _rel(a, b):
    """(b - a) / a — the signed fractional change, None if undefined."""
    if a is None or b is None or not a:
        return None
    return (b - a) / a


def _row(metric, a, b, delta, limit, status, note=''):
    return {'metric': metric, 'a': a, 'b': b, 'delta': delta,
            'limit': limit, 'status': status, 'note': note}


def _dispatch_outcomes(summary):
    """{kernel: set(outcomes with count > 0)} from a run summary."""
    out = {}
    for r in summary.get('dispatch', []):
        if r.get('count', 0) > 0 and 'kernel' in r:
            out.setdefault(r['kernel'], set()).add(r.get('outcome'))
    return out


def diff_runs(a, b, thresholds=None, allow_kernel_fallback=False):
    """Compare two run summaries
    (:func:`dgmc_tpu_torch.obs.report.summarize` outputs). Returns
    ``(rows, regressions)`` — all comparison rows, and the subset that
    breached a threshold."""
    thr = dict(DEFAULT_THRESHOLDS, **(thresholds or {}))
    rows = []

    def gate(metric, va, vb, delta, limit, worse, note=''):
        status = 'REGRESSION' if worse else 'ok'
        rows.append(_row(metric, va, vb, delta, limit, status, note))

    # -- step timing ------------------------------------------------------
    # Asymmetric absence handling, matching the dispatch section below: a
    # metric the BASELINE recorded but the candidate lost (broken timer,
    # run died before its first flush) is a regression — a gate that
    # exits 0 because the numbers it gates on vanished is no gate.
    def timing(key, thr_key, worse_when):
        va, vb = a.get(key), b.get(key)
        if va is None:
            rows.append(_row(key, va, vb, None, thr[thr_key], 'skipped',
                             _missing_note('baseline', a)))
            return
        if vb is None:
            rows.append(_row(key, va, vb, None, thr[thr_key], 'REGRESSION',
                             _missing_note('candidate', b)))
            return
        d = _rel(va, vb)
        if d is None:  # zero baseline: no meaningful ratio
            rows.append(_row(key, va, vb, None, thr[thr_key], 'skipped',
                             'zero baseline'))
            return
        gate(key, va, vb, round(d, 4), thr[thr_key], worse_when(d))

    timing('step_p50_s', 'step_p50', lambda d: d > thr['step_p50'])
    timing('step_p95_s', 'step_p95', lambda d: d > thr['step_p95'])
    timing('steps_per_sec', 'throughput',
           lambda d: -d > thr['throughput'])

    # -- hang reports -----------------------------------------------------
    # Checked before everything else conceptually gates: a hung candidate
    # must fail even when every surviving metric looks fine (a hang
    # truncates the run, which usually *improves* the aggregates).
    ha, hb = a.get('hang_report'), b.get('hang_report')
    if hb is not None:
        inf = hb.get('in_flight') or {}
        status = 'note' if ha is not None else 'REGRESSION'
        note = (f'candidate hung ({hb.get("reason")}) in '
                f'{inf.get("phase")}:{inf.get("name")}'
                + ('; baseline hung too' if ha is not None else ''))
        rows.append(_row('hang_report', 'absent' if ha is None else
                         ha.get('reason'), hb.get('reason'), None, None,
                         status, note))
    elif ha is not None:
        rows.append(_row('hang_report', ha.get('reason'), 'absent', None,
                         None, 'ok', 'baseline hung; candidate did not'))

    # -- supervised-run recovery ------------------------------------------
    # A candidate that needed MORE restarts than the baseline (plus the
    # allowed slack) is a newly flaky path even when its final attempt's
    # metrics look fine; a candidate whose supervisor gave up failed
    # outright, whatever the surviving artifacts say. An unsupervised
    # baseline counts as 0 restarts; an unsupervised candidate skips the
    # row (supervision is opt-in — absence is not evidence).
    ra = a.get('recovery') or {}
    rb = b.get('recovery')
    if rb is not None:
        if rb.get('outcome') == 'gave-up':
            rows.append(_row('recovery', ra.get('outcome') or 'absent',
                             'gave-up', None, None, 'REGRESSION',
                             'candidate supervisor exhausted its '
                             'restart budget'))
        base_r = ra.get('restarts', 0)
        cand_r = rb.get('restarts', 0)
        extra = cand_r - base_r
        gate('restarts', base_r, cand_r, extra, thr['restarts'],
             extra > thr['restarts'],
             ('degraded: ' + ','.join(rb['degradations'])
              if rb.get('degradations') else ''))
        # Elastic-event gate: a candidate whose supervisor had to SHRINK
        # THE MESH survived, but on fewer devices than the run asked for
        # — throughput, memory headroom and every scaling claim changed
        # out from under the surviving metrics. More shrinks than the
        # baseline fails (0 for an un-shrunk baseline).
        ea = len(ra.get('elastic') or [])
        eb = len(rb.get('elastic') or [])
        if ea or eb:
            detail = '; '.join(e.get('detail') or '?'
                               for e in (rb.get('elastic') or []))
            gate('elastic_shrinks', ea, eb, eb - ea, 0, eb > ea,
                 detail or 'baseline shrank; candidate did not')
    elif ra:
        rows.append(_row('restarts', ra.get('restarts', 0), None, None,
                         thr['restarts'], 'skipped',
                         'candidate unsupervised'))

    # -- required-equal logged metrics ------------------------------------
    # The layout-equivalence gate (streamed vs offloaded forward): the
    # named metrics' final logged values must match EXACTLY — a layout
    # change is pure scheduling, so any numeric drift is a bug, not
    # noise. Asymmetric on absence like every other gate: a key the
    # baseline logged but the candidate lost fails.
    la, lb = a.get('last_metrics') or {}, b.get('last_metrics') or {}
    for key in thr.get('require_equal') or ():
        va, vb = la.get(key), lb.get(key)
        if va is None and vb is None:
            rows.append(_row(f'equal:{key}', None, None, None, 0,
                             'REGRESSION',
                             'neither run logged the required metric'))
        elif va is None or vb is None:
            rows.append(_row(f'equal:{key}', va, vb, None, 0,
                             'REGRESSION',
                             _missing_note(
                                 'baseline' if va is None else 'candidate',
                                 a if va is None else b)))
        else:
            # Values may be non-numeric (metrics.jsonl carries e.g.
            # 'event' strings): the gate is pure equality; the delta
            # column is numeric-only garnish.
            delta = (abs(va - vb)
                     if va != vb
                     and isinstance(va, (int, float))
                     and isinstance(vb, (int, float))
                     and not isinstance(va, bool)
                     and not isinstance(vb, bool) else None)
            gate(f'equal:{key}', va, vb, delta, 0, va != vb,
                 '' if va == vb else 'required exactly equal')

    # -- MFU --------------------------------------------------------------
    # Asymmetric like the timings: efficiency the baseline accounted for
    # but the candidate lost (cost recording broke, run died first) is a
    # regression, not a skip.
    mfu_a, mfu_b = a.get('mfu'), b.get('mfu')
    if mfu_a is not None and mfu_b is None:
        rows.append(_row('mfu', mfu_a, mfu_b, None, thr['mfu'],
                         'REGRESSION', _missing_note('candidate', b)))
    elif mfu_a is None and mfu_b is not None:
        rows.append(_row('mfu', mfu_a, mfu_b, None, thr['mfu'], 'skipped',
                         _missing_note('baseline', a)))
    elif mfu_a is not None:
        d = _rel(mfu_a, mfu_b)
        if d is None:
            rows.append(_row('mfu', mfu_a, mfu_b, None, thr['mfu'],
                             'skipped', 'zero baseline'))
        else:
            gate('mfu', mfu_a, mfu_b, round(d, 4), thr['mfu'],
                 -d > thr['mfu'])

    # -- achieved arithmetic intensity ------------------------------------
    # Same asymmetry as MFU: an intensity account the baseline had but
    # the candidate lost is a broken gate input, not a skip.
    ai_a, ai_b = a.get('arith_intensity'), b.get('arith_intensity')
    if ai_a is not None and ai_b is None:
        rows.append(_row('arith_intensity', ai_a, ai_b, None,
                         thr['intensity'], 'REGRESSION',
                         _missing_note('candidate', b)))
    elif ai_a is None and ai_b is not None:
        rows.append(_row('arith_intensity', ai_a, ai_b, None,
                         thr['intensity'], 'skipped',
                         _missing_note('baseline', a)))
    elif ai_a is not None:
        d = _rel(ai_a, ai_b)
        if d is None:
            rows.append(_row('arith_intensity', ai_a, ai_b, None,
                             thr['intensity'], 'skipped', 'zero baseline'))
        else:
            gate('arith_intensity', ai_a, ai_b, round(d, 4),
                 thr['intensity'], -d > thr['intensity'])

    # -- modeled collective overlap ---------------------------------------
    # An ABSOLUTE floor, not a ratio gate: 0.0 overlap is a meaningful
    # value (a fully serial program) and fractional change against it is
    # undefined. A candidate that lost the account the baseline had
    # fails like MFU; the floor itself only gates when configured.
    ov_a, ov_b = a.get('overlap_fraction'), b.get('overlap_fraction')
    floor = thr.get('min_overlap')
    if ov_a is not None and ov_b is None:
        rows.append(_row('overlap_fraction', ov_a, ov_b, None, floor,
                         'REGRESSION', _missing_note('candidate', b)))
    elif ov_b is not None and floor is not None:
        gate('overlap_fraction', ov_a, ov_b,
             None if ov_a is None else round(ov_b - ov_a, 4), floor,
             ov_b < floor,
             'chunk loop serialized below the floor'
             if ov_b < floor else '')
    elif ov_a is not None or ov_b is not None:
        rows.append(_row('overlap_fraction', ov_a, ov_b,
                         None if None in (ov_a, ov_b)
                         else round(ov_b - ov_a, 4), floor, 'info',
                         'no --min-overlap floor configured'))

    # -- Hits@1 (quality plane) -------------------------------------------
    # The paper's headline metric, gated both ways:
    # --max-hits1-regression bounds the RELATIVE drop against the
    # baseline; --min-hits1 is an absolute floor (min_overlap
    # semantics). Either way, a candidate that lost the quality account
    # the baseline carried FAILS unconditionally — an eval loop that
    # silently stopped reporting accuracy must read as a regression,
    # never as a pass.
    h_a, h_b = a.get('hits1'), b.get('hits1')
    h_lim = thr.get('hits1')
    h_floor = thr.get('min_hits1')
    if h_a is not None and h_b is None:
        rows.append(_row('hits1', h_a, h_b, None, h_lim, 'REGRESSION',
                         _missing_note('candidate', b)))
    else:
        if h_lim is not None and h_a is None and h_b is not None:
            rows.append(_row('hits1', h_a, h_b, None, h_lim, 'skipped',
                             _missing_note('baseline', a)))
        elif h_lim is not None and h_a is not None and h_b is not None:
            d = _rel(h_a, h_b)
            if d is None:
                rows.append(_row('hits1', h_a, h_b, None, h_lim,
                                 'skipped', 'zero baseline'))
            else:
                gate('hits1', h_a, h_b, round(d, 4), h_lim, -d > h_lim)
        if h_floor is not None and h_b is not None:
            gate('min_hits1', h_a, h_b,
                 None if h_a is None else round(h_b - h_a, 4), h_floor,
                 h_b < h_floor,
                 'Hits@1 under the absolute floor'
                 if h_b < h_floor else '')
        if h_b is not None and h_lim is None and h_floor is None:
            rows.append(_row(
                'hits1', h_a, h_b,
                None if h_a is None else round(h_b - h_a, 4), None,
                'info',
                'no --max-hits1-regression / --min-hits1 configured'))

    # -- measured comm/compute overlap ------------------------------------
    # The profiler-trace counterpart of the modeled floor above, same
    # semantics: absolute floor (0.0 = genuinely serialized hardware),
    # lost-account fails, floor gates only when configured.
    mo_a = a.get('measured_overlap_fraction')
    mo_b = b.get('measured_overlap_fraction')
    mfloor = thr.get('min_measured_overlap')
    if mo_a is not None and mo_b is None:
        rows.append(_row('measured_overlap_fraction', mo_a, mo_b, None,
                         mfloor, 'REGRESSION',
                         _missing_note('candidate', b)))
    elif mo_b is not None and mfloor is not None:
        gate('measured_overlap_fraction', mo_a, mo_b,
             None if mo_a is None else round(mo_b - mo_a, 4), mfloor,
             mo_b < mfloor,
             'hardware ran the chunk loop below the measured floor'
             if mo_b < mfloor else '')
    elif mo_a is not None or mo_b is not None:
        rows.append(_row('measured_overlap_fraction', mo_a, mo_b,
                         None if None in (mo_a, mo_b)
                         else round(mo_b - mo_a, 4), mfloor, 'info',
                         'no --min-measured-overlap floor configured'))

    # -- idle fraction (measured attribution) ------------------------------
    # Source-matched like the memory row: device idle and host idle are
    # different quantities. A zero-idle baseline gates the candidate's
    # ABSOLUTE idle against the threshold (no ratio exists against 0,
    # and a perfectly-fed baseline is the one worth defending).
    id_a, id_b = a.get('idle_fraction'), b.get('idle_fraction')
    isrc_a, isrc_b = a.get('idle_source'), b.get('idle_source')
    if id_a is not None and id_b is None:
        rows.append(_row('idle_fraction', id_a, id_b, None, thr['idle'],
                         'REGRESSION', _missing_note('candidate', b)))
    elif id_a is None and id_b is not None:
        rows.append(_row('idle_fraction', id_a, id_b, None, thr['idle'],
                         'skipped', _missing_note('baseline', a)))
    elif id_a is not None:
        if isrc_a != isrc_b:
            rows.append(_row('idle_fraction', id_a, id_b, None,
                             thr['idle'], 'skipped',
                             f'sources differ ({isrc_a} vs {isrc_b})'))
        else:
            d = _rel(id_a, id_b)
            if d is not None:
                gate('idle_fraction', id_a, id_b, round(d, 4),
                     thr['idle'], d > thr['idle'],
                     f'source={isrc_a}')
            else:
                gate('idle_fraction', id_a, id_b, round(id_b, 4),
                     thr['idle'], id_b > thr['idle'],
                     f'zero-idle baseline: absolute gate, '
                     f'source={isrc_a}')

    # -- static peak-live bytes -------------------------------------------
    # The liveness model's bound needs no matching measurement source
    # (it is computed from the compiled program alone), so unlike the
    # runtime memory row it always compares when both runs carry it.
    pk_a, pk_b = a.get('static_peak_bytes'), b.get('static_peak_bytes')
    if pk_a is not None and pk_b is None:
        rows.append(_row('static_peak_bytes', pk_a, pk_b, None,
                         thr['static_peak'], 'REGRESSION',
                         _missing_note('candidate', b)))
    elif pk_a is None and pk_b is not None:
        rows.append(_row('static_peak_bytes', pk_a, pk_b, None,
                         thr['static_peak'], 'skipped',
                         _missing_note('baseline', a)))
    elif pk_a is not None:
        d = _rel(pk_a, pk_b)
        if d is None:
            rows.append(_row('static_peak_bytes', pk_a, pk_b, None,
                             thr['static_peak'], 'skipped',
                             'zero baseline'))
        else:
            gate('static_peak_bytes', pk_a, pk_b, round(d, 4),
                 thr['static_peak'], d > thr['static_peak'])

    # -- multi-device skew ------------------------------------------------
    sk_a = (a.get('skew') or {}).get('step_time_ratio')
    sk_b = (b.get('skew') or {}).get('step_time_ratio')
    if sk_a is not None and sk_b is not None:
        d = _rel(sk_a, sk_b)
        gate('skew_step_time_ratio', sk_a, sk_b,
             None if d is None else round(d, 4), thr['skew'],
             d is not None and d > thr['skew'])
    elif sk_a is not None or sk_b is not None:
        rows.append(_row('skew_step_time_ratio', sk_a, sk_b, None,
                         thr['skew'], 'skipped',
                         'aggregation missing from one run'))

    # -- compiles ---------------------------------------------------------
    ca, cb = a.get('compile_events', 0), b.get('compile_events', 0)
    extra = cb - ca
    gate('compile_events', ca, cb, extra, thr['new_compile_events'],
         extra > thr['new_compile_events'])

    # -- memory -----------------------------------------------------------
    ma, mb = a.get('peak_memory_bytes'), b.get('peak_memory_bytes')
    src_a, src_b = (a.get('peak_memory_source'), b.get('peak_memory_source'))
    if ma is not None and mb is None:
        rows.append(_row('peak_memory_bytes', ma, mb, None, thr['memory'],
                         'REGRESSION', _missing_note('candidate', b)))
    elif ma is None or mb is None:
        rows.append(_row('peak_memory_bytes', ma, mb, None, thr['memory'],
                         'skipped', _missing_note('baseline', a)))
    elif src_a != src_b:
        rows.append(_row('peak_memory_bytes', ma, mb, None, thr['memory'],
                         'skipped',
                         f'sources differ ({src_a} vs {src_b})'))
    else:
        d = _rel(ma, mb)
        gate('peak_memory_bytes', ma, mb, round(d, 4), thr['memory'],
             d > thr['memory'], f'source={src_a}')

    # -- kernel dispatch --------------------------------------------------
    da, db = _dispatch_outcomes(a), _dispatch_outcomes(b)
    for kernel, outcomes_a in sorted(da.items()):
        if 'kernel' not in outcomes_a:
            continue
        outcomes_b = db.get(kernel, set())
        # Absent counts as lost too: a candidate that never reached the
        # decision site stopped exercising the kernel just as surely as
        # one that ran the plain version.
        lost = 'kernel' not in outcomes_b
        status = ('note' if allow_kernel_fallback else 'REGRESSION') \
            if lost else 'ok'
        note = '' if not lost else (
            'kernel ran its plain version' if outcomes_b
            else 'kernel decision absent from candidate')
        rows.append(_row(f'dispatch[{kernel}]', 'kernel',
                         ','.join(sorted(x for x in outcomes_b if x))
                         or 'absent',
                         None, None, status, note))

    # -- serve per-stage latency (qtrace) ---------------------------------
    # Gate only when configured (like min_overlap): training runs have
    # no qtrace summary, and a default-on gate would spuriously skip or
    # fail every non-serving diff. When on, the lost-account rule
    # applies: a serving candidate that stopped producing the per-stage
    # account the baseline had fails — the attribution layer is itself
    # a gated artifact.
    sthr = thr.get('stage_p95')
    if sthr is not None:
        qa = a.get('qtrace_stages') or {}
        qb = b.get('qtrace_stages') or {}
        if not qa:
            rows.append(_row('qtrace_stages', None, len(qb) or None,
                             None, sthr, 'skipped',
                             'baseline has no qtrace stage account'))
        elif not qb:
            rows.append(_row('qtrace_stages', len(qa), None, None, sthr,
                             'REGRESSION',
                             'candidate lost the qtrace stage account '
                             'the baseline had'))
        else:
            for stage in sorted(qa):
                pa95 = (qa[stage] or {}).get('p95_ms')
                sb = qb.get(stage) or {}
                pb95 = sb.get('p95_ms')
                key = f'qtrace[{stage}].p95_ms'
                if pa95 is None:
                    continue
                if pb95 is None:
                    rows.append(_row(key, pa95, None, None, sthr,
                                     'REGRESSION',
                                     'stage account missing from '
                                     'candidate'))
                    continue
                d = _rel(pa95, pb95)
                if d is None:
                    rows.append(_row(key, pa95, pb95, None, sthr,
                                     'skipped', 'zero baseline'))
                    continue
                gate(key, pa95, pb95, round(d, 4), sthr, d > sthr)

    # -- goodput ratio (padding-waste account) ----------------------------
    # min_overlap semantics: absolute floor (0.0 goodput — every FLOP
    # spent on padding — is a meaningful value, and a ratio against it
    # is not), lost-account fails unconditionally, the floor only
    # gates when configured.
    gp_a, gp_b = a.get('goodput_ratio'), b.get('goodput_ratio')
    gfloor = thr.get('min_goodput')
    if gp_a is not None and gp_b is None:
        rows.append(_row('goodput_ratio', gp_a, gp_b, None, gfloor,
                         'REGRESSION', _missing_note('candidate', b)))
    elif gp_b is not None and gfloor is not None:
        gate('goodput_ratio', gp_a, gp_b,
             None if gp_a is None else round(gp_b - gp_a, 4), gfloor,
             gp_b < gfloor,
             'padding waste pushed useful FLOPs below the floor'
             if gp_b < gfloor else '')
    elif gp_a is not None or gp_b is not None:
        rows.append(_row('goodput_ratio', gp_a, gp_b,
                         None if None in (gp_a, gp_b)
                         else round(gp_b - gp_a, 4), gfloor, 'info',
                         'no --min-goodput floor configured'))

    # -- pad fraction (worst bucket) --------------------------------------
    # An ABSOLUTE increase bound: the gate fires on pad_b - pad_a >
    # threshold. Not a ratio — a 0.0 baseline (perfectly-filled
    # buckets) is exactly the baseline worth defending, and fractional
    # change against it is undefined.
    pf_a, pf_b = a.get('pad_fraction'), b.get('pad_fraction')
    plim = thr.get('pad_regression')
    if pf_a is not None and pf_b is None:
        rows.append(_row('pad_fraction', pf_a, pf_b, None, plim,
                         'REGRESSION', _missing_note('candidate', b)))
    elif plim is not None and pf_a is None and pf_b is not None:
        rows.append(_row('pad_fraction', pf_a, pf_b, None, plim,
                         'skipped', _missing_note('baseline', a)))
    elif plim is not None and pf_a is not None and pf_b is not None:
        d = round(pf_b - pf_a, 4)
        gate('pad_fraction', pf_a, pf_b, d, plim, d > plim,
             'worst-bucket padding grew past the allowed increase'
             if d > plim else '')
    elif pf_a is not None or pf_b is not None:
        rows.append(_row('pad_fraction', pf_a, pf_b,
                         None if None in (pf_a, pf_b)
                         else round(pf_b - pf_a, 4), plim, 'info',
                         'no --max-pad-regression bound configured'))

    # -- serve utilization (capacity model) -------------------------------
    # Absolute ceiling on the candidate's Little's-law ρ: a serve run
    # hotter than the ceiling has no headroom before the queue grows
    # without bound, whatever its latency quantiles say. Off unless
    # configured (training runs carry no capacity account);
    # lost-from-candidate fails.
    ut_a, ut_b = a.get('utilization'), b.get('utilization')
    uceil = thr.get('max_utilization')
    if ut_a is not None and ut_b is None:
        rows.append(_row('utilization', ut_a, ut_b, None, uceil,
                         'REGRESSION', _missing_note('candidate', b)))
    elif ut_b is not None and uceil is not None:
        gate('utilization', ut_a, ut_b,
             None if ut_a is None else round(ut_b - ut_a, 4), uceil,
             ut_b > uceil,
             'serve path over the utilization ceiling (no headroom)'
             if ut_b > uceil else '')
    elif ut_a is not None or ut_b is not None:
        rows.append(_row('utilization', ut_a, ut_b,
                         None if None in (ut_a, ut_b)
                         else round(ut_b - ut_a, 4), uceil, 'info',
                         'no --max-utilization ceiling configured'))

    # -- probes -----------------------------------------------------------
    fn = b.get('first_nonfinite')
    if fn:
        rows.append(_row('first_nonfinite', a.get('first_nonfinite'), fn,
                         None, None, 'REGRESSION',
                         f'candidate went non-finite at step '
                         f'{fn.get("step")} stage {fn.get("stage")!r}'))
    pa, pb = a.get('probes') or {}, b.get('probes') or {}
    for name in sorted(set(pa) | set(pb)):
        if name == 'nonfinite':
            continue
        mean_a = (pa.get(name) or {}).get('mean')
        mean_b = (pb.get(name) or {}).get('mean')
        rows.append(_row(f'probe[{name}].mean', mean_a, mean_b,
                         _rel(mean_a, mean_b), None, 'info',
                         'informational drift'))

    regressions = [r for r in rows if r['status'] == 'REGRESSION']
    return rows, regressions


def _fmt(v):
    if v is None:
        return '-'
    if isinstance(v, float):
        return f'{v:.6g}'
    return str(v)


def render_diff(a_path, b_path, rows, regressions):
    lines = [f'== run diff: {a_path} (baseline) vs {b_path} (candidate) ==',
             f'  {"metric":<28} {"baseline":>12} {"candidate":>12} '
             f'{"delta":>9} {"limit":>7}  status']
    for r in rows:
        delta = f'{r["delta"]:+.1%}' if isinstance(r['delta'], float) \
            else _fmt(r['delta'])
        limit = _fmt(r['limit'])
        note = f'  ({r["note"]})' if r['note'] else ''
        lines.append(f'  {r["metric"]:<28} {_fmt(r["a"]):>12} '
                     f'{_fmt(r["b"]):>12} {delta:>9} {limit:>7}  '
                     f'{r["status"]}{note}')
    lines.append(f'  => {len(regressions)} regression(s)')
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.diff',
        description='Compare two --obs-dir runs; exit nonzero on '
                    'threshold regression (the CI perf gate).')
    parser.add_argument('baseline', help='obs dir of the baseline run')
    parser.add_argument('candidate', help='obs dir of the candidate run')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable diff object')
    parser.add_argument('--max-step-p50-regression', type=float,
                        default=DEFAULT_THRESHOLDS['step_p50'],
                        metavar='FRAC',
                        help='allowed fractional p50 step-time increase '
                             '(default %(default)s)')
    parser.add_argument('--max-step-p95-regression', type=float,
                        default=DEFAULT_THRESHOLDS['step_p95'],
                        metavar='FRAC',
                        help='allowed fractional p95 step-time increase '
                             '(default %(default)s)')
    parser.add_argument('--max-throughput-regression', type=float,
                        default=DEFAULT_THRESHOLDS['throughput'],
                        metavar='FRAC',
                        help='allowed fractional steps/sec decrease '
                             '(default %(default)s)')
    parser.add_argument('--max-memory-regression', type=float,
                        default=DEFAULT_THRESHOLDS['memory'],
                        metavar='FRAC',
                        help='allowed fractional peak-memory increase '
                             '(default %(default)s)')
    parser.add_argument('--max-new-compile-events', type=int,
                        default=DEFAULT_THRESHOLDS['new_compile_events'],
                        metavar='N',
                        help='allowed extra compile events in the '
                             'candidate (default %(default)s)')
    parser.add_argument('--max-mfu-regression', type=float,
                        default=DEFAULT_THRESHOLDS['mfu'],
                        metavar='FRAC',
                        help='allowed fractional headline-MFU decrease '
                             '(efficiency.json; default %(default)s)')
    parser.add_argument('--max-intensity-regression', type=float,
                        default=DEFAULT_THRESHOLDS['intensity'],
                        metavar='FRAC',
                        help='allowed fractional decrease of the headline '
                             'achieved arithmetic intensity (FLOPs/byte, '
                             'efficiency.json; default %(default)s)')
    parser.add_argument('--min-overlap', type=float, default=None,
                        metavar='FRAC',
                        help='absolute floor on the headline modeled '
                             'collective overlap fraction '
                             '(efficiency.json, a schedule model; none '
                             'on the port\'s runs); '
                             'a candidate below it serialized the chunk '
                             'loop (default: floor off; a lost overlap '
                             'account still fails)')
    parser.add_argument('--min-measured-overlap', type=float,
                        default=None, metavar='FRAC',
                        help='absolute floor on the MEASURED '
                             'comm/compute overlap fraction '
                             '(efficiency.json, from the profiler-'
                             'trace attribution obs.attribution); '
                             'same lost-account semantics as '
                             '--min-overlap (default: floor off)')
    parser.add_argument('--max-idle-regression', type=float,
                        default=DEFAULT_THRESHOLDS['idle'],
                        metavar='FRAC',
                        help='allowed fractional increase of the '
                             'measured idle fraction (efficiency.json, '
                             'obs.attribution; device idle when the '
                             'capture has device tracks, host idle '
                             'otherwise — sources must match to '
                             'compare; default %(default)s)')
    parser.add_argument('--max-peak-regression', type=float,
                        default=DEFAULT_THRESHOLDS['static_peak'],
                        metavar='FRAC',
                        help='allowed fractional increase of the static '
                             'peak-live-bytes bound (efficiency.json, a '
                             'liveness model; none on the port\'s runs; '
                             'default %(default)s)')
    parser.add_argument('--max-skew-regression', type=float,
                        default=DEFAULT_THRESHOLDS['skew'],
                        metavar='FRAC',
                        help='allowed fractional increase of the device '
                             'step-time skew ratio (aggregate.json; '
                             'default %(default)s)')
    parser.add_argument('--max-restarts-regression', type=int,
                        default=DEFAULT_THRESHOLDS['restarts'],
                        metavar='N',
                        help='allowed extra supervisor restarts in the '
                             'candidate over the baseline '
                             '(recovery.json; a candidate whose '
                             'supervisor gave up fails unconditionally; '
                             'default %(default)s)')
    parser.add_argument('--max-stage-p95-regression', type=float,
                        default=DEFAULT_THRESHOLDS['stage_p95'],
                        metavar='FRAC',
                        help='allowed fractional increase of each serve '
                             'stage\'s p95 latency '
                             '(qtrace_summary.json; off unless set — '
                             'training runs carry no qtrace account; a '
                             'serving candidate that lost a stage '
                             'account the baseline had fails)')
    parser.add_argument('--max-hits1-regression', type=float,
                        default=DEFAULT_THRESHOLDS['hits1'],
                        metavar='FRAC',
                        help='allowed fractional Hits@1 decrease '
                             '(quality.json headline; off unless set — '
                             'a candidate that lost the quality account '
                             'the baseline had fails unconditionally)')
    parser.add_argument('--min-hits1', type=float,
                        default=DEFAULT_THRESHOLDS['min_hits1'],
                        metavar='FRAC',
                        help='absolute Hits@1 floor (quality.json '
                             'headline; the paper-parity pin — same '
                             'lost-account semantics as --min-overlap; '
                             'default: floor off)')
    parser.add_argument('--min-goodput', type=float,
                        default=DEFAULT_THRESHOLDS['min_goodput'],
                        metavar='FRAC',
                        help='absolute floor on the goodput ratio '
                             '(useful/executed FLOPs, goodput.json; '
                             'same lost-account semantics as '
                             '--min-overlap; default: floor off)')
    parser.add_argument('--max-pad-regression', type=float,
                        default=DEFAULT_THRESHOLDS['pad_regression'],
                        metavar='FRAC',
                        help='allowed ABSOLUTE increase of the worst-'
                             'bucket pad fraction (goodput.json; '
                             'absolute, not a ratio — a zero-pad '
                             'baseline gates directly; off unless set; '
                             'a candidate that lost the account the '
                             'baseline had fails unconditionally)')
    parser.add_argument('--max-utilization', type=float,
                        default=DEFAULT_THRESHOLDS['max_utilization'],
                        metavar='RHO',
                        help='absolute ceiling on the serve path\'s '
                             'Little\'s-law utilization (capacity.json; '
                             'off unless set — training runs carry no '
                             'capacity account; lost-from-candidate '
                             'fails)')
    parser.add_argument('--require-equal', type=str, default=None,
                        metavar='KEY[,KEY...]',
                        help='comma-separated logged-metric keys whose '
                             'FINAL values must be exactly equal in '
                             'both runs (the streamed-vs-offloaded '
                             'layout-equivalence gate: e.g. '
                             '--require-equal loss,hits1); a key '
                             'either run failed to log fails')
    parser.add_argument('--calibration', type=str, default=None,
                        metavar='FILE',
                        help='calibration.json '
                             '(dgmc_tpu_torch.obs.calibrate): '
                             'rescale the relative regression thresholds '
                             'to z * rel_sigma of each metric\'s fitted '
                             'noise floor; uncalibrated metrics keep '
                             'their fixed thresholds, absolute floors '
                             'and lost-account rules are untouched')
    parser.add_argument('--calibration-z', type=float, default=3.0,
                        metavar='Z',
                        help='significance multiple for calibrated gates '
                             '(default %(default)s noise floors)')
    parser.add_argument('--allow-kernel-fallback', action='store_true',
                        help='downgrade kernel->plain dispatch changes '
                             'from regression to note')
    args = parser.parse_args(argv)

    for p in (args.baseline, args.candidate):
        if not os.path.isdir(p):
            print(f'diff: no such obs dir: {p}', file=sys.stderr)
            return 2

    a = summarize(load_run(args.baseline))
    b = summarize(load_run(args.candidate))
    if not a.get('metrics_records') and not a.get('steps'):
        print(f'diff: {args.baseline} holds no telemetry', file=sys.stderr)
        return 2
    if not b.get('metrics_records') and not b.get('steps'):
        print(f'diff: {args.candidate} holds no telemetry', file=sys.stderr)
        return 2

    thresholds = {
            'step_p50': args.max_step_p50_regression,
            'step_p95': args.max_step_p95_regression,
            'throughput': args.max_throughput_regression,
            'memory': args.max_memory_regression,
            'new_compile_events': args.max_new_compile_events,
            'mfu': args.max_mfu_regression,
            'intensity': args.max_intensity_regression,
            'skew': args.max_skew_regression,
            'restarts': args.max_restarts_regression,
            'min_overlap': args.min_overlap,
            'static_peak': args.max_peak_regression,
            'min_measured_overlap': args.min_measured_overlap,
            'stage_p95': args.max_stage_p95_regression,
            'hits1': args.max_hits1_regression,
            'min_hits1': args.min_hits1,
            'idle': args.max_idle_regression,
            'min_goodput': args.min_goodput,
            'pad_regression': args.max_pad_regression,
            'max_utilization': args.max_utilization,
            'require_equal': tuple(
                k.strip() for k in (args.require_equal or '').split(',')
                if k.strip()),
        }

    calibration_notes = []
    if args.calibration:
        from dgmc_tpu_torch.obs.calibrate import (apply_calibration,
                                                  load_calibration)
        try:
            cal = load_calibration(args.calibration)
        except ValueError as e:
            print(f'diff: {e}', file=sys.stderr)
            return 2
        thresholds, calibration_notes = apply_calibration(
            thresholds, cal, z=args.calibration_z)

    rows, regressions = diff_runs(
        a, b, thresholds=thresholds,
        allow_kernel_fallback=args.allow_kernel_fallback)
    for n in calibration_notes:
        # One info row per rescaled gate: a calibrated verdict must
        # say what it was judged by, in the same table it judged.
        rows.append(_row(
            f'calibrated:{n["gate"]}', n['fixed'],
            round(n['calibrated'], 4), None, round(n['calibrated'], 4),
            'info',
            f'{n["metric"]}: z={n["z"]:g} x rel_sigma='
            f'{n["rel_sigma"]:.4f} over n={n["n"]} samples'))

    if args.json:
        print(json.dumps({'baseline': args.baseline,
                          'candidate': args.candidate,
                          'rows': rows,
                          'calibration': calibration_notes or None,
                          'regressions': len(regressions),
                          'ok': not regressions}, indent=1))
    else:
        print(render_diff(args.baseline, args.candidate, rows, regressions))
    return 1 if regressions else 0


if __name__ == '__main__':
    sys.exit(main())
