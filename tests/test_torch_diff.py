"""The port's cross-run diff (``obs/diff.py``), on the CPU.

The cases of the JAX package's ``tests/obs/test_diff.py`` and the diff
cases of ``tests/resilience/test_obs_recovery.py``, run against the
port's module with the port's dispatch outcomes in the fixtures
(``kernel`` where JAX's read ``pallas``, ``plain`` where they read
``fallback``). Then parity: on one set of run dirs, JAX's ``main`` and
the port's give the same table, JSON and exit code, the dispatch words
mapped. Then real port artifacts: a tiny observed ``pascal_pf`` run
(profiled, its attribution merged) diffed against itself and against
the same run with its kernels launched, and ``recovery.json`` files
written by the port's supervisor.
"""

import contextlib
import copy
import io
import json
import os
import re
import shutil

import pytest
import torch

from dgmc_tpu_torch.obs import diff as diff_mod
from dgmc_tpu_torch.obs.diff import diff_runs
from dgmc_tpu_torch.obs.report import load_run, render, summarize
from tests.obs.test_diff import (AI_EFF, BASE_MEMORY, BASE_TIMINGS, EFF,
                                 SCHED_EFF, _eff_measured, _write_metrics,
                                 _write_plane, _write_qtrace)
from tests.resilience.test_obs_recovery import (_write_attempt,
                                                _write_recovery)
from tests.torch_jax_worker import jax_worker

#: JAX's fixtures but the dispatch table, which is in the port's words.
BASE_DISPATCH = {'counts': [
    {'kernel': 'topk', 'outcome': 'kernel', 'reason': 'cuda',
     'count': 1}]}
#: The JAX package's dispatch outcomes for the port's, and its note for a
#: kernel that ran its plain version.
JAX_WORDS = {'kernel': 'pallas', 'plain': 'fallback'}
JAX_NOTE = ('kernel fell back to XLA', 'kernel ran its plain version')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_run(root, name, timings=None, memory=None, dispatch=None,
              efficiency=None, hang=None, aggregate=None):
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, 'timings.json'), 'w') as f:
        json.dump(timings or BASE_TIMINGS, f)
    with open(os.path.join(d, 'memory.json'), 'w') as f:
        json.dump(memory or BASE_MEMORY, f)
    with open(os.path.join(d, 'dispatch.json'), 'w') as f:
        json.dump(dispatch or BASE_DISPATCH, f)
    with open(os.path.join(d, 'metrics.jsonl'), 'w') as f:
        f.write(json.dumps({'step': 1, 'loss': 1.0}) + '\n')
    for fname, payload in (('efficiency.json', efficiency),
                           ('hang_report.json', hang),
                           ('aggregate.json', aggregate)):
        if payload is not None:
            with open(os.path.join(d, fname), 'w') as f:
                json.dump(payload, f)
    return d


def test_equal_runs_exit_zero(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    assert diff_mod.main([a, b]) == 0
    out = capsys.readouterr().out
    assert '0 regression(s)' in out


def test_step_time_regression_exits_nonzero(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    slow = copy.deepcopy(BASE_TIMINGS)
    for k in ('mean_s', 'p50_s', 'p95_s', 'max_s'):
        slow['steps'][k] *= 2
    b = write_run(tmp_path, 'b', timings=slow)
    assert diff_mod.main([a, b]) == 1
    assert 'REGRESSION' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-step-p50-regression', '1.5',
                          '--max-step-p95-regression', '1.5',
                          '--max-throughput-regression', '0.9']) == 0


def test_compile_churn_regression(tmp_path):
    a = write_run(tmp_path, 'a')
    churny = copy.deepcopy(BASE_TIMINGS)
    churny['compile']['events'] = 30
    b = write_run(tmp_path, 'b', timings=churny)
    assert diff_mod.main([a, b]) == 1
    assert diff_mod.main([a, b, '--max-new-compile-events', '50']) == 0


def test_memory_regression_and_source_mismatch(tmp_path):
    a = write_run(tmp_path, 'a')
    big = {'snapshots': [
        {'tag': 'end', 'devices': [{'id': 0,
                                    'peak_bytes_in_use': 2 << 30}],
         'host': {}}]}
    b = write_run(tmp_path, 'b', memory=big)
    assert diff_mod.main([a, b]) == 1
    # The card's allocator peak and a CPU run's RSS do not compare.
    host_only = {'snapshots': [
        {'tag': 'end', 'devices': [],
         'host': {'peak_rss_bytes': 3 << 30}}]}
    c = write_run(tmp_path, 'c', memory=host_only)
    assert diff_mod.main([a, c]) == 0


def test_kernel_fallback_regression(tmp_path, capsys):
    """A kernel that launched in the baseline and ran only its plain
    version in the candidate fails, or is a note when allowed."""
    a = write_run(tmp_path, 'a')
    fb = {'counts': [{'kernel': 'topk', 'outcome': 'plain',
                      'reason': 'device=cpu', 'count': 1}]}
    b = write_run(tmp_path, 'b', dispatch=fb)
    assert diff_mod.main([a, b]) == 1
    out = capsys.readouterr().out
    assert 'kernel ran its plain version' in out
    assert re.search(r'dispatch\[topk\] +kernel +plain .*REGRESSION', out)
    assert diff_mod.main([a, b, '--allow-kernel-fallback']) == 0
    assert re.search(r'dispatch\[topk\] .* note',
                     capsys.readouterr().out)
    # JAX's outcome word is not the port's: a baseline that recorded
    # 'pallas' has no kernel to lose.
    jax_words = {'counts': [{'kernel': 'topk', 'outcome': 'pallas',
                             'reason': 'auto-tpu', 'count': 1}]}
    c = write_run(tmp_path, 'c', dispatch=jax_words)
    assert diff_mod.main([c, b]) == 0


def test_candidate_missing_step_metrics_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    timerless = copy.deepcopy(BASE_TIMINGS)
    timerless['steps'] = {}
    b = write_run(tmp_path, 'b', timings=timerless)
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, b]) == 0


def test_kernel_absent_from_candidate_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b', dispatch={'counts': []})
    assert diff_mod.main([a, b]) == 1
    out = capsys.readouterr().out
    assert 'absent' in out and 'kernel decision absent' in out
    assert diff_mod.main([a, b, '--allow-kernel-fallback']) == 0


def test_nonfinite_candidate_fails(tmp_path):
    a = write_run(tmp_path, 'a')
    poisoned = copy.deepcopy(BASE_TIMINGS)
    poisoned['first_nonfinite'] = {'step': 7, 'stage': 'psi1'}
    b = write_run(tmp_path, 'b', timings=poisoned)
    assert diff_mod.main([a, b]) == 1


def test_json_output(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    assert diff_mod.main([a, b, '--json']) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload['ok'] and payload['regressions'] == 0
    metrics = {r['metric'] for r in payload['rows']}
    assert {'step_p50_s', 'step_p95_s', 'steps_per_sec', 'compile_events',
            'peak_memory_bytes', 'probe[corr_entropy].mean',
            'dispatch[topk]'} <= metrics


def test_missing_dir_is_usage_error(tmp_path):
    a = write_run(tmp_path, 'a')
    assert diff_mod.main([a, str(tmp_path / 'nope')]) == 2


def test_empty_dir_is_usage_error(tmp_path):
    a = write_run(tmp_path, 'a')
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert diff_mod.main([a, str(empty)]) == 2


def test_hung_candidate_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b',
                  hang={'reason': 'deadline', 'stalled_for_s': 120.0,
                        'in_flight': {'phase': 'step', 'name': 7}})
    assert diff_mod.main([a, b]) == 1
    out = capsys.readouterr().out
    assert 'hang_report' in out and 'candidate hung' in out
    assert diff_mod.main([b, a]) == 0
    assert diff_mod.main([b, b]) == 0
    assert 'baseline hung too' in capsys.readouterr().out


def test_mfu_regression_gates(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=EFF)
    b = write_run(tmp_path, 'b', efficiency=dict(EFF, mfu=0.3))
    assert diff_mod.main([a, b]) == 1
    assert 'mfu' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-mfu-regression', '0.5']) == 0
    assert diff_mod.main([b, a]) == 0


def test_mfu_missing_from_candidate_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=EFF)
    b = write_run(tmp_path, 'b')
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a]) == 0


def test_intensity_regression_gates(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=AI_EFF)
    slid = dict(AI_EFF)
    slid['programs'] = {'train_step': dict(AI_EFF['programs']['train_step'],
                                           arith_intensity=4.0)}
    b = write_run(tmp_path, 'b', efficiency=slid)
    assert diff_mod.main([a, b]) == 1
    assert 'arith_intensity' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-intensity-regression', '0.7']) == 0
    assert diff_mod.main([b, a]) == 0


def test_intensity_missing_from_candidate_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=AI_EFF)
    no_ai = dict(AI_EFF)
    no_ai['programs'] = {'train_step': {'flops': 1e9, 'mfu': 0.5}}
    b = write_run(tmp_path, 'b', efficiency=no_ai)
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a]) == 0


def test_skew_regression_gates(tmp_path, capsys):
    a = write_run(tmp_path, 'a', aggregate={'skew': {'step_time_ratio': 1.1}})
    b = write_run(tmp_path, 'b', aggregate={'skew': {'step_time_ratio': 2.2}})
    assert diff_mod.main([a, b]) == 1
    assert 'skew_step_time_ratio' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-skew-regression', '1.5']) == 0
    c = write_run(tmp_path, 'c')
    assert diff_mod.main([a, c]) == 0


@pytest.mark.parametrize('probe_fallback', [True, False])
def test_probe_aggregates_from_metrics_fallback(tmp_path, probe_fallback):
    t = copy.deepcopy(BASE_TIMINGS)
    if probe_fallback:
        del t['probes']
    d = write_run(tmp_path, 'x', timings=t)
    if probe_fallback:
        with open(os.path.join(d, 'metrics.jsonl'), 'a') as f:
            f.write(json.dumps({'step': 1, 'probe': 'corr_entropy',
                                'value': 3.0}) + '\n')
    assert 'corr_entropy' in summarize(load_run(d))['probes']


def _sched(**fields):
    eff = dict(SCHED_EFF)
    eff['programs'] = {'train_step': dict(
        SCHED_EFF['programs']['train_step'], **fields)}
    return eff


def test_min_overlap_floor_gates(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=SCHED_EFF)
    b = write_run(tmp_path, 'b', efficiency=_sched(overlap_fraction=0.05))
    assert diff_mod.main([a, b]) == 0
    assert diff_mod.main([a, b, '--min-overlap', '0.2']) == 1
    assert 'serialized below the floor' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--min-overlap', '0.01']) == 0
    assert diff_mod.main([b, a, '--min-overlap', '0.2']) == 0


def test_overlap_missing_from_candidate_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=SCHED_EFF)
    lost = dict(SCHED_EFF)
    lost['programs'] = {'train_step': {'flops': 1e9, 'mfu': 0.5}}
    b = write_run(tmp_path, 'b', efficiency=lost)
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a]) == 0


def test_static_peak_regression_gates(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=SCHED_EFF)
    b = write_run(tmp_path, 'b', efficiency=_sched(static_peak_bytes=2 << 20))
    assert diff_mod.main([a, b]) == 1
    assert 'static_peak_bytes' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-peak-regression', '1.5']) == 0
    assert diff_mod.main([b, a]) == 0


def test_measured_overlap_floor(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=_eff_measured(overlap=0.5))
    b = write_run(tmp_path, 'b', efficiency=_eff_measured(overlap=0.1))
    assert diff_mod.main([a, b]) == 0
    assert diff_mod.main([a, b, '--min-measured-overlap', '0.3']) == 1
    assert 'below the measured floor' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--min-measured-overlap', '0.05']) == 0
    assert diff_mod.main([a, b, '--min-measured-overlap', '0.0']) == 0


def test_measured_overlap_lost_account_fails(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=_eff_measured(overlap=0.5))
    b = write_run(tmp_path, 'b', efficiency=_eff_measured())
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a]) == 0


def test_idle_regression_gate(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=_eff_measured(idle=0.1))
    worse = write_run(tmp_path, 'b', efficiency=_eff_measured(idle=0.2))
    assert diff_mod.main([a, worse]) == 1
    assert 'source=device' in capsys.readouterr().out
    assert diff_mod.main([a, worse, '--max-idle-regression', '1.5']) == 0
    lost = write_run(tmp_path, 'c', efficiency=_eff_measured())
    assert diff_mod.main([a, lost]) == 1
    out = capsys.readouterr().out
    assert 'missing from candidate; candidate has:' in out
    assert 'mfu' in out


def test_idle_sources_do_not_compare(tmp_path, capsys):
    a = write_run(tmp_path, 'a',
                  efficiency=_eff_measured(idle=0.0,
                                           idle_source='host-trace'))
    b = write_run(tmp_path, 'b', efficiency=_eff_measured(idle=0.9))
    assert diff_mod.main([a, b]) == 0
    assert 'sources differ' in capsys.readouterr().out


def test_idle_zero_baseline_gates_absolute(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=_eff_measured(idle=0.0))
    b = write_run(tmp_path, 'b', efficiency=_eff_measured(idle=0.5))
    assert diff_mod.main([a, b]) == 1
    assert 'zero-idle baseline' in capsys.readouterr().out
    ok = write_run(tmp_path, 'c', efficiency=_eff_measured(idle=0.2))
    assert diff_mod.main([a, ok]) == 0


def test_missing_note_lists_available_keys(tmp_path, capsys):
    a = write_run(tmp_path, 'a', efficiency=_eff_measured(overlap=0.5))
    timerless = copy.deepcopy(BASE_TIMINGS)
    timerless['steps'] = {}
    b = write_run(tmp_path, 'b', timings=timerless)
    assert diff_mod.main([a, b]) == 1
    out = capsys.readouterr().out
    assert 'missing from candidate; candidate has:' in out
    assert 'compile_events' in out and 'peak_memory_bytes' in out


def test_require_equal_passes_on_exact_match(tmp_path):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    final = {'step': 4, 'loss': 1.25, 'hits1': 0.5, 'hits10': 0.75}
    _write_metrics(a, final)
    _write_metrics(b, dict(final, offload_equal=1.0))
    assert diff_mod.main([a, b, '--require-equal',
                          'loss,hits1,hits10']) == 0


def test_require_equal_fails_on_any_drift(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_metrics(a, {'step': 4, 'loss': 1.25, 'hits1': 0.5})
    _write_metrics(b, {'step': 4, 'loss': 1.2500001, 'hits1': 0.5})
    assert diff_mod.main([a, b, '--require-equal', 'loss,hits1']) == 1
    assert 'equal:loss' in capsys.readouterr().out


def test_require_equal_missing_key_fails_either_side(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_metrics(a, {'step': 4, 'loss': 1.25, 'hits1': 0.5})
    _write_metrics(b, {'step': 4, 'loss': 1.25})
    assert diff_mod.main([a, b, '--require-equal', 'loss,hits1']) == 1
    assert 'equal:hits1' in capsys.readouterr().out


def test_stage_p95_gate_off_by_default(tmp_path):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_qtrace(a, {'device_execute': (10.0, 20.0)})
    _write_qtrace(b, {'device_execute': (10.0, 200.0)})
    assert diff_mod.main([a, b]) == 0


def test_stage_p95_gate_fires_when_configured(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_qtrace(a, {'device_execute': (10.0, 20.0),
                      'serialize': (0.1, 0.2)})
    _write_qtrace(b, {'device_execute': (10.0, 31.0),
                      'serialize': (0.1, 0.2)})
    assert diff_mod.main([a, b,
                          '--max-stage-p95-regression', '0.5']) == 1
    assert 'qtrace[device_execute].p95_ms' in capsys.readouterr().out
    assert diff_mod.main([a, b,
                          '--max-stage-p95-regression', '0.6']) == 0


def test_stage_p95_lost_account_is_regression(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_qtrace(a, {'device_execute': (10.0, 20.0)})
    assert diff_mod.main([a, b,
                          '--max-stage-p95-regression', '0.5']) == 1
    assert 'lost the qtrace stage account' in capsys.readouterr().out
    _write_qtrace(b, {'serialize': (0.1, 0.2)})
    assert diff_mod.main([a, b,
                          '--max-stage-p95-regression', '0.5']) == 1
    c = write_run(tmp_path, 'c')
    d = write_run(tmp_path, 'd')
    _write_qtrace(d, {'device_execute': (10.0, 20.0)})
    assert diff_mod.main([c, d,
                          '--max-stage-p95-regression', '0.5']) == 0


def test_goodput_floor_gate(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, goodput={'goodput_ratio': 0.9})
    _write_plane(b, goodput={'goodput_ratio': 0.6})
    assert diff_mod.main([a, b]) == 0
    assert 'no --min-goodput floor configured' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--min-goodput', '0.8']) == 1
    assert 'below the floor' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--min-goodput', '0.5']) == 0


def test_goodput_lost_account_fails(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, goodput={'goodput_ratio': 0.9})
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a, '--min-goodput', '0.5']) == 0
    assert diff_mod.main([b, a, '--min-goodput', '0.95']) == 1


def test_pad_fraction_absolute_increase_gate(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, goodput={'goodput_ratio': 0.9, 'pad_fraction_max': 0.1})
    _write_plane(b, goodput={'goodput_ratio': 0.9,
                             'pad_fraction_max': 0.35})
    assert diff_mod.main([a, b]) == 0
    assert diff_mod.main([a, b, '--max-pad-regression', '0.2']) == 1
    assert 'padding grew past the allowed increase' \
        in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-pad-regression', '0.3']) == 0


def test_pad_fraction_zero_baseline_gates_directly(tmp_path):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, goodput={'goodput_ratio': 1.0, 'pad_fraction_max': 0.0})
    _write_plane(b, goodput={'goodput_ratio': 0.95,
                             'pad_fraction_max': 0.05})
    assert diff_mod.main([a, b, '--max-pad-regression', '0.01']) == 1
    assert diff_mod.main([a, b, '--max-pad-regression', '0.1']) == 0


def test_pad_fraction_lost_and_baseline_missing(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, goodput={'goodput_ratio': 0.9, 'pad_fraction_max': 0.1})
    _write_plane(b, goodput={'goodput_ratio': 0.9})
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a, '--max-pad-regression', '0.05']) == 0
    assert 'skipped' in capsys.readouterr().out


def test_utilization_ceiling_gate(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, cap={'utilization': 0.5})
    _write_plane(b, cap={'utilization': 0.95})
    assert diff_mod.main([a, b]) == 0
    assert 'no --max-utilization ceiling configured' \
        in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-utilization', '0.9']) == 1
    assert 'over the utilization ceiling' in capsys.readouterr().out
    assert diff_mod.main([a, b, '--max-utilization', '0.99']) == 0


def test_utilization_lost_account_fails(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    _write_plane(a, cap={'utilization': 0.5})
    assert diff_mod.main([a, b]) == 1
    assert 'missing from candidate' in capsys.readouterr().out
    assert diff_mod.main([b, a, '--max-utilization', '0.4']) == 1
    assert diff_mod.main([b, a, '--max-utilization', '0.9']) == 0


# ---------------------------------------------------------------------------
# Supervised roots (recovery.json + attempt_<k>/): the restart, gave-up and
# elastic gates over summaries.
# ---------------------------------------------------------------------------

def _supervised(root, restarts, **kw):
    _write_recovery(root, restarts, **kw)
    for k in range(restarts + 1):
        _write_attempt(root, k)
    return root


def test_diff_gates_on_extra_restarts(tmp_path):
    base = summarize(load_run(_supervised(str(tmp_path / 'base'), 0)))
    cand = summarize(load_run(_supervised(str(tmp_path / 'obs'), 1)))
    rows, regs = diff_runs(base, cand)
    row = next(r for r in rows if r['metric'] == 'restarts')
    assert row['status'] == 'REGRESSION' and row in regs
    rows, regs = diff_runs(cand, cand)
    row = next(r for r in rows if r['metric'] == 'restarts')
    assert row['status'] == 'ok' and not regs
    rows, _ = diff_runs(base, cand, thresholds={'restarts': 1})
    assert next(r for r in rows
                if r['metric'] == 'restarts')['status'] == 'ok'


def test_diff_gates_on_elastic_shrink(tmp_path):
    """JAX's elastic gate, kept for recovery files that carry shrinks
    (the port's supervisor writes none: the row is absent then)."""
    base = summarize(load_run(_supervised(str(tmp_path / 'base'), 1)))
    cand = summarize(load_run(_supervised(
        str(tmp_path / 'cand'), 1,
        elastic=['--model_shards 8 -> 4 (shrink the mesh)'])))
    rows, regs = diff_runs(base, cand, thresholds={'restarts': 100})
    row = next(r for r in rows if r['metric'] == 'elastic_shrinks')
    assert row['status'] == 'REGRESSION' and row in regs
    assert '--model_shards 8 -> 4' in row['note']
    rows, regs = diff_runs(cand, cand, thresholds={'restarts': 100})
    row = next(r for r in rows if r['metric'] == 'elastic_shrinks')
    assert row['status'] == 'ok' and not regs
    rows, regs = diff_runs(cand, base, thresholds={'restarts': 100})
    row = next(r for r in rows if r['metric'] == 'elastic_shrinks')
    assert row['status'] == 'ok' and not regs
    rows, _ = diff_runs(base, base)
    assert 'elastic_shrinks' not in {r['metric'] for r in rows}


def test_elastic_events_render_in_report(tmp_path):
    root = _supervised(str(tmp_path / 'obs'), 1,
                       elastic=['--row_shards 8 -> 4 (shrink the mesh)'])
    s = summarize(load_run(root))
    assert [e['detail'] for e in s['recovery']['elastic']] == \
        ['--row_shards 8 -> 4 (shrink the mesh)']
    text = render(load_run(root))
    assert 'elastic shrink' in text and '--row_shards 8 -> 4' in text


def test_diff_gave_up_fails_unconditionally(tmp_path):
    a = summarize(load_run(_supervised(str(tmp_path / 'a'), 0)))
    b = summarize(load_run(_supervised(str(tmp_path / 'b'), 5,
                                       outcome='gave-up')))
    rows, regs = diff_runs(a, b, thresholds={'restarts': 100})
    rec = next(r for r in rows if r['metric'] == 'recovery')
    assert rec['status'] == 'REGRESSION' and rec in regs


def test_unsupervised_candidate_skips_gate(tmp_path):
    a = _supervised(str(tmp_path / 'a'), 2)
    b = _write_attempt(str(tmp_path), 'solo')
    rows, _ = diff_runs(summarize(load_run(a)), summarize(load_run(b)))
    row = next(r for r in rows if r['metric'] == 'restarts')
    assert row['status'] == 'skipped'


# ---------------------------------------------------------------------------
# Parity: JAX's main and the port's on the same run dirs.
# ---------------------------------------------------------------------------

def _dispatch(*rows, words=None):
    words = words or {}
    return {'counts': [{'kernel': k, 'outcome': words.get(o, o),
                        'reason': 'r', 'count': n} for k, o, n in rows]}


def _scenario_dirs(root, name, words):
    """``(baseline, candidate)`` of one parity scenario, the dispatch
    outcomes written with ``words`` (the port's, or mapped to JAX's)."""
    base = _dispatch(('topk', 'kernel', 3), ('consensus_fwd', 'kernel', 10),
                     ('collate', 'native', 4), words=words)
    d = os.path.join(str(root), name)
    if name == 'equal':
        return write_run(d, 'a', dispatch=base), write_run(d, 'b',
                                                           dispatch=base)
    if name == 'plain_and_absent':
        cand = _dispatch(('topk', 'plain', 3), ('collate', 'numpy', 4),
                         words=words)
        return write_run(d, 'a', dispatch=base), write_run(d, 'b',
                                                           dispatch=cand)
    if name == 'slow_and_churn':
        slow = copy.deepcopy(BASE_TIMINGS)
        for k in ('mean_s', 'p50_s', 'p95_s', 'max_s'):
            slow['steps'][k] *= 1.6
        slow['compile']['events'] = 12
        slow['first_nonfinite'] = {'step': 3, 'stage': 'psi2'}
        return (write_run(d, 'a', dispatch=base),
                write_run(d, 'b', timings=slow, dispatch=base))
    if name == 'efficiency':
        a_eff = dict(_eff_measured(overlap=0.5, idle=0.2),
                     programs=_sched(arith_intensity=10.0)['programs'])
        b_eff = dict(_eff_measured(idle=0.3, idle_source='host'), mfu=0.01,
                     programs=_sched(overlap_fraction=0.05,
                                     static_peak_bytes=3 << 20)['programs'])
        return (write_run(d, 'a', efficiency=a_eff, dispatch=base),
                write_run(d, 'b', efficiency=b_eff, dispatch=base))
    if name == 'serve_planes':
        a = write_run(d, 'a', dispatch=base,
                      aggregate={'skew': {'step_time_ratio': 1.0},
                                 'hosts': 1})
        b = write_run(d, 'b', dispatch=base,
                      hang={'reason': 'deadline', 'stalled_for_s': 9.0,
                            'in_flight': {'phase': 'step', 'name': 4}})
        _write_qtrace(a, {'device_execute': (10.0, 20.0),
                          'serialize': (0.1, 0.2)})
        _write_qtrace(b, {'device_execute': (10.0, 41.0)})
        _write_plane(a, goodput={'goodput_ratio': 0.9,
                                 'pad_fraction_max': 0.1},
                     cap={'utilization': 0.5})
        _write_plane(b, goodput={'goodput_ratio': 0.6,
                                 'pad_fraction_max': 0.4},
                     cap={'utilization': 0.97})
        _write_metrics(a, {'step': 4, 'loss': 1.25, 'hits1': 0.5})
        _write_metrics(b, {'step': 4, 'loss': 1.5})
        return a, b
    if name == 'supervised':
        a = _supervised(os.path.join(d, 'a'), 0)
        b = _supervised(os.path.join(d, 'b'), 3, outcome='gave-up',
                        degradations=('f32',),
                        elastic=['--row_shards 8 -> 4'])
        for root in (a, b):
            for k in os.listdir(root):
                if k.startswith('attempt_'):
                    with open(os.path.join(root, k, 'dispatch.json'),
                              'w') as f:
                        json.dump(base, f)
        return a, b
    raise KeyError(name)


PARITY = {
    'equal': [[], ['--json']],
    'plain_and_absent': [[], ['--json'], ['--allow-kernel-fallback'],
                         ['--allow-kernel-fallback', '--json']],
    'slow_and_churn': [[], ['--json'], ['--max-step-p50-regression', '0.7',
                                        '--max-new-compile-events', '10']],
    'efficiency': [[], ['--json'], ['--min-overlap', '0.2',
                                    '--min-measured-overlap', '0.3',
                                    '--max-peak-regression', '5']],
    'serve_planes': [[], ['--json'], ['--max-stage-p95-regression', '0.5',
                                      '--min-goodput', '0.8',
                                      '--max-pad-regression', '0.2',
                                      '--max-utilization', '0.9',
                                      '--require-equal', 'loss,hits1',
                                      '--json']],
    'supervised': [[], ['--json'], ['--max-restarts-regression', '5']],
}


def _port_words(value):
    """JAX's output in the port's dispatch words."""
    if isinstance(value, str):
        value = value.replace(*JAX_NOTE)
        for port, jax in JAX_WORDS.items():
            value = value.replace(jax, port)
        return value
    if isinstance(value, list):
        return [_port_words(v) for v in value]
    if isinstance(value, dict):
        return {k: _port_words(v) for k, v in value.items()}
    return value


def _call(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_main(name, argv):
    """``dgmc_tpu.obs.<name>.main(argv)`` → ``(rc, stdout, stderr)``."""
    with jax_worker(f'dgmc_tpu.obs.{name}', 'dgmc_tpu.obs.cost',
                    'dgmc_tpu.resilience.supervisor') as mods:
        return _call(mods[name].main, argv)


def same_output(ours, theirs, as_json):
    """The port's and JAX's ``(rc, stdout, stderr)`` agree, JAX's dispatch
    words mapped to the port's (the table compared with its columns'
    padding collapsed: ``plain`` is shorter than ``fallback``)."""
    assert ours[0] == theirs[0]
    assert ours[2] == _port_words(theirs[2])
    if as_json:
        assert json.loads(ours[1]) == _port_words(json.loads(theirs[1]))
    else:
        squash = lambda s: re.sub(r' +', ' ', s)  # noqa: E731
        assert squash(ours[1]) == squash(_port_words(theirs[1]))


@pytest.mark.parametrize('scenario', sorted(PARITY))
def test_main_matches_jax(scenario, tmp_path):
    rcs = []
    for argv in PARITY[scenario]:
        # The same paths for both: each run's dirs are written anew in
        # its own vocabulary.
        a, b = _scenario_dirs(tmp_path / 'runs', scenario, JAX_WORDS)
        theirs = jax_main('diff', [a, b] + argv)
        shutil.rmtree(tmp_path / 'runs')
        a, b = _scenario_dirs(tmp_path / 'runs', scenario, {})
        ours = _call(diff_mod.main, [a, b] + argv)
        shutil.rmtree(tmp_path / 'runs')
        same_output(ours, theirs, '--json' in argv)
        rcs.append(ours[0])
    assert rcs[0] == (0 if scenario == 'equal' else 1)


def test_usage_errors_match_jax(tmp_path):
    a = write_run(tmp_path, 'a')
    empty = tmp_path / 'empty'
    empty.mkdir()
    for argv in ([a, str(tmp_path / 'nope')], [a, str(empty)],
                 [a, a, '--calibration', str(tmp_path / 'absent.json')]):
        ours = _call(diff_mod.main, argv)
        assert ours[0] == 2
        same_output(ours, jax_main('diff', argv), False)


# ---------------------------------------------------------------------------
# Real port artifacts, made on the CPU.
# ---------------------------------------------------------------------------

#: The JAX CI's tiny observed PascalPF run (``.github/workflows/ci.yml``).
TINY_PF = ['--device', 'cpu', '--epochs', '1', '--batch_size', '8',
           '--dim', '16', '--rnd_dim', '8', '--num_steps', '1']
DENSE_KERNELS = ('consensus_fwd', 'rng', 'spline_route_bwd',
                 'spline_route_fwd')


def observed_pascal_pf(root, profile=True):
    """A tiny observed ``pascal_pf.main`` run on the CPU in ``root/obs``
    (with ``profile``: steps 1-2 profiled and the attribution merged into
    its ``efficiency.json``) → the obs dir."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.obs import attribution
    d, prof = os.path.join(root, 'obs'), os.path.join(root, 'prof')
    argv = TINY_PF + ['--data_root', os.path.join(root, 'none'),
                      '--obs-dir', d]
    if profile:
        argv += ['--profile-dir', prof, '--profile-steps', '1:3']
    with contextlib.redirect_stdout(io.StringIO()):
        pascal_pf.main(argv)
        if profile:
            assert attribution.main([prof, '--obs-dir', d]) == 0
    return d


@pytest.fixture(scope='module')
def pf_run(tmp_path_factory):
    torch.set_num_threads(1)
    return observed_pascal_pf(str(tmp_path_factory.mktemp('pf')))


def _rows(rc_out):
    return {r['metric']: r for r in json.loads(rc_out[1])['rows']}


def test_tiny_pascal_pf_run_diffs_clean_against_itself(pf_run):
    rc, out, _ = _call(diff_mod.main, [pf_run, pf_run, '--json'])
    assert rc == 0
    rows = _rows((rc, out))
    for key in ('step_p50_s', 'step_p95_s', 'steps_per_sec', 'mfu',
                'arith_intensity', 'idle_fraction', 'compile_events',
                'peak_memory_bytes'):
        assert rows[key]['status'] == 'ok', key
    assert rows['idle_fraction']['note'].endswith('source=host')
    assert rows['peak_memory_bytes']['note'] == 'source=host'
    assert rows['goodput_ratio']['status'] == 'info'
    # A CPU run ran every kernel's plain version: nothing to gate.
    assert not [m for m in rows if m.startswith('dispatch[')]
    # Fields no port run writes have no row.
    for key in ('overlap_fraction', 'static_peak_bytes',
                'measured_overlap_fraction', 'elastic_shrinks'):
        assert key not in rows


def test_card_baseline_against_the_cpu_run(pf_run, tmp_path):
    """The same run as a card's ledger would record it (every kernel
    launched, and the spline records built by their kernel, a decision
    the CPU's plain routing never reaches) as the baseline: the CPU run
    fails one dispatch row per dense kernel, each a note under
    --allow-kernel-fallback; the reverse has no dispatch row."""
    card = str(tmp_path / 'card')
    shutil.copytree(pf_run, card)
    path = os.path.join(card, 'dispatch.json')
    with open(path) as f:
        counts = json.load(f)['counts']
    for r in counts:
        if r['outcome'] == 'plain':
            r.update(outcome='kernel', reason='cuda')
    counts.append({'kernel': 'spline_records', 'outcome': 'kernel',
                   'reason': 'auto-cuda', 'count': 256})
    with open(path, 'w') as f:
        json.dump({'counts': counts}, f)
    rc, out, _ = _call(diff_mod.main, [card, pf_run, '--json'])
    rows = _rows((rc, out))
    assert rc == 1
    records = rows.pop('dispatch[spline_records]')
    assert (records['b'], records['status'], records['note']) == (
        'absent', 'REGRESSION', 'kernel decision absent from candidate')
    gated = {m: r for m, r in rows.items() if m.startswith('dispatch[')}
    assert sorted(gated) == [f'dispatch[{k}]' for k in DENSE_KERNELS]
    assert all(r['status'] == 'REGRESSION' and r['a'] == 'kernel'
               and r['b'] == 'plain'
               and r['note'] == 'kernel ran its plain version'
               for r in gated.values())
    assert [m for m, r in rows.items() if r['status'] == 'REGRESSION'] \
        == list(gated)
    rc, out, _ = _call(diff_mod.main, [card, pf_run, '--json',
                                       '--allow-kernel-fallback'])
    assert rc == 0 and {r['status'] for m, r in _rows((rc, out)).items()
                        if m.startswith('dispatch[')} == {'note'}
    rc, out, _ = _call(diff_mod.main, [pf_run, card, '--json'])
    assert rc == 0
    assert not [m for m in _rows((rc, out)) if m.startswith('dispatch[')]


def _supervisor_root(tmp_path, scenario, telemetry):
    """``recovery.json`` written by the port's supervisor over the toy
    child of a supervisor scenario, each attempt dir given the tiny run's
    telemetry → the supervised root."""
    from dgmc_tpu_torch.resilience.supervisor import Supervisor
    from tests.test_torch_supervisor import SCENARIOS
    tmp = tmp_path / scenario
    os.makedirs(tmp)
    cmd, argv, kw = SCENARIOS[scenario](tmp)
    obs = tmp / 'obs'
    kw.setdefault('max_restarts', 5)
    Supervisor(cmd, argv + ['--obs-dir', str(obs)], obs_dir=str(obs),
               backoff_s=0.05, grace_s=2.0, poll_s=0.05, **kw).run()
    for k in os.listdir(obs):
        if k.startswith('attempt_'):
            for name in ('timings.json', 'metrics.jsonl', 'memory.json',
                         'dispatch.json'):
                shutil.copy(os.path.join(telemetry, name), obs / k / name)
    return str(obs)


def test_port_supervisor_recovery_gates(pf_run, tmp_path):
    clean = _supervisor_root(tmp_path, 'clean', pf_run)
    crashed = _supervisor_root(tmp_path, 'crashes-until-success', pf_run)
    gave_up = _supervisor_root(tmp_path, 'budget-exhausted', pf_run)
    rows = _rows(_call(diff_mod.main, [clean, crashed, '--json']))
    assert rows['restarts']['a'] == 0 and rows['restarts']['b'] == 2
    assert rows['restarts']['status'] == 'REGRESSION'
    assert [m for m, r in rows.items() if r['status'] == 'REGRESSION'] \
        == ['restarts']
    rc, out, _ = _call(diff_mod.main, [clean, crashed,
                                       '--max-restarts-regression', '2'])
    assert rc == 0 and 'restarts' in out
    rc, out, _ = _call(diff_mod.main, [clean, gave_up, '--json',
                                       '--max-restarts-regression', '100'])
    assert rc == 1
    rows = _rows((rc, out))
    assert rows['recovery']['b'] == 'gave-up'
    assert rows['recovery']['status'] == 'REGRESSION'
    assert 'elastic_shrinks' not in rows
    # The completed attempt read as an unsupervised run: the gate skips.
    rows = _rows(_call(diff_mod.main, [crashed, pf_run, '--json']))
    assert rows['restarts']['status'] == 'skipped'
    # The same verdicts from JAX's diff on the port's files.
    for argv in ([clean, crashed], [clean, gave_up, '--json']):
        same_output(_call(diff_mod.main, argv), jax_main('diff', argv),
                    '--json' in argv)
