"""The port's noise-floor calibration (``obs/calibrate.py``), on the CPU.

The cases of the JAX package's ``tests/obs/test_calibrate.py`` against
the port's module and ``obs/diff.py --calibration``; parity with JAX's
``main`` (the fit file equal but for its ``generated_by``, the
calibrated diff's rows and JSON equal); and a calibration over two
repeats of a tiny observed ``pascal_pf`` run on the CPU, fed to the
diff of the two.
"""

import copy
import json
import os

import pytest
import torch

from dgmc_tpu_torch.obs import calibrate as cal_mod
from dgmc_tpu_torch.obs import diff as diff_mod
from tests.obs.test_calibrate import CAL, _write_cal
from tests.test_torch_diff import (BASE_DISPATCH, BASE_TIMINGS, JAX_WORDS,
                                   _call, jax_main, observed_pascal_pf,
                                   same_output, write_run)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fit_samples_golden():
    s = cal_mod.fit_samples([1.0, 2.0, 3.0, 4.0, 100.0])
    assert s['n'] == 5
    assert s['median'] == 3.0
    assert s['mad'] == 1.0
    assert s['sigma'] == pytest.approx(1.4826)
    assert s['rel_sigma'] == pytest.approx(1.4826 / 3.0)
    assert (s['min'], s['max']) == (1.0, 100.0)
    with pytest.raises(ValueError):
        cal_mod.fit_samples([])


def test_fit_samples_zero_median_has_no_rel_sigma():
    s = cal_mod.fit_samples([-1.0, 0.0, 1.0])
    assert s['median'] == 0.0
    assert s['rel_sigma'] is None


def _repeat_runs(tmp_path, p50s):
    dirs = []
    for i, p50 in enumerate(p50s):
        t = copy.deepcopy(BASE_TIMINGS)
        t['steps']['p50_s'] = p50
        dirs.append(write_run(tmp_path, f'rep{i}', timings=t))
    return dirs


def test_fit_calibration_from_obs_dirs(tmp_path):
    dirs = _repeat_runs(tmp_path, [0.10, 0.11, 0.12])
    cal = cal_mod.fit_calibration(obs_dirs=dirs)
    m = cal['metrics']['step_p50_s']
    assert m['n'] == 3
    assert m['median'] == 0.11
    assert m['rel_sigma'] == pytest.approx(1.4826 * 0.01 / 0.11)
    assert cal['metrics']['compile_events']['rel_sigma'] == 0.0
    assert cal['version'] == cal_mod.CALIBRATION_SCHEMA_VERSION
    assert cal['generated_by'] == 'python -m dgmc_tpu_torch.obs.calibrate'


def _serve_rounds(tmp_path, qps_values):
    for i, qps in enumerate(qps_values, start=1):
        p = tmp_path / f'SERVE_r0{i}.json'
        p.write_text(json.dumps({
            'family': 'SERVE', 'round': i, 'qps': qps,
            'clients': 4, 'hits_at_1': 0.19,
            'latency': {'client_p50_ms': 150.0}}))


def test_fit_calibration_from_round_files(tmp_path):
    _serve_rounds(tmp_path, [20.0, 22.0, 21.0])
    cal = cal_mod.fit_calibration(round_paths=[str(tmp_path)])
    assert cal['metrics']['SERVE.qps']['n'] == 3
    assert cal['metrics']['SERVE.qps']['median'] == 21.0
    assert 'round' not in {k.split('.')[1] for k in cal['metrics']}


def test_fit_cli_writes_calibration(tmp_path, capsys):
    dirs = _repeat_runs(tmp_path, [0.10, 0.11, 0.12])
    out = str(tmp_path / 'calibration.json')
    rc = cal_mod.main(['--obs-dir', dirs[0], '--obs-dir', dirs[1],
                       '--obs-dir', dirs[2], '--out', out])
    assert rc == 0
    with open(out) as f:
        assert json.load(f)['metrics']['step_p50_s']['n'] == 3
    assert 'step_p50_s' in capsys.readouterr().out


def test_fit_cli_usage_and_undersampled(tmp_path):
    with pytest.raises(SystemExit) as exc:
        cal_mod.main(['--out', str(tmp_path / 'c.json')])
    assert exc.value.code == 2
    d = _repeat_runs(tmp_path, [0.10])
    assert cal_mod.main(['--obs-dir', d[0],
                         '--out', str(tmp_path / 'c.json')]) == 2


def test_apply_calibration_scales_armed_gates():
    thresholds = {'step_p50': 0.25, 'step_p95': 0.40, 'min_hits1': None}
    out, notes = cal_mod.apply_calibration(thresholds, CAL)
    assert out['step_p50'] == pytest.approx(0.45)
    assert out['step_p95'] == 0.40
    assert out['min_hits1'] is None
    (n,) = notes
    assert n['gate'] == 'step_p50' and n['metric'] == 'step_p50_s'
    assert n['fixed'] == 0.25 and n['calibrated'] == pytest.approx(0.45)


def test_apply_calibration_guards():
    thin = {'version': 1, 'metrics': {
        'step_p50_s': dict(CAL['metrics']['step_p50_s'], n=2)}}
    out, notes = cal_mod.apply_calibration({'step_p50': 0.25}, thin)
    assert out['step_p50'] == 0.25 and notes == []
    flat = {'version': 1, 'metrics': {
        'step_p50_s': dict(CAL['metrics']['step_p50_s'], rel_sigma=0.0)}}
    out, _ = cal_mod.apply_calibration({'step_p50': 0.25}, flat)
    assert out['step_p50'] == 0.01
    nocal = {'version': 1, 'metrics': {
        'step_p50_s': dict(CAL['metrics']['step_p50_s'], rel_sigma=None)}}
    out, notes = cal_mod.apply_calibration({'step_p50': 0.25}, nocal)
    assert out['step_p50'] == 0.25 and notes == []


def test_load_calibration_errors(tmp_path):
    with pytest.raises(ValueError):
        cal_mod.load_calibration(str(tmp_path / 'absent.json'))
    bad = tmp_path / 'bad.json'
    bad.write_text(json.dumps({'no_metrics': True}))
    with pytest.raises(ValueError):
        cal_mod.load_calibration(str(bad))


def _p50_run(tmp_path, name, p50):
    t = copy.deepcopy(BASE_TIMINGS)
    t['steps'] = dict(t['steps'], p50_s=p50)
    return write_run(tmp_path, name, timings=t)


def test_diff_calibration_loosens_within_noise_delta(tmp_path, capsys):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.13)
    cal = _write_cal(tmp_path, CAL)
    assert diff_mod.main([a, b]) == 1
    capsys.readouterr()
    assert diff_mod.main([a, b, '--calibration', cal]) == 0
    out = capsys.readouterr().out
    assert 'calibrated:step_p50' in out
    assert 'rel_sigma' in out


def test_diff_calibration_still_fails_genuine_regression(tmp_path):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.20)
    cal = _write_cal(tmp_path, CAL)
    assert diff_mod.main([a, b, '--calibration', cal]) == 1


def test_diff_calibration_tightens_quiet_metric(tmp_path, capsys):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.11)
    quiet = {'version': 1, 'metrics': {
        'step_p50_s': dict(CAL['metrics']['step_p50_s'], rel_sigma=0.02)}}
    cal = _write_cal(tmp_path, quiet)
    assert diff_mod.main([a, b]) == 0
    capsys.readouterr()
    assert diff_mod.main([a, b, '--calibration', cal]) == 1
    assert 'REGRESSION' in capsys.readouterr().out


def test_diff_calibration_z_flag(tmp_path):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.13)
    cal = _write_cal(tmp_path, CAL)
    assert diff_mod.main([a, b, '--calibration', cal,
                          '--calibration-z', '1.0']) == 1


def test_diff_calibration_preserves_lost_account_rule(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    timerless = copy.deepcopy(BASE_TIMINGS)
    timerless['steps'] = {}
    b = write_run(tmp_path, 'b', timings=timerless)
    cal = _write_cal(tmp_path, CAL)
    assert diff_mod.main([a, b, '--calibration', cal]) == 1
    assert 'missing from candidate' in capsys.readouterr().out


def test_diff_calibration_unreadable_is_usage_error(tmp_path, capsys):
    a = write_run(tmp_path, 'a')
    b = write_run(tmp_path, 'b')
    assert diff_mod.main([a, b, '--calibration',
                          str(tmp_path / 'absent.json')]) == 2
    assert 'calibration' in capsys.readouterr().err


def test_diff_json_carries_calibration_notes(tmp_path, capsys):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.13)
    cal = _write_cal(tmp_path, CAL)
    assert diff_mod.main([a, b, '--calibration', cal, '--json']) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload['calibration'][0]['gate'] == 'step_p50'
    assert diff_mod.main([a, a, '--json']) == 0
    assert json.loads(capsys.readouterr().out)['calibration'] is None


# ---------------------------------------------------------------------------
# Parity with JAX's calibrate, and the calibrated diff.
# ---------------------------------------------------------------------------

def _set_dispatch(dirs, words):
    """Each run's ``dispatch.json`` in the port's outcome words, or mapped
    to JAX's (the summaries count ``dispatch_pallas`` by them)."""
    counts = [dict(r, outcome=words.get(r['outcome'], r['outcome']))
              for r in BASE_DISPATCH['counts']]
    for d in dirs:
        with open(os.path.join(d, 'dispatch.json'), 'w') as f:
            json.dump({'counts': counts}, f)


def _fit_both(tmp_path, argv, dirs):
    """JAX's and the port's ``main(argv + --out ...)`` over ``dirs``, each
    in its dispatch words → their ``(rc, stdout, stderr)`` and fit
    files."""
    got = {}
    for who, main in (('jax', None), ('port', cal_mod.main)):
        _set_dispatch(dirs, JAX_WORDS if main is None else {})
        out = str(tmp_path / f'{who}.json')
        if main is None:
            res = jax_main('calibrate', argv + ['--out', out])
        else:
            res = _call(main, argv + ['--out', out])
        fit = None
        if os.path.exists(out):
            with open(out) as f:
                fit = json.load(f)
        got[who] = res, fit
    return got


def test_fit_matches_jax(tmp_path):
    dirs = _repeat_runs(tmp_path, [0.10, 0.11, 0.125, 0.4])
    _serve_rounds(tmp_path, [20.0, 22.0, 21.0])
    argv = [a for d in dirs for a in ('--obs-dir', d)] + [
        '--rounds', str(tmp_path)]
    got = _fit_both(tmp_path, argv, dirs)
    (ours, fit), (theirs, jfit) = got['port'], got['jax']
    assert ours[0] == theirs[0] == 0
    assert ours[1].replace('port.json', 'jax.json') == theirs[1]
    assert fit.pop('generated_by') == 'python -m dgmc_tpu_torch.obs.calibrate'
    assert jfit.pop('generated_by') == 'python -m dgmc_tpu.obs.calibrate'
    assert fit == jfit
    # Too few samples: both refuse, with the same words.
    (tmp_path / 'thin').mkdir()
    got = _fit_both(tmp_path / 'thin', ['--obs-dir', dirs[0]], dirs)
    (ours, fit), (theirs, jfit) = got['port'], got['jax']
    assert ours[0] == theirs[0] == 2 and fit is jfit is None
    assert ours[2] == theirs[2]


def test_calibrated_diff_matches_jax(tmp_path):
    a = _p50_run(tmp_path, 'a', 0.10)
    b = _p50_run(tmp_path, 'b', 0.13)
    _set_dispatch((a, b), {})
    cal = _write_cal(tmp_path, {'version': 1, 'metrics': {
        'step_p50_s': CAL['metrics']['step_p50_s'],
        'steps_per_sec': dict(CAL['metrics']['step_p50_s'], rel_sigma=0.5),
        'peak_memory_bytes': dict(CAL['metrics']['step_p50_s'],
                                  rel_sigma=0.0)}})
    for argv in ([a, b, '--calibration', cal],
                 [a, b, '--calibration', cal, '--json'],
                 [a, b, '--calibration', cal, '--calibration-z', '1.5']):
        ours = _call(diff_mod.main, argv)
        _set_dispatch((a, b), JAX_WORDS)
        same_output(ours, jax_main('diff', argv), '--json' in argv)
        _set_dispatch((a, b), {})


def test_two_repeats_of_a_tiny_cpu_run(tmp_path):
    """Two repeats of the CI's tiny observed PascalPF run: the fit has a
    noise floor for every metric the gates read, and the diff of the two
    under it reports its calibrated gates."""
    dirs = [observed_pascal_pf(str(tmp_path / f'rep{i}'), profile=False)
            for i in range(2)]
    out = str(tmp_path / 'calibration.json')
    rc, text, _ = _call(cal_mod.main, ['--obs-dir', dirs[0], '--obs-dir',
                                       dirs[1], '--out', out])
    assert rc == 0
    with open(out) as f:
        metrics = json.load(f)['metrics']
    for key in ('step_p50_s', 'step_p95_s', 'steps_per_sec', 'mfu',
                'arith_intensity', 'peak_memory_bytes'):
        assert metrics[key]['n'] == 2 and metrics[key]['median'] > 0, key
        assert f'  {key}: n=2' in text, key
    # Every run computes the same FLOPs and bytes.
    assert metrics['arith_intensity']['rel_sigma'] == 0.0
    # apply_calibration wants 3 samples: the two repeats change no gate.
    rc, text, _ = _call(diff_mod.main, [dirs[0], dirs[1], '--calibration',
                                        out, '--json'])
    assert json.loads(text)['calibration'] is None
    assert not [r for r in json.loads(text)['rows']
                if r['metric'].startswith('calibrated:')]
    # A third sample (the second run again) arms them, each reported.
    cal3 = str(tmp_path / 'cal3.json')
    rc, _, _ = _call(cal_mod.main, ['--obs-dir', dirs[0], '--obs-dir',
                                    dirs[1], '--obs-dir', dirs[1],
                                    '--out', cal3])
    rc, text, _ = _call(diff_mod.main, [dirs[0], dirs[1], '--calibration',
                                        cal3, '--json'])
    payload = json.loads(text)
    gates = {n['gate'] for n in payload['calibration']}
    assert {'step_p50', 'step_p95', 'throughput', 'memory', 'mfu',
            'intensity'} <= gates
    assert {r['metric'] for r in payload['rows']
            if r['metric'].startswith('calibrated:')} == {
        f'calibrated:{g}' for g in gates}
