"""The port's round trajectory (``obs/timeline.py``), on the CPU.

The cases of the JAX package's ``tests/obs/test_timeline.py`` (and the
``--trend`` case of ``tests/obs/test_calibrate.py``) against the port's
module: both round-record schemas (the legacy ``{'cmd', 'rc', 'tail',
'parsed'}`` capture and the structured r06+ record), all four families,
the ``rc:124`` rounds, the SCALE offload column and the SERVE columns.
The round records are written by each test from literal dicts. Then
parity: on the same files, JAX's ``main`` and the port's print the same
table, JSON, trend and exit code.
"""

import json
import os
import subprocess
import sys

from dgmc_tpu_torch.obs import timeline as tl
from dgmc_tpu_torch.obs.timeline import collect_rounds, parse_round, render
from tests.test_torch_diff import _call, jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, name, payload):
    p = tmp_path / name
    p.write_text(json.dumps(payload))
    return str(p)


def test_parses_legacy_capture(tmp_path):
    _write(tmp_path, 'BENCH_r04.json', {
        'n': 4, 'cmd': 'python bench.py', 'rc': 0, 'tail': '...',
        'parsed': {'metric': 'train_pairs_per_sec', 'value': 1248.9,
                   'device': 'NVIDIA H100 80GB HBM3 (sm_90)',
                   'dense_perf': {'mfu': 0.0194},
                   'sparse_dbp15k': {'step_ms': 306.5}}})
    _write(tmp_path, 'BENCH_r05.json', {
        'n': 5, 'cmd': 'python bench.py', 'rc': 124, 'tail': ''})
    rows = collect_rounds([str(tmp_path)])
    assert [r['round'] for r in rows] == [4, 5]
    r4, r5 = rows
    assert r4['pairs_per_sec'] == 1248.9
    assert r4['mfu'] == 0.0194
    assert r4['step_p50_ms'] == 306.5
    assert r4['device'] == 'NVIDIA H100 80GB HBM3'
    assert r4['outcome'] == 'completed'
    assert r5['outcome'] == 'rc:124'
    assert r5['pairs_per_sec'] is None


def _structured(tmp_path):
    _write(tmp_path, 'BENCH_r06.json', {
        'round': 6, 'rc': 0, 'ok': True,
        'supervision': {'outcome': 'completed', 'restarts': 2},
        'result': {'metric': 'train_pairs_per_sec', 'value': 16.97,
                   'device': 'cpu',
                   'dense_perf': {'mfu': 1.09},
                   'sparse_dbp15k': {'f32': {'step_ms': 11507.9}}}})
    _write(tmp_path, 'MULTICHIP_r08.json', {
        'round': 8, 'n_devices': 8, 'rc': 0, 'ok': True,
        'supervision': {'outcome': 'completed', 'restarts': 0},
        'timing': {'step_p50_ms_8dev': 659.1,
                   'per_device_step_skew_ratio': 1.0}})
    _write(tmp_path, 'SCALE_r07.json', {
        'round': 7, 'n_devices': 8,
        'supervision': {'outcome_8dev': 'completed',
                        'restarts_8dev': 0},
        'timing': {'step_p50_ms_8dev': 412275.0,
                   'per_device_step_skew_ratio': 1.0}})


def test_parses_structured_rounds(tmp_path):
    _structured(tmp_path)
    rows = collect_rounds([str(tmp_path)])
    assert [(r['family'], r['round']) for r in rows] == [
        ('BENCH', 6), ('MULTICHIP', 8), ('SCALE', 7)]
    bench, multi, scale = rows
    assert bench['pairs_per_sec'] == 16.97
    assert bench['step_p50_ms'] == 11507.9
    assert bench['outcome'] == 'completed (2 restarts)'
    assert multi['step_p50_ms'] == 659.1
    assert multi['skew'] == 1.0
    assert multi['devices'] == 8
    assert scale['step_p50_ms'] == 412275.0
    text = render(rows)
    for family in ('BENCH', 'MULTICHIP', 'SCALE'):
        assert f'{family} trajectory' in text


def test_unreadable_round_is_a_row_not_a_crash(tmp_path):
    (tmp_path / 'BENCH_r09.json').write_text('{not json')
    rows = collect_rounds([str(tmp_path)])
    assert rows[0]['outcome'].startswith('unreadable')
    render(rows)


def test_non_round_files_ignored(tmp_path):
    _write(tmp_path, 'BENCH_BASELINE.json', {'value': 1})
    _write(tmp_path, 'corr_shard_memory.json', {'x': 1})
    assert collect_rounds([str(tmp_path)]) == []


def test_parse_round_single_file(tmp_path):
    p = _write(tmp_path, 'MULTICHIP_r01.json', {
        'n_devices': 8, 'rc': 1, 'tail': ''})
    row = parse_round('MULTICHIP', 1, p)
    assert row['outcome'] == 'rc:1'
    assert row['devices'] == 8
    # A file path given to the CLI reads as its round.
    assert [r['round'] for r in collect_rounds([p])] == [1]


def _all_families(tmp_path):
    """Rounds of every family in both schemas, an rc:124 round among
    them."""
    _structured(tmp_path)
    _write(tmp_path, 'BENCH_r05.json', {
        'n': 5, 'cmd': 'python bench.py', 'rc': 124, 'tail': ''})
    _write(tmp_path, 'MULTICHIP_r05.json', {
        'n': 5, 'cmd': 'python bench.py --multichip', 'rc': 124,
        'tail': '', 'n_devices': 4})
    _write(tmp_path, 'BENCH_r04.json', {
        'n': 4, 'cmd': 'python bench.py', 'rc': 0, 'tail': '...',
        'parsed': {'metric': 'train_pairs_per_sec', 'value': 1248.9,
                   'dense_perf': {'mfu': 0.0194},
                   'sparse_dbp15k': {'step_ms': 306.5}}})
    _write(tmp_path, 'SERVE_r01.json', {
        'round': 1, 'outcome': 'completed',
        'supervision': {'outcome': 'completed', 'restarts': 1},
        'latency': {'server_p50_ms': 111.8, 'server_p95_ms': 134.8,
                    'client_p50_ms': 118.8},
        'qps': 28.6, 'clients': 4,
        'restart': {'cold_first_answer_s': 12.7,
                    'warm_first_answer_s': 10.8,
                    'warm_beats_cold': True}})
    _write(tmp_path, 'SERVE_r02.json', {
        'round': 2, 'supervision': {'outcome': 'completed',
                                    'restarts': 1},
        'latency': {'server_p50_ms': 100.0, 'server_p95_ms': 150.0},
        'qps': 30.0, 'clients': 4,
        'qtrace': {'p99_ms': 201.5, 'dominant_stage': 'device_execute'},
        'quality': {'hits1': 0.19, 'saturated_frac': 0.0,
                    'audit': {'recall_min': 1.0}},
        'goodput': {'serve': {'goodput_ratio': 0.987}},
        'capacity': {'utilization': 0.876}})


def test_cli_over_round_records_of_every_family(tmp_path):
    """The module's entry point over every family in both schemas: the
    rc:124 rounds are visible, not hidden."""
    _all_families(tmp_path)
    out = subprocess.run(
        [sys.executable, '-m', 'dgmc_tpu_torch.obs.timeline',
         str(tmp_path), '--json'],
        cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    by_key = {(r['family'], r['round']): r for r in json.loads(out.stdout)}
    assert by_key[('BENCH', 6)]['pairs_per_sec'] == 16.97
    assert by_key[('BENCH', 4)]['mfu'] == 0.0194
    assert by_key[('MULTICHIP', 8)]['step_p50_ms'] == 659.1
    assert by_key[('SCALE', 7)]['outcome'].startswith('completed')
    assert by_key[('BENCH', 5)]['outcome'] == 'rc:124'
    assert by_key[('MULTICHIP', 5)]['outcome'] == 'rc:124'
    serve = by_key[('SERVE', 1)]
    assert serve['outcome'] == 'completed' and serve['restarts'] == 1
    assert serve['latency_p95_ms'] >= serve['latency_p50_ms'] > 0
    serve2 = by_key[('SERVE', 2)]
    assert serve2['latency_p99_ms'] >= serve2['latency_p95_ms'] > 0
    assert serve2['audit_recall'] == 1.0 and serve2['hits1'] == 0.19
    assert list(by_key) == [
        ('BENCH', 4), ('BENCH', 5), ('BENCH', 6), ('MULTICHIP', 5),
        ('MULTICHIP', 8), ('SCALE', 7), ('SERVE', 1), ('SERVE', 2)]


def test_cli_empty_dir_exits_2(tmp_path):
    rc, out, err = _call(tl.main, [str(tmp_path)])
    assert rc == 2 and 'no round records' in err
    assert '(no BENCH_r*' in out


def test_scale_offload_column(tmp_path):
    _write(tmp_path, 'SCALE_r08.json', {
        'round': 8, 'n_devices': 8,
        'supervision': {'outcome_8dev': 'completed',
                        'restarts_8dev': 0},
        'timing': {'step_p50_ms_8dev': 1000.0,
                   'per_device_step_skew_ratio': 1.0},
        'offload': {'rows': 1 << 23, 'prefetch_depth': 2,
                    'host_resident_bytes': 2 << 30,
                    'outcome': 'completed'}})
    _write(tmp_path, 'SCALE_r07.json', {
        'round': 7, 'n_devices': 8,
        'supervision': {'outcome_8dev': 'completed'},
        'timing': {'step_p50_ms_8dev': 2000.0}})
    r7, r8 = collect_rounds([str(tmp_path)])
    assert 'offload' not in r7
    assert r8['offload']['prefetch_depth'] == 2
    assert r8['offload']['rows'] == 1 << 23
    table = render([r7, r8])
    assert 'offload' in table and 'd2/2.0G' in table
    (line7,) = [ln for ln in table.splitlines()
                if ln.strip().startswith('7 ')]
    assert ' - ' in line7


def test_serve_family_rows(tmp_path):
    _write(tmp_path, 'SERVE_r01.json', {
        'round': 1,
        'supervision': {'outcome': 'completed', 'restarts': 1},
        'latency': {'server_p50_ms': 111.8, 'server_p95_ms': 134.8,
                    'client_p50_ms': 118.8},
        'qps': 28.6, 'clients': 4,
        'restart': {'cold_first_answer_s': 12.7,
                    'warm_first_answer_s': 10.8,
                    'warm_beats_cold': True}})
    (r,) = collect_rounds([str(tmp_path)])
    assert r['family'] == 'SERVE'
    assert r['latency_p50_ms'] == 111.8
    assert r['latency_p95_ms'] == 134.8
    assert r['qps'] == 28.6 and r['clients'] == 4
    assert r['restarts'] == 1
    assert r['warm_restart_s'] == 10.8
    assert r['outcome'] == 'completed'
    table = render([r])
    assert 'SERVE trajectory' in table
    assert 'restarts' in table and 'QPS' in table
    (line,) = [ln for ln in table.splitlines()
               if ln.strip().startswith('1 ')]
    assert '10.80s' in line


def test_serve_qtrace_columns(tmp_path):
    _write(tmp_path, 'SERVE_r01.json', {
        'round': 1, 'supervision': {'outcome': 'completed',
                                    'restarts': 1},
        'latency': {'server_p50_ms': 111.8, 'server_p95_ms': 134.8},
        'qps': 28.6, 'clients': 4})
    _write(tmp_path, 'SERVE_r02.json', {
        'round': 2, 'supervision': {'outcome': 'completed',
                                    'restarts': 1},
        'latency': {'server_p50_ms': 100.0, 'server_p95_ms': 150.0},
        'qps': 30.0, 'clients': 4,
        'qtrace': {'p99_ms': 201.5,
                   'dominant_stage': 'admission_queue_wait'}})
    r1, r2 = collect_rounds([str(tmp_path)])
    assert r1['latency_p99_ms'] is None and r1['dominant_stage'] is None
    assert r2['latency_p99_ms'] == 201.5
    assert r2['dominant_stage'] == 'admission_queue_wait'
    table = render([r1, r2])
    assert 'p99' in table and 'tail stage' in table
    (line1,) = [ln for ln in table.splitlines()
                if ln.strip().startswith('1 ')]
    (line2,) = [ln for ln in table.splitlines()
                if ln.strip().startswith('2 ')]
    assert 'admission_queue_wait' in line2 and '201.50 ms' in line2
    assert 'admission_queue_wait' not in line1


def test_serve_goodput_and_utilization_columns(tmp_path):
    _write(tmp_path, 'SERVE_r01.json', {
        'round': 1, 'supervision': {'outcome': 'completed',
                                    'restarts': 1},
        'latency': {'server_p50_ms': 111.8, 'server_p95_ms': 134.8},
        'qps': 28.6, 'clients': 4})
    _write(tmp_path, 'SERVE_r04.json', {
        'round': 4, 'supervision': {'outcome': 'completed',
                                    'restarts': 1},
        'latency': {'server_p50_ms': 100.0, 'server_p95_ms': 150.0},
        'qps': 19.7, 'clients': 4,
        'goodput': {'serve': {'goodput_ratio': 0.987}},
        'capacity': {'utilization': 0.876}})
    r1, r4 = collect_rounds([str(tmp_path)])
    assert r1['goodput'] is None and r1['utilization'] is None
    assert r4['goodput'] == 0.987 and r4['utilization'] == 0.876
    table = render([r1, r4])
    assert 'goodput' in table and 'util' in table
    (line1,) = [ln for ln in table.splitlines()
                if ln.strip().startswith('1 ')]
    (line4,) = [ln for ln in table.splitlines()
                if ln.strip().startswith('4 ')]
    assert '0.987' in line4 and '0.876' in line4
    assert '0.987' not in line1


def test_serve_falls_back_to_client_latency(tmp_path):
    _write(tmp_path, 'SERVE_r02.json', {
        'round': 2, 'supervision': {'outcome': 'completed',
                                    'restarts': 0},
        'latency': {'client_p50_ms': 9.0, 'client_p95_ms': 14.0},
        'qps': 100.0, 'clients': 2})
    (r,) = collect_rounds([str(tmp_path)])
    assert r['latency_p50_ms'] == 9.0
    assert r['latency_p95_ms'] == 14.0
    render([r])


def _serve_trend(tmp_path):
    for i, qps in enumerate([20.0, 21.0, 20.5, 20.8, 5.0], start=1):
        _write(tmp_path, f'SERVE_r0{i}.json', {
            'family': 'SERVE', 'round': i, 'qps': qps, 'clients': 4,
            'latency': {'client_p50_ms': 150.0, 'client_p95_ms': 300.0}})


def test_trend_marks_shift_round(tmp_path, capsys):
    """``--trend``: a qps collapse at r05 reads as one changepoint
    labelled with the ROUND, not the list index."""
    _serve_trend(tmp_path)
    trends = tl.trend(collect_rounds([str(tmp_path)]))
    qps_t = next(t for t in trends if t['metric'] == 'qps')
    assert qps_t['changepoints'] == [
        {'round': 5, 'direction': 'down', 'value': 5.0}]
    p50_t = next(t for t in trends if t['metric'] == 'latency_p50_ms')
    assert p50_t['changepoints'] == []
    assert tl.main([str(tmp_path), '--trend']) == 0
    out = capsys.readouterr().out
    assert 'trend changepoints' in out and 'r05 down' in out
    assert tl.main([str(tmp_path), '--trend', '--json']) == 0
    payload = json.loads(capsys.readouterr().out)
    assert len(payload['rows']) == 5 and payload['trend']


def test_trend_needs_four_measured_rounds(tmp_path):
    _structured(tmp_path)
    assert tl.trend(collect_rounds([str(tmp_path)])) == []
    assert 'need 4+ per family/metric' in tl.render_trend([])


def test_main_matches_jax(tmp_path):
    rounds = tmp_path / 'rounds'
    rounds.mkdir()
    _all_families(rounds)
    (rounds / 'trend').mkdir()
    _serve_trend(rounds / 'trend')
    (rounds / 'BENCH_r09.json').write_text('{not json')
    empty = tmp_path / 'empty'
    empty.mkdir()
    for argv in ([str(rounds)], [str(rounds), '--json'],
                 [str(rounds), str(rounds / 'trend'), '--trend'],
                 [str(rounds), str(rounds / 'trend'), '--trend', '--json'],
                 [str(rounds / 'SERVE_r02.json')], [str(empty)]):
        assert _call(tl.main, argv) == jax_main('timeline', argv)
