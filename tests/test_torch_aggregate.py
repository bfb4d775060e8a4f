"""The port's multi-device / multi-host aggregation (``obs/aggregate.py``).

The cases of the JAX package's ``tests/obs/test_aggregate.py`` against the
port's module: synthesized host subdirectories pin the skew arithmetic (a
2x straggler device reads as ratio 2.0 against the median), the report
and diff read the artifact, ``--scrape`` probes live endpoints. The
fenced run is the port's: ``RunObserver.fence_devices`` on one device,
whose step-time ratio is exactly 1.0. Then parity: on the same dirs,
JAX's ``main`` and the port's print the same table and JSON and write
the same ``aggregate.json``.
"""

import json
import os
import time

import pytest
import torch

from dgmc_tpu_torch.obs import aggregate as agg_mod
from dgmc_tpu_torch.obs import report
from tests.obs.test_aggregate import _host
from tests.test_torch_diff import _call, jax_main


def test_single_dir_acts_as_host0(tmp_path):
    _host(tmp_path, None, device_means=(0.1, 0.1, 0.2, 0.1))
    s = agg_mod.aggregate(str(tmp_path))
    assert s['hosts'] == 1
    assert list(s['per_host']) == ['host_0']
    assert s['skew']['step_time_ratio'] == pytest.approx(2.0)
    assert s['step_time']['worst'] == {'host': 'host_0', 'device': '2'}
    assert s['step_time']['source'] == 'device_series'


def test_multi_host_merge_and_memory_spread(tmp_path):
    _host(tmp_path, 'host_0', device_means=(0.1, 0.1),
          dev_peaks=(1 << 30, 1 << 30), wall=10.0)
    _host(tmp_path, 'host_1', device_means=(0.1, 0.3),
          dev_peaks=(1 << 30, 3 << 30), wall=14.0)
    s = agg_mod.aggregate(str(tmp_path))
    assert s['hosts'] == 2
    assert len(s['devices']) == 4
    assert s['skew']['step_time_ratio'] == pytest.approx(3.0)
    assert s['step_time']['worst'] == {'host': 'host_1', 'device': '1'}
    assert s['skew']['memory_ratio'] == pytest.approx(3.0)
    assert s['memory']['source'] == 'device'
    assert s['skew']['wall_ratio'] == pytest.approx(14.0 / 12.0, abs=1e-3)


def test_host_p50_fallback_when_no_device_series(tmp_path):
    _host(tmp_path, 'host_0', p50=0.1)
    _host(tmp_path, 'host_1', p50=0.4)
    s = agg_mod.aggregate(str(tmp_path))
    assert s['step_time']['source'] == 'host_p50'
    assert s['skew']['step_time_ratio'] == pytest.approx(0.4 / 0.25)


def test_hung_host_is_flagged(tmp_path):
    _host(tmp_path, 'host_0')
    _host(tmp_path, 'host_1',
          hang={'reason': 'deadline', 'stalled_for_s': 99.0,
                'in_flight': {'phase': 'step', 'name': 7}})
    s = agg_mod.aggregate(str(tmp_path))
    assert s['hung_hosts'] == ['host_1']
    assert 'hang_report' in s['per_host']['host_1']


def _hung_fence_root(root):
    _host(root, 'host_0', device_means=(0.1,))
    _host(root, 'host_1', device_means=(0.1,),
          hang={'reason': 'fence-deadline: epoch-fence incomplete '
                          'after 30.0s',
                'in_flight': {'phase': 'fence', 'name': 'epoch-fence'},
                'last_completed': {'phase': 'step', 'name': 11,
                                   'duration_s': 0.4},
                'stalled_for_s': 31.0})
    cdir = os.path.join(str(root), 'control')
    os.makedirs(cdir)
    with open(os.path.join(cdir, 'host_1.json'), 'w') as f:
        json.dump({'host': 1, 'time': 123.0, 'phase': 'epoch', 'step': 12,
                   'last_fence': {'phase': 'epoch-fence', 'step': 10,
                                  'time': 120.0}}, f)


def test_hung_host_attributed_to_fence_and_phase(tmp_path):
    _hung_fence_root(tmp_path)
    s = agg_mod.aggregate(str(tmp_path))
    assert s['hung_hosts'] == ['host_1']
    att = s['hang_attribution']['host_1']
    assert att['reason'].startswith('fence-deadline')
    assert att['in_flight'] == {'phase': 'fence', 'name': 'epoch-fence'}
    assert att['last_completed']['name'] == 11
    assert att['last_fence'] == {'phase': 'epoch-fence', 'step': 10,
                                 'time': 120.0}
    assert att['last_heartbeat']['step'] == 12
    text = agg_mod.render(s)
    assert 'stuck in fence:epoch-fence' in text
    assert 'last fence epoch-fence@10' in text


def test_non_coordinator_hang_reaches_root_summary_and_diff(tmp_path):
    from dgmc_tpu_torch.obs import diff as diff_mod
    clean = str(tmp_path / 'clean')
    _host(clean, 'host_0')
    _host(clean, 'host_1')
    hung = str(tmp_path / 'hung')
    _host(hung, 'host_0')
    _host(hung, 'host_1',
          hang={'reason': 'deadline', 'stalled_for_s': 77.0,
                'in_flight': {'phase': 'step', 'name': 9}})
    s = report.summarize(report.load_run(hung))
    assert s['hang_report']['reason'] == 'deadline'
    assert s['hang_report']['host'] == 'host_1'
    assert s['hung_hosts'] == ['host_1']
    assert _call(diff_mod.main, [clean, hung])[0] == 1


def test_empty_root_returns_none_and_cli_errors(tmp_path):
    assert agg_mod.aggregate(str(tmp_path)) is None
    assert _call(agg_mod.main, [str(tmp_path)])[0] == 2


def test_cli_writes_aggregate_json_and_renders(tmp_path, capsys):
    _host(tmp_path, 'host_0', device_means=(0.1, 0.2))
    assert agg_mod.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert 'step-time skew' in out and 'host_0' in out
    with open(tmp_path / 'aggregate.json') as f:
        on_disk = json.load(f)
    assert on_disk['skew']['step_time_ratio'] == pytest.approx(
        0.2 / 0.15, abs=1e-3)
    os.remove(tmp_path / 'aggregate.json')
    assert agg_mod.main([str(tmp_path), '--no-write', '--json']) == 0
    assert json.loads(capsys.readouterr().out)['hosts'] == 1
    assert not os.path.exists(tmp_path / 'aggregate.json')


def test_report_consumes_multi_host_root(tmp_path, capsys):
    _host(tmp_path, 'host_0', device_means=(0.1, 0.1))
    _host(tmp_path, 'host_1', device_means=(0.1, 0.2))
    assert agg_mod.main([str(tmp_path)]) == 0
    capsys.readouterr()
    assert report.main([str(tmp_path), '--json']) == 0
    s = json.loads(capsys.readouterr().out)
    assert s['hosts'] == 2
    assert s['skew']['step_time_ratio'] == pytest.approx(2.0)
    assert s['steps'] == 8
    with open(tmp_path / 'efficiency.json', 'w') as f:
        json.dump({'mfu': 0.25, 'programs': {}}, f)
    s = report.summarize(report.load_run(str(tmp_path)))
    assert s['mfu'] == 0.25


def test_fence_devices_series_feeds_aggregate(tmp_path):
    """The port's fenced run: ``fence_devices`` on the one device lands
    in ``timings.json``, aggregates to one device row and a step-time
    ratio of exactly 1.0, renders as a fence counter track, and reaches
    the report and the diff's skew row."""
    from dgmc_tpu_torch.obs import RunObserver
    from dgmc_tpu_torch.obs import diff as diff_mod
    d = str(tmp_path / 'obs')
    x = torch.randn(16, 4)
    with RunObserver(d) as obs:
        for _ in range(3):
            with obs.step():
                out = (x * 2.0).sum()
            times = obs.fence_devices(out)
        assert sorted(times) == ['0']
        obs.log(1, loss=1.0)
    with open(os.path.join(d, 'timings.json')) as f:
        t = json.load(f)
    assert list(t['device_steps']) == ['0']
    assert t['device_steps']['0']['count'] == 3
    s = agg_mod.aggregate(d)
    assert s['hosts'] == 1 and len(s['devices']) == 1
    assert s['skew']['step_time_ratio'] == 1.0
    with open(os.path.join(d, 'trace.json')) as f:
        trace = json.load(f)
    assert {e['name'] for e in trace['traceEvents']
            if e.get('cat') == 'fence'} == {'device_step[0]'}
    agg_mod.write_aggregate(d, s)
    assert report.summarize(report.load_run(d))['skew'][
        'step_time_ratio'] == 1.0
    rc, out, _ = _call(diff_mod.main, [d, d, '--json'])
    rows = {r['metric']: r for r in json.loads(out)['rows']}
    assert rc == 0 and rows['skew_step_time_ratio']['status'] == 'ok'


def test_fence_devices_noops(tmp_path):
    from dgmc_tpu_torch.obs import RunObserver
    assert RunObserver(None).fence_devices(torch.ones(())) is None
    with RunObserver(str(tmp_path / 'obs')) as obs:
        assert obs.fence_devices(3.5) is None


def test_scrape_probes_advertised_endpoints(tmp_path):
    from dgmc_tpu_torch.obs.live import TelemetryServer
    h0 = _host(tmp_path, 'host_0', device_means=(0.1,))
    h1 = _host(tmp_path, 'host_1', device_means=(0.1,))
    _host(tmp_path, 'host_2', device_means=(0.1,))
    srv_ok = TelemetryServer(
        0, health_fn=lambda: {'healthy': True,
                              'heartbeat_age_s': 0.5}).start()
    srv_bad = TelemetryServer(
        0, health_fn=lambda: {'healthy': False}).start()
    dead_port = srv_bad.port

    def beat(d, when, port):
        with open(os.path.join(d, 'heartbeat.json'), 'w') as f:
            json.dump({'time': when, 'pid': 1, 'port': port}, f)
    try:
        beat(h0, 1.0, srv_ok.port)
        beat(h1, 1.0, srv_bad.port)
        s = agg_mod.aggregate(str(tmp_path), scrape=True)
        live0 = s['per_host']['host_0']['live']
        assert live0['healthy'] is True
        assert live0['heartbeat_age_s'] == 0.5
        assert s['per_host']['host_1']['live']['healthy'] is False
        assert 'live' not in s['per_host']['host_2']
        assert s['live_unhealthy_hosts'] == ['host_1']
        text = agg_mod.render(s)
        assert 'LIVE-UNHEALTHY HOSTS' in text
        assert f':{srv_ok.port} ok' in text
    finally:
        srv_ok.close()
        srv_bad.close()
    beat(h1, time.time(), dead_port)
    s = agg_mod.aggregate(str(tmp_path), scrape=True)
    live1 = s['per_host']['host_1']['live']
    assert live1.get('unreachable') is True and live1['port'] == dead_port
    assert 'host_1' in s['live_unhealthy_hosts']
    beat(h1, 1.0, dead_port)
    s = agg_mod.aggregate(str(tmp_path), scrape=True)
    assert s['per_host']['host_1']['live'].get('ended') is True
    assert 'host_1' not in s['live_unhealthy_hosts']
    assert f':{dead_port} ended' in agg_mod.render(s)


def test_without_scrape_no_live_blocks(tmp_path):
    h0 = _host(tmp_path, 'host_0', device_means=(0.1,))
    with open(os.path.join(h0, 'heartbeat.json'), 'w') as f:
        json.dump({'time': 1.0, 'pid': 1, 'port': 1}, f)
    s = agg_mod.aggregate(str(tmp_path))
    assert 'live' not in s['per_host']['host_0']
    assert 'live_unhealthy_hosts' not in s


# ---------------------------------------------------------------------------
# Parity with JAX's aggregate on the same dirs.
# ---------------------------------------------------------------------------

def _parity_roots(root):
    one = os.path.join(str(root), 'one')
    _host(one, None, device_means=(0.1, 0.1, 0.2, 0.1),
          dev_peaks=(1 << 30, 2 << 30))
    multi = os.path.join(str(root), 'multi')
    _host(multi, 'host_0', device_means=(0.1, 0.1),
          dev_peaks=(1 << 30, 1 << 30), wall=10.0)
    _host(multi, 'host_1', device_means=(0.1, 0.3), host_peak=5 << 30,
          wall=14.0)
    fallback = os.path.join(str(root), 'fallback')
    _host(fallback, 'host_0', p50=0.1, host_peak=1 << 30)
    _host(fallback, 'host_3', p50=0.4, host_peak=3 << 30)
    hung = os.path.join(str(root), 'hung')
    _hung_fence_root(hung)
    return one, multi, fallback, hung


def _aggregate_file(d):
    """``d``'s ``aggregate.json`` (removed), or ``None``."""
    path = os.path.join(d, 'aggregate.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        payload = json.load(f)
    os.remove(path)
    return payload


def test_main_matches_jax(tmp_path):
    for d in _parity_roots(tmp_path):
        for argv in ([d], [d, '--json'], [d, '--no-write', '--json']):
            theirs = jax_main('aggregate', argv)
            jax_file = _aggregate_file(d)
            ours = _call(agg_mod.main, argv)
            assert ours == theirs and ours[0] == 0
            assert _aggregate_file(d) == jax_file
            assert (jax_file is None) == ('--no-write' in argv)
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert _call(agg_mod.main, [str(empty)]) == \
        jax_main('aggregate', [str(empty)])
