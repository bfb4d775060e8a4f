"""The port's ``RunObserver`` and the four training CLIs' run plane, on the
CPU.

``RunObserver`` from each package, driven by the same script of calls,
writes the same artifacts with the same top-level keys; the flags of
``add_obs_flag`` / ``add_profile_flag`` are JAX's (without
``--fence-deadline``); the observer's contracts (a no-op without a
directory, the notices for plane flags without one, a taken port moving
the plane, the staleness verdict, the first offender); probes off leave
a train step's outputs bit-identical to a step run with no observer;
and each port CLI at tiny width with ``--obs-dir --probes`` writes the
artifacts while its ``/healthz`` answers 200, the guarded KG run naming
the injected fault's step and stage and dumping ``flight.json`` at the
rollback.
"""

import argparse
import json
import os
import socket

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.obs import live, probes
from dgmc_tpu_torch.obs.run import RunObserver, add_obs_flag
from dgmc_tpu_torch.obs.trace import add_profile_flag

TINY_KG = ['--device', 'cpu', '--synthetic', '--syn_nodes_s', '300',
           '--syn_nodes_t', '400', '--syn_edges_s', '1500', '--syn_edges_t',
           '1800', '--dim', '16', '--rnd_dim', '8', '--num_steps', '2']
TINY_KP = ['--device', 'cpu', '--f32', '--vgg_weights', 'none', '--dim', '16',
           '--rnd_dim', '8', '--num_layers', '1', '--num_steps', '2']
ARTIFACTS = {'metrics.jsonl', 'timings.json', 'memory.json', 'dispatch.json',
             'quality.json', 'trace.json', 'anomalies.json'}


@pytest.fixture(autouse=True)
def _one_intra_op_thread(monkeypatch):
    # The live plane of every observer here binds the loopback only.
    monkeypatch.setenv('DGMC_TPU_OBS_BIND', '127.0.0.1')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _top_keys(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        with open(path) as f:
            if name.endswith('.jsonl'):
                out[name] = sorted({k for line in f
                                    for k in json.loads(line)})
            else:
                out[name] = sorted(json.load(f))
    # The heartbeat carries steps_completed once the watchdog thread has
    # polled the run's context (in both packages): a matter of timing.
    out['heartbeat.json'] = [k for k in out.get('heartbeat.json', ())
                             if k != 'steps_completed']
    return out


def _script(obs_mod, registry_mod, directory, tmp_path):
    spec = tmp_path / 'slo.json'
    spec.write_text(json.dumps({'name': 't', 'availability': {
        'objective': 0.9}, 'latency': [{'name': 'step', 'threshold_ms':
                                        1000.0, 'objective': 0.9}]}))
    obs = obs_mod.RunObserver(directory, probes=True,
                              watchdog_deadline_s=30.0, obs_port=0)
    obs.attach_anomaly()
    obs.attach_slo(str(spec))
    for i in range(3):
        with obs.step():
            registry_mod.record_dispatch('topk', 'kernel', 'test')
    obs.log(1, loss=0.5, hits1=0.25)
    obs.quality_eval('dbp15k', {'count': 10, 'hits1': 0.25, 'loss': 0.5},
                     step=1)
    obs.snapshot_memory('epoch1')
    obs.set_gauge('guard_skip_count', 1)
    obs.flight_dump('test', extra={'why': 'script'})
    obs.watchdog.dump('test')
    assert live.probe_healthz(obs.live_port)[0] == 200
    obs.flush()
    obs.close()


def test_run_observer_writes_jax_artifacts_and_keys(tmp_path):
    from dgmc_tpu.obs import registry as j_registry
    from dgmc_tpu.obs import run as j_run
    from dgmc_tpu_torch.obs import registry
    from dgmc_tpu_torch.obs import run
    ours, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    _script(run, registry, ours, tmp_path)
    _script(j_run, j_registry, theirs, tmp_path)
    got, want = _top_keys(ours), _top_keys(theirs)
    assert got == want
    assert set(got) == ARTIFACTS | {'heartbeat.json', 'hang_report.json',
                                    'flight.json', 'slo.json'}
    with open(os.path.join(ours, 'dispatch.json')) as f:
        assert json.load(f)['counts'] == [
            {'kernel': 'topk', 'outcome': 'kernel', 'reason': 'test',
             'count': 3}]
    with open(os.path.join(ours, 'timings.json')) as f:
        t = json.load(f)
    assert t['steps']['steps'] == 3 and t['steps']['fenced_steps'] == 0


def _flags(add):
    p = argparse.ArgumentParser()
    add(p)
    return {tuple(a.option_strings): (a.dest, a.default, a.type)
            for a in p._actions if a.option_strings and a.dest != 'help'}


def test_flags_are_jax_flags_without_the_fence():
    from dgmc_tpu.obs.run import add_obs_flag as j_obs
    from dgmc_tpu.obs.trace import add_profile_flag as j_profile
    want = _flags(j_obs)
    del want[('--fence-deadline', '--fence_deadline')]
    got = _flags(add_obs_flag)
    assert {k: v[:2] for k, v in got.items()} == \
        {k: v[:2] for k, v in want.items()}
    assert set(_flags(add_profile_flag)) == set(_flags(j_profile))
    p = argparse.ArgumentParser()
    add_profile_flag(p)
    assert p.parse_args(['--profile-steps', '1:3']).profile_steps == (1, 3)
    with pytest.raises(SystemExit):
        p.parse_args(['--profile-steps', '3:1'])


def test_disabled_observer_is_a_no_op_with_notices(capsys):
    obs = RunObserver(None, watchdog_deadline_s=1.0, obs_port=0)
    err = capsys.readouterr().err
    assert '--watchdog-deadline is ignored without --obs-dir' in err
    assert '--obs-port is ignored without --obs-dir' in err
    with obs.step():
        pass
    obs.log(1, loss=1.0)
    assert obs.snapshot_memory('x') is None
    assert obs.fence_devices(torch.ones(())) is None
    assert obs.flight_dump('x') is None and obs.live_port is None
    obs.close()


def test_taken_port_moves_the_plane(tmp_path, capsys):
    holder = socket.socket()
    holder.bind(('127.0.0.1', 0))
    holder.listen(1)
    taken = holder.getsockname()[1]
    try:
        obs = RunObserver(str(tmp_path / 'obs'), obs_port=taken,
                          watchdog_deadline_s=30.0)
        try:
            assert obs.live_port not in (None, taken)
            assert 'moved to ephemeral port' in capsys.readouterr().err
            assert live.probe_healthz(obs.live_port)[0] == 200
            with open(tmp_path / 'obs' / 'heartbeat.json') as f:
                assert json.load(f)['port'] == obs.live_port
        finally:
            obs.close()
    finally:
        holder.close()


def test_stale_heartbeat_turns_healthz_503(tmp_path):
    obs = RunObserver(str(tmp_path / 'obs'), obs_port=0,
                      watchdog_deadline_s=60.0)
    try:
        assert live.probe_healthz(obs.live_port)[0] == 200
        obs.watchdog._last_event -= 3 * 60.0
        code, payload = live.probe_healthz(obs.live_port)
        assert code == 503 and payload['stale_after_s'] == 120.0
        metrics = obs.prometheus_metrics()
        assert 'dgmc_healthy 0' in metrics
        assert 'dgmc_step_latency_seconds_count 0' in metrics
    finally:
        obs.close()


def test_fence_records_the_device(tmp_path):
    obs = RunObserver(str(tmp_path / 'obs'))
    with obs.step():
        pass
    times = obs.fence_devices(torch.ones(()), tag=7)
    obs.close()
    assert list(times) == ['0']
    with open(tmp_path / 'obs' / 'timings.json') as f:
        assert json.load(f)['device_steps']['0']['count'] == 1


# -- probes through the observer -----------------------------------------------

def _pair(nan=False):
    r = np.random.RandomState(0)

    def side(n, e):
        x = r.randn(1, n, 4).astype(np.float32)
        return {'x': x, 'senders': r.randint(0, n, (1, e)).astype(np.int32),
                'receivers': r.randint(0, n, (1, e)).astype(np.int32),
                'node_mask': np.ones((1, n), bool),
                'edge_mask': np.ones((1, e), bool)}

    s, t = side(8, 16), side(10, 20)
    if nan:
        s['x'][0, 0, 0] = np.nan
    from dgmc_tpu_torch.utils.data import PairBatch
    return PairBatch(s=s, t=t, y=(np.arange(8, dtype=np.int32) % 10)[None],
                     y_mask=np.ones((1, 8), bool))


def _model(k):
    from dgmc_tpu_torch.models import DGMC, RelCNN
    return DGMC(RelCNN(4, 8, 1), RelCNN(4, 4, 1), num_steps=2, k=k,
                generator=torch.Generator().manual_seed(0))


def _run_steps(k, obs_dir=None, probes_on=False, n=3):
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    model = _model(k)
    state = create_train_state(model, learning_rate=1e-2)
    obs = RunObserver(obs_dir, probes=probes_on)
    outs = []
    with obs:
        step = make_train_step(model)
        for i in range(n):
            with obs.step():
                state, out = step(state, _pair(), i)
            outs.append({k_: v.clone() for k_, v in out.items()})
    return outs, model


@pytest.mark.parametrize('k', [-1, 3], ids=['dense', 'sparse'])
def test_probes_off_steps_are_bit_identical_to_no_observer(k, tmp_path):
    bare, m0 = _run_steps(k)
    observed, m1 = _run_steps(k, str(tmp_path / 'off'))
    probed, m2 = _run_steps(k, str(tmp_path / 'on'), probes_on=True)
    for a, b, c in zip(bare, observed, probed):
        assert a.keys() == b.keys() == c.keys()
        for key in a:
            assert torch.equal(a[key], b[key]) and torch.equal(a[key], c[key])
    for (name, p), q, r in zip(m0.state_dict().items(),
                               m1.state_dict().values(),
                               m2.state_dict().values()):
        assert torch.equal(p, q) and torch.equal(p, r), name
    with open(tmp_path / 'off' / 'timings.json') as f:
        assert 'probes' not in json.load(f)
    with open(tmp_path / 'on' / 'timings.json') as f:
        t = json.load(f)
    assert t['probes']['grad_norm']['count'] == 3
    assert t['probes']['nonfinite']['count'] == 3 * 6
    with open(tmp_path / 'on' / 'metrics.jsonl') as f:
        steps = [json.loads(line)['step'] for line in f]
    assert sorted(set(steps)) == [0, 1, 2]


def test_nonfinite_first_offender_is_psi1(tmp_path):
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    model = _model(-1)
    state = create_train_state(model, learning_rate=1e-3)
    obs = RunObserver(str(tmp_path / 'obs'), probes=True)
    with obs:
        step = make_train_step(model)
        with obs.step():
            step(state, _pair(), 0)
        with obs.step():
            step(state, _pair(nan=True), 1)
    assert obs.first_nonfinite == {'step': 1, 'stage': 'psi1', 'order': 0}
    assert not probes.enabled(), 'RunObserver leaked the probe switch'


def test_first_offender_uses_pipeline_order_not_arrival(tmp_path):
    obs = RunObserver(str(tmp_path / 'obs'), probes=True)
    with obs:
        obs._on_probe({'probe': 'nonfinite', 'value': 1.0, 'time': 0.0,
                       'stage': 'grad', 'order': 1001})
        obs._on_probe({'probe': 'nonfinite', 'value': 1.0, 'time': 0.0,
                       'stage': 'psi1', 'order': 0})
        assert obs.first_nonfinite['stage'] == 'psi1'
        obs._step_index = 3
        obs._on_probe({'probe': 'nonfinite', 'value': 1.0, 'time': 0.0,
                       'stage': 'psi1', 'order': 0})
        assert obs.first_nonfinite['step'] == 0


# -- the four CLIs -------------------------------------------------------------

class _Scrape:
    """A CLI hook that scrapes the run's ``/healthz`` after each train
    step (the port read from ``heartbeat.json``)."""

    def __init__(self, obs_dir):
        self.obs_dir = obs_dir
        self.codes = []

    def __call__(self, kind, index, out):
        if kind not in ('train', 'pretrain'):
            return
        with open(os.path.join(self.obs_dir, 'heartbeat.json')) as f:
            port = json.load(f)['port']
        self.codes.append(live.probe_healthz(port)[0])


def _obs_flags(obs_dir):
    return ['--obs-dir', obs_dir, '--probes', '--obs-port', '0',
            '--watchdog-deadline', '60']


def _check_artifacts(obs_dir, scrape, steps):
    assert ARTIFACTS <= set(os.listdir(obs_dir))
    assert scrape.codes and set(scrape.codes) == {200}
    with open(os.path.join(obs_dir, 'timings.json')) as f:
        t = json.load(f)
    assert t['steps']['steps'] == steps
    assert t['probes']['grad_norm']['count'] == steps
    assert t['compile']['events'] >= 1
    return t


def test_dbp15k_cli_observed_with_guard_and_fault(tmp_path, monkeypatch):
    from dgmc_tpu_torch.experiments import dbp15k
    obs_dir = str(tmp_path / 'obs')
    scrape = _Scrape(obs_dir)
    # Every flight.json dump's reason (a later anomaly dump may replace
    # the rollback's file).
    reasons = []
    dump = live.FlightRecorder.dump
    monkeypatch.setattr(live.FlightRecorder, 'dump',
                        lambda self, reason, **kw: (reasons.append(reason),
                                                    dump(self, reason,
                                                         **kw))[1])
    dbp15k.main(TINY_KG + _obs_flags(obs_dir) + [
        '--f32', '--epochs', '12', '--phase1_epochs', '10',
        '--guard-bad-steps', '1', '--inject-fault', 'nan-grads@11',
        '--profile-dir', str(tmp_path / 'prof'), '--profile-steps', '10:12'],
        hook=scrape)
    t = _check_artifacts(obs_dir, scrape, 12)
    # Optimizer step 11 is the observer's step index 10.
    assert t['first_nonfinite'] == {'step': 10, 'stage': 'grad',
                                    'order': 1001}
    assert 'guard-rollback' in reasons
    assert os.path.isfile(os.path.join(obs_dir, 'flight.json'))
    with open(os.path.join(obs_dir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert any(r.get('event') == 'rollback' for r in recs)
    assert t['probes']['consensus_delta']['count'] == 2 * 2
    with open(os.path.join(obs_dir, 'quality.json')) as f:
        q = json.load(f)
    assert q['headline']['scenario'] == 'dbp15k'
    assert q['consensus']['iterations'] == 2
    (trace_file,) = os.listdir(tmp_path / 'prof')
    with open(tmp_path / 'prof' / trace_file) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'dgmc_step#10', 'dgmc_step#11', 'consensus_iter', 'psi2',
            'topk'} <= names


def test_pascal_pf_cli_observed(tmp_path):
    from dgmc_tpu_torch.experiments import pascal_pf
    obs_dir = str(tmp_path / 'obs')
    scrape = _Scrape(obs_dir)
    pascal_pf.main(['--device', 'cpu', '--epochs', '1', '--dim', '16',
                    '--rnd_dim', '8', '--num_steps', '2', '--batch_size',
                    '512', '--synthetic_eval', '32', '--data_root',
                    str(tmp_path / 'none')] + _obs_flags(obs_dir),
                   hook=scrape)
    t = _check_artifacts(obs_dir, scrape, 2)
    # Every collation of the run in its padding bucket, real sizes beside.
    (bucket,) = [r for r in t['padding_buckets'] if r['batch'] == 512]
    assert bucket['nodes'] == '80x80' and bucket['edges'] == '640x640'
    assert bucket['count'] >= 2 and 0 < bucket['real_nodes_s'] <= \
        bucket['count'] * 512 * 80


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    from dgmc_tpu_torch.datasets.fixtures import write_voc, write_willow
    base = tmp_path_factory.mktemp('trees')
    return {'voc': write_voc(str(base / 'voc'), seed=1, train=4, val=2),
            'willow': write_willow(str(base / 'willow'), seed=2, items=21)}


def test_pascal_cli_observed(roots, tmp_path):
    from dgmc_tpu_torch.experiments import pascal
    obs_dir = str(tmp_path / 'obs')
    scrape = _Scrape(obs_dir)
    pascal.main(TINY_KP + ['--data_root', roots['voc'], '--batch_size', '16',
                           '--epochs', '1', '--test_samples', '10',
                           '--profile', str(tmp_path / 'prof')]
                + _obs_flags(obs_dir), hook=scrape)
    _check_artifacts(obs_dir, scrape, 5)
    assert len(os.listdir(tmp_path / 'prof')) == 1


def test_willow_cli_observed(roots, tmp_path):
    from dgmc_tpu_torch.experiments import willow
    obs_dir = str(tmp_path / 'obs')
    scrape = _Scrape(obs_dir)
    willow.main(TINY_KP + ['--voc_root', roots['voc'], '--willow_root',
                           roots['willow'], '--batch_size', '256',
                           '--pre_epochs', '1', '--epochs', '1', '--runs',
                           '1', '--test_samples', '8']
                + _obs_flags(obs_dir), hook=scrape)
    t = _check_artifacts(obs_dir, scrape, len(scrape.codes))
    assert set(t['compile']['by_label']) >= {'pretrain'}
    with open(os.path.join(obs_dir, 'quality.json')) as f:
        assert json.load(f)['headline']['scenario'] == 'willow'


# -- the cost account ----------------------------------------------------------

#: ``efficiency.json``'s top-level keys, as the JAX package writes them.
EFFICIENCY_KEYS = {'device_kind', 'platform', 'peak_flops', 'peak_flops_ref',
                   'peak_flops_source', 'programs', 'mfu'}


def _sample(text, family):
    for line in text.splitlines():
        if line.startswith(family + ' '):
            return float(line.split()[-1])
    return None


@pytest.mark.parametrize('k', [-1, 3], ids=['dense', 'sparse'])
def test_cost_account_goodput_and_gauges(k, tmp_path):
    """``record_cost`` → ``efficiency.json`` (JAX's keys; MFU from the
    observed step p50 against the CPU's nominal peak), ``goodput.json``
    weighted by the counted stage FLOPs, ``dgmc_mfu`` and
    ``dgmc_arith_intensity`` on ``/metrics`` from the same snapshot, and
    the SLO tracker fed the goodput ratio."""
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    from dgmc_tpu_torch.utils.data import Graph, GraphPair, pad_pair_batch
    obs_dir = str(tmp_path / 'obs')
    model = _model(k)
    state = create_train_state(model, learning_rate=1e-2)
    step = make_train_step(model)
    with RunObserver(obs_dir) as obs:
        obs.attach_slo({'name': 't', 'availability': {'objective': 0.9},
                        'goodput_floor': 0.5})
        summary = obs.record_cost('train_step', step, state, _pair(), 0)
        r = np.random.RandomState(1)
        pair = GraphPair(Graph(r.randint(0, 6, (2, 9)), r.randn(6, 4)),
                         Graph(r.randint(0, 7, (2, 11)), r.randn(7, 4)))
        pad_pair_batch([pair], 8, 16, 10, 20)
        for i in range(3):
            with obs.step():
                state, _ = step(state, _pair(), i)
        obs.flush()
        metrics = obs.prometheus_metrics()
        with open(os.path.join(obs_dir, 'efficiency.json')) as f:
            eff = json.load(f)
        with open(os.path.join(obs_dir, 'goodput.json')) as f:
            good = json.load(f)
        with open(os.path.join(obs_dir, 'slo.json')) as f:
            slo = json.load(f)
    assert set(eff) == EFFICIENCY_KEYS
    ts = eff['programs']['train_step']
    assert {s: r['flops'] for s, r in ts['stages'].items()} == {
        s: r['flops'] for s, r in summary['stages'].items()}
    p50 = ts['step_time_s']
    assert ts['step_time_source'] == 'observed_p50'
    # 4 significant digits of flops / (p50 x peak); the payload keeps p50
    # to the microsecond.
    assert eff['mfu'] == ts['mfu']
    assert ts['mfu'] == pytest.approx(ts['flops'] / (p50 * 48e9), rel=2e-3)
    assert _sample(metrics, 'dgmc_mfu') == eff['mfu']
    assert _sample(metrics, 'dgmc_arith_intensity') == ts['arith_intensity']
    assert good['composed_with_stage_flops'] is True
    assert 0 < good['goodput_ratio'] < 1
    (bucket,) = good['buckets']
    assert (bucket['nodes'], bucket['edges']) == ('8x10', '16x20')
    assert slo['floors']['goodput']['value'] == good['goodput_ratio']


def test_cost_refusal_is_recorded_not_raised(tmp_path):
    def broken(*args):
        raise RuntimeError('no count')
    with RunObserver(str(tmp_path / 'obs')) as obs:
        assert obs.record_cost('train_step', broken) == {
            'error': 'RuntimeError: no count'}
    with open(tmp_path / 'obs' / 'efficiency.json') as f:
        eff = json.load(f)
    assert eff['programs'] == {'train_step': {'error':
                                              'RuntimeError: no count'}}
    assert 'mfu' not in eff


def _hooked(main, argv):
    got = []

    def hook(kind, i, out):
        if isinstance(out, dict):   # metrics (willow also hands its model)
            got.append((kind, i, {k: v.clone() for k, v in out.items()
                                  if torch.is_tensor(v)}))
    main(argv, hook=hook)
    return got


def _same(a, b):
    return len(a) == len(b) and all(
        x[:2] == y[:2] and x[2].keys() == y[2].keys()
        and all(torch.equal(x[2][k], y[2][k]) for k in x[2])
        for x, y in zip(a, b))


@pytest.mark.parametrize('cli', ['dbp15k', 'pascal_pf', 'pascal', 'willow'])
def test_cli_losses_bit_identical_with_and_without_obs_dir(cli, roots,
                                                          tmp_path):
    """The cost count runs before each capture and leaves the run as it
    was: every step's and evaluation's metrics equal a run without
    ``--obs-dir``, and the observed run writes ``efficiency.json`` and
    ``goodput.json``."""
    import importlib
    main = importlib.import_module(f'dgmc_tpu_torch.experiments.{cli}').main
    argv = {
        'dbp15k': TINY_KG + ['--epochs', '3', '--phase1_epochs', '1'],
        'pascal_pf': ['--device', 'cpu', '--epochs', '1', '--dim', '16',
                      '--rnd_dim', '8', '--num_steps', '2', '--batch_size',
                      '256', '--synthetic_eval', '16', '--data_root',
                      str(tmp_path / 'none')],
        'pascal': TINY_KP + ['--data_root', roots['voc'], '--batch_size',
                             '16', '--epochs', '1', '--test_samples', '6'],
        'willow': TINY_KP + ['--voc_root', roots['voc'], '--willow_root',
                             roots['willow'], '--batch_size', '256',
                             '--pre_epochs', '1', '--epochs', '1', '--runs',
                             '1', '--test_samples', '4'],
    }[cli]
    obs_dir = str(tmp_path / 'obs')
    plain = _hooked(main, argv)
    observed = _hooked(main, argv + ['--obs-dir', obs_dir])
    assert plain and _same(plain, observed)
    with open(os.path.join(obs_dir, 'efficiency.json')) as f:
        eff = json.load(f)
    assert set(eff) == EFFICIENCY_KEYS
    assert eff['programs']['train_step']['flops'] > 0
    assert 'psi1' in eff['programs']['train_step']['stages']
    if cli == 'dbp15k':
        assert set(eff['programs']) == {'phase1_step', 'train_step'}
    with open(os.path.join(obs_dir, 'goodput.json')) as f:
        assert 0 < json.load(f)['goodput_ratio'] <= 1
