"""The port's run supervisor against the JAX package's.

``dgmc_tpu_torch.resilience.supervisor.Supervisor`` and JAX's
``dgmc_tpu.resilience.supervisor.Supervisor`` run the same scriptable
child scripts (those of ``tests/resilience/test_supervisor.py`` and
``test_live_supervision.py``) in each scenario there that the port has
(the ladder cases with the ``f32`` rung): the sequence of
``recovery.json`` events, the attempts (reason, exit code, step
evidence, environment overrides), the degradations and the outcome must
be equal. The flag helpers and the ``f32`` and ``shrink-mesh`` rungs
give JAX's argv and environment; JAX's ``disable-fused`` drops out of a
port ladder; ``supervise_cli`` gives JAX's child argv, its
``--fence-deadline`` included; no ``--supervise`` monitor touches CUDA.
The distributed half (the elastic restart, the ledger, the rank
monitors) is held against JAX's in ``tests/test_torch_elastic.py``. Then the real thing on the CPU: a supervised
DBP15K run killed by ``sigkill@N`` ends with the uninterrupted run's
last eval line and final checkpoint, bit for bit, and a supervised
worker killed by SIGKILL comes back with a corpus-cache hit and the same
answers.
"""

import argparse
import concurrent.futures
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

import dgmc_tpu.resilience.supervisor as jax_sup
import dgmc_tpu_torch.resilience.supervisor as sup
from dgmc_tpu.resilience.faults import ledger_dir as jax_ledger_dir
from dgmc_tpu_torch.resilience.faults import LEDGER_ENV, ledger_dir
from tests.resilience.test_live_supervision import CHILD as LIVE_CHILD
from tests.resilience.test_supervisor import CHILD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = {'port': sup, 'jax': jax_sup}
#: Event fields compared (times, pids and command strings differ).
EVENT_KEYS = ('event', 'attempt', 'reason', 'rung', 'number', 'backoff_s',
              'resume_from', 'restarts', 'max_restarts', 'signal',
              'steps_completed')


def _summary(rec):
    return {
        'outcome': rec['outcome'],
        'restarts': rec['restarts'],
        'degradations': [(d['rung'], d['attempt'])
                         for d in rec['degradations']],
        'attempts': [(a['attempt'], a['reason'], a['rc'],
                      a['steps_completed'], sorted(a['env_overrides']),
                      os.path.basename(a['obs_dir'] or ''))
                     for a in rec['attempts']],
        'events': [{k: e[k] for k in EVENT_KEYS if k in e}
                   for e in rec['events']],
    }


def _toy(tmp, attempts, argv=(), ckpt=False, **kw):
    child = tmp / 'child.py'
    child.write_text(CHILD)
    plan = tmp / 'plan.json'
    plan.write_text(json.dumps({'attempts': attempts}))
    argv = list(argv)
    if ckpt:
        argv += ['--ckpt_dir', str(tmp / 'ck')]
        kw['ckpt_dir'] = str(tmp / 'ck')
    return ([sys.executable, str(child), str(plan),
             str(tmp / 'counter.json')], argv, kw)


def _live(tmp, mode, **kw):
    child = tmp / 'child.py'
    child.write_text(LIVE_CHILD)
    kw.setdefault('max_restarts', 3)
    kw.setdefault('hang_deadline_s', 0.3)
    return ([sys.executable, str(child), str(tmp / 'counter.json'), mode],
            [], kw)


SCENARIOS = {
    'clean': lambda t: _toy(t, [{'action': 'ok'}]),
    'crashes-until-success': lambda t: _toy(
        t, [{'action': 'crash'}, {'action': 'crash'}, {'action': 'ok'}]),
    'death-by-signal': lambda t: _toy(
        t, [{'action': 'kill-self'}, {'action': 'ok'}]),
    'budget-exhausted': lambda t: _toy(
        t, [{'action': 'crash', 'rc': 7}], max_restarts=2),
    'stale-heartbeat': lambda t: _toy(
        t, [{'action': 'hang'}, {'action': 'ok'}], hang_deadline_s=0.3),
    'hang-report': lambda t: _toy(
        t, [{'action': 'hang-report'}, {'action': 'ok'}],
        hang_deadline_s=600.0),
    'ladder-same-step': lambda t: _toy(
        t, [{'action': 'crash', 'steps': 5}] * 3 + [{'action': 'ok',
                                                     'steps': 5}],
        ladder=('f32',)),
    'ladder-already-f32': lambda t: _toy(
        t, [{'action': 'crash', 'steps': 5}] * 3 + [{'action': 'ok',
                                                     'steps': 5}],
        argv=['--precision', 'f32'], ladder=('f32',)),
    'progressing-preemptions': lambda t: _toy(
        t, [{'action': 'crash', 'steps': 5, 'ckpt_step': 5},
            {'action': 'crash', 'steps': 5, 'ckpt_step': 10},
            {'action': 'crash', 'steps': 5, 'ckpt_step': 15},
            {'action': 'ok', 'steps': 5}],
        ckpt=True, ladder=('f32',)),
    'no-first-heartbeat': lambda t: _toy(
        t, [{'action': 'wedge-early'}, {'action': 'ok'}],
        hang_deadline_s=0.3, first_heartbeat_s=1.0),
    'healthz-503': lambda t: _live(t, 'unhealthy'),
    'healthy-endpoint-outranks-stale-file': lambda t: _live(t, 'healthy'),
    'healthz-500-is-a-failed-scrape': lambda t: _live(t, 'erroring'),
    'unreachable-port': lambda t: _live(t, 'dead-port'),
}


def _run(impl, tmp, scenario):
    os.makedirs(tmp)
    cmd, argv, kw = SCENARIOS[scenario](tmp)
    obs = tmp / 'obs'
    kw.setdefault('max_restarts', 5)
    s = IMPLS[impl].Supervisor(cmd, argv + ['--obs-dir', str(obs)],
                               obs_dir=str(obs), backoff_s=0.05,
                               grace_s=2.0, poll_s=0.05, **kw)
    rc = s.run()
    with open(obs / 'recovery.json') as f:
        return rc, _summary(json.load(f)), obs


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_recovery_matches_jax(scenario, tmp_path):
    # The port's monitor runs in a thread beside JAX's (off the main
    # thread a supervisor installs no signal handlers, which these
    # scenarios do not use).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run, 'port', tmp_path / 'port', scenario)
        want_rc, want, _ = _run('jax', tmp_path / 'jax', scenario)
        rc, got, obs = port.result()
    assert (rc, got) == (want_rc, want)
    if scenario == 'ladder-same-step':
        ev = [json.load(open(obs / f'attempt_{k}' / 'evidence.json'))
              for k in range(4)]
        assert [e['DGMC_TPU_DISABLE_FUSED'] for e in ev] == [None] * 4
        assert ['--f32' in e['argv'] for e in ev] \
            == [False, False, True, True]


@pytest.mark.parametrize('kind', ['transient', 'persistent'])
def test_spawn_failures_match_jax(kind, tmp_path, monkeypatch):
    results = []
    for impl in ('port', 'jax'):
        obs = tmp_path / impl / 'obs'
        if kind == 'transient':
            real = subprocess.Popen
            calls = {'n': 0}

            def flaky(*a, **kw):
                calls['n'] += 1
                if calls['n'] == 1:
                    raise OSError(11, 'Resource temporarily unavailable')
                return real(*a, **kw)

            monkeypatch.setattr(subprocess, 'Popen', flaky)
            cmd = [sys.executable, '-c', 'pass']
        else:
            cmd = ['/nonexistent-interpreter']
        s = IMPLS[impl].Supervisor(cmd, ['--obs-dir', str(obs)],
                                   obs_dir=str(obs), max_restarts=1,
                                   backoff_s=0.01, poll_s=0.05)
        rc = s.run()
        monkeypatch.undo()
        with open(obs / 'recovery.json') as f:
            results.append((rc, _summary(json.load(f))))
    assert results[0] == results[1]
    assert results[0][1]['attempts'][0][1].startswith('spawn-failed')


def test_stale_evidence_from_a_previous_run_matches_jax(tmp_path):
    results = []
    for impl in ('port', 'jax'):
        stale = tmp_path / impl / 'obs' / 'attempt_0'
        os.makedirs(stale)
        json.dump({'reason': 'deadline: no event for 600.0s'},
                  open(stale / 'hang_report.json', 'w'))
        json.dump({'time': time.time() - 3600, 'steps_completed': 1},
                  open(stale / 'heartbeat.json', 'w'))
        cmd, argv, _ = _toy(tmp_path / impl, [{'action': 'ok'}])
        obs = tmp_path / impl / 'obs'
        s = IMPLS[impl].Supervisor(cmd, argv + ['--obs-dir', str(obs)],
                                   obs_dir=str(obs), backoff_s=0.05,
                                   poll_s=0.05, hang_deadline_s=0.3)
        rc = s.run()
        with open(obs / 'recovery.json') as f:
            results.append((rc, _summary(json.load(f))))
    assert results[0] == results[1]
    assert results[0][1]['outcome'] == 'completed'


def test_supervisor_sigterm_is_forwarded_like_jax(tmp_path):
    """SIGTERM to the monitor kills the child and exits 128 + 15 with
    outcome ``preempted``, under either package."""
    procs, results = [], []
    for impl, module in (('port', 'dgmc_tpu_torch.resilience.supervisor'),
                         ('jax', 'dgmc_tpu.resilience.supervisor')):
        tmp = tmp_path / impl
        os.makedirs(tmp)
        cmd, _, _ = _toy(tmp, [{'action': 'hang'}])
        obs = tmp / 'obs'
        monitor = tmp / 'monitor.py'
        monitor.write_text(
            f'import sys\nsys.path.insert(0, {REPO!r})\n'
            f'from {module} import Supervisor\n'
            f'sup = Supervisor({cmd!r}, ["--obs-dir", {str(obs)!r}], '
            f'obs_dir={str(obs)!r}, backoff_s=0.05, poll_s=0.05, '
            f'grace_s=2.0)\n'
            f'print("READY", flush=True)\nsys.exit(sup.run())\n')
        procs.append((obs, subprocess.Popen(
            [sys.executable, str(monitor)], stdout=subprocess.PIPE,
            text=True)))
    try:
        # Both monitors run at once; each gets its SIGTERM once its
        # child beats.
        for obs, proc in procs:
            assert proc.stdout.readline().strip() == 'READY'
            deadline = time.time() + 30
            while time.time() < deadline and not (
                    obs / 'attempt_0' / 'heartbeat.json').exists():
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
        for obs, proc in procs:
            rc = proc.wait(timeout=30)
            with open(obs / 'recovery.json') as f:
                results.append((rc, _summary(json.load(f))))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert results[0] == results[1]
    assert results[0][0] == 128 + signal.SIGTERM
    assert results[0][1]['outcome'] == 'preempted'


# -- flags, rungs, the ledger home -------------------------------------------

ARGVS = [['--epochs', '3', '--supervise', '--max-restarts', '2',
          '--restart-backoff', '0.5', '--obs-dir', 'x'],
         ['--max_restarts=9', 'pos', '--no-elastic'],
         ['--obs_dir=a', '--precision=f32'], ['--obs-dir', 'a', '--f32'],
         ['--precision', 'f32'], ['--precision', 'bf16'], []]


@pytest.mark.parametrize('argv', ARGVS, ids=range(len(ARGVS)))
def test_flag_helpers_and_rungs_match_jax(argv):
    names = ('--obs-dir', '--obs_dir')
    for impl in (sup, jax_sup):
        assert impl.strip_supervisor_args(argv) \
            == jax_sup.strip_supervisor_args(argv)
        assert impl._replace_flag_value(argv, names, 'b') \
            == jax_sup._replace_flag_value(argv, names, 'b')
        assert impl._flag_value(argv, ('--precision',)) \
            == jax_sup._flag_value(argv, ('--precision',))
    for env in ({}, {LEDGER_ENV: 'l'}):
        for rung in ('f32', 'shrink-mesh'):
            got = sup.LADDER_RUNGS[rung](list(argv), dict(env))
            want = jax_sup.LADDER_RUNGS[rung](list(argv), dict(env))
            assert got[:2] == want[:2]
            assert (got[2] is None) == (want[2] is None)


def test_jax_ladders_keep_only_the_port_rungs():
    """The port has no ``disable-fused`` rung (its gates run the plain
    versions only for CPU tensors): a ladder naming it keeps ``f32`` and
    ``shrink-mesh``, in JAX's order, so no restart sets JAX's switch."""
    assert set(sup.LADDER_RUNGS) == set(jax_sup.LADDER_RUNGS) \
        - {'disable-fused'}
    assert sup.DEFAULT_LADDER == ('f32', 'shrink-mesh')
    cmd = [sys.executable, '-c', 'pass']
    assert sup.Supervisor(cmd, [], ladder=jax_sup.DEFAULT_LADDER).ladder \
        == ['f32', 'shrink-mesh']
    assert sup.Supervisor(cmd, [], ladder=('disable-fused',)).ladder == []


def test_ledger_home_matches_jax(tmp_path, monkeypatch):
    obs = str(tmp_path / 'obs')
    s = sup.Supervisor([sys.executable, '-c', 'pass'], [], obs_dir=obs)
    assert s._base_env[LEDGER_ENV] == obs
    for env in (None, obs):
        if env is None:
            monkeypatch.delenv(LEDGER_ENV, raising=False)
        else:
            monkeypatch.setenv(LEDGER_ENV, env)
        for ck, od in ((None, None), ('ck', None), (None, obs),
                       (None, os.path.join(obs, 'attempt_3')),
                       ('ck', os.path.join(obs, 'attempt_3')),
                       (None, os.path.join(obs, 'attempt_x'))):
            assert ledger_dir(ck, od) == jax_ledger_dir(ck, od)


def _supervise_argv(impl, monkeypatch, argv, obs_dir='o'):
    seen = {}

    def fake_run(self):
        seen['argv'], seen['cmd'] = self.argv, self.cmd
        seen['ladder'] = self.ladder
        return 0

    monkeypatch.setattr(impl.Supervisor, 'run', fake_run)
    args = argparse.Namespace(obs_dir=obs_dir, ckpt_dir='c',
                              watchdog_deadline=None, max_restarts=2,
                              restart_backoff=0.5, elastic=True,
                              fence_deadline=None)
    assert impl.supervise_cli('m', args, argv) == 0
    return seen


def test_supervise_cli_appends_no_fence_deadline(monkeypatch):
    """``supervise_cli`` gives JAX's child argv: the watchdog deadline
    and, beside it, JAX's ``--fence-deadline`` (the port's CLIs have the
    flag now), and JAX's default ladder less ``disable-fused``."""
    argv = ['--supervise', '--obs-dir', 'o', '--ckpt_dir', 'c',
            '--max-restarts', '2']
    got = _supervise_argv(sup, monkeypatch, argv)
    want = _supervise_argv(jax_sup, monkeypatch, argv)
    assert got['argv'] == want['argv'] == [
        '--obs-dir', 'o', '--ckpt_dir', 'c', '--watchdog-deadline', '600.0',
        '--fence-deadline', '600.0']
    assert got['cmd'] == want['cmd']
    assert got['ladder'] == ['f32', 'shrink-mesh']


def test_monitor_never_touches_cuda(monkeypatch):
    """Each ``--supervise`` entry point hands over to the supervisor
    before anything asks for the device: with every CUDA query made to
    raise, the five monitors reach ``Supervisor.run`` with their ladders
    and JAX's ``--fence-deadline`` appended beside the watchdog's."""
    from dgmc_tpu_torch.experiments import dbp15k, pascal, pascal_pf, willow
    from dgmc_tpu_torch.serve import service

    def touched(*a, **k):
        raise AssertionError('the monitor touched CUDA')

    monkeypatch.setattr(torch.cuda, 'is_available', touched)
    monkeypatch.setattr(torch.cuda, '_lazy_init', touched)
    monkeypatch.setattr(torch.cuda, 'init', touched)
    seen = []

    def fake_run(self):
        seen.append((self.cmd[-1], self.ladder, self.argv))
        return 0

    monkeypatch.setattr(sup.Supervisor, 'run', fake_run)
    argv = ['--supervise', '--obs-dir', 'o']
    for cli in (dbp15k, pascal_pf, pascal, willow):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 0
    assert service.main(argv + ['--ckpt_dir', 'c']) == 0
    assert [s[0] for s in seen] == [
        'dgmc_tpu_torch.experiments.dbp15k',
        'dgmc_tpu_torch.experiments.pascal_pf',
        'dgmc_tpu_torch.experiments.pascal',
        'dgmc_tpu_torch.experiments.willow', 'dgmc_tpu_torch.serve']
    assert [s[1] for s in seen] == [['f32', 'shrink-mesh']] \
        + [['f32']] * 3 + [[]]
    assert all(s[2][-4:] == ['--watchdog-deadline', '600.0',
                             '--fence-deadline', '600.0'] for s in seen)
    assert not torch.cuda.is_initialized()


# -- the real CLIs, supervised, on the CPU -----------------------------------

#: The verify skill's tiny KG size (as tests/test_torch_checkpoint.py).
KG_ARGV = ['--device', 'cpu', '--f32', '--synthetic', '--syn_nodes_s', '300',
           '--syn_nodes_t', '400', '--syn_edges_s', '1500', '--syn_edges_t',
           '1800', '--dim', '16', '--rnd_dim', '8', '--num_steps', '3',
           '--epochs', '12', '--phase1_epochs', '10', '--ckpt_every', '4']


def _env():
    # One intra-op thread in every process: a CPU reduction's bits
    # depend on the count, and the runs compared must share it.
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                MKL_NUM_THREADS='1')


def _py(args):
    return subprocess.Popen([sys.executable, '-m'] + args, cwd=REPO,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _eval_lines(out):
    return [re.sub(r' \([0-9.]+s/epoch\)', '', line)
            for line in out.splitlines() if re.match(r'\d{3}: Loss', line)]


def test_supervised_dbp15k_sigkill_ends_as_uninterrupted(tmp_path):
    mod = 'dgmc_tpu_torch.experiments.dbp15k'
    obs = tmp_path / 'obs'
    # The uninterrupted run and the supervised one, side by side.
    procs = [_py([mod] + KG_ARGV + ['--ckpt_dir', str(tmp_path / 'A')]),
             _py([mod, '--supervise', '--restart-backoff', '0.05']
                 + KG_ARGV + ['--ckpt_dir', str(tmp_path / 'B'),
                              '--obs-dir', str(obs), '--inject-fault',
                              'sigkill@11'])]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
        ref, run = [subprocess.CompletedProcess(p.args, p.returncode, *o)
                    for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert run.returncode == 0, run.stderr[-2000:]
    with open(obs / 'recovery.json') as f:
        rec = json.load(f)
    assert rec['outcome'] == 'completed' and rec['restarts'] == 1
    assert [a['reason'] for a in rec['attempts']] \
        == ['signal:SIGKILL', 'completed']
    assert [e['event'] for e in rec['events']] \
        == ['start', 'failure', 'restart', 'start', 'complete']
    assert run.stderr.count('[faults] firing sigkill@11') == 1
    with open(tmp_path / 'B' / 'faults_fired.json') as f:
        assert json.load(f)['fired'] == ['sigkill@11']
    assert _eval_lines(run.stdout)[-1] == _eval_lines(ref.stdout)[-1]
    a = torch.load(tmp_path / 'A' / '12' / 'state.pt', weights_only=True)
    b = torch.load(tmp_path / 'B' / '12' / 'state.pt', weights_only=True)
    for k, v in a['model'].items():
        assert torch.equal(v, b['model'][k]), k


def test_supervised_worker_restarts_warm(tmp_path):
    from dgmc_tpu_torch.serve.client import (discover_endpoint, get_json,
                                             post_match, query_payload,
                                             sample_query)
    from dgmc_tpu_torch.serve.corpus import synthetic_corpus
    obs = tmp_path / 'obs'
    argv = ['dgmc_tpu_torch.serve', '--supervise', '--device', 'cpu',
            '--restart-backoff', '0.05', '--ckpt_dir', str(tmp_path / 'ck'),
            '--init-missing', '--corpus-nodes', '256', '--corpus-edges',
            '1024', '--corpus-dim', '16', '--dim', '16', '--rnd_dim', '8',
            '--num_layers', '1', '--num_steps', '2', '--k', '5',
            '--buckets', '8x16', '--max-results', '3', '--obs-dir',
            str(obs), '--obs-port', '0', '--watchdog-deadline', '30']
    proc = subprocess.Popen([sys.executable, '-m'] + argv, cwd=REPO,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    x = synthetic_corpus(256, 1024, 16).x
    queries = [query_payload(sample_query(x, 6, 12, seed=s)[0])
               for s in range(3)]

    def strip(resp):
        return {k: v for k, v in resp.items() if k not in (
            'latency_ms', 'client_ms', 'trace_id', 'trace_ms', 'stages_ms',
            'server_traceparent')}

    def ready(attempt):
        deadline = time.time() + 120
        while time.time() < deadline:
            found = discover_endpoint(str(obs))
            if found and (obs / f'attempt_{attempt}' / 'heartbeat.json'
                          ).exists():
                hb = json.load(open(obs / f'attempt_{attempt}'
                                    / 'heartbeat.json'))
                res = hb.get('port') and get_json(hb['port'], '/healthz')
                # The gauge goes up just before /match stops answering
                # 503 (warming), as in the JAX worker.
                if res and (res[1].get('gauges') or {}).get('serve_ready') \
                        and post_match(hb['port'], queries[0])[0] == 200:
                    return hb['port'], hb['pid'], res[1]['gauges']
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            time.sleep(0.2)
        raise AssertionError(f'attempt {attempt} never became ready')

    try:
        port, pid, gauges = ready(0)
        assert gauges['corpus_cache_hit'] == 0
        first = [post_match(port, q) for q in queries]
        assert all(code == 200 for code, _ in first)
        os.kill(pid, signal.SIGKILL)
        port, pid2, gauges = ready(1)
        assert pid2 != pid and gauges['corpus_cache_hit'] == 1
        again = [post_match(port, q) for q in queries]
        assert [strip(r) for _, r in again] == [strip(r) for _, r in first]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 128 + signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(obs / 'recovery.json') as f:
        rec = json.load(f)
    assert [a['reason'] for a in rec['attempts']][:1] == ['signal:SIGKILL']
    assert rec['outcome'] == 'preempted'
    for name in ('qtrace.jsonl', 'capacity.json', 'quality.json'):
        assert (obs / 'attempt_1' / name).exists(), name
