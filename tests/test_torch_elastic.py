"""The supervisor's distributed half, the port against the JAX package,
then the real thing on the CPU.

The fast scenarios of the JAX package's ``tests/resilience/test_elastic.py``
(a hang, the ``--row_shards`` spelling, the fence rc, a plain crash,
``--no-elastic``, an unshrinkable mesh, the tombstone reclassification,
the two-host simulation, no first heartbeat, the own child's staleness,
a follower adopting the leader's decision, the cleared control dir)
run under ``dgmc_tpu_torch.resilience.supervisor.Supervisor`` and JAX's,
with the toy children of ``tests/resilience/test_supervisor.py`` and
``test_elastic.py``: the ``recovery.json`` events, the ``elastic``
entries and ``ledger.json`` must be equal (less times and pids). Where
two classification orders are both valid (the poll loop or the
post-mortem can see a tombstone first), each package must give one of
them and the same shrink.

The port's own case: one monitor per rank on toy children, the follower
adopting the decision and retiring, both exiting 0, and the leader's
``recovery.json`` the file ``obs.report`` reads.

Then the KG CLI (``dbp15k --synthetic --row_shards 2`` at a tiny width,
two gloo ranks, one intra-op thread each): ``peer-death@4`` on rank 1
under one ``--supervise`` monitor a rank shrinks the world to one rank,
which resumes from the epoch-3 checkpoint and ends with the control's
final checkpoint, bit for bit (two ranks to epoch 3, then one rank);
``collective-stall@2:120`` under ``--fence-deadline 5``: both ranks exit
67 — the stalled rank's guard fires in the stall, the waiting rank's in
its collective (gloo raises when the stalled rank exits; the fence
holds that until the deadline) — each with a report of JAX's
``FenceGuard`` keys naming the other rank as missing, and
``obs.aggregate``'s output on that directory equal to JAX's; one rank of
a declared world of two under ``--fence-deadline 2`` exits 67 with a
``distributed-init`` report; a plain crash restarts both ranks on the
same world, rebinding the coordinator's port at once.

Every comparison is exact.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

import dgmc_tpu.resilience.distributed_guard as jax_dg
import dgmc_tpu.resilience.supervisor as jax_sup
import dgmc_tpu_torch.resilience.distributed_guard as dg
import dgmc_tpu_torch.resilience.supervisor as sup
from dgmc_tpu_torch.obs import aggregate as agg_mod
from dgmc_tpu_torch.obs import report as report_mod
from tests.resilience.test_supervisor import CHILD
from tests.test_torch_diff import _call, jax_main
from tests.torch_dist_worker import ROOT, free_port

IMPLS = {'port': (sup, dg), 'jax': (jax_sup, jax_dg)}
EVENT_KEYS = ('event', 'attempt', 'reason', 'rung', 'number', 'backoff_s',
              'resume_from', 'restarts', 'max_restarts', 'signal',
              'steps_completed', 'detail')


def _record(obs, host=0, impl='port'):
    """A supervisor's record: the port keeps a follower's at
    ``host_<i>/recovery.json``, JAX every host's at the root."""
    path = sup.recovery_path(str(obs), host) if impl == 'port' \
        else os.path.join(obs, 'recovery.json')
    with open(path) as f:
        return json.load(f)


def _ledger(obs):
    try:
        with open(obs / 'control' / 'ledger.json') as f:
            led = json.load(f)
    except FileNotFoundError:
        return None
    return dict(led, decisions=[{k: v for k, v in d.items() if k != 'time'}
                                for d in led['decisions']])


def _evidence(obs, attempt):
    with open(obs / f'attempt_{attempt}' / 'evidence.json') as f:
        return json.load(f)['argv']


def _summary(rc, rec, obs):
    return {
        'rc': rc, 'outcome': rec['outcome'], 'restarts': rec['restarts'],
        'attempts': [(a['attempt'], a['reason'], a['rc'],
                      a['steps_completed']) for a in rec['attempts']],
        'events': [{k: e[k] for k in EVENT_KEYS if k in e}
                   for e in rec['events']],
        'elastic': rec['elastic'],
        'degradations': rec['degradations'],
        'ledger': _ledger(obs),
        'argv': [_evidence(obs, k)[:-2] for k in range(len(rec['attempts']))
                 if (obs / f'attempt_{k}' / 'evidence.json').exists()],
    }


def _toy(impl, tmp, attempts, argv=(), host=0, **kw):
    """JAX's ``_supervise`` under ``impl``'s supervisor."""
    child = tmp / 'child.py'
    child.write_text(CHILD)
    plan = tmp / 'plan.json'
    plan.write_text(json.dumps({'attempts': attempts}))
    obs = tmp / 'obs'
    s = IMPLS[impl][0].Supervisor(
        [sys.executable, str(child), str(plan), str(tmp / 'counter.json')],
        list(argv) + ['--obs-dir', str(obs)], obs_dir=str(obs),
        max_restarts=5, backoff_s=0.05, grace_s=2.0, poll_s=0.05,
        ladder=(), host_index=host, **kw)
    rc = s.run()
    return _summary(rc, _record(obs, host, impl), obs)


#: ``tests/resilience/test_elastic.py``'s child that beats as host 0,
#: tombstones host 1 and dies by SIGKILL on its first attempt.
TOMB_CHILD = r'''
import json, os, signal, sys, time
argv = sys.argv[1:]
obs_dir = argv[argv.index('--obs-dir') + 1]
k_path = os.path.join(os.path.dirname(obs_dir.rstrip('/')), 'k.json')
k = 0
if os.path.exists(k_path):
    k = json.load(open(k_path))['k'] + 1
json.dump({'k': k}, open(k_path, 'w'))
os.makedirs(obs_dir, exist_ok=True)
json.dump({'argv': argv}, open(os.path.join(obs_dir, 'evidence.json'),
                               'w'))
cdir = os.path.join(obs_dir, 'control')
os.makedirs(cdir, exist_ok=True)
json.dump({'host': 0, 'pid': os.getpid(), 'time': time.time(),
           'phase': 'step', 'step': 3},
          open(os.path.join(cdir, 'host_0.json'), 'w'))
if k == 0:
    json.dump({'host': 1, 'time': time.time(), 'step': 3,
               'reason': 'peer-death'},
              open(os.path.join(cdir, 'host_1.tombstone.json'), 'w'))
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(0)
'''

#: ``tests/resilience/test_elastic.py``'s two-host simulation: the child
#: beats as host 0 until killed; an independent host-1 process beats for
#: a while, then dies.
BEAT_CHILD = r'''
import json, os, sys, time
argv = sys.argv[1:]
obs_dir = argv[argv.index('--obs-dir') + 1]
k_path = os.path.join(os.path.dirname(obs_dir.rstrip('/')), 'k.json')
k = 0
if os.path.exists(k_path):
    k = json.load(open(k_path))['k'] + 1
json.dump({'k': k}, open(k_path, 'w'))
os.makedirs(obs_dir, exist_ok=True)
json.dump({'argv': argv}, open(os.path.join(obs_dir, 'evidence.json'),
                               'w'))
cdir = os.path.join(obs_dir, 'control')
os.makedirs(cdir, exist_ok=True)

def beat(step):
    p = os.path.join(cdir, 'host_0.json')
    json.dump({'host': 0, 'pid': os.getpid(), 'time': time.time(),
               'phase': 'step', 'step': step}, open(p + '.tmp', 'w'))
    os.replace(p + '.tmp', p)

if k == 0:
    open(os.path.join(obs_dir, 'ready'), 'w').close()
    for step in range(1, 10000):
        beat(step)
        time.sleep(0.05)
beat(1)
sys.exit(0)
'''
HOST1 = r'''
import json, os, sys, time
cdir, beats = sys.argv[1], int(sys.argv[2])
os.makedirs(cdir, exist_ok=True)
for step in range(1, beats + 1):
    p = os.path.join(cdir, 'host_1.json')
    json.dump({'host': 1, 'pid': os.getpid(), 'time': time.time(),
               'phase': 'step', 'step': step}, open(p + '.tmp', 'w'))
    os.replace(p + '.tmp', p)
    time.sleep(0.05)
'''


def _script_child(impl, tmp, script, shards, **kw):
    child = tmp / 'child.py'
    child.write_text(script)
    obs = tmp / 'obs'
    s = IMPLS[impl][0].Supervisor(
        [sys.executable, str(child)],
        ['--model_shards', str(shards), '--obs-dir', str(obs)],
        obs_dir=str(obs), backoff_s=0.05, poll_s=0.05, grace_s=2.0, **kw)
    return s, obs


def _tombstone(impl, tmp):
    s, obs = _script_child(impl, tmp, TOMB_CHILD, 8)
    out = _summary(s.run(), _record(obs), obs)
    # Two valid orders: the poll loop sees the tombstone first
    # ('peer-death:host_1', a kill event) or the post-mortem reclassifies
    # the SIGKILL ('peer-death:host_1 (signal:SIGKILL)').
    reason = out['attempts'][0][1]
    assert reason in ('peer-death:host_1',
                      'peer-death:host_1 (signal:SIGKILL)'), reason
    for e in out['elastic']:
        e['reason'] = e['reason'].split(' ')[0]
    return {k: out[k] for k in ('rc', 'outcome', 'restarts', 'elastic',
                                'argv')}


def _two_hosts(impl, tmp):
    s, obs = _script_child(impl, tmp, BEAT_CHILD, 2, peer_stale_s=0.6)
    host1 = tmp / 'host1.py'
    host1.write_text(HOST1)
    result = {}
    t = threading.Thread(target=lambda: result.update(rc=s.run()))
    t.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and not (
                obs / 'attempt_0' / 'ready').exists():
            time.sleep(0.02)
        assert (obs / 'attempt_0' / 'ready').exists()
        subprocess.run([sys.executable, str(host1),
                        str(obs / 'attempt_0' / 'control'), '10'],
                       timeout=60, check=True)
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    return _summary(result['rc'], _record(obs), obs)


def _follower(impl, tmp):
    obs = tmp / 'obs'
    m = IMPLS[impl][1]
    os.makedirs(m.control_dir(str(obs)))
    m.RecoveryLedger(m.control_dir(str(obs)), host_index=0).decide(
        1, 'peer-death:host_2', mesh={'shards': 2})
    return _toy(impl, tmp, [{'action': 'crash'}, {'action': 'ok'}],
                argv=['--model_shards', '8'], host=1, elastic=False)


def _own_staleness(impl, tmp):
    s = IMPLS[impl][0].Supervisor(['true'], [], obs_dir=str(tmp / 'obs'),
                                  host_index=0, peer_stale_s=0.5)
    cdir = str(tmp / 'cdir')
    os.makedirs(cdir)
    now, seen = time.time(), []
    for own, peer in ((now - 60, now), (now, now - 60)):
        for h, t in ((0, own), (1, peer)):
            with open(os.path.join(cdir, f'host_{h}.json'), 'w') as f:
                json.dump({'host': h, 'time': t}, f)
        seen.append(s._dead_peer(cdir))
    return seen


def _clear_control(impl, tmp):
    s = IMPLS[impl][0].Supervisor(['true'], [], obs_dir=str(tmp / 'obs'))
    cdir = tmp / 'cdir'
    os.makedirs(cdir)
    old = cdir / 'host_1.json'
    old.write_text('{"host": 1, "time": 1}')
    os.utime(old, (time.time() - 3600, time.time() - 3600))
    (cdir / 'host_0.tombstone.json').write_text('{"host": 0, "time": 1}')
    s._clear_control_dir(str(cdir))
    return sorted(os.listdir(cdir))


SCENARIOS = {
    'hang': lambda i, t: _toy(i, t, [{'action': 'hang'}, {'action': 'ok'}],
                              argv=['--model_shards', '4'],
                              hang_deadline_s=0.3),
    'row-shards-spelling': lambda i, t: _toy(
        i, t, [{'action': 'hang'}, {'action': 'ok'}],
        argv=['--row_shards', '8'], hang_deadline_s=0.3),
    'fence-rc': lambda i, t: _toy(
        i, t, [{'action': 'crash', 'rc': 67}, {'action': 'ok'}],
        argv=['--model_shards', '2']),
    'plain-crash': lambda i, t: _toy(
        i, t, [{'action': 'crash'}, {'action': 'ok'}],
        argv=['--model_shards', '4']),
    'no-elastic': lambda i, t: _toy(
        i, t, [{'action': 'hang'}, {'action': 'ok'}],
        argv=['--model_shards', '4'], hang_deadline_s=0.3, elastic=False),
    'unshrinkable': lambda i, t: _toy(
        i, t, [{'action': 'hang'}, {'action': 'ok'}],
        argv=['--model_shards', '1'], hang_deadline_s=0.3),
    'tombstone-reclassification': _tombstone,
    'two-host-simulation': _two_hosts,
    'no-first-heartbeat': lambda i, t: _toy(
        i, t, [{'action': 'wedge-early'}, {'action': 'ok'}],
        argv=['--model_shards', '4'], hang_deadline_s=0.3,
        first_heartbeat_s=1.0),
    'own-child-staleness': _own_staleness,
    'follower-adopts-leader': _follower,
    'clear-control-spares-session': _clear_control,
}


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_elastic_matches_jax(scenario, tmp_path):
    # The port's supervisor in a thread beside JAX's (off the main thread
    # a supervisor installs no signal handlers, which these do not use).
    for impl in IMPLS:
        os.makedirs(tmp_path / impl)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(SCENARIOS[scenario], 'port', tmp_path / 'port')
        want = SCENARIOS[scenario]('jax', tmp_path / 'jax')
        got = port.result()
    assert got == want
    if scenario in ('hang', 'two-host-simulation'):
        assert want['elastic'][0]['detail'] == (
            '--model_shards 4 -> 2 (shrink the mesh)' if scenario == 'hang'
            else '--model_shards 2 -> 1 (shrink the mesh)')
        assert want['ledger']['mesh'] == {
            'shards': 2 if scenario == 'hang' else 1}
    if scenario == 'follower-adopts-leader':
        assert any(e['event'] == 'ledger-adopt' for e in want['events'])
        assert want['argv'][1][-1] == '2'


def test_shrink_resizes_the_world_and_drops_the_rendezvous():
    """The port's world flags beside JAX's rung: ``--num_processes``
    halves with the shard flag, and a world of one keeps no
    ``--coordinator`` / ``--process_id``."""
    argv = ['--row_shards', '4', '--coordinator', 'h:1', '--num_processes',
            '4', '--process_id', '3', '--epochs', '5']
    got, _, desc = sup.LADDER_RUNGS['shrink-mesh'](argv, {})
    assert desc == '--row_shards 4 -> 2 (shrink the mesh)'
    assert got == ['--row_shards', '2', '--coordinator', 'h:1',
                   '--num_processes', '2', '--process_id', '3', '--epochs',
                   '5']
    got, _, desc = sup.LADDER_RUNGS['shrink-mesh'](got, {})
    assert got == ['--row_shards', '1', '--num_processes', '1', '--epochs',
                   '5']
    assert sup.LADDER_RUNGS['shrink-mesh'](got, {})[2] is None
    plain = ['--model_shards=8', '--epochs', '5']
    assert sup.LADDER_RUNGS['shrink-mesh'](plain, {})[0] \
        == jax_sup.LADDER_RUNGS['shrink-mesh'](plain, {})[0]


#: One rank of a toy world of two: rank 1 tombstones itself and dies by
#: SIGKILL on the first attempt, rank 0 beats until its monitor kills it;
#: the next attempt exits 0.
RANK_CHILD = r'''
import json, os, signal, sys, time
argv = sys.argv[1:]
obs_dir = argv[argv.index('--obs-dir') + 1]
rank = int(argv[argv.index('--process_id') + 1]) \
    if '--process_id' in argv else 0
k_path = os.path.join(os.path.dirname(obs_dir.rstrip('/')),
                      f'k{rank}.json')
k = json.load(open(k_path))['k'] + 1 if os.path.exists(k_path) else 0
json.dump({'k': k}, open(k_path, 'w'))
mine = os.path.join(obs_dir, f'host_{rank}')
os.makedirs(mine, exist_ok=True)
json.dump({'argv': argv}, open(os.path.join(mine, 'evidence.json'), 'w'))
cdir = os.path.join(obs_dir, 'control')
os.makedirs(cdir, exist_ok=True)
p = os.path.join(cdir, f'host_{rank}.json')
json.dump({'host': rank, 'time': time.time(), 'step': 3},
          open(p + '.tmp', 'w'))
os.replace(p + '.tmp', p)
if k == 0 and rank == 1:
    time.sleep(0.5)
    json.dump({'host': 1, 'time': time.time(), 'step': 4,
               'reason': 'peer-death'},
              open(os.path.join(cdir, 'host_1.tombstone.json'), 'w'))
    os.kill(os.getpid(), signal.SIGKILL)
if k == 0:
    time.sleep(60)
sys.exit(0)
'''


def test_rank_monitors_shrink_and_the_follower_retires(tmp_path):
    child = tmp_path / 'child.py'
    child.write_text(RANK_CHILD)
    obs = tmp_path / 'obs'
    monitors, rcs = [], {}
    for rank in (0, 1):
        argv = ['--row_shards', '2', '--coordinator', '127.0.0.1:1',
                '--num_processes', '2', '--process_id', str(rank),
                '--obs-dir', str(obs)]
        monitors.append(sup.Supervisor(
            [sys.executable, str(child)], argv, obs_dir=str(obs),
            backoff_s=0.05, poll_s=0.05, grace_s=2.0, host_index=rank))
    threads = [threading.Thread(target=lambda m=m: rcs.update(
        {m.host_index: m.run()})) for m in monitors]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert rcs == {0: 0, 1: 0}
    lead, follow = _record(obs, 0), _record(obs, 1)
    assert not os.path.exists(obs / 'host_0')
    assert lead['outcome'] == 'completed' and lead['restarts'] == 1
    assert lead['attempts'][0]['reason'].startswith('peer-death:host_1')
    assert [e['detail'] for e in lead['elastic']] \
        == ['--row_shards 2 -> 1 (shrink the mesh)']
    with open(obs / 'attempt_1' / 'host_0' / 'evidence.json') as f:
        assert json.load(f)['argv'][:4] == ['--row_shards', '1',
                                            '--num_processes', '1']
    assert follow['outcome'] == 'retired'
    assert [e['event'] for e in follow['events']][-2:] \
        == ['elastic-shrink', 'retire']
    assert follow['events'][-1]['world'] == 1
    assert follow['attempts'][0]['reason'].startswith('peer-death:host_1')
    led = _ledger(obs)
    assert led['mesh'] == {'shards': 1} and led['attempt'] == 1
    # The leader's record is the run's: obs.report reads it.
    run = report_mod.load_run(str(obs))
    assert run['recovery']['outcome'] == 'completed'
    rc, out, _ = _call(report_mod.main, [str(obs)])
    assert rc == 0 and 'elastic shrink' in out


# -- the KG CLI on two gloo ranks --------------------------------------------

TINY = ['--synthetic', '--device', 'cpu', '--syn_nodes_s', '300',
        '--syn_nodes_t', '400', '--syn_edges_s', '1500', '--syn_edges_t',
        '1800', '--dim', '16', '--rnd_dim', '8', '--num_steps', '3',
        '--phase1_epochs', '1', '--f32']
LINE = re.compile(r'^(\d{3}): Loss: [\d.]+, Hits@1: [\d.]+, '
                  r'Hits@10: [\d.]+')


def _cli(argv, supervise=False):
    """``dbp15k`` in a fresh process at one intra-op thread."""
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               PYTHONPATH=ROOT)
    cmd = [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k',
           *(['--supervise', '--restart-backoff', '0.1'] if supervise
             else []), *TINY, *argv]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ranks(argv, world=2, extra=None, supervise=False):
    port = free_port()
    return [_cli(argv + ['--row_shards', str(world), '--coordinator',
                         f'127.0.0.1:{port}', '--num_processes', str(world),
                         '--process_id', str(r)]
                 + (extra or {}).get(r, []), supervise)
            for r in range(world)]


def _done(procs, timeout=240):
    out = [p.communicate(timeout=timeout) for p in procs]
    return [(p.returncode, *o) for p, o in zip(procs, out)]


def _lines(out):
    return [re.sub(r' \([0-9.]+s/epoch\)', '', line)
            for line in out.splitlines() if LINE.match(line)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Side by side: the control's first leg (two ranks, epochs 1-3), the
    supervised elastic run, the fence stall, the lone rank, the
    same-world restart; the control's resume leg (one rank, epochs 4-5)
    once its first leg is done."""
    tmp = tmp_path_factory.mktemp('elastic')
    ck = {'control': str(tmp / 'ck_control'), 'elastic': str(tmp / 'ck')}
    every = ['--ckpt_every', '1']
    started = {
        'control': _ranks(['--epochs', '3', '--ckpt_dir', ck['control'],
                           '--obs-dir', str(tmp / 'obs_control')] + every),
        'elastic': _ranks(['--epochs', '5', '--ckpt_dir', ck['elastic'],
                           '--obs-dir', str(tmp / 'obs')] + every,
                          extra={1: ['--inject-fault', 'peer-death@4']},
                          supervise=True),
        'fence': _ranks(['--epochs', '2', '--fence-deadline', '5',
                         '--obs-dir', str(tmp / 'obs_fence')],
                        extra={1: ['--inject-fault',
                                   'collective-stall@2:120']}),
        'lone': [_cli(['--epochs', '1', '--row_shards', '2',
                       '--coordinator', f'127.0.0.1:{free_port()}',
                       '--num_processes', '2', '--process_id', '0',
                       '--fence-deadline', '2', '--obs-dir',
                       str(tmp / 'obs_lone')])],
        'restart': _ranks(
            ['--epochs', '3', '--ckpt_dir', str(tmp / 'ck_restart'),
             '--obs-dir', str(tmp / 'obs_restart')] + every,
            extra={1: ['--inject-fault', 'raise@3']}, supervise=True)}
    t0 = time.monotonic()

    def finish(p):
        stdout, stderr = p.communicate(timeout=240)
        return p.returncode, stdout, stderr, time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(12) as pool:
        done = {k: [pool.submit(finish, p) for p in procs]
                for k, procs in started.items()}
        for f in done['control']:
            f.result()
        done['resume'] = [pool.submit(finish, _cli(
            ['--epochs', '5', '--ckpt_dir', ck['control'], '--row_shards',
             '1', '--num_processes', '1', '--obs-dir',
             str(tmp / 'obs_resume')] + every))]
        done = {k: [f.result() for f in fs] for k, fs in done.items()}
    out = {k: [r[:3] for r in rs] for k, rs in done.items()}
    took = {k: [r[3] for r in rs] for k, rs in done.items()}
    print('seconds to the end of each run:', took)
    out.update(tmp=tmp, ck=ck, took=took)
    return out


def _tensors(value):
    if torch.is_tensor(value):
        return [value]
    if isinstance(value, dict):
        return [t for k in sorted(value, key=str)
                for t in _tensors(value[k])]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def test_peer_death_shrinks_to_one_rank_and_ends_as_the_control(runs):
    (rc0, out0, err0), (rc1, out1, err1) = runs['elastic']
    assert rc0 == rc1 == 0, err0[-3000:] + err1[-3000:]
    assert err1.count('[faults] firing peer-death@4') == 1
    assert f'Resumed from {runs["ck"]["elastic"]} at epoch 3.' in out0
    obs = runs['tmp'] / 'obs'
    lead, follow = _record(obs, 0), _record(obs, 1)
    assert lead['outcome'] == 'completed' and lead['restarts'] == 1
    assert lead['attempts'][0]['reason'].startswith('peer-death:host_1')
    assert [e['detail'] for e in lead['elastic']] \
        == ['--row_shards 2 -> 1 (shrink the mesh)']
    assert _ledger(obs)['mesh'] == {'shards': 1}
    assert follow['outcome'] == 'retired'
    assert follow['events'][-1]['event'] == 'retire'
    # The control: two ranks to epoch 3, then one rank to epoch 5.
    for (rc, _, err) in runs['control'] + runs['resume']:
        assert rc == 0, err[-3000:]
    resumed = runs['resume'][0][1]
    assert f'Resumed from {runs["ck"]["control"]} at epoch 3.' in resumed
    assert _lines(out0)[-2:] == _lines(resumed)[-2:]
    assert [line[:3] for line in _lines(resumed)] == ['004', '005']
    a = torch.load(os.path.join(runs['ck']['control'], '5', 'state.pt'),
                   weights_only=True)
    b = torch.load(os.path.join(runs['ck']['elastic'], '5', 'state.pt'),
                   weights_only=True)
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 10
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert a['step'] == b['step'] == 5
    rc, text, _ = _call(report_mod.main, [str(obs)])
    assert rc == 0 and 'elastic shrink' in text


def test_collective_stall_exits_67_with_jax_report_keys(runs, tmp_path):
    (rc0, _, err0), (rc1, _, err1) = runs['fence']
    assert (rc0, rc1) == (67, 67), err0[-3000:] + err1[-3000:]
    assert 'firing collective-stall@2 inside the step-2 fence' in err1
    assert max(runs['took']['fence']) < 5 + 30
    obs = runs['tmp'] / 'obs_fence'
    # JAX's report keys, as its RunObserver's guard writes them.
    jax_report = str(tmp_path / 'jax.json')
    with jax_dg.FenceGuard(jax_report, 0.05, phase='epoch-fence', step=2,
                           on_timeout='report', context_fn=dict):
        time.sleep(0.3)
    with open(jax_report) as f:
        want = sorted(json.load(f))
    for rank, other in ((0, 1), (1, 0)):
        with open(obs / f'host_{rank}' / 'hang_report.json') as f:
            rep = json.load(f)
        assert sorted(rep) == want
        assert rep['reason'] == 'fence-deadline: epoch-fence incomplete ' \
                                'after 5.0s'
        assert rep['fence'] == {'phase': 'epoch-fence', 'step': 2}
        assert [m['host'] for m in rep['missing_hosts']] == [other]
    argv = [str(obs), '--no-write', '--json']
    ours = _call(agg_mod.main, argv)
    assert ours == jax_main('aggregate', argv) and ours[0] == 0
    summary = json.loads(ours[1])
    assert summary['hung_hosts'] == ['host_0', 'host_1']
    assert summary['hang_attribution']['host_1']['in_flight'] == {
        'phase': 'fence', 'name': 'epoch-fence'}
    assert summary['hang_attribution']['host_1']['last_heartbeat'][
        'step'] == 2


def test_a_lone_rank_exits_67_at_the_rendezvous(runs):
    (rc, _, err), = runs['lone']
    assert rc == 67, err[-3000:]
    with open(runs['tmp'] / 'obs_lone' / 'host_0' / 'hang_report.json') as f:
        rep = json.load(f)
    assert rep['reason'] == 'fence-deadline: distributed-init incomplete ' \
                            'after 2.0s'
    assert rep['fence'] == {'phase': 'distributed-init', 'step': None}


def test_a_plain_crash_restarts_both_ranks_on_the_same_world(runs):
    (rc0, out0, err0), (rc1, out1, err1) = runs['restart']
    assert rc0 == rc1 == 0, err0[-3000:] + err1[-3000:]
    obs = runs['tmp'] / 'obs_restart'
    for host in (0, 1):
        rec = _record(obs, host)
        assert rec['outcome'] == 'completed' and rec['elastic'] == []
        assert [a['reason'] for a in rec['attempts']] \
            == ['exit:1', 'completed']
        first, second = ([x for x in a['argv'] if 'attempt_' not in x]
                         for a in rec['attempts'])
        assert first == second and '--coordinator' in second
    assert _ledger(obs)['mesh'] == {'shards': 2}
    assert 'at epoch 2.' in out0
    assert _lines(out0)[-1].startswith('003')
