"""The port's distributed control plane and its fault kinds against the
JAX package's, on the CPU.

Each scenario of the JAX package's
``tests/resilience/test_distributed_guard.py`` runs through JAX's
``dgmc_tpu.resilience.distributed_guard`` and through the port's
``dgmc_tpu_torch.resilience.distributed_guard``, the same calls on each:
the return values (``peers``, ``dead_peers``, ``stragglers``, the
ledger's decisions, ``_missing_hosts``, the guard's ``fired``) and the
files written must be equal, less the fields that hold a time, a pid, an
age or thread stacks; then each package's readers read the files the
other wrote (heartbeats, tombstones, the ledger). The fence guard's
exit path runs in a subprocess per package (``FENCE_TIMEOUT_RC`` and the
report). The port's own :meth:`FenceGuard.expire` (a collective that
raised is held until the deadline) is checked on its own.

The four multi-rank fault kinds (``peer-death``, ``coord-partition``,
``collective-stall``, ``straggler``): ``parse_spec`` equal to JAX's, and
``before_step`` / ``before_fence`` firing as JAX's do (the sleeps they
ask for recorded, the fire-once ledger, the partition flag);
``peer-death`` in a subprocess per package: a tombstone, then SIGKILL.

Every comparison here is exact.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import dgmc_tpu.resilience.distributed_guard as jax_dg
import dgmc_tpu.resilience.faults as jax_faults
import dgmc_tpu_torch.resilience.distributed_guard as dg
import dgmc_tpu_torch.resilience.faults as faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = {'port': (dg, faults), 'jax': (jax_dg, jax_faults)}
#: Fields that hold a time, a pid, an age or stacks: left out of every
#: comparison (each run has its own).
VOLATILE = {'time', 'pid', 'stale_s', 'heartbeat_age_s', 'stalled_for_s',
            'since_s', 'threads'}


def _stable(value):
    if isinstance(value, dict):
        return {k: _stable(v) for k, v in value.items()
                if k not in VOLATILE}
    if isinstance(value, list):
        return [_stable(v) for v in value]
    return value


def _files(root):
    """Every JSON file under ``root`` by relative path, stable fields."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path) as f:
                try:
                    out[os.path.relpath(path, root)] = _stable(json.load(f))
                except ValueError:
                    out[os.path.relpath(path, root)] = open(path).read()
    return out


# -- the scenarios: each takes (distributed_guard module, faults module,
# -- tmp dir) and returns what it observed --------------------------------

def channel_roundtrip(m, f, tmp):
    obs = str(tmp / 'obs')
    a = m.HostChannel(obs, host_index=0, num_hosts=2)
    b = m.HostChannel(obs, host_index=1, num_hosts=2)
    a.beat('epoch', step=3)
    b.beat('epoch', step=2)
    return {'peers': a.peers(), 'path': os.path.relpath(b.path, tmp)}


def record_fence(m, f, tmp):
    a = m.HostChannel(str(tmp / 'obs'), host_index=0)
    a.record_fence('epoch-fence', 5)
    return {'peers': a.peers()}


def dead_peers(m, f, tmp):
    obs = str(tmp / 'obs')
    a = m.HostChannel(obs, host_index=0, num_hosts=3)
    b = m.HostChannel(obs, host_index=1, num_hosts=3)
    a.beat('epoch', 1)
    b.beat('epoch', 1)
    fresh = a.dead_peers(stale_s=30.0)
    stale = a.dead_peers(stale_s=0.5, now=time.time() + 10)
    m.write_tombstone(a.dir, 2, step=4)
    return {'fresh': fresh, 'stale': stale,
            'tombstoned': a.dead_peers(stale_s=30.0),
            'tombstones': m.read_tombstones(a.dir)}


def stragglers(m, f, tmp):
    a = m.HostChannel(str(tmp / 'obs'), host_index=0)
    b = m.HostChannel(str(tmp / 'obs'), host_index=1)
    a.beat('epoch', step=10)
    b.beat('epoch', step=7)
    lag = a.stragglers(behind_steps=2)
    b.beat('epoch', step=9)
    within = a.stragglers(behind_steps=2)
    solo = m.HostChannel(str(tmp / 'solo'), host_index=0)
    solo.beat('epoch', 1)
    return {'lag': lag, 'within': within, 'solo': solo.stragglers()}


def refresher(m, f, tmp):
    ch = m.HostChannel(str(tmp / 'obs'), host_index=0, interval_s=0.05)
    with ch:
        ch.beat('epoch', 1)
        t0 = ch.peers()[0]['time']
        time.sleep(0.3)
        refreshed = ch.peers()[0]['time'] > t0
    t1 = ch.peers()[0]['time']
    time.sleep(0.2)
    return {'refreshed': refreshed,
            'stale_after_close': ch.peers()[0]['time'] == t1}


def coord_partition(m, f, tmp):
    plan = f.FaultPlan(['coord-partition@2'])
    ch = m.HostChannel(str(tmp / 'obs'), host_index=0, fault_plan=plan)
    ch.beat('epoch', 1)
    t0 = ch.peers()[0]['time']
    plan.before_step(2)
    ch.beat('epoch', 2)
    rec = ch.peers()[0]
    return {'partitioned': plan.coord_partitioned,
            'suppressed': rec['time'] == t0, 'step': rec['step']}


def control_root(m, f, tmp):
    root = str(tmp / 'obs')
    return {'root': os.path.relpath(m.control_root(root), tmp),
            'attempt': os.path.relpath(
                m.control_root(os.path.join(root, 'attempt_3')), tmp),
            'not_attempt': os.path.relpath(
                m.control_root(os.path.join(root, 'attempt_x')), tmp),
            'dir': os.path.relpath(m.control_dir(root), tmp)}


def junk(m, f, tmp):
    cdir = tmp / 'control'
    os.makedirs(cdir)
    (cdir / 'host_0.json').write_text('{"host": 0, "time": 1}')
    (cdir / 'host_x.json').write_text('{}')
    (cdir / 'host_1.json').write_text('{not json')
    (cdir / 'ledger.json').write_text('{}')
    (cdir / 'host_3.tombstone.json').write_text('{"host": "x"}')
    return {'beats': m.read_heartbeats(str(cdir)),
            'tombs': m.read_tombstones(str(cdir)),
            'missing': m.read_heartbeats(str(tmp / 'absent'))}


def ledger_leader(m, f, tmp):
    cdir = str(tmp / 'control')
    os.makedirs(cdir)
    leader = m.RecoveryLedger(cdir, host_index=0)
    follower = m.RecoveryLedger(cdir, host_index=1)
    before = follower.read()
    decision = leader.decide(1, 'peer-death:host_1', mesh={'shards': 4},
                             dead_hosts=[1], detail='--model_shards 8 -> 4')
    try:
        follower.decide(2, 'nope')
        refused = None
    except m.LedgerError as e:
        refused = str(e)
    return {'leader': leader.is_leader, 'follower': follower.is_leader,
            'before': before, 'decision': decision,
            'after': follower.read(), 'refused': refused}


def ledger_wait(m, f, tmp):
    cdir = str(tmp / 'control')
    os.makedirs(cdir)
    leader = m.RecoveryLedger(cdir, host_index=0)
    follower = m.RecoveryLedger(cdir, host_index=1)
    early = follower.wait_for_attempt(1, timeout_s=0.2, poll_s=0.05)
    t = threading.Timer(0.15, lambda: leader.decide(1, 'hang-report',
                                                    mesh={'shards': 2}))
    t.start()
    try:
        got = follower.wait_for_attempt(1, timeout_s=5.0, poll_s=0.02)
    finally:
        t.join()
    return {'early': early, 'got': got,
            'older': follower.wait_for_attempt(0, timeout_s=0.1)}


def ledger_accumulates(m, f, tmp):
    cdir = str(tmp / 'control')
    os.makedirs(cdir)
    led = m.RecoveryLedger(cdir, host_index=0)
    led.decide(1, 'exit:3')
    led.decide(2, 'peer-death:host_2', mesh={'shards': 2})
    return {'ledger': led.read()}


def guard_clean(m, f, tmp):
    report = str(tmp / 'hang_report.json')
    with m.FenceGuard(report, deadline_s=5.0, phase='epoch-fence', step=1,
                      on_timeout='report') as g:
        pass
    time.sleep(0.1)
    return {'fired': g.fired, 'report': os.path.exists(report)}


def guard_missing_hosts(m, f, tmp):
    obs = str(tmp / 'obs')
    report = str(tmp / 'hang_report.json')
    me = m.HostChannel(obs, host_index=0, num_hosts=3)
    peer = m.HostChannel(obs, host_index=1, num_hosts=3)
    me.record_fence('epoch-fence', 4)
    peer.record_fence('epoch-fence', 3)
    m.write_tombstone(me.dir, 2, step=2)
    dumped = []
    g = m.FenceGuard(report, deadline_s=0.1, phase='epoch-fence', step=4,
                     channel=me, on_timeout='report',
                     context_fn=lambda: {'steps': 4}, on_dump=dumped.append)
    missing = g._missing_hosts()
    with g:
        time.sleep(0.5)
    with open(report) as fh:
        rep = json.load(fh)
    return {'fired': g.fired, 'missing': missing, 'dumped': dumped,
            'keys': sorted(rep), 'threads': bool(rep['threads'])}


def guard_peer_reached(m, f, tmp):
    obs = str(tmp / 'obs')
    report = str(tmp / 'hang_report.json')
    me = m.HostChannel(obs, host_index=0, num_hosts=2)
    peer = m.HostChannel(obs, host_index=1, num_hosts=2)
    peer.record_fence('epoch-fence', 4)
    with m.FenceGuard(report, deadline_s=0.1, phase='epoch-fence', step=4,
                      channel=me, on_timeout='report') as g:
        time.sleep(0.4)
    return {'fired': g.fired, 'missing': g._missing_hosts()}


def guard_late_timer(m, f, tmp):
    report = str(tmp / 'hang_report.json')
    g = m.FenceGuard(report, deadline_s=60.0, phase='epoch-fence', step=1,
                     on_timeout='exit')
    with g:
        pass
    g._fire()
    return {'fired': g.fired, 'report': os.path.exists(report)}


def guard_rejects(m, f, tmp):
    try:
        m.FenceGuard('r.json', 1.0, phase='x', on_timeout='explode')
    except ValueError as e:
        return {'error': str(e)}
    return {'error': None}


SCENARIOS = {fn.__name__: fn for fn in (
    channel_roundtrip, record_fence, dead_peers, stragglers, refresher,
    coord_partition, control_root, junk, ledger_leader, ledger_wait,
    ledger_accumulates, guard_clean, guard_missing_hosts,
    guard_peer_reached, guard_late_timer, guard_rejects)}


@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_control_plane_matches_jax(scenario, tmp_path):
    seen = {}
    for impl, (m, f) in IMPLS.items():
        tmp = tmp_path / impl
        os.makedirs(tmp)
        seen[impl] = (_stable(SCENARIOS[scenario](m, f, tmp)), _files(tmp))
    assert seen['port'][0] == seen['jax'][0]
    assert seen['port'][1] == seen['jax'][1]


def test_each_package_reads_the_others_files(tmp_path):
    """Heartbeats, tombstones and the ledger written by one package are
    read by the other's readers as by its own."""
    for writer, reader in ((dg, jax_dg), (jax_dg, dg)):
        obs = str(tmp_path / writer.__name__)
        a = writer.HostChannel(obs, host_index=0, num_hosts=2)
        b = writer.HostChannel(obs, host_index=1, num_hosts=2)
        a.record_fence('epoch-fence', 2)
        b.beat('epoch', 3)
        writer.write_tombstone(a.dir, 1, step=3)
        writer.RecoveryLedger(a.dir).decide(1, 'peer-death:host_1',
                                            mesh={'shards': 1},
                                            dead_hosts=[1])
        for mod in (reader, writer):
            got = (mod.read_heartbeats(a.dir), mod.read_tombstones(a.dir),
                   mod.RecoveryLedger(a.dir, host_index=1).read())
            ch = mod.HostChannel(obs, host_index=0)
            got += (_stable(ch.dead_peers(stale_s=30.0)),
                    ch.stragglers(behind_steps=0))
            if mod is writer:
                want = got
        assert got == want
        assert want[0][0]['last_fence']['step'] == 2
        assert want[1][1]['step'] == 3
        assert want[2]['mesh'] == {'shards': 1}


def _py(code):
    return subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env=dict(os.environ, JAX_PLATFORMS='cpu'))


def test_fence_guard_exit_path_matches_jax(tmp_path):
    """The production mode in a subprocess per package (side by side):
    the missed deadline exits ``FENCE_TIMEOUT_RC`` (67 in both) with a
    report of the same keys and fence."""
    procs, reports = {}, {}
    for impl, pkg in (('port', 'dgmc_tpu_torch'), ('jax', 'dgmc_tpu')):
        report = str(tmp_path / f'{impl}.json')
        procs[impl] = (report, _py(
            f'import time\n'
            f'from {pkg}.resilience.distributed_guard import FenceGuard\n'
            f'with FenceGuard({report!r}, deadline_s=0.1, '
            f'phase="epoch-fence", step=7):\n'
            f'    time.sleep(30)\n'))
    for impl, (report, proc) in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 67, err[-2000:]
        with open(report) as f:
            reports[impl] = json.load(f)
    assert dg.FENCE_TIMEOUT_RC == jax_dg.FENCE_TIMEOUT_RC == 67
    assert sorted(reports['port']) == sorted(reports['jax'])
    assert _stable(dict(reports['port'], argv=None)) \
        == _stable(dict(reports['jax'], argv=None))
    assert reports['port']['fence'] == {'phase': 'epoch-fence', 'step': 7}


def test_expire_holds_a_raised_section_until_the_deadline(tmp_path):
    """The port's addition for gloo, which raises where NCCL blocks: a
    guarded section whose collective raised waits for the deadline, so
    that the report is written (the error in its context) and the caller
    re-raises after it; a guard that already fired returns at once."""
    report = str(tmp_path / 'hang_report.json')
    g = dg.FenceGuard(report, deadline_s=0.3, phase='epoch-fence', step=2,
                      on_timeout='report', context_fn=lambda: {'n': 1})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='Connection closed'):
        with g:
            try:
                raise RuntimeError('Connection closed by peer')
            except RuntimeError as e:
                g.expire(e)
                raise
    assert time.monotonic() - t0 >= 0.29 and g.fired
    with open(report) as f:
        rep = json.load(f)
    assert rep['context'] == {
        'n': 1, 'collective_error': 'RuntimeError: Connection closed by '
                                    'peer'}
    with g:
        time.sleep(0.4)
        t0 = time.monotonic()
        g.expire(OSError('late'))
    assert time.monotonic() - t0 < 0.1


# -- the fault kinds ---------------------------------------------------------

@pytest.mark.parametrize('text', [
    'peer-death@4', 'peer-death@4:1', 'straggler@2:250', 'straggler@2',
    'coord-partition@5', 'collective-stall@3', 'collective-stall@3:7.5'])
def test_parse_spec_matches_jax(text):
    got, want = faults.parse_spec(text), jax_faults.parse_spec(text)
    assert (got.kind, got.step, got.arg, got.key, repr(got)) \
        == (want.kind, want.step, want.arg, want.key, repr(want))
    assert type(got.arg) is type(want.arg)


@pytest.mark.parametrize('bad', ['peer-death', 'collective-stall',
                                 'straggler', 'coord-partition@x'])
def test_parse_spec_refuses_as_jax(bad):
    for impl in (faults, jax_faults):
        with pytest.raises(ValueError):
            impl.parse_spec(bad)


def _sleeps(impl, monkeypatch):
    slept = []
    monkeypatch.setattr(impl.time, 'sleep', slept.append)
    return slept


def test_straggler_sleeps_every_step_from_n(monkeypatch):
    """A condition: it sleeps before every step >= N, replays included,
    and records nothing in the ledger."""
    seen = []
    for impl in (faults, jax_faults):
        slept = _sleeps(impl, monkeypatch)
        plan = impl.FaultPlan(['straggler@3:250'], state_dir=None)
        for step in (1, 2, 3, 4, 3):
            plan.before_step(step)
        seen.append((slept, sorted(plan._fired)))
        monkeypatch.undo()
    assert seen[0] == seen[1] == ([0.25, 0.25, 0.25], [])


def test_coord_partition_fires_once_across_restarts(tmp_path):
    seen = []
    for impl in (faults, jax_faults):
        d = str(tmp_path / impl.__name__)
        os.makedirs(d)
        plan = impl.FaultPlan(['coord-partition@2'], state_dir=d)
        plan.before_step(1)
        first = plan.coord_partitioned
        plan.before_step(2)
        replay = impl.FaultPlan(['coord-partition@2'], state_dir=d)
        replay.before_step(2)
        with open(os.path.join(d, impl.FIRED_LEDGER)) as f:
            seen.append((first, plan.coord_partitioned,
                         replay.coord_partitioned, json.load(f)))
    assert seen[0] == seen[1] == (False, True, False,
                                  {'fired': ['coord-partition@2']})


def test_collective_stall_fires_in_the_fence_once(tmp_path, monkeypatch):
    seen = []
    for impl in (faults, jax_faults):
        d = str(tmp_path / impl.__name__)
        os.makedirs(d)
        slept = _sleeps(impl, monkeypatch)
        plan = impl.FaultPlan(['collective-stall@3:12'], state_dir=d)
        plan.before_step(3)     # a fence kind: not a step fault
        plan.before_fence(2)    # wrong step
        plan.before_fence(3)
        plan.before_fence(3)    # fire once
        impl.FaultPlan(['collective-stall@3:12'],
                       state_dir=d).before_fence(3)   # ledgered
        seen.append(slept)
        monkeypatch.undo()
    assert seen[0] == seen[1] == [12.0]


def _peer_death(pkg, tmp, spec, host):
    """``before_step`` of a ``peer-death`` plan in a subprocess of
    ``pkg``, started."""
    cdir = str(tmp / 'control')
    return _py(f'from {pkg}.resilience.faults import FaultPlan\n'
               f'plan = FaultPlan([{spec!r}], state_dir={str(tmp)!r}, '
               f'control_dir={cdir!r}, host_index={host})\n'
               f'plan.before_step(1)\n'
               f'plan.before_step(2)\n'
               f'print("survived")\n')


@pytest.mark.parametrize('spec,host', [('peer-death@2:1', 0),
                                       ('peer-death@2', 3)])
def test_peer_death_writes_a_tombstone_then_sigkills(spec, host, tmp_path):
    """The tombstone (rank H, or this rank by default), then SIGKILL —
    the fault recorded as fired before the kill — in either package."""
    procs, got = {}, {}
    for impl, pkg in (('port', 'dgmc_tpu_torch'), ('jax', 'dgmc_tpu')):
        os.makedirs(tmp_path / impl)
        procs[impl] = _peer_death(pkg, tmp_path / impl, spec, host)
    for impl, proc in procs.items():
        out, _ = proc.communicate(timeout=120)
        with open(tmp_path / impl / 'faults_fired.json') as f:
            ledger = json.load(f)
        got[impl] = (proc.returncode, out,
                     _files(str(tmp_path / impl / 'control')), ledger)
    assert got['port'] == got['jax']
    rc, out, tombs, ledger = got['port']
    assert rc == -9 and 'survived' not in out
    target = 1 if spec.endswith(':1') else host
    assert tombs == {f'host_{target}.tombstone.json': {
        'host': target, 'step': 2, 'reason': 'peer-death'}}
    assert ledger == {'fired': ['peer-death@2']}
