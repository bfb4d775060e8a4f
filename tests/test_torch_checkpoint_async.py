"""The asynchronous save (JAX's ``Checkpointer.save(..., wait=False)``).

- The same call sequence on JAX's orbax ``Checkpointer`` and on the
  port's — save without waiting, save, wait, retire past
  ``max_to_keep``, re-save a step, close — lists and manifests the same
  steps at each point and restores the same step with the same values.
- The snapshot is the state at the save: an in-place change right
  after ``save`` returns (while the write is held back) does not reach
  the file.
- A write still in flight is never restored: the saving checkpointer's
  restore waits for it, and a process killed mid-write leaves a
  temporary directory that the next checkpointer removes, restoring the
  last committed step.
- ``ckpt-truncate`` / ``ckpt-corrupt`` wait for the commit of an
  asynchronous save, then damage it; the restore falls back past it.
- The DBP15K CLI logs each committed save (the blocking seconds, the
  write's, the bytes); the serve CLI's ``--init-missing`` save is
  committed and manifested when it returns; the dense CLI's held-out
  eval goes through ``eval_summary``.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.resilience.faults import FaultPlan
from dgmc_tpu_torch.train import checkpoint as ckpt_mod
from dgmc_tpu_torch.train.checkpoint import MANIFEST_DIRNAME, Checkpointer
from dgmc_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(value=0.0):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    state = create_train_state(model, 1e-2)
    _fill(model, value)
    return model, state


def _fill(model, value):
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.arange(p.numel(), dtype=torch.float32)
                    .reshape(p.shape) + value + i)


def _values(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _manifests(directory):
    mdir = os.path.join(directory, MANIFEST_DIRNAME)
    return sorted(os.listdir(mdir)) if os.path.isdir(mdir) else None


@pytest.fixture
def held_writes(monkeypatch):
    """Hold every background write until ``gate.set()``."""
    gate = threading.Event()
    write = ckpt_mod._write_step

    def held(*args, **kw):
        assert gate.wait(30), 'the test never released the write'
        return write(*args, **kw)

    monkeypatch.setattr(ckpt_mod, '_write_step', held)
    yield gate
    gate.set()


def test_call_sequence_matches_orbax(tmp_path):
    from dgmc_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
    jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jax_ck = JaxCheckpointer(jdir, max_to_keep=2)
    port_ck = Checkpointer(pdir, max_to_keep=2)
    model, state = _model()

    def jstate(v):
        return {'w': np.arange(4.0, dtype=np.float32) + v}

    def save(step, v, **kw):
        jax_ck.save(step, jstate(v), **kw)
        _fill(model, v)
        port_ck.save(step, model, state, **kw)

    seen = []

    def point(tag):
        seen.append((tag, jax_ck.all_steps(), _manifests(jdir),
                     port_ck.all_steps(), _manifests(pdir)))

    save(1, 1.0, wait=False)
    point('save 1 without waiting')
    save(2, 2.0)
    point('save 2')
    jax_ck.wait_until_finished()
    port_ck.wait_until_finished()
    point('wait')
    save(3, 3.0)
    point('save 3: step 1 retires')
    jax_ck.wait_until_finished()
    port_ck.wait_until_finished()
    save(3, 30.0)
    point('re-save 3')
    jax_ck.close()
    port_ck.close()
    point('close')
    for tag, j_steps, j_man, p_steps, p_man in seen:
        assert (p_steps, p_man) == (j_steps, j_man), tag
    assert seen[-1][1:3] == ([2, 3], ['2.json', '3.json'])
    got = jax_ck.restore(jstate(0.0))
    fresh, fresh_state = _model(-1.0)
    Checkpointer(pdir).restore(fresh, fresh_state)
    want_model, _ = _model(30.0)
    assert jax_ck.restored_step == 3
    np.testing.assert_array_equal(got['w'], jstate(30.0)['w'])
    for k, v in _values(want_model).items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_snapshot_is_the_state_at_the_save(tmp_path, held_writes):
    model, state = _model(1.0)
    model(torch.ones(2, 4)).sum().backward()
    state.optimizer.step()
    want = _values(model)
    adam = {i: {k: v.clone() for k, v in st.items()}
            for i, st in enumerate(state.optimizer.state.values())}
    ck = Checkpointer(tmp_path / 'ck')
    ck.save(1, model, state)
    assert ck.last_save['seconds'] >= 0 and 'write_s' not in ck.last_save
    # Changed in place while the write is held back.
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-3.0)
    for st in state.optimizer.state.values():
        st['exp_avg'].add_(5.0)
    held_writes.set()
    ck.close()
    assert ck.last_save['write_s'] > 0 and ck.last_save['bytes'] > 0
    back, back_state = _model(7.0)
    Checkpointer(tmp_path / 'ck').restore(back, back_state)
    for k, v in want.items():
        assert torch.equal(back.state_dict()[k], v), k
    for i, st in enumerate(back_state.optimizer.state.values()):
        for k, v in adam[i].items():
            assert torch.equal(st[k], v), (i, k)


def test_restore_waits_for_its_own_write(tmp_path, held_writes):
    model, state = _model(1.0)
    ck = Checkpointer(tmp_path / 'ck')
    held_writes.set()
    ck.save(1, model, state, wait=True)
    held_writes.clear()
    _fill(model, 2.0)
    ck.save(2, model, state)
    assert ckpt_mod._step_dirs(ck.directory) == [1]     # not committed
    assert ck.all_steps() == [1, 2]                   # orbax's listing
    done = {}
    back, back_state = _model(0.0)
    t = threading.Thread(target=lambda: done.setdefault(
        'step', ck.restore(back, back_state) and ck.restored_step))
    t.start()
    time.sleep(0.3)
    assert 'step' not in done, 'restored while the write was in flight'
    held_writes.set()
    t.join(30)
    assert ck.restored_step == 2
    assert torch.equal(back[0].weight, model[0].weight)


KILLED_MID_WRITE = textwrap.dedent('''
    import os, signal, sys, time
    import torch
    from dgmc_tpu_torch.train import checkpoint as ckpt_mod
    from dgmc_tpu_torch.train.state import create_train_state

    model = torch.nn.Linear(4, 3)
    state = create_train_state(model, 1e-2)
    ck = ckpt_mod.Checkpointer(sys.argv[1])
    ck.save(1, model, state, wait=True)
    save = torch.save

    def slow_save(obj, path):
        save(obj, path)
        time.sleep(60)

    ckpt_mod.torch.save = slow_save
    with torch.no_grad():
        model.weight.add_(1.0)
    ck.save(2, model, state)
    time.sleep(0.5)            # the write is in flight
    os.kill(os.getpid(), signal.SIGKILL)
''')


def test_a_write_cut_by_a_crash_is_never_restored(tmp_path):
    d = str(tmp_path / 'ck')
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, '-c', KILLED_MID_WRITE, d],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == -signal.SIGKILL, r.stderr
    left = sorted(os.listdir(d))
    assert '2' not in left and any(n.startswith('.tmp-2-') for n in left)
    model = torch.nn.Linear(4, 3)
    state = create_train_state(model, 1e-2)
    ck = Checkpointer(d)
    assert not any(n.startswith('.tmp-') for n in os.listdir(d))
    assert ck.all_steps() == [1]
    ck.restore(model, state)
    assert ck.restored_step == 1 and ck.verify(1) == []


@pytest.mark.parametrize('kind', ['ckpt-truncate', 'ckpt-corrupt'])
def test_faults_wait_for_the_commit_then_damage(tmp_path, held_writes, kind):
    model, state = _model(1.0)
    d = str(tmp_path / 'ck')
    ck = Checkpointer(d)
    held_writes.set()
    ck.save(1, model, state, wait=True)
    held_writes.clear()
    ck.save(2, model, state)
    plan = FaultPlan([f'{kind}@2'], state_dir=d)
    t = threading.Thread(target=plan.after_checkpoint, args=(ck, 2))
    with contextlib.redirect_stderr(io.StringIO()):
        t.start()
        time.sleep(0.3)
        assert t.is_alive(), 'the fault did not wait for the commit'
        held_writes.set()
        t.join(30)
        assert ck.verify(2), 'step 2 was not damaged after its commit'
        back, back_state = _model(0.0)
        ck.restore(back, back_state)
    assert ck.restored_step == 1


def test_kg_cli_logs_each_committed_save(tmp_path):
    from dgmc_tpu_torch.experiments import dbp15k
    log = str(tmp_path / 'm.jsonl')
    argv = ['--device', 'cpu', '--f32', '--synthetic', '--syn_nodes_s', '40',
            '--syn_nodes_t', '50', '--syn_edges_s', '120', '--syn_edges_t',
            '150', '--syn_dim', '12', '--dim', '16', '--rnd_dim', '8',
            '--num_layers', '2', '--num_steps', '2', '--epochs', '4',
            '--phase1_epochs', '2', '--ckpt_every', '2', '--ckpt_dir',
            str(tmp_path / 'ck'), '--metrics_log', log]
    with contextlib.redirect_stdout(io.StringIO()):
        dbp15k.main(argv)
    with open(log) as f:
        events = [json.loads(line) for line in f]
    saves = [e for e in events if e.get('event') == 'checkpoint']
    assert [e['step'] for e in saves] == [2, 4]
    for e in saves:
        assert e['save_s'] >= 0 and e['write_s'] > 0 and e['save_bytes'] > 0
    assert Checkpointer(tmp_path / 'ck').all_steps() == [2, 4]
    assert _manifests(str(tmp_path / 'ck')) == ['2.json', '4.json']


def test_serve_init_missing_save_is_committed_on_return(tmp_path):
    from dgmc_tpu_torch.serve import cli
    model, _ = _model(1.0)
    d = str(tmp_path / 'empty')
    assert cli.restore(model, d, init_missing=True) == 0
    assert ckpt_mod._step_dirs(d) == [0] and _manifests(d) == ['0.json']


def test_dense_cli_eval_goes_through_eval_summary(monkeypatch, tmp_path):
    from dgmc_tpu_torch.experiments import pascal_pf
    calls = []
    real = pascal_pf.eval_summary

    def spy(count, **kw):
        out = real(count, **kw)
        calls.append((count, {k: float(v) for k, v in kw.items()}, out))
        return out

    monkeypatch.setattr(pascal_pf, 'eval_summary', spy)
    pairs = pascal_pf.RandomGraphPairs
    monkeypatch.setattr(pascal_pf, 'RandomGraphPairs', lambda *a, **kw: pairs(
        *a, **dict(kw, length=kw.get('length', 16))))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pascal_pf.main(['--device', 'cpu', '--epochs', '1', '--batch_size',
                        '8', '--dim', '16', '--rnd_dim', '8', '--num_steps',
                        '1', '--synthetic_eval', '16', '--data_root',
                        str(tmp_path / 'none')])
    held = [c for c in calls if set(c[1]) == {'hits1'}]
    assert held, calls
    count, kw, summary = held[0]
    line = [s for s in out.getvalue().splitlines()
            if s.startswith('Held-out synthetic')]
    assert line == [f'Held-out synthetic: {100 * summary["hits1"]:.2f}']
    assert summary['hits1'] == kw['hits1'] / max(count, 1.0)


def test_saves_in_a_row_keep_the_newest_committed(tmp_path):
    """Back-to-back asynchronous saves with a short switch interval:
    each waits for the write before it; the newest ``max_to_keep``
    steps stay, each verified against its manifest, and every commit is
    reported once."""
    model, state = _model(0.0)
    ck = Checkpointer(tmp_path / 'ck', max_to_keep=3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 21):
            _fill(model, float(step))
            ck.save(step, model, state)
        ck.close()
    finally:
        sys.setswitchinterval(interval)
    assert ck.all_steps() == [18, 19, 20]
    assert _manifests(ck.directory) == ['18.json', '19.json', '20.json']
    assert all(ck.verify(s) == [] for s in (18, 19, 20))
    assert [c['step'] for c in ck.take_commits()] == list(range(1, 21))
    back, back_state = _model(-1.0)
    Checkpointer(tmp_path / 'ck').restore(back, back_state)
    assert torch.equal(back[1].bias, model[1].bias)
