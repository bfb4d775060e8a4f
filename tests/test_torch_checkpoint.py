"""The port's checkpoints (``dgmc_tpu_torch/train/checkpoint.py``) and the
DBP15K CLI's resume, on the CPU.

Ports of the JAX package's ``tests/train/test_checkpoint.py`` (round
trip, the willow snapshot and restore) and of
``tests/resilience/test_checkpoint_hardening.py`` (manifests, the
fallback past corrupt or truncated steps, the pinned-step errors, the
re-save, retention, ``resume_or_init``'s edge cases and the guard
toggle), on a tiny DBP15K-configuration model trained three steps. The
asynchronous-save cases of the latter have no counterpart: the port's
saves are synchronous.

Then: JAX's initial DBP15K-configuration parameters, converted, saved
and restored by the port, forward as JAX's ``DGMC.apply`` does (indices
equal; probabilities within rtol 1e-4 / atol 1e-5, the float32 drift of
two consensus steps, as ``tests/test_torch_serve.py`` holds them); the
CLI stopped by ``raise@N`` and resumed (across the phase boundary, and
past a corrupt latest step) ends bit-identical to an uninterrupted run:
parameters, Adam state and printed eval lines; the eval lines follow
:func:`~dgmc_tpu_torch.models.evalsum.eval_summary`, which equals JAX's.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.models.evalsum import eval_summary
from dgmc_tpu_torch.resilience.faults import (FaultInjected,
                                              corrupt_checkpoint)
from dgmc_tpu_torch.train.checkpoint import (MANIFEST_DIRNAME, STATE_FILE,
                                             CheckpointCorruptError,
                                             Checkpointer, resume_or_init)
from dgmc_tpu_torch.train.state import (GuardedTrainState,
                                        create_train_state, restore_params,
                                        snapshot_params, with_guard_counters)
from dgmc_tpu_torch.train.steps import batch_to_device, make_train_step

ARGV = ['--device', 'cpu', '--f32', '--synthetic', '--syn_nodes_s', '40',
        '--syn_nodes_t', '50', '--syn_edges_s', '120', '--syn_edges_t',
        '150', '--syn_dim', '12', '--dim', '16', '--rnd_dim', '8',
        '--num_layers', '2', '--num_steps', '2', '--lr', '0.01']
#: The verify skill's tiny KG size, for the CLI's resume runs.
CLI_ARGV = ['--device', 'cpu', '--f32', '--synthetic', '--syn_nodes_s',
            '300', '--syn_nodes_t', '400', '--syn_edges_s', '1500',
            '--syn_edges_t', '1800', '--dim', '16', '--rnd_dim', '8',
            '--num_steps', '3', '--epochs', '12', '--phase1_epochs', '10',
            '--ckpt_every', '4']


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    """One intra-op thread, for the module-scoped fixtures too: the
    tensors here are small, and the suite's parallel workers would
    otherwise oversubscribe the cores. (A CPU reduction's bits depend on
    the thread count, so the resumed runs and the uninterrupted one must
    share it.)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    args = dbp15k.parse_args(ARGV + ['--seed', str(seed)])
    batch, _, in_dim = dbp15k.synthetic_batches(args)
    return dbp15k.build(args, in_dim), batch


def _model_state(model, state):
    """Cloned ``(state_dict, optimizer state_dict, step)``."""
    opt = state.optimizer.state_dict()
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {'state': {i: {k: v.clone() for k, v in st.items()}
                       for i, st in opt['state'].items()},
             'param_groups': opt['param_groups']}, state.step)


@pytest.fixture(scope='module')
def trained():
    """Three distinguishable states (model, optimizer, step) from three
    real train steps: phase 1, then two phase-2 steps, so that every
    parameter has Adam state."""
    model, batch = _model()
    state = create_train_state(model, 0.01)
    steps = (make_train_step(model, num_steps=0, jit=False),
             make_train_step(model, num_steps=2, detach=True, jit=False),
             make_train_step(model, num_steps=2, detach=True, jit=False))
    states = []
    for i, step in enumerate(steps):
        state, _ = step(state, batch, i)
        states.append(_model_state(model, state))
    return states


def _carrier(saved, guarded=False):
    """A model and state holding ``saved`` (loaded by torch's own
    ``load_state_dict``s, independent of the code under test)."""
    model, _ = _model(seed=5)
    state = create_train_state(model, 0.01)
    model.load_state_dict(saved[0])
    state.optimizer.load_state_dict(saved[1])
    state.step = saved[2]
    return model, (with_guard_counters(state) if guarded else state)


def _save_all(path, states, guarded=False, **kw):
    ckpt = Checkpointer(path, **kw)
    for i, s in enumerate(states, start=1):
        ckpt.save(i, *_carrier(s, guarded))
    return ckpt


def _fresh(guarded=False):
    model, _ = _model(seed=9)
    state = create_train_state(model, 0.01)
    return model, (with_guard_counters(state) if guarded else state)


def _assert_holds(model, state, saved):
    got = _model_state(model, state)
    assert set(got[0]) == set(saved[0])
    for k, v in saved[0].items():
        assert torch.equal(got[0][k], v), k
    assert got[1]['state'].keys() == saved[1]['state'].keys()
    for i, st in saved[1]['state'].items():
        for k, v in st.items():
            assert torch.equal(got[1]['state'][i][k], v), (i, k)
    assert got[2] == saved[2]


# -- tests/train/test_checkpoint.py ----------------------------------------

def test_checkpoint_roundtrip(tmp_path, trained):
    ckpt = Checkpointer(tmp_path / 'ckpt')
    ckpt.save(1, *_carrier(trained[0]))
    assert ckpt.latest_step() == 1
    model, state = _fresh()
    assert not torch.equal(model.psi_1.final.weight,
                           trained[0][0]['psi_1.final.weight'])
    ptrs = [p.data_ptr() for p in model.parameters()]
    out = ckpt.restore(model, state)
    assert out is state and ckpt.restored_step == 1
    _assert_holds(model, state, trained[0])
    # In place: a graph captured before the restore reads the values.
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    payload = torch.load(os.path.join(ckpt.directory, '1', STATE_FILE),
                         weights_only=True)
    assert payload['step'] == 1 and 'guard' not in payload


def test_restore_copies_into_existing_adam_state(tmp_path, trained):
    """Restoring into a state that has stepped writes its moments and
    step counts in place (their storage kept); a parameter with no saved
    state takes the fresh (zeroed) one."""
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    model, state = _carrier(trained[2])
    moments = {id(v): v.data_ptr() for st in state.optimizer.state.values()
               for v in st.values()}
    ckpt.restore(model, state, step=1)
    _assert_holds(model, state, trained[0])
    assert {id(v): v.data_ptr() for st in state.optimizer.state.values()
            for v in st.values()} == moments
    fresh_model, _ = _carrier(trained[0])
    ckpt.save(4, fresh_model, create_train_state(fresh_model))
    ckpt.restore(model, state)
    assert ckpt.restored_step == 4 and state.step == 0
    assert all(not v.any() for st in state.optimizer.state.values()
               for v in st.values())
    assert {id(v): v.data_ptr() for st in state.optimizer.state.values()
            for v in st.values()} == moments


def test_snapshot_restore_params(trained):
    """The willow protocol: snapshot, train on, restore with a fresh
    optimizer, several times; from the next step on the restored state
    equals a new ``create_train_state``'s bit for bit."""
    model, batch = _model()
    model.load_state_dict(trained[2][0])
    state = create_train_state(model, 0.01)
    step = make_train_step(model, num_steps=2, detach=True, jit=False)
    snap = snapshot_params(model)
    state, _ = step(state, batch, 3)
    assert not torch.equal(model.psi_2.final.weight,
                           snap['psi_2.final.weight'])
    ptrs = [p.data_ptr() for p in model.parameters()]
    restore_params(state, model, snap)
    assert state.step == 0
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap[k]), k
    assert all(not v.any() for st in state.optimizer.state.values()
               for v in st.values())
    state, _ = step(state, batch, 4)
    after = _model_state(model, state)

    ref, _ = _model()
    ref.load_state_dict(snap)
    ref_state = create_train_state(ref, 0.01)
    ref_state, _ = make_train_step(ref, num_steps=2, detach=True,
                                   jit=False)(ref_state, batch, 4)
    _assert_holds(ref, ref_state, after)
    restore_params(state, model, snap)
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap[k]), k


# -- tests/resilience/test_checkpoint_hardening.py -------------------------

def test_manifest_written_and_verifies(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    for step in (1, 2, 3):
        mpath = os.path.join(ckpt.directory, MANIFEST_DIRNAME,
                             f'{step}.json')
        with open(mpath) as f:
            assert json.load(f)['files'][STATE_FILE]['bytes'] > 0
        assert ckpt.verify(step) == []
    assert not [n for n in os.listdir(ckpt.directory)
                if n.startswith('.tmp')]


def test_restore_clean_latest(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    model, state = _fresh()
    ckpt.restore(model, state)
    assert ckpt.restored_step == 3
    _assert_holds(model, state, trained[-1])


@pytest.mark.parametrize('mode', ['corrupt', 'truncate'])
def test_corrupt_latest_falls_back_to_previous(tmp_path, trained, mode,
                                               capsys):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    corrupt_checkpoint(ckpt.directory, 3, mode=mode)
    assert ckpt.verify(3), 'damage must be detectable'
    model, state = _fresh()
    ckpt.restore(model, state)
    assert ckpt.restored_step == 2
    _assert_holds(model, state, trained[1])
    assert 'falling back' in capsys.readouterr().err


def test_unverified_damage_falls_back_through_the_load(tmp_path, trained,
                                                      capsys):
    """Without manifests a damaged step is caught by its load."""
    ckpt = _save_all(tmp_path / 'ckpt', trained, verify=False)
    corrupt_checkpoint(ckpt.directory, 3, mode='truncate')
    model, state = _fresh()
    ckpt.restore(model, state)
    assert ckpt.restored_step == 2
    _assert_holds(model, state, trained[1])
    assert 'could not be restored' in capsys.readouterr().err


def test_every_checkpoint_corrupt_raises_actionable(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    for step in (1, 2, 3):
        corrupt_checkpoint(ckpt.directory, step)
    with pytest.raises(CheckpointCorruptError) as e:
        ckpt.restore(*_fresh())
    for step in (1, 2, 3):
        assert f'step {step}' in str(e.value)
    assert 'Delete' in str(e.value)


def test_explicit_missing_step_names_available(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    with pytest.raises(FileNotFoundError) as e:
        ckpt.restore(*_fresh(), step=7)
    assert '[1, 2, 3]' in str(e.value)


def test_explicit_corrupt_step_raises_not_falls_back(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    corrupt_checkpoint(ckpt.directory, 2)
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(*_fresh(), step=2)
    model, state = _fresh()
    ckpt.restore(model, state, step=1)
    _assert_holds(model, state, trained[0])


def test_explicit_step_with_fallback_walks_back(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    corrupt_checkpoint(ckpt.directory, 3)
    model, state = _fresh()
    ckpt.restore(model, state, step=3, fallback=True)
    assert ckpt.restored_step == 2
    _assert_holds(model, state, trained[1])


def test_resave_over_existing_step_overwrites(tmp_path, trained):
    """After a corrupt-latest fallback the resumed run re-runs the epoch
    and saves the same step: that save replaces the torn step and its
    manifest."""
    ckpt = _save_all(tmp_path / 'ckpt', trained)
    corrupt_checkpoint(ckpt.directory, 3)
    ckpt.restore(*_fresh())
    assert ckpt.restored_step == 2
    ckpt.save(3, *_carrier(trained[2]))
    assert ckpt.verify(3) == [], 'the manifest must match the new step 3'
    model, state = _fresh()
    ckpt.restore(model, state)
    assert ckpt.restored_step == 3
    _assert_holds(model, state, trained[2])


def test_verify_disabled_skips_manifests(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained, verify=False)
    assert not os.path.isdir(os.path.join(ckpt.directory,
                                          MANIFEST_DIRNAME))
    ckpt.restore(*_fresh())
    assert ckpt.restored_step == 3


def test_retention_drops_retired_manifests(tmp_path, trained):
    ckpt = _save_all(tmp_path / 'ckpt', trained, max_to_keep=2)
    assert ckpt.all_steps() == [2, 3]
    kept = sorted(os.listdir(os.path.join(ckpt.directory,
                                          MANIFEST_DIRNAME)))
    assert kept == ['2.json', '3.json'], kept


def test_resume_empty_dir_is_fresh_start(tmp_path):
    model, state = _fresh()
    ckpt, out, start = resume_or_init(str(tmp_path / 'ck'), state, model)
    assert start == 1 and out is state and ckpt is not None


def test_resume_none_dir_disables_checkpointing():
    model, state = _fresh()
    ckpt, out, start = resume_or_init(None, state, model)
    assert ckpt is None and out is state and start == 1


def test_resume_torn_latest_falls_back(tmp_path, trained, capsys):
    _save_all(tmp_path / 'ckpt', trained)
    corrupt_checkpoint(str(tmp_path / 'ckpt'), 3, mode='truncate')
    model, state = _fresh()
    _, out, start = resume_or_init(str(tmp_path / 'ckpt'), state, model)
    assert start == 3
    _assert_holds(model, out, trained[1])
    printed = capsys.readouterr().out
    assert 'at epoch 2.' in printed and 'unrestorable' in printed


def test_resume_all_corrupt_raises_with_instructions(tmp_path, trained):
    _save_all(tmp_path / 'ckpt', trained)
    for step in (1, 2, 3):
        corrupt_checkpoint(str(tmp_path / 'ckpt'), step)
    model, state = _fresh()
    with pytest.raises(CheckpointCorruptError, match='Delete'):
        resume_or_init(str(tmp_path / 'ckpt'), state, model)


def test_resume_guard_turned_on_adopts_plain_checkpoints(tmp_path, trained,
                                                         capsys):
    _save_all(tmp_path / 'ckpt', trained)
    model, state = _fresh(guarded=True)
    state.skip_count.fill_(4)
    state.consec_bad.fill_(2)
    _, out, start = resume_or_init(str(tmp_path / 'ckpt'), state, model)
    assert start == 4 and isinstance(out, GuardedTrainState)
    _assert_holds(model, out, trained[-1])
    assert int(out.skip_count) == 0 and int(out.consec_bad) == 0
    assert '--guard-bad-steps toggled' in capsys.readouterr().err


def test_resume_guard_turned_off_drops_the_ledger(tmp_path, trained,
                                                  capsys):
    _save_all(tmp_path / 'ckpt', trained, guarded=True)
    payload = torch.load(tmp_path / 'ckpt' / '3' / STATE_FILE,
                         weights_only=True)
    assert set(payload['guard']) == {'skip_count', 'consec_bad'}
    model, state = _fresh()
    _, out, start = resume_or_init(str(tmp_path / 'ckpt'), state, model)
    assert start == 4 and not isinstance(out, GuardedTrainState)
    _assert_holds(model, out, trained[-1])
    assert 'skip ledger is dropped' in capsys.readouterr().err


def test_resume_guarded_checkpoint_restores_the_counters(tmp_path,
                                                         trained):
    ckpt = Checkpointer(tmp_path / 'ckpt')
    model, state = _carrier(trained[0], guarded=True)
    state.skip_count.fill_(3)
    state.consec_bad.fill_(1)
    ckpt.save(1, model, state)
    model, fresh = _fresh(guarded=True)
    counters = (fresh.skip_count, fresh.consec_bad)
    _, out, _ = resume_or_init(str(tmp_path / 'ckpt'), fresh, model)
    assert (out.skip_count, out.consec_bad) == counters   # same tensors
    assert int(out.skip_count) == 3 and int(out.consec_bad) == 1


def test_resume_mixed_structure_retention_keeps_newest(tmp_path, trained,
                                                       capsys):
    """Retention holding both kinds (the guard toggled mid-history):
    resume lands on the newest step, converted."""
    ckpt = Checkpointer(tmp_path / 'ckpt')
    ckpt.save(1, *_carrier(trained[0]))
    ckpt.save(2, *_carrier(trained[1], guarded=True))
    model, state = _fresh()
    _, out, start = resume_or_init(str(tmp_path / 'ckpt'), state, model)
    assert start == 3 and not isinstance(out, GuardedTrainState)
    _assert_holds(model, out, trained[1])
    assert '--guard-bad-steps toggled' in capsys.readouterr().err


def test_resume_real_corruption_still_raises_despite_toggle(tmp_path,
                                                            trained):
    _save_all(tmp_path / 'ckpt', trained)
    for step in (1, 2, 3):
        corrupt_checkpoint(str(tmp_path / 'ckpt'), step)
    model, state = _fresh(guarded=True)
    with pytest.raises(CheckpointCorruptError):
        resume_or_init(str(tmp_path / 'ckpt'), state, model)


def test_checkpoint_of_another_model_is_refused(tmp_path, trained,
                                                capsys):
    """A step whose state dict does not fit (another width) does not
    load: the walk goes past it, and alone it raises."""
    ckpt = _save_all(tmp_path / 'ckpt', trained[:1])
    args = dbp15k.parse_args(ARGV + ['--dim', '8'])
    other = dbp15k.build(args, 12)
    ckpt.save(2, other, create_train_state(other))
    model, state = _fresh()
    ckpt.restore(model, state)
    assert ckpt.restored_step == 1
    assert 'could not be restored' in capsys.readouterr().err
    with pytest.raises(CheckpointCorruptError, match='where the model has'):
        ckpt.restore(model, state, step=2)


# -- JAX's initial weights through a checkpoint -----------------------------

def test_converted_jax_initial_state_restores_to_jax_forward(tmp_path):
    """JAX's initial DBP15K-configuration parameters (small widths),
    converted, saved as step 0 and restored into a model drawn from
    another seed: the eval forward equals JAX's ``DGMC.apply`` on the same
    pair, JAX's indicator noise injected. The step-0 checkpoint also
    starts the port's CLI (``Resumed ... at epoch 0``, then epoch 1)."""
    import jax
    from flax import linen as nn

    from dgmc_tpu.experiments import dbp15k as jax_dbp15k
    from dgmc_tpu.models import DGMC as JaxDGMC
    from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
    from dgmc_tpu.train.state import create_train_state as jax_state
    from dgmc_tpu_torch.convert import dgmc_from_flax

    jargs = jax_dbp15k.parse_args([a for a in ARGV if a not in (
        '--device', 'cpu')] + ['--k', '5'])
    jtrain, jtest, in_dim = jax_dbp15k.synthetic_batches(jargs)
    jm = JaxDGMC(
        JaxRelCNN(in_dim, jargs.dim, jargs.num_layers, batch_norm=False,
                  cat=True, lin=True, dropout=0.5),
        JaxRelCNN(jargs.rnd_dim, jargs.rnd_dim, jargs.num_layers,
                  batch_norm=False, cat=True, lin=True, dropout=0.0),
        num_steps=jargs.num_steps, k=jargs.k)
    params = jax_state(jm, jax.random.key(0), jtrain,
                       learning_rate=jargs.lr).params
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__' and not seen):
            seen.append(np.array(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        S_0, S_L = jm.apply({'params': params}, jtest.s, jtest.t,
                            train=False, rngs={'noise': jax.random.key(3)})
    targs = dbp15k.parse_args(ARGV + ['--k', '5'])
    _, test, _ = dbp15k.synthetic_batches(targs)
    source = dbp15k.build(targs, in_dim)
    source.load_state_dict(dgmc_from_flax(jax.device_get(params)))
    ckpt_dir = str(tmp_path / 'ckpt')
    Checkpointer(ckpt_dir).save(0, source, create_train_state(source))

    model = dbp15k.build(dbp15k.parse_args(ARGV + ['--k', '5', '--seed',
                                                   '3']), in_dim)
    state = create_train_state(model)
    _, state, start = resume_or_init(ckpt_dir, state, model)
    assert start == 1 and state.step == 0 and not state.optimizer.state
    g_s, g_t, _, _ = batch_to_device(test, 'cpu')
    N_s, steps, R = g_s.x.shape[1], jargs.num_steps, jargs.rnd_dim
    r_s = seen[0].reshape(1, N_s, steps, R).transpose(2, 0, 1, 3)
    with torch.no_grad():
        got = model.eval()(g_s, g_t, r_s=torch.from_numpy(r_s))
    for c, want in zip(got, (S_0, S_L)):
        np.testing.assert_array_equal(c.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(c.val.numpy(), np.asarray(want.val),
                                   rtol=1e-4, atol=1e-5)

    epochs = []
    dbp15k.main(ARGV + ['--k', '5', '--seed', '3', '--epochs', '1',
                        '--ckpt_dir', ckpt_dir],
                hook=lambda kind, epoch, out: epochs.append(epoch))
    assert epochs == [1]


# -- the CLI: resume bit for bit ---------------------------------------------

def _cli(argv):
    """``dbp15k.main(argv)``: ``(state, eval lines, hook records,
    standard output)``; a run stopped by an injected fault returns
    ``None`` for the state."""
    import contextlib
    import io
    buf, records = io.StringIO(), []
    state = None
    with contextlib.redirect_stdout(buf):
        try:
            state = dbp15k.main(argv, hook=lambda kind, epoch, out: (
                records.append((kind, epoch, out))))
        except FaultInjected:
            pass
    lines = [re.sub(r' \([0-9.]+s/epoch\)', '', line)
             for line in buf.getvalue().splitlines()
             if re.match(r'\d{3}: Loss', line)]
    return state, lines, records, buf.getvalue()


@pytest.fixture(scope='module')
def uninterrupted(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp('cli') / 'A')
    state, lines, records, _ = _cli(CLI_ARGV + ['--ckpt_dir', ckpt])
    return ckpt, state, lines, records


def _payload(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                      weights_only=True)


def _assert_payloads_equal(a, b):
    assert a['step'] == b['step']
    for k, v in a['model'].items():
        assert torch.equal(v, b['model'][k]), k
    assert a['optimizer']['state'].keys() == b['optimizer']['state'].keys()
    for i, st in a['optimizer']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, b['optimizer']['state'][i][k]), (i, k)


@pytest.mark.parametrize('faults,resumed_at', [
    (['raise@11'], 8),                       # across the phase boundary
    (['ckpt-corrupt@8', 'raise@11'], 4),     # past a corrupt latest step
], ids=['phase-boundary', 'corrupt-latest'])
def test_cli_resume_is_bit_identical(tmp_path, uninterrupted, faults,
                                     resumed_at):
    ckpt_a, state_a, lines_a, _ = uninterrupted
    ckpt = str(tmp_path / 'B')
    argv = CLI_ARGV + ['--ckpt_dir', ckpt, '--metrics_log',
                       str(tmp_path / 'm.jsonl')]
    for f in faults:
        argv += ['--inject-fault', f]
    stopped, first, _, _ = _cli(argv)
    assert stopped is None and first == lines_a[:1]   # epoch 10 printed
    state, lines, records, out = _cli(argv)
    assert f'at epoch {resumed_at}.' in out
    assert records[0][1] == resumed_at + 1
    assert lines == lines_a[-len(lines):] and lines[-1] == lines_a[-1]
    assert state.step == state_a.step == 12
    _assert_payloads_equal(_payload(ckpt_a, 12), _payload(ckpt, 12))
    with open(tmp_path / 'm.jsonl') as f:
        events = [json.loads(line).get('event') for line in f]
    assert {'resume', 'resume_first_step', 'checkpoint'} <= set(events)


def test_cli_guard_alone_matches_unguarded(tmp_path, uninterrupted):
    """``--guard-bad-steps`` with no fault armed, through both phases
    (each leaves some parameters without a gradient): every step clean,
    the eval lines the unguarded run's with the counters at 0 beside
    them, the last checkpoint bit-identical."""
    ckpt_a, _, lines_a, _ = uninterrupted
    ckpt = str(tmp_path / 'G')
    state, lines, records, _ = _cli(CLI_ARGV + ['--ckpt_dir', ckpt,
                                                '--guard-bad-steps', '3'])
    assert lines == [f'{line}, skipped_steps: 0, consec_bad: 0'
                     for line in lines_a]
    assert not any(bool(out['bad_step']) for kind, _, out in records
                   if kind == 'train')
    assert int(state.skip_count) == 0 and state.step == 12
    _assert_payloads_equal(_payload(ckpt_a, 12), _payload(ckpt, 12))


def test_cli_eval_lines_follow_eval_summary(uninterrupted):
    """The printed fractions are ``eval_summary``'s of the eval step's
    sums (JAX's own accounting), formatted as before."""
    from dgmc_tpu.models.evalsum import eval_summary as jax_eval_summary
    _, _, lines, records = uninterrupted
    train = {e: out for kind, e, out in records if kind == 'train'}
    want = []
    for kind, epoch, ev in records:
        if kind != 'eval':
            continue
        n = float(ev['count'])
        hits1 = float(ev['correct']) / max(n, 1.0)
        hits10 = float(ev['hits@10']) / max(n, 1.0)
        want.append(f'{epoch:03d}: Loss: {float(train[epoch]["loss"]):.4f}, '
                    f'Hits@1: {hits1:.4f}, Hits@10: {hits10:.4f}')
    assert lines == want and len(lines) == 3
    for count in (0, 1, 37):
        got = eval_summary(count, loss=0.5, hits1=min(count, 3), hits10=2)
        assert got == jax_eval_summary(count, loss=0.5, hits1=min(count, 3),
                                       hits10=2)
