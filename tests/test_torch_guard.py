"""The in-graph non-finite guard, the rollback guard and the fault
injection of the port, on the CPU.

Ports of the JAX package's ``tests/resilience/test_guard_step.py`` (a bad
step freezes the whole update and counts, the unguarded step is
unchanged, rollback after M, rollback without a snapshot, M = 0) through
the eager and the compiled (static-buffer) step, on a model with batch
norm so that its buffers are held too; the port's guarded step against
JAX's ``make_train_step(guard=True, fault_nan_step=N)`` on converted
parameters; and ports of the single-process cases of
``tests/resilience/test_faults.py``, with the refusal of the kinds the
port does not have.

Tolerances: the frozen step's parameters and Adam state, and the
counters, are equal (bit for bit, in both packages); a clean step's loss
within rtol 1e-5 of JAX's (the steps' tolerance in
``tests/test_torch_compiled.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.resilience import faults
from dgmc_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                              corrupt_checkpoint, parse_spec)
from dgmc_tpu_torch.resilience.guard import RollbackGuard
from dgmc_tpu_torch.train.checkpoint import Checkpointer
from dgmc_tpu_torch.train.state import (GuardedTrainState,
                                        create_train_state,
                                        with_guard_counters)
from dgmc_tpu_torch.train.steps import make_train_step
from dgmc_tpu_torch.utils.data import PairBatch

B, N_S, N_T, E, C, R = 2, 12, 15, 40, 6, 4


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _side(r, n, n_real):
    x = r.randn(B, n, C).astype(np.float32)
    x[:, n_real:] = 0
    mask = np.zeros((B, n), bool)
    mask[:, :n_real] = True
    return {'x': x, 'senders': r.randint(0, n_real, (B, E)).astype(np.int32),
            'receivers': r.randint(0, n_real, (B, E)).astype(np.int32),
            'node_mask': mask, 'edge_mask': r.rand(B, E) > 0.1}


@pytest.fixture(scope='module')
def pair():
    r = np.random.RandomState(0)
    s, t = _side(r, N_S, N_S), _side(r, N_T, N_T - 2)
    y = np.stack([r.permutation(N_T - 2)[:N_S] for _ in range(B)])
    y_mask = r.rand(B, N_S) > 0.2
    return s, t, np.where(y_mask, y, -1).astype(np.int64), y_mask


def _batch(pair):
    s, t, y, y_mask = pair
    return PairBatch(s=s, t=t, y=y, y_mask=y_mask)


def _bn_model():
    """Sparse DGMC with batch norm in ψ₁ and ψ₂: every kind of state a
    step moves (parameters, Adam moments and counts, running averages)."""
    g = torch.Generator().manual_seed(0)
    return DGMC(RelCNN(C, 8, 2, batch_norm=True),
                RelCNN(R, R, 2, batch_norm=True), num_steps=1, k=4,
                generator=g)


def _everything(model, state):
    out = {f'p {k}': v.clone() for k, v in model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        for k, v in st.items():
            out[f'adam {i} {k}'] = v.clone()
    return out


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture
def setup(pair):
    model = _bn_model()
    state = with_guard_counters(create_train_state(model, 1e-2))
    return model, _batch(pair), state


def test_with_guard_counters_structure(setup):
    _model, _batch_, state = setup
    assert isinstance(state, GuardedTrainState)
    for t in (state.skip_count, state.consec_bad):
        assert t.dtype == torch.int32 and t.shape == () and int(t) == 0


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'compiled'])
def test_bad_step_freezes_update_and_counts(setup, jit):
    model, batch, state = setup
    step = make_train_step(model, guard=True, fault_nan_step=2, jit=jit)
    state, out = step(state, batch, 1)
    assert not bool(out['bad_step'])
    before = _everything(model, state)
    counters = (state.skip_count, state.consec_bad)
    state, out = step(state, batch, 2)          # nan-grads fires here
    assert bool(out['bad_step']) and np.isfinite(float(out['loss']))
    assert _equal(_everything(model, state), before)
    # The host's step still advances: the draws and the fault's indexing
    # stay aligned across skips.
    assert state.step == 2
    assert int(state.skip_count) == 1 and int(state.consec_bad) == 1
    assert (int(out['skip_count']), int(out['consec_bad'])) == (1, 1)
    assert (state.skip_count, state.consec_bad) == counters   # in place
    state, out = step(state, batch, 3)
    assert not bool(out['bad_step'])
    assert not _equal(_everything(model, state), before)
    assert int(state.skip_count) == 1 and int(state.consec_bad) == 0


def test_first_step_bad_keeps_the_fresh_optimizer(setup):
    """A bad first step leaves Adam's state as a fresh one (zeros, the
    count 0), which the next step then takes as its first."""
    model, batch, state = setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, out = make_train_step(model, guard=True, fault_nan_step=1,
                                 jit=False)(state, batch, 1)
    assert bool(out['bad_step'])
    assert _equal({f'p {k}': v for k, v in model.state_dict().items()},
                  {f'p {k}': v for k, v in before.items()})
    assert all(not v.any() for st in state.optimizer.state.values()
               for v in st.values())


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'compiled'])
@pytest.mark.parametrize('num_steps,detach', [(None, False), (0, False),
                                              (1, True)],
                         ids=['full', 'phase1', 'phase2'])
def test_guarded_clean_step_equals_unguarded(pair, num_steps, detach, jit):
    """On clean steps the guard changes no bit of the update. DBP15K's
    phases leave parameters without a gradient (phase 1, ``num_steps =
    0``: ψ₂ and the consensus MLP; phase 2, ``detach``: ψ₁): the guard
    takes them as zero gradients, as optax's global norm does, with no
    fault armed."""
    runs = []
    for guard in (False, True):
        model = _bn_model()
        state = create_train_state(model, 1e-2)
        if guard:
            state = with_guard_counters(state)
        step = make_train_step(model, num_steps=num_steps, detach=detach,
                               guard=guard, jit=jit)
        for i in range(2):
            state, out = step(state, _batch(pair), i)
            if guard:
                assert not bool(out['bad_step'])
        runs.append((_everything(model, state), float(out['loss']),
                     sorted(out)))
    assert _equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert runs[0][2] == ['acc', 'loss', 'loss_per_pair']
    assert runs[1][2] == ['acc', 'bad_step', 'consec_bad', 'loss',
                          'loss_per_pair', 'skip_count']
    assert int(state.skip_count) == 0 and int(state.consec_bad) == 0


def test_unguarded_step_unchanged(setup):
    """``guard=False`` and no fault: no ledger in the metrics, and the
    compiled step takes no step-number input."""
    model, batch, _ = setup
    state = create_train_state(model, 1e-2)
    step = make_train_step(model)
    state, out = step(state, batch, 1)
    assert 'bad_step' not in out and 'skip_count' not in out
    (rec,) = step.jit.compiled.records.values()
    assert rec.static[-1] is None
    with pytest.raises(TypeError, match='GuardedTrainState'):
        make_train_step(model, guard=True)(state, batch, 1)


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'compiled'])
def test_rollback_after_m_consecutive(setup, jit):
    model, batch, state = setup
    step = make_train_step(model, guard=True, fault_nan_step=1, jit=jit)
    guard = RollbackGuard(max_consecutive=3)
    guard.note_good(state, model, step=0)
    good = {k: v.clone() for k, v in model.state_dict().items()}
    rolled_at = None
    for i in range(1, 5):
        # nan-grads fires at state.step == 0 only: hold it there to make
        # every step bad.
        state.step = 0
        state, out = step(state, batch, i)
        assert bool(out['bad_step'])
        state, rolled = guard.maybe_rollback(state, model,
                                             int(state.consec_bad), step=i)
        if rolled:
            rolled_at = i
            break
    assert rolled_at == 3 and guard.rollbacks == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, good[k]), k
    assert state.step == 1
    assert int(state.skip_count) == 3 and int(state.consec_bad) == 0


def test_rollback_restores_snapshot_with_fresh_optimizer(setup, tmp_path):
    """After a rollback the next step equals a fresh train state's first
    step from the snapshot, bit for bit; the rollback is logged."""
    from dgmc_tpu_torch.obs.observe import MetricLogger
    model, batch, state = setup
    step = make_train_step(model, guard=True, fault_nan_step=3, jit=False)
    for i in range(1, 3):
        state, _ = step(state, batch, i)
    with MetricLogger(str(tmp_path / 'm.jsonl')) as logger:
        guard = RollbackGuard(1, logger)
        guard.note_good(state, model, step=2)
        snap = {k: v.clone() for k, v in model.state_dict().items()}
        state, out = step(state, batch, 3)
        state, rolled = guard.maybe_rollback(state, model,
                                             int(out['consec_bad']), step=3)
    assert rolled and state.step == 3
    state, _ = step(state, batch, 4)
    after = _everything(model, state)
    ref = _bn_model()
    ref.load_state_dict(snap)
    ref_state = with_guard_counters(create_train_state(ref, 1e-2))
    make_train_step(ref, guard=True, jit=False)(ref_state, batch, 4)
    assert _equal(after, _everything(ref, ref_state))
    with open(tmp_path / 'm.jsonl') as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec['event'] == 'rollback' and rec['rollback_to'] == 2
    assert rec['consec_bad'] == 1 and rec['rollbacks'] == 1


def test_rollback_without_snapshot_reports_and_holds(setup, capsys):
    model, _batch_, state = setup
    guard = RollbackGuard(max_consecutive=2)
    out_state, rolled = guard.maybe_rollback(state, model, 5, step=1)
    assert not rolled and out_state is state
    assert 'no good snapshot' in capsys.readouterr().err


def test_rollback_disabled_with_zero(setup):
    model, _batch_, state = setup
    guard = RollbackGuard(max_consecutive=0)
    guard.note_good(state, model, step=0)
    _out, rolled = guard.maybe_rollback(state, model, 100, step=1)
    assert not rolled


def test_guarded_checkpoint_round_trip(setup, tmp_path):
    """The counters ride the checkpoint."""
    model, batch, state = setup
    step = make_train_step(model, guard=True, fault_nan_step=1, jit=False)
    state, _ = step(state, batch, 1)
    Checkpointer(tmp_path / 'ck').save(1, model, state)
    fresh = with_guard_counters(create_train_state(_bn_model(), 1e-2))
    other = _bn_model()
    Checkpointer(tmp_path / 'ck').restore(other, fresh)
    assert int(fresh.skip_count) == 1 and int(fresh.consec_bad) == 1


# -- against JAX's guarded step ---------------------------------------------

@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'compiled'])
def test_guarded_step_matches_jax(pair, jit):
    """Three steps with ``nan-grads@2`` in both packages (dense DGMC,
    num_steps = 0, no dropout: no random draw in either), the port's
    state set to JAX's before each step: the counters and ``bad_step``
    equal, the frozen step's parameters and Adam state equal JAX's bit
    for bit, a clean step's loss within rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from dgmc_tpu.models import DGMC as JaxDGMC
    from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
    from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
    from dgmc_tpu.train import create_train_state as jax_state
    from dgmc_tpu.train import make_train_step as jax_step
    from dgmc_tpu.train import with_guard_counters as jax_guard
    from dgmc_tpu.utils.data import PairBatch as JaxPairBatch
    from dgmc_tpu_torch.convert import dgmc_from_flax

    s, t, y, y_mask = pair

    def jgraph(a):
        return JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                             edge_attr=None)

    jbatch = JaxPairBatch(s=jgraph(s), t=jgraph(t),
                          y=jnp.asarray(y, jnp.int32),
                          y_mask=jnp.asarray(y_mask))
    jm = JaxDGMC(JaxRelCNN(C, 8, 2, dropout=0.0), JaxRelCNN(R, R, 2),
                 num_steps=1, k=-1)
    jstate = jax_guard(jax_state(jm, jax.random.key(0), jbatch,
                                 learning_rate=1e-2))
    jtrain = jax_step(jm, num_steps=0, guard=True, fault_nan_step=2)
    tm = DGMC(RelCNN(C, 8, 2), RelCNN(R, R, 2), num_steps=1, k=-1)
    state = with_guard_counters(create_train_state(tm, 1e-2))
    step = make_train_step(tm, num_steps=0, guard=True, fault_nan_step=2,
                           jit=jit)

    def host(js):
        return jax.tree.map(np.asarray, jax.device_get(js))

    for i in range(3):
        pre = host(jstate)
        tm.load_state_dict(dgmc_from_flax(pre.params))
        adam = pre.opt_state[0]
        if int(adam.count):
            mu, nu = dgmc_from_flax(adam.mu), dgmc_from_flax(adam.nu)
            with torch.no_grad():
                for name, p in tm.named_parameters():
                    st = state.optimizer.state[p]
                    st['exp_avg'].copy_(mu[name])
                    st['exp_avg_sq'].copy_(nu[name])
                    st['step'].fill_(int(adam.count))
        state.step = int(pre.step)
        state.skip_count.fill_(int(pre.skip_count))
        state.consec_bad.fill_(int(pre.consec_bad))
        before = _everything(tm, state)
        jstate, jout = jtrain(jstate, jbatch, jax.random.key(7 + i))
        state, out = step(state, _batch(pair), i)
        assert bool(out['bad_step']) == bool(jout['bad_step']) == (i == 1)
        assert int(out['skip_count']) == int(jout['skip_count'])
        assert int(out['consec_bad']) == int(jout['consec_bad'])
        np.testing.assert_allclose(float(out['loss']), float(jout['loss']),
                                   rtol=1e-5, err_msg=f'step {i}')
        if i == 1:
            assert _equal(_everything(tm, state), before)
            post = host(jstate)
            want = dgmc_from_flax(post.params)
            for name, v in tm.state_dict().items():
                assert torch.equal(v, want[name]), name
            assert int(post.opt_state[0].count) == int(adam.count)
    assert (int(state.skip_count), int(state.consec_bad)) == (1, 0)


# -- tests/resilience/test_faults.py (single-process kinds) ----------------

@pytest.mark.parametrize('text,kind,step,arg', [
    ('raise@3', 'raise', 3, None),
    ('sigterm@1', 'sigterm', 1, None),
    ('sigkill@12', 'sigkill', 12, None),
    ('stall@4', 'stall', 4, 3600.0),
    ('stall@4:2.5', 'stall', 4, 2.5),
    ('nan-grads@7', 'nan-grads', 7, None),
    ('ckpt-truncate@2', 'ckpt-truncate', 2, None),
    ('ckpt-corrupt@2', 'ckpt-corrupt', 2, None),
])
def test_parse_spec(text, kind, step, arg):
    spec = parse_spec(text)
    assert (spec.kind, spec.step, spec.arg) == (kind, step, arg)
    assert spec.key == f'{kind}@{step}'


@pytest.mark.parametrize('bad', [
    'explode@3',          # unknown kind
    'raise',              # step required
    'sigkill',            # step required
    'raise@x',            # non-integer step
    'raise@3:1',          # only stall takes an argument
])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_spec(bad)


@pytest.mark.parametrize('text', [
    'peer-death@4', 'peer-death@4:1', 'coord-partition@5',
    'collective-stall@3', 'collective-stall@3:7.5', 'straggler@2:250',
    'download-fail', 'download-fail:3'])
def test_kinds_not_ported_are_refused_at_parse_time(text):
    """The multi-host, obs and download kinds are refused by name, never
    ignored: at parse time and through the CLI's parser."""
    from dgmc_tpu_torch.experiments import dbp15k
    with pytest.raises(ValueError, match='not ported yet'):
        parse_spec(text)
    args = dbp15k.parse_args(['--synthetic', '--inject-fault', text])
    with pytest.raises(ValueError, match='not ported yet'):
        FaultPlan.from_args(args)


def test_raise_fires_at_exact_step(tmp_path):
    plan = FaultPlan(['raise@3'], state_dir=str(tmp_path))
    plan.before_step(1)
    plan.before_step(2)
    with pytest.raises(FaultInjected):
        plan.before_step(3)


def test_ledger_prevents_refire_across_restarts(tmp_path):
    plan = FaultPlan(['raise@3'], state_dir=str(tmp_path))
    with pytest.raises(FaultInjected):
        plan.before_step(3)
    with open(tmp_path / faults.FIRED_LEDGER) as f:
        assert json.load(f)['fired'] == ['raise@3']
    FaultPlan(['raise@3'], state_dir=str(tmp_path)).before_step(3)


def test_no_state_dir_refires_in_fresh_plan():
    plan = FaultPlan(['raise@2'], state_dir=None)
    with pytest.raises(FaultInjected):
        plan.before_step(2)
    plan.before_step(2)   # the same plan: already fired
    with pytest.raises(FaultInjected):
        FaultPlan(['raise@2'], state_dir=None).before_step(2)


def test_kill_kinds_mark_the_ledger_before_the_signal(tmp_path,
                                                      monkeypatch):
    import signal
    kills = []
    monkeypatch.setattr(faults.os, 'kill',
                        lambda pid, sig: kills.append((pid, sig)))
    monkeypatch.setattr(faults.time, 'sleep', lambda s: None)
    plan = FaultPlan(['sigkill@2', 'sigterm@3'], state_dir=str(tmp_path))
    for step, sig in ((2, signal.SIGKILL), (3, signal.SIGTERM)):
        with pytest.raises(FaultInjected, match='survived'):
            plan.before_step(step)
        assert kills[-1] == (os.getpid(), sig)
    with open(tmp_path / faults.FIRED_LEDGER) as f:
        assert json.load(f)['fired'] == ['sigkill@2', 'sigterm@3']


def test_stall_sleeps_its_seconds_once(tmp_path, monkeypatch):
    naps = []
    monkeypatch.setattr(faults.time, 'sleep', naps.append)
    plan = FaultPlan(['stall@2:1.5'], state_dir=str(tmp_path))
    for step in (1, 2, 2, 3):
        plan.before_step(step)
    assert naps == [1.5]


def test_nan_grads_not_ledgered(tmp_path):
    plan = FaultPlan(['nan-grads@4'], state_dir=str(tmp_path))
    assert plan.nan_grads_step == 4
    for step in range(1, 10):
        plan.before_step(step)
    assert not os.path.exists(tmp_path / faults.FIRED_LEDGER)


def _fake_step_dir(tmp_path, step=3):
    d = tmp_path / str(step) / 'default'
    d.mkdir(parents=True)
    (d / 'small.bin').write_bytes(b'x' * 64)
    (d / 'big.bin').write_bytes(bytes(range(256)) * 64)
    return d / 'big.bin'


def test_corrupt_checkpoint_truncates_largest(tmp_path):
    big = _fake_step_dir(tmp_path)
    orig = big.stat().st_size
    assert corrupt_checkpoint(str(tmp_path), 3, mode='truncate') == str(big)
    assert big.stat().st_size == orig // 2


def test_corrupt_checkpoint_flips_bytes(tmp_path):
    big = _fake_step_dir(tmp_path)
    orig = big.read_bytes()
    assert corrupt_checkpoint(str(tmp_path), 3, mode='corrupt') == str(big)
    damaged = big.read_bytes()
    assert len(damaged) == len(orig) and damaged != orig


def test_corrupt_checkpoint_missing_step(tmp_path):
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(str(tmp_path), 9)


def test_after_checkpoint_damages_the_saved_step_once(tmp_path, setup):
    model, _batch_, state = setup
    ckpt = Checkpointer(tmp_path / 'ck')
    ckpt.save(2, model, state)
    plan = FaultPlan(['ckpt-truncate@2'], state_dir=str(tmp_path / 'ck'))
    plan.after_checkpoint(ckpt, 1)
    assert ckpt.verify(2) == []
    plan.after_checkpoint(ckpt, 2)
    assert ckpt.verify(2)
    ckpt.save(2, model, state)
    FaultPlan(['ckpt-truncate@2'], state_dir=str(tmp_path / 'ck')) \
        .after_checkpoint(ckpt, 2)
    assert ckpt.verify(2) == []
