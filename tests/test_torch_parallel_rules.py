"""The port's partition rules (``dgmc_tpu_torch/parallel/rules.py``)
against JAX's (``dgmc_tpu/parallel/rules.py``, ``tests/parallel/
test_rules.py``): the matcher's semantics (first match wins, an
unmatched leaf raises naming its path, scalars get ``()``), the train
state typed by one rule list with JAX's leaf paths, shapes and values
leaf for leaf (params, Adam's moments and count, the guard counters),
the config objects, the streamed forward, and ``streamed_rules``' train
and eval steps over 2 and 4 gloo ranks against the one-process steps
(and against JAX's sharded steps, marked slow where JAX marks its test).

Tolerances of the streamed steps: the loss within rel 1e-5 of one
process and rel 1e-4 of JAX, the eval sums equal, the parameters after
one SGD step within atol 1e-6 / rtol 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgmc_tpu.parallel import match_partition_rules as jax_match
from dgmc_tpu.parallel.rules import leaf_path_str
from dgmc_tpu.train import create_train_state as jax_create_state
from dgmc_tpu.train import with_guard_counters as jax_guard
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.parallel import (PartitionRules, corr_row_rules,
                                     make_mesh, match_partition_rules,
                                     replicated_rules, shard_tree,
                                     state_tree, streamed_rules,
                                     tree_shardings)
from dgmc_tpu_torch.parallel.rules import leaf_paths
from dgmc_tpu_torch.train.state import (create_train_state,
                                        optimizer_update,
                                        with_guard_counters)
from tests import torch_parallel_jobs as jobs
from tests.torch_dist_worker import run_groups
from tests.torch_parallel_ref import case as jax_case
from tests.train.test_steps import tiny_loader, tiny_model

WORLDS = (2, 4)


def test_first_match_wins():
    tree = {'params': {'psi_1': {'kernel': np.ones((4, 8))},
                       'psi_2': {'kernel': np.ones((4, 8))}}}
    specs = match_partition_rules(
        ((r'psi_1/kernel', ('data',)), (r'kernel', ('model',)),
         (r'.*', ())), tree)
    assert specs['params']['psi_1']['kernel'] == ('data',)
    assert specs['params']['psi_2']['kernel'] == ('model',)


def test_unmatched_leaf_raises_with_path():
    tree = {'params': {'deep': {'odd_name': np.ones((4, 8))}}}
    with pytest.raises(ValueError, match=r'params/deep/odd_name'):
        match_partition_rules(((r'kernel', ()),), tree)


def test_scalars_never_partitioned():
    tree = {'count': np.int32(3), 'one': np.ones((1,)),
            'vec': np.ones((8,))}
    specs = match_partition_rules(((r'.*', ('data',)),), tree)
    assert specs == {'count': (), 'one': (), 'vec': ('data',)}


@pytest.fixture(scope='module')
def guarded():
    """JAX's guarded Adam state of the tiny sparse model and the port's
    state over the same weights, Adam's moments made (one update of zero
    gradients: optax makes them at init, torch at the first step)."""
    jm = tiny_model(k=4)
    jb = next(iter(tiny_loader(batch_size=2)))
    jstate = jax_guard(jax.jit(lambda b: jax_create_state(
        jm, jax.random.key(0), b, tx=optax.adam(1e-3)))(jb))
    model = jobs.build_model(('spline', 4, 2))
    model.load_state_dict(dgmc_from_flax(jax.device_get(jstate.params)))
    state = with_guard_counters(create_train_state(model))
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    optimizer_update(state)
    return jstate, state, model


RULES = ((r'hidden_kernel$', (None, 'model')), (r'.*', ()))


def test_state_paths_equal_jax_leaf_for_leaf(guarded):
    """One rule list types the whole state in both packages: the same
    paths, each leaf of the same shape (a ``Linear`` weight as JAX's
    ``[in, out]``), the same spec, the parameters equal."""
    jstate, state, model = guarded
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    want = {leaf_path_str(p): np.asarray(v) for p, v in flat}
    got = dict(leaf_paths(state_tree(state, model)))
    assert set(got) == set(want)
    jspecs = {leaf_path_str(p): s for p, s in jax.tree_util.
              tree_flatten_with_path(jax_match(
                  tuple((r, P(*s)) for r, s in RULES), jstate),
                  is_leaf=lambda x: isinstance(x, P))[0]}
    specs = dict(leaf_paths(match_partition_rules(RULES,
                                                  state_tree(state, model))))
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert specs[path] == tuple(jspecs[path]), path
        if path.startswith('params/'):
            np.testing.assert_array_equal(got[path].detach().numpy(), w)
    kernels = [p for p in specs if p.endswith('hidden_kernel')]
    assert any(p.startswith('opt_state') for p in kernels)
    for counter in ('step', 'skip_count', 'consec_bad',
                    'opt_state/0/count'):
        assert specs[counter] == ()


def test_shard_tree_places_each_leaf_per_its_rule(guarded):
    """A one-rank mesh: every leaf whole on its device, values equal, and
    ``tree_shardings`` the same specs over the mesh."""
    _, state, model = guarded
    mesh = make_mesh(device='cpu')
    tree = state_tree(state, model)
    placed = dict(leaf_paths(shard_tree(tree, RULES, mesh)))
    for path, leaf in leaf_paths(tree):
        torch.testing.assert_close(placed[path], torch.as_tensor(leaf))
    sh = dict(leaf_paths(tree_shardings(RULES, tree, mesh)))
    assert sh['params/mlp_hidden_kernel'].spec == (None, 'model')
    assert sh['params/mlp_hidden_kernel'].mesh is mesh


def test_place_refuses_a_sharded_state(guarded):
    _, state, model = guarded
    mesh = make_mesh(device='cpu')
    with pytest.raises(ValueError, match='hidden_kernel'):
        PartitionRules(state=RULES).place(state, jobs.bn_batch(), mesh,
                                          model)
    placed_state, batch = replicated_rules(batch_axis=None).place(
        state, jobs.bn_batch(), mesh, model)
    assert placed_state is state and batch.y.shape == (8, 8)


def test_builders_and_resume_refuse_a_sharded_state(guarded, tmp_path):
    """JAX's ``state=`` of the sharded builders and ``rules=`` of
    ``resume_or_init`` are checked: a rule that shards a leaf of the
    replicated state raises; replicating rules build and resume."""
    from dgmc_tpu_torch.parallel import (make_sharded_eval_step,
                                         make_sharded_train_step)
    from dgmc_tpu_torch.train.checkpoint import resume_or_init
    _, state, model = guarded
    mesh = make_mesh(device='cpu')
    sharded, plain = PartitionRules(state=RULES), replicated_rules(None)
    for build in (make_sharded_train_step, make_sharded_eval_step):
        with pytest.raises(ValueError, match='hidden_kernel'):
            build(model, mesh, rules=sharded, state=state)
        assert callable(build(model, mesh, rules=plain, state=state))
    with pytest.raises(ValueError, match='hidden_kernel'):
        resume_or_init(str(tmp_path), state, model, mesh=mesh,
                       rules=sharded)
    assert resume_or_init(str(tmp_path), state, model, mesh=mesh,
                          rules=plain)[2] == 1


def test_replicated_rules_match_legacy_behavior():
    rules = replicated_rules()
    assert rules.batch == ('data',)
    assert rules.activation_spec('corr') is None
    st = streamed_rules(stream_chunk=64)
    assert st.activation_spec('corr') == (None, 'data')
    assert st.ring_targets and st.stream_chunk == 64
    assert PartitionRules(
        activations={'corr': (None, 'data')}).activation_spec('topk') \
        == (None, 'data')
    assert corr_row_rules().activation_spec('psi2') == ('data', 'model')


def test_apply_to_model_shares_the_parameters(guarded):
    _, _, model = guarded
    mesh = make_mesh(device='cpu')
    rules = streamed_rules(stream_chunk=4, topk_block=8)
    laid = rules.apply_to_model(model, mesh)
    assert laid is not model and model.row_layout() is None
    assert laid.row_layout() is not None
    assert (laid.stream_chunk, laid.ring_targets, laid.topk_block) == (
        4, True, 8)
    assert all(a is b for a, b in zip(laid.parameters(),
                                      model.parameters()))
    # JAX's ψ₁ table rule needs the correspondence rows on its axis.
    with pytest.raises(ValueError, match='ψ₁.*correspondence rows'):
        PartitionRules(activations={'psi1': (None, 'data')}).apply_to_model(
            model, mesh)


def _pair(batch):
    return (GraphBatch.from_numpy(batch.s, 'cpu'),
            GraphBatch.from_numpy(batch.t, 'cpu'))


def test_stream_chunk_matches_unstreamed_forward():
    """Streaming the source rows is scheduling only: the same shortlist,
    the same probabilities (``test_stream_chunk_matches_unstreamed_
    forward``; 5 rows a chunk against N_s = 12)."""
    case = jobs.port_case('port', 'rows', 4, 2)
    base = jobs.build_model(case['model'])
    base.load_state_dict({k: torch.as_tensor(v)
                          for k, v in case['state_dict'].items()})
    g_s, g_t = _pair(case['batch'])
    with torch.no_grad():
        a0, aL = base.eval()(g_s, g_t, noise_seed=7)
        b0, bL = base.with_layout(stream_chunk=5)(g_s, g_t, noise_seed=7)
    torch.testing.assert_close(a0.idx, b0.idx, rtol=0, atol=0)
    torch.testing.assert_close(a0.val, b0.val, rtol=0, atol=1e-6)
    torch.testing.assert_close(aL.val, bL.val, rtol=0, atol=1e-6)


def test_streamed_dense_rejected():
    model = jobs.build_model(('spline', -1, 2)).with_layout(stream_chunk=8)
    with pytest.raises(ValueError, match='stream_chunk'):
        model(None, None)


@pytest.fixture(scope='module')
def streamed():
    cases = {'port-streamed': jobs.port_case('port-streamed', 'rows', 4, 1)}
    out = run_groups([('tests.torch_parallel_jobs:step_cases', w, (cases,))
                      for w in WORLDS])
    return cases, dict(zip(WORLDS, out))


def _hold(got, want, rel):
    assert float(got['metrics']['loss']) == pytest.approx(
        float(want['metrics']['loss']), rel=rel)
    assert float(got['metrics']['acc']) == pytest.approx(
        float(want['metrics']['acc']), abs=1e-6)
    for key, w in want['state'].items():
        np.testing.assert_allclose(got['state'][key], w, rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize('world', WORLDS)
def test_streamed_rules_train_eval_match_reference(streamed, world):
    cases, ranks = streamed
    one = jobs.one_step(cases['port-streamed'], False)
    for got in (r['port-streamed'] for r in ranks[world]):
        _hold(got, one, 1e-5)
        assert {k: int(v) for k, v in got['evals'].items()} == {
            k: int(v) for k, v in one['evals'].items()}


@pytest.mark.slow
def test_streamed_rules_match_jax_sharded_steps():
    """JAX's streamed case (slow in JAX too): its weights and draws on 2
    and 4 ranks against its sharded train and eval steps."""
    port, want = jax_case('streamed')
    ranks = run_groups([('tests.torch_parallel_jobs:step_cases', w,
                         ({'streamed': port},)) for w in WORLDS])
    for r in ranks:
        got = r[0]['streamed']
        _hold(got, want, 1e-4)
        assert {k: int(got['evals'][k]) for k in ('count', 'correct')} == {
            k: int(want['eval'][k]) for k in ('count', 'correct')}
