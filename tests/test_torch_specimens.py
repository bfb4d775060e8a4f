"""The port's specimen registry, its trace tier on the CPU, its static
peak and the specimen cost CLI.

- The registry holds JAX's eight single-device specimens under JAX's
  names, in JAX's order, on the same inputs (the same numpy draws).
- With JAX's initial parameters (``convert.py``) and the indicator
  noise (and negatives) JAX's forward drew, each forward, eval and
  train-step specimen gives JAX's outputs and loss within rtol / atol
  1e-5 (the port's float32 gates).
- Over the eight specimens the trace tier gives no finding outside the
  committed ``lint-baseline-torch.json`` and no TRC003 or TRC004 at all;
  each specimen is built and run once per process, whichever of the
  tier, the liveness bound and the cost CLI asks.
- The static peak lies between the largest buffer and the sum of all.
- ``python -m dgmc_tpu_torch.obs.cost`` writes ``specimen.*`` rows with
  ``static_peak_bytes`` into an obs dir, keeps its run rows and reruns
  idempotently; ``obs.diff --max-peak-regression`` passes on the dir
  against itself and fails once the static peaks grow by half.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu_torch.analysis import registry
from dgmc_tpu_torch.analysis.findings import (default_baseline_path,
                                              load_baseline,
                                              split_by_baseline)
from dgmc_tpu_torch.analysis.liveness import module_peak
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.obs import cost as cost_mod
from dgmc_tpu_torch.obs import diff as diff_mod
from tests.torch_jax_worker import jax_analysis

#: Parameters whose gradient is zero in exact arithmetic.
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')

NAMES = ['forward_dense', 'forward_sparse_k3', 'train_step_dense',
         'train_step_sparse_k3', 'eval_step_dense', 'ops.chunked_topk_f32',
         'ops.masked_softmax', 'ops.segment_sum']


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_registry():
    with jax_analysis('dgmc_tpu.analysis.registry') as m:
        yield m['registry']


@pytest.fixture(scope='module')
def tier():
    """The trace tier over the eight specimens on the CPU, through this
    process's shared cache (the cost CLI below reads the same runs)."""
    cache = registry.shared_cache('cpu')
    findings = registry.run_trace_tier(
        [s for s in registry.default_specimens() if not s.min_devices],
        cache=cache)
    return cache, findings


def test_names_order_and_inputs_equal_jax(jax_registry):
    want = [s.name for s in jax_registry.default_specimens()
            if not s.min_devices and 'trace' in s.tiers]
    assert want == NAMES
    assert [s.name for s in registry.default_specimens()
            if not s.min_devices] == NAMES
    # JAX's mesh specimens follow, with JAX's names, order, minimum
    # device counts and tiers.
    assert [(s.name, s.min_devices, s.tiers)
            for s in registry.default_specimens()] == [
        (s.name, s.min_devices, s.tiers)
        for s in jax_registry.default_specimens()]
    jb = jax_registry._pair_batch(np.random.RandomState(0))
    pb = registry.pair_batch()
    for side in ('s', 't'):
        for k, v in pb.__dict__[side].items():
            np.testing.assert_array_equal(v, np.asarray(getattr(
                getattr(jb, side), k)), err_msg=f'{side}.{k}')
    np.testing.assert_array_equal(pb.y, jb.y)
    np.testing.assert_array_equal(pb.y_mask, jb.y_mask)
    for name in NAMES[5:]:
        (jspec,) = [s for s in jax_registry.default_specimens()
                    if s.name == name]
        (pspec,) = [s for s in registry.default_specimens()
                    if s.name == name]
        jargs = jspec.build()['args']
        pargs = pspec.build(torch.device('cpu'))['args']
        assert len(jargs) == len(pargs)
        for a, b in zip(jargs, pargs):
            assert tuple(np.shape(a)) == tuple(b.shape)
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_specimens_declare_their_inplace_state():
    for spec in registry.default_specimens():
        if spec.min_devices:
            continue      # built on ranks (tests/test_torch_mesh_*.py)
        built = spec.build(torch.device('cpu'))
        if spec.name.startswith('train_step'):
            names = set(built['inplace']())
            assert built['inplace_argnums'] == (0,)
            assert any(n.startswith('param:psi_1') for n in names)
        else:
            assert 'inplace' not in built


# ---------------------------------------------------------------------------
# Outputs against JAX's
# ---------------------------------------------------------------------------


def _jax_case(jax_registry, k, train):
    """JAX's specimen model, state and batch, its forward's outputs and
    the noise (and negatives) that forward drew."""
    model, state, batch = jax_registry._model_state_batch(k)
    params = jax.device_get(state.params)
    key = jax.random.key(1)
    rngs = {'noise': key}
    if train:
        k_noise, k_neg, _ = jax.random.split(key, 3)
        rngs = {'noise': k_noise, 'negatives': k_neg}
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__'):
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        S_0, S_L = model.apply({'params': params}, batch.s, batch.t,
                               y=batch.y, y_mask=batch.y_mask, train=train,
                               rngs=rngs)
    R = 4
    if seen[0].shape[-1] == 2 * R:          # the packed source side
        r_s = seen[0].reshape(1, 8, 2, R).transpose(2, 0, 1, 3)
    else:
        r_s = np.stack(seen[0::2])
    negatives = (np.asarray(S_L.idx)[..., k:] if train and k > 0
                 else None)
    return (model, state, batch, params, (S_0, S_L),
            torch.from_numpy(np.ascontiguousarray(r_s)), negatives)


def _port(name, params):
    (spec,) = [s for s in registry.default_specimens() if s.name == name]
    built = spec.build(torch.device('cpu'))
    model = built.get('keep', built['args'])[0]
    model.load_state_dict(dgmc_from_flax(params))
    return built, model


def _hold(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5, err_msg=what)


@pytest.mark.parametrize('name,k', [('forward_dense', -1),
                                    ('forward_sparse_k3', 3)])
def test_forward_specimens_give_jax_outputs(jax_registry, name, k):
    _, _, _, params, (S_0, S_L), r_s, _ = _jax_case(jax_registry, k, False)
    built, model = _port(name, params)
    got_0, got_L = built['fn'](*built['args'], r_s=r_s)
    for g, w, what in ((got_0, S_0, 'S_0'), (got_L, S_L, 'S_L')):
        _hold(g.val, w.val, what)
        if k > 0:
            np.testing.assert_array_equal(g.idx.numpy(), np.asarray(w.idx))


def test_eval_specimen_gives_jax_counts(jax_registry):
    model, state, batch, params, _, r_s, _ = _jax_case(jax_registry, -1,
                                                      False)
    from dgmc_tpu.train import make_eval_step
    want = make_eval_step(model, jit=False)(state, batch, jax.random.key(1))
    built, _ = _port('eval_step_dense', params)
    got = built['fn'](*built['args'], r_s=r_s)
    assert set(got) == set(want)
    for key in want:
        _hold(got[key], want[key], key)


@pytest.mark.parametrize('name,k', [('train_step_dense', -1),
                                    ('train_step_sparse_k3', 3)])
def test_train_step_specimens_give_jax_loss_and_update(jax_registry, name,
                                                       k):
    model, state, batch, params, _, r_s, negatives = _jax_case(
        jax_registry, k, True)
    from dgmc_tpu.train import make_train_step
    new_state, want = make_train_step(model)(state, batch,
                                             jax.random.key(1))
    built, port_model = _port(name, params)
    neg = None if negatives is None else torch.from_numpy(
        np.array(negatives)).long()
    _, got = built['fn'](*built['args'], r_s=r_s, negatives=neg)
    _hold(got['loss'], want['loss'], 'loss')
    _hold(got['acc'], want['acc'], 'acc')
    # Adam's first update is lr * g / (|g| + eps): a parameter whose
    # gradient is zero in exact arithmetic (a bias added to every logit of
    # a softmax row, or cancelled by ψ₂'s difference) moves by noise, so
    # only the others are compared.
    updated = dgmc_from_flax(jax.device_get(new_state.params))
    for key, value in port_model.state_dict().items():
        if key not in ZERO_GRAD:
            _hold(value, updated[key], key)


# ---------------------------------------------------------------------------
# The tier, the bound and the cost CLI on the CPU
# ---------------------------------------------------------------------------


def test_trace_tier_on_the_cpu_is_baselined(tier):
    cache, findings = tier
    assert not [f for f in findings if f.rule in ('TRC003', 'TRC004')]
    baseline = load_baseline(default_baseline_path(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    new, _ = split_by_baseline(findings, baseline)
    assert new == [], [(f.rule, f.where) for f in new]
    assert {f.rule for f in findings} <= {'TRC001', 'TRC005'}
    stats = cache.stats()
    assert list(stats) == NAMES
    for name, st in stats.items():
        assert (st['builds'], st['runs']) == (1, 1), (name, st)
        assert st['captures'] == int(name.startswith('train_step'))


def test_static_peak_lies_between_the_largest_buffer_and_the_sum(tier):
    cache, _ = tier
    for spec in registry.default_specimens():
        if spec.min_devices:
            continue
        tape = cache.artifacts(spec).recorded()['tape']
        sizes = [b.nbytes for b in tape.buffers.values()]
        peak = module_peak(tape).peak_bytes
        assert max(sizes) <= peak <= sum(sizes), spec.name


def _cost_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cost_mod.main(argv)
    return rc, out.getvalue()


def test_cost_cli_rows_merge_and_rerun_idempotently(tier, tmp_path):
    cache, _ = tier
    d = tmp_path / 'obs'
    d.mkdir()
    run_rows = {'device_kind': 'NVIDIA H100 80GB HBM3', 'platform': 'gpu',
                'peak_flops': 989e12, 'mfu': 0.01,
                'programs': {'train_step': {'flops': 123, 'mfu': 0.01}}}
    (d / 'efficiency.json').write_text(json.dumps(run_rows))
    rc, out = _cost_main(['--device', 'cpu', '--json', '--obs-dir', str(d)])
    assert rc == 0
    payload = json.loads(out)
    merged = json.loads((d / 'efficiency.json').read_text())
    assert merged == payload
    assert merged['programs']['train_step'] == \
        run_rows['programs']['train_step']
    assert merged['device_kind'] == run_rows['device_kind']
    rows = {k: v for k, v in merged['programs'].items() if k != 'train_step'}
    # The mesh specimens' rows too (rank 0's runs on 4 gloo ranks).
    assert sorted(rows) == sorted(f'specimen.{s.name}'
                                  for s in registry.default_specimens())
    for name, row in rows.items():
        assert row['static_peak_bytes'] > 0 and 'stages' in row, name
        assert row['launches'] == {} and row['measured_peak_bytes'] is None
    assert rows['specimen.train_step_dense']['flops'] > 0
    before = (d / 'efficiency.json').read_text()
    assert _cost_main(['--device', 'cpu', '--json', '--obs-dir',
                       str(d)])[0] == 0
    assert (d / 'efficiency.json').read_text() == before
    # One build and one run each, whichever consumer asked.
    assert all((s['builds'], s['runs']) == (1, 1)
               for s in cache.stats().values())


def test_cost_cli_reports_a_broken_specimen_as_an_error_row(monkeypatch):
    def broken(device):
        raise ValueError('no such model')

    monkeypatch.setattr(registry, 'default_specimens', lambda: [
        registry.Specimen('broken', broken),
        registry.Specimen('ops.segment_sum', registry._segment_specimen())])
    rows = cost_mod.specimen_costs(
        cache=registry.SpecimenCache('cpu'))
    assert rows['broken'] == {'error': 'ValueError: no such model'}
    assert rows['ops.segment_sum']['static_peak_bytes'] > 0


def test_max_peak_regression_reads_the_specimen_rows(tier, tmp_path):
    # A recorded run's telemetry: one metrics record is what the diff
    # needs to compare two dirs.
    d = str(tmp_path / 'run')
    os.makedirs(d)
    with open(os.path.join(d, 'metrics.jsonl'), 'w') as f:
        f.write(json.dumps({'step': 1, 'loss': 1.0}) + '\n')
    assert _cost_main(['--device', 'cpu', '--obs-dir', d])[0] == 0
    raised = str(tmp_path / 'raised')
    shutil.copytree(d, raised)
    path = os.path.join(raised, 'efficiency.json')
    with open(path) as f:
        eff = json.load(f)
    for row in eff['programs'].values():
        if row.get('static_peak_bytes'):
            row['static_peak_bytes'] = int(row['static_peak_bytes'] * 1.5)
    with open(path, 'w') as f:
        json.dump(eff, f)
    got = {}
    for name, cand in (('itself', d), ('raised', raised)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = diff_mod.main([d, cand, '--json'])
        (row,) = [r for r in json.loads(out.getvalue())['rows']
                  if r['metric'] == 'static_peak_bytes']
        got[name] = (rc, row['status'])
    assert got == {'itself': (0, 'ok'), 'raised': (1, 'REGRESSION')}
