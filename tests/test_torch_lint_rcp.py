"""The port's recompile pass against the JAX package's, and the serving
router's signature that rides on it.

``signature_of``, ``bucket_signature`` and ``analyze_buckets`` must give
the JAX package's answers on the same rows; ``pair_batch_avals`` must
describe what the port's ``pad_pair_batch`` really emits; and
``load_obs_buckets`` must read an obs dir that the port writes on the
CPU as the JAX package's does. The one deliberate difference, the
RCP202 budget counting captures and not ``nvcc`` builds, is held on a
synthetic ``timings.json``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from dgmc_tpu_torch.analysis import recompile
from dgmc_tpu_torch.serve.router import QueryRouter
from dgmc_tpu_torch.utils.data import Graph, GraphPair, pad_pair_batch
from tests.torch_jax_worker import jax_worker


def _bucket(batch, nodes, edges, count=1):
    return {'batch': batch, 'nodes': nodes, 'edges': edges, 'count': count}


def _fields(findings):
    return [(f.rule, f.severity.name, f.where, f.message, f.detail,
             f.context, f.fingerprint) for f in findings]


#: The JAX package's recompile cases (``tests/analysis/test_recompile.py``)
#: with the telemetry counts each is checked at.
ROWS = {
    'dominated': [_bucket(8, '32x40', '64x80'),
                  _bucket(8, '24x40', '64x80', count=3)],
    'incomparable': [_bucket(8, '48x40', '64x80'),
                     _bucket(8, '32x40', '96x80')],
    'pair_batch_axis': [_bucket(1, '32x40', '64x80'),
                        _bucket(2, '32x40', '64x80')],
    'equal_pair_batch': [_bucket(2, '32x40', '64x80'),
                         _bucket(2, '24x40', '64x80'),
                         _bucket(1, '24x40', '64x80')],
    'single': [_bucket(8, '32x40', '64x80')],
    'list_dims': [_bucket(4, [10, 12], [30, 36]), _bucket(4, 12, 36)],
}


@pytest.mark.parametrize('case', sorted(ROWS))
@pytest.mark.parametrize('events', [None, 3, 16, 50])
def test_analyze_buckets_equals_jax(case, events):
    rows = ROWS[case]
    with jax_worker('dgmc_tpu.analysis.recompile') as m:
        jr = m['recompile']
        want = _fields(jr.analyze_buckets(rows, compile_events=events))
        want_sigs = [jr.bucket_signature(b) for b in rows]
        want_of = jr.signature_of(jr.pair_batch_avals(2, 5, 6, 7, 8, 16, 3))
    assert _fields(recompile.analyze_buckets(
        rows, compile_events=events)) == want
    assert [recompile.bucket_signature(b) for b in rows] == want_sigs
    assert recompile.signature_of(
        recompile.pair_batch_avals(2, 5, 6, 7, 8, 16, 3)) == want_of


def test_dominated_bucket_and_telemetry_findings():
    (f,) = recompile.analyze_buckets(ROWS['dominated'])
    assert f.rule == 'RCP201' and 'nodes=24x40' in f.message
    (f,) = recompile.analyze_buckets(ROWS['single'], compile_events=50)
    assert f.rule == 'RCP202' and '50 compile events' in f.message
    assert recompile.analyze_buckets(ROWS['pair_batch_axis']) == []


def _graph(rng, n, e, c, d=None):
    return Graph(edge_index=rng.randint(0, n, (2, e)).astype(np.int64),
                 x=rng.rand(n, c).astype(np.float32),
                 edge_attr=None if d is None
                 else rng.rand(e, d).astype(np.float32))


@pytest.mark.parametrize('native', ['auto', 'never'])
@pytest.mark.parametrize('edge_dim', [None, 3])
def test_pair_batch_avals_match_a_real_pad_pair_batch(native, edge_dim):
    rng = np.random.RandomState(0)
    pairs = [GraphPair(s=_graph(rng, 7, 12, 5, edge_dim),
                       t=_graph(rng, 9, 15, 5, edge_dim),
                       y_col=rng.permutation(9)[:7].astype(np.int64))
             for _ in range(3)]
    batch = pad_pair_batch(pairs, 10, 20, 11, 24, native=native)
    leaves = [*batch.s.values(), *batch.t.values(), batch.y, batch.y_mask]
    got = [(tuple(a.shape), str(a.dtype)) for a in leaves]
    assert got == recompile.pair_batch_avals(3, 10, 11, 20, 24, feat_dim=5,
                                             edge_dim=edge_dim)


def _timings(d, events, by_kind=None, buckets=None):
    os.makedirs(d, exist_ok=True)
    comp = {'events': events, 'compile_s': 1.0, 'cache_hits': 0,
            'by_label': {}}
    if by_kind is not None:
        comp['by_kind'] = by_kind
    with open(os.path.join(d, 'timings.json'), 'w') as f:
        json.dump({'compile': comp, 'padding_buckets': buckets
                   or [_bucket(1, '15000x20000', '100000x120000', 1)]}, f)
    return d


def test_the_budget_counts_captures_not_kernel_builds(tmp_path):
    """A one-bucket KG run on a cold ``_build/``: four captures (phase 1,
    its eval, phase 2, its eval) and six ``nvcc`` builds, one a source.
    The budget (distinct x 8) counts the captures: no RCP202. Nine
    captures still trip it; telemetry without the kind split (a JAX
    run's) counts every event, as the JAX package does."""
    cold = _timings(str(tmp_path / 'cold'), 10, {'capture': 4, 'nvcc': 6})
    rows, events = recompile.load_obs_buckets(cold)
    assert events == 4
    assert recompile.analyze_buckets(rows, compile_events=events) == []
    with jax_worker('dgmc_tpu.analysis.recompile') as m:
        j_rows, j_events = m['recompile'].load_obs_buckets(cold)
        assert j_events == 10
        assert [f.rule for f in m['recompile'].analyze_buckets(
            j_rows, compile_events=j_events)] == ['RCP202']
    churn = _timings(str(tmp_path / 'churn'), 15, {'capture': 9, 'nvcc': 6})
    rows, events = recompile.load_obs_buckets(churn)
    assert [f.rule for f in recompile.analyze_buckets(
        rows, compile_events=events)] == ['RCP202']
    legacy = _timings(str(tmp_path / 'legacy'), 10)
    assert recompile.load_obs_buckets(legacy)[1] == 10
    assert recompile.load_obs_buckets(str(tmp_path / 'missing')) == ([], None)


@pytest.fixture(scope='module')
def port_obs_dir(tmp_path_factory):
    """A tiny observed ``pascal_pf.main`` run on the CPU (the JAX CI's
    flags): the obs dir the port writes."""
    import torch
    from dgmc_tpu_torch.experiments import pascal_pf
    root = str(tmp_path_factory.mktemp('rcp'))
    d = os.path.join(root, 'obs')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            pascal_pf.main(['--device', 'cpu', '--epochs', '1',
                            '--batch_size', '8', '--dim', '16',
                            '--rnd_dim', '8', '--num_steps', '1',
                            '--data_root', os.path.join(root, 'none'),
                            '--obs-dir', d])
    finally:
        torch.set_num_threads(threads)
    return d


def test_load_obs_buckets_equals_jax_on_a_port_obs_dir(port_obs_dir):
    rows, events = recompile.load_obs_buckets(port_obs_dir)
    with jax_worker('dgmc_tpu.analysis.recompile') as m:
        jr = m['recompile']
        assert jr.load_obs_buckets(port_obs_dir) == (rows, events)
        want = _fields(jr.analyze_buckets(rows, specimen='obs',
                                          compile_events=events))
    assert rows and events >= 1
    with open(os.path.join(port_obs_dir, 'timings.json')) as f:
        comp = json.load(f)['compile']
    assert comp['by_kind'] == {'capture': events}
    assert _fields(recompile.analyze_buckets(
        rows, specimen='obs', compile_events=events)) == want == []


@pytest.mark.parametrize('spec,corpus', [
    ('16x48,32x96,64x192', (20000, 120000)),
    ('16x48,200x300', (150, 450)),
])
def test_router_signature_equals_jax(spec, corpus):
    port = QueryRouter(spec, *corpus)
    with jax_worker('dgmc_tpu.serve.router') as m:
        jax_router = m['router'].QueryRouter(spec, *corpus)
        want = [(jax_router.bucket_row(b), jax_router.signature(b))
                for b in jax_router.buckets]
    got = [(port.bucket_row(b), port.signature(b)) for b in port.buckets]
    assert got == want
    assert all(len(sig) == 16 and int(sig, 16) >= 0 for _, sig in got)
