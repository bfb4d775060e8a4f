"""JAX's opt-in ψ₁ table sharding in the port (the ``'psi1'`` /
``'corpus'`` activation rules: ``DGMC.with_layout(psi1_sharding=,
corpus_sharding=)``), on gloo ranks, each a CPU process, at world size 2
and 4. With the rules each rank computes and holds its row block of
``h_s`` and of ``h_t`` only, and the target ring passes the ``h_t``
shards rank to rank.

Cases, each one SGD step (lr 1e-2) with the step's draws injected:

- JAX's (:func:`tests.torch_parallel_ref.table_case`): ``streamed-psi1``,
  the ``streamed`` case's SplineCNN ψ₁ (whole on each rank, its rows
  kept: ``psi1_rows`` ``whole``; at 4 ranks k = 4 exceeds a shard's 3
  columns, so the ring falls back to the gathered targets), and
  ``rel-psi1``, a two-layer RelCNN ψ₁ with batch norm over blocked
  graphs whose 8-row ranges the rank blocks straddle (``psi1_rows``
  ``rows``), against JAX's sharded step on two virtual devices under the
  same rules: metrics and updated parameters within rtol 1e-5 / atol
  1e-6 (the ``streamed`` case's tolerances), the training forward's
  shortlist equal.
- The port's own (its weights and draws): ``port-rel`` (RelCNN ψ₁, no
  batch norm, no dropout), ``port-rel-drop`` (batch norm and dropout
  0.5) and ``port-gin`` (GIN with batch norm), each in phase 1 (ψ₁
  trains, no consensus step) and phase 2 (ψ₁ detached, two steps),
  against the same ranks' step under the replicated tables
  (``streamed_rules``' default).

What is bit for bit, and what is within a tolerance:

- the shortlists (indices), always;
- phase 2 without batch norm at 2 ranks (``port-rel``): the whole step
  (loss, metrics, parameters), since each row's aggregation keeps its
  order and this CPU's products of the rank's 10 / 12 rows round as
  those of all 20 / 24 rows;
- otherwise within rtol 1e-5 / atol 1e-6: at 4 ranks the products of 5
  / 6 rows round otherwise (an ulp); batch norm sums each rank's partial
  sums over the ranks; and phase 1's ψ₁ gradients are the ranks' parts
  summed in rank order, where one process sums over all rows at once;
- every rank bit-identical to every other.
"""

import numpy as np
import pytest
import torch

from tests import torch_parallel_jobs as jobs
from tests.torch_dist_worker import start_groups
from tests.torch_parallel_ref import table_case as jax_table_case

WORLDS = (2, 4)
JAX_CASES = ('streamed-psi1', 'rel-psi1')
PHASES = (('phase1', 0, False), ('phase2', 2, True))
PORT_CASES = {'port-rel': ('rel', 4, 2, False, 0.0),
              'port-rel-drop': ('rel', 4, 2, True, 0.5),
              'port-gin': ('gin', 4, 2)}


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def run():
    ports = {name: jobs.table_case(name, spec, PHASES)
             for name, spec in PORT_CASES.items()}
    # Each group starts as soon as its case is ready; JAX's next case is
    # computed while the ranks run.
    started = [start_groups([('tests.torch_parallel_jobs:table_steps', w,
                              (ports,)) for w in WORLDS])]
    cases, wants = dict(ports), {}
    for name in JAX_CASES:
        case, wants[name] = jax_table_case(name)
        cases[name] = case
        started.append(start_groups([(
            'tests.torch_parallel_jobs:table_steps', w, ({name: case},))
            for w in WORLDS]))
    ranks = {w: [{} for _ in range(w)] for w in WORLDS}
    for finish in started:
        for w, got in zip(WORLDS, finish()):
            for mine, part in zip(ranks[w], got):
                mine.update(part)
    return cases, wants, ranks


def _close(got, want, err=''):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-6,
                                   err_msg=f'{err} {key}')


def _same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for other in ranks[1:]:
        for mode in ('replicated', 'tables'):
            for phase, st in first[mode]['steps'].items():
                got = other[name][mode]['steps'][phase]['state']
                for key, v in st['state'].items():
                    np.testing.assert_array_equal(got[key], v)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', JAX_CASES)
def test_sharded_tables_match_jax(run, world, name):
    _, wants, ranks = run
    want = wants[name]
    _same_on_every_rank(ranks[world], name)
    for mode in ('tables', 'replicated'):
        got = ranks[world][0][name][mode]
        m, w = got['steps']['jax']['metrics'], want['metrics']
        assert float(m['loss']) == pytest.approx(float(w['loss']),
                                                 rel=1e-5, abs=1e-6)
        assert float(m['acc']) == pytest.approx(float(w['acc']), abs=1e-6)
        _close(got['steps']['jax']['state'], want['state'], mode)
        np.testing.assert_array_equal(got['shortlist'], want['shortlist'])


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(PORT_CASES))
@pytest.mark.parametrize('phase', [p for p, *_ in PHASES])
def test_sharded_tables_match_replicated_tables(run, world, name, phase):
    _, _, ranks = run
    _same_on_every_rank(ranks[world], name)
    got = ranks[world][0][name]
    a = got['replicated']['steps'][phase]
    b = got['tables']['steps'][phase]
    np.testing.assert_array_equal(got['tables']['shortlist'],
                                  got['replicated']['shortlist'])
    if (name, phase, world) == ('port-rel', 'phase2', 2):
        for part in ('metrics', 'state'):
            for key, v in a[part].items():
                np.testing.assert_array_equal(b[part][key], v,
                                              err_msg=key)
        return
    assert float(b['metrics']['loss']) == pytest.approx(
        float(a['metrics']['loss']), rel=1e-5)
    assert float(b['metrics']['acc']) == float(a['metrics']['acc'])
    _close(b['state'], a['state'], phase)


def _held(world, n_s, n_t, c):
    from dgmc_tpu_torch.parallel.topk import row_block
    out = []
    for n in (n_s, n_t):
        lo, hi, _ = row_block(n, world, 0)
        out.append((1, hi - lo, c))
    return out


@pytest.mark.parametrize('world', WORLDS)
def test_ring_moves_target_shards(run, world):
    """Each rank holds only its row blocks of ``h_s`` and ``h_t`` (ψ₁'s
    output shapes), its search takes ``n - 1`` permutes of the target
    shard and its mask slice (the shard's bytes plus a byte a column),
    and nothing correspondence-sized is all-gathered (SHD302 stays
    silent). Where k exceeds a shard's columns (``streamed-psi1`` at 4
    ranks: 3 columns) the shards are all-gathered instead."""
    from dgmc_tpu_torch.analysis.shd_rules import (ShardedContext,
                                                   check_corr_replication)
    _, _, ranks = run
    for r in ranks[world]:
        for name in ('port-rel', 'port-gin', 'rel-psi1'):
            tables = r[name]['tables']
            assert tables['held'] == _held(world, 20, 24, 8)
            assert tables['psi1_rows']['path'] == 'rows'
            per_t = _held(world, 20, 24, 8)[1][1]
            permutes = [p for k, p in tables['collectives']
                        if k == 'collective-permute']
            assert permutes == [per_t * 8 * 4 + per_t] * (world - 1)
            assert r[name]['replicated']['psi1_rows'] is None
            ctx = ShardedContext(specimen=name, corr_bytes=20 * 24 * 4)
            assert check_corr_replication(tables['tape'], ctx) == []
        spline = r['streamed-psi1']['tables']
        assert spline['psi1_rows']['path'] == 'whole'
        assert spline['held'] == _held(world, 12, 12, 16)
        kinds = [k for k, _ in spline['collectives']]
        assert kinds.count('collective-permute') == (1 if world == 2 else 0)


@pytest.mark.parametrize('parts', [2, 3])
def test_node_row_dropout_is_the_one_process_mask(parts):
    """A rank's dropout masks over its node rows (:class:`~dgmc_tpu_torch.
    models.rel.NodeBlock`) are its rows of the mask one process draws,
    bit for bit, and the generator ends where one process's does (source
    call, then target call)."""
    from dgmc_tpu_torch.models.rel import NodeBlock, NodeRows, dropout
    from dgmc_tpu_torch.parallel.topk import row_block
    g = torch.Generator().manual_seed(1)
    h_s, h_t = torch.randn(2, 7, 3, generator=g), torch.randn(2, 9, 3,
                                                              generator=g)
    one = torch.Generator().manual_seed(5)
    want = [dropout(h, 0.5, one) for h in (h_s, h_t)]
    for me in range(parts):
        gen = torch.Generator().manual_seed(5)
        for h, w in zip((h_s, h_t), want):
            N = h.shape[1]
            lo, hi, _ = row_block(N, parts, me)
            got = dropout(NodeRows(lo, hi, N, None).take(h), 0.5,
                          NodeBlock(gen, lo, hi, N))
            n = min(hi, N) - lo
            torch.testing.assert_close(got[:, :n], w[:, lo:lo + n], rtol=0,
                                       atol=0)
        assert torch.equal(gen.get_state(), one.get_state())


def test_batch_and_node_blocks_compose():
    """Inside a batch block, a node block keeps its pair's rows of the
    whole batch's mask."""
    from dgmc_tpu_torch.models.rel import (BatchBlock, NodeBlock, NodeRows,
                                           dropout)
    h = torch.randn(4, 6, 2, generator=torch.Generator().manual_seed(3))
    want = dropout(h, 0.3, torch.Generator().manual_seed(9))
    rows = NodeRows(3, 6, 6, None)
    got = dropout(rows.take(h[2:]), 0.3, NodeBlock(BatchBlock(
        torch.Generator().manual_seed(9), 2, 1), 3, 6, 6))
    torch.testing.assert_close(got, want[2:, 3:6], rtol=0, atol=0)


@pytest.mark.parametrize('parts', [2, 3])
def test_row_block_tables_keep_each_rows_order(parts):
    """The row block's tables (``ops/blocked.py``): ``row_slice``'s rows
    of ``ordered_aggregate`` are the whole call's rows, bit for bit;
    ``owned_rows``' transposed sum equals the whole transposed call over
    the block's rows placed in a zero table (each row's order kept), and
    the blocks' sums add up to the whole backward; the plain versions
    (the wrapper's CPU path) agree with both."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    from dgmc_tpu_torch.parallel.topk import row_block
    rng = np.random.RandomState(parts)
    N, C = 70, 5
    snd, rcv = rng.randint(0, N, (2, 1, 400))
    rcv[0, :100] = 3
    inc, outg = ob.build_edge_blocks(snd, rcv, rng.rand(1, 400) > 0.1, N,
                                     rows=16, block_edges=32)
    h = torch.from_numpy(rng.randn(1, N, C).astype(np.float32))
    d = torch.from_numpy(rng.randn(1, N, C).astype(np.float32))
    whole = ob.ordered_aggregate(h, inc)
    back = torch.zeros(1, N, C)
    for me in range(parts):
        lo, hi, padded = row_block(N, parts, me)
        n = min(hi, N) - lo
        got = ob.ordered_aggregate(h, ob.row_slice(inc, lo, hi))
        torch.testing.assert_close(got[:, :n], whole[:, lo:lo + n], rtol=0,
                                   atol=0)
        assert not got[:, n:].any()
        plain = kb.aggregate(h, inc, rows=(lo, hi))
        torch.testing.assert_close(plain[:, :n],
                                   ob.plain_aggregate(h, inc)[:, lo:lo + n],
                                   rtol=0, atol=0)
        mine = torch.nn.functional.pad(d, (0, 0, 0, padded - N))[:, lo:hi]
        zero = torch.zeros(1, N, C)
        zero[:, lo:lo + n] = mine[:, :n]
        part = ob.ordered_aggregate(mine, ob.owned_rows(outg, lo, hi))
        torch.testing.assert_close(part, ob.ordered_aggregate(zero, outg),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            kb.aggregate(mine, outg, rows=(lo, hi), sources=True),
            ob.plain_aggregate(zero, outg), rtol=0, atol=0)
        back = back + part
    torch.testing.assert_close(back, ob.ordered_aggregate(d, outg),
                               rtol=1e-6, atol=1e-6)


def test_with_layout_takes_the_table_rules_on_the_rows_axis():
    """``with_layout`` accepts ``psi1_sharding`` / ``corpus_sharding`` on
    the correspondence rows' axis and refuses them on another axis or
    without a row layout (JAX's rules set them alike)."""
    from dgmc_tpu_torch.parallel import make_mesh, streamed_rules
    from dgmc_tpu_torch.parallel.mesh import NamedSharding
    mesh = make_mesh(device='cpu')
    model = jobs.build_model(('rel', 4, 2, False, 0.0))
    row = NamedSharding(mesh, (None, 'data'))
    laid = model.with_layout(corr_sharding=row, psi1_sharding=row,
                             corpus_sharding=row, ring_targets=True)
    assert laid.psi1_sharding is row and laid.corpus_sharding is row
    rules = jobs._table_rules(4, True)
    assert rules.apply_to_model(model, mesh).corpus_sharding.spec == (
        None, 'data')
    assert streamed_rules().apply_to_model(model, mesh).psi1_sharding is None
    with pytest.raises(ValueError, match="must be the correspondence"):
        model.with_layout(corr_sharding=row, corpus_sharding=NamedSharding(
            mesh, (None, 'model')))
    with pytest.raises(ValueError, match='ψ₁'):
        model.with_layout(psi1_sharding=row)
