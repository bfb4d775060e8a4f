"""The port's cost and efficiency account (``obs/cost.py``, the kernels'
work functions, ``obs/stages.py``), on the CPU.

- The per-stage counts of a small sparse DGMC's train step against the
  JAX package's ``cost_summary`` of the same model (the one of
  ``tests/obs/test_cost.py``, its weights carried across with
  ``convert.py``): ``dot_ops`` and ``flops`` equal in ``psi1``, ``psi2``
  and ``initial_corr``; ``topk`` and ``consensus_iter`` count the
  kernels' formulas, whose factor against JAX's dots is stated and held;
  every stage JAX's test names is present.
- The count with the kernel entries swapped for their plain versions (as
  ``chip_smoke.py``'s ``plain_on_card`` swaps them) equals the count
  through the wrappers; the counted pass leaves parameters, batch-norm
  buffers, Adam's state, the launch counters and the random state
  bit-identical.
- ``efficiency_payload`` gives JAX's output on the same program
  summaries, the device fields aside; an unknown card gets no MFU.
- The kernels' work functions reproduce, at ``PERF.md`` §6's shapes, the
  bounds recorded there (``chip_smoke.py`` reads its bounds from them).
"""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.obs import cost
from dgmc_tpu_torch.obs.stages import STAGE_NAMES, stage, stage_of
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.rng import draw_work
from dgmc_tpu_torch.ops.kernels.sparse_consensus import sc_work
from dgmc_tpu_torch.ops.kernels.topk import topk_work
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import make_train_step
from dgmc_tpu_torch.utils.data import PairBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _side(rng, n, e, c=4):
    return dict(x=rng.randn(1, n, c).astype(np.float32),
                senders=rng.randint(0, n, (1, e)).astype(np.int32),
                receivers=rng.randint(0, n, (1, e)).astype(np.int32),
                node_mask=np.ones((1, n), bool),
                edge_mask=np.ones((1, e), bool))


def _batch_arrays():
    """``tests/obs/test_cost.py``'s batch: 8 and 10 nodes, 16 and 20
    edges, 4 features."""
    rng = np.random.RandomState(0)
    s, t = _side(rng, 8, 16), _side(rng, 10, 20)
    y = (np.arange(8, dtype=np.int32) % 10)[None]
    return s, t, y, np.ones((1, 8), bool)


def _port_model():
    return DGMC(RelCNN(4, 8, num_layers=1), RelCNN(4, 4, num_layers=1),
                num_steps=2, k=3)


@pytest.fixture(scope='module')
def summaries():
    """JAX's and the port's cost summaries of the same train step."""
    import jax
    from tests.torch_jax_worker import jax_worker
    from dgmc_tpu.models import DGMC as JaxDGMC
    from dgmc_tpu.models import RelCNN as JaxRelCNN
    from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
    from dgmc_tpu.train import create_train_state as jax_state
    from dgmc_tpu.train import make_train_step as jax_step
    from dgmc_tpu.utils.data import PairBatch as JaxPairBatch
    from dgmc_tpu_torch.convert import dgmc_from_flax
    s, t, y, y_mask = _batch_arrays()
    jb = JaxPairBatch(s=JaxGraphBatch(**s, edge_attr=None),
                      t=JaxGraphBatch(**t, edge_attr=None), y=y,
                      y_mask=y_mask)
    jm = JaxDGMC(JaxRelCNN(4, 8, num_layers=1), JaxRelCNN(4, 4, num_layers=1),
                 num_steps=2, k=3)
    state = jax_state(jm, jax.random.key(0), jb, learning_rate=1e-3)
    with jax_worker('dgmc_tpu.obs.cost') as mods:
        theirs = mods['cost'].cost_summary(jax_step(jm), state, jb,
                                           jax.random.key(1))
        payload = mods['cost'].efficiency_payload(
            {'train_step': theirs, 'other': {'flops': 3e6, 'bytes': 1e6,
                                             'step_time_s': 0.25}},
            fallback_step_time_s=0.1)
    model = _port_model()
    model.load_state_dict(dgmc_from_flax(jax.device_get(state.params)))
    ours = cost.cost_summary(make_train_step(model, jit=False),
                             create_train_state(model),
                             PairBatch(s=s, t=t, y=y, y_mask=y_mask), 1)
    return theirs, ours, payload


def test_stage_counts_match_jax(summaries):
    theirs, ours, _ = summaries
    assert ours['source'] == 'counted'
    for name in ('psi1', 'psi2', 'initial_corr'):
        for key in ('dot_ops', 'flops'):
            assert ours['stages'][name][key] == theirs['stages'][name][key], \
                (name, key)
    # tests/obs/test_cost.py:56-72: every stage, with work in the product
    # stages.
    for name in ('psi1', 'initial_corr', 'topk', 'consensus_iter', 'psi2',
                 'loss', 'optimizer'):
        assert ours['stages'][name]['ops'] > 0, name
        assert ours['stages'][name]['bytes_out'] > 0, name
    for name in ('psi1', 'initial_corr', 'consensus_iter', 'psi2', 'topk'):
        assert ours['stages'][name]['flops'] > 0, name
        assert ours['stages'][name]['dot_ops'] > 0, name
    assert ours['flops'] == sum(r['flops'] for r in ours['stages'].values())
    assert ours['arith_intensity'] == round(ours['flops'] / ours['bytes'], 3)


def test_kernel_stages_differ_from_jax_by_their_stated_factors(summaries):
    theirs, ours, _ = summaries
    # The search: one product of the contract's shape, 2 B N_s N_t C. JAX's
    # blockwise search pads the targets to its 256-wide block and its dot
    # carries no stage scope (it lands in 'other'): a factor 10/256.
    topk = ours['stages']['topk']
    assert topk['flops'] == 2 * 1 * 8 * 10 * 8 == 1280
    assert theirs['stages']['topk']['dot_ops'] == 0
    assert theirs['stages']['other']['flops'] == 2 * 8 * 256 * 8
    assert topk['flops'] * 256 == theirs['stages']['other']['flops'] * 10
    # Consensus: two steps of the factored form's least work (forward and
    # backward; k = 3 plus 3 negatives = 6 candidates, R = 4, 8 + 10 of
    # them the rows touched) against JAX's dots of its direct form: 7/10.
    work = sc_work(1, 8, 10, 6, 4, 10)
    want = 2 * (work['flops'] + work['bwd']['flops'])
    assert ours['stages']['consensus_iter']['flops'] == want == 8064
    assert theirs['stages']['consensus_iter']['flops'] == 11520
    assert 10 * want == 7 * theirs['stages']['consensus_iter']['flops']
    assert ours['kernels']['sparse_consensus_fwd']['calls'] == 2
    assert ours['kernels']['sparse_consensus_bwd']['calls'] == 2
    assert ours['kernels']['topk'] == {
        'calls': 1, 'flops': 1280, 'bytes': int(topk_work(1, 8, 10, 8, 3)[
            'bytes'])}
    # The optimizer: Adam's elementwise work on every parameter.
    n = sum(p.numel() for p in _port_model().parameters())
    assert ours['stages']['optimizer']['flops'] == cost.ADAM_FLOPS * n


def test_efficiency_payload_matches_jax(summaries):
    theirs, _, payload = summaries
    ours = cost.efficiency_payload(
        {'train_step': theirs, 'other': {'flops': 3e6, 'bytes': 1e6,
                                         'step_time_s': 0.25}},
        fallback_step_time_s=0.1, device='cpu')
    device = ('device_kind', 'platform')
    assert {k: v for k, v in ours.items() if k not in device} == \
        {k: v for k, v in payload.items() if k not in device}
    assert ours['peak_flops_source'] == 'cpu-fallback'
    assert ours['mfu'] == float(f'{theirs["flops"] / (0.1 * 48e9):.4g}')
    text = cost.render_costs(ours)
    assert 'MFU' in text and 'stage psi1' in text


def test_unknown_card_has_no_mfu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda d=None: 'QPU')
    p = cost.efficiency_payload({'train_step': {'flops': 1e9}},
                                fallback_step_time_s=0.1, device='cuda')
    assert p['peak_flops'] is None and p['peak_flops_source'] == 'unknown'
    assert 'mfu' not in p and 'mfu' not in p['programs']['train_step']
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda d=None: 'NVIDIA H100 80GB HBM3')
    p = cost.efficiency_payload({'train_step': {'flops': 9.89e9}},
                                fallback_step_time_s=0.1, device='cuda')
    assert (p['platform'], p['peak_flops'], p['mfu']) == ('gpu', 989e12,
                                                         0.0001)


def test_stage_of_prefers_innermost_scope():
    assert stage_of('dgmc_step#3/consensus_iter/psi2') == 'psi2'
    assert stage_of('consensus_iter') == 'consensus_iter'
    assert stage_of('metrics') == 'other'
    assert STAGE_NAMES == ('psi1', 'psi2', 'initial_corr', 'topk',
                           'consensus_iter', 'loss', 'optimizer')
    counter = cost.WorkCounter()
    a = torch.ones(3, 4)
    with counter:
        with stage('consensus_iter'):
            a @ a.T
            with stage('psi2'):
                a @ a.T
        a @ a.T
    assert {s: r['flops'] for s, r in counter.rows.items()} == {
        'consensus_iter': 72, 'psi2': 72, 'other': 72}


def _state_of(model, state):
    return ([p.detach().clone() for p in model.parameters()],
            [None if p.grad is None else p.grad.clone()
             for p in model.parameters()],
            [b.clone() for b in model.buffers()],
            copy.deepcopy(state.optimizer.state_dict()),
            dispatch.launch_counts(), dispatch.decisions(),
            torch.get_rng_state())


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_counted_pass_leaves_the_run_as_it_was():
    s, t, y, y_mask = _batch_arrays()
    batch = PairBatch(s=s, t=t, y=y, y_mask=y_mask)
    model = DGMC(RelCNN(4, 8, num_layers=1, batch_norm=True, dropout=0.5),
                 RelCNN(4, 4, num_layers=1, batch_norm=True), num_steps=2,
                 k=3)
    state = create_train_state(model)
    step = make_train_step(model, jit=False)
    step(state, batch, 5)                     # Adam's state exists
    before = _state_of(model, state)
    summary = cost.cost_summary(step, state, batch, 6)
    assert summary['flops'] > 0
    assert _equal(_state_of(model, state), before)
    # And the steps that follow are the ones without the count.
    twin = copy.deepcopy(model)
    twin_state = create_train_state(twin)
    twin_state.optimizer.load_state_dict(state.optimizer.state_dict())
    twin_step = make_train_step(twin, jit=False)
    _, a = step(state, batch, 7)
    _, b = twin_step(twin_state, batch, 7)
    assert torch.equal(a['loss'], b['loss'])


def test_plain_versions_count_as_the_wrappers():
    """The kernel entries swapped for their plain versions, as
    ``plain_on_card`` swaps them on the card: the same count."""
    from dgmc_tpu_torch.ops.kernels import sparse_consensus
    s, t, y, y_mask = _batch_arrays()
    batch = PairBatch(s=s, t=t, y=y, y_mask=y_mask)
    model = _port_model()
    state = create_train_state(model)
    step = make_train_step(model, jit=False)
    through = cost.cost_summary(step, state, batch, 3)
    saved = sparse_consensus.fused_candidate_delta
    sparse_consensus.fused_candidate_delta = \
        sparse_consensus.plain_fused_candidate_delta
    try:
        swapped = cost.cost_summary(step, state, batch, 3)
    finally:
        sparse_consensus.fused_candidate_delta = saved
    assert swapped == through


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_bounds', os.path.join(REPO, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_work_functions_give_perf_md_bounds():
    """``PERF.md`` §6's bounds (ms, as printed there) from the work
    functions at the main path's shapes, through ``chip_smoke.py``'s
    ``bound``."""
    cs = _chip_smoke()
    f32, bf16 = cs.PEAK_F32_FLOPS, cs.PEAK_BF16_FLOPS

    def ms(work, peak=f32, digits=4):
        b_ms, by = cs.work_bound(work, peak)
        return round(b_ms, digits), by

    from dgmc_tpu_torch.ops.kernels.consensus import consensus_work
    assert ms(topk_work(1, 15000, 20000, 256, 10), digits=3) == \
        (2.293, 'operations')
    assert [ms(topk_work(1, n, 20000, 256, 10)) for n in (16, 32)] == \
        [(0.0061, 'bytes')] * 2
    assert ms(topk_work(1, 64, 20000, 256, 10)) == (0.0098, 'operations')
    assert ms(topk_work(1, 15000, 20000, 256, 10, 2), bf16, 3) == \
        (0.155, 'operations')
    assert ms(consensus_work(64, 80, 80, 64)) == (0.0024, 'operations')
    assert ms(consensus_work(64, 80, 80, 64, 2), bf16) == (0.0009, 'bytes')
    assert ms(consensus_work(512, 18, 18, 128)) == (0.0100, 'operations')
    assert ms(consensus_work(512, 18, 18, 128, 2), bf16) == (0.0016, 'bytes')
    sc = sc_work(1, 15000, 20000, 20, 32)
    assert ms(sc) == (0.0021, 'bytes')
    assert ms(sc['bwd']) == (0.0041, 'operations')
    sc16 = sc_work(1, 15000, 20000, 20, 32, elem=2)
    assert ms(sc16, bf16) == (0.0014, 'bytes')
    assert ms(sc16['bwd'], bf16) == (0.0021, 'bytes')
    assert [ms(sc_work(1, n, 20000, 10, 32, n * 10), digits=5)
            for n in (16, 32, 64)] == [(0.00001, 'bytes'),
                                       (0.00002, 'bytes'),
                                       (0.00003, 'bytes')]
    assert ms(draw_work('normal', 10, 1, 15000 * 32)) == (0.0057, 'bytes')
    assert ms(draw_work('normal', 10, 64, 80 * 64)) == (0.0039, 'bytes')
    assert ms(draw_work('negatives', 1, 15000, 10)) == (0.0004, 'bytes')


def test_work_functions_give_perf_md_data_bounds():
    """The bounds of §6 that read the data: SplineConv's routing on the
    PascalPF training batch (``chip_smoke.py``'s ``spline_kernel``) and
    the blocked aggregation on the synthetic DBP15K source graph's
    tables (``blocked_kernel``), both made from their seeds here."""
    cs = _chip_smoke()
    from dgmc_tpu_torch.experiments import dbp15k, pascal_pf
    from dgmc_tpu_torch.models.spline import spline_routing
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels.blocked import blocked_work
    from dgmc_tpu_torch.ops.kernels.spline import records_work, route_work
    _, loader, _ = pascal_pf.build(pascal_pf.parse_args(
        ['--seed', '0', '--precision', 'f32']))
    graph = GraphBatch.from_numpy(next(iter(loader)).s, 'cpu')
    basis, routing = spline_routing(graph, 5)
    got = {}
    for O in (256, 64):
        work = route_work(basis, routing, O)
        got[O] = (round(cs.work_bound(work)[0], 4),
                  round(cs.work_bound(work['bwd'])[0], 4))
    assert got == {256: (0.0125, 0.0412), 64: (0.0035, 0.0107)}
    assert round(cs.work_bound(records_work(routing))[0], 4) == 0.0024
    train, _, _ = dbp15k.synthetic_batches(
        dbp15k.parse_args(cs.KG_ARGV + cs.F32_ARGV))
    blocks = GraphBatch.host(train.s).blocks_in
    assert {C: round(cs.work_bound(blocked_work(blocks, C, 4))[0], 4)
            for C in (32, 256, 320)} == {32: 0.0013, 256: 0.0093,
                                         320: 0.0116}
    assert {C: round(cs.work_bound(blocked_work(blocks, C, 2))[0], 4)
            for C in (256, 320)} == {256: 0.0070, 320: 0.0087}
