"""The port's measured per-stage account (``obs/trace_events.py``,
``obs/attribution.py``) on Kineto's Chrome traces, on the CPU.

The JAX package's cases (``tests/obs/test_attribution.py``) moved to the
format ``torch.profiler`` writes: kernels linked to their launches by
correlation id, host ranges, ``cudaStreamSynchronize`` waits; truncated
JSON and a bad gzip stream are named errors, one corrupt trace does not
discard the others, overlapping slices are not counted twice, a trace
without device slices degrades to the host's account, and one card's
overlap fraction is absent (None), never 0. Then the replay map: a
CPU-profiled eager train step, its aten ops given stand-in kernels, gives
the same stage table read as an eager step and as a replayed graph
through its warm-up; a replay whose kernel names differ is ``unmatched``.
Last, a trace cut from the card (``test_torch_attribution_golden.json.gz``:
two replayed bf16 KG phase-2 steps and the warm-up of their capture) is
parsed to the stage table stated below.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.obs import attribution as attr_mod
from dgmc_tpu_torch.obs import trace_events as te

GOLDEN = os.path.join(os.path.dirname(__file__),
                      'test_torch_attribution_golden.json.gz')
PID, GPU = 4242, 0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta(pid, name, tid=None):
    e = {'ph': 'M', 'pid': pid, 'name': 'process_name' if tid is None
         else 'thread_name', 'args': {'name': name}}
    if tid is not None:
        e['tid'] = tid
    return e


def _x(pid, tid, ts, dur, name, cat, args=None):
    return {'ph': 'X', 'pid': pid, 'tid': tid, 'ts': ts, 'dur': dur,
            'name': name, 'cat': cat, 'args': dict(args or {})}


def _launch(ts, corr, name='cudaLaunchKernel', tid=1):
    return _x(PID, tid, ts, 5, name, 'cuda_runtime', {'correlation': corr})


def _kernel(ts, dur, corr, name='k', stream=7):
    return _x(GPU, stream, ts, dur, name, 'kernel', {'correlation': corr})


def device_host_events():
    """Two steps: psi1 and topk kernels, a copy on a second stream, a
    host wait; window 0-4000 us, the card busy 2100 us (the copy
    overlaps the second kernel)."""
    return [
        _meta(PID, 'python'), _meta(PID, 'main', tid=1),
        _meta(GPU, 'GPU 0'), _meta(GPU, 'stream 7', tid=7),
        _x(PID, 1, 0, 2000, 'dgmc_step#0', 'user_annotation'),
        _x(PID, 1, 2000, 2000, 'dgmc_step#1', 'user_annotation'),
        _x(PID, 1, 10, 400, 'psi1', 'user_annotation'),
        _launch(20, 1), _launch(30, 2),
        _x(PID, 1, 500, 300, 'topk', 'user_annotation'),
        _launch(510, 3, 'cudaMemcpyAsync'),
        _x(PID, 1, 1500, 500, 'cudaStreamSynchronize', 'cuda_runtime'),
        _x(PID, 1, 2010, 100, 'psi1', 'user_annotation'),
        _launch(2020, 4),
        _kernel(100, 500, 1, 'gemm'), _kernel(600, 500, 2, 'gemm'),
        _x(GPU, 8, 700, 500, 'Memcpy DtoD', 'gpu_memcpy',
           {'correlation': 3}),
        _kernel(2100, 1000, 4, 'gemm'),
        _x(GPU, 7, 2100, 1000, 'dgmc_step#1', 'gpu_user_annotation'),
    ]


GOLDEN_STAGES = {
    'psi1': {'wall_s': 0.002, 'events': 3, 'share': 0.8},
    'topk': {'wall_s': 0.0005, 'events': 1, 'share': 0.2},
}


def write_trace(d, events, name='dgmc_torch.1.0.pt.trace.json', gz=False):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), name + ('.gz' if gz else ''))
    raw = json.dumps({'traceEvents': events}).encode()
    with (gzip.open(path, 'wb') if gz else open(path, 'wb')) as f:
        f.write(raw)
    return path


def test_merge_and_intersect_intervals():
    merged = te.merge_intervals([(0, 10), (5, 15), (20, 30), (30, 31),
                                 (2, 3)])
    assert merged == [(0, 15), (20, 31)]
    assert te.sum_intervals(merged) == 26
    other = te.merge_intervals([(12, 22), (25, 40)])
    inter = te.intersect_intervals(merged, other)
    assert inter == [(12, 15), (20, 22), (25, 31)]
    assert te.sum_intervals(inter) == 11
    assert te.merge_intervals([]) == []
    assert te.intersect_intervals([], merged) == []


def test_device_host_golden_stage_table(tmp_path):
    write_trace(tmp_path, device_host_events())
    payload, _ = attr_mod.build_attribution(str(tmp_path))
    assert payload['device_available'] is True
    assert payload['stage_source'] == 'device'
    assert payload['stages'] == GOLDEN_STAGES
    assert payload['stage_sources'] == {'range': 4}
    occ = payload['occupancy']
    assert occ['window_s'] == 0.004
    assert occ['device_active_s'] == 0.0021
    assert occ['device_idle_s'] == 0.0019
    assert occ['device_idle_fraction'] == 0.475
    assert occ['compute_busy_s'] == 0.0021
    assert occ['comm_busy_s'] == 0.0
    assert occ['overlapped_s'] == 0.0
    # One card: no communication, so no overlap fraction (not 0).
    assert occ['measured_overlap_fraction'] is None
    assert occ['host_wait_s'] == 0.0005
    assert occ['idle_fraction'] == 0.475
    assert occ['idle_source'] == 'device'
    assert payload['steps'] == {'observed': 2, 'wall_s': 0.004,
                                'mean_s': 0.002}
    assert payload['per_step'] == {'device_active_s': 0.00105, 'steps': 2}
    assert payload['unavailable'] == []
    assert payload['errors'] == []


def test_gzipped_trace_is_identical(tmp_path):
    write_trace(tmp_path / 'plain', device_host_events())
    write_trace(tmp_path / 'zipped', device_host_events(), gz=True)
    a, _ = attr_mod.build_attribution(str(tmp_path / 'plain'))
    b, _ = attr_mod.build_attribution(str(tmp_path / 'zipped'))
    assert a['stages'] == b['stages'] == GOLDEN_STAGES
    assert a['occupancy'] == b['occupancy']


def test_trace_without_device_slices_degrades_to_host(tmp_path):
    events = [e for e in device_host_events()
              if not (e.get('ph') == 'X' and e.get('pid') == GPU)]
    write_trace(tmp_path, events)
    payload, _ = attr_mod.build_attribution(str(tmp_path))
    assert payload['device_available'] is False
    assert payload['stage_source'] == 'host'
    occ = payload['occupancy']
    for key in ('device_active_s', 'device_idle_s', 'device_idle_fraction',
                'compute_busy_s', 'comm_busy_s', 'overlapped_s',
                'measured_overlap_fraction'):
        assert occ[key] is None, key
    assert occ['idle_source'] == 'host'
    assert payload['per_step'] is None
    assert set(attr_mod._DEVICE_FIELDS) == set(payload['unavailable'])
    assert occ['host_wait_s'] == 0.0005
    assert set(payload['stages']) == {'psi1', 'topk', 'other'}


def test_truncated_json_is_a_named_error(tmp_path):
    path = write_trace(tmp_path, device_host_events())
    raw = open(path, 'rb').read()
    with open(path, 'wb') as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(te.TraceParseError) as ei:
        te.read_trace_file(path)
    assert 'truncated or corrupt JSON' in str(ei.value)
    with pytest.raises(te.TraceParseError):
        attr_mod.build_attribution(str(tmp_path))


def test_one_corrupt_trace_does_not_discard_the_others(tmp_path):
    write_trace(tmp_path, device_host_events())
    bad = write_trace(tmp_path, [], name='dgmc_torch.1.1.pt.trace.json')
    with open(bad, 'wb') as f:
        f.write(b'{"traceEvents": [')
    payload, _ = attr_mod.build_attribution(str(tmp_path))
    assert payload['stages'] == GOLDEN_STAGES
    assert len(payload['errors']) == 1
    assert 'dgmc_torch.1.1.pt.trace.json' in payload['errors'][0]


def test_bad_gzip_stream_is_a_named_error(tmp_path):
    path = os.path.join(str(tmp_path), 'x.pt.trace.json.gz')
    with open(path, 'wb') as f:
        f.write(b'\x1f\x8b' + b'not really gzip')
    with pytest.raises(te.TraceParseError) as ei:
        te.read_trace_file(path)
    assert 'bad gzip' in str(ei.value)


def test_overlapping_slices_do_not_double_count(tmp_path):
    """Kernels on two streams that overlap union to their cover; the
    stage of each is its launch's."""
    events = [
        _meta(GPU, 'GPU 0'),
        _x(PID, 1, 0, 100, 'psi2', 'user_annotation'),
        _launch(10, 1), _launch(20, 2),
        _x(PID, 1, 100, 100, 'topk', 'user_annotation'),
        _launch(110, 3),
        _kernel(200, 500, 1, 'a', stream=7),
        _kernel(300, 300, 2, 'b', stream=8),
        _kernel(1200, 200, 3, 'c', stream=7),
    ]
    write_trace(tmp_path, events)
    payload, _ = attr_mod.build_attribution(str(tmp_path))
    occ = payload['occupancy']
    assert occ['device_active_s'] == 0.0007
    assert occ['compute_busy_s'] == 0.0007
    assert payload['stages'] == {
        'psi2': {'wall_s': 0.0005, 'events': 2, 'share': 0.7143},
        'topk': {'wall_s': 0.0002, 'events': 1, 'share': 0.2857},
    }


def test_backward_kernels_take_their_forward_stage(tmp_path):
    """A launch inside an autograd node goes to the stage of the forward
    op holding the node's sequence number, not to the ranges open on the
    backward's thread."""
    events = [
        _meta(GPU, 'GPU 0'),
        _x(PID, 1, 0, 100, 'consensus_iter', 'user_annotation'),
        _x(PID, 1, 10, 20, 'aten::mm', 'cpu_op', {'Sequence number': 7}),
        _launch(15, 1),
        _x(PID, 1, 200, 100, 'loss', 'user_annotation'),
        _x(PID, 1, 210, 20, 'aten::sum', 'cpu_op', {'Sequence number': 9}),
        _x(PID, 2, 400, 100, 'autograd::engine::evaluate_function: '
           'MmBackward0', 'cpu_op', {'Sequence number': 7}),
        _launch(410, 2, tid=2),
        _x(PID, 2, 600, 100, 'autograd::engine::evaluate_function: '
           'SumBackward0', 'cpu_op', {'Sequence number': 9}),
        _launch(610, 3, tid=2),
        _kernel(20, 10, 1), _kernel(420, 10, 2), _kernel(620, 30, 3),
    ]
    write_trace(tmp_path, events)
    payload, _ = attr_mod.build_attribution(str(tmp_path))
    assert {k: v['events'] for k, v in payload['stages'].items()} == {
        'consensus_iter': 2, 'loss': 1}


def test_attribution_schema_and_cli(tmp_path, capsys):
    prof, obs = tmp_path / 'prof', tmp_path / 'obs'
    write_trace(prof, device_host_events())
    os.makedirs(obs)
    with open(obs / 'efficiency.json', 'w') as f:
        json.dump({'programs': {'train_step': {'flops': 2.5e9}},
                   'peak_flops': 1e15, 'mfu': 0.001}, f)
    with open(obs / 'timings.json', 'w') as f:
        json.dump({'steps': {'p50_s': 0.002}}, f)
    assert attr_mod.main([str(prof), '--obs-dir', str(obs)]) == 0
    assert 'measured-runtime attribution' in capsys.readouterr().out
    with open(obs / 'attribution.json') as f:
        payload = json.load(f)
    assert set(payload) == {
        'schema', 'source', 'errors', 'device_available', 'window_s',
        'steps', 'stages', 'stage_source', 'stage_sources',
        'unmatched_share', 'replays', 'occupancy', 'per_step', 'tracks',
        'unavailable', 'reconciliation'}
    rec = payload['reconciliation']
    # 2.5 GFLOP a step over 1.05 ms of device time at 1 PFLOP/s.
    assert rec['measured_mfu'] == 0.002381
    assert rec['static_mfu'] == 0.001
    with open(obs / 'efficiency.json') as f:
        eff = json.load(f)
    assert eff['measured_mfu'] == 0.002381
    assert eff['idle_fraction'] == 0.475
    assert eff['programs'] == {'train_step': {'flops': 2.5e9}}
    assert attr_mod.main([str(tmp_path / 'missing')]) == 2


# ---------------------------------------------------------------------------
# The replay map
# ---------------------------------------------------------------------------


def _profiled_eager_step():
    """A CPU trace of one eager train step of a small sparse DGMC, under
    a ``dgmc_warmup#k`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from dgmc_tpu_torch.models.dgmc import DGMC
    from dgmc_tpu_torch.models.rel import RelCNN
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    from dgmc_tpu_torch.utils.data import PairBatch
    rng = np.random.RandomState(0)

    def side(n, e):
        return dict(x=rng.randn(1, n, 4).astype(np.float32),
                    senders=rng.randint(0, n, (1, e)).astype(np.int32),
                    receivers=rng.randint(0, n, (1, e)).astype(np.int32),
                    node_mask=np.ones((1, n), bool),
                    edge_mask=np.ones((1, e), bool))
    batch = PairBatch(s=side(8, 16), t=side(10, 20),
                      y=(np.arange(8) % 10)[None],
                      y_mask=np.ones((1, 8), bool))
    model = DGMC(RelCNN(4, 8, num_layers=1), RelCNN(4, 4, num_layers=1),
                 num_steps=2, k=3)
    step = make_train_step(model, jit=False)
    state = create_train_state(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('dgmc_warmup#k'):
            step(state, batch, 1)
    path = os.path.join(os.environ.get('TMPDIR', '/tmp'),
                        f'dgmc_cpu_step_{os.getpid()}.json')
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)['traceEvents']
    finally:
        os.remove(path)


def _with_kernels(events):
    """Each leaf aten op of the trace gets a stand-in launch on its
    thread and a kernel named after it on the card, one after another."""
    ops = sorted((e for e in events if e.get('cat') == 'cpu_op'),
                 key=lambda e: (e['tid'], e['ts'], -e['dur']))
    leaves = []
    for i, e in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        inner = (nxt is not None and nxt['tid'] == e['tid']
                 and nxt['ts'] < e['ts'] + e['dur'])
        if e['name'].startswith('aten::') and not inner:
            leaves.append(e)
    out = [e for e in events if e.get('ph') != 'X'
           or e.get('cat') != 'cuda_runtime'] + [_meta(GPU, 'GPU 0')]
    t_gpu = max(e['ts'] + e.get('dur', 0) for e in events
                if e.get('ph') == 'X')
    kernels = []
    for corr, e in enumerate(sorted(leaves, key=lambda e: e['ts']), 1):
        out.append(dict(_launch(e['ts'] + e['dur'] / 2, corr),
                        pid=e['pid'], tid=e['tid'], dur=0.01))
        kernels.append(_kernel(t_gpu + 10 * corr, 5, corr,
                               f'k_{e["name"][6:]}'))
    return out + kernels, kernels


def _replay(kernels, key='k'):
    """A replay of ``kernels`` (names and durations): one graph launch
    under ``dgmc_replay#<key>`` in a step range."""
    corr = 10 ** 6
    t0 = 10 ** 7
    events = [_meta(PID, 'python'), _meta(GPU, 'GPU 0'),
              _x(PID, 1, t0, 100, 'dgmc_step#0', 'user_annotation'),
              _x(PID, 1, t0 + 1, 50, f'dgmc_replay#{key}',
                 'user_annotation'),
              _launch(t0 + 2, corr, 'cudaGraphLaunch')]
    for i, k in enumerate(kernels):
        events.append(_kernel(t0 + 100 + 10 * i, k['dur'], corr,
                              k['name']))
    return events


@pytest.fixture(scope='module')
def eager_step():
    return _with_kernels(_profiled_eager_step())


def test_replayed_graph_has_the_eager_steps_stage_table(eager_step):
    events, kernels = eager_step
    eager = attr_mod.attribute_events([{'traceEvents': events}])
    stages = eager['stages']
    assert {'psi1', 'topk', 'initial_corr', 'consensus_iter', 'psi2',
            'loss', 'optimizer'} <= set(stages)
    assert eager['stage_sources'] == {'range': len(kernels)}
    replayed = attr_mod.attribute_events(
        [{'traceEvents': _replay(kernels)}],
        warmups=[{'traceEvents': events}])
    assert replayed['stages'] == stages
    assert replayed['stage_sources'] == {'replay': len(kernels)}
    assert replayed['replays'] == {'count': 1, 'matched': 1,
                                   'unmatched': []}
    assert replayed['unmatched_share'] == 0.0


def test_replay_with_another_kernel_is_unmatched(eager_step):
    events, kernels = eager_step
    changed = [dict(k) for k in kernels]
    changed[5] = dict(changed[5], name='k_other')
    got = attr_mod.attribute_events(
        [{'traceEvents': _replay(changed)}],
        warmups=[{'traceEvents': events}])
    assert set(got['stages']) == {'other'}
    assert got['stage_sources'] == {'unmatched': len(kernels)}
    assert got['unmatched_share'] == 1.0
    (bad,) = got['replays']['unmatched']
    assert 'first difference at 5' in bad['reason']
    short = attr_mod.attribute_events(
        [{'traceEvents': _replay(kernels[:-1])}],
        warmups=[{'traceEvents': events}])
    assert short['stage_sources'] == {'unmatched': len(kernels) - 1}
    missing = attr_mod.attribute_events([{'traceEvents': _replay(kernels)}])
    assert missing['replays']['unmatched'][0]['reason'] == 'no warm-up trace'


#: The stage table of the golden trace: one replayed bf16 KG phase-2
#: step (``chip_smoke.py`` ``obs`` (a), NVIDIA H100 80GB HBM3), cut to
#: every 25th kernel plus those of ``topk`` and ``loss``, with the same
#: kernels of its capture's warm-up.
GOLDEN_CARD = {
    'psi1': {'wall_s': 9.2e-05, 'events': 12, 'share': 0.0498},
    'psi2': {'wall_s': 0.000253, 'events': 73, 'share': 0.1372},
    'initial_corr': {'wall_s': 2e-06, 'events': 1, 'share': 0.0011},
    'topk': {'wall_s': 0.00092, 'events': 3, 'share': 0.4992},
    'consensus_iter': {'wall_s': 0.000448, 'events': 35, 'share': 0.2433},
    'loss': {'wall_s': 4.8e-05, 'events': 19, 'share': 0.0263},
    'optimizer': {'wall_s': 5e-06, 'events': 3, 'share': 0.0026},
    'other': {'wall_s': 7.5e-05, 'events': 43, 'share': 0.0405},
}


def test_golden_trace_from_the_card():
    golden = te.read_trace_file(GOLDEN)
    got = attr_mod.attribute_events(
        [{'traceEvents': golden['traceEvents']}],
        warmups=[{'traceEvents': golden['warmupEvents']}])
    assert got['device_available'] is True
    assert got['stages'] == GOLDEN_CARD
    assert got['stage_sources'] == {'replay': 171, 'replay_copy': 18}
    assert got['replays'] == {'count': 1, 'matched': 1, 'unmatched': []}
    assert got['unmatched_share'] == 0.0
    assert got['steps']['observed'] == 1
    assert got['occupancy']['device_active_s'] == 0.001842
    assert got['occupancy']['measured_overlap_fraction'] is None
    # Without its warm-up the replay cannot be staged: all 'other'.
    alone = attr_mod.attribute_events(
        [{'traceEvents': golden['traceEvents']}])
    assert set(alone['stages']) == {'other'}
    assert alone['unmatched_share'] == 1.0
    # The warm-up read as an eager step: its kernels by their launches,
    # in the stages the replay gave them (the replay's 18 copies took the
    # stage of the kernel before each).
    eager = attr_mod.attribute_events(
        [{'traceEvents': golden['warmupEvents']}])
    assert eager['stage_sources'] == {'range': 171}
    assert set(eager['stages']) == set(GOLDEN_CARD)
    assert all(eager['stages'][s]['events'] <= r['events']
               for s, r in GOLDEN_CARD.items())
    assert sum(r['events'] for r in eager['stages'].values()) == 171
