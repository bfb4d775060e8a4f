"""The port's memory tiers held against the JAX package on the CPU: the
source-streamed top-k (``ops/topk.streamed_topk``), the host-RAM offload
tier (``ops/offload.py``: the prefetch ring and both offloaded searches),
the serve engine's streamed and offload tiers, and the DBP15K CLI's
memory-tier flags (``--blocked_adjacency``, ``--stream_chunk``,
``--topk_block``, ``--offload-corpus``, ``--prefetch-depth``).

Tolerances: every search result is compared bit for bit — indices and
values — with the port's unchunked search (ties, masks, ragged chunks and
a degenerate ``k`` included: the port's plain scan sums each score per
row, independently of the other rows), and with the JAX package's:
indices equal, values within rtol 1e-5 (continuous float32 inputs, the
channels summed in another order; the tie pins are exact duplicates, so
each framework ties them within itself). The engine's tiers give
identical answers. The CLI's first phase-1 loss on its blocked
batches, with JAX's weights and negatives and ψ₁'s dropout off, agrees
with JAX's to rtol 1e-5 and its gradients to rtol 1e-4 / atol 1e-4 x
max|grad| (float32 summed in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.experiments import dbp15k as jax_dbp15k
from dgmc_tpu.ops.offload import offloaded_corpus_topk as jax_corpus_topk
from dgmc_tpu.ops.offload import offloaded_streamed_topk as jax_offloaded
from dgmc_tpu.ops.topk import streamed_topk as jax_streamed
from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops import offload
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.offload import (OffloadStats, PrefetchRing,
                                        offloaded_corpus_topk,
                                        offloaded_streamed_topk)
from dgmc_tpu_torch.ops.topk import chunked_topk, streamed_topk
from dgmc_tpu_torch.serve.client import sample_query
from dgmc_tpu_torch.serve.corpus import load_or_build, synthetic_corpus
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import QueryRouter


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_ring_prefetches_ahead_and_evicts_behind():
    """get(i) serves chunk i, keeps the next `depth` chunks in flight and
    drops everything behind the cursor (JAX's tests/ops/test_offload.py)."""
    fetched = []

    def source(i):
        fetched.append(i)
        return np.full((2, 2), i, np.float32)

    ring = PrefetchRing(source, depth=2, n_chunks=6, device='cpu')
    a = ring.get(0)
    assert torch.equal(a, torch.zeros(2, 2))
    assert fetched == [0, 1, 2] and ring.misses == 1
    assert ring.in_flight == 3 and ring.puts == 3
    ring.get(1)
    assert fetched == [0, 1, 2, 3] and ring.misses == 1
    assert ring.evictions == 1 and sorted(ring._slots) == [1, 2, 3]
    ring.get(4)                       # skip ahead: 4 was never prefetched
    assert ring.misses == 2 and sorted(ring._slots) == [4, 5]
    ring.get(5)
    assert sorted(ring._slots) == [5]
    assert sorted(fetched) == list(range(6))    # each fetched once


def test_ring_array_source_and_depth_floor():
    table = np.zeros((5, 3), np.float32)
    ring = PrefetchRing(table, depth=1, device='cpu')
    assert ring.n_chunks == 5
    ring.get(0)
    assert ring.in_flight == 2
    assert PrefetchRing(table, depth=0, device='cpu').depth == 1
    with pytest.raises(ValueError, match='n_chunks'):
        PrefetchRing(lambda i: table, device='cpu')


def _ties(seed=5, n_s=37, c=8):
    """Continuous inputs with duplicated target rows (value ties) and a
    mask, a ragged number of source rows."""
    rng = np.random.RandomState(seed)
    base = rng.randn(2, 16, c).astype(np.float32)
    h_t = np.concatenate([base, base], axis=1)
    h_s = rng.randn(2, n_s, c).astype(np.float32)
    return h_s, h_t, rng.rand(2, 32) > 0.4


@pytest.mark.parametrize('chunk', [1, 8, 16, 37, 64])
def test_streamed_topk_bit_identical_to_chunked_and_jax(chunk):
    h_s, h_t, tm = _ties()
    want_v, want_i = jax_streamed(jnp.asarray(h_s), jnp.asarray(h_t), 5,
                                  chunk, t_mask=jnp.asarray(tm), block=8,
                                  pallas=False, return_values=True)
    dv, di = chunked_topk(_t(h_s), _t(h_t), 5, _t(tm), block=8,
                          return_values=True)
    sv, si = streamed_topk(_t(h_s), _t(h_t), 5, chunk, _t(tm), block=8,
                           return_values=True)
    assert torch.equal(si, di) and torch.equal(sv, dv)
    np.testing.assert_array_equal(si.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(sv.numpy(), np.asarray(want_v), rtol=1e-5)
    assert torch.equal(streamed_topk(_t(h_s), _t(h_t), 5, chunk, _t(tm)),
                       si)
    with pytest.raises(ValueError, match='chunk'):
        streamed_topk(_t(h_s), _t(h_t), 5, 0)


@pytest.mark.parametrize('depth', [1, 2, 4])
def test_offloaded_streamed_matches_device_and_jax(depth):
    h_s, h_t, tm = _ties()
    dv, di = streamed_topk(_t(h_s), _t(h_t), 5, 8, _t(tm), block=8,
                           return_values=True)
    ov, oi, stats = offloaded_streamed_topk(h_s, h_t, 5, 8, t_mask=tm,
                                            block=8, depth=depth,
                                            device='cpu')
    assert torch.equal(oi, di) and torch.equal(ov, dv)
    jv, ji, jstats = jax_offloaded(h_s, h_t, 5, 8, t_mask=tm, block=8,
                                   depth=depth, devices=jax.devices()[:1])
    np.testing.assert_array_equal(oi.numpy(), ji)
    np.testing.assert_allclose(ov.numpy(), jv, rtol=1e-5)
    assert isinstance(stats, OffloadStats)
    assert (stats.rows, stats.chunks, stats.ring_misses) == (37, 5, 1)
    assert (stats.ring_misses, stats.chunks) == (jstats.ring_misses,
                                                 jstats.chunks)
    assert stats.prefetch_depth == depth and stats.devices == 1
    # Every row moved host -> device once (the ragged tail as it is).
    assert stats.bytes_streamed == h_s.nbytes
    assert stats.host_resident_bytes == h_s.nbytes + ov.numel() * 4 + \
        oi.numel() * 4
    assert stats.to_json()['ring_evictions'] == 4


def _corpus_tables(seed=0, B=1, Ns=7, Nt=53, C=8):
    rng = np.random.RandomState(seed)
    h_s = rng.randn(B, Ns, C).astype(np.float32)
    h_t = rng.randn(B, Nt, C).astype(np.float32)
    h_t[:, 10] = h_t[:, 40]       # exact duplicates: the tie-order pin
    h_t[:, 3] = h_t[:, 22]
    return h_s, h_t


@pytest.mark.parametrize('chunk', [4, 8, 16, 53, 64])
def test_offloaded_corpus_bit_identical_to_chunked_and_jax(chunk):
    h_s, h_t = _corpus_tables()
    dv, di = chunked_topk(_t(h_s), _t(h_t), 5, block=8, return_values=True)
    ov, oi, stats = offloaded_corpus_topk(h_s, h_t, 5, chunk, block=8,
                                          device='cpu')
    assert torch.equal(oi, di) and torch.equal(ov, dv)
    jv, ji, _ = jax_corpus_topk(h_s, h_t, 5, chunk, block=8)
    np.testing.assert_array_equal(oi.numpy(), ji)
    np.testing.assert_allclose(ov.numpy(), jv, rtol=1e-5)
    assert stats.chunks == -(-53 // chunk) and stats.ring_misses == 1
    assert stats.rows == 53 and stats.bytes_streamed == h_t.nbytes


@pytest.mark.parametrize('valid', [45, 3])
def test_offloaded_corpus_with_mask_and_k_above_valid(valid):
    """A mask, and k above the valid targets: the masked columns fill the
    tail in index order (finfo.min, their own indices), as on the
    device."""
    h_s, h_t = _corpus_tables(seed=1 if valid == 45 else 2)
    mask = np.zeros((1, 53), bool)
    mask[0, :valid] = True
    k = 4 if valid == 45 else 6
    dv, di = chunked_topk(_t(h_s), _t(h_t), k, _t(mask), block=8,
                          return_values=True)
    ov, oi, _ = offloaded_corpus_topk(h_s, h_t, k, 16, t_mask=mask, block=8,
                                      device='cpu')
    assert torch.equal(oi, di) and torch.equal(ov, dv)
    jv, ji, _ = jax_corpus_topk(h_s, h_t, k, 16, t_mask=mask, block=8)
    np.testing.assert_array_equal(oi.numpy(), ji)
    np.testing.assert_allclose(ov.numpy(), jv, rtol=1e-5)
    if valid == 3:
        assert (ov[..., 3:] == torch.finfo(torch.float32).min).all()
        assert (oi[0, :, 3:] == torch.arange(3, 6)).all()
    with pytest.raises(ValueError, match='k='):
        offloaded_corpus_topk(h_s, h_t, 54, 16, device='cpu')


def test_offloaded_searches_bit_identical_in_bf16():
    """The bf16 policy's tables: both offloaded searches return what the
    device searches do, values in bfloat16."""
    rng = np.random.RandomState(3)
    h_s = torch.from_numpy(rng.randn(1, 29, 16).astype(np.float32)).to(
        torch.bfloat16)
    h_t = torch.from_numpy(rng.randn(1, 41, 16).astype(np.float32)).to(
        torch.bfloat16)
    dv, di = chunked_topk(h_s, h_t, 6, return_values=True)
    ov, oi, _ = offloaded_streamed_topk(h_s, h_t, 6, 10, device='cpu')
    assert ov.dtype == torch.bfloat16
    assert torch.equal(oi, di) and torch.equal(ov, dv)
    cv, ci, _ = offloaded_corpus_topk(h_s, h_t, 6, 9, device='cpu')
    assert torch.equal(ci, di) and torch.equal(cv, dv)


def test_offload_scale_run_verifies_its_prefix(capsys):
    assert offload.main(['--device', 'cpu', '--rows', '3000', '--targets',
                         '400', '--dim', '8', '--chunk', '700',
                         '--verify-rows', '1500']) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['metric'] == 'offloaded_shortlist'
    assert rec['verified_equal'] is True and rec['verified_rows'] == 1500
    assert rec['offload']['chunks'] == 5 and rec['offload']['rows'] == 3000


def test_dgmc_stream_chunk_gives_the_same_forward():
    """stream_chunk moves the search only: one top-k search per chunk,
    the same correspondences; refused for the dense variant."""
    from dgmc_tpu_torch.ops.graph import GraphBatch
    rng = np.random.RandomState(4)

    def side(n, e):
        return GraphBatch.from_numpy(
            {'x': rng.randn(1, n, 6).astype(np.float32),
             'senders': rng.randint(0, n, (1, e)),
             'receivers': rng.randint(0, n, (1, e)),
             'node_mask': np.ones((1, n), bool),
             'edge_mask': np.ones((1, e), bool)}, 'cpu')

    g_s, g_t = side(30, 90), side(40, 120)
    tm = DGMC(RelCNN(6, 8, 2), RelCNN(4, 4, 2), num_steps=2, k=5,
              generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = tm(g_s, g_t, noise_seed=3)
        tm.stream_chunk = 7
        dispatch.reset()
        got = tm(g_s, g_t, noise_seed=3)
    assert dispatch.decisions()['topk']['counts']['plain'] == 5
    for a, b in zip(got, want):
        assert torch.equal(a.idx, b.idx) and torch.equal(a.val, b.val)
    dense = DGMC(RelCNN(6, 8, 2), RelCNN(4, 4, 2), num_steps=1, k=-1,
                 stream_chunk=8)
    with pytest.raises(ValueError, match='stream_chunk'):
        dense.eval()(g_s, g_t)


@pytest.fixture(scope='module')
def serve_setup():
    corpus = synthetic_corpus(300, 900, 12, seed=0)
    tm = DGMC(RelCNN(12, 16, 2), RelCNN(8, 8, 2), num_steps=3, k=5,
              generator=torch.Generator().manual_seed(0)).eval()
    index, _ = load_or_build(None, tm.psi_1, corpus, device='cpu')
    queries = [sample_query(corpus.x, n, 3 * n, seed=s)[0]
               for n, s in ((12, 1), (20, 2), (31, 3))]
    return corpus, tm, index, queries


@pytest.mark.parametrize('jit', [True, False])
@pytest.mark.parametrize('tier', ['streamed', 'offload'])
def test_engine_tiers_answer_as_the_device_tier(serve_setup, tier, jit):
    corpus, tm, index, queries = serve_setup

    def engine(**kw):
        router = QueryRouter('16x48,32x96', corpus.num_nodes,
                             corpus.num_edges)
        eng = MatchEngine(tm, index, router, max_results=3, device='cpu',
                          jit=jit, **kw)
        eng.warm()
        return eng

    device = engine()
    want = [device.match(q) for q in queries]
    r_s = np.random.RandomState(9).randn(3, 1, 32, 8).astype(np.float32)
    want.append(device.match(queries[2], r_s=r_s))
    if tier == 'streamed':
        tm.stream_chunk = 6
        try:
            eng = engine()
            got = [eng.match(q) for q in queries]
            got.append(eng.match(queries[2], r_s=r_s))
        finally:
            tm.stream_chunk = None
    else:
        eng = engine(offload=True, offload_chunk=64, prefetch_depth=3)
        assert eng._h_t is None
        got = [eng.match(q) for q in queries]
        got.append(eng.match(queries[2], r_s=r_s))
        stats = eng.last_offload
        assert stats.chunks == -(-300 // 64) and stats.prefetch_depth == 3
        assert stats.ring_misses == 1
    assert got == want


def _cli_argv(extra=()):
    return ['--device', 'cpu', '--synthetic', '--syn_nodes_s', '1500',
            '--syn_nodes_t', '2000', '--syn_edges_s', '7500',
            '--syn_edges_t', '9000', '--syn_dim', '24', '--dim', '16',
            '--rnd_dim', '8', '--num_layers', '2', '--num_steps', '2',
            '--f32', *extra]


@pytest.mark.parametrize('flags,want', [
    ((), True), (('--stream_chunk', '400'), False),
    (('--stream_chunk', '400', '--blocked_adjacency', 'on'), True),
    (('--blocked_adjacency', 'off'), False)])
def test_cli_blocked_adjacency_resolves_as_jax(flags, want):
    args = dbp15k.parse_args(_cli_argv(flags)[2:])
    jargs = jax_dbp15k.parse_args(_cli_argv(flags)[2:])
    assert dbp15k.use_blocked_adjacency(args) is want
    assert jax_dbp15k.use_blocked_adjacency(jargs) is want


def test_cli_blocked_batches_and_first_loss_match_jax():
    """The CLI's synthetic batches at 1500 / 2000 entities carry JAX's
    blocked tables (auto = on); the first phase-1 loss and gradients of
    the CLI's model on them match JAX's (JAX's weights converted, its
    negatives injected, ψ₁'s dropout off)."""
    from dgmc_tpu.models import DGMC as JaxDGMC
    from dgmc_tpu.models import RelCNN as JaxRelCNN
    from dgmc_tpu.models import metrics as jmetrics
    from dgmc_tpu_torch.convert import dgmc_from_flax
    from dgmc_tpu_torch.models import metrics
    from dgmc_tpu_torch.train.steps import batch_to_device
    argv = _cli_argv()[2:]
    jargs, targs = jax_dbp15k.parse_args(argv), dbp15k.parse_args(argv)
    jtrain, _, in_dim = jax_dbp15k.synthetic_batches(jargs)
    ttrain, ttest, _ = dbp15k.synthetic_batches(targs)
    for side in ('s', 't'):
        jg, tg = getattr(jtrain, side), getattr(ttrain, side)
        assert jg.blocks_in is not None
        for key in ('blocks_in', 'blocks_out'):
            for f in ('src', 'dst_local', 'mask', 'range_id', 'inv_degree'):
                np.testing.assert_array_equal(
                    getattr(tg[key], f).numpy(),
                    np.asarray(getattr(getattr(jg, key), f)))
        np.testing.assert_array_equal(tg['x'], np.asarray(jg.x))
    assert ttest.s['blocks_in'] is ttrain.s['blocks_in']
    np.testing.assert_array_equal(ttrain.y, np.asarray(jtrain.y))

    jm = JaxDGMC(JaxRelCNN(in_dim, 16, 2, dropout=0.0),
                 JaxRelCNN(8, 8, 2), num_steps=2, k=10)
    rngs = {'noise': jax.random.key(3), 'negatives': jax.random.key(4)}
    params = jax.device_get(jm.init({'params': jax.random.key(0), **rngs},
                                    jtrain.s, jtrain.t)['params'])
    y, ym = jnp.asarray(jtrain.y), jnp.asarray(jtrain.y_mask)

    def jloss(p):
        S_0, S_L = jm.apply({'params': p}, jtrain.s, jtrain.t, y=y,
                            y_mask=ym, train=True, num_steps=0, rngs=rngs)
        return jmetrics.nll_loss(S_L, y, ym), S_L.idx

    (want, idx), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = DGMC(RelCNN(in_dim, 16, 2), RelCNN(8, 8, 2), num_steps=2, k=10)
    tm.load_state_dict(dgmc_from_flax(params))
    b = batch_to_device(ttrain, 'cpu')
    _, S_L = tm.train()(b.graph_s, b.graph_t, y=b.y, y_mask=b.y_mask,
                        num_steps=0,
                        negatives=torch.from_numpy(np.asarray(
                            idx)[..., 10:]).long())
    np.testing.assert_array_equal(S_L.idx.numpy(), np.asarray(idx))
    loss = metrics.nll_loss(S_L, b.y, b.y_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    got = dict(tm.named_parameters())
    for name, w in dgmc_from_flax(jax.device_get(want_g)).items():
        if not name.startswith('psi_1.'):
            continue
        w = w.numpy()
        np.testing.assert_allclose(got[name].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_cli_streamed_offload_pass_prints_equal(tmp_path, capsys):
    """--stream_chunk (blocked off by auto) with --offload-corpus: one
    top-k search per chunk in every step, the offload pass bit-equal,
    logged."""
    log = tmp_path / 'kg.jsonl'
    dispatch.reset()
    steps = []
    dbp15k.main(_cli_argv(['--stream_chunk', '400', '--offload-corpus',
                           '--prefetch-depth', '3', '--topk_block', '64',
                           '--epochs', '11', '--phase1_epochs', '10',
                           '--metrics_log', str(log)]),
                hook=lambda kind, e, o: steps.append(
                    dispatch.decisions()['topk']['counts']['plain']))
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith('# offload')]
    assert line and 'equal=True' in line[0] and 'chunks=4' in line[0]
    assert 'depth=3' in line[0]
    # 4 source chunks (1500 rows / 400): 4 searches per step.
    assert steps[0] == 4 and steps[1] - steps[0] == 4
    assert 'blocked' not in dispatch.decisions()
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    off = [r for r in recs if r.get('event') == 'offload_shortlist']
    assert len(off) == 1 and off[0]['offload_equal'] == 1.0
    assert off[0]['offload_prefetch_depth'] == 3


def test_cli_trains_blocked_by_default():
    dispatch.reset()
    losses = []
    dbp15k.main(_cli_argv(['--epochs', '11', '--phase1_epochs', '10',
                           '--bf16']),
                hook=lambda kind, e, o: losses.append(float(o['loss']))
                if kind == 'train' else None)
    d = dispatch.decisions()['blocked']
    # bf16 policy: ψ₁'s 16-wide bf16 rows are widened to float32.
    assert d['path'] == 'plain' and d['dtype'] == 'float32'
    assert len(losses) == 11 and np.isfinite(losses).all()
