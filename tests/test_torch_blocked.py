"""The port's blocked adjacency (dgmc_tpu_torch/ops/blocked.py) held
against the JAX package's (dgmc_tpu/ops/blocked.py) on the CPU, with
flax weights carried across by dgmc_tpu_torch.convert.

Tolerances, stated per check:

- the host tables (``build_edge_blocks``): equal bit for bit, dtypes
  included; ``inv_degree`` equal to the masked in-degree's reciprocal.
- ``adj_matmul`` forward and gradient in float32: rtol 1e-5 / atol 1e-5
  against JAX's (the one-hot contractions sum the same float32 terms in
  another order), and against the dense reference sum.
- RelCNN and DGMC, blocked, float32: atol 1e-5 on O(1) activations, the
  correspondences atol 1e-5, gradients rtol 1e-4 / atol 1e-4 x max|grad|
  per tensor (the tolerances of tests/test_torch_graph_rel.py and
  tests/test_torch_sparse_train.py for the unblocked path).
- the row table (``row_ptr``, ``row_src``): equal to a pure-Python walk
  of the blocks in the kernel's order (ranges, then blocks, then slots).
- ``ordered_aggregate`` (the kernel's order and rounding): bit-equal to
  the plain version and to JAX's ``adj_matmul`` on integer-valued rows
  (every sum exact); within rtol 1e-5 / atol 1e-5 x max|out| of both on
  random float32 rows (the same float32 terms in another order); with
  bf16 rows under ``gather_dtype``, within one bf16 ulp of the float64
  sum of the widened rows, plus 1e-5 x max|out| for sums that cancel
  (an ulp of a value near 0 is smaller than float32 summation error).
- bf16 policy with ``gather_dtype='bfloat16'``: the forward within 2^-6
  relative plus 1e-2 of the largest |value| (bf16 products in another
  order, each output rounded to bf16 once), the gradients within 2e-2 of
  each tensor's norm. ``adj_matmul`` alone with bf16 rows (C = 256),
  forward and backward (whose float32 ``d_out`` is cast to bf16 first):
  rtol 1e-5 / atol 1e-5, the same bf16 terms summed in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import RelCNN as JaxRelCNN
from dgmc_tpu.models.precision import BF16 as JAX_BF16
from dgmc_tpu.ops import GraphBatch as JaxGraphBatch
from dgmc_tpu.ops import blocked as jb
from dgmc_tpu_torch.convert import dgmc_from_flax, relcnn_from_flax
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.ops import blocked as tb
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.kernels import blocked as kb
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.train.compiled import compiled

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: small tensors, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, b, n, e, c, hub=False):
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, n, (b, e)).astype(np.int32)
    receivers = rng.randint(0, n, (b, e)).astype(np.int32)
    if hub:  # one node receives half of all edges: many blocks, one range
        receivers[0, :e // 2] = 3
    return {'x': rng.randn(b, n, c).astype(np.float32), 'senders': senders,
            'receivers': receivers, 'node_mask': np.ones((b, n), bool),
            'edge_mask': rng.rand(b, e) > 0.15}


def _jgraph(a, **blocks):
    return JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                         edge_attr=None, **blocks)


def _dense_reference(a, values, transpose=False):
    snd, rcv = a['senders'], a['receivers']
    if transpose:
        snd, rcv = rcv, snd
    B, N, C = values.shape
    out = np.zeros((B, N, C), np.float64)
    for b in range(B):
        for e in range(snd.shape[1]):
            if a['edge_mask'][b, e]:
                out[b, rcv[b, e]] += values[b, snd[b, e]]
    return out


def _tables_equal(jax_blocks, port_blocks):
    for f in ('src', 'dst_local', 'mask', 'range_id', 'inv_degree'):
        want = np.asarray(getattr(jax_blocks, f))
        got = getattr(port_blocks, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (port_blocks.rows, port_blocks.num_ranges) == (
        jax_blocks.rows, jax_blocks.num_ranges)


@pytest.mark.parametrize('hub', [False, True])
def test_build_edge_blocks_tables_equal_jax(hub):
    a = _arrays(0, 2, 200, 1300, 8, hub=hub)
    args = (a['senders'], a['receivers'], a['edge_mask'], 200)
    j_in, j_out = jb.build_edge_blocks(*args, rows=32, block_edges=64)
    t_in, t_out = tb.build_edge_blocks(*args, rows=32, block_edges=64)
    _tables_equal(j_in, t_in)
    _tables_equal(j_out, t_out)
    for blocks in (t_in, t_out):
        # range_ptr: range r's blocks are exactly those with range_id r.
        for b in range(2):
            ptr = blocks.range_ptr[b].numpy()
            n_real = int(blocks.mask[b].any(-1).sum())
            rid = blocks.range_id[b].numpy()
            assert ptr[0] == 0 and ptr[-1] == n_real
            for r in range(blocks.num_ranges):
                assert (rid[ptr[r]:ptr[r + 1]] == r).all()
    if hub:
        # The hub's range takes several blocks of one range.
        assert (t_in.range_ptr[0, 1] - t_in.range_ptr[0, 0]) > 5


def _walk_row_table(blocks, num_nodes):
    """The row table by a pure-Python walk of the blocks in the order
    the kernel sums them: ranges in order, each range's blocks in order,
    each block's slots in order, a row's edges in slot order."""
    B = blocks.src.shape[0]
    ptrs, srcs = [], []
    for b in range(B):
        per_row = [[] for _ in range(num_nodes)]
        rp = blocks.range_ptr[b].tolist()
        for r in range(blocks.num_ranges):
            for blk in range(rp[r], rp[r + 1]):
                for e in range(blocks.src.shape[2]):
                    if blocks.mask[b, blk, e]:
                        row = r * blocks.rows + int(blocks.dst_local[b, blk,
                                                                     e])
                        per_row[row].append(int(blocks.src[b, blk, e]))
        ptrs.append(np.cumsum([0] + [len(r) for r in per_row]))
        srcs.append([s for r in per_row for s in r])
    return ptrs, srcs


@pytest.mark.parametrize('case', ['hub', 'padded', 'edgeless', 'ragged_n'])
def test_row_table_is_the_kernels_walk_of_the_blocks(case):
    """row_ptr / row_src in both directions equal the walk of the blocks
    the shared-memory kernel summed in: a hub batch (one range of many
    blocks), a batch padded to one block count (its second element has
    fewer blocks), an edgeless graph beside a full one, and N no multiple
    of the range (130 nodes in ranges of 32)."""
    n = 130 if case == 'ragged_n' else 200
    a = _arrays(14, 2, n, 1300, 4, hub=case == 'hub')
    if case == 'padded':
        a['edge_mask'][1, 400:] = False
    if case == 'edgeless':
        a['edge_mask'][0] = False
    t_in, t_out = tb.build_edge_blocks(a['senders'], a['receivers'],
                                       a['edge_mask'], n, rows=32,
                                       block_edges=64)
    for blocks in (t_in, t_out):
        ptrs, srcs = _walk_row_table(blocks, n)
        assert blocks.row_ptr.dtype == blocks.row_src.dtype == torch.int32
        assert tuple(blocks.row_ptr.shape) == (2, n + 1)
        assert blocks.row_src.shape[1] == max(1, max(map(len, srcs)))
        for b in range(2):
            np.testing.assert_array_equal(blocks.row_ptr[b].numpy(),
                                          ptrs[b])
            got = blocks.row_src[b].numpy()
            np.testing.assert_array_equal(got[:len(srcs[b])], srcs[b])
            assert not got[len(srcs[b]):].any()
    if case == 'padded':
        assert int(t_in.mask[1].any(-1).sum()) < t_in.src.shape[1]
    if case == 'edgeless':
        assert int(t_in.row_ptr[0, -1]) == 0 and int(t_in.row_ptr[1, -1]) > 0


def _bf16_ulp(x):
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


@pytest.mark.parametrize('hub', [False, True])
@pytest.mark.parametrize('C', [1, 32, 40])
def test_ordered_aggregate_matches_plain_and_jax(C, hub):
    """The kernel's reference, both directions: bit-equal to the plain
    version and to JAX's adj_matmul on integer rows, within rtol 1e-5 /
    atol 1e-5 x max|out| on random float32 rows."""
    a = _arrays(15 + C, 2, 130, 1300, C, hub=hub)
    args = (a['senders'], a['receivers'], a['edge_mask'], 130)
    j_in, j_out = jb.build_edge_blocks(*args, rows=32, block_edges=64)
    t_in, t_out = tb.build_edge_blocks(*args, rows=32, block_edges=64)
    ints = np.random.RandomState(C).randint(-4, 5, (2, 130, C)).astype(
        np.float32)
    for jf, jr, tf in ((j_in, j_out, t_in), (j_out, j_in, t_out)):
        for x, exact in ((ints, True), (a['x'], False)):
            got = tb.ordered_aggregate(torch.from_numpy(x), tf)
            plain = tb.plain_aggregate(torch.from_numpy(x), tf)
            want = torch.from_numpy(np.array(
                jb.adj_matmul(jnp.asarray(x), jf, jr)))
            assert got.dtype == torch.float32
            for other in (plain, want):
                if exact:
                    assert torch.equal(got, other)
                else:
                    torch.testing.assert_close(
                        got, other, rtol=1e-5,
                        atol=1e-5 * float(other.abs().max()))


def test_ordered_aggregate_bf16_rows_within_an_ulp_of_the_widened_sum():
    """gather_dtype bf16 at C = 256 and 320: the rows are rounded to
    bf16, widened exactly and summed in float32; within one bf16 ulp
    (plus 1e-5 x max|out|) of the float64 sum of the widened rows, as
    JAX's adj_matmul under the same gather_dtype is."""
    for C in (256, 320):
        a = _arrays(16, 1, 150, 800, C, hub=True)
        args = (a['senders'], a['receivers'], a['edge_mask'], 150)
        j_in, j_out = (b.replace(gather_dtype='bfloat16') for b in
                       jb.build_edge_blocks(*args, rows=32, block_edges=64))
        t_in, _ = (b.replace(gather_dtype='bfloat16') for b in
                   tb.build_edge_blocks(*args, rows=32, block_edges=64))
        x = torch.from_numpy(a['x'])
        got = tb.ordered_aggregate(x, t_in)
        widened = x.to(BF16).double().numpy()
        ref = torch.from_numpy(_dense_reference(a, widened))
        jax_out = torch.from_numpy(np.array(
            jb.adj_matmul(jnp.asarray(a['x']), j_in, j_out))).double()
        for out in (got.double(), jax_out):
            tol = _bf16_ulp(ref) + 1e-5 * float(ref.abs().max())
            assert bool(((out - ref).abs() <= tol).all())
        assert not torch.equal(got, tb.ordered_aggregate(
            x, t_in.replace(gather_dtype=None)))


def test_launch_plan_follows_the_kernel_source():
    """The wrapper's constants are the source's, and its launch plan
    gives the grid the kernel computes at the main path's widths."""
    import pathlib
    import re
    src = (pathlib.Path(tb.__file__).parent.parent / 'csrc' /
           'blocked.cu').read_text()
    consts = {k: int(v) for k, v in re.findall(
        r'constexpr int (\w+) = (\d+);', src)}
    assert (consts['WARPS'], consts['UNROLL'], consts['TT_MAX']) == (
        kb.WARPS, kb.UNROLL, kb.VECTORS_PER_LANE)
    plan = kb.launch_plan
    # C = 32 float32 on the 15000-node source KG: 8 lanes a row, 469
    # blocks of 256 threads.
    assert plan(15000, 32, 4) == {'vw': 4, 'lanes': 8, 'tt': 1, 'tiles': 1,
                                  'blocks': 469}
    assert plan(15000, 256, 4) == {'vw': 4, 'lanes': 32, 'tt': 2,
                                   'tiles': 1, 'blocks': 1875}
    assert plan(15000, 320, 4)['tt'] == 3
    assert plan(15000, 256, 2) == {'vw': 8, 'lanes': 32, 'tt': 1,
                                   'tiles': 1, 'blocks': 1875}
    assert plan(15000, 320, 2)['tt'] == 2
    assert plan(10, 1, 4) == {'vw': 1, 'lanes': 4, 'tt': 1, 'tiles': 1,
                              'blocks': 1}
    assert plan(10, 40, 4)['lanes'] == 16
    assert plan(10, 600, 4) == {'vw': 4, 'lanes': 32, 'tt': 4, 'tiles': 2,
                                'blocks': 2}
    assert plan(10, 256, 4, address=8)['vw'] == 2
    assert plan(10, 256, 2, address=2)['vw'] == 1


@pytest.mark.parametrize('default_sizes', [False, True])
def test_build_edge_blocks_at_the_cli_block_sizes(default_sizes):
    """The CLI's rows=128 / 512-edge blocks on a graph past min_nodes,
    through attach_blocks on both packages (a dict here, a GraphBatch
    there)."""
    a = _arrays(1, 1, 1500, 9000, 4)
    if default_sizes:
        port = tb.attach_blocks(a)
        want = jb.attach_blocks(_jgraph(a))
    else:
        port = tb.attach_blocks(a, rows=64, block_edges=100)
        want = jb.attach_blocks(_jgraph(a), rows=64, block_edges=100)
    _tables_equal(want.blocks_in, port['blocks_in'])
    _tables_equal(want.blocks_out, port['blocks_out'])


def test_inv_degree_matches_masked_bincount():
    a = _arrays(2, 2, 100, 700, 4)
    t_in, t_out = tb.build_edge_blocks(a['senders'], a['receivers'],
                                       a['edge_mask'], 100, rows=32,
                                       block_edges=64)
    for blocks, dst in ((t_in, a['receivers']), (t_out, a['senders'])):
        deg = np.zeros((2, 100))
        for b in range(2):
            np.add.at(deg[b], dst[b][a['edge_mask'][b]], 1)
        np.testing.assert_array_equal(blocks.inv_degree[..., 0].numpy(),
                                      (1.0 / np.maximum(deg, 1.0)).astype(
                                          np.float32))


def test_attach_blocks_skips_small_graphs():
    a = _arrays(3, 1, 64, 200, 4)
    assert tb.attach_blocks(a).get('blocks_in') is None
    g = GraphBatch.from_numpy(a, 'cpu')
    assert tb.attach_blocks(g).blocks_in is None
    assert tb.attach_blocks(a, min_nodes=1)['blocks_in'] is not None
    gb = tb.attach_blocks(g, min_nodes=1, gather_dtype=precision.BF16)
    assert gb.blocks_in.gather_dtype == 'bfloat16'
    assert tb.attach_blocks(gb, min_nodes=1) is gb   # attached already


@pytest.mark.parametrize('hub', [False, True])
def test_adj_matmul_forward_and_gradient_match_jax(hub):
    a = _arrays(4, 2, 200, 1300, 8, hub=hub)
    args = (a['senders'], a['receivers'], a['edge_mask'], 200)
    j_in, j_out = jb.build_edge_blocks(*args, rows=32, block_edges=64)
    t_in, t_out = tb.build_edge_blocks(*args, rows=32, block_edges=64)
    w = np.random.RandomState(5).randn(2, 200, 8).astype(np.float32)
    want = np.asarray(jb.adj_matmul(jnp.asarray(a['x']), j_in, j_out))
    want_g = np.asarray(jax.grad(lambda h: (jb.adj_matmul(
        h, j_in, j_out) * w).sum())(jnp.asarray(a['x'])))
    h = torch.from_numpy(a['x']).requires_grad_()
    got = tb.adj_matmul(h, t_in, t_out)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(),
                               _dense_reference(a, a['x']), rtol=1e-5,
                               atol=1e-5)
    # d/dh of sum(out * w) aggregates w along the transposed adjacency.
    np.testing.assert_allclose(h.grad.numpy(),
                               _dense_reference(a, w, transpose=True),
                               rtol=1e-5, atol=1e-5)


def test_adj_matmul_bf16_rows_and_backward_cast_match_jax():
    """gather_dtype bf16 at C = 256: the forward reads bf16 rows, and the
    backward casts its float32 d_out to bf16 before it sums, as JAX's
    does (rtol 1e-5: the same bf16 terms summed in float32 in another
    order). Without that cast the gradient moves by bf16 rounding (more
    than 1e-3 of its largest entry here)."""
    a = _arrays(12, 1, 150, 800, 256)
    args = (a['senders'], a['receivers'], a['edge_mask'], 150)
    j_in, j_out = (b.replace(gather_dtype='bfloat16') for b in
                   jb.build_edge_blocks(*args, rows=32, block_edges=64))
    t_in, t_out = (b.replace(gather_dtype='bfloat16') for b in
                   tb.build_edge_blocks(*args, rows=32, block_edges=64))
    w = np.random.RandomState(13).randn(1, 150, 256).astype(np.float32)
    want = np.asarray(jb.adj_matmul(jnp.asarray(a['x']), j_in, j_out))
    want_g = np.asarray(jax.grad(lambda h: (jb.adj_matmul(
        h, j_in, j_out) * w).sum())(jnp.asarray(a['x'])))
    h = torch.from_numpy(a['x']).requires_grad_()
    got = tb.adj_matmul(h, t_in, t_out)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    uncast = tb.plain_aggregate(torch.from_numpy(w),
                                t_out.replace(gather_dtype=None))
    assert float((uncast - h.grad).abs().max()) > 1e-3 * float(
        uncast.abs().max())


@pytest.mark.parametrize('dtype,C,gather,want', [
    (torch.float32, 256, None, torch.float32),
    (torch.float32, 256, 'bfloat16', BF16),     # >= 512-byte bf16 rows
    (torch.float32, 320, 'bfloat16', BF16),     # the packed ψ₂
    (torch.float32, 255, 'bfloat16', torch.float32),
    (BF16, 32, 'bfloat16', torch.float32),      # narrow bf16: widened
    (BF16, 32, None, torch.float32),
    (BF16, 64, None, BF16),                     # 128-byte rows stay
    (torch.float64, 8, None, torch.float64),
])
def test_operand_dtype_rules_follow_jax(dtype, C, gather, want):
    assert tb.operand_dtype(dtype, C, gather) == want
    h = torch.zeros(1, 3, C, dtype=dtype)
    assert tb.operand(h, gather).dtype == want


def test_cpu_wrapper_takes_plain_version_and_records_it():
    a = _arrays(6, 1, 50, 300, 4)
    inc, _ = tb.build_edge_blocks(a['senders'], a['receivers'],
                                  a['edge_mask'], 50, rows=16,
                                  block_edges=32)
    dispatch.reset()
    out = kb.aggregate(torch.from_numpy(a['x']), inc)
    d = dispatch.decisions()['blocked']
    assert (d['path'], d['reason'], d['dtype']) == ('plain', 'device=cpu',
                                                    'float32')
    assert dispatch.launch_counts()['blocked'] == 0
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, tb.plain_aggregate(torch.from_numpy(a['x']), inc), rtol=0,
        atol=0)
    with pytest.raises(ValueError):
        kb.aggregate(torch.zeros(1, 49, 4), inc)   # tables for 50 nodes


def _rel_pair(seed, C_in, C, layers, policy, rows=32, block_edges=64,
              streams=1):
    a = _arrays(seed, 2, 160, 900, C_in)
    x = a['x']
    if streams > 1:
        x = np.random.RandomState(seed + 1).randn(
            2, 160, streams * C_in).astype(np.float32)
    gd = None if policy is None else 'bfloat16'
    jg = jb.attach_blocks(_jgraph(a), rows=rows, block_edges=block_edges,
                          min_nodes=1, gather_dtype=gd)
    tg = GraphBatch.from_numpy(tb.attach_blocks(
        a, rows=rows, block_edges=block_edges, min_nodes=1,
        gather_dtype=gd), 'cpu')
    jm = JaxRelCNN(C_in, C, layers, dtype=None if policy is None
                   else JAX_BF16)
    params = jax.device_get(jm.init(jax.random.key(seed), jnp.asarray(
        a['x']), jg)['params'])
    tm = RelCNN(C_in, C, layers, dtype=policy)
    tm.load_state_dict(relcnn_from_flax(params))
    return x, jg, tg, jm, params, tm.eval()


def _rel_both(x, jg, tg, jm, params, tm, streams=1):
    w = np.random.RandomState(11).randn(
        *jm.apply({'params': params}, jnp.asarray(x), jg,
                  streams=streams).shape).astype(np.float32)

    def jloss(p):
        out = jm.apply({'params': p}, jnp.asarray(x), jg, streams=streams)
        return (out.astype(jnp.float32) * w).sum(), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    got = tm(torch.from_numpy(x), tg, streams=streams)
    (got.float() * torch.from_numpy(w)).sum().backward()
    want_g = relcnn_from_flax(jax.device_get(want_g))
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    return (got.detach().float().numpy(),
            np.asarray(want.astype(jnp.float32)), got_g, want_g)


@pytest.mark.parametrize('streams', [1, 3])
def test_relcnn_blocked_matches_jax_blocked_f32(streams):
    x, jg, tg, jm, params, tm = _rel_pair(7, 6, 16, 3, None,
                                          streams=streams)
    got, want, got_g, want_g = _rel_both(x, jg, tg, jm, params, tm, streams)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        w = w.numpy()
        np.testing.assert_allclose(got_g[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _norm_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize('C', [256, 8])
def test_relcnn_blocked_matches_jax_blocked_bf16(C):
    """bf16 policy, gather_dtype bf16: at C = 256 the rows (and the
    backward's float32 d_out) travel in bf16; at C = 8 they are widened
    to float32."""
    x, jg, tg, jm, params, tm = _rel_pair(8, 12, C, 2, precision.BF16)
    got, want, got_g, want_g = _rel_both(x, jg, tg, jm, params, tm)
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= 2 ** -6 * np.abs(want)
                  + 1e-2 * scale)
    errs = {k: _norm_err(got_g[k].numpy(), w.numpy())
            for k, w in want_g.items()}
    assert max(errs.values()) < 2e-2, errs


def test_relcnn_blocked_with_batch_norm_matches_unblocked():
    """The blocked branch under batch norm (training mode, running
    averages updated) equals the gather/segment branch up to float32
    summation order."""
    a = _arrays(9, 2, 120, 700, 6)
    g = GraphBatch.from_numpy(a, 'cpu')
    gb = GraphBatch.from_numpy(tb.attach_blocks(a, rows=32, block_edges=64,
                                                min_nodes=1), 'cpu')
    gen = torch.Generator().manual_seed(0)
    m1 = RelCNN(6, 16, 2, batch_norm=True)
    m1.reset_parameters(gen)
    m2 = RelCNN(6, 16, 2, batch_norm=True)
    m2.load_state_dict(m1.state_dict())
    out1 = m1.train()(g.x, g)
    out2 = m2.train()(gb.x, gb)
    torch.testing.assert_close(out2, out1, rtol=1e-5, atol=1e-5)
    out1.square().sum().backward()
    out2.square().sum().backward()
    for (k, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        torch.testing.assert_close(p2.grad, p1.grad, rtol=1e-4,
                                   atol=1e-4 * float(p1.grad.abs().max()),
                                   msg=k)
    for b1, b2 in zip(m1.buffers(), m2.buffers()):
        torch.testing.assert_close(b2, b1, rtol=1e-5, atol=1e-6)


def _dgmc_pair(k, policy):
    rng = np.random.RandomState(5)
    sides = [_arrays(int(rng.randint(1 << 30)), 1, n, e, 24)
             for n, e in ((300, 1700), (400, 2100))]
    gd = None if policy is None else 'bfloat16'
    jg = [jb.attach_blocks(_jgraph(a), rows=64, block_edges=128,
                           min_nodes=1, gather_dtype=gd) for a in sides]
    tg = [GraphBatch.from_numpy(tb.attach_blocks(
        a, rows=64, block_edges=128, min_nodes=1, gather_dtype=gd), 'cpu')
        for a in sides]
    jdt = None if policy is None else JAX_BF16
    jm = JaxDGMC(JaxRelCNN(24, 48, 2, dtype=jdt),
                 JaxRelCNN(16, 16, 2, dtype=jdt), num_steps=2, k=k,
                 dtype=jdt)
    rngs = {'noise': jax.random.PRNGKey(7)}
    variables = jm.init({'params': jax.random.PRNGKey(0), **rngs}, *jg)
    params = jax.device_get(variables['params'])
    tm = DGMC(RelCNN(24, 48, 2, dtype=policy),
              RelCNN(16, 16, 2, dtype=policy), num_steps=2, k=k,
              dtype=policy)
    tm.load_state_dict(dgmc_from_flax(params))
    return jm, params, rngs, jg, tg, tm.eval()


@pytest.mark.parametrize('policy', [None, precision.BF16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('k', [-1, 10])
def test_dgmc_blocked_matches_jax_blocked(k, policy):
    """Eval-mode DGMC on blocked graphs: JAX's noise captured at ψ₂'s
    first call and injected, the correspondences compared (indices equal
    where sparse)."""
    from flax import linen as nn
    jm, params, rngs, jg, tg, tm = _dgmc_pair(k, policy)
    seen = []

    def capture(next_fun, args, kwargs, context):
        if (context.module.name == 'psi_2'
                and context.method_name == '__call__' and not seen):
            seen.append(args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        S0_j, SL_j = jm.apply({'params': params}, *jg, rngs=rngs)
    packed = np.asarray(seen[0].astype(jnp.float32))   # [B, N_s, T * R]
    r_s = torch.from_numpy(packed.reshape(1, 300, 2, 16).transpose(
        2, 0, 1, 3).copy())
    with torch.no_grad():
        S0_t, SL_t = tm(*tg, r_s=r_s)
    tol = 1e-5 if policy is None else 2e-2
    for got, want in ((S0_t, S0_j), (SL_t, SL_j)):
        w = np.asarray(want.val.astype(jnp.float32))
        np.testing.assert_allclose(got.val.float().numpy(), w,
                                   atol=tol * max(1.0, np.abs(w).max()))
        if k > 0:
            np.testing.assert_array_equal(got.idx.numpy(),
                                          np.asarray(want.idx))


def test_blocked_graph_round_trip_and_static_copy():
    """The tables travel with the batch: from_numpy, to, static_like,
    copy_from (a captured step's static input), repeat_graph; a batch
    without blocks has another signature."""
    a = tb.attach_blocks(_arrays(10, 1, 80, 400, 4), rows=16,
                         block_edges=32, min_nodes=1)
    g = GraphBatch.from_numpy(a, 'cpu')
    assert len(g.fields()) == 5 + 2 * 8
    assert torch.equal(g.blocks_in.row_src, a['blocks_in'].row_src)
    assert torch.equal(g.blocks_out.row_ptr, a['blocks_out'].row_ptr)
    s = g.static_like('cpu')
    assert s.blocks_in.meta == g.blocks_in.meta
    s.copy_from(g)
    for x, y in zip(s.fields(), g.fields()):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    with pytest.raises(ValueError, match='blocks'):
        GraphBatch.from_numpy({k: v for k, v in a.items()
                               if not k.startswith('blocks')},
                              'cpu').static_like('cpu').copy_from(g)
    r = tb.repeat_graph(g, 3)
    assert r.x.shape[0] == 3 and r.blocks_out.src.shape[0] == 3
    assert torch.equal(r.blocks_out.range_ptr[2], g.blocks_out.range_ptr[0])
    assert torch.equal(r.blocks_out.row_ptr[2], g.blocks_out.row_ptr[0])
    assert torch.equal(r.blocks_in.row_src[1], g.blocks_in.row_src[0])
    torch.testing.assert_close(
        tb.ordered_aggregate(r.x, r.blocks_in),
        tb.ordered_aggregate(g.x, g.blocks_in).repeat(3, 1, 1), rtol=0,
        atol=0)
    rd = tb.repeat_graph(a, 2)
    assert rd['blocks_in'].inv_degree.shape[0] == 2
    assert rd['blocks_in'].row_src.shape[0] == 2
    assert s.blocks_in.row_src.data_ptr() != g.blocks_in.row_src.data_ptr()

    # A compiled function reads the tables from its static buffers.
    m = RelCNN(4, 8, 2).eval()
    step = compiled(lambda model, batch: model(batch.x, batch), 'cpu')
    from dgmc_tpu_torch.train.compiled import Fixed
    with torch.no_grad():
        got = step(Fixed(m), g)
        torch.testing.assert_close(got, m(g.x, g), rtol=0, atol=0)
