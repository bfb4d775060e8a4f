"""The port's sparse consensus delta held against the JAX package's
(``dgmc_tpu.ops.pallas.sparse_consensus``) on the CPU: the Pallas kernel
in interpret mode and the unfused jnp reference, forward and every
gradient, for the widened form (``fused_candidate_delta``) and the narrow
one (``sparse_consensus_delta``), through the port's differentiable form
(plain forward, factored plain backward: the kernels' arithmetic) and
through autograd of its plain version.

Cases mirror ``tests/ops/test_sparse_consensus.py``: a source axis that
is no multiple of the TPU tile (150 rows), K = 1, B = 2 throughout, and a
shortlist in which most slots point at one target (the ``d_o_t`` sum
must add every one of them); and a hub with K = 40 > 32 (a row's
candidates span two 32-slot rounds, the hub's list many chunks).

The host-side pieces of the CUDA path are held against their
definitions here: the shortlist's int32 copies and chunk map, the
backward's launch plan, and the autograd form keeping the forward's
``u`` for its backward.

Tolerances: the delta sums R float32 products in another order, rtol and
atol 1e-5 on O(1) values. Gradients: the port's backward takes the
factored form (``u_s - u_t``, as the CUDA kernels do), whose rounding
differs from the direct form's, and sums up to hundreds of candidates per
target: each tensor within rtol 1e-4 and atol 1e-4 x its largest
|gradient|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.ops.pallas import sparse_consensus as jsc
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels import sparse_consensus as tsc
from dgmc_tpu_torch.ops.shortlist import CHUNK, Shortlist

# (B, N_s, N_t, K, R, share of slots pointing at target 3)
FUSED_CASES = {'ragged': (2, 150, 90, 5, 16, 0.0),
               'k_1': (2, 130, 40, 1, 8, 0.0),
               'duplicates': (2, 140, 50, 6, 16, 0.8),
               'hub_k40': (2, 60, 50, 40, 8, 0.5)}
NARROW_CASES = {'ragged': (2, 150, 5, 16), 'k_1': (2, 130, 1, 8)}
FLOAT_ARGS = ('o_s', 'o_t', 'w1', 'b1', 'w2', 'b2')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tensors here are small, and the suite's
    parallel workers would otherwise oversubscribe the cores (a training
    loop here ran ~40x slower with 8 threads per worker under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(r, R):
    return [(0.3 * r.randn(R, R)).astype(np.float32),
            (0.1 * r.randn(R)).astype(np.float32),
            (0.3 * r.randn(R, 1)).astype(np.float32),
            (0.1 * r.randn(1)).astype(np.float32)]


def _fused_case(name):
    B, N_s, N_t, K, R, dup = FUSED_CASES[name]
    r = np.random.RandomState(sum(FUSED_CASES[name][:5]))
    o_s = r.randn(B, N_s, R).astype(np.float32)
    o_t = r.randn(B, N_t, R).astype(np.float32)
    idx = r.randint(0, N_t, (B, N_s, K))
    idx[r.rand(B, N_s, K) < dup] = 3
    return [o_s, o_t, *_weights(r, R)], idx


def _jax_grads(fn, floats, *static):
    def loss(*a):
        out = fn(*a, *static)
        return jnp.sum(jnp.sin(out)), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(floats))), has_aux=True))(
            *map(jnp.asarray, floats))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, floats, *static):
    ts = [torch.from_numpy(a).requires_grad_() for a in floats]
    out = fn(*ts, *static)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_close(got, want, names):
    (out, grads), (w_out, w_grads) = got, want
    np.testing.assert_allclose(out, w_out, rtol=1e-5, atol=1e-5)
    for g, w, name in zip(grads, w_grads, names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def _fused_torch(impl, floats, idx):
    fn = {'fused': tsc.fused_candidate_delta,
          'plain': tsc.plain_fused_candidate_delta,
          'factored': tsc.plain_sparse_consensus_fwd}[impl]
    idx = torch.from_numpy(idx)

    def call(o_s, o_t, w1, b1, w2, b2):
        return fn(o_s, o_t, idx, w1, b1, w2, b2)
    return _torch_grads(call, floats)


@functools.lru_cache(maxsize=None)
def _jax_fused(name):
    """JAX's forward and gradients of one case: the Pallas kernel in
    interpret mode, then the jnp reference."""
    floats, idx = _fused_case(name)
    jidx = jnp.asarray(idx.astype(np.int32))

    def kernel(o_s, o_t, w1, b1, w2, b2):
        return jsc.fused_candidate_delta(o_s, o_t, jidx, w1, b1, w2, b2,
                                         True)

    def reference(o_s, o_t, w1, b1, w2, b2):
        return jsc.fused_candidate_delta_reference(o_s, o_t, jidx, w1, b1,
                                                   w2, b2)

    return [_jax_grads(fn, floats) for fn in (kernel, reference)]


@pytest.mark.parametrize('impl', ['fused', 'plain', 'factored'])
@pytest.mark.parametrize('name', sorted(FUSED_CASES))
def test_fused_candidate_delta_matches_jax(name, impl):
    floats, idx = _fused_case(name)
    got = _fused_torch(impl, floats, idx)
    for want in _jax_fused(name):
        _assert_close(got, want, FLOAT_ARGS)


def _narrow_case(name):
    B, N_s, K, R = NARROW_CASES[name]
    r = np.random.RandomState(B + N_s + K + R)
    return [r.randn(B, N_s, R).astype(np.float32),
            r.randn(B, N_s, K, R).astype(np.float32), *_weights(r, R)]


@functools.lru_cache(maxsize=None)
def _jax_narrow(name):
    floats = _narrow_case(name)
    return [_jax_grads(jsc.sparse_consensus_delta, floats, True),
            _jax_grads(jsc.sparse_consensus_delta_reference, floats)]


@pytest.mark.parametrize('impl', ['narrow', 'plain'])
@pytest.mark.parametrize('name', sorted(NARROW_CASES))
def test_sparse_consensus_delta_matches_jax(name, impl):
    fn = {'narrow': tsc.sparse_consensus_delta,
          'plain': tsc.plain_sparse_consensus_delta}[impl]
    got = _torch_grads(fn, _narrow_case(name))
    for want in _jax_narrow(name):
        _assert_close(got, want, ('o_s', 'cand', 'w1', 'b1', 'w2', 'b2'))


def test_wrappers_take_the_plain_versions_on_cpu():
    floats, idx = _fused_case('duplicates')
    o_s, o_t, w1, b1, w2, b2 = map(torch.from_numpy, floats)
    sl = Shortlist(torch.from_numpy(idx), o_t.shape[1])
    dispatch.reset()
    out = tsc.sparse_consensus_fwd(o_s, o_t, sl, w1, b1, w2, b2)
    g = torch.ones_like(out)
    grads = tsc.sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g)
    d = dispatch.decisions()
    for name in ('sparse_consensus_fwd', 'sparse_consensus_bwd'):
        assert (d[name]['path'], d[name]['reason']) == ('plain', 'device=cpu')
    assert dispatch.launch_counts()['sparse_consensus_fwd'] == 0
    assert dispatch.launch_counts()['sparse_consensus_bwd'] == 0
    assert torch.equal(out, tsc.plain_sparse_consensus_fwd(
        o_s, o_t, sl, w1, b1, w2, b2))
    assert [tuple(x.shape) for x in grads] == [tuple(a.shape)
                                              for a in (o_s, o_t, w1, b1,
                                                        w2, b2)]


@pytest.mark.parametrize('name', sorted(FUSED_CASES))
def test_cpu_backward_is_the_gradient_of_its_own_forward(name):
    """On the CPU both wrappers take the factored form, so the backward
    is the gradient of the forward they computed: it equals autograd of
    :func:`plain_sparse_consensus_fwd` (up to summation order), ReLU
    mask included."""
    floats, idx = _fused_case(name)
    got = _fused_torch('fused', floats, idx)
    want = _fused_torch('factored', floats, idx)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w, n in zip(got[1], want[1], FLOAT_ARGS):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=n)


def test_wrappers_reject_mismatched_inputs():
    floats, idx = _fused_case('k_1')
    o_s, o_t, w1, b1, w2, b2 = map(torch.from_numpy, floats)
    with pytest.raises(ValueError, match='shortlist'):
        tsc.sparse_consensus_fwd(o_s, o_t[:, :-1], Shortlist(
            torch.from_numpy(idx), o_t.shape[1]), w1, b1, w2, b2)
    with pytest.raises(ValueError, match='MLP'):
        tsc.sparse_consensus_fwd(o_s, o_t, torch.from_numpy(idx), w1[:-1],
                                 b1, w2, b2)


def test_shortlist_scatter_and_gather_gradient_sum_duplicates():
    """The receiver order sums every slot of a target, duplicates
    included, as ``jax.ops.segment_sum`` does."""
    r = np.random.RandomState(5)
    idx = r.randint(0, 7, (2, 9, 4))
    idx[:, :5] = 2
    msgs = r.randn(2, 9, 4, 3).astype(np.float32)
    sl = Shortlist(torch.from_numpy(idx), 7)
    want = jax.vmap(lambda m, i: jax.ops.segment_sum(m, i, num_segments=7))(
        jnp.asarray(msgs.reshape(2, 36, 3)), jnp.asarray(idx.reshape(2, 36)))
    np.testing.assert_allclose(sl.scatter(torch.from_numpy(msgs)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    feat = torch.from_numpy(r.randn(2, 7, 3).astype(np.float32))
    feat.requires_grad_()
    sl.gather(feat).mul(torch.from_numpy(msgs)).sum().backward()
    np.testing.assert_allclose(feat.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_shortlist_chunks_cut_each_target_list():
    """The backward's target pass takes each target's slots in chunks:
    ``chunk_start`` counts ``ceil(slots / CHUNK)`` per target, within the
    host bound the kernel's grid is sized by."""
    r = np.random.RandomState(6)
    idx = r.randint(0, 30, (2, 50, 7))
    idx[:, :40, :5] = 4                          # a hub of 400 slots
    sl = Shortlist(torch.from_numpy(idx), 30)
    start, bound = sl.chunks
    deg = np.stack([np.bincount(i.ravel(), minlength=30) for i in idx])
    np.testing.assert_array_equal(np.diff(start.numpy()),
                                  -(-deg.ravel() // CHUNK))
    assert start[0] == 0 and int(start[-1]) <= bound
    assert sl.chunks[0] is start


def _shortlists():
    """Shortlists for the host-side checks: top-k-like hubs (a few
    targets in most lists), duplicates within a row, K > 32, targets no
    slot points at, and the narrow form's identity shortlist."""
    r = np.random.RandomState(9)
    hub = np.minimum(r.zipf(1.5, (2, 300, 10)) - 1, 199)
    dup = r.randint(0, 40, (1, 80, 6))
    dup[:, :, 3:] = dup[:, :, :1]
    wide = r.randint(0, 25, (2, 30, 70))
    wide[:, :20] = 7
    sparse_t = r.randint(0, 5, (1, 40, 3)) * 13
    return {'hub': Shortlist(torch.from_numpy(hub), 200),
            'duplicates': Shortlist(torch.from_numpy(dup), 40),
            'k_70': Shortlist(torch.from_numpy(wide), 25),
            'empty_targets': Shortlist(torch.from_numpy(sparse_t), 60),
            'identity': Shortlist.identity(2, 9, 4, 'cpu')}


@pytest.mark.parametrize('name', sorted(_shortlists()))
def test_shortlist_int32_copies_equal_the_int64_ones(name):
    sl = _shortlists()[name]
    assert sl.idx32.dtype == sl.order32.dtype == torch.int32
    assert sl.idx32.is_contiguous() and sl.order32.is_contiguous()
    assert torch.equal(sl.idx32.long(), sl.idx)
    assert torch.equal(sl.order32.long(), sl.order)
    assert sl.idx32 is sl.idx32 and sl.order32 is sl.order32   # made once


@pytest.mark.parametrize('name', sorted(_shortlists()))
def test_shortlist_chunk_map_matches_its_definition(name):
    """Row c of the chunk map is (target, first position in ``order``,
    slots, 0) of chunk c, chunks taken target by target and, within a
    target of d slots, L = CHUNK * max(1, ceil(ceil(sqrt(d)) / CHUNK))
    positions at a time; rows past the last chunk are (-1, 0, 0, 0).
    Every position of ``order`` lies in exactly one chunk, which points at
    that position's own target."""
    sl = _shortlists()[name]
    B, N_s, K = sl.shape
    idx = sl.idx.numpy().reshape(B, N_s * K)
    flat_t = (idx + np.arange(B)[:, None] * sl.num_targets).ravel()
    deg = np.bincount(flat_t, minlength=B * sl.num_targets)
    want, pos, per_target = [], 0, []
    for t, d in enumerate(deg):
        L = CHUNK * max(1, -(-int(np.ceil(np.sqrt(d))) // CHUNK))
        for first in range(pos, pos + d, L):
            want.append((t, first, min(L, pos + d - first), 0))
        per_target.append(-(-d // L))
        pos += d
    start, bound = sl.chunks
    want += [(-1, 0, 0, 0)] * (bound - len(want))
    got = sl.chunk_map
    assert got.dtype == torch.int32 and tuple(got.shape) == (bound, 4)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    np.testing.assert_array_equal(np.diff(start.numpy()), per_target)
    covered = np.zeros(B * N_s * K, dtype=int)
    order = sl.order.numpy()
    for t, first, n, _ in got.numpy():
        covered[first:first + n] += 1
        assert (flat_t[order[first:first + n]] == t).all()
    assert (covered == 1).all()
    assert sl.chunk_map is got


@pytest.mark.parametrize('rows_s,rows_t,R,n_chunks,cap', [
    (15000, 20000, 32, 29375, 132 * 4), (1, 1, 1, 2, 264),
    (16, 17, 33, 18, 5), (300, 90, 128, 120, 1), (66, 130, 64, 200, 1000),
    (10 ** 6, 10, 7, 31260, 792)])
def test_bwd_plan_covers_every_row_within_the_cap(rows_s, rows_t, R,
                                                  n_chunks, cap):
    """Source and chunk blocks: BWD_WARPS items a block at a time, the
    source blocks at most three quarters of ``cap`` (one wave), the chunk
    blocks at most the rest, each at least one; the warps' strided walks
    cover every source row and every chunk once. Node blocks: ceil(rows /
    node_rows(R)) for each side, where a block's 256 threads own 4 rows x
    4 channels each."""
    src, chunk, nodes = tsc.bwd_plan(rows_s, rows_t, R, n_chunks, cap)
    W = tsc.BWD_WARPS
    assert src == max(1, min(-(-rows_s // W), 3 * cap // 4))
    assert chunk == max(1, min(-(-n_chunks // W), cap - src))
    for blocks, items in ((src, rows_s), (chunk, n_chunks)):
        walked = sorted(r for b in range(blocks) for w in range(W)
                        for r in range(b * W + w, items, blocks * W))
        assert walked == list(range(items))
    br = tsc.node_rows(R)
    assert (br // 4) * -(-R // 4) <= tsc.NODE_THREADS < (br // 4 + 1) * -(
        -R // 4)
    assert nodes == -(-rows_s // br) + -(-rows_t // br)


def test_autograd_form_keeps_u_only_for_a_gradient():
    """The forward keeps its u_s and u_t for the backward when a gradient
    is asked for, and nothing when none is; the backward from the kept u
    equals the backward that recomputes it."""
    floats, idx = _fused_case('hub_k40')
    ts = [torch.from_numpy(a).requires_grad_() for a in floats]
    sl = Shortlist(torch.from_numpy(idx), floats[1].shape[1])
    out = tsc.fused_candidate_delta(ts[0], ts[1], sl, *ts[2:])
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7
    u_s, u_t = saved[5:]
    np.testing.assert_array_equal(u_s.numpy(), (ts[0] @ ts[2] + ts[3])
                                  .detach().numpy())
    np.testing.assert_array_equal(u_t.numpy(), (ts[1] @ ts[2]).detach()
                                  .numpy())
    g = torch.from_numpy(np.random.RandomState(4).randn(*out.shape)
                         .astype(np.float32))
    got = torch.autograd.grad(out, ts, g)
    want = tsc.sparse_consensus_bwd(ts[0], ts[1], sl, *ts[2:5], g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    frozen = [torch.from_numpy(a) for a in floats]
    assert tsc.fused_candidate_delta(frozen[0], frozen[1], sl,
                                     *frozen[2:]).grad_fn is None
    with torch.no_grad():
        assert tsc.fused_candidate_delta(ts[0], ts[1], sl,
                                         *ts[2:]).grad_fn is None


def test_wrappers_hand_the_forwards_state_to_the_backward():
    """``return_state`` gives the forward's node rows (on the CPU, no
    mask); the backward given them equals the one that forms them
    itself, and refuses a state of other shapes."""
    floats, idx = _fused_case('duplicates')
    o_s, o_t, w1, b1, w2, b2 = map(torch.from_numpy, floats)
    sl = Shortlist(torch.from_numpy(idx), o_t.shape[1])
    out, u = tsc.sparse_consensus_fwd(o_s, o_t, sl, w1, b1, w2, b2,
                                      return_state=True)
    assert len(u) == 2
    assert torch.equal(out, tsc.sparse_consensus_fwd(o_s, o_t, sl, w1, b1,
                                                     w2, b2))
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape)
                         .astype(np.float32))
    for a, b in zip(tsc.sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g, u),
                    tsc.sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='state must be'):
        tsc.sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g, u[::-1])


@pytest.mark.parametrize('candidates,target_rows,touched', [
    (16 * 10, 20000, True), (64 * 10, 20000, True),
    (15000 * 10, 20000, False), (15000 * 20, 20000, False),
    (20000, 20000, False), (1, 7, True), (1, 1, False)])
def test_projection_rule_forms_only_touched_rows_when_fewer(
        candidates, target_rows, touched):
    """The CUDA forward forms u_t per candidate where there are fewer
    candidates than target rows (a query's shortlist over the corpus),
    else every target row once; the reason names the side taken."""
    got, reason = tsc.projection(candidates, target_rows)
    assert got is touched
    assert reason.startswith('touched rows' if touched else 'all rows')
    assert f'{candidates} candidates' in reason


def test_cpu_forward_takes_the_plain_version_whatever_the_projection():
    """On the CPU the projection rule does not apply: over as many target
    rows as the shortlist has candidates (the rule's all-rows side) and
    over more (its touched-rows side, o_t padded with rows nothing points
    at), the forward is the plain factored form with the full u_t state,
    and the dispatch is recorded as plain."""
    floats, idx = _fused_case('duplicates')
    o_s, o_t, w1, b1, w2, b2 = map(torch.from_numpy, floats)
    B, N_s, K = idx.shape
    for N_t in (o_t.shape[1], N_s * K + 1):
        assert tsc.projection(B * N_s * K, B * N_t)[0] is (N_t > N_s * K)
        wide = torch.cat([o_t, torch.ones(B, N_t - o_t.shape[1],
                                          o_t.shape[2])], 1)
        sl = Shortlist(torch.from_numpy(idx), N_t)
        out, state = tsc.sparse_consensus_fwd(o_s, wide, sl, w1, b1, w2, b2,
                                              return_state=True)
        assert torch.equal(out, tsc.plain_sparse_consensus_fwd(
            o_s, wide, sl, w1, b1, w2, b2))
        assert torch.equal(state[0], o_s @ w1 + b1)
        assert torch.equal(state[1], wide @ w1)
        d = dispatch.decisions()['sparse_consensus_fwd']
        assert (d['path'], d['reason']) == ('plain', 'device=cpu')
