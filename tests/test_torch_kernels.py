"""The port's CUDA kernels against their plain versions on the card.

Imports torch and the port only (no JAX), so it also runs on a machine
with a GPU and no JAX, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device every test here skips. Tolerance: bit-equal,
since every input is integer-valued or dyadic (each product and partial
sum is exact in float32, and the divisions by the degree are correctly
rounded on both sides).
"""

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.consensus import (R_MAX, consensus_fwd,
                                                  plain_consensus)
from dgmc_tpu_torch.ops.kernels.spline import (Routing, build_records,
                                               plain_edge_records,
                                               plain_route_aggregate,
                                               plain_route_d_t,
                                               plain_slot_records, route_d_t,
                                               route_fwd)
from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
    plain_fused_candidate_delta, plain_sparse_consensus_bwd,
    plain_sparse_consensus_fwd, sparse_consensus_bwd, sparse_consensus_fwd)
from dgmc_tpu_torch.ops.kernels.topk import (K_MAX, TC_C_MAX, TC_K_MAX,
                                             plain_topk, route,
                                             streaming_topk)
from dgmc_tpu_torch.ops.shortlist import Shortlist

# (B, N_s, N_t, C, k, masked share): ties, tile boundaries, segments,
# k above the valid targets and k at the kernel's limit; then each row
# tile (16, 32, 64, 128 rows) with the segment merge against 20000
# targets, k at the limit through the merge, and channel counts that are
# no multiple of 4 (4-byte staging).
CASES = [(2, 300, 700, 8, 7, 0.3), (1, 64, 64, 8, 3, None),
         (1, 65, 65, 8, 3, None), (1, 16, 5000, 32, 10, 0.5),
         (1, 40, 20, 4, 9, 0.8), (1, 200, 3000, 32, K_MAX, 0.9),
         (1, 1, 20000, 32, 10, None), (1, 16, 20000, 32, 10, None),
         (1, 17, 20000, 32, 10, 0.5), (1, 33, 20000, 32, 10, None),
         (1, 64, 20000, 32, 10, 0.3), (1, 16, 20000, 8, K_MAX, None),
         (2, 50, 300, 3, 5, 0.2), (1, 130, 2000, 7, 10, None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_topk_kernel_matches_plain(cuda, case):
    B, N_s, N_t, C, k, masked = case
    rng = np.random.RandomState(N_s + N_t)
    h_s = torch.from_numpy(rng.randint(-2, 3, (B, N_s, C)).astype(
        np.float32)).to(cuda)
    h_t = torch.from_numpy(rng.randint(-2, 3, (B, N_t, C)).astype(
        np.float32)).to(cuda)
    mask = (None if masked is None
            else torch.from_numpy(rng.rand(B, N_t) > masked).to(cuda))
    before = streaming_topk.launches
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    assert streaming_topk.launches == before + 1
    assert dispatch.decisions()['topk']['path'] == 'kernel'
    pv, pi = plain_topk(h_s, h_t, k, mask)
    assert torch.equal(i, pi) and torch.equal(v, pv)


@pytest.mark.cuda
@pytest.mark.parametrize('n_s', [1, 16, 64])
def test_topk_kernel_k_above_valid_targets_across_segments(cuda, n_s):
    """Only 5 of 20000 targets valid, k = 10: each segment's list and the
    merge must put the masked targets (finfo.min) after the valid ones,
    lowest index first."""
    rng = np.random.RandomState(n_s)
    h_s = torch.from_numpy(rng.randint(-2, 3, (1, n_s, 32)).astype(
        np.float32)).to(cuda)
    h_t = torch.from_numpy(rng.randint(-2, 3, (1, 20000, 32)).astype(
        np.float32)).to(cuda)
    mask = torch.zeros(1, 20000, dtype=torch.bool, device=cuda)
    mask[0, [3, 777, 5000, 12345, 19999]] = True
    v, i = streaming_topk(h_s, h_t, 10, mask)
    pv, pi = plain_topk(h_s, h_t, 10, mask)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    assert (v[..., 5:] == torch.finfo(torch.float32).min).all()


@pytest.mark.cuda
def test_topk_kernel_rejects_other_dtypes(cuda):
    h = torch.zeros(1, 8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        streaming_topk(h, h, 2)


@pytest.mark.cuda
def test_topk_above_k_max_is_a_recorded_plain_dispatch(cuda):
    h_s = torch.ones(1, 4, 4, device=cuda)
    h_t = torch.ones(1, K_MAX + 5, 4, device=cuda)
    before = streaming_topk.launches
    _, idx = streaming_topk(h_s, h_t, K_MAX + 1)
    d = dispatch.decisions()['topk']
    assert (d['path'], d['reason']) == ('plain', f'k>{K_MAX}')
    assert streaming_topk.launches == before
    assert torch.equal(idx[0, 0].cpu(), torch.arange(K_MAX + 1,
                                                     dtype=torch.int32))


# (B, N, E, O, masked share): an all-masked batch, M = N * 25 not a
# multiple of any tile, B = 1, no edges, and the training path's widths.
SPLINE_CASES = [(2, 11, 40, 16, 1.01), (3, 13, 50, 33, 0.2),
                (1, 24, 80, 64, 0.2), (2, 6, 0, 8, 0.0),
                (4, 80, 640, 256, 0.3)]


def _spline_case(cuda, B, N, E, O, masked):
    """Small-integer t, dyadic basis (quarters), and g an integer multiple
    of each node's degree, so that g / deg is exact: exact sums."""
    rng = np.random.RandomState(B * 1000 + N + E + O)
    A, M = 4, N * 25
    t = torch.from_numpy(rng.randint(-3, 4, (B, M, O)).astype(np.float32))
    basis = torch.from_numpy(rng.randint(0, 5, (B, E, A)).astype(
        np.float32) / 4)
    flat = torch.from_numpy(rng.randint(0, M, (B, E, A)))
    rcv = torch.from_numpy(rng.randint(0, N, (B, E)))
    mask = torch.from_numpy(rng.rand(B, E) > masked)
    deg = torch.zeros(B, N).scatter_add_(1, rcv, mask.float())
    g = torch.from_numpy(rng.randint(-3, 4, (B, N, O)).astype(
        np.float32)) * deg.clamp(min=1)[..., None]
    routing = Routing(flat.to(cuda), rcv.to(cuda), mask.to(cuda), N, M)
    return t.to(cuda), g.to(cuda), basis.to(cuda), routing


@pytest.mark.cuda
@pytest.mark.parametrize('case', SPLINE_CASES)
def test_spline_kernels_match_plain(cuda, case):
    t, g, basis, routing = _spline_case(cuda, *case)
    before = (route_fwd.launches, route_d_t.launches)
    out = route_fwd(t, basis, routing)
    d_t = route_d_t(g, basis, routing)
    torch.cuda.synchronize()
    assert (route_fwd.launches, route_d_t.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert dispatch.decisions()['spline_route_fwd']['path'] == 'kernel'
    assert torch.equal(out, plain_route_aggregate(t, basis, routing))
    assert torch.equal(d_t, plain_route_d_t(g, basis, routing))
    assert torch.equal(out, route_fwd(t, basis, routing))
    assert torch.equal(d_t, route_d_t(g, basis, routing))


@pytest.mark.cuda
@pytest.mark.parametrize('O', [64, 256])
@pytest.mark.parametrize('hub', [0.0, 0.3])
def test_route_d_t_kernel_with_empty_rows_and_a_hub(cuda, O, hub):
    """The training path's widths at B = 4, 80 nodes, 640 edges: most
    rows of d_t have no slot; with ``hub`` 0.3 of the slots point at one
    row per graph (~770 slots, more than a warp stages)."""
    t, g, basis, routing = _spline_case(cuda, 4, 80, 640, O, 0.3)
    if hub:
        rng = np.random.RandomState(O)
        flat = routing.flat.clone()
        flat[torch.from_numpy(rng.rand(*flat.shape) < hub).to(cuda)] = 7
        routing = Routing(flat, routing.receivers, routing.edge_mask, 80,
                          routing.num_rows)
    _, offsets = routing.slot_records(basis)
    counts = offsets[1:] - offsets[:-1]
    assert (counts == 0).any()
    if hub:
        assert int(counts.max()) > 128
    before = route_d_t.launches
    d_t = route_d_t(g, basis, routing)
    torch.cuda.synchronize()
    assert route_d_t.launches == before + 1
    assert torch.equal(d_t, plain_route_d_t(g, basis, routing))
    assert torch.equal(d_t, route_d_t(g, basis, routing))


@pytest.mark.cuda
@pytest.mark.parametrize('case', SPLINE_CASES)
def test_slot_records_kernel_matches_plain(cuda, case):
    _, _, basis, routing = _spline_case(cuda, *case)
    got = build_records(routing, basis)[2:]
    torch.cuda.synchronize()
    want = plain_slot_records(routing, basis)
    assert all(a.dtype == torch.int32 for a in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize('case', SPLINE_CASES)
def test_edge_records_kernel_matches_plain(cuda, case):
    """The edge records come from the launch that builds the slot records
    (one launch a build)."""
    _, _, basis, routing = _spline_case(cuda, *case)
    before = build_records.launches
    got = build_records(routing, basis)[:2]
    torch.cuda.synchronize()
    assert build_records.launches == before + 1
    want = plain_edge_records(routing, basis)
    assert all(a.dtype == torch.int32 for a in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize('O', [3, 64, 256])
@pytest.mark.parametrize('hub', [0.0, 0.3])
def test_route_fwd_kernel_with_empty_rows_and_a_hub_receiver(cuda, O, hub):
    """B = 4, 80 nodes, 640 edges, 30% of them masked: receivers drawn from
    the first 60 nodes leave 20 rows of each graph without an edge; with
    ``hub`` 0.3 of the edges point at node 7 (~770 slots, more than a
    warp stages). O = 3 takes the 4-byte path, O = 64 two rows a warp,
    O = 256 two vectors a lane. The records are built once and serve
    every call."""
    t, _, basis, routing = _spline_case(cuda, 4, 80, 640, O, 0.3)
    rng = np.random.RandomState(O)
    rcv = torch.from_numpy(rng.randint(0, 60, (4, 640)))
    if hub:
        rcv[torch.from_numpy(rng.rand(4, 640) < hub)] = 7
    routing = Routing(routing.flat, rcv.to(cuda), routing.edge_mask, 80,
                      routing.num_rows)
    _, offsets = routing.edge_records(basis)
    counts = (offsets[1:] - offsets[:-1])[:4 * 80]
    assert (counts == 0).sum() >= 4 * 20
    if hub:
        assert int(counts.max()) > 256
    before = (route_fwd.launches, build_records.launches)
    out = route_fwd(t, basis, routing)
    torch.cuda.synchronize()
    assert (route_fwd.launches, build_records.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(out, plain_route_aggregate(t, basis, routing))
    assert not out.reshape(4 * 80, O)[counts == 0].any()
    assert torch.equal(out, route_fwd(t, basis, routing))


# (B, N_s, N_t, R): the training path's shape; then each of one pair,
# ragged 20 x 37, 80 x 80 and 33 x 65 at R in {1, 8, 33, 64, R_MAX}
# (ragged tiles of the launch plan, R below, at and across the 32-channel
# steps of the projection).
CONSENSUS_CASES = [(64, 80, 80, 64)] + [
    (2, n_s, n_t, R) for n_s, n_t in ((1, 1), (20, 37), (80, 80), (33, 65))
    for R in (1, 8, 33, 64, R_MAX)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', CONSENSUS_CASES)
def test_consensus_kernel_matches_plain(cuda, case):
    B, N_s, N_t, R = case
    rng = np.random.RandomState(N_s + N_t + R)

    def ints(*shape, lo=-2, hi=3):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(
            np.float32)).to(cuda)

    args = (ints(B, N_s, R), ints(B, N_t, R), ints(R, R), ints(R),
            ints(R, 1), ints(1))
    before = consensus_fwd.launches
    out = consensus_fwd(*args)
    torch.cuda.synchronize()
    assert consensus_fwd.launches == before + 1
    assert dispatch.decisions()['consensus_fwd']['path'] == 'kernel'
    assert torch.equal(out, plain_consensus(*args))
    assert torch.equal(out, consensus_fwd(*args))


@pytest.mark.cuda
def test_consensus_kernel_rejects_r_above_limit(cuda):
    R = R_MAX + 1
    z = torch.zeros
    with pytest.raises(ValueError):
        consensus_fwd(z(1, 2, R, device=cuda), z(1, 2, R, device=cuda),
                      z(R, R, device=cuda), z(R, device=cuda),
                      z(R, 1, device=cuda), z(1, device=cuda))


# (B, N_s, N_t, K, R, share of slots pointing at one target): ragged rows,
# the duplicate-heavy shortlist, one row, K = 1, the kernels' R limit.
SC_CASES = [(2, 300, 90, 20, 32, 0.0), (2, 200, 50, 6, 16, 0.9),
            (1, 1, 1, 1, 1, 0.0), (2, 70, 30, 1, 8, 0.0),
            (2, 33, 65, 7, 128, 0.3)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', SC_CASES)
def test_sparse_consensus_kernels_match_plain(cuda, case):
    B, N_s, N_t, K, R, dup = case
    rng = np.random.RandomState(N_s + N_t + K + R)

    def ints(*shape):
        return torch.from_numpy(rng.randint(-2, 3, shape).astype(
            np.float32)).to(cuda)

    idx = rng.randint(0, N_t, (B, N_s, K))
    idx[rng.rand(B, N_s, K) < dup] = N_t // 2
    sl = Shortlist(torch.from_numpy(idx).to(cuda), N_t)
    args = (ints(B, N_s, R), ints(B, N_t, R), ints(R, R), ints(R),
            ints(R, 1), ints(1))
    g = ints(B, N_s, K)
    before = (sparse_consensus_fwd.launches, sparse_consensus_bwd.launches)
    out, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                      return_state=True)
    grads = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
    torch.cuda.synchronize()
    assert (sparse_consensus_fwd.launches,
            sparse_consensus_bwd.launches) == (before[0] + 1, before[1] + 1)
    for plain in (plain_fused_candidate_delta, plain_sparse_consensus_fwd):
        assert torch.equal(out, plain(args[0], args[1], sl, *args[2:]))
    assert torch.equal(out, sparse_consensus_fwd(args[0], args[1], sl,
                                                 *args[2:]))
    want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
    again = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    with pytest.raises(ValueError, match='forward\'s state'):
        sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)


def _sc_exact(cuda, rng, B, N_s, N_t, R, K):
    def ints(*shape):
        return torch.from_numpy(rng.randint(-2, 3, shape).astype(
            np.float32)).to(cuda)
    return ((ints(B, N_s, R), ints(B, N_t, R), ints(R, R), ints(R),
             ints(R, 1), ints(1)), ints(B, N_s, K))


def _sc_shortlist(name, rng, B, N_s, N_t, K):
    """Top-k-like hubs (Zipf: a few targets in most lists, most targets
    in none), duplicates within rows, K > 32, and the narrow form's
    identity shortlist."""
    if name == 'identity':
        return Shortlist.identity(B, N_s, K, 'cuda')
    if name == 'hub':
        idx = np.minimum(rng.zipf(1.3, (B, N_s, K)) - 1, N_t - 1)
    else:
        idx = rng.randint(0, N_t, (B, N_s, K))
    if name == 'duplicates':
        idx[:, :, K // 2:] = idx[:, :, :1]
    return Shortlist(torch.from_numpy(idx).cuda(), N_t)


# name -> (B, N_s, N_t, K, R): hubs of thousands of slots (many chunks a
# target), duplicates, K across one and two 32-slot rounds, R across the
# 32-channel steps, and the identity shortlist (N_t = N_s * K).
SC_SHORTLISTS = {'hub': (1, 3000, 4000, 20, 32),
                 'hub_r_max': (2, 400, 300, 10, 128),
                 'duplicates': (2, 500, 200, 12, 33),
                 'k_40': (2, 300, 500, 40, 64),
                 'k_70': (1, 200, 90, 70, 8),
                 'identity': (2, 150, 150 * 6, 6, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(SC_SHORTLISTS))
def test_sparse_consensus_backward_on_hard_shortlists(cuda, name):
    B, N_s, N_t, K, R = SC_SHORTLISTS[name]
    rng = np.random.RandomState(sum(SC_SHORTLISTS[name]))
    sl = _sc_shortlist(name.split('_r_')[0], rng, B, N_s, N_t, K)
    args, g = _sc_exact(cuda, rng, B, N_s, N_t, R, K)
    _, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                    return_state=True)
    grads = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
    torch.cuda.synchronize()
    want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
    for got, w in zip(grads, want):
        assert got.shape == w.shape and torch.equal(got, w)
    again = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['hub', 'k_40'])
def test_sparse_consensus_backward_reuses_the_forwards_u(cuda, name):
    """The autograd form hands the forward's u_s, u_t and ReLU mask to
    the backward kernel, which runs no projection: on exact inputs the
    saved u equals the plain projection and the gradients equal the plain
    backward, which forms u itself; on float32 inputs they equal the
    kernels called directly, the backward given the forward's state."""
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        fused_candidate_delta)
    B, N_s, N_t, K, R = SC_SHORTLISTS[name]
    rng = np.random.RandomState(K + R)
    sl = _sc_shortlist(name, rng, B, N_s, N_t, K)
    for exact in (True, False):
        args, g = _sc_exact(cuda, rng, B, N_s, N_t, R, K)
        if not exact:
            args = tuple(torch.randn_like(a) for a in args)
            g = torch.randn_like(g)
        ts = [a.clone().requires_grad_() for a in args]
        before = (sparse_consensus_fwd.launches,
                  sparse_consensus_bwd.launches)
        out = fused_candidate_delta(ts[0], ts[1], sl, *ts[2:])
        u_s, u_t, _ = out.grad_fn.saved_tensors[5:]
        got = torch.autograd.grad(out, ts, g)
        torch.cuda.synchronize()
        assert (sparse_consensus_fwd.launches,
                sparse_consensus_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
        if exact:
            assert torch.equal(u_s, args[0] @ args[2] + args[3])
            assert torch.equal(u_t, args[1] @ args[2])
            want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
        else:
            _, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                            return_state=True)
            want = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _plain_mask(args, sl):
    """The ReLU mask as the forward writes it, from the plain factored
    form (for bf16 inputs rounded as the kernels round: u, then pre):
    bit l of word c of a candidate is ``pre > 0`` in channel ``l + 32 c``,
    ``[B*N_s*K, ceil(R/32)]`` int32."""
    o_s, o_t, w1, b1 = (a.float() for a in args[:4])
    dt = args[0].dtype

    def rnd(x):
        return x.to(dt).float()
    R = o_s.shape[2]
    nc = -(-R // 32)
    pre = rnd(rnd(rnd(o_s @ w1) + b1)[:, :, None, :]
              - sl.gather(rnd(o_t @ w1)))
    bits = torch.zeros(pre.numel() // R, 32 * nc, dtype=torch.int64,
                       device=pre.device)
    bits[:, :R] = (pre.reshape(-1, R) > 0).long()
    words = (bits.reshape(-1, nc, 32) << torch.arange(
        32, device=pre.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def _widen(args, sl, N_t):
    """The same problem over ``N_t`` target rows: ``o_t`` padded with
    rows that no candidate points at, so that only the projection rule's
    side changes."""
    pad = N_t - args[1].shape[1]
    o_t = torch.cat([args[1], args[1][:, :1].expand(-1, pad, -1) + 1], 1)
    return (args[0], o_t, *args[2:]), Shortlist(sl.idx, N_t)


@pytest.mark.cuda
@pytest.mark.parametrize('touched', [False, True])
@pytest.mark.parametrize('K', [1, 10, 20, 33])
@pytest.mark.parametrize('R', [7, 20, 32, 33, 64, 128])
def test_sparse_consensus_forward_matches_plain_at_every_layout(cuda, R, K,
                                                                touched):
    """Every lane layout of the forward (16-byte vectors over 2 to 32
    lanes at R = 20, 32, 64 and 128; scalar channels at R = 7 and 33,
    one and two per lane), K within one round, across rounds and past one
    32-candidate window, and both ways of forming u_t, each at a shape on
    its side of the projection rule (40 source rows a graph over 20 K
    target rows, or over 5000): the delta, the ReLU mask and the state
    the backward takes, bit-equal to the plain versions on exact inputs,
    and the backward from that state equal to the plain backward."""
    B, N_s = 2, 40
    N_t = 5000 if touched else 20 * K
    rng = np.random.RandomState(R * 100 + K)
    sl = Shortlist(torch.from_numpy(rng.randint(0, N_t, (B, N_s, K))).to(
        cuda), N_t)
    args, g = _sc_exact(cuda, rng, B, N_s, N_t, R, K)
    out, (u_s, u_t, mask) = sparse_consensus_fwd(
        args[0], args[1], sl, *args[2:], return_state=True)
    torch.cuda.synchronize()
    reason = dispatch.decisions()['sparse_consensus_fwd']['reason']
    assert reason.startswith('auto-cuda, ' + ('touched rows' if touched
                                              else 'all rows'))
    assert torch.equal(out, plain_sparse_consensus_fwd(args[0], args[1], sl,
                                                       *args[2:]))
    assert torch.equal(mask, _plain_mask(args, sl))
    assert torch.equal(u_s, args[0] @ args[2] + args[3])
    want_t = args[1] @ args[2]
    if touched:   # only the rows the shortlist points at; zeros elsewhere
        hit = torch.zeros(B, N_t, dtype=torch.bool, device=cuda)
        hit.scatter_(1, sl.flat, True)
        want_t = torch.where(hit[..., None], want_t, 0.0)
    assert torch.equal(u_t, want_t)
    assert torch.equal(out, sparse_consensus_fwd(args[0], args[1], sl,
                                                 *args[2:]))
    grads = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g,
                                 (u_s, u_t, mask))
    want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('R', [20, 32, 33, 128])
def test_sparse_consensus_forward_projections_agree_to_the_bit(cuda, R):
    """On float32 inputs the two ways of forming u_t sum in one order. At
    the rule's edge (as many candidates as target rows) one more target
    row that nothing points at turns the rule: delta, mask and u_s are
    bit-identical either side, and u_t at every touched row."""
    rng = np.random.RandomState(R)
    B, N_s, K = 2, 60, 12
    N_t = N_s * K
    sl = Shortlist(torch.from_numpy(rng.randint(0, N_t, (B, N_s, K))).to(
        cuda), N_t)
    args = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
            for shape in ((B, N_s, R), (B, N_t, R), (R, R), (R,), (R, 1),
                          (1,))]
    a = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                             return_state=True)
    assert 'all rows' in dispatch.decisions()[
        'sparse_consensus_fwd']['reason']
    wide, wide_sl = _widen(args, sl, N_t + 1)
    b = sparse_consensus_fwd(wide[0], wide[1], wide_sl, *wide[2:],
                             return_state=True)
    assert 'touched rows' in dispatch.decisions()[
        'sparse_consensus_fwd']['reason']
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[1][2], b[1][2])
    hit = torch.zeros(B, N_t, dtype=torch.bool, device=cuda)
    hit.scatter_(1, sl.flat, True)
    assert torch.equal(a[1][1][hit], b[1][1][:, :N_t][hit])
    torch.testing.assert_close(a[0], plain_sparse_consensus_fwd(
        args[0], args[1], sl, *args[2:]), rtol=1e-5,
        atol=1e-5 * float(a[0].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [16, 32, 64])
def test_sparse_consensus_forward_at_the_serve_shapes(cuda, n):
    """A query's rows (16, 32, 64) x K = 10 over the 20000-row corpus,
    R = 32: the rule forms u_t of the touched rows only, bit-equal to the
    plain version; on float32 inputs within rtol 1e-5 / atol 1e-5 x
    max|out| of it, and a repeat bit-identical."""
    rng = np.random.RandomState(n)
    N_t, K, R = 20000, 10, 32
    sl = Shortlist(torch.from_numpy(rng.randint(0, N_t, (1, n, K))).to(
        cuda), N_t)
    args, _ = _sc_exact(cuda, rng, 1, n, N_t, R, K)
    out = sparse_consensus_fwd(args[0], args[1], sl, *args[2:])
    assert 'touched rows' in dispatch.decisions()[
        'sparse_consensus_fwd']['reason']
    assert torch.equal(out, plain_sparse_consensus_fwd(args[0], args[1], sl,
                                                       *args[2:]))
    floats = [torch.randn_like(a) for a in args]
    got = sparse_consensus_fwd(floats[0], floats[1], sl, *floats[2:])
    torch.testing.assert_close(got, plain_sparse_consensus_fwd(
        floats[0], floats[1], sl, *floats[2:]), rtol=1e-5,
        atol=1e-5 * float(got.abs().max()))
    assert torch.equal(got, sparse_consensus_fwd(floats[0], floats[1], sl,
                                                 *floats[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(SC_SHORTLISTS))
def test_sparse_consensus_backward_from_the_touched_rows_state(cuda, name):
    """The hard shortlists of the backward's tests over more target rows
    than candidates (o_t padded with rows nothing points at), so that the
    forward forms u_t of the touched rows only: its state gives the plain
    backward."""
    B, N_s, N_t, K, R = SC_SHORTLISTS[name]
    rng = np.random.RandomState(sum(SC_SHORTLISTS[name]) + 1)
    sl = _sc_shortlist(name.split('_r_')[0], rng, B, N_s, N_t, K)
    args, g = _sc_exact(cuda, rng, B, N_s, N_t, R, K)
    args, sl = _widen(args, sl, max(N_t, N_s * K + 1))
    out, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                      return_state=True)
    assert 'touched rows' in dispatch.decisions()[
        'sparse_consensus_fwd']['reason']
    assert torch.equal(out, plain_sparse_consensus_fwd(args[0], args[1], sl,
                                                       *args[2:]))
    assert torch.equal(state[2], _plain_mask(args, sl))
    grads = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
    want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


# -- bf16 variants (the precision policy's): each kernel against its plain
# bf16 version, bit-equal on the same exact inputs (small integers and
# quarters are exact in bf16; every product and sum stays exact in
# float32, so both sides round the same values at the same points).

BF16 = torch.bfloat16

# C = 256, the KG training width, and C = 200: several 64-channel chunks
# of the tensor-core tile, the last one partial (and, with k = K_MAX,
# several channel slots of the bf16 FMA kernel's ring).
BF16_WIDE_CASES = [(1, 300, 2000, 256, 10, 0.3),
                   (1, 17, 20000, 256, 10, None),
                   (2, 130, 1100, 256, K_MAX, 0.5),
                   (1, 64, 5000, 200, 10, None)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES + BF16_WIDE_CASES)
def test_topk_kernel_bf16_matches_plain(cuda, case):
    B, N_s, N_t, C, k, masked = case
    rng = np.random.RandomState(N_s + N_t + 1)
    h_s = torch.from_numpy(rng.randint(-3, 4, (B, N_s, C))).to(cuda, BF16)
    h_t = torch.from_numpy(rng.randint(-3, 4, (B, N_t, C))).to(cuda, BF16)
    mask = (None if masked is None
            else torch.from_numpy(rng.rand(B, N_t) > masked).to(cuda))
    before = streaming_topk.launches
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    assert streaming_topk.launches == before + 1 and v.dtype == BF16
    d = dispatch.decisions()['topk']
    assert (d['path'], d['dtype']) == ('kernel', 'bfloat16')
    assert d['reason'] == route(BF16, B, N_s, N_t, C, k)[1]
    pv, pi = plain_topk(h_s, h_t, k, mask)
    assert torch.equal(i, pi) and torch.equal(v, pv)


# (B, N_s, N_t, C, k, masked share or a mask's name, the route's reason):
# the tensor-core tile's edges (rows no multiple of 64 or 128, targets no
# multiple of a tile, a ragged last k16 slice at C = 200 and 264, k = 1
# and its carry's limit, whole masked blocks, k above the valid targets,
# B = 2), then a shape past each of its limits, which the FMA kernel
# takes with the reason recorded.
TC_EDGE_CASES = [(1, 200, 1024, 64, 10, None, 'tensor-core'),
                 (1, 128, 1000, 64, 10, 0.3, 'tensor-core'),
                 (1, 300, 1000, 200, 10, 0.3, 'tensor-core'),
                 (1, 257, 700, 264, 10, None, 'tensor-core'),
                 (1, 200, 3000, 64, 1, None, 'tensor-core'),
                 (2, 130, 1100, 256, TC_K_MAX, 0.5, 'tensor-core'),
                 (2, 300, 1000, 64, 10, 'blocks', 'tensor-core'),
                 (1, 40, 20, 8, 9, 'five_valid', 'tensor-core'),
                 (1, 17, 20000, 32, 10, 0.5, 'tensor-core'),
                 (1, 64, 700, 12, 10, None, 'fma, C%8!=0'),
                 (1, 64, 700, 64, TC_K_MAX + 1, None, 'fma, k>16'),
                 (1, 64, 700, TC_C_MAX + 8, 10, None, 'fma, C>640')]


@pytest.mark.cuda
@pytest.mark.parametrize('case', TC_EDGE_CASES)
def test_topk_bf16_route_edges_match_plain(cuda, case):
    B, N_s, N_t, C, k, masked, reason = case
    rng = np.random.RandomState(N_s + N_t + C)
    h_s = torch.from_numpy(rng.randint(-3, 4, (B, N_s, C))).to(cuda, BF16)
    h_t = torch.from_numpy(rng.randint(-3, 4, (B, N_t, C))).to(cuda, BF16)
    if masked == 'blocks':           # batch 0 all masked, 2 tiles of 1
        mask = torch.ones(B, N_t, dtype=torch.bool, device=cuda)
        mask[0] = False
        mask[1, 128:384] = False
    elif masked == 'five_valid':
        mask = (torch.arange(N_t, device=cuda) < 5).expand(B, N_t)
    else:
        mask = (None if masked is None
                else torch.from_numpy(rng.rand(B, N_t) > masked).to(cuda))
    before = streaming_topk.launches
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    assert streaming_topk.launches == before + 1
    d = dispatch.decisions()['topk']
    assert (d['path'], d['dtype'], d['reason']) == ('kernel', 'bfloat16',
                                                    reason)
    pv, pi = plain_topk(h_s, h_t, k, mask)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    v2, i2 = streaming_topk(h_s, h_t, k, mask)
    assert torch.equal(i2, i) and torch.equal(v2, v)    # repeats


@pytest.mark.cuda
def test_topk_bf16_tc_reads_a_view_at_an_odd_offset(cuda):
    """TMA wants 16-byte aligned rows: a view one row into its storage
    (C = 8: 16 bytes a row) is aligned, one element in is not and is
    copied first; both give the plain version's answer."""
    rng = np.random.RandomState(3)
    base = torch.from_numpy(rng.randint(-3, 4, (1, 401, 8))).to(cuda, BF16)
    h_t = torch.from_numpy(rng.randint(-3, 4, (1, 300, 8))).to(cuda, BF16)
    for h_s in (base[:, 1:], base.flatten()[1:3201].view(1, 400, 8)):
        v, i = streaming_topk(h_s, h_t, 10)
        assert dispatch.decisions()['topk']['reason'] == 'tensor-core'
        pv, pi = plain_topk(h_s, h_t, 10)
        assert torch.equal(i, pi) and torch.equal(v, pv)


@pytest.mark.cuda
@pytest.mark.parametrize('case', SPLINE_CASES)
def test_spline_kernels_bf16_match_plain(cuda, case):
    t, g, basis, routing = _spline_case(cuda, *case)
    t, g = t.to(BF16), g.to(BF16)
    before = (route_fwd.launches, route_d_t.launches)
    out, d_t = route_fwd(t, basis, routing), route_d_t(g, basis, routing)
    torch.cuda.synchronize()
    assert (route_fwd.launches, route_d_t.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert out.dtype == d_t.dtype == BF16
    assert dispatch.decisions()['spline_route_bwd']['dtype'] == 'bfloat16'
    assert torch.equal(out, plain_route_aggregate(t, basis, routing))
    assert torch.equal(d_t, plain_route_d_t(g, basis, routing))
    assert torch.equal(out, route_fwd(t, basis, routing))


@pytest.mark.cuda
@pytest.mark.parametrize('case', CONSENSUS_CASES)
def test_consensus_kernel_bf16_matches_plain(cuda, case):
    B, N_s, N_t, R = case
    rng = np.random.RandomState(N_s + N_t + R + 1)

    def ints(*shape, lo=-2, hi=3):
        return torch.from_numpy(rng.randint(lo, hi, shape)).to(cuda, BF16)

    args = (ints(B, N_s, R), ints(B, N_t, R), ints(R, R), ints(R),
            ints(R, 1), ints(1))
    before = consensus_fwd.launches
    out = consensus_fwd(*args)
    torch.cuda.synchronize()
    assert consensus_fwd.launches == before + 1
    assert out.dtype == torch.float32
    assert dispatch.decisions()['consensus_fwd']['dtype'] == 'bfloat16'
    assert torch.equal(out, plain_consensus(*args))
    assert torch.equal(out, consensus_fwd(*args))


def _sc_bf16(args, g):
    return tuple(a.to(BF16) for a in args), g


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(SC_SHORTLISTS))
def test_sparse_consensus_kernels_bf16_match_plain(cuda, name):
    """Forward (with the ReLU mask of the rounded pre-activations) and
    backward on the hard shortlists; the touched-row form is float32
    only, so bf16 projects every row even where candidates are fewer."""
    B, N_s, N_t, K, R = SC_SHORTLISTS[name]
    rng = np.random.RandomState(sum(SC_SHORTLISTS[name]) + 2)
    sl = _sc_shortlist(name.split('_r_')[0], rng, B, N_s, N_t, K)
    args, g = _sc_bf16(*_sc_exact(cuda, rng, B, N_s, N_t, R, K))
    for widen in (False, True):
        if widen:
            args, sl = _widen(args, sl, max(N_t, N_s * K + 1))
        before = (sparse_consensus_fwd.launches,
                  sparse_consensus_bwd.launches)
        out, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                          return_state=True)
        grads = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        torch.cuda.synchronize()
        assert (sparse_consensus_fwd.launches,
                sparse_consensus_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
        d = dispatch.decisions()['sparse_consensus_fwd']
        assert d['dtype'] == 'bfloat16' and 'all rows' in d['reason']
        assert out.dtype == torch.float32 and state[0].dtype == BF16
        assert torch.equal(out, plain_sparse_consensus_fwd(
            args[0], args[1], sl, *args[2:]))
        assert torch.equal(state[2], _plain_mask(args, sl))
        want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
        for got, w in zip(grads, want):
            assert got.dtype == BF16 and torch.equal(got, w)
        again = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_bf16_kernels_accumulate_f32(cuda):
    """2048 cotangents of 0.5 onto one target row: exactly -1024 through
    the sparse and the dense consensus kernels' autograd forms (a bf16
    running sum would stall at -256)."""
    from dgmc_tpu_torch.ops.kernels.consensus import consensus_update
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        fused_candidate_delta)
    N_s, R = 2048, 8
    idx = torch.zeros((1, N_s, 1), dtype=torch.int64, device=cuda)
    for fn in (lambda *a: fused_candidate_delta(a[0], a[1], idx, *a[2:]),
               consensus_update):
        o_t = torch.zeros((1, 4, R), dtype=BF16, device=cuda,
                          requires_grad=True)
        out = fn(torch.zeros((1, N_s, R), dtype=BF16, device=cuda), o_t,
                 torch.eye(R, dtype=BF16, device=cuda),
                 torch.ones(R, dtype=BF16, device=cuda),
                 torch.ones((R, 1), dtype=BF16, device=cuda),
                 torch.zeros(1, dtype=BF16, device=cuda))
        (0.5 * out.sum()).backward()
        want = torch.full_like(o_t, -1024.0)
        if out.shape[-1] == 1:   # sparse: every candidate on target 0
            want[0, 1:] = 0
        assert o_t.grad.dtype == BF16 and torch.equal(o_t.grad, want)


@pytest.mark.cuda
def test_kernels_refuse_half_and_mixed_dtypes(cuda):
    """float32 or bfloat16, every float operand in one dtype: float16 and
    a mix raise (no fallback)."""
    def z(*shape, dtype=torch.float16):
        return torch.zeros(shape, dtype=dtype, device=cuda)
    R = 8
    sl = Shortlist(torch.zeros((1, 4, 2), dtype=torch.int64, device=cuda), 4)
    basis = torch.ones(1, 3, 4, device=cuda)
    routing = Routing(torch.zeros((1, 3, 4), dtype=torch.int64, device=cuda),
                      torch.zeros((1, 3), dtype=torch.int64, device=cuda),
                      torch.ones((1, 3), dtype=torch.bool, device=cuda),
                      2, 50)
    for dt in (torch.float16, None):
        def f(*shape):
            return z(*shape, dtype=dt or BF16)
        last = z(1, dtype=torch.float16) if dt is None else f(1)
        with pytest.raises(TypeError):
            streaming_topk(f(1, 4, R), z(1, 6, R, dtype=dt or torch.float32),
                           2)
        with pytest.raises(TypeError):
            route_fwd(z(1, 50, R, dtype=dt or torch.float64), basis, routing)
        with pytest.raises(TypeError):
            consensus_fwd(f(1, 4, R), f(1, 4, R), f(R, R), f(R), f(R, 1),
                          last)
        with pytest.raises(TypeError):
            sparse_consensus_fwd(f(1, 4, R), f(1, 4, R), sl, f(R, R), f(R),
                                 f(R, 1), last)


def _blocked_case(rng, B, N, E, hub):
    from dgmc_tpu_torch.ops.blocked import build_edge_blocks
    snd = rng.randint(0, N, (B, E))
    rcv = rng.randint(0, N, (B, E))
    if hub:
        rcv[0, :E // 2] = 3
    return build_edge_blocks(snd, rcv, rng.rand(B, E) > 0.1, N)


@pytest.mark.cuda
@pytest.mark.parametrize('C', [1, 32, 40, 256, 320])
@pytest.mark.parametrize('rows', ['float32', 'bfloat16'])
def test_blocked_kernel_matches_plain(cuda, C, rows):
    """The blocked aggregation on integer-valued rows (every sum exact):
    bit-equal to the plain version, a hub's range of many blocks beside a
    batch element with fewer (padded) blocks, both directions; a repeat
    bit-identical; one launch a call."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    rng = np.random.RandomState(C)
    gd = None if rows == 'float32' else 'bfloat16'
    dt = getattr(torch, rows)
    for blocks in _blocked_case(rng, 2, 700, 9000, hub=True):
        blk = blocks.map(lambda t: t.to(cuda)).replace(gather_dtype=gd)
        h = torch.from_numpy(rng.randint(-4, 5, (2, 700, C))).to(
            cuda, dt)
        before = kb.aggregate.launches
        got = kb.aggregate(h, blk)
        assert kb.aggregate.launches == before + 1
        assert got.dtype == torch.float32
        assert torch.equal(got, ob.plain_aggregate(h, blk))
        assert torch.equal(got, kb.aggregate(h, blk))


@pytest.mark.cuda
@pytest.mark.parametrize('C', [1, 32, 40, 256, 320])
@pytest.mark.parametrize('rows', ['float32', 'bfloat16'])
def test_blocked_kernel_matches_ordered_aggregate(cuda, C, rows):
    """The kernel bit-identical to ordered_aggregate (its order and
    rounding, in torch) on random rows: a hub batch beside a padded
    element and an edgeless graph, both directions, the rows also as a
    view at an odd element offset (narrower loads)."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.blocked import build_edge_blocks
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    rng = np.random.RandomState(100 + C)
    gd = None if rows == 'float32' else 'bfloat16'
    dt = getattr(torch, rows)
    snd = rng.randint(0, 700, (1, 3000))
    edgeless = build_edge_blocks(snd, snd, np.zeros((1, 3000), bool), 700)
    for blocks in (*_blocked_case(rng, 2, 700, 9000, hub=True), *edgeless):
        blk = blocks.map(lambda t: t.to(cuda)).replace(gather_dtype=gd)
        B = blk.src.shape[0]
        flat = torch.from_numpy(rng.randn(B * 700 * C + 1)).to(cuda, dt)
        for h in (flat[:-1].view(B, 700, C), flat[1:].view(B, 700, C)):
            got = kb.aggregate(h, blk)
            assert torch.equal(got, ob.ordered_aggregate(h, blk))
            assert torch.equal(got, kb.aggregate(h, blk))


@pytest.mark.cuda
def test_blocked_adj_matmul_gradient_on_the_card(cuda):
    """adj_matmul's backward is the kernel over the transposed tables:
    bit-equal to the plain version's on integer cotangents."""
    from dgmc_tpu_torch.ops import blocked as ob
    rng = np.random.RandomState(1)
    inc, outg = (b.map(lambda t: t.to(cuda)) for b in
                 _blocked_case(rng, 1, 500, 4000, hub=False))
    h = torch.from_numpy(rng.randint(-3, 4, (1, 500, 64))).to(
        cuda, torch.float32).requires_grad_()
    g = torch.from_numpy(rng.randint(-3, 4, (1, 500, 64))).to(
        cuda, torch.float32)
    ob.adj_matmul(h, inc, outg).backward(g)
    assert torch.equal(h.grad, ob.plain_aggregate(g, outg))


@pytest.mark.cuda
@pytest.mark.parametrize('C', [32, 256])
@pytest.mark.parametrize('rows', ['float32', 'bfloat16'])
@pytest.mark.parametrize('parts', [2, 3])
def test_blocked_kernel_on_a_row_block(cuda, C, rows, parts):
    """A rank's row block (ψ₁ row-restricted): the kernel's output rows
    ``[lo, hi)`` of the whole table (a row-pointer slice whose first
    offset is not 0; 700 rows in blocks padded to ``parts`` ranks, not
    aligned to the tables' 128-row ranges) and the transposed sum over
    the entries the block's rows send, each bit-identical to
    ordered_aggregate over the same tables; the forward rows equal the
    whole call's rows; one launch a call."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    from dgmc_tpu_torch.parallel.topk import row_block
    rng = np.random.RandomState(7 + C + parts)
    gd = None if rows == 'float32' else 'bfloat16'
    dt = getattr(torch, rows)
    for blocks in _blocked_case(rng, 2, 700, 9000, hub=True):
        blk = blocks.map(lambda t: t.to(cuda)).replace(gather_dtype=gd)
        h = torch.from_numpy(rng.randn(2, 700, C)).to(cuda, dt)
        whole = kb.aggregate(h, blk)
        for me in range(parts):
            lo, hi, _ = row_block(700, parts, me)
            before = kb.aggregate.launches
            got = kb.aggregate(h, blk, rows=(lo, hi))
            assert kb.aggregate.launches == before + 1
            assert torch.equal(got, ob.ordered_aggregate(
                h, ob.row_slice(blk, lo, hi)))
            n = min(hi, 700) - lo
            assert torch.equal(got[:, :n], whole[:, lo:lo + n])
            assert not got[:, n:].any()
            d = torch.from_numpy(rng.randn(2, hi - lo, C)).to(cuda, dt)
            back = kb.aggregate(d, blk, rows=(lo, hi), sources=True)
            assert torch.equal(back, ob.ordered_aggregate(
                d, ob.owned_rows(blk, lo, hi)))


def _route_case(rng, cuda, B=2, N_s=400, K=6, n_t=900):
    """A route over a shortlist with a duplicate in every third row and a
    hub target (node 3 in most of element 0's rows), on the card."""
    from dgmc_tpu_torch.ops.corr_route import build_corr_route
    idx = rng.randint(0, n_t, (B, N_s, K))
    idx[:, ::3, -1] = idx[:, ::3, 0]
    idx[0, 50:] = 3
    return build_corr_route(torch.from_numpy(idx).to(cuda), n_t, rows=64,
                            block_entries=128)


@pytest.mark.cuda
@pytest.mark.parametrize('C', [1, 32, 40, 64])
@pytest.mark.parametrize('rows', ['float32', 'bfloat16'])
def test_routed_kernel_matches_plain_and_ordered(cuda, C, rows):
    """The blocked kernel's routed entry (csrc/blocked.cu,
    dgmc_blocked_route): the scaled projection and the gather's backward
    bit-equal to the plain version on integer rows and quarter scales,
    bit-identical to the scaled ordered_aggregate on random ones (bf16
    rows at C = 64 read as bf16, the product rounded to bf16); one launch
    a call; a repeat bit-identical."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    rng = np.random.RandomState(200 + C)
    route = _route_case(rng, cuda)
    dt = getattr(torch, rows)
    S = torch.from_numpy(rng.randint(-8, 9, (2, 400, 6)) / 4).to(
        cuda, torch.float32)
    for which, M in (('src', 400), ('ent', 2400)):
        for x in (torch.from_numpy(rng.randint(-4, 5, (2, M, C))),
                  torch.from_numpy(rng.randn(2, M, C))):
            x = x.to(cuda, dt)
            rows_dt = ob.operand(x, None).dtype
            if which == 'src':
                before = kb.route_project.launches
                got = kb.route_project(x, S, route)
                assert kb.route_project.launches == before + 1
                plain = route.plain_sum(x, 'src', route.block_scale(S))
                want = ob.ordered_aggregate(x, route.table('src'),
                                            route.row_scale(S, rows_dt))
                again = kb.route_project(x, S, route)
            else:
                before = kb.route_gather_bwd.launches
                got = kb.route_gather_bwd(x, route)
                assert kb.route_gather_bwd.launches == before + 1
                plain = route.plain_sum(x, 'ent')
                want = ob.ordered_aggregate(x, route.table('ent'))
                again = kb.route_gather_bwd(x, route)
            assert got.shape == (2, 900, C) and got.dtype == torch.float32
            assert torch.equal(got, want) and torch.equal(got, again)
            if bool((x == x.round()).all()):   # every sum exact
                assert torch.equal(got, plain)


@pytest.mark.cuda
def test_routed_sparse_project_and_gather_gradients_on_the_card(cuda):
    """sparse_project and sparse_gather on the card against the CPU's plain
    path, values and gradients, rtol 1e-5 / atol 1e-5 x max|out|."""
    from dgmc_tpu_torch.ops.corr_route import (build_corr_route,
                                               sparse_gather, sparse_project)
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, 900, (2, 400, 6)))
    S = torch.from_numpy(rng.randn(2, 400, 6).astype(np.float32))
    r_s = torch.from_numpy(rng.randn(2, 400, 32).astype(np.float32))
    feat = torch.from_numpy(rng.randn(2, 900, 32).astype(np.float32))
    outs = {}
    for dev in ('cpu', cuda):
        route = build_corr_route(idx.to(dev), 900)
        a = S.to(dev).requires_grad_()
        b = r_s.to(dev).requires_grad_()
        f = feat.to(dev).requires_grad_()
        out = sparse_project(a, b, idx.to(dev), route)
        cand = sparse_gather(f, idx.to(dev), route)
        (out.sin().sum() + cand.cos().sum()).backward()
        outs[str(dev)] = [t.detach().cpu() for t in (out, cand, a.grad,
                                                       b.grad, f.grad)]
    for got, want in zip(outs[str(cuda)], outs['cpu']):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_streamed_and_offloaded_topk_match_the_device_search(cuda, dtype):
    """streamed_topk, offloaded_streamed_topk and offloaded_corpus_topk
    on the card: indices and values bit-identical to one chunked_topk,
    ties (duplicated targets) and a mask included, ragged chunks."""
    from dgmc_tpu_torch.ops.offload import (offloaded_corpus_topk,
                                            offloaded_streamed_topk)
    from dgmc_tpu_torch.ops.topk import chunked_topk, streamed_topk
    rng = np.random.RandomState(2)
    base = rng.randn(1, 1000, 64).astype(np.float32)
    h_t = torch.from_numpy(np.concatenate([base, base], 1)).to(cuda, dtype)
    h_s = torch.from_numpy(rng.randn(1, 3001, 64)).to(cuda, dtype)
    mask = torch.from_numpy(rng.rand(1, 2000) > 0.2).to(cuda)
    v, i = chunked_topk(h_s, h_t, 10, mask, return_values=True)
    for chunk in (1000, 777):
        sv, si = streamed_topk(h_s, h_t, 10, chunk, mask,
                               return_values=True)
        assert torch.equal(si, i) and torch.equal(sv, v)
    ov, oi, stats = offloaded_streamed_topk(h_s.cpu(), h_t, 10, 777, mask,
                                            depth=2, device=cuda)
    assert torch.equal(oi, i.cpu()) and torch.equal(ov, v.cpu())
    assert stats.chunks == 4 and stats.ring_misses == 1
    cv, ci, stats = offloaded_corpus_topk(h_s, h_t.cpu(), 10, 300, mask,
                                          depth=3, device=cuda)
    assert torch.equal(ci, i.cpu()) and torch.equal(cv, v.cpu())
    assert stats.chunks == 7 and stats.ring_misses == 1
