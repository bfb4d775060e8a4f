"""Blocked adjacency: edge→node aggregation from dst-sorted, range-aligned
tables.

The JAX package's answer to the cost of message passing's gathers and
segment reductions at DBP15K size (``dgmc_tpu/ops/blocked.py``), ported
with its tables bit for bit:

1. Host (:func:`build_edge_blocks`, numpy, once per graph): sort the
   real edges by destination (stable); cut them into blocks of at most
   ``block_edges`` edges whose destinations lie inside one aligned range
   of ``rows`` nodes (a hub's range simply gets several blocks); within a
   block, order the edges by source (stable). ``inv_degree`` is the
   reciprocal in-degree (1 where there is none): mean aggregation is a
   static scale.
2. Device (:func:`adj_matmul`): ``out[b, n] = Σ_{e: dst_e = n}
   h[b, src_e]``. On the card the hand-written kernel
   (:mod:`~dgmc_tpu_torch.ops.kernels.blocked`, ``csrc/blocked.cu``)
   reads the row table below: one warp (or, at narrow widths, a group of
   lanes) per output row sums the row's sources in the table's order, in
   float32, deterministically (no atomics). On the CPU the plain version
   (:func:`plain_aggregate`) is JAX's ``_routed``: the flattened row
   gather, the ``[E_b, rows]`` one-hot contraction and the
   ``[num_ranges, NB]`` combine. :func:`ordered_aggregate` is torch over
   the row table, rounding as the kernel does (the tests' and the card
   check's reference for bit equality; on no main path).
3. Backward: the gradient of ``h`` is the same aggregation over the
   transposed tables (incoming ↔ outgoing), so it is the same kernel.

Dtype rules (JAX's ``_routed``, which change numbers): the output is
``promote(h, float32)``; with ``gather_dtype`` (``'bfloat16'``, the bf16
policy's) rows are cast to it only where they stay at least 512 bytes
wide (``C * 2 >= 512``: ψ₁'s C = 256, the packed ψ₂'s C = 320, and the
backward's float32 ``d_out`` at those widths); low-precision rows
narrower than 128 bytes are widened to float32 (exact).

Beside JAX's tables each :class:`EdgeBlocks` carries, built on the host
with the rest: ``range_ptr``, the first block of each range; and the row
table the kernel reads, a CSR over destination rows (``row_ptr``,
``row_src``) whose order within a row is the blocks' own: the range's
blocks in order, each block's slots in order. ``UnionPair`` /
``batch_pair`` are not ported: nothing in the JAX package's CLIs enables
them.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['EdgeBlocks', 'build_edge_blocks', 'operand_dtype', 'operand',
           'plain_aggregate', 'ordered_aggregate',
           'adj_matmul', 'repeat_graph', 'attach_blocks']

_TENSORS = ('src', 'dst_local', 'mask', 'range_id', 'inv_degree',
            'range_ptr', 'row_ptr', 'row_src')


@dataclasses.dataclass(frozen=True)
class EdgeBlocks:
    """One direction of blocked adjacency: dst-sorted, range-aligned.

    Per batch element: ``src [B, NB, E_b]`` int32 source node of each
    blocked edge; ``dst_local [B, NB, E_b]`` int32 its destination's offset
    within the block's range; ``mask [B, NB, E_b]`` bool edge validity;
    ``range_id [B, NB]`` int32 the block's range; ``inv_degree [B, N, 1]``
    float32 reciprocal destination in-degree (1 where empty);
    ``range_ptr [B, num_ranges + 1]`` int32: range ``r``'s blocks are
    ``range_ptr[r]:range_ptr[r + 1]`` (blocks past the last pointer pad
    the batch). The row table: ``row_ptr [B, N + 1]`` int32 and
    ``row_src [B, E_max]`` int32, node ``n``'s sources
    ``row_src[row_ptr[n]:row_ptr[n + 1]]`` in the blocks' order (the
    range's blocks in order, each block's slots in order; ``E_max`` the
    batch's most real edges, at least 1, zeros past them). ``rows`` and
    ``num_ranges`` are ints; ``gather_dtype`` the name of the dtype rows
    travel in (``None``: as they are).
    """
    src: torch.Tensor
    dst_local: torch.Tensor
    mask: torch.Tensor
    range_id: torch.Tensor
    inv_degree: torch.Tensor
    range_ptr: torch.Tensor
    row_ptr: torch.Tensor
    row_src: torch.Tensor
    rows: int
    num_ranges: int
    gather_dtype: Optional[str] = None

    def tensors(self):
        """The tables, in a fixed order."""
        return [getattr(self, f) for f in _TENSORS]

    def map(self, fn):
        """These blocks with ``fn`` applied to every table."""
        return dataclasses.replace(
            self, **{f: fn(getattr(self, f)) for f in _TENSORS})

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @property
    def meta(self):
        """What a captured step's signature takes from the blocks beside
        the tables' shapes."""
        return (self.rows, self.num_ranges, self.gather_dtype)


def _build_one(src, dst, mask, num_nodes, rows, block_edges):
    """Block one graph's edge list (numpy, on the host): JAX's
    ``_build_one`` plus the range pointers and the row table."""
    src = np.asarray(src)[mask]
    dst = np.asarray(dst)[mask]
    order = np.argsort(dst, kind='stable')
    src, dst = src[order], dst[order]
    num_ranges = -(-num_nodes // rows)

    blocks = []  # (range_id, src_chunk, dst_local_chunk)
    rid_of = dst // rows
    start = 0
    e = len(dst)
    while start < e:
        rid = rid_of[start]
        run_end = start + np.searchsorted(rid_of[start:], rid + 1)
        end = min(start + block_edges, run_end)
        o = np.argsort(src[start:end], kind='stable')
        blocks.append((rid, src[start:end][o],
                       (dst[start:end] - rid * rows)[o]))
        start = end
    if not blocks:
        blocks.append((0, np.zeros(0, np.int32), np.zeros(0, np.int32)))

    nb = len(blocks)
    b_src = np.zeros((nb, block_edges), np.int32)
    b_loc = np.zeros((nb, block_edges), np.int32)
    b_msk = np.zeros((nb, block_edges), bool)
    b_rid = np.zeros((nb,), np.int32)
    for i, (rid, s, l) in enumerate(blocks):
        n = len(s)
        b_src[i, :n] = s
        b_loc[i, :n] = l
        b_msk[i, :n] = True
        b_rid[i] = rid

    deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)
    inv_deg = (1.0 / np.maximum(deg, 1.0))[:, None]
    ptr = np.searchsorted(b_rid, np.arange(num_ranges + 1),
                          side='left').astype(np.int32)
    # The row table: the real slots, blocks in order and slots in order,
    # stable-sorted by destination node.
    slot_dst = (b_rid[:, None] * rows + b_loc)[b_msk]
    row_src = b_src[b_msk][np.argsort(slot_dst, kind='stable')]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        slot_dst, minlength=num_nodes))]).astype(np.int32)
    return (b_src, b_loc, b_msk, b_rid, inv_deg, ptr, num_ranges, row_ptr,
            row_src)


def _numpy(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_edge_blocks(senders, receivers, edge_mask, num_nodes, rows=128,
                      block_edges=512):
    """Host-side blocking of a batched edge list, both directions.

    ``senders`` / ``receivers`` / ``edge_mask`` are ``[B, E]`` arrays (or
    CPU tensors). Returns ``(incoming, outgoing)`` :class:`EdgeBlocks` of
    CPU tensors: ``incoming`` aggregates messages to each edge's receiver
    (dst = receiver, src = sender), ``outgoing`` the reverse; each is the
    other's backward. Batch elements are padded to one block count."""
    senders, receivers = _numpy(senders), _numpy(receivers)
    edge_mask = _numpy(edge_mask).astype(bool)
    out = []
    for dst, src in ((receivers, senders), (senders, receivers)):
        per = [_build_one(src[b], dst[b], edge_mask[b], num_nodes, rows,
                          block_edges) for b in range(dst.shape[0])]
        nb = max(p[0].shape[0] for p in per)
        e_max = max(1, max(p[8].shape[0] for p in per))

        def pad(a, n=nb):
            return np.pad(a, ((0, n - a.shape[0]),) + ((0, 0),) *
                          (a.ndim - 1))

        def stack(i, n=nb):
            return torch.from_numpy(np.stack([pad(p[i], n) for p in per]))

        out.append(EdgeBlocks(
            src=stack(0), dst_local=stack(1), mask=stack(2),
            range_id=stack(3),
            inv_degree=torch.from_numpy(np.stack([p[4] for p in per])),
            range_ptr=torch.from_numpy(np.stack([p[5] for p in per])),
            row_ptr=torch.from_numpy(np.stack([p[7] for p in per])),
            row_src=stack(8, e_max), rows=rows, num_ranges=per[0][6]))
    return out[0], out[1]


def operand_dtype(dtype, C, gather_dtype):
    """The dtype of the rows the aggregation reads, under JAX's rules:
    ``gather_dtype`` where its rows stay >= 512 bytes (``C * 2 >= 512``),
    else float32 for low-precision rows narrower than 128 bytes, else
    ``dtype``."""
    if gather_dtype is not None and C * 2 >= 512:
        return getattr(torch, gather_dtype)
    if (dtype.is_floating_point and dtype.itemsize < 4
            and dtype.itemsize * C < 128):
        return torch.float32
    return dtype


def operand(h, gather_dtype):
    """``h`` as the aggregation reads it (:func:`operand_dtype`)."""
    return h.to(operand_dtype(h.dtype, h.shape[-1], gather_dtype))


def _aggregate_work(h, blocks):
    from dgmc_tpu_torch.ops.kernels.blocked import call_work
    return call_work(h, blocks)


def _adj_work(h, fwd_blocks, bwd_blocks):
    """The aggregation's work forward and, over the transposed tables,
    backward."""
    return dict(_aggregate_work(h, fwd_blocks),
                bwd=_aggregate_work(h, bwd_blocks))


@dispatch.counted('plain_aggregate', _aggregate_work)
def plain_aggregate(h, blocks):
    """The plain version: JAX's ``_routed`` — ``out[b, n] = Σ_{e: dst=n}
    h[b, src_e]`` as the flattened row gather, the one-hot contraction
    ``[B, NB, E_b, rows] x [B, NB, E_b, C] -> [B, NB, rows, C]`` and the
    range combine, accumulated in ``promote(h, float32)``, which is also
    the output's dtype. ``h [B, M, C]`` → ``[B, M, C]``."""
    B, M, C = h.shape
    acc = torch.promote_types(h.dtype, torch.float32)
    h = operand(h, blocks.gather_dtype)
    dev = h.device
    src = blocks.src.to(dev, torch.int64)
    gidx = src + (torch.arange(B, device=dev) * M)[:, None, None]
    g = h.reshape(B * M, C)[gidx.reshape(-1)].reshape(*src.shape, C)
    onehot = ((blocks.dst_local.to(dev)[..., None]
               == torch.arange(blocks.rows, device=dev))
              & blocks.mask.to(dev)[..., None])
    per_block = torch.einsum('aber,abec->abrc', onehot.to(acc), g.to(acc))
    combine = (blocks.range_id.to(dev)[:, None, :]
               == torch.arange(blocks.num_ranges, device=dev)[None, :, None])
    out = torch.einsum('anb,abrc->anrc', combine.to(acc), per_block)
    return out.reshape(B, blocks.num_ranges * blocks.rows, C)[:, :M]


def ordered_aggregate(h, blocks):
    """``out[b, n] = Σ_{e: dst=n} h[b, src_e]`` in the kernel's order and
    rounding: over the row table, each row's k-th source added at step
    ``k`` by one elementwise add into a sum that starts at 0, in
    ``promote(h, float32)`` (the output's dtype), the rows read as
    :func:`operand` gives them (bf16 widened exactly). The CUDA kernel
    computes the same sum bit for bit; this is its reference in the
    tests and on the card, on no main path. ``h [B, M, C]`` →
    ``[B, M, C]``."""
    B, M, C = h.shape
    acc = torch.promote_types(h.dtype, torch.float32)
    x = operand(h, blocks.gather_dtype).to(acc).reshape(B * M, C)
    dev = h.device
    ptr = blocks.row_ptr.to(dev, torch.int64)
    E = blocks.row_src.shape[1]
    # Rows by falling degree (stable), so that step k touches a prefix.
    deg = (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)
    order = torch.argsort(deg, descending=True, stable=True)
    first = (ptr[:, :-1] + torch.arange(B, device=dev)[:, None] * E
             ).reshape(-1)[order]
    base = (order // M) * M   # the row's batch element's first row
    src = blocks.row_src.to(dev, torch.int64).reshape(-1)
    active = torch.bincount(deg, minlength=1).flip(0).cumsum(0).flip(0)
    active = active.cpu().tolist()   # active[k]: rows of degree >= k
    out = torch.zeros(B * M, C, dtype=acc, device=dev)
    for k in range(1, len(active)):
        n = active[k]
        out[:n] = out[:n] + x[base[:n] + src[first[:n] + (k - 1)]]
    return torch.empty_like(out).index_copy_(0, order, out).reshape(
        B, M, C)


def _aggregate(h, blocks):
    # Looked up at call time, so a comparison can swap in the plain
    # version on the card.
    from dgmc_tpu_torch.ops.kernels import blocked
    return blocked.aggregate(h, blocks)


class _AdjMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, fwd_blocks, bwd_blocks):
        ctx.bwd_blocks = bwd_blocks
        return _aggregate(h, fwd_blocks)

    @staticmethod
    def backward(ctx, d_out):
        # The gradient's dtype is cast to h's by autograd.
        return _aggregate(d_out, ctx.bwd_blocks), None, None


@dispatch.counted('adj_matmul', _adj_work)
def adj_matmul(h, fwd_blocks, bwd_blocks):
    """``out[b, n, :] = Σ_{edges e with dst = n} h[b, src_e, :]`` over
    ``fwd_blocks``, in ``promote(h, float32)``; the gradient is the same
    aggregation over ``bwd_blocks`` (the transpose)."""
    return _AdjMatmul.apply(h, fwd_blocks, bwd_blocks)


def _repeat(a, reps):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.repeat_interleave(reps, dim=0)
    if isinstance(a, EdgeBlocks):
        return a.map(lambda t: t.repeat_interleave(reps, dim=0))
    return np.repeat(np.asarray(a), reps, axis=0)


def repeat_graph(graph, reps):
    """Tile a graph batch — a :class:`~dgmc_tpu_torch.ops.graph.
    GraphBatch` or a dict of arrays (:func:`~dgmc_tpu_torch.utils.data.
    pad_graphs`'), its blocks included — ``reps`` times along the batch
    axis (``--pairs-per-step``): the blocking runs once on one pair and
    its tables are repeated."""
    if reps <= 1:
        return graph
    if isinstance(graph, dict):
        return {k: _repeat(v, reps) for k, v in graph.items()}
    from dgmc_tpu_torch.ops.graph import GraphBatch
    return GraphBatch(**{f: _repeat(getattr(graph, f), reps)
                         for f in GraphBatch.FIELDS})


def attach_blocks(graph, rows=128, block_edges=512, min_nodes=1024,
                  gather_dtype=None):
    """``graph`` with blocked adjacency attached (``blocks_in``,
    ``blocks_out``): a :class:`~dgmc_tpu_torch.ops.graph.GraphBatch` or a
    dict of host arrays. On the host, once; a no-op below ``min_nodes``
    nodes or where blocks are attached already. ``gather_dtype``: a dtype
    name (``'bfloat16'``) or a precision policy
    (:func:`~dgmc_tpu_torch.models.precision.gather_dtype_of`)."""
    is_dict = isinstance(graph, dict)
    get = graph.get if is_dict else (lambda k: getattr(graph, k))
    num_nodes = np.shape(get('x'))[1]
    if num_nodes < min_nodes or get('blocks_in') is not None:
        return graph
    if gather_dtype is not None and not isinstance(gather_dtype, str):
        from dgmc_tpu_torch.models.precision import gather_dtype_of
        gather_dtype = gather_dtype_of(gather_dtype)
    inc, outg = build_edge_blocks(get('senders'), get('receivers'),
                                  get('edge_mask'), num_nodes, rows=rows,
                                  block_edges=block_edges)
    if gather_dtype is not None:
        inc = inc.replace(gather_dtype=gather_dtype)
        outg = outg.replace(gather_dtype=gather_dtype)
    if is_dict:
        return {**graph, 'blocks_in': inc, 'blocks_out': outg}
    return dataclasses.replace(graph, blocks_in=inc, blocks_out=outg,
                               _memo={})
