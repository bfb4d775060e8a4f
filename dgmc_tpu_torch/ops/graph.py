"""Padded graph batches and deterministic edge→node aggregation.

Every batch of graphs lives in ``[B, N, ...]`` / ``[B, E, ...]`` tensors
with boolean validity masks and graph-local edge endpoints, as in the
JAX package. Aggregation never uses ``index_add_``/``scatter_add_``:
those use floating-point atomics on CUDA, whose order changes from run
to run, and serving promises bit-identical answers across repeats. Edges
are instead stable-sorted by receiver and each node's messages summed in
edge order by one segment reduction. The same holds for the gradient of
a gather (``torch.gather``'s backward is ``scatter_add_``):
:func:`gather_nodes` sums it by the same sorted segment reduction.
The sort, ``searchsorted`` and ``segment_reduce`` read nothing back to
the host, so a captured CUDA graph records them (the captures run under
``torch.cuda.set_sync_debug_mode('error')``).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ['GraphBatch', 'canonical_device', 'host_tensor', 'gather_nodes',
           'segments', 'segment_sum', 'scatter_to_nodes', 'degree']


def canonical_device(device):
    """``device`` as a ``torch.device``, a CUDA one with its index."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def host_tensor(array, dtype, pin_memory=False):
    """A fresh CPU tensor of ``dtype`` holding ``array`` (in pinned memory
    with ``pin_memory``): one copy, the conversion included."""
    array = np.asarray(array)
    out = torch.empty(array.shape, dtype=dtype, pin_memory=pin_memory)
    return out.copy_(torch.from_numpy(array))


@dataclasses.dataclass
class GraphBatch:
    """A batch of ``B`` graphs padded to ``N`` nodes and ``E`` edges each.

    Attributes:
        x: ``[B, N, C]`` node features (zeros at padding).
        senders / receivers: ``[B, E]`` int64 graph-local endpoints.
        node_mask: ``[B, N]`` bool, True at real nodes.
        edge_mask: ``[B, E]`` bool, True at real edges. Padded edges
            point at node 0 and are masked out of every aggregation.
        edge_attr: optional ``[B, E, D]`` float32 edge features (the
            pseudo-coordinates of SplineCNN).
        blocks_in / blocks_out: optional blocked adjacency
            (:class:`~dgmc_tpu_torch.ops.blocked.EdgeBlocks`, attached on
            the host by :func:`~dgmc_tpu_torch.ops.blocked.attach_blocks`):
            the tables RelConv aggregates through where they are present.
            Their tensors travel with the batch's (:meth:`fields`), so a
            captured step takes them as static inputs and never rebuilds
            them.

    A batch is immutable once built: :meth:`csr` caches the sorted edge
    orders per endpoint array, so every aggregation and gather gradient
    over one batch sorts each endpoint array at most twice (real edges;
    every edge), and :meth:`memo` caches what a model derives from the
    graph alone (SplineCNN's routing,
    :func:`~dgmc_tpu_torch.models.spline.spline_routing`). Neither the
    endpoint arrays, the masks nor the edge attributes are to be modified
    after a batch is built.

    The upload is split in two (:meth:`from_numpy`): :meth:`host`
    validates the arrays and converts them to CPU tensors (in pinned
    memory for a copy to the card), on any thread; then
    :meth:`to` copies them to the device on the caller's current stream,
    without blocking. Each host batch gets fresh pinned tensors: torch's
    host allocator keeps them from reuse until their copy is done.

    A captured step's static input batch (:meth:`static_like`) is the one
    exception to immutability: :meth:`copy_from` writes each step's batch
    into it. Its caches are derived data, so it holds none across a copy:
    :meth:`copy_from` refuses a batch with a non-empty memo, and the step
    clears it (:meth:`clear_memo`) after each run and capture, so that a
    graph builds its routing and CSR orders inside the captured region,
    from the data each replay copies in.
    """
    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    edge_attr: Optional[torch.Tensor] = None
    blocks_in: Optional[object] = None
    blocks_out: Optional[object] = None
    _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    #: The data fields, in order.
    FIELDS = ('x', 'senders', 'receivers', 'node_mask', 'edge_mask',
              'edge_attr', 'blocks_in', 'blocks_out')

    @classmethod
    def host(cls, arrays, pin_memory=False):
        """The host part of an upload: a batch of CPU tensors (pinned with
        ``pin_memory``) from the arrays of
        :func:`~dgmc_tpu_torch.utils.data.pad_graphs` (or any dict with
        the same keys). Edge endpoints outside ``[0, N)`` raise: the
        kernels index node rows with them unchecked. So does a
        ``node_mask`` whose real nodes are not the first of each graph: a
        candidate's validity and the negatives' draw take node ``j`` as
        real when ``j`` is below the graph's count of real nodes (as
        :func:`pad_graphs` pads, at the tail)."""
        N = np.shape(arrays['x'])[1]
        for key in ('senders', 'receivers'):
            ends = np.asarray(arrays[key])
            if ends.size and (ends.min() < 0 or ends.max() >= N):
                raise ValueError(f'{key} outside [0, {N})')
        mask = np.asarray(arrays['node_mask'], bool)
        if (mask[:, 1:] & ~mask[:, :-1]).any():
            raise ValueError('node_mask: the real nodes of a graph must '
                             'come first (a padded tail), not interleave '
                             'with padding')
        attr = arrays.get('edge_attr')

        def blocks(key):
            b = arrays.get(key)
            if b is None or not pin_memory:
                return b
            return b.map(lambda t: t.pin_memory())
        return cls(x=host_tensor(arrays['x'], torch.float32, pin_memory),
                   senders=host_tensor(arrays['senders'], torch.int64,
                                       pin_memory),
                   receivers=host_tensor(arrays['receivers'], torch.int64,
                                         pin_memory),
                   node_mask=host_tensor(mask, torch.bool, pin_memory),
                   edge_mask=host_tensor(arrays['edge_mask'], torch.bool,
                                         pin_memory),
                   edge_attr=(None if attr is None else host_tensor(
                       attr, torch.float32, pin_memory)),
                   blocks_in=blocks('blocks_in'),
                   blocks_out=blocks('blocks_out'))

    def to(self, device):
        """This batch on ``device``: itself where it lies there already,
        else a copy (``non_blocking``, on the current stream) with empty
        caches."""
        device = canonical_device(device)
        if self.x.device == device:
            return self

        return self._mapped(lambda t: t.to(device, non_blocking=True))

    def _mapped(self, fn):
        """A batch of ``fn`` of each tensor (the blocks' tables
        included), with empty caches."""
        def one(v):
            if v is None:
                return None
            return fn(v) if torch.is_tensor(v) else v.map(fn)
        return GraphBatch(**{f: one(getattr(self, f)) for f in self.FIELDS})

    @classmethod
    def from_numpy(cls, arrays, device):
        """:meth:`host` (pinned for a CUDA ``device``), then :meth:`to`
        ``device``."""
        device = canonical_device(device)
        return cls.host(arrays, device.type == 'cuda').to(device)

    def fields(self):
        """The batch's tensors: ``edge_attr`` where present, then the
        blocks' tables where present."""
        out = [t for t in (self.x, self.senders, self.receivers,
                           self.node_mask, self.edge_mask, self.edge_attr)
               if t is not None]
        for b in (self.blocks_in, self.blocks_out):
            if b is not None:
                out += b.tensors()
        return out

    @property
    def meta(self):
        """What a captured step's signature takes from the batch beside
        its tensors' shapes: whether it has edge attributes and which
        blocks."""
        return (self.edge_attr is not None,
                *(None if b is None else b.meta
                  for b in (self.blocks_in, self.blocks_out)))

    def static_like(self, device):
        """An uninitialized batch of this one's shapes and dtypes on
        ``device``, with an empty memo: a captured step's input buffers
        (:meth:`copy_from`)."""
        device = canonical_device(device)
        return self._mapped(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                  device=device))

    def copy_from(self, src):
        """Copy ``src``'s data into this batch's tensors (without blocking
        from pinned host memory, on the current stream). Refuses a
        non-empty memo: a cache built from the data being replaced would go
        stale."""
        if self._memo:
            raise RuntimeError(f'copy_from into a batch with cached '
                               f'{sorted(map(str, self._memo))}: clear_memo '
                               f'first, so that caches are rebuilt from the '
                               f'new data')
        dst, new = self.fields(), src.fields()
        if [(t.shape, t.dtype) for t in dst] != [(t.shape, t.dtype)
                                                 for t in new] \
                or self.meta != src.meta:
            raise ValueError('copy_from: the batches differ in shape, dtype, '
                             'edge attributes or blocks')
        for d, t in zip(dst, new):
            d.copy_(t, non_blocking=True)
        return self

    def clear_memo(self):
        """Drop every cache (:meth:`memo`, :meth:`csr`)."""
        self._memo.clear()

    @property
    def num_nodes(self):
        return self.x.shape[1]

    @property
    def num_edges(self):
        return self.senders.shape[1]

    def memo(self, key, build):
        """``build()``, computed once per batch under ``key``."""
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def csr(self, key, masked=True):
        """:func:`segments` of the edges by ``key`` (``'senders'`` or
        ``'receivers'``), computed once per batch: of the real edges
        (``masked``, for :func:`scatter_to_nodes`) or of every edge (for
        :func:`gather_nodes`)."""
        return self.memo(('csr', key, masked), lambda: segments(
            getattr(self, key), self.edge_mask if masked else None,
            self.num_nodes))


class _GatherNodes(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, idx, segs):
        ctx.num_nodes = x.shape[1]
        ctx.segs = segs
        if segs is None:
            ctx.save_for_backward(idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        segs = ctx.segs
        if segs is None:
            idx, = ctx.saved_tensors
            segs = segments(idx, None, ctx.num_nodes)
        return segment_sum(g, *segs, ctx.num_nodes).to(g.dtype), None, None


def gather_nodes(x, idx, segs=None):
    """Batched node gather ``x[b, idx[b, e]]``: ``[B, N, C]``, ``[B, E]``
    → ``[B, E, C]``.

    Its gradient w.r.t. ``x`` sums each node's rows in a fixed order
    (:func:`segment_sum`) over ``segs = segments(idx, None, N)``, the
    order of every entry of ``idx``: pass an earlier call's to skip the
    sort (``GraphBatch.csr(key, masked=False)``). A masked order would
    drop the gradient of the entries it leaves out.
    """
    return _GatherNodes.apply(x, idx, segs)


def segments(receivers, edge_mask, num_nodes):
    """Receiver-sorted edge order and per-node offsets over the flattened
    batch: node ``(b, n)`` owns sorted positions
    ``offsets[b*N+n] : offsets[b*N+n+1]``. Masked edges sort into a
    sentinel segment past the last node; ``edge_mask=None`` keeps every
    edge."""
    B = receivers.shape[0]
    base = torch.arange(B, device=receivers.device)[:, None] * num_nodes
    seg = receivers.long() + base
    if edge_mask is not None:
        seg = torch.where(edge_mask, seg, B * num_nodes)
    sorted_seg, order = torch.sort(seg.reshape(-1), stable=True)
    bounds = torch.arange(B * num_nodes + 2, device=receivers.device)
    offsets = torch.searchsorted(sorted_seg, bounds)
    return order, offsets


def segment_sum(messages, order, offsets, num_nodes):
    """``[B, E, C]`` messages summed per node in the sorted order of
    :func:`segments` → ``[B, N, C]``, accumulated in (at least) float32.
    The last segment is the masked edges' sentinel: reduced, then cut."""
    B, E, C = messages.shape
    acc = torch.promote_types(messages.dtype, torch.float32)
    data = messages.reshape(B * E, C).to(acc)[order]
    out = torch.segment_reduce(data, 'sum', offsets=offsets, axis=0)
    return out[:B * num_nodes].reshape(B, num_nodes, C)


def scatter_to_nodes(messages, receivers, edge_mask, num_nodes, aggr='sum',
                     segs=None):
    """Batched edge→node aggregation, deterministic on every device.

    messages: ``[B, E, C]``, receivers: ``[B, E]``, edge_mask: ``[B, E]``.
    Returns ``[B, N, C]``. ``aggr`` is ``'sum'`` or ``'mean'`` (masked;
    empty neighbourhoods give zeros). Sums accumulate in float32 and are
    cast back to the message dtype once. ``segs``: the
    ``segments(receivers, edge_mask, num_nodes)`` of an earlier call, to
    skip the sort.
    """
    if aggr not in ('sum', 'mean'):
        raise ValueError(f'Unknown aggregation: {aggr!r}')
    B = messages.shape[0]
    order, offsets = segs or segments(receivers, edge_mask, num_nodes)
    out = segment_sum(messages, order, offsets, num_nodes)
    if aggr == 'mean':
        deg = (offsets[1:] - offsets[:-1])[:B * num_nodes].to(out.dtype)
        out = out / deg.clamp(min=1.0).reshape(B, num_nodes, 1)
    return out.to(messages.dtype)


def degree(receivers, edge_mask, num_nodes):
    """Masked in-degree per node: ``[B, E]`` → ``[B, N]`` float32."""
    B = receivers.shape[0]
    _, offsets = segments(receivers, edge_mask, num_nodes)
    deg = (offsets[1:] - offsets[:-1])[:B * num_nodes]
    return deg.to(torch.float32).reshape(B, num_nodes)
