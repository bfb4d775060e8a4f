"""Directed-relation convolution backbone (used for DBP15K KGs).

Per layer ``root(x) + mean_{j->i} lin1(x_j) + mean_{i->j} lin2(x_j)``:
separate linear maps for the incoming and outgoing neighbourhoods, two
masked mean reductions with swapped sender/receiver roles. Stacked as
conv → ReLU → optional
:class:`~dgmc_tpu_torch.models.norm.MaskedBatchNorm` over the node mask
(``bns.<i>``) → dropout in training mode (masks from an explicit
``torch.Generator`` on the model's device), with the jumping-knowledge
concat and a final linear map.

``dtype`` (a compute dtype or a precision policy,
:mod:`~dgmc_tpu_torch.models.precision`): under bf16 the input is cast
once and every linear map runs in bf16 on its float32 weights cast where
used (flax ``Dense(dtype=...)``: the product rounded, then the bias
added); the aggregations sum in float32 and round once.

Where the graph carries blocked adjacency (``blocks_in`` /
``blocks_out``, :func:`~dgmc_tpu_torch.ops.blocked.attach_blocks`), both
aggregations go through :func:`~dgmc_tpu_torch.ops.blocked.adj_matmul`
(the blocked kernel on the card), as the JAX package's RelConv does:
``adj_matmul(h, in, out) * in.inv_degree`` and its transpose, summed in
float32 and rounded once to ``root``'s dtype. Otherwise the edge gathers
and both aggregations of a layer read the graph's cached receiver and
sender orders (:meth:`GraphBatch.csr`: every edge for a gather's
gradient, the real edges for an aggregation), so their gradients, like
their forwards, sum in a fixed order; the means are rounded to the
messages' dtype before they are summed.

Row-restricted (``rows``, a :class:`NodeRows`: this rank's block of the
node rows where ψ₁'s tables are sharded over ranks, DGMC's
``psi1_sharding`` / ``corpus_sharding``): each layer computes ``lin1``,
``lin2`` and ``root`` on the rank's rows only, all-gathers the messages
``h1`` / ``h2`` (:func:`~dgmc_tpu_torch.parallel.comm.all_gather_grad`:
their gradients flow back to the rank that owns them, summed over the
ranks in rank order) and aggregates the rank's rows only: over the
blocked tables, the output rows of the block with a backward over the
entries the rank's rows receive
(:func:`~dgmc_tpu_torch.ops.blocked.adj_matmul_rows`); otherwise the
whole aggregation, its rows kept (:func:`aggregate_rows`). Batch norm's
statistics span every rank's real rows (the row group's sums, with the
data group's where there is one); dropout draws the whole graph's mask
and keeps the rank's rows (:class:`NodeBlock`). The concat and the final
map are row-local. A row's aggregation keeps its order, so the forward
rows are the whole forward's where the products on a row subset round as
on all rows.
"""

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from dgmc_tpu_torch.models.norm import MaskedBatchNorm
from dgmc_tpu_torch.models.precision import compute_dtype_of
from dgmc_tpu_torch.ops.blocked import adj_matmul, adj_matmul_rows
from dgmc_tpu_torch.ops.graph import gather_nodes, scatter_to_nodes

__all__ = ['RelConv', 'RelCNN', 'BatchBlock', 'NodeBlock', 'NodeRows',
           'aggregate_rows', 'dense', 'dropout', 'init_linear_',
           'lecun_normal_']

# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w, fan_in, generator=None):
    """Flax's default kernel init (``lecun_normal``): a normal of variance
    ``1/fan_in`` truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def init_linear_(lin, generator):
    lecun_normal_(lin.weight, lin.in_features, generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


def dense(lin, x, dtype=None):
    """``lin(x)``, or flax's ``Dense(dtype=dtype)`` where ``dtype`` is
    given: ``x``, the kernel and the bias cast to ``dtype``, the product
    rounded to it, then the bias added (rounded again). The weights stay
    float32; the gradient of the cast reaches them in float32."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class BatchBlock(NamedTuple):
    """Dropout's source for block ``index`` of a batch split into ``parts``
    equal blocks over ranks (data parallelism): the masks are drawn from
    ``generator`` for the whole batch and the block's kept, so the pairs
    of a rank's slice draw the masks they draw in one process."""
    generator: torch.Generator
    parts: int
    index: int


class NodeBlock(NamedTuple):
    """Dropout's source for a rank's rows ``[lo, hi)`` of a graph of
    ``num_nodes`` node rows (ψ₁ row-restricted): the mask is drawn from
    ``generator`` (a ``torch.Generator`` or a :class:`BatchBlock`) for
    every node and the rank's rows kept, so a rank's rows drop what they
    drop in one process and the generator advances as it does there."""
    generator: object
    lo: int
    hi: int
    num_nodes: int


def _rows(x, lo, hi, dim=1):
    """Rows ``[lo, hi)`` of ``x`` along ``dim``, zeros past its end."""
    pad = hi - x.shape[dim]
    if pad > 0:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    if lo == 0 and hi == x.shape[dim]:
        return x
    return x.narrow(dim, lo, hi - lo)


class NodeRows:
    """This rank's block of a graph's node rows, ``[lo, hi)`` of the
    ``num_nodes`` rows padded up to equal blocks over the row ``group``'s
    ranks (:func:`~dgmc_tpu_torch.parallel.topk.row_block`);
    ``mesh_group`` spans the row group and the data group (batch norm's
    statistics where the batch is split too)."""

    def __init__(self, lo, hi, num_nodes, group, mesh_group=None):
        self.lo, self.hi, self.num_nodes = lo, hi, num_nodes
        self.group, self.mesh_group = group, mesh_group

    def take(self, x, dim=1):
        """The block's rows of ``x`` (whole rows along ``dim``), zeros
        past ``num_nodes``."""
        return _rows(x, self.lo, self.hi, dim)

    def gather(self, x):
        """Every rank's rows of ``x [B, hi - lo, C]`` → ``[B, num_nodes,
        C]``, differentiably (the gradient of a rank's rows summed over
        the ranks)."""
        from dgmc_tpu_torch.parallel.comm import all_gather_grad
        return all_gather_grad(x, self.group, dim=1)[:, :self.num_nodes]

    def stats_group(self, data_group):
        """Batch norm's group: the rows' group, or with ``data_group``
        (the batch split too) the one over both."""
        return self.group if data_group is None else self.mesh_group

    def dropout_source(self, generator):
        return None if generator is None else NodeBlock(
            generator, self.lo, self.hi, self.num_nodes)


def dropout(h, p, generator):
    """Flax's ``Dropout``: keep each entry with probability ``1 - p`` and
    scale the kept ones by ``1 / (1 - p)`` in ``h``'s dtype; the mask is
    drawn from ``generator``, which lives on ``h``'s device, as float32
    uniforms under every precision policy (flax draws its Bernoulli mask
    so; a bf16 uniform would quantize the keep probability). A
    :class:`BatchBlock` draws the whole batch's mask (``h``'s leading
    axis is the rank's block of the batch) and keeps this block's; a
    :class:`NodeBlock` draws every node row's (``h``'s second axis is the
    rank's block of the rows) and keeps the block's."""
    if generator is None:
        raise ValueError('training-mode dropout draws its masks from an '
                         'explicit generator; pass generator=')
    if p >= 1.0:
        return torch.zeros_like(h)
    rows = None
    if isinstance(generator, NodeBlock):
        rows, generator = generator, generator.generator
    gen, parts, index = (generator if isinstance(generator, BatchBlock)
                         else (generator, 1, 0))
    B = h.shape[0]
    shape = tuple(h.shape[1:])
    if rows is not None:
        shape = (rows.num_nodes,) + shape[1:]
    u = torch.rand((parts * B,) + shape, generator=gen,
                   device=h.device, dtype=torch.float32)
    keep = u[index * B:(index + 1) * B] >= p
    if rows is not None:
        keep = _rows(keep, rows.lo, rows.hi)
    return torch.where(keep, h / (1.0 - p), 0.0)


def aggregate_rows(h_all, graph, rows, senders, receivers, aggr):
    """``rows``' block of the aggregation ``Σ`` (or the mean) over the
    edges ``senders -> receivers`` of the whole ``h_all [B, N, C]``: the
    whole aggregation (the graph's cached edge orders), its block's rows
    kept; the gradient reaches every row of ``h_all`` from the block's
    rows alone. ``rows`` ``None``: the whole aggregation."""
    N = h_all.shape[1]
    msgs = gather_nodes(h_all, getattr(graph, senders),
                        graph.csr(senders, masked=False))
    out = scatter_to_nodes(msgs, getattr(graph, receivers), graph.edge_mask,
                           N, aggr=aggr, segs=graph.csr(receivers))
    return out if rows is None else rows.take(out)


class RelConv(nn.Module):
    def __init__(self, in_channels, out_channels, dtype=None):
        super().__init__()
        self.lin1 = nn.Linear(in_channels, out_channels, bias=False)
        self.lin2 = nn.Linear(in_channels, out_channels, bias=False)
        self.root = nn.Linear(in_channels, out_channels)
        self.dtype = compute_dtype_of(dtype)

    def reset_parameters(self, generator=None):
        for lin in (self.lin1, self.lin2, self.root):
            init_linear_(lin, generator)

    def forward(self, x, graph, streams=1, rows=None):
        """``streams > 1`` evaluates the same convolution on ``streams``
        independent channel groups laid out channel-wise
        (``x: [B, N, streams * C]``): per group the math equals a separate
        call, but the edge gathers read ``streams``-times wider rows.
        ``rows`` (a :class:`NodeRows`): ``x`` is this rank's rows, and so
        is the result (see the module docstring)."""
        B, N = x.shape[0], x.shape[1]

        def grouped(lin, v):
            if streams == 1:
                return dense(lin, v, self.dtype)
            return dense(lin, v.reshape(B, N, streams, -1),
                         self.dtype).reshape(B, N, -1)

        h1 = grouped(self.lin1, x)
        h2 = grouped(self.lin2, x)
        root = grouped(self.root, x)
        if rows is not None:
            h1, h2 = rows.gather(h1), rows.gather(h2)
        if graph.blocks_in is not None:
            # The blocked tables (ops/blocked.py), as the JAX package
            # orders it: each mean in float32, their sum rounded once to
            # root's dtype.
            b_in, b_out = graph.blocks_in, graph.blocks_out
            if rows is None:
                a_in = adj_matmul(h1, b_in, b_out) * b_in.inv_degree
                a_out = adj_matmul(h2, b_out, b_in) * b_out.inv_degree
            else:
                a_in = (adj_matmul_rows(h1, b_in, b_out, rows.lo, rows.hi)
                        * rows.take(b_in.inv_degree))
                a_out = (adj_matmul_rows(h2, b_out, b_in, rows.lo, rows.hi)
                         * rows.take(b_out.inv_degree))
            return root + (a_in + a_out).to(root.dtype)
        # Incoming: messages flow sender -> receiver; outgoing: the same
        # edges walked backwards.
        a_in = aggregate_rows(h1, graph, rows, 'senders', 'receivers', 'mean')
        a_out = aggregate_rows(h2, graph, rows, 'receivers', 'senders',
                               'mean')
        return root + (a_in + a_out)


class RelCNN(nn.Module):
    """Stack of :class:`RelConv` layers (``RelCNN(in, channels, layers)``).

    The output width is :attr:`out_channels`. ``supports_streams`` tells
    DGMC that all consensus steps' source-side inputs can be evaluated
    in one channel-packed pass (refused with batch norm or active
    dropout, which would couple the packed groups).
    """
    supports_streams = True
    supports_rows = True

    def __init__(self, in_channels, channels, num_layers, batch_norm=False,
                 cat=True, lin=True, dropout=0.0, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.channels = channels
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        self.cat = cat
        self.lin = lin
        self.dropout = dropout
        self.dtype = compute_dtype_of(dtype)
        self.convs = nn.ModuleList(
            RelConv(in_channels if i == 0 else channels, channels,
                    dtype=self.dtype)
            for i in range(num_layers))
        self.bns = nn.ModuleList(
            MaskedBatchNorm(channels) for _ in range(num_layers)
        ) if batch_norm else None
        if lin:
            width = (in_channels + num_layers * channels if cat
                     else channels)
            self.final = nn.Linear(width, channels)
        else:
            self.final = None

    @property
    def out_channels(self):
        if self.lin:
            return self.channels
        if self.cat:
            return self.in_channels + self.num_layers * self.channels
        return self.channels

    def reset_parameters(self, generator=None):
        for conv in self.convs:
            conv.reset_parameters(generator)
        for bn in self.bns or ():
            bn.reset_parameters()
        if self.final is not None:
            init_linear_(self.final, generator)

    def forward(self, x, graph, streams=1, generator=None, rows=None):
        """``generator``: the source of the dropout masks, needed in
        training mode with ``dropout > 0``. ``streams > 1`` (see
        :class:`RelConv`) is refused with batch norm, whose statistics
        would span the channel groups, and with active dropout, which
        would draw one mask across them. ``rows`` (a :class:`NodeRows`):
        compute this rank's rows of the whole graph's output only (see
        the module docstring); ``x`` is whole."""
        active = self.training and self.dropout > 0
        if streams > 1 and self.batch_norm:
            raise ValueError('streams>1 is invalid with batch_norm=True: '
                             'batch statistics would couple the streams')
        if streams > 1 and active:
            raise ValueError(
                'streams>1 is invalid with active dropout: a packed '
                'evaluation draws ONE mask across the channel groups, '
                'coupling what should be independent iterations')
        if streams > 1 and rows is not None:
            raise ValueError('streams>1 packs ψ₂\'s source side; rows '
                             'restrict ψ₁: not both')
        B, N = x.shape[0], x.shape[1]
        mask = graph.node_mask
        if rows is not None:
            x, mask = rows.take(x), rows.take(mask)
            generator = rows.dropout_source(generator)
        # Every consumer of x casts it to the compute dtype (the JAX
        # package's Dense layers; its concat then rounds at the final
        # Dense): once here is the same. Batch norm returns float32,
        # which the next layer's maps and the final map cast again.
        xs = [x if self.dtype is None else x.to(self.dtype)]
        for i, conv in enumerate(self.convs):
            h = torch.relu(conv(xs[-1], graph, streams=streams, rows=rows))
            if self.batch_norm:
                h = self.bns[i](h, mask, rows=rows)
            xs.append(dropout(h, self.dropout, generator) if active else h)
        if streams == 1:
            out = torch.cat(xs, dim=-1) if self.cat else xs[-1]
            return dense(self.final, out, self.dtype) if self.lin else out
        # Grouped jumping-knowledge concat + final linear map: per group.
        if self.cat:
            out = torch.cat([v.reshape(B, N, streams, -1) for v in xs],
                            dim=-1)
        else:
            out = xs[-1].reshape(B, N, streams, -1)
        if self.lin:
            out = dense(self.final, out, self.dtype)
        return out.reshape(B, N, -1)

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'num_layers={self.num_layers}, '
                f'batch_norm={self.batch_norm}, cat={self.cat}, '
                f'lin={self.lin}, dropout={self.dropout}')
