"""GIN backbone (Graph Isomorphism Network).

``num_layers`` GIN convolutions with a learnable ``eps`` (initially 0),
``h_i' = MLP((1 + eps) * h_i + Σ_{j→i} h_j)``, each wrapping a 2-layer
:class:`~dgmc_tpu_torch.models.mlp.MLP` without dropout; the
jumping-knowledge concat ``[x, h^1, ..., h^L]`` when ``cat``; the
optional final linear map. The output width is :attr:`GIN.out_channels`.

The neighbour sum reads the graph's cached receiver and sender orders
(:meth:`GraphBatch.csr`), so it and its gradient sum in a fixed order,
without atomics.

``dtype`` (a compute dtype or a precision policy): ``(1 + eps) * x +
agg`` is formed as the JAX package forms it, the float32 ``eps``
promoting a bf16 ``x`` (and the bf16 sum, accumulated in float32 and
rounded once) to float32; each MLP's linear maps and the final map then
cast to the compute dtype where used.

GIN has no channel-packed evaluation (``streams``): as ψ₂, DGMC calls it
once per consensus step on each side.

Row-restricted (``rows``, as ψ₁ under DGMC's ``psi1_sharding`` /
``corpus_sharding``): RelConv's incoming half
(:func:`~dgmc_tpu_torch.models.rel.aggregate_rows`): each layer
all-gathers its input rows, sums the neighbours of the rank's rows and
runs the MLP on those rows alone (row-local; its batch norm over every
rank's real rows).
"""

import torch
from torch import nn

from dgmc_tpu_torch.models.mlp import MLP
from dgmc_tpu_torch.models.precision import compute_dtype_of
from dgmc_tpu_torch.models.rel import aggregate_rows, dense, init_linear_

__all__ = ['GINConv', 'GIN']


class GINConv(nn.Module):
    """``MLP((1 + eps) * x + Σ_{j→i} x_j)`` with a learnable scalar
    ``eps``."""

    def __init__(self, mlp):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.eps.zero_()
        self.mlp.reset_parameters(generator)

    def forward(self, x, graph, generator=None, rows=None):
        """``rows``: ``x`` is this rank's rows, and so is the result."""
        x_all = x if rows is None else rows.gather(x)
        agg = aggregate_rows(x_all, graph, rows, 'senders', 'receivers',
                             'sum')
        acc = torch.promote_types(x.dtype, self.eps.dtype)
        out = (1.0 + self.eps) * x.to(acc) + agg.to(acc)
        mask = graph.node_mask if rows is None else rows.take(
            graph.node_mask)
        return self.mlp(out, mask, generator=generator, rows=rows)


class GIN(nn.Module):
    """``GIN(in, channels, num_layers)``; flax's ``mlp_<i>`` and
    ``conv_<i>`` scopes are ``convs.<i>.mlp`` and ``convs.<i>`` here."""
    supports_rows = True

    def __init__(self, in_channels, channels, num_layers, batch_norm=False,
                 cat=True, lin=True, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.channels = channels
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        self.cat = cat
        self.lin = lin
        self.dtype = compute_dtype_of(dtype)
        self.convs = nn.ModuleList(
            GINConv(MLP(in_channels if i == 0 else channels, channels, 2,
                        batch_norm, dropout=0.0, dtype=self.dtype))
            for i in range(num_layers))
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
        if self.final is not None:
            init_linear_(self.final, generator)

    def forward(self, x, graph, generator=None, rows=None):
        """``generator`` is accepted for DGMC's calls; GIN draws nothing
        (its MLPs have no dropout). ``rows``: compute this rank's rows
        only (see the module docstring); ``x`` is whole."""
        xs = [x if rows is None else rows.take(x)]
        for conv in self.convs:
            xs.append(conv(xs[-1], graph, generator=generator, rows=rows))
        # torch.cat promotes mixed dtypes as the JAX package's concat does.
        out = torch.cat(xs, dim=-1) if self.cat else xs[-1]
        return dense(self.final, out, self.dtype) if self.lin else out

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'num_layers={self.num_layers}, '
                f'batch_norm={self.batch_norm}, cat={self.cat}, '
                f'lin={self.lin}')
