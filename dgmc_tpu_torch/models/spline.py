"""SplineCNN backbone: B-spline convolutions over edge pseudo-coordinates.

Per layer (degree-1 open splines, ``kernel_size`` knots per
pseudo-coordinate dimension, mean aggregation, root weight and bias):
every node goes through all ``K^D`` kernel matrices in one GEMM
``t = x @ W`` (``[B*N, C_in] x [C_in, K^D*C_out]``, ``torch.matmul``);
each edge then blends its ``2^D`` active ``(sender, knot)`` rows of ``t``
with the closed-form basis weights and each receiver averages its edges.
That routing step is :func:`~dgmc_tpu_torch.ops.kernels.spline.
route_aggregate` (the CUDA kernel on CUDA tensors, its plain gather +
blend + masked mean on the CPU). Layers are stacked with ReLU and an
optional jumping-knowledge concat, dropout and a final linear map.

``dtype`` (a compute dtype or a precision policy): under bf16 the input
is cast once, the node GEMM, the root map and the final map run in bf16
on their float32 weights cast where used, and the routing takes bf16
``t`` with float32 basis weights and sums (its output rounded once), as
the JAX package's ``SplineConv(dtype=...)`` and its kernel do.
"""

import torch
from torch import nn

from dgmc_tpu_torch.models.precision import compute_dtype_of
from dgmc_tpu_torch.models.rel import (dense, dropout, init_linear_,
                                       lecun_normal_)
from dgmc_tpu_torch.ops.kernels.spline import Routing, route_aggregate
from dgmc_tpu_torch.ops.spline import open_spline_basis

__all__ = ['SplineConv', 'SplineCNN', 'spline_routing']


def spline_routing(graph, kernel_size, degree=1):
    """``(basis, routing)`` of a graph batch for SplineConv: the basis
    weights ``[B, E, 2^D]`` of ``graph.edge_attr`` and the
    :class:`~dgmc_tpu_torch.ops.kernels.spline.Routing` of the fused
    ``(sender, knot)`` rows ``sender * K^D + knot``.

    Built once per graph batch and ``(kernel_size, degree)`` and cached on
    it (:meth:`~dgmc_tpu_torch.ops.graph.GraphBatch.memo`), so every
    layer of every SplineCNN call on the batch shares one routing and its
    records: a dense step's ψ₁ and its ten ψ₂ calls on a graph build one.
    The routing carries no gradient (pseudo-coordinates are constants);
    edge attributes that require a gradient get a routing of their own,
    uncached."""
    if graph.edge_attr is None:
        raise ValueError('SplineConv needs edge pseudo-coordinates '
                         '(graph.edge_attr)')

    def build():
        KD = kernel_size ** graph.edge_attr.shape[-1]
        basis, combo = open_spline_basis(graph.edge_attr, kernel_size,
                                         degree)
        flat = graph.senders[..., None] * KD + combo
        N = graph.num_nodes
        return basis, Routing(flat, graph.receivers, graph.edge_mask, N,
                              N * KD)

    if graph.edge_attr.requires_grad:
        return build()
    return graph.memo(('spline_routing', kernel_size, degree), build)


class SplineConv(nn.Module):
    """One B-spline convolution (``weight [K^D, C_in, C_out]``, the JAX
    package's layout; ``root`` is a bias-free linear map, ``bias`` is
    added last)."""

    def __init__(self, in_channels, out_channels, dim, kernel_size=5,
                 degree=1, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dim = dim
        self.kernel_size = kernel_size
        self.degree = degree
        self.dtype = compute_dtype_of(dtype)
        KD = kernel_size ** dim
        self.weight = nn.Parameter(torch.empty(KD, in_channels,
                                               out_channels))
        self.root = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator=None):
        """Flax's defaults: a truncated normal of variance 1/fan_in with
        fan_in = ``C_in * K^D`` for ``weight``, lecun-normal ``root``,
        zero ``bias``."""
        KD, C_in, _ = self.weight.shape
        with torch.no_grad():
            lecun_normal_(self.weight, C_in * KD, generator)
            self.bias.zero_()
        init_linear_(self.root, generator)

    def forward(self, x, graph, routing=None):
        """``x [B, N, C_in]`` → ``[B, N, C_out]``; ``routing`` is the
        ``(basis, Routing)`` of :func:`spline_routing` (built here when
        not given)."""
        B, N, C_in = x.shape
        KD, _, O = self.weight.shape
        if routing is None:
            routing = spline_routing(graph, self.kernel_size, self.degree)
        basis, route = routing
        if route.num_rows != N * KD:
            raise ValueError(f'the routing has {route.num_rows} rows per '
                             f'graph; this layer needs N * K^D = {N * KD}')
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x = x.to(self.dtype)
            weight, bias = weight.to(self.dtype), bias.to(self.dtype)
        t = x @ weight.permute(1, 0, 2).reshape(C_in, KD * O)
        t = t.reshape(B, N * KD, O)
        return (route_aggregate(t, basis, route)
                + dense(self.root, x, self.dtype) + bias)

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, dim={self.dim}, '
                f'kernel_size={self.kernel_size}')


class SplineCNN(nn.Module):
    """Stack of :class:`SplineConv` layers
    (``SplineCNN(in, channels, dim, num_layers)``); the output width is
    :attr:`out_channels`."""

    def __init__(self, in_channels, channels, dim, num_layers, cat=True,
                 lin=True, dropout=0.0, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.channels = channels
        self.dim = dim
        self.num_layers = num_layers
        self.cat = cat
        self.lin = lin
        self.dropout = dropout
        self.dtype = compute_dtype_of(dtype)
        self.convs = nn.ModuleList(
            SplineConv(in_channels if i == 0 else channels, channels, dim,
                       dtype=self.dtype)
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

    def forward(self, x, graph, generator=None):
        """``generator``: the source of the dropout mask, needed in
        training mode with ``dropout > 0``."""
        conv = self.convs[0]
        routing = spline_routing(graph, conv.kernel_size, conv.degree)
        # Each conv and the final map cast their input to the compute
        # dtype (the JAX package's concat rounds at its final Dense): once
        # here is the same.
        xs = [x if self.dtype is None else x.to(self.dtype)]
        for conv in self.convs:
            xs.append(torch.relu(conv(xs[-1], graph, routing)))
        out = torch.cat(xs, dim=-1) if self.cat else xs[-1]
        if self.training and self.dropout > 0:
            out = dropout(out, self.dropout, generator)
        return dense(self.final, out, self.dtype) if self.lin else out

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, dim={self.dim}, '
                f'num_layers={self.num_layers}, cat={self.cat}, '
                f'lin={self.lin}, dropout={self.dropout}')
