"""SplineConv routing and masked-mean aggregation: CUDA kernels and plain
versions.

The kernels (``csrc/spline.cu``) replace the JAX package's Pallas TPU
kernels ``dgmc_tpu/ops/pallas/spline.py::_fwd_kernel`` / ``_bwd_kernel``;
see the source for their design and bound. With ``t [B, M, O]`` the node
features through all ``K^D`` kernel matrices (``M = N * K^D``) and a
:class:`Routing` (each edge's ``A = 2^D`` active rows ``flat [B, E, A]``
of ``t``, its receiver and mask):

- :func:`route_fwd` computes ``out[b, n] = sum over the real edges e into
  n of sum_a basis[b, e, a] * t[b, flat[b, e, a]] / max(deg_n, 1)``
  (an all-masked node gives zeros);
- :func:`route_d_t` its transpose, the gradient w.r.t. ``t``: a scatter
  of ``basis * g[rcv] / deg`` to the ``M`` rows;
- :func:`route_aggregate` ties them into one differentiable op (a
  ``torch.autograd.Function``); the gradient w.r.t. ``basis`` (edge
  attributes) is plain PyTorch and runs only when ``basis`` requires
  one.

Each wrapper takes its plain version for CPU tensors; on a CUDA tensor it
launches its kernel or raises. The kernels have no size gate: they hold
no per-graph working set (the TPU kernel's VMEM limits ``MAX_E``/``MAX_N``
do not apply), so every CUDA call launches.

Both kernels read CSR lists that :class:`Routing` builds once per graph
batch with a stable sort (receiver-sorted edges, flat-sorted slots) and
caches, so the layers of one SplineCNN call share them; the ``d_t``
kernel reads the slots as 32-bit records (:meth:`Routing.slot_records`,
one launch of a third kernel, once per routing and basis) and divides
``g`` by the receivers' degrees once per node. Sums run in that fixed
order without atomics: repeats are bit-identical.
"""

import ctypes

import torch

from dgmc_tpu_torch.ops.graph import scatter_to_nodes, segments
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['Routing', 'build_slot_records', 'plain_route_aggregate',
           'plain_route_d_t', 'plain_slot_records', 'route_fwd', 'route_d_t',
           'route_aggregate']


class Routing:
    """The edge → (receiver, t-row) structure of one padded graph batch.

    Args:
        flat: ``[B, E, A]`` int rows of ``t`` (per graph, ``< M``): the
            (sender, knot) pairs each edge blends.
        receivers / edge_mask: ``[B, E]`` as in
            :class:`~dgmc_tpu_torch.ops.graph.GraphBatch`. Masked edges
            take no part in any sum.
        num_nodes: ``N``.
        num_rows: ``M``, the rows of ``t`` per graph.
    """

    def __init__(self, flat, receivers, edge_mask, num_nodes, num_rows):
        self.flat = flat.long().contiguous()
        self.receivers = receivers.long().contiguous()
        self.edge_mask = edge_mask
        self.num_nodes = num_nodes
        self.num_rows = num_rows
        self._rcv = self._slots = self._records = None

    @property
    def device(self):
        return self.flat.device

    def receiver_csr(self):
        """``(order, offsets)``: edge ids of the flattened batch sorted by
        ``(b, receiver)``, masked edges last; node ``(b, n)`` owns
        ``order[offsets[b*N+n] : offsets[b*N+n+1]]``."""
        if self._rcv is None:
            self._rcv = segments(self.receivers, self.edge_mask,
                                 self.num_nodes)
        return self._rcv

    def slot_csr(self):
        """``(order, offsets)``: the ``(edge, a)`` slot ids of the
        flattened batch (``(b*E + e)*A + a``) sorted by ``(b, flat)``,
        masked slots last; row ``(b, m)`` owns
        ``order[offsets[b*M+m] : offsets[b*M+m+1]]``."""
        if self._slots is None:
            B, E, A = self.flat.shape
            M = self.num_rows
            base = torch.arange(B, device=self.device)[:, None, None] * M
            key = torch.where(self.edge_mask[..., None], self.flat + base,
                              B * M)
            sorted_key, order = torch.sort(key.reshape(-1), stable=True)
            bounds = torch.arange(B * M + 1, device=self.device)
            self._slots = (order, torch.searchsorted(sorted_key, bounds))
        return self._slots

    def slot_records(self, basis):
        """``(records, offsets)`` that the ``d_t`` kernel reads (see
        :func:`build_slot_records`), built once per routing and ``basis``
        tensor (its storage and version), like the CSR lists."""
        key = (basis.data_ptr(), basis._version, tuple(basis.shape))
        if self._records is None or self._records[0] != key:
            # Holding basis keeps its storage (and so the key) its own.
            self._records = (key, basis, *build_slot_records(self, basis))
        return self._records[2:]


def plain_slot_records(routing, basis):
    """The plain version of :func:`build_slot_records`."""
    order, offsets = routing.slot_csr()
    E, A = routing.flat.shape[1:]
    edge = order // A
    node = (edge // E) * routing.num_nodes + routing.receivers.reshape(
        -1)[edge]
    weight = basis.detach().reshape(-1).to(torch.float32)[order]
    records = torch.stack([node.to(torch.int32), weight.view(torch.int32)],
                          dim=1)
    return records, offsets.to(torch.int32)


def build_slot_records(routing, basis):
    """``(records, offsets)``: one record of two 32-bit words per slot, in
    the order of :meth:`Routing.slot_csr` — the receiver node of the
    flattened batch ``b*N + receivers[b, e]`` (int32) and the slot's
    weight ``basis[b, e, a]`` (float32 bits) — ``[B*E*A, 2]`` int32
    (masked slots last, never read), and the row offsets of
    :meth:`Routing.slot_csr` as int32. One launch of the ``slot_records``
    kernel on the card (uncached; :meth:`Routing.slot_records` caches
    it), :func:`plain_slot_records` on the CPU."""
    dev = _check(basis, basis, routing, 'slot_records')
    B, E, A = routing.flat.shape
    if B * E * A >= 2 ** 31:
        raise ValueError(f'{B * E * A} slots exceed the int32 records of '
                         f'the d_t kernel')
    if dev.type == 'cpu':
        return plain_slot_records(routing, basis)
    order, offsets = routing.slot_csr()
    basis = basis.detach().contiguous()
    records = torch.empty((B * E * A, 2), dtype=torch.int32, device=dev)
    off32 = torch.empty(offsets.shape, dtype=torch.int32, device=dev)
    err = _library().dgmc_spline_slot_records(
        order.data_ptr(), routing.receivers.data_ptr(), basis.data_ptr(),
        offsets.data_ptr(), records.data_ptr(), off32.data_ptr(),
        B * E * A, offsets.numel(), E, A, routing.num_nodes, *_stream(dev))
    if err != 0:
        raise RuntimeError(f'slot_records kernel launch failed with CUDA '
                           f'error {err} (B={B}, E={E}, A={A})')
    return records, off32


def plain_route_aggregate(t, basis, routing):
    """The plain version of the forward: gather the ``A`` rows of every
    edge, blend them with ``basis``, masked mean over each receiver's
    edges (differentiable by autograd)."""
    B, M, O = t.shape
    E, A = routing.flat.shape[1:]
    picked = torch.gather(
        t, 1, routing.flat.reshape(B, E * A, 1).expand(-1, -1, O))
    msgs = torch.einsum('bea,beao->beo', basis.to(t.dtype),
                        picked.reshape(B, E, A, O))
    return scatter_to_nodes(msgs, routing.receivers, routing.edge_mask,
                            routing.num_nodes, aggr='mean')


def _g_norm(g, routing):
    """``g / max(deg, 1)`` per receiver node."""
    _, offsets = routing.receiver_csr()
    B, N = g.shape[0], routing.num_nodes
    deg = (offsets[1:] - offsets[:-1])[:B * N].to(g.dtype)
    return g / deg.clamp(min=1.0).reshape(B, N, 1)


def plain_route_d_t(g, basis, routing):
    """The plain version of the backward w.r.t. ``t``: ``g [B, N, O]`` →
    ``d_t [B, M, O]``, each slot's ``basis * g[rcv] / deg`` summed into
    its ``flat`` row in slot order."""
    B, E, A = routing.flat.shape
    O = g.shape[-1]
    gn = _g_norm(g, routing)
    rows = torch.gather(gn, 1, routing.receivers[..., None].expand(-1, -1,
                                                                    O))
    contrib = basis.to(g.dtype)[..., None] * rows[:, :, None, :]
    mask = routing.edge_mask[..., None].expand(B, E, A).reshape(B, E * A)
    return scatter_to_nodes(contrib.reshape(B, E * A, O),
                            routing.flat.reshape(B, E * A), mask,
                            routing.num_rows, aggr='sum')


def _d_basis(g, t, routing):
    """Gradient w.r.t. ``basis`` (plain PyTorch): ``mask_e * sum_o
    (g/deg)[b, rcv_e, o] * t[b, flat[b, e, a], o]``."""
    B, E, A = routing.flat.shape
    O = g.shape[-1]
    gn = _g_norm(g, routing)
    rows = torch.gather(gn, 1, routing.receivers[..., None].expand(-1, -1,
                                                                    O))
    picked = torch.gather(
        t, 1, routing.flat.reshape(B, E * A, 1).expand(-1, -1, O))
    d = torch.einsum('beo,beao->bea', rows, picked.reshape(B, E, A, O))
    return d * routing.edge_mask[..., None].to(d.dtype)


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('spline.cu')
    if not getattr(lib, 'spline_bound', False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dgmc_spline_route_fwd_f32.argtypes = [p] * 6 + [i, i, ll, i, i,
                                                           i, p]
        lib.dgmc_spline_route_dt_f32.argtypes = [p] * 6 + [i, i, ll, i, i,
                                                          p]
        lib.dgmc_spline_slot_records.argtypes = [p] * 6 + [ll, ll, i, i, i,
                                                          i, p]
        for fn in (lib.dgmc_spline_route_fwd_f32,
                   lib.dgmc_spline_route_dt_f32,
                   lib.dgmc_spline_slot_records):
            fn.restype = ctypes.c_int
        lib.spline_bound = True
    return lib


def _check(t_or_g, basis, routing, name):
    devs = {t_or_g.device, basis.device, routing.device}
    if len(devs) != 1:
        raise ValueError(f'{name} inputs lie on several devices: '
                         f'{sorted(map(str, devs))}')
    dev = t_or_g.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cpu or cuda, not {dev.type}')
    if dev.type == 'cuda' and (t_or_g.dtype != torch.float32
                               or basis.dtype != torch.float32):
        raise TypeError(f'the {name} kernel takes float32 only; got '
                        f'{t_or_g.dtype} / {basis.dtype}')
    if tuple(basis.shape) != tuple(routing.flat.shape):
        raise ValueError(f'basis {tuple(basis.shape)} and flat '
                         f'{tuple(routing.flat.shape)} differ in shape')
    return dev


def _stream(device):
    s = torch.cuda.current_stream(device)
    return s.device_index, s.cuda_stream


@dispatch.kernel_wrapper('spline_route_fwd')
def route_fwd(t, basis, routing):
    """Forward routing ``t [B, M, O]`` → ``[B, N, O]`` (no gradient; see
    :func:`route_aggregate`)."""
    dev = _check(t, basis, routing, 'spline_route_fwd')
    B, M, O = t.shape
    if M != routing.num_rows:
        raise ValueError(f't has {M} rows per graph, the routing '
                         f'{routing.num_rows}')
    t, basis = t.detach(), basis.detach()
    if dev.type == 'cpu':
        dispatch.record('spline_route_fwd', 'plain', 'device=cpu')
        return plain_route_aggregate(t, basis, routing)
    dispatch.record('spline_route_fwd', 'kernel', 'auto-cuda')
    lib = _library()
    N, A = routing.num_nodes, routing.flat.shape[2]
    order, offsets = routing.receiver_csr()
    t, basis = t.contiguous(), basis.contiguous()
    out = torch.empty((B, N, O), dtype=torch.float32, device=dev)
    err = lib.dgmc_spline_route_fwd_f32(
        t.data_ptr(), routing.flat.data_ptr(), basis.data_ptr(),
        order.data_ptr(), offsets.data_ptr(), out.data_ptr(), B, N, M, O, A,
        *_stream(dev))
    if err != 0:
        raise RuntimeError(f'spline_route_fwd kernel launch failed with CUDA '
                           f'error {err} (B={B}, N={N}, M={M}, O={O}, A={A})')
    route_fwd.launches += 1
    return out


@dispatch.kernel_wrapper('spline_route_bwd')
def route_d_t(g, basis, routing):
    """Backward routing w.r.t. ``t``: ``g [B, N, O]`` → ``[B, M, O]``."""
    dev = _check(g, basis, routing, 'spline_route_bwd')
    B, N, O = g.shape
    if N != routing.num_nodes:
        raise ValueError(f'g has {N} nodes per graph, the routing '
                         f'{routing.num_nodes}')
    g, basis = g.detach(), basis.detach()
    if dev.type == 'cpu':
        dispatch.record('spline_route_bwd', 'plain', 'device=cpu')
        return plain_route_d_t(g, basis, routing)
    dispatch.record('spline_route_bwd', 'kernel', 'auto-cuda')
    lib = _library()
    M = routing.num_rows
    records, offsets = routing.slot_records(basis)
    _, rcv_offsets = routing.receiver_csr()
    g = g.contiguous()
    g_norm = torch.empty_like(g)       # scratch: g / max(deg, 1)
    d_t = torch.empty((B, M, O), dtype=torch.float32, device=dev)
    err = lib.dgmc_spline_route_dt_f32(
        g.data_ptr(), records.data_ptr(), offsets.data_ptr(),
        rcv_offsets.data_ptr(), g_norm.data_ptr(), d_t.data_ptr(), B, N, M,
        O, *_stream(dev))
    if err != 0:
        raise RuntimeError(f'spline_route_bwd kernel launch failed with CUDA '
                           f'error {err} (B={B}, N={N}, M={M}, O={O})')
    route_d_t.launches += 1
    return d_t


class _RouteAggregate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, basis, routing):
        ctx.routing = routing
        ctx.save_for_backward(t if ctx.needs_input_grad[1] else None, basis)
        return route_fwd(t, basis, routing)

    @staticmethod
    def backward(ctx, g):
        t, basis = ctx.saved_tensors
        routing = ctx.routing
        d_t = (route_d_t(g, basis, routing) if ctx.needs_input_grad[0]
               else None)
        d_basis = (_d_basis(g, t, routing).to(basis.dtype)
                   if ctx.needs_input_grad[1] else None)
        return d_t, d_basis, None


def route_aggregate(t, basis, routing):
    """Masked-mean aggregation of basis-blended ``t`` rows, differentiable
    in ``t`` (the :func:`route_d_t` kernel) and in ``basis`` (plain
    PyTorch, only when asked for)."""
    return _RouteAggregate.apply(t, basis, routing)
