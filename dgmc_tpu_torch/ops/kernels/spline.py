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
launches its kernel or raises. ``t`` and ``g`` may be float32 or
bfloat16 (the precision policy's variant); ``basis`` stays float32 and
every sum runs in float32, the output rounded to ``t``'s (``g``'s) dtype
once, as the JAX package's kernels write it. The kernels have no size gate: they hold
no per-graph working set (the TPU kernel's VMEM limits ``MAX_E``/``MAX_N``
do not apply), so every CUDA call launches.

Both kernels read CSR lists that :class:`Routing` builds once per graph
batch with a stable sort (receiver-sorted edges, flat-sorted slots) and
caches, so the layers of one SplineCNN call share them. Each reads its
list as records of two 32-bit words: the forward's edge records
(:meth:`Routing.edge_records`) and the ``d_t`` kernel's slot records
(:meth:`Routing.slot_records`), both built by one launch of a kernel of
their own (:func:`build_records`, counted on its own) once per routing
and basis and cached beside the lists; ``d_t`` also divides ``g`` by the
receivers' degrees once per node. Sums run in that fixed order without
atomics: repeats are bit-identical.

:func:`route_work` and :func:`records_work` are the least work of these
functions on one routing (the work counter's count in
:mod:`~dgmc_tpu_torch.obs.cost` and ``chip_smoke.py``'s bounds), the same
whichever path runs.
"""

import ctypes

import torch

from dgmc_tpu_torch.ops.graph import scatter_to_nodes, segments
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['Routing', 'build_records', 'plain_edge_records',
           'plain_route_aggregate', 'plain_route_d_t', 'plain_slot_records',
           'route_fwd', 'route_d_t', 'route_aggregate', 'route_work',
           'records_work']


def route_work(basis, routing, O, elem=4):
    """The least work of the forward on this routing, and (``'bwd'``)
    of ``d_t``: an add and a product per real slot and channel; the
    forward reads each touched row of ``t`` once, the gradient writes all
    of ``d_t`` (``elem`` bytes a value of ``t``, ``g`` and the outputs:
    4, or 2 for bf16), each reads the slots' rows and weights (12 bytes a
    slot) and the edges' receivers and masks (9 bytes an edge). Reads the
    routing's mask and rows on its device."""
    B, E, A = routing.flat.shape
    N, M = routing.num_nodes, routing.num_rows
    keep = routing.edge_mask[..., None].expand(B, E, A)
    slots = int(keep.sum())
    b = torch.arange(B, device=routing.flat.device)[:, None, None]
    rows = int(torch.unique((b * M + routing.flat)[keep]).numel())
    index_bytes = 12.0 * slots + 9.0 * B * E
    flops = 2.0 * slots * O
    return {'kernel': 'spline_route_fwd', 'flops': flops,
            'bytes': elem * rows * O + index_bytes + elem * B * N * O,
            'out_bytes': elem * B * N * O, 'dot': True, 'slots': slots,
            'rows': rows,
            'bwd': {'kernel': 'spline_route_bwd', 'flops': flops,
                    'bytes': elem * B * N * O + index_bytes
                    + elem * B * M * O,
                    'out_bytes': elem * B * M * O, 'dot': True}}


def records_work(routing):
    """The records' least work: no operations; bytes the two orders (8
    an edge, 8 a slot), flat, basis and receivers (12 a slot, 8 an edge)
    and both offset lists (8 a row) read, both record sets (16 a slot)
    and the int32 offsets (4 a row) written."""
    B, E, A = routing.flat.shape
    n_off = routing.receiver_csr()[1].numel() + routing.slot_csr()[1].numel()
    return {'kernel': 'spline_records', 'flops': 0.0,
            'bytes': 16.0 * B * E + 36.0 * B * E * A + 12.0 * n_off,
            'out_bytes': 16.0 * B * E * A + 4.0 * n_off, 'dot': False}


def _route_work(t, basis, routing):
    return route_work(basis, routing, t.shape[-1], t.element_size())


def _d_t_work(g, basis, routing):
    return _route_work(g, basis, routing)['bwd']


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

    def records(self, basis):
        """``(edge_records, edge_offsets, slot_records, slot_offsets)``,
        what the two kernels read (see :func:`build_records`), built once
        per routing and ``basis`` tensor (its storage, version and shape),
        like the CSR lists. Holding ``basis`` keeps its storage (and so
        the key) its own."""
        key = (basis.data_ptr(), basis._version, tuple(basis.shape))
        if self._records is None or self._records[0] != key:
            self._records = (key, basis, build_records(self, basis))
        return self._records[2]

    def edge_records(self, basis):
        """``(records, offsets)`` that the forward kernel reads."""
        return self.records(basis)[:2]

    def slot_records(self, basis):
        """``(records, offsets)`` that the ``d_t`` kernel reads."""
        return self.records(basis)[2:]


def plain_slot_records(routing, basis):
    """The plain version of :func:`build_records`' slot records and
    offsets."""
    order, offsets = routing.slot_csr()
    E, A = routing.flat.shape[1:]
    edge = order // A
    node = (edge // E) * routing.num_nodes + routing.receivers.reshape(
        -1)[edge]
    weight = basis.detach().reshape(-1).to(torch.float32)[order]
    records = torch.stack([node.to(torch.int32), weight.view(torch.int32)],
                          dim=1)
    return records, offsets.to(torch.int32)


def plain_edge_records(routing, basis):
    """The plain version of :func:`build_records`' edge records and
    offsets."""
    order, offsets = routing.receiver_csr()
    B, E, A = routing.flat.shape
    row = ((order // E)[:, None] * routing.num_rows
           + routing.flat.reshape(B * E, A)[order])
    weight = basis.detach().reshape(B * E, A).to(torch.float32)[order]
    records = torch.stack([row.to(torch.int32), weight.view(torch.int32)],
                          dim=-1).reshape(B * E * A, 2)
    return records, (offsets * A).to(torch.int32)


@dispatch.kernel_wrapper('spline_records')
@dispatch.counted('spline_records', lambda routing, basis:
                  records_work(routing))
def build_records(routing, basis):
    """``(edge_records, edge_offsets, slot_records, slot_offsets)``, one
    record of two 32-bit words per (edge, a) slot in each list (``[B*E*A,
    2]`` int32, masked edges last, never read), with int32 offsets:

    - the forward's edge records, edges in the order of
      :meth:`Routing.receiver_csr` and each edge's A slots in order: the
      row of ``t`` in the flattened batch ``b*M + flat[b, e, a]`` and the
      weight ``basis[b, e, a]`` (float32 bits); node ``(b, n)`` owns
      slots ``edge_offsets[b*N+n] : edge_offsets[b*N+n+1]`` (A times the
      receiver CSR offsets);
    - the ``d_t`` kernel's slot records, in the order of
      :meth:`Routing.slot_csr`: the receiver node of the flattened batch
      ``b*N + receivers[b, e]`` and the same weight bits; ``slot_offsets``
      are the slot CSR's row offsets.

    One launch of the ``records`` kernel on the card (uncached;
    :meth:`Routing.records` caches it), :func:`plain_edge_records` and
    :func:`plain_slot_records` on the CPU."""
    dev = _check(basis, basis, routing, 'spline_records')
    B, E, A = routing.flat.shape
    M = routing.num_rows
    if max(B * E * A, B * M) >= 2 ** 31:
        raise ValueError(f'{B * E * A} slots over {B * M} rows exceed the '
                         f'int32 records of the spline kernels')
    if dev.type == 'cpu':
        dispatch.record('spline_records', 'plain', 'device=cpu',
                        basis.dtype)
        return (*plain_edge_records(routing, basis),
                *plain_slot_records(routing, basis))
    dispatch.record('spline_records', 'kernel', 'auto-cuda', basis.dtype)
    rcv_order, rcv_off = routing.receiver_csr()
    slot_order, slot_off = routing.slot_csr()
    basis = basis.detach().contiguous()
    edge_rec = torch.empty((B * E * A, 2), dtype=torch.int32, device=dev)
    slot_rec = torch.empty((B * E * A, 2), dtype=torch.int32, device=dev)
    edge_off = torch.empty(rcv_off.shape, dtype=torch.int32, device=dev)
    row_off = torch.empty(slot_off.shape, dtype=torch.int32, device=dev)
    err = _library().dgmc_spline_records(
        rcv_order.data_ptr(), slot_order.data_ptr(), routing.flat.data_ptr(),
        routing.receivers.data_ptr(), basis.data_ptr(), rcv_off.data_ptr(),
        slot_off.data_ptr(), edge_rec.data_ptr(), edge_off.data_ptr(),
        slot_rec.data_ptr(), row_off.data_ptr(), B * E * A, rcv_off.numel(),
        slot_off.numel(), E, A, routing.num_nodes, M, *_stream(dev))
    if err != 0:
        raise RuntimeError(f'spline_records kernel launch failed with CUDA '
                           f'error {err} (B={B}, E={E}, A={A})')
    build_records.launches += 1
    return edge_rec, edge_off, slot_rec, row_off


def _acc(dtype):
    """The dtype the sums run in: float32, or wider inputs' own."""
    return torch.promote_types(dtype, torch.float32)


@dispatch.counted('route_aggregate', _route_work)
def plain_route_aggregate(t, basis, routing):
    """The plain version of the forward: gather the ``A`` rows of every
    edge, blend them with ``basis``, masked mean over each receiver's
    edges, in (at least) float32, rounded to ``t``'s dtype once
    (differentiable by autograd)."""
    B, M, O = t.shape
    E, A = routing.flat.shape[1:]
    acc = _acc(t.dtype)
    picked = torch.gather(
        t.to(acc), 1, routing.flat.reshape(B, E * A, 1).expand(-1, -1, O))
    msgs = torch.einsum('bea,beao->beo', basis.to(acc),
                        picked.reshape(B, E, A, O))
    return scatter_to_nodes(msgs, routing.receivers, routing.edge_mask,
                            routing.num_nodes, aggr='mean').to(t.dtype)


def _g_norm(g, routing):
    """``g / max(deg, 1)`` per receiver node."""
    _, offsets = routing.receiver_csr()
    B, N = g.shape[0], routing.num_nodes
    deg = (offsets[1:] - offsets[:-1])[:B * N].to(g.dtype)
    return g / deg.clamp(min=1.0).reshape(B, N, 1)


@dispatch.counted('spline_route_bwd', _d_t_work)
def plain_route_d_t(g, basis, routing):
    """The plain version of the backward w.r.t. ``t``: ``g [B, N, O]`` →
    ``d_t [B, M, O]``, each slot's ``basis * g[rcv] / deg`` summed into
    its ``flat`` row in slot order, in (at least) float32, rounded to
    ``g``'s dtype once."""
    B, E, A = routing.flat.shape
    O = g.shape[-1]
    acc = _acc(g.dtype)
    gn = _g_norm(g.to(acc), routing)
    rows = torch.gather(gn, 1, routing.receivers[..., None].expand(-1, -1,
                                                                    O))
    contrib = basis.to(acc)[..., None] * rows[:, :, None, :]
    mask = routing.edge_mask[..., None].expand(B, E, A).reshape(B, E * A)
    return scatter_to_nodes(contrib.reshape(B, E * A, O),
                            routing.flat.reshape(B, E * A), mask,
                            routing.num_rows, aggr='sum').to(g.dtype)


def _d_basis(g, t, routing):
    """Gradient w.r.t. ``basis`` (plain PyTorch, in at least float32):
    ``mask_e * sum_o (g/deg)[b, rcv_e, o] * t[b, flat[b, e, a], o]``."""
    B, E, A = routing.flat.shape
    O = g.shape[-1]
    acc = _acc(g.dtype)
    g, t = g.to(acc), t.to(acc)
    gn = _g_norm(g, routing)
    rows = torch.gather(gn, 1, routing.receivers[..., None].expand(-1, -1,
                                                                    O))
    picked = torch.gather(
        t, 1, routing.flat.reshape(B, E * A, 1).expand(-1, -1, O))
    d = torch.einsum('beo,beao->bea', rows, picked.reshape(B, E, A, O))
    return d * routing.edge_mask[..., None].to(d.dtype)


#: The kernels' entry points for each dtype of ``t`` (forward) and ``g``
#: (``d_t``) they take.
_FWD = {torch.float32: 'dgmc_spline_route_fwd_f32',
        torch.bfloat16: 'dgmc_spline_route_fwd_bf16'}
_DT = {torch.float32: 'dgmc_spline_route_dt_f32',
       torch.bfloat16: 'dgmc_spline_route_dt_bf16'}


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('spline.cu')
    if not getattr(lib, 'spline_bound', False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in _FWD.values():
            getattr(lib, fn).argtypes = [p] * 4 + [i, i, ll, i, i, i, p]
        for fn in _DT.values():
            getattr(lib, fn).argtypes = [p] * 6 + [i, i, ll, i, i, p]
        lib.dgmc_spline_records.argtypes = [p] * 11 + [ll] * 3 + [i] * 3 + [
            ll, i, p]
        for fn in (*_FWD.values(), *_DT.values(), 'dgmc_spline_records'):
            getattr(lib, fn).restype = ctypes.c_int
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
    if dev.type == 'cuda' and (t_or_g.dtype not in _FWD
                               or basis.dtype != torch.float32):
        raise TypeError(f'the {name} kernel takes float32 or bfloat16 '
                        f'rows and float32 basis weights; got '
                        f'{t_or_g.dtype} / {basis.dtype}')
    if tuple(basis.shape) != tuple(routing.flat.shape):
        raise ValueError(f'basis {tuple(basis.shape)} and flat '
                         f'{tuple(routing.flat.shape)} differ in shape')
    return dev


def _stream(device):
    s = torch.cuda.current_stream(device)
    return s.device_index, s.cuda_stream


@dispatch.kernel_wrapper('spline_route_fwd')
@dispatch.counted('spline_route_fwd', _route_work)
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
        dispatch.record('spline_route_fwd', 'plain', 'device=cpu', t.dtype)
        return plain_route_aggregate(t, basis, routing)
    dispatch.record('spline_route_fwd', 'kernel', 'auto-cuda', t.dtype)
    lib = _library()
    N, A = routing.num_nodes, routing.flat.shape[2]
    records, offsets = routing.edge_records(basis)
    t = t.contiguous()
    out = torch.empty((B, N, O), dtype=t.dtype, device=dev)
    err = getattr(lib, _FWD[t.dtype])(
        t.data_ptr(), records.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        B, N, M, O, A, *_stream(dev))
    if err != 0:
        raise RuntimeError(f'spline_route_fwd kernel launch failed with CUDA '
                           f'error {err} (B={B}, N={N}, M={M}, O={O}, A={A}, '
                           f'{t.dtype})')
    route_fwd.launches += 1
    return out


@dispatch.kernel_wrapper('spline_route_bwd')
@dispatch.counted('spline_route_bwd')
def route_d_t(g, basis, routing):
    """Backward routing w.r.t. ``t``: ``g [B, N, O]`` → ``[B, M, O]``."""
    dev = _check(g, basis, routing, 'spline_route_bwd')
    B, N, O = g.shape
    if N != routing.num_nodes:
        raise ValueError(f'g has {N} nodes per graph, the routing '
                         f'{routing.num_nodes}')
    g, basis = g.detach(), basis.detach()
    if dev.type == 'cpu':
        dispatch.record('spline_route_bwd', 'plain', 'device=cpu', g.dtype)
        return plain_route_d_t(g, basis, routing)
    dispatch.record('spline_route_bwd', 'kernel', 'auto-cuda', g.dtype)
    lib = _library()
    M = routing.num_rows
    records, offsets = routing.slot_records(basis)
    _, rcv_offsets = routing.receiver_csr()
    g = g.contiguous()
    # scratch: g / max(deg, 1) in float32 under either dtype of g
    g_norm = torch.empty(g.shape, dtype=torch.float32, device=dev)
    d_t = torch.empty((B, M, O), dtype=g.dtype, device=dev)
    err = getattr(lib, _DT[g.dtype])(
        g.data_ptr(), records.data_ptr(), offsets.data_ptr(),
        rcv_offsets.data_ptr(), g_norm.data_ptr(), d_t.data_ptr(), B, N, M,
        O, *_stream(dev))
    if err != 0:
        raise RuntimeError(f'spline_route_bwd kernel launch failed with CUDA '
                           f'error {err} (B={B}, N={N}, M={M}, O={O}, '
                           f'{g.dtype})')
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


@dispatch.counted('route_aggregate')
def route_aggregate(t, basis, routing):
    """Masked-mean aggregation of basis-blended ``t`` rows, differentiable
    in ``t`` (the :func:`route_d_t` kernel) and in ``basis`` (plain
    PyTorch, only when asked for)."""
    return _RouteAggregate.apply(t, basis, routing)
