"""The cross-rank sums, gathers and broadcasts of the sharded paths.

Each function takes a process group (a mesh axis's,
:meth:`~dgmc_tpu_torch.parallel.mesh.Mesh.group`); ``None`` means one
process and no communication. NCCL moves CUDA tensors itself. Gloo moves
CPU tensors, and of CUDA tensors only some operations (no all-gather),
so under gloo a CUDA tensor is staged through the host: copied to a CPU
tensor, communicated, copied back. That is how two ranks
that share one card communicate (NCCL refuses two ranks on one device).
Each call records its route in the dispatch ledger under ``collective``:
``device`` (NCCL on the card's memory) or ``host`` (gloo, with the reason
``gloo, cuda tensors staged`` or ``gloo, cpu tensors``).

:func:`collective_permute` (JAX's ``ppermute`` by one place around the
group) sends this rank's tensors to its right neighbour and receives its
left neighbour's without blocking: it returns a :class:`Permute` handle
whose :meth:`~Permute.wait` gives the received tensors, so that the
caller can issue a transfer and compute before it needs the result
(NCCL: ``batch_isend_irecv``; gloo: ``isend`` / ``irecv`` of host
copies).

:func:`all_gather_grad` is the differentiable all-gather of row blocks
(each rank's rows of a tensor computed row-restricted): its backward
(:func:`reduce_scatter_rows`, an all-to-all of the blocks) gives each
rank the sum over the ranks of the gradient at its own rows, added in
the group's rank order (rank 0's part first) on both backends, so that
the result is the same under NCCL and gloo.

:func:`all_reduce_sum` is differentiable: its backward all-reduces the
gradient over the same group. That is the rule for a sum whose result is
replicated while each rank's loss covers its own rows: each rank's
gradient of the replicated result holds its own rows' part, and the
contributions' gradient is the sum of the parts.

Each call marks itself on an active tape recorder
(:class:`~dgmc_tpu_torch.analysis.trace_rules.TapeRecorder`, through
``dispatch.tape``) as one op, as a kernel entry marks its launch: its
kind in JAX's spelling (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``collective-broadcast``, ``collective-permute``),
the group's ranks, the dtype and shape of the tensor as the caller holds
it, the payload bytes as JAX counts them (the result's: the gathered
tensor for an all-gather, the tensors moved for a permute) and the
tensors it reads and writes; a permute is marked as an asynchronous
start and a ``wait`` at :meth:`Permute.wait`. The ops the call runs
itself (the host staging, the c10d op) go unrecorded and uncounted by
the work counter, so one program's tape reads the same under NCCL and
under gloo.
"""

import contextlib

import torch
import torch.distributed as dist

from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['backend_of', 'staged', 'group_ranks', 'all_reduce_',
           'all_reduce_sum', 'all_gather', 'all_gather_grad', 'broadcast_',
           'reduce_scatter_rows', 'collective_permute', 'Permute']


def backend_of(group):
    """The group's backend name (``None`` without a group)."""
    return None if group is None else str(dist.get_backend(group))


def staged(group, tensor):
    """Whether ``tensor`` goes through the host for ``group``: a CUDA
    tensor under gloo."""
    return tensor.is_cuda and backend_of(group) == 'gloo'


def _record(group, tensor):
    if staged(group, tensor):
        dispatch.record('collective', 'host', 'gloo, cuda tensors staged')
    elif tensor.is_cuda:
        dispatch.record('collective', 'device', backend_of(group))
    else:
        dispatch.record('collective', 'host', f'{backend_of(group)}, cpu '
                        f'tensors')


def group_ranks(group):
    """The global ranks of ``group``, in its order."""
    return tuple(dist.get_global_rank(group, i)
                 for i in range(dist.get_world_size(group)))


@contextlib.contextmanager
def _unrecorded():
    """The block's ops go unrecorded on the active tape and uncounted by
    the work counter (a collective's own staging and c10d ops)."""
    rec, counter = dispatch.tape, dispatch.counter
    if counter is not None:
        counter.suppress += 1
    try:
        with (rec.hidden() if rec is not None
              else contextlib.nullcontext()):
            yield
    finally:
        if counter is not None:
            counter.suppress -= 1


@contextlib.contextmanager
def _marked(kind, group, tensor, nbytes=None):
    """Run one collective's body unrecorded and uncounted, then mark it
    on the active tape (see the module docstring). The block sets
    ``box[0]`` to the call's result (``tensor`` itself for an in-place
    one)."""
    box = [tensor]
    rec = dispatch.tape
    with _unrecorded():
        yield box
    out = box[0]
    if rec is not None:
        rec.collective(kind, group_ranks(group), tensor, out,
                       out.numel() * out.element_size()
                       if nbytes is None else nbytes, out is tensor)


def all_reduce_(tensor, group):
    """Sum ``tensor`` over ``group`` in place; returns it."""
    if group is None:
        return tensor
    _record(group, tensor)
    with _marked('all-reduce', group, tensor):
        if staged(group, tensor):
            host = tensor.cpu()
            dist.all_reduce(host, group=group)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor, group=group)
    return tensor


def broadcast_(tensor, group):
    """Overwrite ``tensor`` with the group's first rank's, in place;
    returns it."""
    if group is None:
        return tensor
    _record(group, tensor)
    src = dist.get_global_rank(group, 0)
    with _marked('collective-broadcast', group, tensor):
        if staged(group, tensor):
            host = tensor.cpu()
            dist.broadcast(host, src, group=group)
            tensor.copy_(host)
        else:
            dist.broadcast(tensor, src, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradient over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x, group):
    """``x`` summed over ``group`` (a new tensor), differentiable: the
    backward all-reduces the gradient (see the module docstring)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return all_reduce_(x.clone(), group)


#: Moved bit for bit as an integer type of their width (no arithmetic on
#: the way, and every backend moves these).
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def _to_wire(t, host):
    t = t.cpu() if host else t.contiguous()
    return t.view(_WIRE[t.dtype]) if t.dtype in _WIRE else t


def _from_wire(t, dtype, device):
    t = t.view(dtype) if t.dtype != dtype else t
    return t.to(device) if t.device != device else t


def all_gather(tensor, group, dim=0):
    """Every rank's ``tensor`` (equal shapes), concatenated along ``dim``
    in the group's rank order."""
    if group is None:
        return tensor
    _record(group, tensor)
    n = dist.get_world_size(group)
    with _marked('all-gather', group, tensor) as box:
        src = _to_wire(tensor, staged(group, tensor))
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        box[0] = _from_wire(torch.cat(parts, dim=dim), tensor.dtype,
                            tensor.device)
    return box[0]


def reduce_scatter_rows(x, group, dim=0):
    """This rank's block of ``x`` summed over ``group``: ``x`` splits
    along ``dim`` into one equal block per rank (rank order); rank ``r``
    gets ``Σ_q x_q[block r]``, added in rank order (rank 0's part first)
    on every backend, so the sum is bit-identical under NCCL and gloo.
    Moves each block once (an all-to-all, then the ordered sum); marked
    as one ``reduce-scatter`` (JAX's payload: the result's bytes)."""
    if group is None:
        return x
    _record(group, x)
    n = dist.get_world_size(group)
    with _marked('reduce-scatter', group, x) as box:
        host = staged(group, x)
        src = _to_wire(x.movedim(dim, 0).contiguous(), host)
        parts = torch.empty_like(src)
        dist.all_to_all_single(parts, src, group=group)
        parts = _from_wire(parts, x.dtype, x.device)
        out = None
        for part in parts.chunk(n, dim=0):
            out = part.clone() if out is None else out + part
        box[0] = out.movedim(0, dim)
    return box[0]


class _AllGatherGrad(torch.autograd.Function):
    """All-gather of row blocks; the backward reduce-scatters the
    gradient (:func:`reduce_scatter_rows`)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.group, ctx.dim), None, None


def all_gather_grad(x, group, dim=0):
    """:func:`all_gather`, differentiable: every rank's ``x`` (its block
    of rows along ``dim``, equal shapes) concatenated in rank order; the
    backward gives this rank the sum over the ranks of their gradients at
    its block, ``Σ_r grad_r[block]`` added in rank order (rank 0 first),
    the same on NCCL and gloo (:func:`reduce_scatter_rows`). ``None``
    group: ``x`` itself."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGatherGrad.apply(x, group, dim)
    return all_gather(x, group, dim)


class Permute:
    """An issued :func:`collective_permute`: :meth:`wait` completes it
    and returns the received tensors (a tuple where a tuple was sent)."""

    def __init__(self, reqs, results, copies, start, single):
        self._reqs, self._results, self._copies = reqs, results, copies
        self._start, self._single = start, single
        self._waited = False

    def wait(self):
        if not self._waited:
            self._waited = True
            rec = dispatch.tape
            with _unrecorded():
                for req in self._reqs:
                    req.wait()
                for dst, src in self._copies:
                    dst.copy_(src)
            self._reqs = self._copies = None
            if rec is not None and self._start is not None:
                rec.wait(self._start, self._results)
        return self._results[0] if self._single else self._results


def _wire_view(t):
    return t.view(_WIRE[t.dtype]) if t.dtype in _WIRE else t


def collective_permute(tensors, group, shift=1):
    """Send ``tensors`` (a tensor or a tuple of them) to the rank
    ``shift`` places to the right in ``group``'s order and receive the
    same shapes from the rank ``shift`` places to the left, without
    blocking: returns a :class:`Permute` (``wait()`` gives the received
    tensors). One op a call on the tape, a ``collective-permute`` whose
    payload is the bytes sent. Moved bit for bit (bf16 and bool as
    integers of their width; CUDA tensors under gloo through the host).
    ``None`` group or one rank: the tensors themselves."""
    single = torch.is_tensor(tensors)
    ts = (tensors,) if single else tuple(tensors)
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return Permute((), ts, (), None, single)
    _record(group, ts[0])
    me = dist.get_group_rank(group, dist.get_rank())
    right = dist.get_global_rank(group, (me + shift) % n)
    left = dist.get_global_rank(group, (me - shift) % n)
    host = staged(group, ts[0])
    rec = dispatch.tape
    with _unrecorded():
        results = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                        for t in ts)
        sends = [_to_wire(t, host) for t in ts]
        if host:
            recv = [torch.empty_like(w) for w in sends]
            copies = [(_wire_view(r), w) for r, w in zip(results, recv)]
        else:
            recv, copies = [_wire_view(r) for r in results], []
        if backend_of(group) == 'nccl':
            ops = [dist.P2POp(dist.isend, w, right, group) for w in sends]
            ops += [dist.P2POp(dist.irecv, r, left, group) for r in recv]
            reqs = list(dist.batch_isend_irecv(ops))
        else:
            reqs = [dist.isend(w, right, group=group) for w in sends]
            reqs += [dist.irecv(r, left, group=group) for r in recv]
        # The sent copies live until their transfers complete.
        reqs.append(_Keep(sends))
    start = None
    if rec is not None:
        start = rec.collective(
            'collective-permute', group_ranks(group), ts, results,
            sum(t.numel() * t.element_size() for t in ts), False,
            asynchronous=True)
    return Permute(reqs, results, copies, start, single)


class _Keep:
    """Holds tensors until the transfers that read them complete."""

    def __init__(self, tensors):
        self.tensors = tensors

    def wait(self):
        self.tensors = None
