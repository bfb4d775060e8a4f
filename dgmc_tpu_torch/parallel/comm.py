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

:func:`all_reduce_sum` is differentiable: its backward all-reduces the
gradient over the same group. That is the rule for a sum whose result is
replicated while each rank's loss covers its own rows: each rank's
gradient of the replicated result holds its own rows' part, and the
contributions' gradient is the sum of the parts.

Each call marks itself on an active tape recorder
(:class:`~dgmc_tpu_torch.analysis.trace_rules.TapeRecorder`, through
``dispatch.tape``) as one op, as a kernel entry marks its launch: its
kind in JAX's spelling (``all-reduce``, ``all-gather``,
``collective-broadcast``), the group's ranks, the dtype and shape of the
tensor as the caller holds it, the payload bytes as JAX counts them (the
result's: the gathered tensor for an all-gather) and the tensors it reads
and writes. The ops the call runs itself (the host staging, the c10d
op) go unrecorded and uncounted by the work counter, so one program's
tape reads the same under NCCL and under gloo.
"""

import contextlib

import torch
import torch.distributed as dist

from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['backend_of', 'staged', 'group_ranks', 'all_reduce_',
           'all_reduce_sum', 'all_gather', 'broadcast_']


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
def _marked(kind, group, tensor, nbytes=None):
    """Run one collective's body unrecorded and uncounted, then mark it
    on the active tape (see the module docstring). The block sets
    ``box[0]`` to the call's result (``tensor`` itself for an in-place
    one)."""
    box = [tensor]
    rec, counter = dispatch.tape, dispatch.counter
    if rec is None and counter is None:
        yield box
        return
    if counter is not None:
        counter.suppress += 1
    try:
        with (rec.hidden() if rec is not None
              else contextlib.nullcontext()):
            yield box
    finally:
        if counter is not None:
            counter.suppress -= 1
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
