"""Blocked edge→node aggregation: CUDA kernel and plain version.

The kernel (``csrc/blocked.cu``) sums ``out[b, n] = Σ_{e: dst=n}
h[b, src_e]`` straight from the tables of
:class:`~dgmc_tpu_torch.ops.blocked.EdgeBlocks`: one block of threads per
node range and channel tile, float32 accumulators in shared memory, each
output row summed over its range's blocks in order and each block's edges
in order, by one thread per channel — deterministic, no atomics. It has
no Pallas counterpart: the JAX package computes the same sum as XLA
one-hot einsums (``dgmc_tpu/ops/blocked.py:148-218``), which is the plain
version here (:func:`~dgmc_tpu_torch.ops.blocked.plain_aggregate`).

:func:`aggregate` is the wrapper: a CPU tensor takes the plain version; a
CUDA tensor of float32 or bfloat16 launches the kernel on the rows
:func:`~dgmc_tpu_torch.ops.blocked.operand` selects (float32, or bf16
under ``gather_dtype`` where the rows stay >= 512 bytes), and any other
dtype raises. The output is float32 (``promote(h, float32)``), as the
plain version's.
"""

import ctypes

import torch

from dgmc_tpu_torch.ops import blocked as blocked_ops
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['WARPS', 'GROUP', 'CHANNEL_TILE', 'aggregate', 'launch']

#: Warps a block of threads, edges a warp loads before it adds them, the
#: widest channel tile (32 channels a lane column, at most 4 columns;
#: checked against the compiled library at load).
WARPS = 8
GROUP = 4
CHANNEL_TILE = 128


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('blocked.cu')
    if not getattr(lib, 'blocked_bound', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dgmc_blocked_aggregate.argtypes = ([p, i] + [p] * 5 + [i] * 7
                                               + [i, p])
        lib.dgmc_blocked_aggregate.restype = i
        for name in ('dgmc_blocked_warps', 'dgmc_blocked_group',
                     'dgmc_blocked_channel_tile'):
            getattr(lib, name).restype = i
        got = (lib.dgmc_blocked_warps(), lib.dgmc_blocked_group(),
               lib.dgmc_blocked_channel_tile())
        if got != (WARPS, GROUP, CHANNEL_TILE):
            raise RuntimeError(f'csrc/blocked.cu launch constants {got} '
                               f'differ from the wrapper\'s '
                               f'{(WARPS, GROUP, CHANNEL_TILE)}')
        lib.blocked_bound = True
    return lib


def _check(h, blocks):
    if h.dim() != 3:
        raise ValueError(f'blocked aggregation wants h [B, M, C]; got '
                         f'{tuple(h.shape)}')
    B, M, _ = h.shape
    if blocks.src.dim() != 3 or blocks.src.shape[0] != B:
        raise ValueError(f'blocks of {tuple(blocks.src.shape)} do not match '
                         f'h of {tuple(h.shape)}')
    if tuple(blocks.inv_degree.shape[:2]) != (B, M):
        raise ValueError(f'blocks built for {blocks.inv_degree.shape[1]} '
                         f'nodes; h has {M} rows')
    devs = {t.device for t in blocks.tensors()} | {h.device}
    if len(devs) != 1:
        raise ValueError(f'blocked aggregation inputs lie on several '
                         f'devices: {sorted(map(str, devs))}')


def launch(x, blocks):
    """One launch of the kernel on CUDA rows ``x`` (float32 or bf16, as
    :func:`~dgmc_tpu_torch.ops.blocked.operand` gives them) →
    ``[B, M, C]`` float32; counts nothing (timing)."""
    B, M, C = x.shape
    NB, E_b = blocks.src.shape[1], blocks.src.shape[2]
    x = x.contiguous()
    tabs = [t.contiguous() for t in (blocks.src, blocks.dst_local,
                                     blocks.mask, blocks.range_ptr)]
    if any(t.dtype != want for t, want in zip(
            tabs, (torch.int32, torch.int32, torch.bool, torch.int32))):
        raise TypeError('blocked tables must be int32 (src, dst_local, '
                        'range_ptr) and bool (mask)')
    out = torch.empty((B, M, C), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    err = _library().dgmc_blocked_aggregate(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        *(t.data_ptr() for t in tabs[:3]), tabs[3].data_ptr(),
        out.data_ptr(), B, M, NB, E_b, blocks.num_ranges, blocks.rows, C,
        stream.device_index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'blocked kernel launch failed with CUDA error '
                           f'{err} (B={B}, M={M}, C={C}, NB={NB}, '
                           f'E_b={E_b}, rows={blocks.rows}, {x.dtype})')
    return out


@dispatch.kernel_wrapper('blocked')
def aggregate(h, blocks):
    """``out[b, n] = Σ_{e: dst=n} h[b, src_e]`` over ``blocks`` →
    ``[B, M, C]`` in ``promote(h, float32)`` (see the module
    docstring). Carries no gradient itself:
    :func:`~dgmc_tpu_torch.ops.blocked.adj_matmul` is the differentiable
    form."""
    _check(h, blocks)
    h = h.detach()
    if h.device.type == 'cpu':
        dispatch.record('blocked', 'plain', 'device=cpu',
                        blocked_ops.operand_dtype(h.dtype, h.shape[-1],
                                                  blocks.gather_dtype))
        return blocked_ops.plain_aggregate(h, blocks)
    if h.device.type != 'cuda':
        raise ValueError(f'blocked aggregation runs on cpu or cuda, not '
                         f'{h.device.type}')
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the blocked kernel takes float32 or bfloat16 '
                        f'rows; got {h.dtype}')
    x = blocked_ops.operand(h, blocks.gather_dtype)
    dispatch.record('blocked', 'kernel', 'auto-cuda', x.dtype)
    out = launch(x, blocks)
    aggregate.launches += 1
    return out
