"""Blocked edge→node aggregation: CUDA kernel and plain versions.

The kernel (``csrc/blocked.cu``) sums ``out[b, n] = Σ_{e: dst=n}
h[b, src_e]`` from the row table of
:class:`~dgmc_tpu_torch.ops.blocked.EdgeBlocks` (``row_ptr``,
``row_src``: each row's sources in the blocks' order): one output row per
group of lanes (a warp where the row has at least 32 16-byte vectors;
fewer lanes, several rows a warp, at narrow C), 16-byte loads across the
channels, the next stage's rows loaded before the current stage's are
added, each (row, channel) summed by one thread into float32 in the
table's order — deterministic, no atomics, no shared memory. It has no
Pallas counterpart: the JAX package computes the same sum as XLA one-hot
einsums (``dgmc_tpu/ops/blocked.py:148-218``), which is the plain version
of record here (:func:`~dgmc_tpu_torch.ops.blocked.plain_aggregate`);
:func:`~dgmc_tpu_torch.ops.blocked.ordered_aggregate` rounds exactly as
the kernel does.

:func:`aggregate` is the wrapper: a CPU tensor takes the plain version; a
CUDA tensor of float32 or bfloat16 launches the kernel on the rows
:func:`~dgmc_tpu_torch.ops.blocked.operand` selects (float32, or bf16
under ``gather_dtype`` where the rows stay >= 512 bytes), and any other
dtype raises. The output is float32 (``promote(h, float32)``), as the
plain version's.

:func:`blocked_work` is the aggregation's least work on one table (the
work counter's count in :mod:`~dgmc_tpu_torch.obs.cost` and
``chip_smoke.py``'s bound), the same whichever path runs.
"""

import ctypes

import torch

from dgmc_tpu_torch.ops import blocked as blocked_ops
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['WARPS', 'UNROLL', 'VECTORS_PER_LANE', 'launch_plan',
           'aggregate', 'launch', 'blocked_work']


def blocked_work(blocks, C, elem):
    """The least work of one aggregation over ``blocks`` whatever
    implements it: an add per real edge and channel; the h table read once
    (``elem`` bytes a value), the float32 output written once, the E real
    edges' int32 sources read once. Reads the edge mask's sum."""
    B, M = blocks.inv_degree.shape[:2]
    E = float(blocks.mask.sum())
    return {'kernel': 'blocked', 'flops': E * C,
            'bytes': float(B * M * C * (elem + 4)) + 4.0 * E,
            'out_bytes': 4.0 * B * M * C, 'dot': False}


def call_work(h, blocks):
    """:func:`blocked_work` of one call on rows ``h``."""
    x_dtype = blocked_ops.operand_dtype(h.dtype, h.shape[-1],
                                        blocks.gather_dtype)
    return blocked_work(blocks, h.shape[-1],
                        torch.empty((), dtype=x_dtype).element_size())

#: Warps a block of threads, edges a lane group loads per stage (two
#: stages in flight; also the fewest lanes a row), 16-byte vectors a lane
#: holds per row and channel tile at most (checked against the compiled
#: library at load).
WARPS = 8
UNROLL = 4
VECTORS_PER_LANE = 4


def launch_plan(M, C, itemsize, address=0):
    """The kernel's launch for ``M`` rows of ``C`` values of ``itemsize``
    bytes at ``address`` (as ``csrc/blocked.cu`` computes it): ``vw``
    values a load (the widest of 16, 8, 4 bytes or one value that ``C``
    and the address allow), ``lanes`` a row (a power of two from
    :data:`UNROLL` to 32, at least the row's vectors where it can),
    ``tt`` vectors a lane, ``tiles`` channel tiles and ``blocks`` blocks
    of ``32 * WARPS`` threads per batch element."""
    vw = 1
    for w in (16 // itemsize, 8 // itemsize, 4 // itemsize):
        if w > 1 and C % w == 0 and address % (w * itemsize) == 0:
            vw = w
            break
    vectors = C // vw
    lanes = UNROLL
    while lanes < 32 and lanes < vectors:
        lanes *= 2
    tt = min(-(-vectors // lanes), VECTORS_PER_LANE)
    rows_per_block = WARPS * 32 // lanes
    return {'vw': vw, 'lanes': lanes, 'tt': tt,
            'tiles': -(-vectors // (lanes * tt)),
            'blocks': -(-M // rows_per_block)}


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('blocked.cu')
    if not getattr(lib, 'blocked_bound', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dgmc_blocked_aggregate.argtypes = ([p, i] + [p] * 3 + [i] * 5
                                               + [p])
        lib.dgmc_blocked_aggregate.restype = i
        names = ('dgmc_blocked_warps', 'dgmc_blocked_unroll',
                 'dgmc_blocked_vectors_per_lane')
        for name in names:
            getattr(lib, name).restype = i
        got = tuple(getattr(lib, name)() for name in names)
        want = (WARPS, UNROLL, VECTORS_PER_LANE)
        if got != want:
            raise RuntimeError(f'csrc/blocked.cu launch constants {got} '
                               f'differ from the wrapper\'s {want}')
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
    if (tuple(blocks.inv_degree.shape[:2]) != (B, M)
            or tuple(blocks.row_ptr.shape) != (B, M + 1)):
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
    x = x.contiguous()
    ptr, src = blocks.row_ptr.contiguous(), blocks.row_src.contiguous()
    if ptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError('the blocked row table (row_ptr, row_src) must be '
                        'int32')
    if src.dim() != 2 or src.shape[0] != B or src.shape[1] < 1:
        raise ValueError(f'row_src of {tuple(src.shape)} does not match h '
                         f'of {tuple(x.shape)}')
    out = torch.empty((B, M, C), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    err = _library().dgmc_blocked_aggregate(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptr.data_ptr(),
        src.data_ptr(), out.data_ptr(), B, M, src.shape[1], C,
        stream.device_index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'blocked kernel launch failed with CUDA error '
                           f'{err} (B={B}, M={M}, C={C}, '
                           f'E_max={src.shape[1]}, {x.dtype})')
    return out


@dispatch.kernel_wrapper('blocked')
@dispatch.counted('blocked', call_work)
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
