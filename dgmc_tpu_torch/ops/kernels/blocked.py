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

The routed sums of the sparse correspondence
(:mod:`~dgmc_tpu_torch.ops.corr_route`) run through the same kernel's
second entry, ``dgmc_blocked_route``: the table has its own row count
(``M_tab``: ``N_s`` rows for the indicator projection, ``N_s * K`` for
the candidate gather's backward, against ``n_t`` output rows), and the
projection multiplies each row by a float32 ``row_scale [B, N_s * K]``
aligned with ``row_src`` (the correspondence ``S`` at the route's order),
as a rounded multiply and a rounded add (bf16 rows: the scale and the
product rounded to bf16, as JAX's ``_routed`` multiplies in the rows'
dtype), so that the scaled
:func:`~dgmc_tpu_torch.ops.blocked.ordered_aggregate` is its bit-for-bit
reference. Its wrappers :func:`route_project` and
:func:`route_gather_bwd` (counters ``corr_project``, ``corr_gather_bwd``)
dispatch as :func:`aggregate` does; the unscaled entry and its launch
plan are unchanged.

:func:`aggregate`'s ``rows=(lo, hi)`` sums a rank's row block of a
graph whose node rows are split over ranks
(:func:`~dgmc_tpu_torch.ops.blocked.adj_matmul_rows`): the output rows
``[lo, hi)`` from the whole ``h`` (``row_ptr`` the whole table's
pointers from row ``lo``, :func:`~dgmc_tpu_torch.ops.blocked.row_slice`:
the kernel reads each row's sources at the offsets the pointers hold, so
the first need not be 0), or, with ``sources``, every output row over the
entries whose source lies in the block (``h`` the block's rows,
:func:`~dgmc_tpu_torch.ops.blocked.owned_rows`). On the card both launch
the routed entry unscaled (its table and output row counts differ), in
each row's own order, so that
:func:`~dgmc_tpu_torch.ops.blocked.ordered_aggregate` over the same
tables is their bit-for-bit reference; on the CPU the plain version runs
on the whole table (the output rows cut, or the block's rows placed in a
zero table), the whole aggregation's values at those rows.

:func:`blocked_work` is the aggregation's least work on one table (the
work counter's count in :mod:`~dgmc_tpu_torch.obs.cost` and
``chip_smoke.py``'s bound), the same whichever path runs;
:func:`route_work` the routed sums'.
"""

import ctypes

import torch

from dgmc_tpu_torch.ops import blocked as blocked_ops
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['WARPS', 'UNROLL', 'VECTORS_PER_LANE', 'launch_plan',
           'aggregate', 'launch', 'blocked_work', 'rows_work', 'route_work',
           'route_project', 'route_gather_bwd', 'launch_route']


def blocked_work(blocks, C, elem):
    """The least work of one aggregation over ``blocks`` whatever
    implements it: an add per real edge and channel; the h table read once
    (``elem`` bytes a value), the float32 output written once, the E real
    edges' int32 sources read once. Reads the edge mask's sum."""
    B, M = blocks.row_ptr.shape[0], blocks.row_ptr.shape[1] - 1
    E = float(blocks.mask.sum())
    return {'kernel': 'blocked', 'flops': E * C,
            'bytes': float(B * M * C * (elem + 4)) + 4.0 * E,
            'out_bytes': 4.0 * B * M * C, 'dot': False}


def call_work(h, blocks, rows=None, sources=False):
    """:func:`blocked_work` of one call on rows ``h`` (:func:`rows_work`
    with ``rows``)."""
    if rows is not None:
        return rows_work(h, blocks, *rows, sources)
    x_dtype = blocked_ops.operand_dtype(h.dtype, h.shape[-1],
                                        blocks.gather_dtype)
    return blocked_work(blocks, h.shape[-1],
                        torch.empty((), dtype=x_dtype).element_size())


def rows_work(h, blocks, lo, hi, sources):
    """The least work of a row block's aggregation (:func:`aggregate`
    with ``rows=(lo, hi)``): an add per entry summed and channel (the
    block's rows' entries forward; with ``sources`` the entries whose
    source is in the block), the rows ``h`` read once, the float32 output
    rows written once, the entries' int32 sources read once. Reads the
    table's pointers on the host."""
    B, M, C = h.shape
    ptr = blocks.row_ptr.long()
    N = ptr.shape[1] - 1
    if sources:
        src = blocks.row_src
        pos = torch.arange(src.shape[1], device=src.device)[None]
        E = float(((pos < ptr[:, -1:]) & (src >= lo) & (src < hi)).sum())
        out_rows = N
    else:
        E = float((ptr[:, min(hi, N)] - ptr[:, min(lo, N)]).sum())
        out_rows = hi - lo
    elem = torch.empty((), dtype=blocked_ops.operand_dtype(
        h.dtype, C, blocks.gather_dtype)).element_size()
    return {'kernel': 'blocked', 'flops': E * C,
            'bytes': float(B * M * C * elem + B * out_rows * C * 4)
            + 4.0 * E, 'out_bytes': 4.0 * B * out_rows * C, 'dot': False}

def route_work(kernel, B, M_tab, M_out, E, C, elem, scaled):
    """The least work of one routed sum whatever implements it: an add
    per entry and channel (and a multiply where ``scaled``); the
    ``[B, M_tab, C]`` table read once (``elem`` bytes a value), the
    float32 ``[B, M_out, C]`` output written once, the ``E`` entries'
    int32 rows (and float32 scales) read once."""
    per = 2 if scaled else 1
    return {'kernel': kernel, 'flops': float(per * E * C),
            'bytes': float(B * (M_tab * C * elem + M_out * C * 4))
            + 4.0 * per * E,
            'out_bytes': 4.0 * B * M_out * C, 'dot': False}


def _rows_elem(h):
    return torch.empty((), dtype=blocked_ops.operand_dtype(
        h.dtype, h.shape[-1], None)).element_size()


def project_work(r_s, S, route):
    """:func:`route_work` of :func:`route_project`."""
    B, N_s, C = r_s.shape
    return route_work('corr_project', B, N_s, route.n_t,
                      route.row_src.numel(), C, _rows_elem(r_s), True)


def gather_bwd_work(g, route):
    """:func:`route_work` of :func:`route_gather_bwd`."""
    B, E, C = g.shape
    return route_work('corr_gather_bwd', B, E, route.n_t, B * E, C,
                      _rows_elem(g), False)


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
        lib.dgmc_blocked_route.argtypes = [p, i] + [p] * 4 + [i] * 6 + [p]
        lib.dgmc_blocked_route.restype = i
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


def _rows_tables(blocks, rows, sources):
    """The row table a row block's call reads (see the module
    docstring)."""
    lo, hi = rows
    return (blocked_ops.owned_rows(blocks, lo, hi) if sources
            else blocked_ops.row_slice(blocks, lo, hi))


def _plain_rows(h, blocks, rows, sources):
    """The plain version of a row block's call: the whole table's
    aggregation, its rows ``[lo, hi)`` cut (zero past ``N``), or, with
    ``sources``, over the block's rows placed in a zero table."""
    lo, hi = rows
    B, _, C = h.shape
    N = blocks.row_ptr.shape[1] - 1
    if sources:
        whole = h.new_zeros((B, max(N, hi), C))
        whole[:, lo:hi] = h
        return blocked_ops.plain_aggregate(whole[:, :N], blocks)
    out = blocked_ops.plain_aggregate(h, blocks)
    if hi > N:
        out = torch.cat([out, out.new_zeros((B, hi - N, C))], dim=1)
    return out[:, lo:hi]


@dispatch.kernel_wrapper('blocked')
@dispatch.counted('blocked', call_work)
def aggregate(h, blocks, rows=None, sources=False):
    """``out[b, n] = Σ_{e: dst=n} h[b, src_e]`` over ``blocks`` →
    ``[B, M, C]`` in ``promote(h, float32)`` (see the module
    docstring). ``rows=(lo, hi)``: a row block's call, the output rows
    ``[lo, hi)`` of the whole ``h``, or with ``sources`` every output row
    over the entries whose source is in the block, ``h`` its
    ``hi - lo`` rows. Carries no gradient itself:
    :func:`~dgmc_tpu_torch.ops.blocked.adj_matmul` and
    :func:`~dgmc_tpu_torch.ops.blocked.adj_matmul_rows` are the
    differentiable forms."""
    if rows is None or not sources:
        _check(h, blocks)
    h = h.detach()
    if h.device.type == 'cpu':
        dispatch.record('blocked', 'plain', 'device=cpu',
                        blocked_ops.operand_dtype(h.dtype, h.shape[-1],
                                                  blocks.gather_dtype))
        if rows is not None:
            return _plain_rows(h, blocks, rows, sources)
        return blocked_ops.plain_aggregate(h, blocks)
    if h.device.type != 'cuda':
        raise ValueError(f'blocked aggregation runs on cpu or cuda, not '
                         f'{h.device.type}')
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the blocked kernel takes float32 or bfloat16 '
                        f'rows; got {h.dtype}')
    x = blocked_ops.operand(h, blocks.gather_dtype)
    dispatch.record('blocked', 'kernel', 'auto-cuda', x.dtype)
    if rows is None:
        out = launch(x, blocks)
    else:
        table = _rows_tables(blocks, rows, sources)
        out = launch_route(x, table.row_ptr, table.row_src)
    aggregate.launches += 1
    return out


def launch_route(x, row_ptr, row_src, scale=None):
    """One launch of the routed entry on CUDA rows ``x [B, M_tab, C]``
    (float32 or bf16, as :func:`~dgmc_tpu_torch.ops.blocked.operand`
    gives them), the row table ``row_ptr [B, M_out + 1]`` /
    ``row_src [B, E]`` (int32 rows of ``x``) and an optional float32
    ``scale [B, E]`` (already rounded to the rows' dtype) →
    ``[B, M_out, C]`` float32; counts nothing (timing)."""
    B, M_tab, C = x.shape
    x = x.contiguous()
    ptr, src = row_ptr.contiguous(), row_src.contiguous()
    if ptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError('the route\'s row table (row_ptr, row_src) must be '
                        'int32')
    if (src.dim() != 2 or src.shape[0] != B or src.shape[1] < 1
            or ptr.shape[0] != B):
        raise ValueError(f'row table {tuple(ptr.shape)} / '
                         f'{tuple(src.shape)} does not match rows of '
                         f'{tuple(x.shape)}')
    if scale is not None:
        scale = scale.contiguous()
        if scale.dtype != torch.float32 or scale.shape != src.shape:
            raise ValueError(f'row_scale must be float32 '
                             f'{tuple(src.shape)}; got {scale.dtype} '
                             f'{tuple(scale.shape)}')
    M_out = ptr.shape[1] - 1
    out = torch.empty((B, M_out, C), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    err = _library().dgmc_blocked_route(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptr.data_ptr(),
        src.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), B, M_out, M_tab, src.shape[1], C,
        stream.device_index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'routed blocked kernel launch failed with CUDA '
                           f'error {err} (B={B}, M_out={M_out}, '
                           f'M_tab={M_tab}, C={C}, E={src.shape[1]}, '
                           f'{x.dtype}, scaled={scale is not None})')
    return out


def _route_rows(name, h, tensors):
    """The rows a routed sum reads, after the device checks: the plain
    version's decision recorded and ``None`` for a CPU tensor."""
    if h.dim() != 3:
        raise ValueError(f'{name} wants a table [B, M, C]; got '
                         f'{tuple(h.shape)}')
    devs = {t.device for t in tensors} | {h.device}
    if len(devs) != 1:
        raise ValueError(f'{name} inputs lie on several devices: '
                         f'{sorted(map(str, devs))}')
    x_dtype = blocked_ops.operand_dtype(h.dtype, h.shape[-1], None)
    if h.device.type == 'cpu':
        dispatch.record(name, 'plain', 'device=cpu', x_dtype)
        return None
    if h.device.type != 'cuda':
        raise ValueError(f'{name} runs on cpu or cuda, not '
                         f'{h.device.type}')
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the routed kernel takes float32 or bfloat16 '
                        f'rows; got {h.dtype}')
    dispatch.record(name, 'kernel', 'auto-cuda', x_dtype)
    return blocked_ops.operand(h, None)


@dispatch.kernel_wrapper('corr_project')
@dispatch.counted('corr_project', project_work)
def route_project(r_s, S, route):
    """``r_t[b, t] = Σ_{s,k: S_idx[b,s,k] = t} S[b,s,k] * r_s[b,s]`` over a
    :class:`~dgmc_tpu_torch.ops.corr_route.CorrRoute` → ``[B, n_t, C]``
    float32: the plain version (JAX's scaled ``_routed``) for a CPU
    tensor, the scaled kernel for a CUDA one. No gradient of its own
    (:func:`~dgmc_tpu_torch.ops.corr_route.sparse_project` is the
    differentiable form)."""
    r_s, S = r_s.detach(), S.detach()
    x = _route_rows('corr_project', r_s, route.tensors() + [S])
    if x is None:
        return route.plain_sum(r_s, 'src', route.block_scale(S))
    out = launch_route(x, route.row_ptr, route.row_src,
                       route.row_scale(S, x.dtype))
    route_project.launches += 1
    return out


@dispatch.kernel_wrapper('corr_gather_bwd')
@dispatch.counted('corr_gather_bwd', gather_bwd_work)
def route_gather_bwd(g, route):
    """The candidate gather's transpose, ``out[b, t] = Σ_{e: S_idx_e = t}
    g[b, e]`` for ``g [B, N_s * K, C]`` over a route → ``[B, n_t, C]``
    float32: the plain version for a CPU tensor, the unscaled routed
    kernel (an ``N_s * K``-row table) for a CUDA one."""
    g = g.detach()
    x = _route_rows('corr_gather_bwd', g, route.tensors())
    if x is None:
        return route.plain_sum(g, 'ent')
    out = launch_route(x, route.row_ptr, route.row_ent)
    route_gather_bwd.launches += 1
    return out
