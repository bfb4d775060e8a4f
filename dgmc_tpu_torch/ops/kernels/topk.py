"""Streaming exact top-k of ``h_s @ h_t^T``: CUDA kernels and plain version.

The kernels (``csrc/topk.cu``) replace the JAX package's Pallas TPU
kernel ``dgmc_tpu/ops/pallas/topk.py::_kernel``; see the source for their
designs and bounds. :func:`streaming_topk` is their wrapper:

- a CPU tensor takes :func:`plain_topk`, the blockwise scan in plain
  PyTorch with the same contract;
- a CUDA tensor launches a kernel, float32 or bfloat16 (``h_s`` and
  ``h_t`` in one dtype), or raises on what the kernels do not take (any
  other dtype). :func:`route` picks it from the dtype and shapes alone,
  and the dispatch ledger records its reason:

  - float32: the FMA kernel (``auto-cuda``);
  - bfloat16: the tensor-core tile (``tensor-core``: wgmma on bf16
    operands, TMA, selection from the accumulators), or, for a shape the
    tile does not take, the bf16 FMA kernel, with the reason
    (``fma, C%8!=0``: TMA's 16-byte row stride; ``fma, C>640``: the
    resident h_s stripe; ``fma, k>16``: the tile's carry in registers);
  - ``k > K_MAX``, either dtype: the plain version (``k>128``).

Contract (every path): values descending, lowest target index first
among equal values; masked targets score ``finfo(dtype).min``; the
carry starts at ``-inf``, so when ``k`` exceeds the valid targets the
masked ones fill the tail in index order. The search is selection and
carries no gradient. For bfloat16 inputs (the precision policy's
variant) the products and sums run in float32 and each score is rounded
to bfloat16 before selection, as the JAX package's kernel rounds them
through the input dtype; the values come back in bfloat16.

:func:`topk_work` is the search's work by its contract (the count of the
work counter in :mod:`~dgmc_tpu_torch.obs.cost` and the bound in
``chip_smoke.py``), the same whichever path runs.
"""

import ctypes
import functools
import math

import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.build import sm_count

__all__ = ['BLOCK_OVERHEAD_TILES', 'K_MAX', 'PLAIN_BLOCK',
           'PLAIN_TILE_ELEMS', 'ROW_TILES',
           'TARGETS_PER_TILE', 'TC_BLOCK_OVERHEAD_TILES', 'TC_C_MAX',
           'TC_K_MAX', 'TC_ROWS', 'TC_STAGES', 'SMEM_MAX', 'blocks_per_sm',
           'launch_plan', 'plain_topk', 'route', 'streaming_topk',
           'tc_launch_plan', 'tc_smem_bytes']

#: Largest ``k`` the kernel takes: its per-row carry lives in shared
#: memory (8 bytes x rows per block x k) beside 108 KB of staging slots
#: (72 KB where the carry needs the room), within the 227 KB a block may
#: use. Checked against the compiled library at load.
K_MAX = 128

#: Target block of the plain scan.
PLAIN_BLOCK = 256

#: Elements of the plain scan's largest product tile (64 MB of float32).
PLAIN_TILE_ELEMS = 1 << 24

#: Source rows per block the kernel is built for, and targets per tile
#: (both checked against the compiled library at load).
ROW_TILES = (16, 32, 64, 128)
TARGETS_PER_TILE = 128

#: A block's own cost in tiles (filling the staging ring, its first,
#: candidate-heavy selection, writing its list), as measured on the H100:
#: the whole DBP15K source KG takes 5.62 ms in one segment (118 blocks)
#: and 5.75 ms in ten (1180 blocks, 9 waves), which fits about two.
BLOCK_OVERHEAD_TILES = 2

#: The tensor-core tile (bf16): source rows a block (two warpgroups of
#: 64), ring stages of 64 channels x 128 targets, the largest ``k`` its
#: register carry holds and the largest ``C`` whose h_s stripe stays
#: resident in shared memory. Targets per tile: :data:`TARGETS_PER_TILE`.
#: Checked against the compiled library at load.
TC_ROWS = 128
TC_STAGES = 4
TC_K_MAX = 16
TC_C_MAX = 640

#: A tensor-core block's own cost in tiles (its first tile's candidates,
#: inserted into an empty carry, and the h_s stripe's load): an estimate
#: at C = 256, not measured; it decides only how far a small query's
#: targets are cut.
TC_BLOCK_OVERHEAD_TILES = 8

#: Dynamic shared memory a block may use on the H100.
SMEM_MAX = 232448


def topk_work(B, N_s, N_t, C, k, elem=4):
    """The search's least work: ``2 B N_s N_t C`` operations (the product
    ``h_s h_t^T``); bytes ``h_s`` and ``h_t`` read once (``elem`` bytes a
    value: 4, or 2 for bf16), the target mask (a byte a target) and the
    ``[B, N_s, k]`` picks written (a float32 value and an int32 index
    each)."""
    return {'kernel': 'topk', 'flops': 2.0 * B * N_s * N_t * C,
            'bytes': elem * B * (N_s + N_t) * C + B * N_t + 8.0 * B * N_s * k,
            'out_bytes': (elem + 4.0) * B * N_s * k, 'dot': True}


def _call_work(h_s, h_t, k, t_mask=None, block=None):
    B, N_s, C = h_s.shape
    return topk_work(B, N_s, h_t.shape[1], C, k, h_s.element_size())


@dispatch.counted('topk', _call_work)
def plain_topk(h_s, h_t, k, t_mask=None, block=PLAIN_BLOCK):
    """Blockwise running top-k in plain PyTorch → ``(vals, idx)``.

    h_s ``[B, N_s, C]``, h_t ``[B, N_t, C]``, t_mask ``[B, N_t]`` bool →
    vals ``[B, N_s, k]`` (h_s dtype), idx ``[B, N_s, k]`` int32. Each
    target block's scores are merged with the running carry by one
    stable descending sort over (carry ‖ block), carry first, so earlier
    (lower) indices win ties exactly as in a top-k of the full matrix.
    Scores are products and sums in (at least) float32, rounded to the
    inputs' dtype (bfloat16) and carried in float32 (:func:`_scores`). On
    the CPU each score is its products summed over the channel axis alone,
    so a row's scores do not depend on the other rows: a search over any
    subset of the rows (a source chunk) gives those rows the same picks and
    values, as the kernels do (a CPU matrix product does not promise that:
    its summation order follows the shapes). On the card the scores are
    cuBLAS's product, whose in-order float32 sums are the kernels'.
    """
    with torch.no_grad():
        B, N_s, _ = h_s.shape
        N_t = h_t.shape[1]
        dt = h_s.dtype
        acc = torch.promote_types(dt, torch.float32)
        neg = torch.finfo(dt).min
        vals = torch.full((B, N_s, k), -math.inf, dtype=acc,
                          device=h_s.device)
        idx = torch.zeros((B, N_s, k), dtype=torch.int64, device=h_s.device)
        for start in range(0, N_t, block):
            stop = min(start + block, N_t)
            scores = _scores(h_s, h_t[:, start:stop], acc).to(dt).to(acc)
            if t_mask is not None:
                scores = scores.masked_fill(
                    ~t_mask[:, None, start:stop], neg)
            cols = torch.arange(start, stop, device=h_s.device)
            cand_v = torch.cat([vals, scores], dim=-1)
            cand_i = torch.cat(
                [idx, cols.expand(B, N_s, stop - start)], dim=-1)
            sv, pos = torch.sort(cand_v, dim=-1, descending=True,
                                 stable=True)
            vals = sv[..., :k]
            idx = torch.gather(cand_i, -1, pos[..., :k])
        return vals.to(dt), idx.to(torch.int32)


def _scores(h_s, h_t, acc):
    """``[B, N_s, N_t]`` inner products in ``acc``: on the CPU elementwise
    products summed over the channel axis, in tiles of rows that bound the
    product tile at :data:`PLAIN_TILE_ELEMS` elements; elsewhere a batched
    matrix product."""
    if h_s.device.type != 'cpu':
        return torch.bmm(h_s.to(acc), h_t.to(acc).transpose(1, 2))
    B, N_s, C = h_s.shape
    rows = max(1, PLAIN_TILE_ELEMS // max(1, B * h_t.shape[1] * C))
    h_t = h_t.to(acc)[:, None]
    return torch.cat([(h_s[:, lo:lo + rows, None, :].to(acc) * h_t).sum(-1)
                      for lo in range(0, N_s, rows)], dim=1)


def tc_smem_bytes(C):
    """Dynamic shared memory of a tensor-core block at ``C`` channels:
    1024 bytes to align the swizzled tiles, the resident h_s stripe and
    the ring (16 KB a 64-channel chunk of 128 rows), 9 mbarriers."""
    return 1024 + (-(-C // 64) + TC_STAGES) * 128 * 64 * 2 + 8 * (
        2 * TC_STAGES + 1)


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('topk.cu')
    if not getattr(lib, 'topk_bound', False):
        for fn in (lib.dgmc_topk_f32, lib.dgmc_topk_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.dgmc_topk_bf16_tc.argtypes = ([ctypes.c_void_p] * 7
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p])
        lib.dgmc_topk_bf16_tc.restype = ctypes.c_int
        for name in ('dgmc_topk_k_max', 'dgmc_topk_targets_per_tile',
                     'dgmc_topk_row_tile', 'dgmc_topk_blocks_per_sm',
                     'dgmc_topk_tc_rows', 'dgmc_topk_tc_targets_per_tile',
                     'dgmc_topk_tc_stages', 'dgmc_topk_tc_k_max',
                     'dgmc_topk_tc_c_max', 'dgmc_topk_tc_smem_bytes'):
            getattr(lib, name).restype = ctypes.c_int
        tiles = tuple(t for t in map(lib.dgmc_topk_row_tile,
                                     range(len(ROW_TILES) + 1)) if t)
        widths = (8, 200, 256, 264, TC_C_MAX)
        got = (lib.dgmc_topk_k_max(), lib.dgmc_topk_targets_per_tile(),
               tiles, tuple(map(lib.dgmc_topk_blocks_per_sm, tiles)),
               lib.dgmc_topk_tc_rows(), lib.dgmc_topk_tc_targets_per_tile(),
               lib.dgmc_topk_tc_stages(), lib.dgmc_topk_tc_k_max(),
               lib.dgmc_topk_tc_c_max(),
               tuple(map(lib.dgmc_topk_tc_smem_bytes, widths)))
        want = (K_MAX, TARGETS_PER_TILE, ROW_TILES,
                tuple(map(blocks_per_sm, ROW_TILES)), TC_ROWS,
                TARGETS_PER_TILE, TC_STAGES, TC_K_MAX, TC_C_MAX,
                tuple(map(tc_smem_bytes, widths)))
        if got != want:
            raise RuntimeError(f'csrc/topk.cu launch constants {got} differ '
                               f'from the wrapper\'s {want}')
        lib.topk_bound = True
    return lib


def blocks_per_sm(ts):
    """Blocks of ``ts`` rows that share an SM: the kernel's launch bounds
    give a 128-row block the whole register file (255 registers a
    thread), smaller row tiles two blocks. Checked against the compiled
    library at load, with :data:`ROW_TILES`."""
    return 1 if ts == 128 else 2


def _segments(row_blocks, n_tiles, slots, overhead):
    """Tiles per segment minimizing waves of blocks x the time of a block
    (its tiles plus ``overhead`` of its own), the longest among equals."""
    def makespan(tiles_per_seg):
        nseg = -(-n_tiles // tiles_per_seg)
        return (-(-row_blocks * nseg // slots)
                * (tiles_per_seg + overhead))
    return min(range(n_tiles, 0, -1), key=makespan)


@functools.lru_cache(maxsize=None)
def launch_plan(B, N_s, N_t, sms):
    """``(rows_per_block, segments, tiles_per_segment)`` of one launch of
    the FMA kernels, a pure function of the shapes and the card's SM
    count.

    The row tile is the smallest of :data:`ROW_TILES` that holds the
    query (128 for larger ones), so no FMA goes to padding rows. The
    ``n_tiles = ceil(N_t / 128)`` target tiles are cut into segments of
    consecutive tiles, in index order, each covered by one block per row
    tile; segment ``s`` holds tiles ``[s * tiles_per_segment, min((s + 1)
    * tiles_per_segment, n_tiles))`` and none is empty. The segment length
    minimizes the waves of blocks (:func:`blocks_per_sm` blocks per SM at
    a time) times the time of a block: its tiles plus
    :data:`BLOCK_OVERHEAD_TILES` of its own, the longest segments among
    equals. So a small query spreads over the whole card, and a large
    one is cut only where a fuller last wave pays for the extra blocks.
    """
    ts = next((t for t in ROW_TILES if N_s <= t), ROW_TILES[-1])
    n_tiles = -(-N_t // TARGETS_PER_TILE)
    tiles_per_seg = _segments(B * -(-N_s // ts), n_tiles,
                              sms * blocks_per_sm(ts), BLOCK_OVERHEAD_TILES)
    return ts, -(-n_tiles // tiles_per_seg), tiles_per_seg


@functools.lru_cache(maxsize=None)
def tc_launch_plan(B, N_s, N_t, sms):
    """``(rows_per_block, segments, tiles_per_segment)`` of one launch of
    the tensor-core tile, cut as :func:`launch_plan` cuts, with its own
    block: :data:`TC_ROWS` rows whatever the query (padding rows cost
    tensor-core work, not instructions), one block an SM (the block's
    288 threads may take the whole register file, and at C >= 256 its
    shared memory, ``tc_smem_bytes(256)`` = 132 KB, leaves no room for a
    second), :data:`TC_BLOCK_OVERHEAD_TILES` of its own. At the DBP15K
    shape (15000 x 20000 on 132 SMs) that is 118 blocks of all 157 tiles
    in one wave: any cut adds a wave."""
    n_tiles = -(-N_t // TARGETS_PER_TILE)
    tiles_per_seg = _segments(B * -(-N_s // TC_ROWS), n_tiles, sms,
                              TC_BLOCK_OVERHEAD_TILES)
    return TC_ROWS, -(-n_tiles // tiles_per_seg), tiles_per_seg


def route(dtype, B, N_s, N_t, C, k):
    """``(entry, reason)``: which kernel :func:`streaming_topk` launches
    for CUDA inputs of ``dtype`` and these shapes, and the reason the
    dispatch ledger records — ``'f32'``, ``'bf16_tc'`` (the tensor-core
    tile), ``'bf16_fma'`` (the bf16 FMA kernel, for a shape the tile
    does not take) or ``'plain'`` (``k > K_MAX``). A pure function of its
    arguments (``B``, ``N_s`` and ``N_t`` take every route)."""
    del B, N_s, N_t
    if k > K_MAX:
        return 'plain', f'k>{K_MAX}'
    if dtype != torch.bfloat16:
        return 'f32', 'auto-cuda'
    if C % 8:
        return 'bf16_fma', 'fma, C%8!=0'
    if C > TC_C_MAX:
        return 'bf16_fma', f'fma, C>{TC_C_MAX}'
    if k > TC_K_MAX:
        return 'bf16_fma', f'fma, k>{TC_K_MAX}'
    return 'bf16_tc', 'tensor-core'


#: The library's entry point of each route.
_ENTRY = {'f32': 'dgmc_topk_f32', 'bf16_fma': 'dgmc_topk_bf16',
          'bf16_tc': 'dgmc_topk_bf16_tc'}


def _launch(entry, h_s, h_t, k, t_mask=None):
    """One launch of the library's ``entry`` (a :func:`route`) on CUDA
    inputs → ``(vals float32, idx int32)``; counts nothing (the timing
    of an entry beside the one the route picks calls this)."""
    B, N_s, C = h_s.shape
    N_t = h_t.shape[1]
    lib = _library()
    h_s, h_t = h_s.contiguous(), h_t.contiguous()
    if entry == 'bf16_tc':
        # TMA reads from 16-byte aligned rows: a view at an odd offset is
        # copied.
        h_s, h_t = (x if x.data_ptr() % 16 == 0 else x.clone()
                    for x in (h_s, h_t))
    mask = (None if t_mask is None
            else t_mask.to(torch.uint8).contiguous())
    device = h_s.device
    out_v = torch.empty((B, N_s, k), dtype=torch.float32, device=device)
    out_i = torch.empty((B, N_s, k), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    sms = sm_count(stream.device_index)
    ts, nseg, tiles_per_seg = (tc_launch_plan if entry == 'bf16_tc'
                               else launch_plan)(B, N_s, N_t, sms)
    part_v = part_i = None
    if nseg > 1:
        part_v = torch.empty((B * N_s, nseg, k), dtype=torch.float32,
                             device=device)
        part_i = torch.empty((B * N_s, nseg, k), dtype=torch.int32,
                             device=device)
    tile = () if entry == 'bf16_tc' else (ts,)
    err = getattr(lib, _ENTRY[entry])(
        h_s.data_ptr(), h_t.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if part_v is None else part_v.data_ptr(),
        None if part_i is None else part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), B, N_s, N_t, C, k, *tile, nseg, tiles_per_seg,
        stream.device_index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'topk kernel launch failed with CUDA error '
                           f'{err} (B={B}, N_s={N_s}, N_t={N_t}, C={C}, '
                           f'k={k}, {h_s.dtype}, route {entry}, rows per '
                           f'block={ts}, segments={nseg})')
    return out_v, out_i


@dispatch.kernel_wrapper('topk')
@dispatch.counted('topk')
def streaming_topk(h_s, h_t, k, t_mask=None, block=PLAIN_BLOCK):
    """Exact top-k of ``h_s @ h_t^T`` per source row → ``(vals, idx)``
    (``h_s``'s dtype / int32, ``[B, N_s, k]``). See the module
    docstring. ``block`` tiles the plain scan's targets only; the kernels
    ignore it, as the JAX package's Pallas kernel does."""
    if h_s.dim() != 3 or h_t.dim() != 3 or h_s.shape[0] != h_t.shape[0] \
            or h_s.shape[2] != h_t.shape[2]:
        raise ValueError(f'streaming_topk wants h_s [B, N_s, C] and h_t '
                         f'[B, N_t, C]; got {tuple(h_s.shape)} and '
                         f'{tuple(h_t.shape)}')
    B, N_s, C = h_s.shape
    N_t = h_t.shape[1]
    if not 1 <= k <= N_t:
        raise ValueError(f'k={k} must lie in [1, N_t={N_t}]')
    if t_mask is not None and tuple(t_mask.shape) != (B, N_t):
        raise ValueError(f't_mask must be [B, N_t] = {(B, N_t)}; got '
                         f'{tuple(t_mask.shape)}')
    devs = {h_s.device, h_t.device}
    if t_mask is not None:
        devs.add(t_mask.device)
    if len(devs) != 1:
        raise ValueError(f'streaming_topk inputs lie on several devices: '
                         f'{sorted(map(str, devs))}')
    device, dt = h_s.device, h_s.dtype
    h_s, h_t = h_s.detach(), h_t.detach()
    if device.type == 'cpu':
        dispatch.record('topk', 'plain', 'device=cpu', dt)
        return plain_topk(h_s, h_t, k, t_mask, block)
    if device.type != 'cuda':
        raise ValueError(f'streaming_topk runs on cpu or cuda, not '
                         f'{device.type}')
    if h_t.dtype != dt or dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the topk kernel takes float32 or bfloat16, both '
                        f'inputs in one dtype; got {h_s.dtype} / '
                        f'{h_t.dtype}')
    entry, reason = route(dt, B, N_s, N_t, C, k)
    if entry == 'plain':
        dispatch.record('topk', 'plain', reason, dt)
        return plain_topk(h_s, h_t, k, t_mask, block)
    dispatch.record('topk', 'kernel', reason, dt)
    out_v, out_i = _launch(entry, h_s, h_t, k, t_mask)
    streaming_topk.launches += 1
    # Scores of bf16 inputs are carried in float32 but bf16 holds them
    # exactly: the cast only narrows the storage.
    return out_v.to(dt), out_i
