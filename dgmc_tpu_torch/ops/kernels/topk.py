"""Streaming exact top-k of ``h_s @ h_t^T``: CUDA kernel and plain version.

The kernel (``csrc/topk.cu``) replaces the JAX package's Pallas TPU
kernel ``dgmc_tpu/ops/pallas/topk.py::_kernel``; see the source for its
design and bound. :func:`streaming_topk` is its wrapper:

- a CPU tensor takes :func:`plain_topk`, the blockwise scan in plain
  PyTorch with the same contract;
- a CUDA tensor launches the kernel, or raises on what the kernel does
  not take (a dtype other than float32). Only ``k > K_MAX`` takes the
  plain version on the card, and only through a recorded dispatch
  decision with reason ``k>K_MAX``.

Contract (both paths): values descending, lowest target index first
among equal values; masked targets score ``finfo(float32).min``; the
carry starts at ``-inf``, so when ``k`` exceeds the valid targets the
masked ones fill the tail in index order. The search is selection and
carries no gradient.
"""

import ctypes
import math

import torch

from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['K_MAX', 'PLAIN_BLOCK', 'plain_topk', 'streaming_topk']

#: Largest ``k`` the kernel takes: its per-row carry lives in shared
#: memory (8 bytes x 128 rows x k) beside 81 KB of tiles, and k <= 128
#: keeps a block within the 227 KB a block may use (at k = 10 two blocks
#: share an SM). Checked against the compiled library at load.
K_MAX = 128

#: Target block of the plain scan.
PLAIN_BLOCK = 256

_ROWS_PER_BLOCK = 128
_TARGETS_PER_TILE = 128


def plain_topk(h_s, h_t, k, t_mask=None, block=PLAIN_BLOCK):
    """Blockwise running top-k in plain PyTorch → ``(vals, idx)``.

    h_s ``[B, N_s, C]``, h_t ``[B, N_t, C]``, t_mask ``[B, N_t]`` bool →
    vals ``[B, N_s, k]`` (h_s dtype), idx ``[B, N_s, k]`` int32. Each
    target block's scores are merged with the running carry by one
    stable descending sort over (carry ‖ block), carry first, so earlier
    (lower) indices win ties exactly as in a top-k of the full matrix.
    """
    with torch.no_grad():
        B, N_s, _ = h_s.shape
        N_t = h_t.shape[1]
        neg = torch.finfo(h_s.dtype).min
        vals = torch.full((B, N_s, k), -math.inf, dtype=h_s.dtype,
                          device=h_s.device)
        idx = torch.zeros((B, N_s, k), dtype=torch.int64, device=h_s.device)
        for start in range(0, N_t, block):
            stop = min(start + block, N_t)
            scores = torch.bmm(h_s, h_t[:, start:stop].transpose(1, 2))
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
        return vals, idx.to(torch.int32)


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('topk.cu')
    if not getattr(lib, 'topk_bound', False):
        fn = lib.dgmc_topk_f32
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ('dgmc_topk_k_max', 'dgmc_topk_rows_per_block',
                     'dgmc_topk_targets_per_tile'):
            getattr(lib, name).restype = ctypes.c_int
        got = (lib.dgmc_topk_k_max(), lib.dgmc_topk_rows_per_block(),
               lib.dgmc_topk_targets_per_tile())
        want = (K_MAX, _ROWS_PER_BLOCK, _TARGETS_PER_TILE)
        if got != want:
            raise RuntimeError(f'csrc/topk.cu constants {got} differ from '
                               f'the wrapper\'s {want}')
        lib.topk_bound = True
    return lib


def _segments(B, N_s, N_t, device):
    """Cut the target axis so that up to two blocks per SM are in flight
    in one wave: a small query (one row tile) would otherwise run on one
    SM."""
    n_tiles = -(-N_t // _TARGETS_PER_TILE)
    blocks = B * -(-N_s // _ROWS_PER_BLOCK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_tiles, 2 * sms // blocks))
    tiles_per_seg = -(-n_tiles // want)
    return -(-n_tiles // tiles_per_seg), tiles_per_seg


@dispatch.kernel_wrapper('topk')
def streaming_topk(h_s, h_t, k, t_mask=None):
    """Exact top-k of ``h_s @ h_t^T`` per source row → ``(vals, idx)``
    (float32 / int32, ``[B, N_s, k]``). See the module docstring."""
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
    device = h_s.device
    h_s, h_t = h_s.detach(), h_t.detach()
    if device.type == 'cpu':
        dispatch.record('topk', 'plain', 'device=cpu')
        return plain_topk(h_s, h_t, k, t_mask)
    if device.type != 'cuda':
        raise ValueError(f'streaming_topk runs on cpu or cuda, not '
                         f'{device.type}')
    if k > K_MAX:
        dispatch.record('topk', 'plain', f'k>{K_MAX}')
        return plain_topk(h_s, h_t, k, t_mask)
    if h_s.dtype != torch.float32 or h_t.dtype != torch.float32:
        raise TypeError(f'the topk kernel takes float32 only; got '
                        f'{h_s.dtype} / {h_t.dtype}')
    dispatch.record('topk', 'kernel', 'auto-cuda')
    lib = _library()
    h_s, h_t = h_s.contiguous(), h_t.contiguous()
    mask = (torch.ones((B, N_t), dtype=torch.uint8, device=device)
            if t_mask is None else t_mask.to(torch.uint8).contiguous())
    out_v = torch.empty((B, N_s, k), dtype=torch.float32, device=device)
    out_i = torch.empty((B, N_s, k), dtype=torch.int32, device=device)
    nseg, tiles_per_seg = _segments(B, N_s, N_t, device)
    if nseg > 1:
        part_v = torch.empty((nseg, B, N_s, k), dtype=torch.float32,
                             device=device)
        part_i = torch.empty((nseg, B, N_s, k), dtype=torch.int32,
                             device=device)
    else:
        part_v, part_i = out_v, out_i
    stream = torch.cuda.current_stream(device)
    err = lib.dgmc_topk_f32(
        h_s.data_ptr(), h_t.data_ptr(), mask.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), B, N_s, N_t,
        C, k, nseg, tiles_per_seg, stream.device_index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'topk kernel launch failed with CUDA error '
                           f'{err} (B={B}, N_s={N_s}, N_t={N_t}, C={C}, '
                           f'k={k}, segments={nseg})')
    streaming_topk.launches += 1
    return out_v, out_i
