"""Dense consensus update: CUDA kernel (forward), plain versions and the
tile-recompute backward.

``delta[b, s, t] = relu((o_s[b, s] - o_t[b, t]) @ W1 + b1) @ W2 + b2``
(float32, ``[B, N_s, N_t]``), never holding the ``[B, N_s, N_t, R]``
difference tensor across the forward. The inputs are float32 or
bfloat16 (the precision policy's variant), all in one dtype; every sum
runs in float32. Under bfloat16 the factored form rounds where the JAX
package's factored dense path rounds (``u_s = bf16(bf16(o_s W1) + b1)``,
``u_t = bf16(o_t W1)``, ``h = relu(bf16(u_s - u_t))``), and the output
``h · W2 + b2`` is float32. The kernel (``csrc/consensus.cu``)
replaces the JAX package's Pallas TPU kernel
``dgmc_tpu/ops/pallas/consensus.py::_consensus_kernel``; see the source
for its design and bound.

- :func:`consensus_fwd` is the kernel's wrapper: its plain version
  :func:`plain_consensus` (the factored form ``relu(u_s - u_t) @ W2 + b2``
  with ``u_s = o_s @ W1 + b1``, ``u_t = o_t @ W1``) for CPU tensors; on a
  CUDA tensor it launches the kernel or raises. ``R > R_MAX`` does not
  reach it: the model records that gate (``dispatch``) and takes the
  plain form instead.
- :func:`consensus_update` is differentiable: its backward recomputes
  the difference tile by tile over ``TILE_T`` targets in plain PyTorch
  (float32 accumulation, each gradient cast to its operand's dtype once),
  as the JAX kernel's ``lax.scan`` backward does; the JAX package has no
  Pallas backward to port.
- :func:`consensus_work`: the function's least work in the factored form
  (the work counter's count and ``chip_smoke.py``'s bound), forward and
  backward, the same whichever path runs.
"""

import ctypes
import functools
import math

import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.build import sm_count

__all__ = ['R_MAX', 'MICRO', 'TILE_MAX', 'MAX_THREADS', 'TILE_T',
           'launch_plan', 'plain_consensus', 'consensus_fwd',
           'consensus_backward', 'consensus_update', 'consensus_work',
           'rounding']

#: Largest R the kernels take: the projection keeps W1 in shared memory,
#: the pair kernel a tile's u_s and u_t rows (about 4 (R + 4) (TS + TT)
#: bytes, at most 85 KB at R = 128, where the thread limit keeps TS + TT
#: <= 160). Checked against the compiled library at load, as are the three
#: tile limits below.
R_MAX = 128

#: Pairs per thread along s and along t (a 4 x 4 micro-tile), the largest
#: tile side, and the most threads a block (``TS/4 * TT/4``) may have.
MICRO, TILE_MAX, MAX_THREADS = 4, 128, 256

#: Target rows per backward tile: bounds the recomputed difference to
#: ``B * N_s * TILE_T * R`` floats.
TILE_T = 32


def rounding(dtype):
    """``(up, rnd)`` for inputs of ``dtype``: widen to the dtype the sums
    run in (float32, or float64 inputs' own), and round a sum through
    ``dtype`` (the identity for float32 and float64). The plain versions
    of both consensus kernels (this module's and ``sparse_consensus``'s)
    round with it."""
    acc = torch.promote_types(dtype, torch.float32)
    return (lambda a: a.to(acc)), (lambda a: a.to(dtype).to(acc))


def _factored(o_s, o_t, w1, b1, rnd, up):
    """``u_s = rnd(rnd(o_s W1) + b1)`` and ``u_t = rnd(o_t W1)``, widened."""
    return (rnd(rnd(up(o_s) @ up(w1)) + up(b1)), rnd(up(o_t) @ up(w1)))


def consensus_work(B, N_s, N_t, R, elem=4):
    """The least work of the delta in the factored form: the node
    products ``2 B (N_s + N_t) R^2`` and per pair ``3 R`` (difference,
    product, sum); bytes ``o_s``, ``o_t`` and the weights read once
    (``elem`` bytes a value), the float32 delta written once. ``'bwd'``:
    the gradients given ``g``: the node products three times (``u``
    again, ``d_o`` and ``d_W1``) and per pair ``6 R``; bytes the rows
    twice, ``g``, and the weights and their gradients."""
    pairs = B * N_s * N_t
    nodes = 2.0 * B * (N_s + N_t) * R * R
    rows = elem * B * (N_s + N_t) * R
    weights = elem * (R * R + 2 * R + 1)
    return {'kernel': 'consensus_fwd', 'flops': nodes + 3.0 * pairs * R,
            'bytes': rows + weights + 4.0 * pairs, 'out_bytes': 4.0 * pairs,
            'dot': True,
            'bwd': {'kernel': 'consensus_bwd',
                    'flops': 3 * nodes + 6.0 * pairs * R,
                    'bytes': 2 * rows + 4.0 * pairs + 2 * weights,
                    'out_bytes': rows + weights, 'dot': True}}


def _call_work(o_s, o_t, w1, b1, w2, b2):
    B, N_s, R = o_s.shape
    return consensus_work(B, N_s, o_t.shape[1], R, o_s.element_size())


@dispatch.counted('consensus', _call_work)
def plain_consensus(o_s, o_t, w1, b1, w2, b2):
    """The factored plain version → ``[B, N_s, N_t]``, rounded as the
    kernel rounds for the inputs' dtype. Materializes the ``[B, N_s, N_t,
    R]`` hidden layer; differentiable by autograd."""
    up, rnd = rounding(o_s.dtype)
    u_s, u_t = _factored(o_s, o_t, w1, b1, rnd, up)
    h = torch.relu(rnd(u_s[:, :, None, :] - u_t[:, None, :, :]))
    return (h @ up(w2))[..., 0] + up(b2)[0]


@functools.lru_cache(maxsize=None)
def launch_plan(B, N_s, N_t, sms):
    """``(TS, TT)``: the pair kernel's tile, a pure function of the shapes
    and the card's SM count.

    Each axis is cut into ``n`` near-equal tiles of a multiple of
    :data:`MICRO` rows, at most :data:`TILE_MAX`, with at most
    :data:`MAX_THREADS` threads a block. Blocks are equal, so the kernel
    takes about ``ceil(blocks / sms)`` block times; a block's time is its
    pairs (padding included) plus its staged rows. The plan minimizes
    that product, then the number of blocks. At ``[64, 80, 80]`` on 132
    SMs: 40 x 80, 128 blocks in one wave, no padded pair.
    """
    def cuts(n):
        sizes = {MICRO * -(-n // (MICRO * k))
                 for k in range(1, -(-n // MICRO) + 1)}
        return sorted(t for t in sizes if t <= TILE_MAX)

    best = None
    for TS in cuts(N_s):
        for TT in cuts(N_t):
            if (TS // MICRO) * (TT // MICRO) > MAX_THREADS:
                continue
            blocks = B * -(-N_s // TS) * -(-N_t // TT)
            cost = (math.ceil(blocks / sms) * (TS * TT + 2 * (TS + TT)),
                    blocks)
            if best is None or cost < best[0]:
                best = (cost, (TS, TT))
    return best[1]


#: The kernel's entry point for each input dtype it takes.
_ENTRY = {torch.float32: 'dgmc_consensus_fwd_f32',
          torch.bfloat16: 'dgmc_consensus_fwd_bf16'}


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('consensus.cu')
    if not getattr(lib, 'consensus_bound', False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        got = (lib.dgmc_consensus_r_max(), lib.dgmc_consensus_micro(),
               lib.dgmc_consensus_tile_max(),
               lib.dgmc_consensus_max_threads())
        want = (R_MAX, MICRO, TILE_MAX, MAX_THREADS)
        if got != want:
            raise RuntimeError(f'csrc/consensus.cu is built for (R_MAX, '
                               f'MICRO, TILE_MAX, MAX_THREADS) = {got}, the '
                               f'wrapper for {want}')
        lib.consensus_bound = True
    return lib


@dispatch.kernel_wrapper('consensus_fwd')
@dispatch.counted('consensus_fwd', _call_work)
def consensus_fwd(o_s, o_t, w1, b1, w2, b2):
    """The consensus delta → ``[B, N_s, N_t]`` float32 (no gradient; see
    :func:`consensus_update`)."""
    if o_s.dim() != 3 or o_t.dim() != 3 or o_s.shape[0] != o_t.shape[0] \
            or o_s.shape[2] != o_t.shape[2]:
        raise ValueError(f'consensus_fwd wants o_s [B, N_s, R] and o_t '
                         f'[B, N_t, R]; got {tuple(o_s.shape)} and '
                         f'{tuple(o_t.shape)}')
    B, N_s, R = o_s.shape
    N_t = o_t.shape[1]
    if (tuple(w1.shape) != (R, R) or tuple(b1.shape) != (R,)
            or tuple(w2.shape) != (R, 1) or tuple(b2.shape) != (1,)):
        raise ValueError(f'consensus MLP shapes {tuple(w1.shape)}, '
                         f'{tuple(b1.shape)}, {tuple(w2.shape)}, '
                         f'{tuple(b2.shape)} do not fit R={R}')
    args = [a.detach() for a in (o_s, o_t, w1, b1, w2, b2)]
    devs = {a.device for a in args}
    if len(devs) != 1:
        raise ValueError(f'consensus_fwd inputs lie on several devices: '
                         f'{sorted(map(str, devs))}')
    dev, dt = o_s.device, o_s.dtype
    if dev.type == 'cpu':
        dispatch.record('consensus_fwd', 'plain', 'device=cpu', dt)
        return plain_consensus(*args)
    if dev.type != 'cuda':
        raise ValueError(f'consensus_fwd runs on cpu or cuda, not '
                         f'{dev.type}')
    if dt not in _ENTRY or any(a.dtype != dt for a in args):
        raise TypeError(f'the consensus kernel takes float32 or bfloat16, '
                        f'every operand in one dtype; got '
                        f'{sorted({str(a.dtype) for a in args})}')
    if R > R_MAX or B > 65535:
        raise ValueError(f'the consensus kernel takes R <= {R_MAX} and '
                         f'B <= 65535; got R={R}, B={B}')
    dispatch.record('consensus_fwd', 'kernel', 'auto-cuda', dt)
    lib = _library()
    args = [a.contiguous() for a in args]
    u_s, u_t = torch.empty_like(args[0]), torch.empty_like(args[1])
    out = torch.empty((B, N_s, N_t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    TS, TT = launch_plan(B, N_s, N_t, sm_count(stream.device_index))
    err = getattr(lib, _ENTRY[dt])(
        *(a.data_ptr() for a in args), u_s.data_ptr(), u_t.data_ptr(),
        out.data_ptr(), B, N_s, N_t, R, TS, TT, stream.device_index,
        stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'consensus kernel launch failed with CUDA error '
                           f'{err} (B={B}, N_s={N_s}, N_t={N_t}, R={R}, '
                           f'{dt})')
    consensus_fwd.launches += 1
    return out


def consensus_backward(o_s, o_t, w1, b1, w2, g):
    """Gradients of ``sum(g * delta)`` w.r.t. ``(o_s, o_t, w1, b1, w2,
    b2)``: the hidden layer is recomputed per tile of ``TILE_T`` targets
    (rounded as the forward rounds it) and reduced at once, so at most
    ``[B, N_s, TILE_T, R]`` lives at a time. Through the factored form:
    ``d_u_s`` / ``d_u_t`` first, then one node-level product each for
    ``d_o_s``, ``d_o_t`` and ``d_w1``. Every sum runs in (at least)
    float32; each gradient is cast to its operand's dtype once (``d_b2``
    to ``w2``'s)."""
    N_t = o_t.shape[1]
    up, rnd = rounding(o_s.dtype)
    u_s, u_t = _factored(o_s, o_t, w1, b1, rnd, up)
    g = up(g)
    w2v = up(w2)[:, 0]
    d_us = torch.zeros_like(u_s)
    d_ut = torch.empty_like(u_t)
    d_w2 = torch.zeros_like(w2v)
    for start in range(0, N_t, TILE_T):
        stop = min(start + TILE_T, N_t)
        g_b = g[:, :, start:stop]                                # [B,S,T]
        pre = rnd(u_s[:, :, None, :]
                  - u_t[:, None, start:stop, :])                 # [B,S,T,R]
        d_w2 += torch.einsum('bstq,bst->q', torch.relu(pre), g_b)
        d_pre = torch.where(pre > 0, g_b[..., None] * w2v, 0.0)
        d_us += d_pre.sum(dim=2)
        d_ut[:, start:stop] = -d_pre.sum(dim=1)
    w1a = up(w1)
    d_w1 = (torch.einsum('bsr,bsq->rq', up(o_s), d_us)
            + torch.einsum('btr,btq->rq', up(o_t), d_ut))
    grads = (d_us @ w1a.T, d_ut @ w1a.T, d_w1, d_us.sum(dim=(0, 1)),
             d_w2[:, None], g.sum().reshape(1))
    return tuple(d.to(a.dtype) for d, a in
                 zip(grads, (o_s, o_t, w1, b1, w2, w2)))


class _ConsensusUpdate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, o_s, o_t, w1, b1, w2, b2):
        ctx.save_for_backward(o_s, o_t, w1, b1, w2)
        return consensus_fwd(o_s, o_t, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        grads = consensus_backward(*ctx.saved_tensors, g)
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad))


@dispatch.counted('consensus')
def consensus_update(o_s, o_t, w1, b1, w2, b2):
    """``mlp(o_s[:, :, None] - o_t[:, None, :])`` → ``[B, N_s, N_t]``,
    differentiable in every argument; see the module docstring."""
    return _ConsensusUpdate.apply(o_s, o_t, w1, b1, w2, b2)
