"""Counter-based random draws (Philox4x32-10): CUDA kernel and plain
versions.

The port's counterpart of ``jax.random`` on the device: the model's
per-pair indicator noise and negatives
(:func:`~dgmc_tpu_torch.models.dgmc.draw_noise`,
:func:`~dgmc_tpu_torch.models.dgmc.draw_negatives`) are drawn by the
kernel ``csrc/rng.cu`` on the card and by the plain versions here on the
CPU, from one stream that both compute, so a draw is the same on every
device. JAX draws them inside its jitted step
(``dgmc_tpu/models/dgmc.py:515-526``, ``:733-738``); threefry's bits are
not reproduced.

The stream (see the source): key = the 64-bit ``seed``, a Python int or
a 0-d int64 tensor holding its bits in two's complement
(:func:`seed_tensor`; read on its device, never on the host: a captured
CUDA graph of a step reads each replay's seed from it); element ``e`` of
pair ``b``'s draw (its flat index within that pair's draw) is word
``e % 4`` of the Philox block at counter
``(e // 4 low, e // 4 high, pair_offset + b, stream)``. So a batch of
pairs draws exactly what the same pairs draw one at a time at their
``pair_offset``. A draw of ``steps`` blocks of ``P`` elements a pair is
laid out ``[steps, B, P]``, ``e = step * P + i``.

- uniforms: ``(x >> 8) * 2^-24`` in ``[0, 1)``, float32;
- negatives: ``min(floor(u * float32(n_valid[b])), max(n_valid[b] - 1,
  0))`` (a float32 product), int64, ``n_valid`` read on its device;
- normals: Box–Muller on the word pairs ``(x0, x1)``, ``(x2, x3)`` of a
  block in float64 (``u1 = ((x0 >> 8) + 1) * 2^-24``,
  ``u2 = (x1 >> 8) * 2^-24``, ``r cos(2 pi u2)``, ``r sin(2 pi u2)``),
  rounded to float32 once.

Uniforms and negatives are integer and IEEE-exact arithmetic: the kernel
and the plain versions agree bit for bit. Normals agree unless the card's
and the CPU's float64 ``log`` / ``sin`` / ``cos`` straddle a float32
rounding boundary, which costs at most one float32 ulp.

:func:`philox_normal` and :func:`philox_negatives` take their plain
version for the CPU; on the card they launch the kernel or raise. Both
count on one ``launches`` counter (``rng``) and write a dispatch record.
The uniforms have no entry of their own on the card: the negatives over
``n_valid = 2^24`` are their 24 bits exactly.
"""

import ctypes
import math

import torch

from dgmc_tpu_torch.ops.graph import canonical_device
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['PHILOX_M', 'PHILOX_W', 'key_bits', 'seed_tensor', 'philox4x32',
           'plain_philox_words',
           'plain_philox_normal', 'plain_philox_uniform',
           'plain_philox_negatives', 'philox_normal', 'philox_negatives',
           'draw_work']

#: Philox4x32-10's round multipliers and key increments (Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)

_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1
_TWO_PI = 2 * math.pi


def _mulhilo(m, c):
    """``(lo, hi)`` 32-bit words of ``m * c`` for a 32-bit constant ``m``
    and an int64 tensor ``c`` of 32-bit values, in 16-bit halves so that
    no product leaves int64."""
    a = m * (c & 0xFFFF)                  # < 2^48
    b = m * (c >> 16)                     # < 2^48
    s = ((b & 0xFFFF) << 16) + a          # < 2^49
    return s & _U32, (b >> 16) + (s >> 32)


def philox4x32(counter, key):
    """Philox4x32-10 of ``counter`` (four int64 tensors of 32-bit values,
    or ints) under ``key`` (two 32-bit ints, or two 0-d int64 tensors on
    the counters' device): the four 32-bit words of each block as int64
    tensors."""
    dev = next((c.device for c in counter if torch.is_tensor(c)), 'cpu')
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=dev)
                      for c in counter)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        lo0, hi0 = _mulhilo(PHILOX_M[0], c0)
        lo1, hi1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_bits(seed):
    """The int64 whose two's-complement bits are the 64-bit key of the
    int ``seed`` (its low 64 bits)."""
    seed = int(seed) & _U64
    return seed - (1 << 64) if seed >> 63 else seed


def seed_tensor(seed, device='cpu'):
    """``seed`` as the key's device form: a 0-d int64 tensor on
    ``device`` holding :func:`key_bits` (written by a fill: no copy from
    the host)."""
    return torch.full((), key_bits(seed), dtype=torch.int64, device=device)


def _check_seed(seed, device):
    if torch.is_tensor(seed) and (seed.dim() != 0 or seed.dtype
                                  != torch.int64 or seed.device != device):
        raise ValueError(f'a seed tensor is 0-d int64 on {device}; got '
                         f'{tuple(seed.shape)} {seed.dtype} on '
                         f'{seed.device}')


def _key(seed, device):
    """The key's two 32-bit words: ints for an int ``seed``, 0-d int64
    tensors on ``device`` for a seed tensor (no host read)."""
    if torch.is_tensor(seed):
        seed = seed.to(device=device, dtype=torch.int64)
        return seed & _U32, (seed >> 32) & _U32
    seed = int(seed) & _U64
    return seed & _U32, seed >> 32


def _check_pairs(B, pair_offset):
    if pair_offset < 0 or pair_offset + B > 1 << 32:
        raise ValueError(f'pairs {pair_offset}..{pair_offset + B - 1} '
                         f'leave the 32-bit counter word')


def plain_philox_words(steps, B, P, seed, pair_offset=0, stream=0,
                       device='cpu'):
    """The 32-bit words of a draw, ``[B, 4 * ceil(steps * P / 4)]`` int64:
    pair ``b``'s blocks at counters ``(q, pair_offset + b, stream)``, the
    four words of each in order. The plain versions run where ``device``
    says (the CPU path; the card only to time them there)."""
    _check_pairs(B, pair_offset)
    Q = -(-steps * P // 4)
    q = torch.arange(Q, dtype=torch.int64, device=device)[None, :]
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    words = philox4x32((q & _U32, q >> 32, b + pair_offset, int(stream)),
                       _key(seed, device))
    return torch.stack(words, dim=-1).reshape(B, 4 * Q)


def _layout(flat, steps, P):
    """``[B, >= steps * P]`` per-pair elements → ``[steps, B, P]``."""
    B = flat.shape[0]
    return flat[:, :steps * P].reshape(B, steps, P).transpose(0, 1)


def _uniform24(words):
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def plain_philox_uniform(steps, B, P, seed, pair_offset=0, stream=0,
                         device='cpu'):
    """Uniforms ``[steps, B, P]`` float32 in ``[0, 1)``, what the kernel
    draws before it forms negatives."""
    words = plain_philox_words(steps, B, P, seed, pair_offset, stream,
                               device)
    return _layout(_uniform24(words), steps, P).contiguous()


def plain_philox_normal(steps, B, P, seed, pair_offset=0, stream=0,
                        device='cpu'):
    """The plain version of :func:`philox_normal`: ``[steps, B, P]``
    float32, Box–Muller in float64 on each block's word pairs."""
    words = plain_philox_words(steps, B, P, seed, pair_offset, stream,
                               device)
    w = words.reshape(B, -1, 2, 2)      # [B, Q, pair h, (x_2h, x_2h+1)]
    u1 = ((w[..., 0] >> 8) + 1).to(torch.float64) * 2.0 ** -24
    u2 = (w[..., 1] >> 8).to(torch.float64) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return _layout(z.to(torch.float32).reshape(B, -1), steps,
                   P).contiguous()


def plain_philox_negatives(n_valid, P, seed, pair_offset=0, stream=1):
    """The plain version of :func:`philox_negatives`: ``[B, P]`` int64
    columns in ``[0, max(n_valid[b], 1))``, on ``n_valid``'s device."""
    B = n_valid.shape[0]
    u = plain_philox_uniform(1, B, P, seed, pair_offset, stream,
                             n_valid.device)[0]
    n = n_valid.to(torch.int64)
    cols = torch.floor(u * n.to(torch.float32)[:, None]).to(torch.int64)
    return torch.minimum(cols, (n - 1).clamp(min=0)[:, None])


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('rng.cu')
    if not getattr(lib, 'rng_bound', False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        u32 = ctypes.c_uint
        lib.dgmc_philox_normal.argtypes = [p, ll, ll, i, p, u32, u32, i, p]
        lib.dgmc_philox_negatives.argtypes = [p, p, ll, i, p, u32, u32, i, p]
        lib.dgmc_philox_normal.restype = ctypes.c_int
        lib.dgmc_philox_negatives.restype = ctypes.c_int
        lib.rng_bound = True
    return lib


def _device(device):
    dev = canonical_device(device)
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'rng runs on cpu or cuda, not {dev.type}')
    return dev


def draw_work(kind, steps, B, P):
    """A draw's least work: no floating-point operations counted (the
    integer rounds of Philox and the float64 Box-Muller have no peak of
    their own in the bound); bytes written: ``[steps, B, P]`` float32
    normals or ``[B, P]`` int64 negatives (with the ``[B]`` counts read),
    and the 8-byte key read."""
    if kind == 'normal':
        nbytes, out = 4.0 * steps * B * P + 8.0, 4.0 * steps * B * P
    else:
        nbytes, out = 8.0 * B * P + 8.0 * B + 8.0, 8.0 * B * P
    return {'kernel': 'rng', 'flops': 0.0, 'bytes': nbytes,
            'out_bytes': out, 'dot': False}


@dispatch.kernel_wrapper('rng')
@dispatch.counted('rng', lambda kind, steps, B, P, *_a, **_k:
                  draw_work(kind, steps, B, P))
def _draw(kind, steps, B, P, seed, pair_offset, stream, device,
          n_valid=None):
    """One draw of ``kind`` (``'normal'`` or ``'negatives'``) on
    ``device``: the plain version on the CPU, one kernel launch on the
    card, which reads the key from a seed tensor (an int ``seed`` is
    written into one by a fill launch first)."""
    _check_pairs(B, pair_offset)
    _check_seed(seed, device)
    if device.type == 'cpu':
        if kind == 'normal':
            dispatch.record('rng', 'plain', 'device=cpu', torch.float32)
            return plain_philox_normal(steps, B, P, seed, pair_offset,
                                       stream)
        dispatch.record('rng', 'plain', 'device=cpu', torch.int64)
        return plain_philox_negatives(n_valid, P, seed, pair_offset, stream)
    s = torch.cuda.current_stream(device)
    if not torch.is_tensor(seed):
        seed = seed_tensor(seed, device)
    if kind == 'normal':
        dispatch.record('rng', 'kernel', 'auto-cuda', torch.float32)
        out = torch.empty((steps, B, P), dtype=torch.float32, device=device)
        err = _library().dgmc_philox_normal(
            out.data_ptr(), steps, P, B, seed.data_ptr(), pair_offset,
            stream, s.device_index, s.cuda_stream)
    else:
        dispatch.record('rng', 'kernel', 'auto-cuda', torch.int64)
        out = torch.empty((B, P), dtype=torch.int64, device=device)
        err = _library().dgmc_philox_negatives(
            out.data_ptr(), n_valid.data_ptr(), P, B, seed.data_ptr(),
            pair_offset, stream, s.device_index, s.cuda_stream)
    if err != 0:
        raise RuntimeError(f'rng {kind} kernel launch failed with CUDA '
                           f'error {err} (steps={steps}, B={B}, P={P})')
    _draw.launches += 1
    return out


def philox_normal(steps, B, P, seed, pair_offset=0, stream=0,
                  device='cpu'):
    """Standard normals ``[steps, B, P]`` float32 on ``device``: pair
    ``b``'s from counters ``(q, pair_offset + b, stream)``; ``seed`` an int
    or a seed tensor on ``device`` (:func:`seed_tensor`)."""
    return _draw('normal', steps, B, P, seed, pair_offset, stream,
                 _device(device))


def philox_negatives(n_valid, P, seed, pair_offset=0, stream=1):
    """Random columns ``[B, P]`` int64 on ``n_valid``'s device, each in
    ``[0, n_valid[b])`` (0 where ``n_valid[b]`` is 0); ``n_valid`` ``[B]``
    is read on its device, never on the host, as is a seed tensor."""
    if n_valid.dim() != 1:
        raise ValueError(f'n_valid must be [B]; got {tuple(n_valid.shape)}')
    return _draw('negatives', 1, n_valid.shape[0], P, seed, pair_offset,
                 stream, _device(n_valid.device),
                 n_valid=n_valid.to(torch.int64).contiguous())
