"""Sparse consensus delta: CUDA kernels (forward and backward), plain
versions, and its two differentiable forms.

``delta[b, s, k] = relu((o_s[b, s] - o_t[b, S_idx[b, s, k]]) @ W1 + b1)
@ W2 + b2`` (float32, ``[B, N_s, K]``), the per-candidate MLP of every
sparse consensus step. The inputs are float32 or bfloat16 (the precision
policy's variant), all in one dtype; every sum runs in float32. Under
bfloat16 the factored form rounds ``u_s = bf16(bf16(o_s W1) + b1)``,
``u_t = bf16(o_t W1)`` and ``pre = bf16(u_s - u_t)`` (the JAX package's
sparse path takes the direct form, which rounds elsewhere), and the
gradients leave their float32 sums rounded to the operands' dtype once. The kernels (``csrc/sparse_consensus.cu``) replace
the JAX package's Pallas TPU kernels
``dgmc_tpu/ops/pallas/sparse_consensus.py::_fwd_kernel`` / ``_bwd_kernel``;
see the source for their design and bound.

- :func:`sparse_consensus_fwd` and :func:`sparse_consensus_bwd` are the
  kernels' wrappers. On CUDA the forward forms u_t one of two ways,
  chosen by :func:`projection` and recorded as the dispatch reason: for
  every target row first (training and evaluation over a whole KG), or
  only for the rows the shortlist points at, inside its candidate
  kernel (a query's few rows over the corpus). Their CPU versions,
  :func:`plain_sparse_consensus_fwd` and :func:`plain_sparse_consensus_bwd`,
  compute the kernels' factored form in plain PyTorch, so on every device
  the backward is the gradient of its own forward (the direct and the
  factored form round differently, and a value near 0 may take the other
  side of the ReLU). On a CUDA tensor each launches its kernel or raises;
  ``R > R_MAX`` does not reach them (the model records that gate and takes
  the plain form instead). The touched-row form is float32 only (the
  serve path's dtype): bfloat16 always projects every row first.
- :func:`fused_candidate_delta` (``o_t`` table plus shortlist, the form
  DGMC uses) and :func:`sparse_consensus_delta` (pre-gathered candidates
  ``[B, N_s, K, R]``, seen as a ``[B, N_s*K, R]`` table under the
  identity shortlist) are ``torch.autograd.Function`` s over the two
  wrappers. Their residuals are ``o_s``, ``o_t``, the weights and, when
  a gradient is needed, the forward's state (``u_s``, ``u_t`` and, on
  CUDA, the ReLU mask bits): the backward runs no projection of its own.
  The candidate tensor is never saved.
- :func:`plain_sparse_consensus_delta` / :func:`plain_fused_candidate_delta`
  are the unfused forms of the JAX package's ``*_reference`` functions,
  differentiable by autograd: the forward's independent check.

``S_idx`` may be an int tensor or a
:class:`~dgmc_tpu_torch.ops.shortlist.Shortlist`, whose receiver order the
backward's ``d_o_t`` pass walks; pass the Shortlist to build that order
once per forward. Indices must lie in ``[0, N_t)``: the kernels read
``o_t`` rows unchecked.

:func:`sc_work` is the delta's least work in the factored form, forward
and backward (the work counter's count in :mod:`~dgmc_tpu_torch.obs.cost`
and ``chip_smoke.py``'s bounds), the same whichever path runs.
"""

import ctypes
import functools

import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.build import sm_count
from dgmc_tpu_torch.ops.kernels.consensus import rounding
from dgmc_tpu_torch.ops.shortlist import Shortlist

__all__ = ['R_MAX', 'BWD_WARPS', 'NODE_THREADS', 'node_rows', 'bwd_plan',
           'projection', 'plain_sparse_consensus_delta',
           'plain_fused_candidate_delta', 'plain_sparse_consensus_fwd',
           'plain_sparse_consensus_bwd', 'sparse_consensus_fwd',
           'sparse_consensus_bwd', 'fused_candidate_delta',
           'sparse_consensus_delta', 'sc_work', 'touched_rows']

#: Largest R the kernels take: a warp holds a row in registers, at most
#: four channels per lane. Checked against the compiled library at load.
R_MAX = 128


def plain_sparse_consensus_delta(o_s, cand, w1, b1, w2, b2):
    """The unfused form: ``o_s [B, N_s, R]``, ``cand [B, N_s, K, R]`` →
    ``[B, N_s, K]``, materializing the difference and hidden layer. For
    bfloat16 inputs it rounds where the JAX package's
    ``sparse_consensus_delta_reference`` does: the difference and the
    hidden layer, the sums in float32."""
    up, rnd = rounding(o_s.dtype)
    d = rnd(up(o_s)[:, :, None, :] - up(cand))
    h = rnd(torch.relu(d @ up(w1) + up(b1)))
    return (h @ up(w2))[..., 0] + up(b2)[0]


def _shortlist(S_idx, num_targets):
    if isinstance(S_idx, Shortlist):
        return S_idx
    return Shortlist(S_idx, num_targets)


def sc_work(B, N_s, N_t, K, R, T=None, elem=4):
    """The least work of the function in the factored form, forward and
    (``'bwd'``) backward. ``T``: the target rows the shortlist points at
    (all ``B*N_t`` if None), the only ones the forward needs. Operations:
    node products 2(N_s+N_t)R^2 each (u forward, over the touched target
    rows; u again, d_o and d_W1 backward); per candidate 3R forward
    (difference, product, sum) and 6R backward (the difference, g*w2
    where positive, its sums into d_u_s and d_u_t, 2R for d_w2). Bytes:
    o_s, o_t, the shortlist at 4 bytes a slot, the weights (and g) read
    once, delta (or d_o_s, d_o_t and the weight gradients) written once.
    The backward given the forward's u (as the main path calls it) saves
    one node product but reads u_s and u_t too: at the DBP15K shape its
    bound (bytes) lies above this one, so this one is the least.
    ``elem``: bytes a value of o, the weights and their gradients (4, or
    2 for bf16; delta and g stay float32)."""
    nodes = 2.0 * B * (N_s + N_t) * R * R
    cand = B * N_s * K
    rows = elem * B * (N_s + N_t) * R
    weights = elem * (R * R + 2 * R + 1)
    fwd_rows = B * N_s + (B * N_t if T is None else T)
    return {'kernel': 'sparse_consensus_fwd',
            'flops': 2.0 * fwd_rows * R * R + 3.0 * cand * R,
            'bytes': elem * fwd_rows * R + 4.0 * cand + 4.0 * cand + weights,
            'out_bytes': 4.0 * cand, 'dot': True,
            'bwd': {'kernel': 'sparse_consensus_bwd',
                    'flops': 3 * nodes + 6.0 * cand * R,
                    'bytes': 2 * rows + 4.0 * cand + 4.0 * cand
                    + 2 * weights,
                    'out_bytes': rows + weights, 'dot': True}}


def touched_rows(sl):
    """Target rows of the flattened batch that a shortlist points at."""
    b = torch.arange(sl.shape[0], device=sl.flat.device)[:, None]
    return int(torch.unique(sl.flat + b * sl.num_targets).numel())


def _call_work(o_s, o_t, S_idx, *_weights, **_kw):
    sl = _shortlist(S_idx, o_t.shape[1])
    B, N_s, R = o_s.shape
    return sc_work(B, N_s, o_t.shape[1], sl.shape[2], R, touched_rows(sl),
                   o_s.element_size())


def _bwd_work(*args, **kw):
    return _call_work(*args, **kw)['bwd']


@dispatch.counted('fused_candidate_delta', _call_work)
def plain_fused_candidate_delta(o_s, o_t, S_idx, w1, b1, w2, b2):
    """Gather the candidate rows of ``o_t [B, N_t, R]``, then
    :func:`plain_sparse_consensus_delta`."""
    sl = _shortlist(S_idx, o_t.shape[1])
    return plain_sparse_consensus_delta(o_s, sl.gather(o_t), w1, b1, w2, b2)


def _factored(o_s, o_t, w1, b1):
    """``u_s = o_s W1 + b1`` and ``u_t = o_t W1``: ``(o_s - o_t) W1 + b1
    = u_s - u_t``; in the inputs' dtype, the sums in (at least) float32
    and, for bfloat16, rounded as the kernel rounds them:
    ``bf16(bf16(o_s W1) + b1)`` and ``bf16(o_t W1)``."""
    up, rnd = rounding(o_s.dtype)
    dt = o_s.dtype
    return ((rnd(up(o_s) @ up(w1)) + up(b1)).to(dt),
            (up(o_t) @ up(w1)).to(dt))


def _plain_fwd(o_s, o_t, sl, w1, b1, w2, b2):
    up, rnd = rounding(o_s.dtype)
    u_s, u_t = _factored(o_s, o_t, w1, b1)
    pre = rnd(up(u_s)[:, :, None, :] - up(sl.gather(u_t)))
    return (torch.relu(pre) @ up(w2))[..., 0] + up(b2)[0], (u_s, u_t)


@dispatch.counted('sparse_consensus_fwd', _call_work)
def plain_sparse_consensus_fwd(o_s, o_t, S_idx, w1, b1, w2, b2):
    """The delta in the kernels' factored form, in plain PyTorch:
    ``relu(u_s[s] - u_t[t]) @ w2 + b2``. Holds ``[B, N_s, K, R]`` while
    it runs."""
    return _plain_fwd(o_s, o_t, _shortlist(S_idx, o_t.shape[1]), w1, b1,
                      w2, b2)[0]


def _node_grads(o_s, o_t, w1, d_us, d_ut):
    """``(d_o_s, d_o_t, d_w1, d_b1)`` from the gradients w.r.t. ``u_s`` and
    ``u_t`` (in the sums' dtype): node-level products, no per-candidate
    work (the kernel forms them in its epilogues)."""
    up = lambda a: a.to(d_us.dtype)  # noqa: E731
    d_w1 = (torch.einsum('bsr,bsq->rq', up(o_s), d_us)
            + torch.einsum('btr,btq->rq', up(o_t), d_ut))
    return (d_us @ up(w1).T, d_ut @ up(w1).T, d_w1,
            d_us.sum(dim=(0, 1)))


@dispatch.counted('sparse_consensus_bwd', _bwd_work)
def plain_sparse_consensus_bwd(o_s, o_t, S_idx, w1, b1, w2, g, state=None):
    """Gradients of ``sum(g * delta)`` w.r.t. ``(o_s, o_t, w1, b1, w2,
    b2)`` in the kernels' factored form, in plain PyTorch: with ``pre =
    u_s[s] - u_t[t]`` and ``d_pre = g * w2`` where ``pre > 0``, ``d_u_s``
    sums ``d_pre`` over each row's candidates and ``d_u_t`` minus
    ``d_pre`` over the slots pointing at each target (the shortlist's
    receiver order). ``state = (u_s, u_t)``: the forward's node rows, else
    formed here. Every sum runs in (at least) float32; each gradient is
    cast to the operands' dtype once. Holds ``[B, N_s, K, R]`` while it
    runs."""
    sl = _shortlist(S_idx, o_t.shape[1])
    up, rnd = rounding(o_s.dtype)
    u_s, u_t = _factored(o_s, o_t, w1, b1) if state is None else state
    g = up(g)
    pre = rnd(up(u_s)[:, :, None, :] - up(sl.gather(u_t)))
    d_pre = torch.where(pre > 0, g[..., None] * up(w2)[:, 0], 0.0)
    d_us = d_pre.sum(dim=2)
    d_ut = -sl.scatter(d_pre)
    d_w2 = torch.einsum('bskq,bsk->q', torch.relu(pre), g)[:, None]
    grads = (*_node_grads(o_s, o_t, w1, d_us, d_ut), d_w2,
             g.sum().reshape(1))
    return tuple(d.to(o_s.dtype) for d in grads)


#: Warps (source rows at a time) per block of the backward's candidate
#: kernel, and threads per block of its node pass.
BWD_WARPS, NODE_THREADS = 8, 128


def node_rows(R):
    """Rows per block of the backward's node pass (as of the forward's
    projection): each of the 128 threads owns 4 rows x 4 channels, so a
    block takes ``4 * 128 / (ceil(R / 4))`` rows (64 at R = 32)."""
    return 4 * (NODE_THREADS // -(-R // 4))


def bwd_plan(rows_s, rows_t, R, n_chunks, cap):
    """``(src_blocks, chunk_blocks, node_blocks)`` of one backward, a pure
    function of the row and chunk counts, R and ``cap``, the candidate
    kernel's blocks that the card holds at once (its SM count times the
    blocks per SM the compiled kernel allows).

    The candidate kernel's source blocks walk the source rows and its
    chunk blocks the chunks, ``BWD_WARPS`` at a time, each pipelining the
    next item's loads behind the current one's: the two share one wave of
    ``cap`` blocks, three quarters for the source rows (their random u_t
    rows are the kernel's bytes; a chunk costs a few small reads) and the
    rest for the chunks, fewer where there are fewer items (each source
    block also leaves one partial sum of ``d_w2`` and ``d_b2``).
    The node pass takes one block per :func:`node_rows` source rows, then
    one per as many target rows."""
    br = node_rows(R)
    src = max(1, min(-(-rows_s // BWD_WARPS), 3 * cap // 4))
    chunk = max(1, min(-(-n_chunks // BWD_WARPS), cap - src))
    return src, chunk, -(-rows_s // br) + -(-rows_t // br)


def projection(candidates, target_rows):
    """``(touched, reason)``: how the CUDA forward forms u_t. With fewer
    candidates (``B*N_s*K``) than target rows (``B*N_t``), as a serve or
    eval query has, its candidate kernel forms u_s and each candidate's
    u_t itself: fewer products than projecting every target row, and one
    launch instead of two. Otherwise ``project_rows`` forms every u row
    first and each is read by the candidates that point at it. Both sum
    in one order, so the delta is the same to the bit either way. On the
    H100 (``chip_smoke.py --kernels``, R = 32, K = 10) the touched form
    is the faster at as many candidates as target rows and the slower
    from one and a half times as many: the crossover lies between."""
    if candidates < target_rows:
        return True, (f'touched rows: {candidates} candidates < '
                      f'{target_rows} target rows')
    return False, (f'all rows: {candidates} candidates >= {target_rows} '
                   f'target rows')


#: The kernels' entry points for each input dtype they take.
_FWD = {torch.float32: 'dgmc_sc_fwd_f32', torch.bfloat16: 'dgmc_sc_fwd_bf16'}
_BWD = {torch.float32: 'dgmc_sc_bwd_f32', torch.bfloat16: 'dgmc_sc_bwd_bf16'}


def _library():
    from dgmc_tpu_torch.ops.kernels.build import load_library
    lib = load_library('sparse_consensus.cu')
    if not getattr(lib, 'sc_bound', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in _FWD.values():
            getattr(lib, name).argtypes = [p] * 11 + [i] * 7 + [p]
        for name in _BWD.values():
            getattr(lib, name).argtypes = [p] * 20 + [i] * 9 + [p]
        lib.dgmc_sc_bwd_blocks_per_sm.argtypes = [i, i, i]
        lib.dgmc_sc_node_rows.argtypes = [i]
        if lib.dgmc_sc_r_max() != R_MAX or any(
                lib.dgmc_sc_node_rows(R) != node_rows(R)
                for R in range(1, R_MAX + 1)):
            raise RuntimeError('csrc/sparse_consensus.cu is built for '
                               'another R_MAX or node pass than the '
                               'wrapper')
        lib.sc_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_cap(index, R, dtype):
    """Blocks of the backward's candidate kernel the card holds at once
    at this R and input dtype."""
    per_sm = _library().dgmc_sc_bwd_blocks_per_sm(
        R, int(dtype == torch.bfloat16), index)
    if per_sm < 1:
        raise RuntimeError(f'sparse_consensus_bwd: no block fits on an SM '
                           f'at R={R} (CUDA error {-per_sm})')
    return per_sm * sm_count(index)


def _check(name, o_s, o_t, sl, weights, g=None):
    """Shapes, devices and (on CUDA) dtypes and the R limit → device.
    ``weights``: ``(w1, b1, w2, b2)``, or ``(w1, b1, w2)`` and the output
    gradient ``g`` (checked for device too; on CUDA it is float32, the
    delta's dtype, or the operands')."""
    if o_s.dim() != 3 or o_t.dim() != 3 or o_s.shape[0] != o_t.shape[0] \
            or o_s.shape[2] != o_t.shape[2]:
        raise ValueError(f'{name} wants o_s [B, N_s, R] and o_t [B, N_t, R]; '
                         f'got {tuple(o_s.shape)} and {tuple(o_t.shape)}')
    B, N_s, R = o_s.shape
    N_t = o_t.shape[1]
    if sl.shape[:2] != (B, N_s) or sl.num_targets != N_t:
        raise ValueError(f'{name}: shortlist {sl.shape} over '
                         f'{sl.num_targets} targets does not fit o_s '
                         f'{tuple(o_s.shape)} / o_t {tuple(o_t.shape)}')
    w1, b1, w2 = weights[:3]
    if (tuple(w1.shape) != (R, R) or tuple(b1.shape) != (R,)
            or tuple(w2.shape) != (R, 1)
            or any(tuple(b.shape) != (1,) for b in weights[3:])):
        raise ValueError(f'{name}: consensus MLP shapes '
                         f'{[tuple(w.shape) for w in weights]} do not fit '
                         f'R={R}')
    tensors = (o_s, o_t, *weights) + (() if g is None else (g,))
    devs = {a.device for a in tensors} | {sl.device}
    if len(devs) != 1:
        raise ValueError(f'{name} inputs lie on several devices: '
                         f'{sorted(map(str, devs))}')
    dev = o_s.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on cpu or cuda, not {dev.type}')
    if dev.type == 'cuda':
        floats = (o_s, o_t, *weights)
        dt = o_s.dtype
        if (dt not in _FWD or any(a.dtype != dt for a in floats)
                or (g is not None and g.dtype not in (torch.float32, dt))):
            raise TypeError(f'the {name} kernel takes float32 or bfloat16, '
                            f'every operand in one dtype; got '
                            f'{sorted({str(a.dtype) for a in tensors})}')
        if R > R_MAX:
            raise ValueError(f'the {name} kernel takes R <= {R_MAX}; got '
                             f'R={R}')
    return dev


def _stream(device):
    s = torch.cuda.current_stream(device)
    return s.device_index, s.cuda_stream


@dispatch.kernel_wrapper('sparse_consensus_fwd')
@dispatch.counted('sparse_consensus_fwd')
def sparse_consensus_fwd(o_s, o_t, S_idx, w1, b1, w2, b2, return_state=False):
    """The delta ``[B, N_s, K]`` float32 (no gradient; see
    :func:`fused_candidate_delta`). With ``return_state``: ``(delta,
    state)``, what :func:`sparse_consensus_bwd` takes from its forward:
    ``(u_s, u_t)``, the factored form's node rows, and on CUDA also
    ``mask`` ``[B*N_s*K, ceil(R/32)]`` int32, the ReLU mask's bits per
    candidate (bit l of word c: ``pre > 0`` in channel ``l + 32 c``).

    On CUDA, :func:`projection` chooses how u_t is formed; with touched
    rows the state's ``u_t`` holds the rows the shortlist points at and
    zeros elsewhere (the backward reads no other)."""
    sl = _shortlist(S_idx, o_t.shape[1])
    args = [a.detach() for a in (o_s, o_t, w1, b1, w2, b2)]
    dev = _check('sparse_consensus_fwd', args[0], args[1], sl, args[2:])
    dt = o_s.dtype
    if dev.type == 'cpu':
        dispatch.record('sparse_consensus_fwd', 'plain', 'device=cpu', dt)
        with torch.no_grad():
            out, state = _plain_fwd(args[0], args[1], sl, *args[2:])
        return (out, state) if return_state else out
    B, N_s, K = sl.shape
    N_t, R = o_t.shape[1], o_s.shape[2]
    if dt == torch.float32:
        touched, reason = projection(B * N_s * K, B * N_t)
    else:
        touched, reason = False, ('all rows: the touched-row form is '
                                  'float32 only')
    dispatch.record('sparse_consensus_fwd', 'kernel', f'auto-cuda, {reason}',
                    dt)
    lib = _library()
    o_s, o_t, w1, b1, w2, b2 = (a.contiguous() for a in args)
    if not touched:
        u_s, u_t = torch.empty_like(o_s), torch.empty_like(o_t)
    elif return_state:
        u_s, u_t = torch.empty_like(o_s), torch.zeros_like(o_t)
    else:
        u_s = u_t = None
    out = torch.empty((B, N_s, K), dtype=torch.float32, device=dev)
    mask = (torch.empty((B * N_s * K, -(-R // 32)), dtype=torch.int32,
                        device=dev) if return_state else None)

    def ptr(x):
        return None if x is None else x.data_ptr()
    err = getattr(lib, _FWD[dt])(
        o_s.data_ptr(), o_t.data_ptr(), sl.idx32.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ptr(u_s), ptr(u_t),
        out.data_ptr(), ptr(mask), B, N_s, N_t, K, R, int(touched),
        *_stream(dev))
    if err != 0:
        raise RuntimeError(f'sparse_consensus_fwd kernel launch failed with '
                           f'CUDA error {err} (B={B}, N_s={N_s}, N_t={N_t}, '
                           f'K={K}, R={R}, touched={bool(touched)}, {dt})')
    sparse_consensus_fwd.launches += 1
    return (out, (u_s, u_t, mask)) if return_state else out


@dispatch.kernel_wrapper('sparse_consensus_bwd')
@dispatch.counted('sparse_consensus_bwd')
def sparse_consensus_bwd(o_s, o_t, S_idx, w1, b1, w2, g, state=None):
    """Gradients of ``sum(g * delta)`` →
    ``(d_o_s, d_o_t, d_w1, d_b1, d_w2, d_b2)``. ``state``: the forward's
    (``sparse_consensus_fwd(..., return_state=True)`` on the same device).
    The kernel takes u and the ReLU mask from it and runs no projection,
    so on CUDA it is required; without it the plain version forms u."""
    sl = _shortlist(S_idx, o_t.shape[1])
    args = [a.detach() for a in (o_s, o_t, w1, b1, w2)]
    g = g.detach()
    dev = _check('sparse_consensus_bwd', args[0], args[1], sl, args[2:], g)
    if tuple(g.shape) != sl.shape:
        raise ValueError(f'sparse_consensus_bwd: g {tuple(g.shape)} does not '
                         f'fit the shortlist {sl.shape}')
    B, N_s, K = sl.shape
    R = args[0].shape[2]
    if state is None and dev.type == 'cuda':
        raise ValueError('sparse_consensus_bwd on CUDA takes the forward\'s '
                         'state: sparse_consensus_fwd(..., '
                         'return_state=True)')
    if state is not None:
        state = tuple(x.detach() for x in state)
        want = [(tuple(a.shape), a.device, a.dtype) for a in args[:2]]
        if dev.type == 'cuda':
            want.append(((B * N_s * K, -(-R // 32)), dev, torch.int32))
        got = [(tuple(x.shape), x.device, x.dtype) for x in state]
        if got != want:
            raise ValueError(f'sparse_consensus_bwd: state must be the '
                             f'forward\'s, {want}; got {got}')
    dt = args[0].dtype
    if dev.type == 'cpu':
        dispatch.record('sparse_consensus_bwd', 'plain', 'device=cpu', dt)
        with torch.no_grad():
            return plain_sparse_consensus_bwd(args[0], args[1], sl,
                                              *args[2:], g, state)
    dispatch.record('sparse_consensus_bwd', 'kernel', 'auto-cuda', dt)
    lib = _library()
    o_s, o_t, w1, w2 = (a.contiguous() for a in (*args[:3], args[4]))
    g = g.to(torch.float32).contiguous()
    N_t = o_t.shape[1]
    u_s, u_t, mask = (x.contiguous() for x in state)
    index, stream = _stream(dev)
    chunk_start, max_chunks = sl.chunks
    src_blocks, chunk_blocks, node_blocks = bwd_plan(
        B * N_s, B * N_t, R, max_chunks, _bwd_cap(index, R, dt))

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    d_us, d_os = empty(B, N_s, R), empty(B, N_s, R, dtype=dt)
    d_ut, d_ot = empty(B, N_t, R), empty(B, N_t, R, dtype=dt)
    tgt_partial = empty(max_chunks, R)
    wpart, npart = empty(src_blocks, R + 1), empty(node_blocks, R * R + R)
    grads = empty(R * R + 2 * R + 1)
    err = getattr(lib, _BWD[dt])(
        o_s.data_ptr(), o_t.data_ptr(), sl.idx32.data_ptr(), w1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), sl.order32.data_ptr(),
        sl.chunk_map.data_ptr(), chunk_start.data_ptr(), u_s.data_ptr(),
        u_t.data_ptr(), mask.data_ptr(), d_us.data_ptr(), d_ut.data_ptr(),
        d_os.data_ptr(), d_ot.data_ptr(), tgt_partial.data_ptr(),
        wpart.data_ptr(), npart.data_ptr(), grads.data_ptr(), B, N_s, N_t, K,
        R, max_chunks, src_blocks, chunk_blocks, index, stream)
    if err != 0:
        raise RuntimeError(f'sparse_consensus_bwd kernel launch failed with '
                           f'CUDA error {err} (B={B}, N_s={N_s}, N_t={N_t}, '
                           f'K={K}, R={R}, {dt})')
    sparse_consensus_bwd.launches += 1
    # The weights' gradients leave their float32 sums in the operands'
    # dtype (one rounding; d_o_s and d_o_t come out of the kernel so).
    grads = grads.to(dt)
    return (d_os, d_ot, grads[:R * R].view(R, R), grads[R * R:R * R + R],
            grads[R * R + R:R * R + 2 * R, None], grads[R * R + 2 * R:])


class _FusedCandidateDelta(torch.autograd.Function):

    @staticmethod
    def forward(ctx, o_s, o_t, w1, b1, w2, b2, sl, keep_state):
        ctx.sl = sl
        out = sparse_consensus_fwd(o_s, o_t, sl, w1, b1, w2, b2,
                                   return_state=keep_state)
        # The forward's state (u_s, u_t and, on CUDA, its ReLU mask bits):
        # the backward runs no projection and reads the forward's own
        # mask. Nothing is kept without a gradient to take.
        out, state = out if keep_state else (out, ())
        ctx.save_for_backward(o_s, o_t, w1, b1, w2, *state)
        return out

    @staticmethod
    def backward(ctx, g):
        o_s, o_t, w1, b1, w2, *state = ctx.saved_tensors
        grads = sparse_consensus_bwd(o_s, o_t, ctx.sl, w1, b1, w2, g,
                                     tuple(state) or None)
        return tuple(d if need else None for d, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None)


@dispatch.counted('fused_candidate_delta')
def fused_candidate_delta(o_s, o_t, S_idx, w1, b1, w2, b2):
    """``mlp(o_s[:, :, None] - o_t[S_idx])`` → ``[B, N_s, K]``,
    differentiable in every float argument; see the module docstring."""
    sl = _shortlist(S_idx, o_t.shape[1])
    floats = (o_s, o_t, w1, b1, w2, b2)
    keep_state = torch.is_grad_enabled() and any(a.requires_grad
                                                 for a in floats)
    return _FusedCandidateDelta.apply(*floats, sl, keep_state)


def sparse_consensus_delta(o_s, cand, w1, b1, w2, b2):
    """``mlp(o_s[:, :, None] - cand)`` for pre-gathered candidates
    ``cand [B, N_s, K, R]`` → ``[B, N_s, K]``, through the same kernels:
    ``cand`` is a ``[B, N_s*K, R]`` table under the identity shortlist."""
    B, N_s, K, R = cand.shape
    sl = Shortlist.identity(B, N_s, K, cand.device)
    return fused_candidate_delta(o_s, cand.reshape(B, N_s * K, R), sl, w1,
                                 b1, w2, b2)
