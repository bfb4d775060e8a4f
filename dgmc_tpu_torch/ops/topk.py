"""Top-k correspondence candidates without materializing the score matrix.

``dense_topk`` ranks the full score matrix; ``chunked_topk`` streams the
target axis (the CUDA kernel on the card, the plain blockwise scan on
the CPU, :mod:`dgmc_tpu_torch.ops.kernels.topk`); ``streamed_topk`` also
streams the source axis, in chunks of rows, each through
``chunked_topk``: rows are independent, so each chunk's picks are its
rows' global answer and the result is bit-identical to the unchunked
search (the kernels select each row's exact top-k whatever the launch
plan cuts, and merge by value, then index). All keep the JAX
package's rules: values descending with the lowest index first among
equal values, masked columns at ``finfo.min``, and a running carry that
starts at ``-inf``. ``torch.topk`` does not promise that tie order, so
selection here is a stable descending sort.
"""

import torch

from dgmc_tpu_torch.ops.kernels.topk import streaming_topk

__all__ = ['DEFAULT_BLOCK', 'DEFAULT_TOPK_BLOCK', 'DEFAULT_STREAM_CHUNK',
           'stable_topk', 'dense_topk', 'chunked_topk', 'streamed_topk']

#: The JAX package's target block of the blockwise scan
#: (``dgmc_tpu/ops/topk.py``): it tiles the plain scan only; the CUDA
#: kernels ignore it, as the Pallas kernel does.
DEFAULT_BLOCK = 256
#: The JAX package's partition-rule names of the two defaults
#: (``dgmc_tpu/parallel/rules.py``): the candidate search's target block
#: and the source chunk of the streamed search.
DEFAULT_TOPK_BLOCK = DEFAULT_BLOCK
DEFAULT_STREAM_CHUNK = 8192


def stable_topk(x, k, dim=-1):
    """``(values, positions)`` of the ``k`` largest entries along ``dim``,
    sorted descending, lowest position first among equal values."""
    vals, pos = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), pos.narrow(dim, 0, k)


def dense_topk(h_s, h_t, k, t_mask=None):
    """Top-k over the fully materialized score matrix: h_s ``[B, N_s, C]``,
    h_t ``[B, N_t, C]`` → int32 indices ``[B, N_s, k]``; invalid target
    columns (``t_mask`` False) rank last."""
    with torch.no_grad():
        # Products and sums in (at least) float32, each score rounded to
        # the inputs' dtype (bfloat16), as the streaming search rounds it.
        acc = torch.promote_types(h_s.dtype, torch.float32)
        scores = torch.bmm(h_s.to(acc), h_t.to(acc).transpose(1, 2)).to(
            h_s.dtype)
        if t_mask is not None:
            scores = scores.masked_fill(~t_mask[:, None, :],
                                        torch.finfo(scores.dtype).min)
        return stable_topk(scores, k)[1].to(torch.int32)


def chunked_topk(h_s, h_t, k, t_mask=None, block=DEFAULT_BLOCK,
                 return_values=False):
    """Running top-k of ``h_s @ h_t^T`` along the target axis, identical
    to :func:`dense_topk` (tie order included) while never holding the
    full score matrix. ``block`` tiles the plain scan's targets.
    ``return_values`` also returns the scores (``(vals, idx)``)."""
    vals, idx = streaming_topk(h_s, h_t, k, t_mask, block)
    return (vals, idx) if return_values else idx


def streamed_topk(h_s, h_t, k, chunk, t_mask=None, block=DEFAULT_BLOCK,
                  return_values=False):
    """:func:`chunked_topk` over chunks of ``chunk`` source rows (the last
    one ragged), one search each, in order: bit-identical to the unchunked
    search, while a search only holds ``chunk`` rows' scores."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f'stream chunk must be >= 1; got {chunk}')
    parts = [chunked_topk(h_s[:, lo:lo + chunk], h_t, k, t_mask, block,
                          return_values=True)
             for lo in range(0, h_s.shape[1], chunk)]
    vals = torch.cat([v for v, _ in parts], dim=1)
    idx = torch.cat([i for _, i in parts], dim=1)
    return (vals, idx) if return_values else idx
