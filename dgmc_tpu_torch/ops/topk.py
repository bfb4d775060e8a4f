"""Top-k correspondence candidates without materializing the score matrix.

``dense_topk`` ranks the full score matrix; ``chunked_topk`` streams the
target axis (the CUDA kernel on the card, the plain blockwise scan on
the CPU, :mod:`dgmc_tpu_torch.ops.kernels.topk`). Both keep the JAX
package's rules: values descending with the lowest index first among
equal values, masked columns at ``finfo.min``, and a running carry that
starts at ``-inf``. ``torch.topk`` does not promise that tie order, so
selection here is a stable descending sort.
"""

import torch

from dgmc_tpu_torch.ops.kernels.topk import streaming_topk

__all__ = ['stable_topk', 'dense_topk', 'chunked_topk']


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


def chunked_topk(h_s, h_t, k, t_mask=None, return_values=False):
    """Running top-k of ``h_s @ h_t^T`` along the target axis, identical
    to :func:`dense_topk` (tie order included) while never holding the
    full score matrix. ``return_values`` also returns the scores
    (``(vals, idx)``)."""
    vals, idx = streaming_topk(h_s, h_t, k, t_mask)
    return (vals, idx) if return_values else idx
