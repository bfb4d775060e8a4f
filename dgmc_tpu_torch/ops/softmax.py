"""Masked softmax over padded correspondence scores."""

import torch

__all__ = ['masked_softmax']


def masked_softmax(src, mask, dim=-1):
    """Softmax of ``src`` along ``dim`` restricted to ``mask``.

    Entries outside ``mask`` get probability 0. Rows with no valid entry
    return all zeros instead of NaN.
    """
    finfo = torch.finfo(src.dtype)
    masked = torch.where(mask, src, finfo.min)
    m = masked.amax(dim=dim, keepdim=True)
    # Guard fully-masked rows: their max is finfo.min; shift so exp() is
    # finite.
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(masked - m) * mask.to(src.dtype)
    denom = e.sum(dim=dim, keepdim=True)
    return e / denom.clamp(min=finfo.tiny)
