"""Correspondence metrics the serving answer reports."""

import torch

__all__ = ['entropy', 'delta_norm']

_EPS = 1e-12


def _row_mean(per_row, row_mask):
    if row_mask is None:
        return per_row.mean()
    m = row_mask.to(per_row.dtype)
    return (per_row * m).sum() / m.sum().clamp(min=1.0)


def entropy(S, row_mask=None):
    """Mean per-row entropy of a probability tensor ``[..., rows, C]``
    (zero entries contribute zero; ``row_mask`` selects valid rows)."""
    S = S.to(torch.float32)
    h = -torch.where(S > 0, S * torch.log(S.clamp(min=_EPS)),
                     0.0).sum(dim=-1)
    return _row_mean(h, row_mask)


def delta_norm(S_new, S_old, row_mask=None):
    """Mean-over-batch Frobenius norm of ``S_new - S_old`` (rows outside
    ``row_mask`` zeroed)."""
    d = (S_new - S_old).to(torch.float32)
    if row_mask is not None:
        d = d * row_mask[..., None].to(d.dtype)
    dims = tuple(range(1, d.dim()))
    return torch.sqrt((d * d).sum(dim=dims)).mean()
