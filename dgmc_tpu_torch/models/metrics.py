"""Correspondence losses and retrieval metrics, dense and sparse.

Ground truths are padded ``y [B, N_s]`` target columns with a validity
mask, so every reduction is a masked mean or sum. Ties resolve lowest
index first, as ``jnp.argmax`` and ``lax.top_k`` do in the JAX package:
``torch.argmax`` returns the first maximum and the top-k is a stable
descending sort. For sparse correspondences a ground truth absent from
the candidates contributes nothing to the loss.
"""

import torch

from dgmc_tpu_torch.ops.topk import stable_topk

__all__ = ['EPS', 'nll_loss', 'nll_terms', 'acc', 'hits_at_k']

EPS = 1e-8


def _prep(y, y_mask):
    y = y.long()
    if y_mask is None:
        y_mask = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    return y, y_mask


def _gt_val(S, y):
    """Probability mass on the ground-truth column, and whether that
    column is among the candidates at all."""
    if S.is_sparse:
        hit = S.idx == y[..., None]
        return (S.val * hit).sum(-1), hit.any(-1)
    val = torch.gather(S.val, -1, y.clamp(min=0)[..., None])[..., 0]
    return val, torch.ones(y.shape, dtype=torch.bool, device=y.device)


def _nll(S, y, y_mask):
    """The masked NLL ``[B, N_s]`` and its mask (valid rows whose ground
    truth is a candidate)."""
    y, y_mask = _prep(y, y_mask)
    val, found = _gt_val(S, y)
    m = y_mask & found
    return -torch.log(val + EPS) * m, m


def nll_loss(S, y, y_mask=None, reduction='mean'):
    """Negative log-likelihood of the ground-truth correspondences.

    ``reduction``: ``'mean'`` (over every valid correspondence in the
    batch), ``'sum'``, ``'none'`` (``[B, N_s]``) or ``'per_pair'`` (a
    ``[B]`` masked mean per pair).
    """
    nll, m = _nll(S, y, y_mask)
    if reduction == 'none':
        return nll
    if reduction == 'per_pair':
        axes = tuple(range(1, nll.dim()))
        return nll.sum(axes) / m.sum(axes).clamp(min=1)
    total = nll.sum()
    if reduction == 'sum':
        return total
    return total / m.sum().clamp(min=1)


def nll_terms(S, y, y_mask=None, per_pair=False):
    """``(sum, count)`` of the NLL over the valid correspondences whose
    ground truth is a candidate (scalars, or ``[B]`` with ``per_pair``):
    the parts of :func:`nll_loss`'s mean that a row-sharded step sums over
    its ranks."""
    nll, m = _nll(S, y, y_mask)
    if per_pair:
        axes = tuple(range(1, nll.dim()))
        return nll.sum(axes), m.sum(axes)
    return nll.sum(), m.sum()


def _dense_scores(S):
    return torch.where(S.tgt_mask[:, None, :], S.val,
                       torch.finfo(S.val.dtype).min)


def acc(S, y, y_mask=None, reduction='mean'):
    """Hits@1: the share of valid ground truths whose argmax is right."""
    y, y_mask = _prep(y, y_mask)
    if S.is_sparse:
        best = torch.argmax(S.val, dim=-1)
        pred = torch.gather(S.idx, -1, best[..., None])[..., 0]
    else:
        pred = torch.argmax(_dense_scores(S), dim=-1)
    correct = ((pred == y) & y_mask).sum()
    if reduction == 'sum':
        return correct
    return correct / y_mask.sum().clamp(min=1)


def hits_at_k(k, S, y, y_mask=None, reduction='mean'):
    """Hits@k: the share of valid ground truths ranked in the top ``k``."""
    y, y_mask = _prep(y, y_mask)
    kk = min(k, S.val.shape[-1])
    if S.is_sparse:
        _, pos = stable_topk(S.val, kk)
        pred = torch.gather(S.idx, -1, pos)
    else:
        _, pred = stable_topk(_dense_scores(S), kk)
    correct = ((pred == y[..., None]).any(-1) & y_mask).sum()
    if reduction == 'sum':
        return correct
    return correct / y_mask.sum().clamp(min=1)
