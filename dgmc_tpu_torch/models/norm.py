"""Mask-aware batch normalization.

Batch statistics over padded ``[B, N, C]`` node tensors must leave the
padding out, or its zero rows would bias the mean and variance; this
batch norm takes the node mask into account, as the JAX package's
``MaskedBatchNorm`` does.

Conventions (those of the JAX package, not of ``nn.BatchNorm1d``):

- running averages follow flax's momentum, ``ra = 0.9 * ra + 0.1 *
  batch`` (``nn.BatchNorm1d``'s ``momentum = 0.1`` means the same update
  with the opposite naming);
- the running variance is the unbiased one (Bessel's ``n / (n - 1)``,
  ``n = max(Σ mask, 1)``); normalization uses the biased one;
- the statistics are float32 under every precision policy, and the
  output is what ``(x - mean) / sqrt(var + eps) * scale + bias`` gives:
  float32 for a bf16 ``x`` (the float32 statistics promote it);
- ``eval()`` normalizes by the running averages.

The running averages are buffers (``mean`` zeros, ``var`` ones at
start), updated in place in training mode: a captured CUDA graph reads
and writes their storage, so they are never rebound.

Under data parallelism the module's ``stats_group`` (a process group,
set on every batch norm of a model by :func:`sync_batch_stats`, which
the sharded steps of :mod:`~dgmc_tpu_torch.parallel.sharding` call on
their model, as ``nn.SyncBatchNorm.convert_sync_batchnorm`` gives a
model its group) makes the masked sums, sums of squares and counts sums
over that group, differentiably, so the statistics and running averages
are those of the global batch on every rank, as GSPMD makes them in the
JAX package. Without a group (``None``, the default) they are this
rank's batch's.
"""

import torch
from torch import nn

__all__ = ['MaskedBatchNorm', 'sync_batch_stats']


def sync_batch_stats(module, group):
    """Set ``group`` (a process group; ``None``: each rank's batch alone)
    as the statistics' group of every :class:`MaskedBatchNorm` in
    ``module``; returns ``module``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.stats_group = group
    return module


def _global_stats(xf, w, group):
    """``(mean, var, n)`` of the rows ``xf [M, C]`` weighted by ``w [M, 1]``
    (``None``: every row) over ``group``'s ranks: the same two passes as
    one rank's, each sum all-reduced."""
    from dgmc_tpu_torch.parallel.comm import all_reduce_, all_reduce_sum
    if w is None:
        w = xf.new_ones((xf.shape[0], 1))
    n = all_reduce_(w.sum().detach().clone(), group).clamp(min=1.0)
    mean = all_reduce_sum((xf * w).sum(dim=0), group) / n
    var = all_reduce_sum((((xf - mean) ** 2) * w).sum(dim=0), group) / n
    return mean, var, n


class MaskedBatchNorm(nn.Module):
    """Batch norm over the last axis of ``x [..., C]``; ``mask`` (the
    node mask, ``x.shape[:-1]``) selects the rows the statistics count."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('mean', torch.zeros(num_features))
        self.register_buffer('var', torch.ones(num_features))
        self.stats_group = None

    def reset_parameters(self, generator=None):
        """Flax's initial state: ``scale`` ones, ``bias`` zeros, running
        ``mean`` zeros and ``var`` ones (nothing is drawn)."""
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, mask=None):
        C = x.shape[-1]
        if not self.training:
            mean, var = self.mean, self.var
        else:
            acc = torch.promote_types(x.dtype, torch.float32)
            xf = x.to(acc).reshape(-1, C)
            if self.stats_group is not None:
                mean, var, n = _global_stats(
                    xf, None if mask is None else mask.to(acc).reshape(-1, 1),
                    self.stats_group)
                bessel = n / (n - 1.0).clamp(min=1.0)
            elif mask is None:
                n = float(xf.shape[0])
                mean = xf.mean(dim=0)
                var = ((xf - mean) ** 2).mean(dim=0)
                bessel = n / max(n - 1.0, 1.0)
            else:
                w = mask.to(acc).reshape(-1, 1)
                n = w.sum().clamp(min=1.0)
                mean = (xf * w).sum(dim=0) / n
                var = (((xf - mean) ** 2) * w).sum(dim=0) / n
                bessel = n / (n - 1.0).clamp(min=1.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * (var * bessel))
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        return y * self.scale + self.bias

    def extra_repr(self):
        return (f'{self.num_features}, momentum={self.momentum}, '
                f'epsilon={self.epsilon}')
