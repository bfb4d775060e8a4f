"""Matching models: DGMC and its backbones (RelCNN, SplineCNN, GIN, MLP,
MaskedBatchNorm)."""

from dgmc_tpu_torch.models.norm import MaskedBatchNorm
from dgmc_tpu_torch.models.mlp import MLP
from dgmc_tpu_torch.models.gin import GIN, GINConv
from dgmc_tpu_torch.models.rel import RelCNN, RelConv
from dgmc_tpu_torch.models.spline import SplineCNN, SplineConv
from dgmc_tpu_torch.models.dgmc import DGMC, Correspondence

__all__ = ['MaskedBatchNorm', 'MLP', 'GIN', 'GINConv', 'RelCNN', 'RelConv',
           'SplineCNN', 'SplineConv', 'DGMC', 'Correspondence']
