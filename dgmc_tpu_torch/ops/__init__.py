"""Tensor operations: padded graphs, segment reductions, masked softmax,
top-k search, the spline basis (the JAX package's ``dgmc_tpu.ops``
names)."""

from dgmc_tpu_torch.ops.graph import (GraphBatch, gather_nodes,
                                      scatter_to_nodes, degree)
from dgmc_tpu_torch.ops.softmax import masked_softmax
from dgmc_tpu_torch.ops.segment import segment_sum, segment_mean
from dgmc_tpu_torch.ops.topk import chunked_topk, dense_topk
from dgmc_tpu_torch.ops.spline import open_spline_basis

__all__ = ['GraphBatch', 'gather_nodes', 'scatter_to_nodes', 'degree',
           'masked_softmax', 'segment_sum', 'segment_mean', 'chunked_topk',
           'dense_topk', 'open_spline_basis']
