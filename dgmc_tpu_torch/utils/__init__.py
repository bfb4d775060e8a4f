"""Host-side utilities: graph containers, collation, atomic I/O, match
plots (the JAX package's ``dgmc_tpu.utils`` names)."""

from dgmc_tpu_torch.utils.data import (Graph, GraphPair, PairDataset,
                                       ValidPairDataset, ConcatDataset,
                                       pad_graphs, pad_pair_batch,
                                       PairLoader, PrefetchLoader,
                                       graph_limits)

__all__ = ['Graph', 'GraphPair', 'PairDataset', 'ValidPairDataset',
           'ConcatDataset', 'pad_graphs', 'pad_pair_batch', 'PairLoader',
           'PrefetchLoader', 'graph_limits']
