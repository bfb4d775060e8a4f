"""Host-side graph container and padded collation (NumPy).

``pad_graphs`` produces the arrays of a padded ``[B, N, ...]`` /
``[B, E, ...]`` batch with boolean validity masks and graph-local edge
endpoints; :meth:`dgmc_tpu_torch.ops.graph.GraphBatch.from_numpy` moves
them onto a device. Padded edges point at node 0 under
``edge_mask=False``.
"""

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ['Graph', 'pad_graphs']


@dataclasses.dataclass
class Graph:
    """A single host-side graph (NumPy, ragged — the pre-padding form)."""
    edge_index: np.ndarray                 # [2, E] int
    x: Optional[np.ndarray] = None         # [N, C] float

    @property
    def num_nodes(self):
        if self.x is not None:
            return self.x.shape[0]
        return int(self.edge_index.max()) + 1 if self.edge_index.size else 0

    @property
    def num_edges(self):
        return self.edge_index.shape[1]


def pad_graphs(graphs: Sequence[Graph], num_nodes: int, num_edges: int,
               feat_dim: Optional[int] = None):
    """Collate host graphs into padded arrays.

    Returns a dict with ``x [B, N, C]`` float32, ``senders`` /
    ``receivers [B, E]`` int32, ``node_mask [B, N]`` and
    ``edge_mask [B, E]`` bool. A graph larger than the padding raises.
    """
    B = len(graphs)
    if feat_dim is None:
        feat_dim = next(g.x.shape[1] for g in graphs if g.x is not None)
    x = np.zeros((B, num_nodes, feat_dim), np.float32)
    senders = np.zeros((B, num_edges), np.int32)
    receivers = np.zeros((B, num_edges), np.int32)
    node_mask = np.zeros((B, num_nodes), bool)
    edge_mask = np.zeros((B, num_edges), bool)
    for b, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        if n > num_nodes or e > num_edges:
            raise ValueError(f'graph {b} ({n} nodes / {e} edges) exceeds '
                             f'padding ({num_nodes} / {num_edges})')
        if g.x is not None:
            x[b, :n] = g.x
        senders[b, :e] = g.edge_index[0]
        receivers[b, :e] = g.edge_index[1]
        node_mask[b, :n] = True
        edge_mask[b, :e] = True
    return {'x': x, 'senders': senders, 'receivers': receivers,
            'node_mask': node_mask, 'edge_mask': edge_mask}
