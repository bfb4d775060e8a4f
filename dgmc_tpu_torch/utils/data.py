"""Host-side graph containers, padded collation and the pair loader
(NumPy).

``pad_graphs`` produces the arrays of a padded ``[B, N, ...]`` /
``[B, E, ...]`` batch with boolean validity masks and graph-local edge
endpoints; :meth:`dgmc_tpu_torch.ops.graph.GraphBatch.from_numpy` moves
them onto a device. Padded edges point at node 0 under
``edge_mask=False``. ``pad_pair_batch`` collates (source, target) pairs
with padded ground-truth columns ``y``/``y_mask``; ``PairLoader`` emits
fixed-shape batches from a pair dataset, as the JAX package's does.
"""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ['Graph', 'GraphPair', 'PairBatch', 'PairLoader', 'pad_graphs',
           'pad_pair_batch']


@dataclasses.dataclass
class Graph:
    """A single host-side graph (NumPy, ragged — the pre-padding form)."""
    edge_index: np.ndarray                  # [2, E] int
    x: Optional[np.ndarray] = None          # [N, C] float
    edge_attr: Optional[np.ndarray] = None  # [E, D] float
    pos: Optional[np.ndarray] = None        # [N, d] float

    @property
    def num_nodes(self):
        if self.x is not None:
            return self.x.shape[0]
        if self.pos is not None:
            return self.pos.shape[0]
        return int(self.edge_index.max()) + 1 if self.edge_index.size else 0

    @property
    def num_edges(self):
        return self.edge_index.shape[1]


@dataclasses.dataclass
class GraphPair:
    """A (source, target) pair with an optional ground-truth column map:
    ``y_col[i]`` is the target node matched to source node ``i`` (or -1)."""
    s: Graph
    t: Graph
    y_col: Optional[np.ndarray] = None


@dataclasses.dataclass
class PairBatch:
    """A padded batch of graph pairs: ``s`` / ``t`` are
    :func:`pad_graphs` dicts, ``y [B, N_s]`` int32 (-1 where invalid) and
    ``y_mask [B, N_s]`` bool."""
    s: dict
    t: dict
    y: np.ndarray
    y_mask: np.ndarray


def pad_graphs(graphs: Sequence[Graph], num_nodes: int, num_edges: int,
               feat_dim: Optional[int] = None):
    """Collate host graphs into padded arrays.

    Returns a dict with ``x [B, N, C]`` float32, ``senders`` /
    ``receivers [B, E]`` int32, ``node_mask [B, N]`` and
    ``edge_mask [B, E]`` bool, and ``edge_attr [B, E, D]`` float32 when
    any graph carries edge attributes. A graph larger than the padding
    raises.
    """
    B = len(graphs)
    if feat_dim is None:
        feat_dim = next(g.x.shape[1] for g in graphs if g.x is not None)
    edge_dim = next((g.edge_attr.shape[1] for g in graphs
                     if g.edge_attr is not None), None)
    x = np.zeros((B, num_nodes, feat_dim), np.float32)
    senders = np.zeros((B, num_edges), np.int32)
    receivers = np.zeros((B, num_edges), np.int32)
    node_mask = np.zeros((B, num_nodes), bool)
    edge_mask = np.zeros((B, num_edges), bool)
    edge_attr = (np.zeros((B, num_edges, edge_dim), np.float32)
                 if edge_dim is not None else None)
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
        if edge_attr is not None and g.edge_attr is not None:
            edge_attr[b, :e] = g.edge_attr
    out = {'x': x, 'senders': senders, 'receivers': receivers,
           'node_mask': node_mask, 'edge_mask': edge_mask}
    if edge_attr is not None:
        out['edge_attr'] = edge_attr
    return out


def pad_pair_batch(pairs: List[GraphPair], num_nodes_s, num_edges_s,
                   num_nodes_t=None, num_edges_t=None, pairs_per_step=1):
    """Collate :class:`GraphPair` lists into a :class:`PairBatch`; the
    target side pads to the source's sizes unless given its own.
    ``pairs_per_step > 1`` tiles the pair list that many times along the
    batch axis (``--pairs-per-step``: the replicas draw their own noise
    and negatives, see :func:`~dgmc_tpu_torch.models.dgmc.draw_noise`)."""
    if pairs_per_step > 1:
        pairs = list(pairs) * pairs_per_step
    num_nodes_t = num_nodes_t or num_nodes_s
    num_edges_t = num_edges_t or num_edges_s
    g_s = pad_graphs([p.s for p in pairs], num_nodes_s, num_edges_s)
    g_t = pad_graphs([p.t for p in pairs], num_nodes_t, num_edges_t)
    B = len(pairs)
    y = np.full((B, num_nodes_s), -1, np.int32)
    y_mask = np.zeros((B, num_nodes_s), bool)
    for b, p in enumerate(pairs):
        if p.y_col is not None:
            n = len(p.y_col)
            y[b, :n] = p.y_col
            y_mask[b, :n] = p.y_col >= 0
    return PairBatch(s=g_s, t=g_t, y=y, y_mask=y_mask)


class PairLoader:
    """Shuffling batch iterator over a pair dataset, emitting fixed-shape
    :class:`PairBatch` es.

    The padding is given or computed once from the dataset; the final
    short batch is dropped when ``drop_last``, else padded with repeated
    pairs under a zeroed ``y_mask``.
    """

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 num_nodes=None, num_edges=None, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        if num_nodes is None or num_edges is None:
            n_max = e_max = 1
            for i in range(len(dataset)):
                p = dataset[i]
                n_max = max(n_max, p.s.num_nodes, p.t.num_nodes)
                e_max = max(e_max, p.s.num_edges, p.t.num_edges)
            num_nodes = num_nodes or n_max
            num_edges = num_edges or e_max
        self.num_nodes = num_nodes
        self.num_edges = num_edges

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                fill = np.resize(chunk, self.batch_size - len(chunk))
                batch = pad_pair_batch(
                    [self.dataset[int(i)] for i in (*chunk, *fill)],
                    self.num_nodes, self.num_edges)
                batch.y_mask[len(chunk):] = False
                yield batch
                return
            yield pad_pair_batch([self.dataset[int(i)] for i in chunk],
                                 self.num_nodes, self.num_edges)
