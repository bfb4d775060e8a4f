"""Host-side pair-data layer (NumPy): graph containers, pair datasets,
padded collation, the pair loader and its background prefetch — the port
of the JAX package's ``dgmc_tpu/utils/data.py``.

- :class:`Graph`, :class:`GraphPair`: ragged host graphs and pairs.
- :class:`PairDataset` (the product or a sampled pairing of two graph
  datasets), :class:`ValidPairDataset` (the pairs whose source classes
  all occur in the target, with the induced ground truth),
  :class:`ConcatDataset` and :func:`graph_limits` (the padding a loader
  needs).
- :func:`pad_graphs` produces the arrays of a padded ``[B, N, ...]`` /
  ``[B, E, ...]`` batch with boolean validity masks and graph-local edge
  endpoints, through the port's C++ collation (``dgmc_tpu_torch/native``,
  built with ``g++`` at first use) or its NumPy loop (``native=``; each
  call records the path in the dispatch ledger under ``collate``).
  Padded edges point at node 0 under ``edge_mask=False``.
  :meth:`dgmc_tpu_torch.ops.graph.GraphBatch.from_numpy` moves them onto
  a device. :func:`pad_pair_batch` collates (source, target) pairs with
  padded ground-truth columns ``y``/``y_mask``.
- :class:`PairLoader` emits fixed-shape batches from a pair dataset;
  :class:`PrefetchLoader` runs any batch iterable in a background thread,
  so batch b+1 is collated while batch b trains.
"""

import dataclasses
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

__all__ = ['Graph', 'GraphPair', 'PairDataset', 'ValidPairDataset',
           'ConcatDataset', 'graph_limits', 'PairBatch', 'PairLoader',
           'PrefetchLoader', 'pad_graphs', 'pad_pair_batch']


@dataclasses.dataclass
class Graph:
    """A single host-side graph (NumPy, ragged — the pre-padding form)."""
    edge_index: np.ndarray                  # [2, E] int
    x: Optional[np.ndarray] = None          # [N, C] float
    edge_attr: Optional[np.ndarray] = None  # [E, D] float
    pos: Optional[np.ndarray] = None        # [N, d] float
    y: Optional[np.ndarray] = None          # [N] int (keypoint classes etc.)
    face: Optional[np.ndarray] = None       # [3, F] int (Delaunay triangles)
    name: Optional[str] = None

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


class PairDataset:
    """All (or sampled) source x target combinations of two graph
    datasets: ``sample=False`` holds the full product; ``sample=True``
    pairs each source with one uniformly random target per access."""

    def __init__(self, dataset_s, dataset_t, sample=False, seed=0):
        self.dataset_s = dataset_s
        self.dataset_t = dataset_t
        self.sample = sample
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        if self.sample:
            return len(self.dataset_s)
        return len(self.dataset_s) * len(self.dataset_t)

    def __getitem__(self, idx):
        if self.sample:
            g_s = self.dataset_s[idx]
            g_t = self.dataset_t[self._rng.randint(len(self.dataset_t))]
        else:
            g_s = self.dataset_s[idx // len(self.dataset_t)]
            g_t = self.dataset_t[idx % len(self.dataset_t)]
        return GraphPair(s=g_s, t=g_t)

    def __repr__(self):
        return (f'{type(self).__name__}({self.dataset_s}, {self.dataset_t}, '
                f'sample={self.sample})')


class ValidPairDataset:
    """Pairs in which every source node class (``Graph.y``) also occurs in
    the target, with the induced ground truth: each source node maps to
    the target node holding its class. Validity is precomputed from
    per-graph class-membership masks."""

    def __init__(self, dataset_s, dataset_t, sample=False, seed=0):
        self.dataset_s = dataset_s
        self.dataset_t = dataset_t
        self.sample = sample
        self._rng = np.random.RandomState(seed)
        self.pairs, self.cumdeg = self._compute_pairs()

    def _compute_pairs(self):
        num_classes = 0
        for g in list(self.dataset_s) + list(self.dataset_t):
            if g.y is not None and g.y.size:
                num_classes = max(num_classes, int(g.y.max()) + 1)
        mask_s = np.zeros((len(self.dataset_s), num_classes), bool)
        mask_t = np.zeros((len(self.dataset_t), num_classes), bool)
        for i, g in enumerate(self.dataset_s):
            mask_s[i, g.y] = True
        for i, g in enumerate(self.dataset_t):
            mask_t[i, g.y] = True
        # (i, j) is valid iff classes(i) ⊆ classes(j).
        subset = (mask_s[:, None, :] & ~mask_t[None, :, :]).sum(-1) == 0
        pairs = np.argwhere(subset)
        counts = np.bincount(pairs[:, 0], minlength=len(self.dataset_s))
        cumdeg = np.concatenate([[0], np.cumsum(counts)])
        return pairs, cumdeg

    def __len__(self):
        return len(self.dataset_s) if self.sample else len(self.pairs)

    def __getitem__(self, idx):
        if self.sample:
            lo, hi = self.cumdeg[idx], self.cumdeg[idx + 1]
            if hi <= lo:
                raise IndexError(f'source graph {idx} has no valid partner')
            g_s = self.dataset_s[idx]
            g_t = self.dataset_t[self.pairs[self._rng.randint(lo, hi)][1]]
        else:
            i, j = self.pairs[idx]
            g_s = self.dataset_s[int(i)]
            g_t = self.dataset_t[int(j)]
        # Target position of each class, then look up the source classes.
        class_to_pos = np.full(int(g_t.y.max()) + 1, -1, np.int64)
        class_to_pos[g_t.y] = np.arange(g_t.num_nodes)
        return GraphPair(s=g_s, t=g_t, y_col=class_to_pos[g_s.y])

    def __repr__(self):
        return (f'{type(self).__name__}({self.dataset_s}, {self.dataset_t}, '
                f'sample={self.sample})')


def graph_limits(datasets):
    """Max node / edge counts across graph datasets: the static padding a
    :class:`PairLoader` needs so one shape serves every batch."""
    n = e = 1
    for ds in datasets:
        for i in range(len(ds)):
            g = ds[i]
            n = max(n, g.num_nodes)
            e = max(e, g.num_edges)
    return n, e


class ConcatDataset:
    """Concatenation of several pair datasets (the reference concatenates
    the PascalVOC categories this way)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d = int(np.searchsorted(self._cum, idx, side='right')) - 1
        return self.datasets[d][idx - int(self._cum[d])]


@dataclasses.dataclass
class PairBatch:
    """A padded batch of graph pairs: ``s`` / ``t`` are
    :func:`pad_graphs` dicts, ``y [B, N_s]`` int32 (-1 where invalid) and
    ``y_mask [B, N_s]`` bool."""
    s: dict
    t: dict
    y: np.ndarray
    y_mask: np.ndarray


def _check_native(native):
    if native not in ('auto', 'never', 'require'):
        raise ValueError(f"native must be 'auto', 'never' or 'require'; got "
                         f'{native!r}')


def _native_module(native, what):
    """The native collation module, or None for the NumPy path (recorded
    in the dispatch ledger with the reason); ``'require'`` without the
    library raises."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    _check_native(native)
    if native == 'never':
        dispatch.record('collate', 'numpy', f'{what}:native=never')
        return None
    from dgmc_tpu_torch import native as native_mod
    if native_mod.available():
        dispatch.record('collate', 'native', f'{what}:native={native}')
        return native_mod
    if native == 'require':
        raise RuntimeError('native collation library unavailable (no g++, '
                           'or its build failed)')
    dispatch.record('collate', 'numpy', f'{what}:library unavailable')
    return None


def pad_graphs(graphs: Sequence[Graph], num_nodes: int, num_edges: int,
               feat_dim: Optional[int] = None, native: str = 'auto'):
    """Collate host graphs into padded arrays.

    Returns a dict with ``x [B, N, C]`` float32, ``senders`` /
    ``receivers [B, E]`` int32, ``node_mask [B, N]`` and
    ``edge_mask [B, E]`` bool, and ``edge_attr [B, E, D]`` float32 when
    any graph carries edge attributes. A graph larger than the padding
    raises, and so does a feature or edge-attribute width that differs
    from the first graph's.

    ``native='auto'`` collates through the C++ library
    (:mod:`dgmc_tpu_torch.native`) when it is available and the NumPy loop
    below otherwise; ``'never'`` forces NumPy, ``'require'`` raises
    without the library. Both paths give the same arrays.
    """
    B = len(graphs)
    if feat_dim is None:
        feat_dim = next(g.x.shape[1] for g in graphs if g.x is not None)
    edge_dim = next((g.edge_attr.shape[1] for g in graphs
                     if g.edge_attr is not None), None)
    lib = _native_module(native, 'graphs')
    if lib is not None:
        out = lib.pad_graphs_native(graphs, num_nodes, num_edges, feat_dim,
                                    edge_dim)
        if out['edge_attr'] is None:
            del out['edge_attr']
        return out
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
        # NumPy would broadcast a one-wide edge_attr into the batch's.
        for key, width in (('x', feat_dim), ('edge_attr', edge_dim)):
            a = getattr(g, key)
            if a is not None and (a.ndim != 2 or a.shape[1] != width):
                raise ValueError(f'graph {b}: {key} has shape {a.shape}, '
                                 f'expected [*, {width}]')
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
                   num_nodes_t=None, num_edges_t=None, native='auto',
                   pairs_per_step=1):
    """Collate :class:`GraphPair` lists into a :class:`PairBatch`; the
    target side pads to the source's sizes unless given its own.
    ``native`` as in :func:`pad_graphs` (the ground truth too).
    ``pairs_per_step > 1`` tiles the pair list that many times along the
    batch axis (``--pairs-per-step``: the replicas draw their own noise
    and negatives, see :func:`~dgmc_tpu_torch.models.dgmc.draw_noise`)."""
    if pairs_per_step > 1:
        pairs = list(pairs) * pairs_per_step
    num_nodes_t = num_nodes_t or num_nodes_s
    num_edges_t = num_edges_t or num_edges_s
    # The run plane's padding account (``timings.json``'s
    # ``padding_buckets``): one count per collation into its bucket, with
    # the real sizes beside it.
    from dgmc_tpu_torch.obs.registry import record_padding
    record_padding(batch=len(pairs),
                   nodes=f'{num_nodes_s}x{num_nodes_t}',
                   edges=f'{num_edges_s}x{num_edges_t}',
                   real={'nodes_s': sum(p.s.num_nodes for p in pairs),
                         'nodes_t': sum(p.t.num_nodes for p in pairs),
                         'edges_s': sum(p.s.num_edges for p in pairs),
                         'edges_t': sum(p.t.num_edges for p in pairs)})
    g_s = pad_graphs([p.s for p in pairs], num_nodes_s, num_edges_s,
                     native=native)
    g_t = pad_graphs([p.t for p in pairs], num_nodes_t, num_edges_t,
                     native=native)
    lib = _native_module(native, 'ground_truth')
    if lib is not None:
        y, y_mask = lib.pad_ground_truth_native([p.y_col for p in pairs],
                                                num_nodes_s)
        return PairBatch(s=g_s, t=g_t, y=y, y_mask=y_mask)
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

    def first_batch(self):
        """The first batch an iteration would give now, with the
        shuffle's and the datasets' random states set back after it, so
        the run's batches are the ones it gives without this call (the
        example input of a cost count)."""
        owners = [self, self.dataset,
                  *getattr(self.dataset, 'datasets', ())]
        saved = [(o, o._rng.get_state()) for o in owners
                 if isinstance(getattr(o, '_rng', None),
                               np.random.RandomState)]
        try:
            return next(iter(self))
        finally:
            for o, state in saved:
                o._rng.set_state(state)

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


class PrefetchLoader:
    """Background-thread prefetch around any batch iterable: batch b+1 is
    produced (collated, and whatever else the iterable does) while batch b
    trains — the role the reference gives torch DataLoader workers.

    At most ``depth`` batches wait in a bounded queue. An iteration the
    consumer abandons (``break``, an exception) sets a stop event that
    frees the worker thread; an exception in the worker is raised on the
    consumer's side. ``len`` is the wrapped loader's.
    """

    def __init__(self, loader, depth=2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()

        def put(item):
            # A bounded put that gives up once the consumer is gone, so an
            # abandoned iteration cannot pin the worker and its batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
                put(done)
            except BaseException as e:  # surfaced on the consumer's side
                put(e)

        thread = threading.Thread(target=worker, daemon=True,
                                  name='PrefetchLoader')
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
