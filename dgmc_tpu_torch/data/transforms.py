"""Host-side keypoint-graph transforms (NumPy).

The transforms the PascalPF training pipeline applies to every point
cloud: a constant node feature, a k-nearest-neighbour graph and
Cartesian edge pseudo-coordinates. Copies of the JAX package's, with the
same ``argpartition`` neighbour order, so one graph gives the same edge
list in both.
"""

import dataclasses

import numpy as np

__all__ = ['Compose', 'Constant', 'KNNGraph', 'Cartesian']


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, g):
        # A shallow copy: transforms rebind fields and never mutate
        # arrays, so a cached graph is left as it was.
        g = dataclasses.replace(g)
        for t in self.transforms:
            g = t(g)
        return g


class Constant:
    """Set (or append to) node features a constant value column."""

    def __init__(self, value=1.0, cat=True):
        self.value = value
        self.cat = cat

    def __call__(self, g):
        col = np.full((g.num_nodes, 1), self.value, np.float32)
        if g.x is not None and self.cat:
            g.x = np.concatenate([g.x, col], axis=1)
        else:
            g.x = col
        return g


class KNNGraph:
    """Connect every node to its ``k`` nearest neighbours (edges j -> i)."""

    def __init__(self, k=6, loop=False):
        self.k = k
        self.loop = loop

    def __call__(self, g):
        pos = g.pos
        n = pos.shape[0]
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        if not self.loop:
            np.fill_diagonal(d2, np.inf)
        k = min(self.k, n - (0 if self.loop else 1))
        if k <= 0:
            g.edge_index = np.zeros((2, 0), np.int64)
            return g
        nbrs = np.argpartition(d2, k - 1, axis=1)[:, :k]   # [n, k] sources
        targets = np.repeat(np.arange(n), k)
        g.edge_index = np.stack([nbrs.reshape(-1), targets]).astype(np.int64)
        return g


class Cartesian:
    """Edge pseudo-coordinates: relative node positions, normalized to
    ``[0, 1]``."""

    def __init__(self, norm=True, max_value=None):
        self.norm = norm
        self.max_value = max_value

    def __call__(self, g):
        src, dst = g.edge_index
        cart = g.pos[src] - g.pos[dst]
        if self.norm and cart.size:
            scale = self.max_value or np.abs(cart).max()
            cart = cart / (2 * max(scale, 1e-12)) + 0.5
        attr = cart.astype(np.float32)
        if g.edge_attr is not None:
            g.edge_attr = np.concatenate([g.edge_attr, attr], axis=1)
        else:
            g.edge_attr = attr
        return g
