"""Host-side keypoint-graph transforms (NumPy / SciPy).

The transforms the keypoint experiments apply to every point cloud:
PascalPF's constant node feature, k-nearest-neighbour graph and
Cartesian edge pseudo-coordinates; PascalVOC's and WILLOW's Delaunay
triangulation (SciPy's Qhull), its faces turned into undirected edges,
and Cartesian or (``--isotropic``) Distance pseudo-coordinates. Copies of
the JAX package's, with the same ``argpartition`` neighbour order, the
same Qhull options and the same degenerate cases, so one graph gives the
same faces, edges and attributes in both.
"""

import dataclasses

import numpy as np

__all__ = ['Compose', 'Constant', 'KNNGraph', 'Delaunay', 'FaceToEdge',
           'Cartesian', 'Distance']


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


class Delaunay:
    """Delaunay triangulation of ``pos`` into faces (SciPy's Qhull with
    ``QJ``, joggled input, so that every point lands in a triangle).

    Degenerate sizes: fewer than 2 nodes give no face and no edge, exactly
    2 one edge each way, exactly 3 one triangle. A layout Qhull rejects
    (collinear points) becomes a chain through the points in x order,
    both directions, and no face.
    """

    def __call__(self, g):
        n = g.pos.shape[0]
        if n < 2:
            g.face = np.zeros((3, 0), np.int64)
            g.edge_index = np.zeros((2, 0), np.int64)
            return g
        if n == 2:
            g.face = None
            g.edge_index = np.array([[0, 1], [1, 0]], np.int64)
            return g
        if n == 3:
            g.face = np.array([[0], [1], [2]], np.int64)
            return g
        from scipy.spatial import Delaunay as SciPyDelaunay
        from scipy.spatial import QhullError
        try:
            tri = SciPyDelaunay(g.pos, qhull_options='QJ')
            g.face = tri.simplices.T.astype(np.int64)
        except QhullError:
            order = np.argsort(g.pos[:, 0] + 1e-9 * g.pos[:, 1])
            src, dst = order[:-1], order[1:]
            g.edge_index = np.stack([
                np.concatenate([src, dst]),
                np.concatenate([dst, src])]).astype(np.int64)
            g.face = None
        return g


class FaceToEdge:
    """Triangle faces → undirected edges: both directions of each side,
    deduplicated and sorted (``np.unique`` over columns)."""

    def __init__(self, remove_faces=True):
        self.remove_faces = remove_faces

    def __call__(self, g):
        face = g.face
        if face is not None and face.size:
            pairs = np.concatenate(
                [face[[0, 1]], face[[1, 2]], face[[2, 0]]], axis=1)
            und = np.unique(np.concatenate([pairs, pairs[::-1]], axis=1),
                            axis=1)
            g.edge_index = und.astype(np.int64)
        if self.remove_faces:
            g.face = None
        return g


def _append_attr(g, attr):
    if g.edge_attr is not None:
        g.edge_attr = np.concatenate([g.edge_attr, attr], axis=1)
    else:
        g.edge_attr = attr
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
        return _append_attr(g, cart.astype(np.float32))


class Distance:
    """Edge pseudo-coordinates: the Euclidean length of each edge,
    divided by the longest (``--isotropic``: one coordinate)."""

    def __init__(self, norm=True, max_value=None):
        self.norm = norm
        self.max_value = max_value

    def __call__(self, g):
        src, dst = g.edge_index
        d = np.linalg.norm(g.pos[src] - g.pos[dst], axis=1, keepdims=True)
        if self.norm and d.size:
            scale = self.max_value or d.max()
            d = d / max(scale, 1e-12)
        return _append_attr(g, d.astype(np.float32))
