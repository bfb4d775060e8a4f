"""PascalPF (Proposal Flow) keypoint pairs: the zero-shot evaluation of
the PascalPF experiment.

Per category, keypoint sets from the ``PF-dataset-PASCAL`` annotation
``.mat`` files (rows with a NaN dropped), normalized into ``[-1, 1]``
preserving aspect, and the official evaluation pairs from
``parsePascalVOC.mat``. The parser is the JAX package's
(``dgmc_tpu/datasets/pascal_pf.py``).

Raw layout (nothing is downloaded)::

    <root>/PF-dataset-PASCAL/Annotations/<category>/*.mat   (kps [M, 2|3])
    <root>/PF-dataset-PASCAL/parsePascalVOC.mat             (pair list)
"""

import glob
import os

import numpy as np

from dgmc_tpu_torch.utils.data import Graph

__all__ = ['CATEGORIES', 'PascalPF']

CATEGORIES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
              'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
              'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
              'tvmonitor')


class PascalPF:
    """One category of PascalPF: ``items`` maps an image name to its
    :class:`~dgmc_tpu_torch.utils.data.Graph` (``pos`` and ``y = arange``
    only: a transform builds the graph), ``pairs`` lists the evaluation
    pairs ``(name_s, name_t)``: the official list where
    ``parsePascalVOC.mat`` resolves some, else consecutive names."""

    def __init__(self, root, category, transform=None, download=False):
        if category not in CATEGORIES:
            raise ValueError(f'unknown category {category!r}')
        self.root = os.path.expanduser(root)
        self.category = category
        self.transform = transform
        base = os.path.join(self.root, 'PF-dataset-PASCAL')
        if not os.path.isdir(base):
            if download:
                raise NotImplementedError(
                    'downloads are not ported: place the PF-dataset-PASCAL '
                    f'release at {base}')
            raise FileNotFoundError(
                f'PascalPF raw data not found at {base}; place the '
                f'PF-dataset-PASCAL release there.')
        self._load(base)

    def _load(self, base):
        from scipy.io import loadmat
        ann = os.path.join(base, 'Annotations', self.category)
        self.items = {}
        for path in sorted(glob.glob(os.path.join(ann, '*.mat'))):
            kps = np.asarray(loadmat(path)['kps'], np.float32)[:, :2]
            kps = kps[~np.isnan(kps).any(axis=1)]
            if kps.shape[0] == 0:
                continue
            center = (kps.max(0) + kps.min(0)) / 2
            scale = (kps.max(0) - kps.min(0)).max() / 2
            pos = (kps - center) / max(scale, 1e-6)
            name = os.path.splitext(os.path.basename(path))[0]
            # Row i of every item of a category is the same keypoint.
            self.items[name] = Graph(edge_index=np.zeros((2, 0), np.int64),
                                     pos=pos, y=np.arange(len(pos)),
                                     name=name)

        pairs_file = os.path.join(base, 'parsePascalVOC.mat')
        self.pairs = []
        if os.path.exists(pairs_file):
            entry = loadmat(pairs_file, simplify_cells=True)['PascalVOC']
            cat_idx = list(entry['class']).index(self.category)
            pair_arr = np.asarray(entry['pair'][cat_idx], dtype=object)
            # simplify_cells squeezes a single pair into a flat [2] array
            # of names: back to one row of two.
            if (pair_arr.ndim == 1 and pair_arr.size == 2
                    and all(isinstance(v, str) for v in pair_arr)):
                pair_arr = pair_arr[None, :]
            for row in np.atleast_1d(pair_arr):
                row = np.atleast_1d(np.asarray(row, dtype=object))
                if row.size < 2:
                    continue
                a, b = str(row[0]), str(row[1])
                if a in self.items and b in self.items:
                    self.pairs.append((a, b))
        if not self.pairs:
            names = sorted(self.items)
            self.pairs = [(names[i], names[i + 1])
                          for i in range(len(names) - 1)]

    def get(self, name):
        g = self.items[name]
        return self.transform(g) if self.transform else g

    def pair_graphs(self):
        """``(graph_s, graph_t, y_col)`` for every evaluation pair, the
        ground truth keypoint i → keypoint i over the shorter set."""
        for a, b in self.pairs:
            g_s, g_t = self.get(a), self.get(b)
            n = min(g_s.pos.shape[0], g_t.pos.shape[0])
            yield g_s, g_t, np.arange(n, dtype=np.int64)

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return (f'PascalPF({self.category}, items={len(self.items)}, '
                f'pairs={len(self.pairs)})')
