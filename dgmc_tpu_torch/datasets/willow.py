"""WILLOW-ObjectClass keypoint dataset.

Five categories (face, motorbike, car, duck, winebottle), each image
annotated with exactly 10 keypoints: node features are VGG16 features at
the keypoints (:class:`~dgmc_tpu_torch.datasets.features.VGG16Features`),
positions the keypoints centred on their centroid, ``y`` the identity
over the 10 keypoints (the ground truth between any two items of a
category). The parser is the JAX package's
(``dgmc_tpu/datasets/willow.py``).

Raw layout (the official release; nothing is downloaded)::

    <root>/WILLOW-ObjectClass/<Category>/*.mat   (pts_coord [2, 10])
    <root>/WILLOW-ObjectClass/<Category>/*.png   (optional: a missing
                                                  image is a zero image)

``<Category>`` is ``Face``, ``Motorbike``, ... (or the lower-case
category name). PIL is imported only where a ``.png`` exists.
"""

import glob
import os

import numpy as np

from dgmc_tpu_torch.datasets.pascal_voc import read_image
from dgmc_tpu_torch.utils.data import Graph

__all__ = ['CATEGORIES', 'NUM_KEYPOINTS', 'WILLOWObjectClass']

CATEGORIES = ('face', 'motorbike', 'car', 'duck', 'winebottle')
_DIRNAMES = {'face': 'Face', 'motorbike': 'Motorbike', 'car': 'Car',
             'duck': 'Duck', 'winebottle': 'Winebottle'}
NUM_KEYPOINTS = 10


class WILLOWObjectClass:
    """One category of WILLOW-ObjectClass as a list-like of
    :class:`~dgmc_tpu_torch.utils.data.Graph` s."""

    def __init__(self, root, category, transform=None, features=None,
                 device_features=None, download=False):
        if category not in CATEGORIES:
            raise ValueError(f'unknown category {category!r}')
        self.root = os.path.expanduser(root)
        self.category = category
        self.transform = transform
        if features is None:
            from dgmc_tpu_torch.datasets.features import VGG16Features
            features = VGG16Features(weights=device_features or 'random')
        self.features = features
        base = os.path.join(self.root, 'WILLOW-ObjectClass',
                            _DIRNAMES[category])
        if not os.path.isdir(base):
            alt = os.path.join(self.root, 'WILLOW-ObjectClass', category)
            if os.path.isdir(alt):
                base = alt
            elif download:
                raise NotImplementedError(
                    'downloads are not ported: place the WILLOW-ObjectClass '
                    f'release under {self.root}')
            else:
                raise FileNotFoundError(
                    f'WILLOW raw data not found at {base}; place the '
                    f'WILLOW-ObjectClass release under {self.root}.')
        self._graphs = self._load(base)

    def _load(self, base):
        from scipy.io import loadmat
        graphs = []
        for mat_path in sorted(glob.glob(os.path.join(base, '*.mat'))):
            pts = np.asarray(loadmat(mat_path)['pts_coord'],
                             np.float64)[:2].T          # [10, 2] xy
            name = os.path.splitext(os.path.basename(mat_path))[0]
            img_path = os.path.join(base, name + '.png')
            if os.path.exists(img_path):
                img = read_image(img_path)
            else:
                img = np.zeros((256, 256, 3), np.uint8)
            x = self.features(img, pts)
            pos = (pts - pts.mean(axis=0)).astype(np.float32)
            graphs.append(Graph(
                edge_index=np.zeros((2, 0), np.int64), x=x, pos=pos,
                y=np.arange(pts.shape[0], dtype=np.int64), name=name))
        if not graphs:
            raise FileNotFoundError(f'no .mat annotations under {base}')
        return graphs

    def __len__(self):
        return len(self._graphs)

    def __getitem__(self, idx):
        g = self._graphs[idx]
        return self.transform(g) if self.transform else g

    def shuffled_split(self, n_train, seed=0):
        """A random ``n_train`` / rest split (one permutation from
        ``RandomState(seed)``), as two list-likes."""
        order = np.random.RandomState(seed).permutation(len(self))
        return _Subset(self, order[:n_train]), _Subset(self, order[n_train:])

    @property
    def num_node_features(self):
        return self._graphs[0].x.shape[1]

    def __repr__(self):
        return f'WILLOWObjectClass({self.category}, {len(self)})'


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
