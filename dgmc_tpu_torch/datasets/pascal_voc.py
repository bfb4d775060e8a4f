"""PascalVOC with the Berkeley keypoint annotations.

Twenty VOC categories; each sample is one object instance with its
visible keypoints, its positions relative to the instance's bounding
box, and VGG16 features of the crop at the keypoints
(:class:`~dgmc_tpu_torch.datasets.features.VGG16Features`). ``y`` holds
each keypoint's class: its index in the category's sorted keypoint-name
vocabulary, which :class:`~dgmc_tpu_torch.utils.data.ValidPairDataset`
matches on. The parser is the JAX package's
(``dgmc_tpu/datasets/pascal_voc.py``): the same graphs, names, splits and
vocabularies from one tree.

Raw layout (nothing is downloaded)::

    <root>/annotations/<category>/*.xml   Berkeley keypoint annotations:
        <annotation><image>...</image>
          <visible_bounds xmin= ymin= width= height=/>  (or xmax= ymax=)
          <keypoints><keypoint name= x= y= visible=/>...</keypoints>
        </annotation>
    <root>/images/<image>.{jpg,png}       VOC images (optional: a missing
                                          one is a zero image, warned)
    <root>/ImageSets/Main/<category>_{train,val}.txt
                                          official split lists
                                          (``image_id [label]``, label -1
                                          excluded); else a plain id list
                                          in <root>/splits/; else a warned
                                          fraction split

Features are cached per category and weight source in
``<root>/processed/<category>_<tag>_torch.npz``, a name of its own: the
two packages' features agree within a tolerance, not bit for bit, so
neither reads the other's cache.
"""

import glob
import os
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from dgmc_tpu_torch.utils.data import Graph

__all__ = ['CATEGORIES', 'PascalVOCKeypoints', 'read_image']

CATEGORIES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
              'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
              'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
              'tvmonitor')


def read_image(path):
    """An image file as an ``[H, W, 3]`` uint8 array. PIL is imported
    only here, where a file exists; without it this raises and names the
    package (a zero image would silently change the features)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f'reading {path} needs Pillow (the PIL package), '
                          f'which is not installed') from e
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def _parse_annotation(path):
    """``(image, bounds, keypoints)`` of one Berkeley XML file: bounds
    ``(x0, y0, x1, y1)`` from ``width``/``height`` or ``xmax``/``ymax``
    (None without ``visible_bounds``), keypoints ``(name, x, y)`` with
    the invisible ones dropped."""
    root = ET.parse(path).getroot()
    image = root.findtext('image', default='').strip()
    vb = root.find('visible_bounds')
    bounds = None
    if vb is not None:
        x0 = float(vb.get('xmin', 0))
        y0 = float(vb.get('ymin', 0))
        if vb.get('width') is not None:
            x1 = x0 + float(vb.get('width'))
            y1 = y0 + float(vb.get('height', 0))
        else:
            x1 = float(vb.get('xmax', x0))
            y1 = float(vb.get('ymax', y0))
        bounds = (x0, y0, x1, y1)
    kps = []
    kp_root = root.find('keypoints')
    if kp_root is not None:
        for kp in kp_root.findall('keypoint'):
            if kp.get('visible', '1') in ('0', 'false', 'False'):
                continue
            kps.append((kp.get('name'), float(kp.get('x')),
                        float(kp.get('y'))))
    return image, bounds, kps


class PascalVOCKeypoints:
    """One category of PascalVOC keypoint instances, a list-like of
    :class:`~dgmc_tpu_torch.utils.data.Graph` s (``transform`` applied on
    every access, ``pre_filter`` once at load)."""

    def __init__(self, root, category, train=True, transform=None,
                 pre_filter=None, features=None, device_features=None,
                 train_fraction=0.8, download=False):
        if category not in CATEGORIES:
            raise ValueError(f'unknown category {category!r}')
        self.root = os.path.expanduser(root)
        self.category = category
        self.transform = transform
        if features is None:
            from dgmc_tpu_torch.datasets.features import VGG16Features
            features = VGG16Features(weights=device_features or 'random')
        self.features = features

        ann_dir = os.path.join(self.root, 'annotations', category)
        if not os.path.isdir(ann_dir):
            if download:
                raise NotImplementedError(
                    'downloads are not ported: place the Berkeley keypoint '
                    f'annotations at {ann_dir}')
            raise FileNotFoundError(
                f'Berkeley keypoint annotations not found at {ann_dir}; '
                f'place them there.')

        parsed, names = [], set()
        for p in sorted(glob.glob(os.path.join(ann_dir, '*.xml'))):
            image, bounds, kps = _parse_annotation(p)
            parsed.append((p, image, bounds, kps))
            names.update(n for n, _, _ in kps)
        self.keypoint_names = sorted(names)
        name_to_class = {n: i for i, n in enumerate(self.keypoint_names)}

        split_ids = self._load_split_ids(train)
        if split_ids is not None:
            kept = [rec for rec in parsed if rec[1] in split_ids]
            if parsed and split_ids and not kept:
                raise ValueError(
                    f'split list for {category!r} matched 0 of '
                    f'{len(parsed)} annotated instances — the list ids do '
                    f'not correspond to the annotations\' <image> fields '
                    f'(wrong VOC year, or ids carry file suffixes?)')
            parsed = kept
        else:
            warnings.warn(
                f'No official split list found for {category!r} under '
                f'{self.root}/ImageSets/Main; using a {train_fraction:.0%} '
                f'fraction split — results are not comparable to the '
                f'reference protocol.', stacklevel=2)
            n_train = int(len(parsed) * train_fraction)
            parsed = parsed[:n_train] if train else parsed[n_train:]

        cache = self._feature_cache(category)
        self._graphs = []
        dirty = False
        for p, image, bounds, kps in parsed:
            if not kps:
                continue
            pts = np.array([(x, y) for _, x, y in kps], np.float64)
            y = np.array([name_to_class[n] for n, _, _ in kps], np.int64)
            # A repeated keypoint class has no bijective ground truth.
            if len(np.unique(y)) != len(y):
                continue
            name = os.path.splitext(os.path.basename(p))[0]
            if bounds is not None:
                x0, y0, x1, y1 = bounds
            else:
                (x0, y0), (x1, y1) = pts.min(axis=0), pts.max(axis=0)
            local = pts - np.array([x0, y0])
            if name in cache:
                x = cache[name]
            else:
                x = self.features(*self._crop(image, pts, x0, y0, x1, y1))
                cache[name] = x
                dirty = True
            g = Graph(edge_index=np.zeros((2, 0), np.int64), x=x,
                      pos=local.astype(np.float32), y=y, name=name)
            if pre_filter is not None and not pre_filter(g):
                continue
            self._graphs.append(g)
        if dirty:
            self._save_feature_cache(cache)

    def _crop(self, image, pts, x0, y0, x1, y1):
        """``(crop, crop_pts)``: the instance's bounding box padded by 5%
        of its longer side, clipped to the image (the whole image where
        that leaves nothing), and the keypoints in the crop's pixels.
        With ``weights='none'`` features no image is read."""
        if getattr(self.features, 'tag', None) == 'none':
            return np.zeros((1, 1, 3), np.uint8), pts
        img = self._image(image)
        h, w = img.shape[:2]
        pad = 0.05 * max(x1 - x0, y1 - y0)
        cx0 = int(max(0, np.floor(x0 - pad)))
        cy0 = int(max(0, np.floor(y0 - pad)))
        cx1 = int(min(w, np.ceil(x1 + pad))) or w
        cy1 = int(min(h, np.ceil(y1 + pad))) or h
        if cx1 > cx0 and cy1 > cy0:
            return img[cy0:cy1, cx0:cx1], pts - np.array([cx0, cy0])
        return img, pts

    def _load_split_ids(self, train):
        """Image ids of the official VOC list
        (``ImageSets/Main/<category>_{train,val}.txt``) or of a plain list
        under ``splits/``; None when neither exists."""
        name = 'train' if train else 'val'
        for path in (os.path.join(self.root, 'ImageSets', 'Main',
                                  f'{self.category}_{name}.txt'),
                     os.path.join(self.root, 'splits',
                                  f'{self.category}_{name}.txt')):
            if not os.path.exists(path):
                continue
            ids = set()
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts or (len(parts) >= 2 and parts[1] == '-1'):
                        continue
                    ids.add(parts[0])
            return ids
        return None

    def _feature_cache(self, category):
        tag = getattr(self.features, 'tag', None)
        if not tag or tag == 'none':
            self._cache_path = None
            return {}
        self._cache_path = os.path.join(self.root, 'processed',
                                        f'{category}_{tag}_torch.npz')
        if os.path.exists(self._cache_path):
            with np.load(self._cache_path) as z:
                return {k: z[k] for k in z.files}
        return {}

    def _save_feature_cache(self, cache):
        if self._cache_path is None:
            return
        os.makedirs(os.path.dirname(self._cache_path), exist_ok=True)
        np.savez(self._cache_path, **cache)

    def _image(self, image_name):
        for ext in ('.jpg', '.png'):
            p = os.path.join(self.root, 'images', image_name + ext)
            if os.path.exists(p):
                return read_image(p)
        # Warned once, and only where features are extracted
        # (weights='none' is the deliberate structure-only mode).
        if (not getattr(self, '_warned_missing_images', False)
                and getattr(self.features, 'tag', None) != 'none'):
            self._warned_missing_images = True
            warnings.warn(
                f'no image found for {image_name!r} under '
                f'{os.path.join(self.root, "images")}; visual features '
                f'will be extracted from ZERO images (structure-only '
                f'training). Place the VOC JPEGImages there to fix.')
        return np.zeros((256, 256, 3), np.uint8)

    def __len__(self):
        return len(self._graphs)

    def __getitem__(self, idx):
        g = self._graphs[idx]
        return self.transform(g) if self.transform else g

    @property
    def num_node_features(self):
        return self._graphs[0].x.shape[1]

    def __repr__(self):
        return (f'PascalVOCKeypoints({self.category}, {len(self)}, '
                f'kps={len(self.keypoint_names)})')
