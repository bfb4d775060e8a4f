"""Small dataset trees in the published raw layouts, made from a seed.

The keypoint and KG experiments read their datasets from raw files
(:mod:`dgmc_tpu_torch.datasets`). These writers make trees of the same
layouts with random content, so that the parsers and the CLIs run end
to end without the datasets: in the tests on the CPU and in
``chip_smoke.py``'s ``keypoints`` phase on the card.

- :func:`write_voc`: the Berkeley keypoint XML files of PascalVOC
  (``visible_bounds`` with ``width`` / ``height``, ``visible="0"``
  keypoints, ``z`` and ``round`` attributes) and the official VOC split
  lists (``image_id label``), per category a vocabulary of keypoint names
  and per instance a visible subset of it;
- :func:`write_willow`: WILLOW-ObjectClass ``.mat`` files
  (``pts_coord [2, 10]``);
- :func:`write_pascal_pf`: PF-PASCAL ``.mat`` files (``kps [M, 3]`` with
  NaN rows) and ``parsePascalVOC.mat``;
- :func:`write_dbp15k`: one DBP15K language pair in the JAPE layout.

Keypoints follow a template per category plus a little noise, so that a
model can learn to match them. Given an ``image_size`` the image-bearing
layouts also get images in their release's format (random pixels, JPEG
for PascalVOC and PNG for WILLOW, written with PIL, which must then be
installed); without them the parsers extract features from zero
images.
"""

import json
import os

import numpy as np

__all__ = ['VOC_CATEGORIES', 'WILLOW_DIRS', 'JITTER', 'write_voc',
           'write_willow', 'write_pascal_pf', 'write_dbp15k']

VOC_CATEGORIES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
                  'car', 'cat', 'chair', 'cow', 'diningtable', 'dog',
                  'horse', 'motorbike', 'person', 'pottedplant', 'sheep',
                  'sofa', 'train', 'tvmonitor')
WILLOW_DIRS = ('Face', 'Motorbike', 'Car', 'Duck', 'Winebottle')
#: Keypoint noise around a category's template, as a share of the box.
JITTER = 0.03


def _write_text(path, text):
    """Write ``text`` to ``path`` whole: a temporary file beside it,
    then ``os.replace``, so no reader sees a part of it."""
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w') as f:
        f.write(text)
    os.replace(tmp, path)


def _image(path, rng, h, w):
    """A random RGB image, in the format the path's suffix names."""
    from PIL import Image
    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
        path)


def write_voc(root, seed=0, train=4, val=2, image_size=None):
    """A PascalVOC keypoint tree under ``root``: per category ``train`` +
    ``val`` instances, a vocabulary of 6-20 keypoint names placed by a
    template of the category (each instance its bounding box times the
    template, plus :data:`JITTER` times the box of normal noise), each
    instance showing a random subset of at least 3 of them (the others
    ``visible="0"``), one instance per image (ids ``2008_<category
    index><i>``), the split lists in ``ImageSets/Main`` (one absent id,
    label -1, each). ``image_size`` ``(h, w)`` writes a JPEG per image, as
    VOC has. Returns ``root``."""
    rng = np.random.RandomState(seed)
    images = os.path.join(root, 'images')
    sets = os.path.join(root, 'ImageSets', 'Main')
    os.makedirs(sets, exist_ok=True)
    if image_size is not None:
        os.makedirs(images, exist_ok=True)
    h, w = image_size or (300, 400)
    for c, cat in enumerate(VOC_CATEGORIES):
        ann = os.path.join(root, 'annotations', cat)
        os.makedirs(ann, exist_ok=True)
        names = [f'{cat[:3]}_kp{j:02d}' for j in
                 range(rng.randint(6, 21))]
        template = rng.rand(len(names), 2)
        ids = []
        for i in range(train + val):
            image_id = f'2008_{c:02d}{i:04d}'
            ids.append(image_id)
            x0, y0 = rng.uniform(0, 0.3 * w), rng.uniform(0, 0.3 * h)
            bw, bh = rng.uniform(0.3 * w, 0.65 * w), rng.uniform(
                0.3 * h, 0.65 * h)
            visible = np.zeros(len(names), bool)
            visible[rng.permutation(len(names))[:rng.randint(
                3, len(names) + 1)]] = True
            pts = np.clip(template + JITTER * rng.randn(len(names), 2), 0, 1)
            kps = [f'<keypoint name="{n}" round="0" '
                   f'visible="{int(visible[j])}" '
                   f'x="{x0 + pts[j, 0] * bw:.2f}" '
                   f'y="{y0 + pts[j, 1] * bh:.2f}" z="0.0"/>'
                   for j, n in enumerate(names)]
            _write_text(os.path.join(ann, f'{image_id}_1.xml'),
                        f'<?xml version="1.0" encoding="utf-8"?>\n'
                        f'<annotation>\n\t<image>{image_id}</image>\n'
                        f'\t<category>{cat}</category>\n'
                        f'\t<visible_bounds height="{bh:.2f}" '
                        f'width="{bw:.2f}" xmin="{x0:.2f}" '
                        f'ymin="{y0:.2f}"/>\n\t<keypoints>\n\t\t'
                        + '\n\t\t'.join(kps) + '\n\t</keypoints>\n'
                        '\t<segmented>0</segmented>\n</annotation>\n')
            if image_size is not None:
                _image(os.path.join(images, f'{image_id}.jpg'), rng, h, w)
        for split, part in (('train', ids[:train]), ('val', ids[train:])):
            _write_text(os.path.join(sets, f'{cat}_{split}.txt'),
                        ''.join(f'{i} {rng.choice([0, 1]):2d}\n'
                                for i in part)
                        + f'2008_99{c:04d} -1\n')
    return root


def write_willow(root, seed=0, items=21, image_size=None):
    """A WILLOW-ObjectClass tree under ``root``: ``items`` ``.mat`` files
    of 10 keypoints per category, placed by a template of the category
    plus :data:`JITTER` times the image of normal noise (and a PNG each
    with ``image_size`` ``(h, w)``). Returns ``root``."""
    from scipy.io import savemat
    rng = np.random.RandomState(seed)
    h, w = image_size or (200, 240)
    scale = np.array([[w - 1], [h - 1]])
    for dirname in WILLOW_DIRS:
        base = os.path.join(root, 'WILLOW-ObjectClass', dirname)
        os.makedirs(base, exist_ok=True)
        template = rng.rand(2, 10)
        for i in range(items):
            pts = np.clip(template + JITTER * rng.randn(2, 10), 0, 1) * scale
            savemat(os.path.join(base, f'image_{i:04d}.mat'),
                    {'pts_coord': pts})
            if image_size is not None:
                _image(os.path.join(base, f'image_{i:04d}.png'), rng, h, w)
    return root


def write_pascal_pf(root, seed=0, items=4, categories=VOC_CATEGORIES):
    """A PF-PASCAL tree under ``root``: per category of ``categories``
    ``items`` annotation files of 6-12 keypoints (the same count within a
    category) plus 2 invisible ones (NaN rows), and
    ``parsePascalVOC.mat`` listing consecutive pairs of each category.
    Returns ``root``."""
    from scipy.io import savemat
    rng = np.random.RandomState(seed)
    base = os.path.join(root, 'PF-dataset-PASCAL')
    pairs = np.empty((1, len(VOC_CATEGORIES)), dtype=object)
    for c, cat in enumerate(VOC_CATEGORIES):
        pairs[0, c] = np.empty((0, 2), dtype=object)
        if cat not in categories:
            continue
        ann = os.path.join(base, 'Annotations', cat)
        os.makedirs(ann, exist_ok=True)
        m = rng.randint(6, 13)
        names = [f'2009_{c:02d}{i:04d}' for i in range(items)]
        for name in names:
            kps = np.concatenate([rng.rand(m, 2) * 300.0,
                                  np.full((2, 2), np.nan)])
            kps = np.concatenate([kps, np.zeros((len(kps), 1))], axis=1)
            savemat(os.path.join(ann, f'{name}.mat'), {'kps': kps})
        pairs[0, c] = np.array(
            [[np.array([a]), np.array([b])]
             for a, b in zip(names, names[1:])], dtype=object)
    classes = np.array([np.array([c]) for c in VOC_CATEGORIES],
                       dtype=object).reshape(1, -1)
    savemat(os.path.join(base, 'parsePascalVOC.mat'),
            {'PascalVOC': {'class': classes, 'pair': pairs}})
    return root


def write_dbp15k(root, n1=12, n2=14, e1=30, e2=36, dim=8, train=6, test=6,
                 seed=0):
    """DBP15K's ``zh_en`` pair in the JAPE layout under ``root``:
    global ids ``0..n1-1`` and ``100..`` for the second graph, random
    triples, the first ``train`` aligned ids as ``sup_pairs``, the next
    ``test`` as ``ref_pairs``, and one vector list per language indexed
    by global id. Returns ``root``."""
    rng = np.random.RandomState(seed)
    d = os.path.join(str(root), 'zh_en')
    os.makedirs(d, exist_ok=True)

    def write(name, text):
        _write_text(os.path.join(d, name), text)

    write('ent_ids_1', ''.join(f'{i}\te{i}\n' for i in range(n1)))
    write('ent_ids_2', ''.join(f'{100 + i}\tf{i}\n' for i in range(n2)))
    write('triples_1', ''.join(
        f'{rng.randint(n1)}\t0\t{rng.randint(n1)}\n' for _ in range(e1)))
    write('triples_2', ''.join(
        f'{100 + rng.randint(n2)}\t0\t{100 + rng.randint(n2)}\n'
        for _ in range(e2)))
    write('sup_pairs', ''.join(f'{i}\t{100 + i}\n' for i in range(train)))
    write('ref_pairs', ''.join(f'{i}\t{100 + i}\n'
                               for i in range(train, train + test)))
    vecs = rng.randn(max(120, 100 + n2), dim).tolist()
    write('zh_vectorList.json', json.dumps(vecs))
    write('en_vectorList.json', json.dumps(vecs))
    return str(root)
