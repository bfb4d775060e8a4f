"""The keypoint experiments' data layer held against the JAX package on
the CPU: the Delaunay / FaceToEdge / Cartesian / Distance transforms, the
VGG16 extractor (its resize against PIL), the weight converter, and the
PascalVOC, WILLOW, PascalPF and DBP15K parsers on trees in the published
raw layouts.

Tolerances: transforms and parsed graphs must be equal, bit for bit.
The port resizes with torch's antialiased bicubic in two passes, rounded
half up to uint8 levels after each, as PIL's 8-bit resize does: every
pixel within one level of PIL's, and fewer than 0.1% of them off by one.
On one resized array the two extractors agree to rtol 1e-4 / atol 1e-4
x max|out| (convolutions summed in other orders; measured ~1e-6). From
the image, the resize's one-level pixels move the features: each within
2e-3 x max|out| of JAX's, and on average within 1e-3 of its mean |out|
(measured 4e-4 and 2e-4 at input sizes 64 and 128).
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from dgmc_tpu.data import Cartesian as JCartesian
from dgmc_tpu.data import Compose as JCompose
from dgmc_tpu.data import Delaunay as JDelaunay
from dgmc_tpu.data import Distance as JDistance
from dgmc_tpu.data import FaceToEdge as JFaceToEdge
from dgmc_tpu.datasets import DBP15K as JDBP15K
from dgmc_tpu.datasets import PascalPF as JPascalPF
from dgmc_tpu.datasets import PascalVOCKeypoints as JVOC
from dgmc_tpu.datasets import VGG16Features as JVGG
from dgmc_tpu.datasets import WILLOWObjectClass as JWillow
from dgmc_tpu.datasets import convert_vgg as jconvert
from dgmc_tpu.datasets.features import _load_npz as jax_load_npz
from dgmc_tpu.datasets.pascal_voc import _parse_annotation as jparse
from dgmc_tpu.utils.data import Graph as JGraph
from dgmc_tpu_torch.data import (Cartesian, Compose, Delaunay, Distance,
                                 FaceToEdge)
from dgmc_tpu_torch.datasets import (DBP15K, PascalPF, PascalVOCKeypoints,
                                     VGG16Features, WILLOWObjectClass,
                                     convert_checkpoint, convert_vgg)
from dgmc_tpu_torch.datasets import features as tfeatures
from dgmc_tpu_torch.datasets.fixtures import (write_dbp15k, write_pascal_pf,
                                              write_voc, write_willow)
from dgmc_tpu_torch.datasets.pascal_voc import (CATEGORIES,
                                                _parse_annotation)
from dgmc_tpu_torch.utils.data import Graph


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (the suite's parallel workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- transforms ---------------------------------------------------------------

def _points(case):
    rng = np.random.RandomState(len(case))
    if case == 'collinear':
        t = rng.rand(6)
        return np.stack([t, 2 * t + 1], 1).astype(np.float32)
    if case == 'duplicates':
        p = rng.rand(5, 2)
        return np.concatenate([p, p[:2]]).astype(np.float32)
    return (rng.rand(int(case), 2) * 100).astype(np.float32)


@pytest.mark.parametrize('case', ['0', '1', '2', '3', '4', '7', '20', '40',
                                  'collinear', 'duplicates'])
@pytest.mark.parametrize('isotropic', [False, True])
def test_keypoint_transforms_equal_jax(case, isotropic):
    pos = _points(case)
    jg = JGraph(edge_index=np.zeros((2, 0), np.int64), pos=pos)
    tg = Graph(edge_index=np.zeros((2, 0), np.int64), pos=pos)
    jg, tg = JDelaunay()(jg), Delaunay()(tg)
    for a, b in ((jg.face, tg.face), (jg.edge_index, tg.edge_index)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype
    jg, tg = JFaceToEdge()(jg), FaceToEdge()(tg)
    assert jg.face is None and tg.face is None
    np.testing.assert_array_equal(tg.edge_index, jg.edge_index)
    pseudo = (JDistance(), Distance()) if isotropic else (JCartesian(),
                                                          Cartesian())
    jg, tg = pseudo[0](jg), pseudo[1](tg)
    np.testing.assert_array_equal(tg.edge_attr, jg.edge_attr)
    assert tg.edge_attr.shape == (tg.edge_index.shape[1], 1 + (not
                                                               isotropic))


def test_compose_leaves_the_cached_graph_alone():
    pos = _points('20')
    g = Graph(edge_index=np.zeros((2, 0), np.int64), pos=pos)
    out = Compose([Delaunay(), FaceToEdge(), Cartesian()])(g)
    assert g.edge_index.shape == (2, 0) and g.edge_attr is None
    assert out.edge_index.shape[1] > 0


# -- the VGG16 extractor ------------------------------------------------------

def _image(rng, h, w, gray=False):
    img = rng.randint(0, 256, (h, w) if gray else (h, w, 3))
    return img.astype(np.uint8)


@pytest.mark.parametrize('shape', [(32, 32), (48, 64), (500, 375),
                                   (17, 300), (120, 90, 'gray'),
                                   (256, 256)])
def test_resize_within_one_level_of_pil(shape):
    """Up- and downscaling, grayscale, and the identity size: every pixel
    within one uint8 level of PIL's bicubic ``resize``, fewer than 0.1%
    off at all (random pixels, the worst case for the intermediate
    rounding, and a smooth image)."""
    h, w = shape[:2]
    gray = len(shape) == 3
    rng = np.random.RandomState(h * w)
    yy, xx = np.mgrid[:h, :w]
    smooth = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(
        np.uint8)
    for img in (_image(rng, h, w, gray),
                smooth if gray else np.stack([smooth] * 3, -1)):
        want = np.asarray(Image.fromarray(img).resize((256, 256)),
                          np.float32)
        x = torch.from_numpy(img).float()
        got = tfeatures.resize_uint8(x if x.ndim == 3 else x[..., None],
                                     256).numpy()
        diff = np.abs(got.reshape(want.shape) - want)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() < 1e-3


@pytest.fixture(scope='module')
def extractors():
    jf = JVGG('random', input_size=64)
    jf._build()
    return jf, VGG16Features('random', input_size=64, device='cpu')


def test_random_weights_are_the_jax_draws_transposed(extractors):
    jf, tf = extractors
    assert len(tf.params) == len(jf.params) == 13
    for (jw, jb), (tw, tb) in zip(jf.params, tf.params):
        np.testing.assert_array_equal(tw, jw.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tb, jb)


def test_features_on_one_resized_array_match_jax(extractors):
    jf, tf = extractors
    rng = np.random.RandomState(0)
    arr = rng.rand(64, 64, 3).astype(np.float32)
    # Corners and edges of the map included: the cell clip.
    coords = np.concatenate([rng.rand(10, 2), [[0, 0], [1, 1], [1, 0]]]
                            ).astype(np.float32)
    want = np.asarray(jf._apply(jf.params, arr, coords))
    with torch.no_grad():
        got = tf.extract(torch.from_numpy(arr),
                         torch.from_numpy(coords)).numpy()
    assert got.shape == (13, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('shape', [(48, 64), (300, 200), (90, 120, 'gray')])
def test_features_from_the_image_match_jax(extractors, shape):
    jf, tf = extractors
    h, w = shape[:2]
    rng = np.random.RandomState(h + w)
    img = _image(rng, h, w, gray=len(shape) == 3)
    kps = np.stack([rng.rand(12) * (w - 1), rng.rand(12) * (h - 1)], 1)
    want, got = jf(img, kps), tf(img, kps)
    assert got.shape == want.shape == (12, 1024)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * scale)
    assert np.abs(got - want).mean() < 1e-3 * np.abs(want).mean()
    assert tf.calls >= 1 and tf.seconds > 0


def test_none_weights_give_zeros_without_a_device():
    tf = VGG16Features('none', device='cuda')   # never resolved
    out = tf(np.zeros((10, 10, 3), np.uint8), np.ones((4, 2)))
    assert out.shape == (4, 1024) and not out.any()
    assert tf.tag == 'none' and tf.calls == 0
    with pytest.raises(FileNotFoundError, match='weights not found'):
        VGG16Features('/nonexistent.npz')


def _state_dict(seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for idx, (c_out, c_in) in zip(convert_vgg.CONV_INDICES,
                                  convert_vgg.CONV_SHAPES):
        sd[f'features.{idx}.weight'] = torch.tensor(
            (rng.randn(c_out, c_in, 3, 3)
             * np.sqrt(2.0 / (9 * c_in))).astype(np.float32))
        sd[f'features.{idx}.bias'] = torch.tensor(
            (rng.randn(c_out) * 0.01).astype(np.float32))
    sd['classifier.0.weight'] = torch.zeros(8, 8)
    return sd


def test_npz_loader_takes_both_key_layouts(tmp_path):
    sd = _state_dict()
    torch.save(sd, str(tmp_path / 'vgg16.pth'))
    flat = convert_checkpoint(str(tmp_path / 'vgg16.pth'),
                              str(tmp_path / 'flat.npz'))
    want = [(w.transpose(3, 2, 0, 1), b) for w, b in jax_load_npz(flat)]
    # The block layout: HWIO for most, torch's layout for some (both
    # occur in converted files).
    blocks, i = {}, 0
    for bi, n in enumerate((2, 2, 3, 3, 3), start=1):
        for j in range(1, n + 1):
            idx = convert_vgg.CONV_INDICES[i]
            w = sd[f'features.{idx}.weight'].numpy()
            blocks[f'conv{bi}_{j}/w'] = (w if i % 3 == 0
                                         else w.transpose(2, 3, 1, 0))
            blocks[f'conv{bi}_{j}/b'] = sd[f'features.{idx}.bias'].numpy()
            i += 1
    np.savez(str(tmp_path / 'blocks.npz'), **blocks)
    for path in (flat, str(tmp_path / 'blocks.npz')):
        got = tfeatures.load_npz(path)
        jgot = jax_load_npz(path)
        assert len(got) == len(jgot) == 13
        for (tw, tb), (jw, jb), (ww, wb) in zip(got, jgot, want):
            np.testing.assert_array_equal(tw, jw.transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(tw, ww)
            np.testing.assert_array_equal(tb, wb)
    assert VGG16Features(flat, device='cpu').tag == 'flat'


def test_convert_and_features_match_jax(tmp_path):
    sd = _state_dict()
    src = tmp_path / 'vgg16.pth'
    torch.save(sd, str(src))
    out = convert_checkpoint(str(src), str(tmp_path / 'vgg16.npz'))
    jout = jconvert.convert_checkpoint(str(src), str(tmp_path / 'j.npz'))
    npz, jnpz = np.load(out), np.load(jout)
    assert sorted(npz.files) == sorted(jnpz.files) and len(npz.files) == 26
    for k in npz.files:
        np.testing.assert_array_equal(npz[k], jnpz[k])
    rng = np.random.RandomState(1)
    image = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    kps = np.array([[5.0, 7.0], [40.0, 30.0], [63.0, 47.0]], np.float32)
    want = JVGG(weights=jout, input_size=64)(image, kps)
    got = VGG16Features(weights=out, input_size=64, device='cpu')(image,
                                                                  kps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_convert_rejects_non_vgg_and_runs_as_a_cli(tmp_path, capsys):
    sd = _state_dict()
    del sd['features.28.bias']
    with pytest.raises(KeyError, match='features.28.bias'):
        convert_vgg.convert_state_dict(sd)
    sd = _state_dict()
    sd['features.0.weight'] = torch.zeros(64, 3, 5, 5)
    with pytest.raises(ValueError, match='shape'):
        convert_vgg.convert_state_dict(sd)
    src = tmp_path / 'vgg16.pth'
    torch.save(_state_dict(), str(src))
    convert_vgg.main([str(src), str(tmp_path / 'out.npz')])
    assert 'wrote' in capsys.readouterr().out
    assert VGG16Features(weights=str(tmp_path / 'out.npz')).tag == 'out'


# -- parsers ------------------------------------------------------------------

def _assert_graphs_equal(jgraphs, tgraphs):
    assert len(jgraphs) == len(tgraphs)
    for a, b in zip(jgraphs, tgraphs):
        assert a.name == b.name
        for k in ('edge_index', 'x', 'pos', 'y', 'edge_attr'):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_array_equal(vb, va, err_msg=k)
                assert vb.dtype == va.dtype, k


class RandomFeatures:
    """A stand-in extractor: seeded random features, no cache (no tag)."""
    tag = None

    def __call__(self, image, kps):
        rng = np.random.RandomState(int(np.asarray(kps).sum() * 1000) % 2**31)
        return rng.randn(len(kps), 1024).astype(np.float32)


def JCompose_keypoints():
    return JCompose([JDelaunay(), JFaceToEdge(), JCartesian()])


@pytest.fixture(scope='module')
def voc_root(tmp_path_factory):
    return write_voc(str(tmp_path_factory.mktemp('voc')), seed=3, train=5,
                     val=3)


@pytest.mark.parametrize('train', [True, False])
def test_voc_parser_matches_jax(voc_root, train):
    for category in CATEGORIES:
        jds = JVOC(voc_root, category, train=train,
                   transform=JCompose_keypoints(),
                   features=RandomFeatures())
        tds = PascalVOCKeypoints(voc_root, category, train=train,
                                 transform=Compose([Delaunay(), FaceToEdge(),
                                                    Cartesian()]),
                                 features=RandomFeatures())
        assert tds.keypoint_names == jds.keypoint_names
        assert len(tds) == len(jds) > 0
        _assert_graphs_equal([jds[i] for i in range(len(jds))],
                             [tds[i] for i in range(len(tds))])
        assert repr(tds) == repr(jds)


BERKELEY = """<?xml version="1.0" encoding="utf-8"?>
<annotation>
\t<image>{image}</image>
\t<category>aeroplane</category>
\t<visible_bounds height="161.00" width="325.00" xmin="21.00" ymin="88.00"/>
\t<keypoints>
\t\t<keypoint name="L_WingTip" round="0" visible="1" x="43.0" y="151.5" z="0.0"/>
\t\t<keypoint name="R_WingTip" round="0" visible="0" x="269.0" y="110.0" z="0.0"/>
\t\t<keypoint name="NoseTip" round="1" visible="1" x="328.2" y="160.7" z="0.0"/>
\t\t<keypoint name="{dup}" round="1" visible="1" x="30.2" y="100.7" z="0.0"/>
\t</keypoints>
\t<segmented>0</segmented>
</annotation>
"""


def test_voc_quirks_splits_and_errors_match_jax(tmp_path):
    """Width/height and xmax/ymax bounds, invisible keypoints, a repeated
    class skipped, the official lists (label -1 out), the plain lists
    under ``splits/``, the warned fraction split, a list that matches
    nothing, a missing root and ``pre_filter``."""
    ann = tmp_path / 'annotations' / 'aeroplane'
    ann.mkdir(parents=True)
    for i, img in enumerate(['2008_000045', '2008_000046', '2008_000047',
                             '2007_000048']):
        dup = 'NoseTip' if i == 1 else 'Tail'
        text = BERKELEY.format(image=img, dup=dup)
        if i == 2:
            text = text.replace('height="161.00" width="325.00"',
                                'xmax="300.00" ymax="200.00"')
        (ann / f'{img}_1.xml').write_text(text)
    for name in os.listdir(ann):
        p = str(ann / name)
        assert _parse_annotation(p) == jparse(p)

    def both(**kw):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter('always')
            j = JVOC(str(tmp_path), 'aeroplane', features=RandomFeatures(),
                     **kw)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter('always')
            t = PascalVOCKeypoints(str(tmp_path), 'aeroplane',
                                   features=RandomFeatures(), **kw)
        tw = [str(w.message) for w in tw]
        assert tw == [str(w.message) for w in jw]
        _assert_graphs_equal(j._graphs, t._graphs)
        return t, [w for w in tw if 'fraction split' in w]

    t, w = both(train=True)                  # fraction split, warned
    assert len(w) == 1
    assert [g.name for g in t._graphs] == ['2007_000048_1',
                                           '2008_000045_1']
    t, _ = both(train=True, pre_filter=lambda g: not g.name.startswith(
        '2007'))
    assert len(t) == 1
    splits = tmp_path / 'splits'
    splits.mkdir()
    (splits / 'aeroplane_train.txt').write_text('2008_000047\n2008_000046\n')
    t, w = both(train=True)
    assert not w and [g.name for g in t._graphs] == ['2008_000047_1']
    main = tmp_path / 'ImageSets' / 'Main'
    main.mkdir(parents=True)
    (main / 'aeroplane_train.txt').write_text(
        '2008_000045  0\n2007_000048  1\n2008_000099 -1\n')
    (main / 'aeroplane_val.txt').write_text('2008_000047  1\n')
    t, _ = both(train=True)
    assert len(t) == 2
    t, _ = both(train=False)
    assert len(t) == 1
    (main / 'aeroplane_val.txt').write_text('2011_000001  1\n')
    for cls in (JVOC, PascalVOCKeypoints):
        with pytest.raises(ValueError, match='matched 0 of'):
            cls(str(tmp_path), 'aeroplane', train=False,
                features=RandomFeatures())
        with pytest.raises(FileNotFoundError, match='annotations not found'):
            cls(str(tmp_path), 'bird', features=RandomFeatures())
        with pytest.raises(ValueError, match='unknown category'):
            cls(str(tmp_path), 'zebra', features=RandomFeatures())
    with pytest.raises(NotImplementedError, match='downloads are not'):
        PascalVOCKeypoints(str(tmp_path), 'bird', download=True,
                           features=RandomFeatures())


def _voc_with_image(tmp_path):
    write_voc(str(tmp_path), seed=5, train=2, val=1)
    rng = np.random.RandomState(0)
    os.makedirs(tmp_path / 'images', exist_ok=True)
    for c in range(2):
        Image.fromarray(_image(rng, 120, 160)).save(
            str(tmp_path / 'images' / f'2008_{c:02d}0000.png'))
    return str(tmp_path)


def test_voc_features_cache_and_images(tmp_path):
    """Features of the padded crop, from the image where one exists and
    from a warned zero image where not, cached under the port's own name
    (a JAX cache beside it is never read); the crop's features agree with
    JAX's within the extractor's tolerance."""
    root = _voc_with_image(tmp_path)
    jf = JVGG('random', input_size=32)
    tf = VGG16Features('random', input_size=32, device='cpu')
    with pytest.warns(UserWarning, match='ZERO images'):
        jds = JVOC(root, 'aeroplane', features=jf)
    with pytest.warns(UserWarning, match='ZERO images'):
        tds = PascalVOCKeypoints(root, 'aeroplane', features=tf)
    processed = tmp_path / 'processed'
    assert sorted(os.listdir(processed)) == ['aeroplane_random.npz',
                                             'aeroplane_random_torch.npz']
    assert tf.calls == len(tds) == 2
    for a, b in zip(jds._graphs, tds._graphs):
        np.testing.assert_allclose(b.x, a.x, rtol=0,
                                   atol=2e-3 * np.abs(a.x).max())
        np.testing.assert_array_equal(b.pos, a.pos)
    # Poison the JAX cache: the port reads its own.
    with np.load(processed / 'aeroplane_random.npz') as z:
        np.savez(processed / 'aeroplane_random.npz',
                 **{k: z[k] + 1.0 for k in z.files})
    again = PascalVOCKeypoints(root, 'aeroplane', features=tf)
    assert tf.calls == 2    # nothing extracted: the cache was read
    for a, b in zip(tds._graphs, again._graphs):
        np.testing.assert_array_equal(b.x, a.x)


def test_image_without_pil_raises_and_names_it(tmp_path, monkeypatch):
    root = _voc_with_image(tmp_path)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='Pillow'):
        PascalVOCKeypoints(root, 'aeroplane', features=RandomFeatures())
    # weights='none' reads no image, so it needs no PIL.
    assert len(PascalVOCKeypoints(root, 'aeroplane',
                                  features=VGG16Features('none'))) == 2
    # No image file: no PIL needed.
    write_willow(str(tmp_path / 'w'), items=2)
    assert len(WILLOWObjectClass(str(tmp_path / 'w'), 'duck',
                                 features=VGG16Features('none'))) == 2


@pytest.fixture(scope='module')
def willow_root(tmp_path_factory):
    root = write_willow(str(tmp_path_factory.mktemp('willow')), seed=4,
                        items=23)
    rng = np.random.RandomState(9)
    Image.fromarray(_image(rng, 64, 80)).save(os.path.join(
        root, 'WILLOW-ObjectClass', 'Car', 'image_0000.png'))
    return root


def test_willow_parser_matches_jax(willow_root):
    from dgmc_tpu.datasets.willow import CATEGORIES as JCATS
    from dgmc_tpu_torch.datasets.willow import CATEGORIES as TCATS
    assert TCATS == JCATS
    for category in TCATS:
        jds = JWillow(willow_root, category, transform=JCompose_keypoints(),
                      features=RandomFeatures())
        tds = WILLOWObjectClass(willow_root, category,
                                transform=Compose([Delaunay(), FaceToEdge(),
                                                   Cartesian()]),
                                features=RandomFeatures())
        _assert_graphs_equal([jds[i] for i in range(len(jds))],
                             [tds[i] for i in range(len(tds))])
        for seed in (0, 3):
            for jpart, tpart in zip(jds.shuffled_split(20, seed=seed),
                                    tds.shuffled_split(20, seed=seed)):
                assert tpart.indices == jpart.indices
        assert repr(tds) == repr(jds)
    jf = JVGG('random', input_size=32)
    tf = VGG16Features('random', input_size=32, device='cpu')
    a = JWillow(willow_root, 'car', features=jf)[0].x
    b = WILLOWObjectClass(willow_root, 'car', features=tf)[0].x
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-3 * np.abs(a).max())
    for cls in (JWillow, WILLOWObjectClass):
        with pytest.raises(FileNotFoundError, match='WILLOW raw data'):
            cls(str(willow_root) + '_missing', 'face',
                features=RandomFeatures())


def test_pascal_pf_parser_matches_jax(tmp_path):
    root = write_pascal_pf(str(tmp_path), seed=2, items=4)
    # A category without a resolvable pair list: consecutive pairs.
    write_pascal_pf(str(tmp_path / 'no_list'), seed=3, items=3,
                    categories=('car',))
    os.remove(tmp_path / 'no_list' / 'PF-dataset-PASCAL' /
              'parsePascalVOC.mat')
    for r, cats in ((root, CATEGORIES), (str(tmp_path / 'no_list'),
                                         ('car',))):
        for category in cats:
            jds, tds = JPascalPF(r, category), PascalPF(r, category)
            assert tds.pairs == jds.pairs and len(tds.pairs) > 0
            assert sorted(tds.items) == sorted(jds.items)
            _assert_graphs_equal([jds.items[k] for k in sorted(jds.items)],
                                 [tds.items[k] for k in sorted(tds.items)])
            for a, b in zip(jds.pair_graphs(), tds.pair_graphs()):
                np.testing.assert_array_equal(b[2], a[2])
            assert repr(tds) == repr(jds)
    # One pair a category: simplify_cells squeezes it to a flat row.
    one = tmp_path / 'one'
    write_pascal_pf(str(one), seed=4, items=2, categories=('bus',))
    assert PascalPF(str(one), 'bus').pairs == JPascalPF(str(one), 'bus').pairs
    for cls in (JPascalPF, PascalPF):
        with pytest.raises(FileNotFoundError, match='PascalPF raw data'):
            cls(str(tmp_path / 'missing'), 'car')


def _jape(tmp_path):
    """zh_en in the JAPE format: unsorted global ids, graph 2 offset at
    10000, a relation-id file to ignore, one shared vector list."""
    d = tmp_path / 'zh_en'
    d.mkdir()
    (d / 'ent_ids_1').write_text('7\ta\n0\tb\n2\tc\n1\td\n')
    (d / 'ent_ids_2').write_text('10000\te\n10002\tf\n10001\tg\n')
    (d / 'triples_1').write_text('7\t100\t0\n2\t100\t0\n1\t101\t2\n9\t1\t0\n')
    (d / 'triples_2').write_text('10000\t3\t10002\n10001\t3\t10002\n')
    (d / 'rel_ids_1').write_text('100\tp\n')
    (d / 'sup_ent_ids').write_text('7\t10000\n2\t10001\n')
    (d / 'ref_ent_ids').write_text('0\t10002\n')
    vecs = [[float(i), 1.0, 2.0] for i in range(10003)]
    (d / 'vectorList.json').write_text(json.dumps(vecs))
    return str(tmp_path)


@pytest.mark.parametrize('layout', ['jape', 'per_language', 'tiny'])
def test_dbp15k_parser_matches_jax(tmp_path, layout):
    if layout == 'jape':
        root = _jape(tmp_path)
    elif layout == 'tiny':
        root = write_dbp15k(str(tmp_path))
    else:
        root = write_dbp15k(str(tmp_path), n1=5, n2=6, e1=8, e2=9, dim=4,
                            train=2, test=2, seed=3)
        np.save(os.path.join(root, 'zh_en', 'x2.npy'),
                np.arange(24, dtype=np.float64).reshape(6, 4))
    j, t = JDBP15K(root, 'zh_en'), DBP15K(root, 'zh_en')
    for k in ('x1', 'x2', 'edge_index1', 'edge_index2', 'rel1', 'rel2',
              'train_y', 'test_y'):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
        assert getattr(t, k).dtype == getattr(j, k).dtype, k
    _assert_graphs_equal(j.graphs(), t.graphs())
    assert repr(t) == repr(j)
    for cls in (JDBP15K, DBP15K):
        with pytest.raises(FileNotFoundError):
            cls(root, 'ja_en')
        with pytest.raises(ValueError, match='pair must be one of'):
            cls(root, 'xx_en')


def test_tiny_dbp15k_fixture_is_the_helpers(tmp_path):
    """``write_dbp15k``'s defaults rebuild ``tests/helpers.py``'s
    ``make_tiny_dbp15k`` tree file for file."""
    from tests.helpers import make_tiny_dbp15k
    a = make_tiny_dbp15k(tmp_path / 'a')
    b = write_dbp15k(str(tmp_path / 'b'))
    names = sorted(os.listdir(os.path.join(a, 'zh_en')))
    assert names == sorted(os.listdir(os.path.join(b, 'zh_en')))
    for n in names:
        with open(os.path.join(a, 'zh_en', n)) as fa, \
                open(os.path.join(b, 'zh_en', n)) as fb:
            assert fa.read() == fb.read(), n


def test_fixture_trees_parse_in_both(tmp_path):
    """The writers' trees with images: every category parses in both
    packages (PIL writes the PNGs)."""
    write_voc(str(tmp_path / 'v'), seed=1, train=2, val=1,
              image_size=(40, 50))
    write_willow(str(tmp_path / 'w'), seed=1, items=2, image_size=(30, 40))
    none = VGG16Features('none')
    for c in CATEGORIES:
        assert len(PascalVOCKeypoints(str(tmp_path / 'v'), c,
                                      features=none)) == len(
            JVOC(str(tmp_path / 'v'), c, features=JVGG('none')))
    assert len(WILLOWObjectClass(str(tmp_path / 'w'), 'face',
                                 features=none)) == 2
