"""Keypoint visual features (the WILLOW / PascalVOC node features).

Every keypoint gets the VGG16 ``relu4_2`` and ``relu5_1`` activation
maps of its image, bilinearly sampled at the keypoint and concatenated
(512 + 512 = 1024 float32 values), as the JAX package's
``dgmc_tpu/datasets/features.py`` computes them. Here the stack up to
``relu5_1`` runs on the device (``torch.nn.functional.conv2d``, ReLU and
2 x 2 max pooling, float32), one image a call, with three weight
sources:

- ``weights=<path.npz>``: converted pretrained weights, keys
  ``features.<i>.weight`` / ``.bias`` (torchvision's layout
  ``[out, in, kh, kw]``, used as they are) or ``conv<b>_<j>/{w,b}``
  (HWIO, transposed here; a weight already ``[out, in, 3, 3]`` is kept);
- ``weights='random'``: the JAX package's He-initialized filters, the
  same NumPy draws (``RandomState(0)``), transposed from HWIO;
- ``weights='none'``: no image is read; the features are zeros.

The image is resized to ``input_size`` squared on the device by
``torch.nn.functional.interpolate(mode='bicubic', antialias=True)``, rows
then columns, each pass rounded half up and clamped to uint8 levels, as
PIL's 8-bit ``Image.resize`` (the JAX package's) computes it: the two
agree within one level on every pixel and exactly on nearly all
(``tests/test_torch_keypoints.py`` states the share). The extractor
runs in float32 whatever the training policy; the CLIs'
``precision.apply`` turns TF32 off on the card.
"""

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['VGG_CFG', 'TAP_RELU4_2', 'TAP_RELU5_1', 'FEATURE_DIM',
           'IMAGENET_MEAN', 'IMAGENET_STD', 'he_weights', 'load_npz',
           'resize_uint8', 'bilinear_sample', 'VGG16Features']

VGG_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
           512, 512, 512, 'M', 512, 512, 512, 'M')
#: The tapped activations, counting convolutions from 0: relu4_2 is the
#: 9th, relu5_1 the 11th (the last one run).
TAP_RELU4_2 = 8
TAP_RELU5_1 = 10
FEATURE_DIM = 1024
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def he_weights(seed=0):
    """The ``'random'`` weights: ``[(w [out, in, 3, 3], b [out])]`` for
    the 13 convolutions, the JAX package's draws (HWIO, fan-in scaled)
    transposed to torch's layout."""
    rng = np.random.RandomState(seed)
    params = []
    c_in = 3
    for c in VGG_CFG:
        if c == 'M':
            continue
        w = rng.randn(3, 3, c_in, c).astype(np.float32)
        w *= np.sqrt(2.0 / (3 * 3 * c_in))
        params.append((np.ascontiguousarray(w.transpose(3, 2, 0, 1)),
                       np.zeros(c, np.float32)))
        c_in = c
    return params


def load_npz(path):
    """Weights from a converted ``.npz`` in either key layout, as
    ``[(w [out, in, 3, 3], b)]``."""
    raw = np.load(path)
    params = []
    if any(k.startswith('features.') for k in raw.files):
        idxs = sorted({int(k.split('.')[1]) for k in raw.files
                       if k.startswith('features.')})
        for i in idxs:
            params.append((raw[f'features.{i}.weight'].astype(np.float32),
                           raw[f'features.{i}.bias'].astype(np.float32)))
        return params
    for bi, n in enumerate((2, 2, 3, 3, 3), start=1):
        for j in range(1, n + 1):
            w = raw[f'conv{bi}_{j}/w'].astype(np.float32)
            if w.shape[0] == w.shape[1] == 3:      # HWIO
                w = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
            params.append((w, raw[f'conv{bi}_{j}/b'].astype(np.float32)))
    return params


def resize_uint8(image, size):
    """``image [H, W, C]`` (uint8 levels as a float tensor) resized to
    ``size`` x ``size`` by antialiased bicubic interpolation →
    ``[size, size, C]`` float32 uint8 levels. As PIL does for 8-bit
    images, the rows are resized first, rounded (half up) and clamped to
    uint8 levels, then the columns, rounded and clamped again (bicubic
    overshoots, and PIL's intermediate image is 8-bit)."""
    x = image.permute(2, 0, 1)[None]
    for shape in ((x.shape[2], size), (size, size)):
        if tuple(x.shape[2:]) != shape:
            x = F.interpolate(x, size=shape, mode='bicubic',
                              align_corners=False,
                              antialias=True)
            x = torch.floor(x + 0.5).clamp(0, 255)
    return x[0].permute(1, 2, 0)


def bilinear_sample(fmap, coords_01):
    """Sample ``fmap [C, h, w]`` at ``coords_01 [M, 2]`` (x, y in
    [0, 1]) bilinearly → ``[M, C]``; the cell's corner is clipped to
    ``[0, w - 2]`` x ``[0, h - 2]`` as the JAX package clips it."""
    h, w = fmap.shape[1], fmap.shape[2]
    xf = coords_01[:, 0] * (w - 1)
    yf = coords_01[:, 1] * (h - 1)
    x0 = torch.floor(xf).long().clamp(0, w - 2)
    y0 = torch.floor(yf).long().clamp(0, h - 2)
    dx = (xf - x0)[:, None]
    dy = (yf - y0)[:, None]
    f = fmap.permute(1, 2, 0)
    f00, f01 = f[y0, x0], f[y0, x0 + 1]
    f10, f11 = f[y0 + 1, x0], f[y0 + 1, x0 + 1]
    return ((1 - dy) * ((1 - dx) * f00 + dx * f01)
            + dy * ((1 - dx) * f10 + dx * f11))


class VGG16Features:
    """The keypoint feature extractor.

    ``VGG16Features(weights='random', input_size=256, device=None)``;
    call it with an ``[H, W, 3]`` (or ``[H, W]`` grayscale) uint8 image
    and ``[M, 2]`` pixel keypoint coordinates (x, y) to get ``[M, 1024]``
    float32 features as a NumPy array. ``device`` is where the stack
    runs (``cuda`` by default, resolved at the first call that computes,
    so ``weights='none'`` needs no device); ``tag`` names the weight
    source in the datasets' feature caches; ``calls`` and ``seconds``
    count the extractions and their host seconds (each ends when its
    features are on the host).
    """

    def __init__(self, weights='random', input_size=256, device=None):
        self.input_size = input_size
        self._device = device
        if weights == 'none':
            self.params, self.tag = None, 'none'
        elif weights == 'random' or weights is None:
            self.params, self.tag = he_weights(), 'random'
        elif isinstance(weights, str) and os.path.exists(weights):
            self.params = load_npz(weights)
            self.tag = os.path.splitext(os.path.basename(weights))[0]
        else:
            raise FileNotFoundError(
                f'VGG16 weights not found at {weights!r}; pass '
                f"'random'/'none' or a converted .npz path")
        self._weights = None
        self.calls, self.seconds = 0, 0.0

    def _on_device(self):
        if self._weights is None:
            from dgmc_tpu_torch import resolve_device
            dev = resolve_device(self._device)
            self._weights = [(torch.from_numpy(w).to(dev),
                              torch.from_numpy(b).to(dev))
                             for w, b in self.params]
        return self._weights

    def taps(self, x):
        """``x [H, W, 3]`` float32 in [0, 1] on the device →
        ``(relu4_2, relu5_1)``, each ``[C, h, w]``."""
        weights = self._on_device()
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(2, 0, 1)[None]
        taps, ci = [], 0
        for c in VGG_CFG:
            if c == 'M':
                x = F.max_pool2d(x, 2)
                continue
            w, b = weights[ci]
            x = torch.relu(F.conv2d(x, w, b, padding=1))
            if ci in (TAP_RELU4_2, TAP_RELU5_1):
                taps.append(x[0])
            if ci == TAP_RELU5_1:
                break
            ci += 1
        return taps

    def prepare(self, image):
        """The resized ``[S, S, 3]`` float32 image in [0, 1] on the
        device (grayscale repeated into three channels)."""
        dev = self._on_device()[0][0].device
        img = np.asarray(image).astype(np.uint8)
        x = torch.from_numpy(img).to(dev, torch.float32)
        if x.ndim == 2:
            x = x[..., None]
        x = resize_uint8(x, self.input_size) / 255.0
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, 3)
        return x

    def extract(self, x, coords_01):
        """Features of the prepared image ``x`` at ``coords_01 [M, 2]``
        (a float32 tensor on the device) → ``[M, 1024]`` on the
        device."""
        t4, t5 = self.taps(x)
        return torch.cat([bilinear_sample(t4, coords_01),
                          bilinear_sample(t5, coords_01)], dim=-1)

    def __call__(self, image, keypoints_xy):
        M = np.shape(keypoints_xy)[0]
        if self.params is None:
            return np.zeros((M, FEATURE_DIM), np.float32)
        t0 = time.perf_counter()
        h, w = np.shape(image)[:2]
        coords = np.asarray(keypoints_xy, np.float32) / np.array(
            [max(w - 1, 1), max(h - 1, 1)], np.float32)
        coords = np.clip(coords, 0.0, 1.0)
        with torch.no_grad():
            x = self.prepare(image)
            out = self.extract(x, torch.from_numpy(coords).to(x.device))
        out = out.cpu().numpy()
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out
