"""Convert a torchvision VGG16 checkpoint to the ``.npz`` weights that
:class:`dgmc_tpu_torch.datasets.VGG16Features` loads.

The keypoint experiments take node features from torchvision's
pretrained VGG16. Given ``vgg16-397923af.pth`` (the torchvision VGG16
checkpoint), run::

    python -m dgmc_tpu_torch.datasets.convert_vgg vgg16-397923af.pth vgg16.npz
    python -m dgmc_tpu_torch.experiments.pascal --vgg_weights vgg16.npz

Only the 13 convolutions are kept (the extractor taps relu4_2 and
relu5_1; the classifier is unused), in torch's ``[out, in, kh, kw]``
layout under torchvision's key names (``features.<i>.weight`` /
``.bias``): the layout both packages' extractors read.
"""

import argparse

import numpy as np

__all__ = ['CONV_INDICES', 'CONV_SHAPES', 'convert_state_dict',
           'convert_checkpoint', 'main']

#: torchvision VGG16 ``features`` indices of the 13 convolutions (the
#: gaps are the ReLU and MaxPool entries of its ``nn.Sequential``).
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
#: ``(out_channels, in_channels)`` of each, for validation.
CONV_SHAPES = (
    (64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256),
    (256, 256), (512, 256), (512, 512), (512, 512), (512, 512), (512, 512),
    (512, 512),
)


def convert_state_dict(state_dict):
    """A torchvision VGG16 state dict (any mapping of array-likes with
    ``features.<i>.weight/.bias`` keys) → a dict of float32 NumPy arrays
    of the 13 convolutions. A missing key raises ``KeyError``, a shape
    other than VGG16's ``ValueError``."""
    out = {}
    for idx, (c_out, c_in) in zip(CONV_INDICES, CONV_SHAPES):
        for key, want in ((f'features.{idx}.weight', (c_out, c_in, 3, 3)),
                          (f'features.{idx}.bias', (c_out,))):
            if key not in state_dict:
                raise KeyError(
                    f'missing {key!r}: not a torchvision VGG16 '
                    f'checkpoint (13 conv layers expected)')
            arr = np.asarray(state_dict[key], dtype=np.float32)
            if arr.shape != want:
                raise ValueError(f'{key}: shape {arr.shape} != VGG16 {want}')
            out[key] = arr
    return out


def convert_checkpoint(src_path, out_path):
    """Read a ``.pth`` torchvision checkpoint (``torch.load`` with
    ``weights_only=True``) or an ``.npz`` with the same keys, and write
    the converted ``.npz``. Returns ``out_path``."""
    if src_path.endswith('.npz'):
        raw = dict(np.load(src_path))
    else:
        import torch
        obj = torch.load(src_path, map_location='cpu', weights_only=True)
        if hasattr(obj, 'state_dict'):
            obj = obj.state_dict()
        raw = {k: v.numpy() for k, v in obj.items() if hasattr(v, 'numpy')}
    np.savez(out_path, **convert_state_dict(raw))
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.datasets.convert_vgg',
        description='torchvision VGG16 checkpoint -> .npz weights')
    parser.add_argument('src', help='vgg16-*.pth (torchvision state dict)')
    parser.add_argument('out', help='output .npz path')
    args = parser.parse_args(argv)
    convert_checkpoint(args.src, args.out)
    print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
