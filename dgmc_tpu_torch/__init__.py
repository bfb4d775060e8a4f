"""PyTorch/CUDA port of Deep Graph Matching Consensus.

A second package beside the JAX reference (``dgmc_tpu``): the same
module layout (``ops/``, ``models/``, ``train/``, ``serve/``,
``experiments/``, ``utils/``, ``data/``) in PyTorch idiom, with every
kernel the serving and dense training paths reach written by hand for
Hopper (``csrc/``). The package imports neither JAX nor anything of
``dgmc_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
asking for CUDA where there is none raises instead of falling back.

Importing the package imports no torch (its modules do, each for
itself), so the static analysis (:mod:`dgmc_tpu_torch.analysis`) starts
without it.
"""

__version__ = '0.1.0'

__all__ = ['resolve_device', 'set_exact_float32', '__version__']


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` by default.

    ``None`` means ``cuda``; a CUDA device that is not available raises
    ``RuntimeError`` (no silent CPU fallback). ``'cpu'`` is always
    honoured.
    """
    import torch
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'dgmc_tpu_torch runs on CUDA by default and no CUDA device is '
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def set_exact_float32():
    """Full float32 on the card: no TF32 in matrix products or cuDNN, so
    results compare against the float32 plain versions."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
