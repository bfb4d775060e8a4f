"""Carry weights across: flax parameter trees → torch ``state_dict``s.

``params`` is the flax parameter tree as nested dicts of numpy arrays
(``jax.device_get(variables['params'])`` gives one). The mapping:

- a flax ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight``
  ``[out, in]``; its bias keeps its shape (RelConv's ``lin1``/``lin2``
  have none, ``root`` and ``final`` do);
- RelCNN's and SplineCNN's layer scopes ``conv_<i>`` become
  ``convs.<i>``;
- a SplineConv ``weight [K^D, C_in, C_out]`` keeps its layout, its
  ``root`` (a bias-free Dense) is transposed, its ``bias`` carries over;
- DGMC's explicit consensus-MLP parameters (``mlp_hidden_kernel``,
  ``mlp_hidden_bias``, ``mlp_out_kernel``, ``mlp_out_bias``) keep their
  names and shapes.

Parameters are float32 under both precision policies, in either package
(a policy casts them where they are used, never where they are stored):
a parameter of any other dtype raises instead of being converted.
"""

import re

import numpy as np
import torch

__all__ = ['dgmc_from_flax', 'relcnn_from_flax', 'splinecnn_from_flax']

_MLP = ('mlp_hidden_kernel', 'mlp_hidden_bias', 'mlp_out_kernel',
        'mlp_out_bias')


def _tensor(a):
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f'a parameter of dtype {a.dtype}: parameters are '
                        f'float32 under both precision policies')
    return torch.tensor(a)


def _linear(dense, key, out):
    """A flax ``Dense`` into ``out`` as ``Linear`` ``weight`` (transposed)
    and, where it has one, ``bias``."""
    out[f'{key}.weight'] = _tensor(dense['kernel']).T.contiguous()
    if 'bias' in dense:
        out[f'{key}.bias'] = _tensor(dense['bias'])


def relcnn_from_flax(params, prefix=''):
    """State dict of :class:`~dgmc_tpu_torch.models.rel.RelCNN` from a
    flax ``RelCNN`` parameter tree; keys are prefixed with ``prefix``."""
    out = {}
    for scope, sub in params.items():
        m = re.fullmatch(r'conv_(\d+)', scope)
        if m:
            for lin in ('lin1', 'lin2', 'root'):
                _linear(sub[lin], f'{prefix}convs.{m.group(1)}.{lin}', out)
        elif scope == 'final':
            _linear(sub, f'{prefix}final', out)
        else:
            raise KeyError(f'unexpected RelCNN parameter scope {scope!r}')
    return out


def splinecnn_from_flax(params, prefix=''):
    """State dict of :class:`~dgmc_tpu_torch.models.spline.SplineCNN`
    from a flax ``SplineCNN`` parameter tree; keys are prefixed with
    ``prefix``."""
    out = {}
    for scope, sub in params.items():
        m = re.fullmatch(r'conv_(\d+)', scope)
        if m:
            key = f'{prefix}convs.{m.group(1)}'
            out[f'{key}.weight'] = _tensor(sub['weight'])
            _linear(sub['root'], f'{key}.root', out)
            out[f'{key}.bias'] = _tensor(sub['bias'])
        elif scope == 'final':
            _linear(sub, f'{prefix}final', out)
        else:
            raise KeyError(f'unexpected SplineCNN parameter scope {scope!r}')
    return out


def _backbone_from_flax(params, prefix):
    spline = 'weight' in params.get('conv_0', {})
    return (splinecnn_from_flax if spline else relcnn_from_flax)(
        params, prefix)


def dgmc_from_flax(params):
    """State dict of :class:`~dgmc_tpu_torch.models.dgmc.DGMC` (RelCNN or
    SplineCNN ψ₁/ψ₂) from the flax DGMC parameter tree."""
    out = {}
    for role in ('psi_1', 'psi_2'):
        out.update(_backbone_from_flax(params[role], prefix=f'{role}.'))
    for name in _MLP:
        out[name] = _tensor(params[name])
    extra = set(params) - {'psi_1', 'psi_2', *_MLP}
    if extra:
        raise KeyError(f'unexpected DGMC parameters {sorted(extra)}')
    return out
