"""Carry weights across: flax parameter trees → torch ``state_dict``s.

``params`` is the flax parameter tree as nested dicts of numpy arrays
(``jax.device_get(variables['params'])`` gives one). The mapping:

- a flax ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight``
  ``[out, in]``; its bias keeps its shape (RelConv's ``lin1``/``lin2``
  have none, ``root`` and ``final`` do);
- RelCNN's and SplineCNN's layer scopes ``conv_<i>`` become
  ``convs.<i>``, RelCNN's batch norms ``bn_<i>`` ``bns.<i>``;
- an MLP's ``dense_<i>`` and ``bn_<i>`` become ``lins.<i>`` and
  ``bns.<i>``; GIN's ``conv_<i>`` (its ``eps``) stays ``convs.<i>`` and
  its ``mlp_<i>``, bound in GIN's own scope, becomes ``convs.<i>.mlp``;
- a ``MaskedBatchNorm``'s ``scale`` and ``bias`` carry over, and its
  running ``mean`` and ``var`` from the flax ``batch_stats`` collection
  (the same scopes) into the module's buffers where a ``batch_stats``
  tree is given;
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

__all__ = ['dgmc_from_flax', 'gin_from_flax', 'mlp_from_flax',
           'relcnn_from_flax', 'splinecnn_from_flax']

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


def _batch_norm(params, stats, key, out):
    """A flax ``MaskedBatchNorm`` into ``out``: ``scale`` and ``bias``,
    and the running ``mean`` and ``var`` where ``stats`` (its
    ``batch_stats`` scope) is given."""
    for name in ('scale', 'bias'):
        out[f'{key}.{name}'] = _tensor(params[name])
    if stats is not None:
        for name in ('mean', 'var'):
            out[f'{key}.{name}'] = _tensor(stats[name])


def _stats_scopes(stats, scopes, what):
    """``stats`` (a ``batch_stats`` tree or ``None``), checked to hold
    only scopes of ``scopes``."""
    extra = set(stats or ()) - set(scopes)
    if extra:
        raise KeyError(f'unexpected {what} batch_stats scopes '
                       f'{sorted(extra)}')
    return stats


def relcnn_from_flax(params, prefix='', batch_stats=None):
    """State dict of :class:`~dgmc_tpu_torch.models.rel.RelCNN` from a
    flax ``RelCNN`` parameter tree (and its ``batch_stats`` tree, for
    batch norm's running averages); keys are prefixed with ``prefix``."""
    stats = _stats_scopes(batch_stats, [s for s in params
                                        if s.startswith('bn_')], 'RelCNN')
    out = {}
    for scope, sub in params.items():
        m = re.fullmatch(r'(conv|bn)_(\d+)', scope)
        if m and m.group(1) == 'conv':
            for lin in ('lin1', 'lin2', 'root'):
                _linear(sub[lin], f'{prefix}convs.{m.group(2)}.{lin}', out)
        elif m:
            _batch_norm(sub, None if stats is None else stats[scope],
                        f'{prefix}bns.{m.group(2)}', out)
        elif scope == 'final':
            _linear(sub, f'{prefix}final', out)
        else:
            raise KeyError(f'unexpected RelCNN parameter scope {scope!r}')
    return out


def mlp_from_flax(params, prefix='', batch_stats=None):
    """State dict of :class:`~dgmc_tpu_torch.models.mlp.MLP` from a flax
    ``MLP`` parameter tree (and its ``batch_stats`` tree); keys are
    prefixed with ``prefix``."""
    stats = _stats_scopes(batch_stats, [s for s in params
                                        if s.startswith('bn_')], 'MLP')
    out = {}
    for scope, sub in params.items():
        m = re.fullmatch(r'(dense|bn)_(\d+)', scope)
        if m and m.group(1) == 'dense':
            _linear(sub, f'{prefix}lins.{m.group(2)}', out)
        elif m:
            _batch_norm(sub, None if stats is None else stats[scope],
                        f'{prefix}bns.{m.group(2)}', out)
        else:
            raise KeyError(f'unexpected MLP parameter scope {scope!r}')
    return out


def gin_from_flax(params, prefix='', batch_stats=None):
    """State dict of :class:`~dgmc_tpu_torch.models.gin.GIN` from a flax
    ``GIN`` parameter tree (and its ``batch_stats`` tree); keys are
    prefixed with ``prefix``."""
    stats = _stats_scopes(batch_stats, [s for s in params
                                        if s.startswith('mlp_')], 'GIN')
    out = {}
    for scope, sub in params.items():
        m = re.fullmatch(r'(conv|mlp)_(\d+)', scope)
        if m and m.group(1) == 'conv':
            if set(sub) != {'eps'}:
                raise KeyError(f'unexpected GINConv parameters '
                               f'{sorted(sub)}')
            out[f'{prefix}convs.{m.group(2)}.eps'] = _tensor(sub['eps'])
        elif m:
            out.update(mlp_from_flax(
                sub, f'{prefix}convs.{m.group(2)}.mlp.',
                None if stats is None else stats.get(scope)))
        elif scope == 'final':
            _linear(sub, f'{prefix}final', out)
        else:
            raise KeyError(f'unexpected GIN parameter scope {scope!r}')
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


def _backbone_from_flax(params, prefix, batch_stats):
    conv = params.get('conv_0', {})
    if 'weight' in conv:
        if batch_stats:
            raise KeyError('SplineCNN has no batch_stats')
        return splinecnn_from_flax(params, prefix)
    convert = gin_from_flax if 'eps' in conv else relcnn_from_flax
    return convert(params, prefix, batch_stats)


def dgmc_from_flax(params, batch_stats=None):
    """State dict of :class:`~dgmc_tpu_torch.models.dgmc.DGMC` (RelCNN,
    SplineCNN or GIN ψ₁/ψ₂) from the flax DGMC parameter tree and, for
    backbones with batch norm, its ``batch_stats`` tree (without it the
    running averages are left out of the state dict)."""
    stats = _stats_scopes(batch_stats, ('psi_1', 'psi_2'), 'DGMC') or {}
    out = {}
    for role in ('psi_1', 'psi_2'):
        out.update(_backbone_from_flax(params[role], f'{role}.',
                                       stats.get(role)))
    for name in _MLP:
        out[name] = _tensor(params[name])
    extra = set(params) - {'psi_1', 'psi_2', *_MLP}
    if extra:
        raise KeyError(f'unexpected DGMC parameters {sorted(extra)}')
    return out
