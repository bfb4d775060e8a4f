"""Precision policy: bf16 compute with float32 accumulation, the default.

One object owns the port's mixed-precision contract, as the JAX
package's ``models/precision.py`` does:

- **compute dtype**: what the backbone products and the consensus
  kernels run in (``torch.bfloat16`` under the default policy; ``None``
  means float32).
- **accumulation**: correspondence logits (``S_hat``), softmaxes,
  losses, segment reductions and the kernels' running sums stay float32
  under every policy. A bf16 running sum stops absorbing contributions
  once it is about 256 times an addend, so this is a correctness
  contract, not a knob; there is no field for it.
- **parameters and Adam state**: float32 under every policy. Modules
  cast their weights to the compute dtype where they use them, so the
  gradient of that cast lands in float32.
- **gather dtype**: the dtype blocked-aggregation rows travel in
  (:mod:`~dgmc_tpu_torch.ops.blocked`, where they stay at least 512 bytes
  wide), read by :func:`gather_dtype_of`.

The training CLIs take ``--precision {bf16,f32}`` (default bf16),
``--f32`` as the opt-out and ``--bf16`` as an alias of the default
(:func:`add_precision_args`). :func:`apply` selects the float32
accumulation contract of the card's libraries for a run; nothing here
changes global state at import.
"""

import dataclasses
from typing import Optional

import torch

from dgmc_tpu_torch import set_exact_float32

__all__ = ['Precision', 'BF16', 'F32', 'get', 'compute_dtype_of',
           'gather_dtype_of', 'add_precision_args', 'from_args', 'apply']


@dataclasses.dataclass(frozen=True)
class Precision:
    """An immutable mixed-precision policy (see the module docstring).

    ``compute_dtype`` is ``None`` for float32 compute; ``gather_dtype`` is
    the name of the dtype blocked message tables travel in (``None``:
    float32)."""
    name: str
    compute_dtype: Optional[torch.dtype]
    gather_dtype: Optional[str]

    def __repr__(self):
        return f'Precision({self.name!r})'


F32 = Precision('f32', None, None)
BF16 = Precision('bf16', torch.bfloat16, 'bfloat16')


def get(spec):
    """``spec`` as a :class:`Precision`: a policy (returned as it is),
    ``'bf16'`` / ``'f32'`` (and their long names), ``None`` (float32) or
    a torch dtype."""
    if isinstance(spec, Precision):
        return spec
    if spec is None:
        return F32
    if isinstance(spec, str):
        name = spec.lower()
        if name in ('bf16', 'bfloat16'):
            return BF16
        if name in ('f32', 'fp32', 'float32'):
            return F32
        raise ValueError(f'unknown precision policy {spec!r} '
                         f"(expected 'bf16' or 'f32')")
    if spec == torch.float32:
        return F32
    if spec == torch.bfloat16:
        return BF16
    raise ValueError(f'no precision policy computes in {spec}')


def compute_dtype_of(spec):
    """The compute dtype a module casts its activations and weights to
    (``None`` for float32), from a policy, a policy name or a dtype."""
    if spec is None:
        return None
    if isinstance(spec, torch.dtype):
        return None if spec == torch.float32 else spec
    return get(spec).compute_dtype


def gather_dtype_of(spec):
    """The blocked aggregation's gather dtype name for ``spec``: a policy,
    a policy name, a torch dtype, or a dtype name such as
    ``'bfloat16'`` (returned as it is); ``None`` for float32 rows."""
    if spec is None:
        return None
    if isinstance(spec, Precision):
        return spec.gather_dtype
    if isinstance(spec, str) and spec not in ('bf16', 'f32', 'fp32',
                                              'float32'):
        return spec
    return get(spec).gather_dtype


def add_precision_args(parser):
    """The shared flags: ``--precision {bf16,f32}`` (default bf16),
    ``--f32`` (the opt-out) and ``--bf16`` (an alias of the default)."""
    group = parser.add_argument_group('precision policy')
    group.add_argument('--precision', choices=['bf16', 'f32'],
                       default='bf16',
                       help='compute policy: bf16 products with float32 '
                            'accumulation (default) or float32 throughout')
    group.add_argument('--f32', dest='precision', action='store_const',
                       const='f32',
                       help='opt out of the bf16 default '
                            '(= --precision f32)')
    group.add_argument('--bf16', dest='precision', action='store_const',
                       const='bf16', help='alias of the bf16 default')
    return parser


def from_args(args):
    """The :class:`Precision` that :func:`add_precision_args` selected."""
    return get(getattr(args, 'precision', None) or 'f32')


def apply(spec):
    """Select, for this process's run, the card libraries' settings that
    the policy's float32 accumulation needs, and return the policy.

    - cuBLAS may reduce a bf16 product in bf16 unless told otherwise
      (``allow_bf16_reduced_precision_reduction`` is true by default in
      PyTorch): that would break the "f32 accumulation" contract of every
      bf16 product outside the port's own kernels (the backbones'
      ``x @ W``). It is switched off.
    - No TF32 in float32 products or cuDNN: float32 stays float32.

    The entry points call this where they set up a run; importing the
    package changes none of it."""
    policy = get(spec)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    set_exact_float32()
    return policy
