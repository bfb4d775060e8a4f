"""The ``(data, model)`` mesh over the world's ranks.

The JAX package's mesh is a grid of devices with a ``data`` axis (the
pair batch ``B``) and a ``model`` axis (the correspondence rows ``N_s``),
over which GSPMD places arrays. In the port a mesh is a grid of ranks,
one card each, the model axis the inner one, with a process group for
each line along each axis (and one over the whole mesh): the groups the
sharded paths sum and gather over. Every rank creates every group, as
``torch.distributed.new_group`` requires.

A spec is a tuple of axis names (or ``None``) per dimension, as
``PartitionSpec`` is: ``()`` replicated, ``('data',)`` the leading axis
over ``data``. A :class:`NamedSharding` pairs a spec with its mesh.

Without a process group (one process) every group is ``None``: the
collectives are no-ops, so the sharded code runs unchanged.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch.distributed as dist

from dgmc_tpu_torch.parallel.distributed import process_index, rank_device

__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'Mesh', 'PartitionSpec',
           'NamedSharding', 'make_mesh', 'batch_spec', 'corr_spec',
           'corr_sharding']

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


class Mesh:
    """A ``(data, model)`` grid of ranks (``ranks [data, model]``) with
    this rank's process group along each axis and over the whole mesh,
    and this rank's ``device``."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, ranks, groups, device):
        self.ranks = np.asarray(ranks)
        self._groups = groups
        self.device = device
        self.shape = dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self):
        return int(self.ranks.size)

    def _axes(self, axis):
        if axis is None:
            return ()
        return axis if isinstance(axis, tuple) else (axis,)

    def axis_size(self, axis):
        """The ranks along ``axis`` (a name, a tuple of names or
        ``None``: 1)."""
        out = 1
        for a in self._axes(axis):
            out *= self.shape[a]
        return out

    def coords(self):
        """This rank's ``(data, model)`` position (``(0, 0)`` for a rank
        outside a process group)."""
        hit = np.argwhere(self.ranks == process_index())
        if not len(hit):
            raise ValueError(f'rank {process_index()} is not in this mesh '
                             f'({self.ranks.tolist()})')
        return tuple(int(c) for c in hit[0])

    def axis_index(self, axis):
        """This rank's index along ``axis`` (row-major over a tuple)."""
        coords = dict(zip(self.axis_names, self.coords()))
        out = 0
        for a in self._axes(axis):
            out = out * self.shape[a] + coords[a]
        return out

    def group(self, axis=None):
        """This rank's process group along ``axis`` (a name, or a tuple
        naming both axes), or over the whole mesh for ``None``; ``None``
        without a process group."""
        axes = self._axes(axis)
        if len(axes) == 2 or axis is None:
            return self._groups.get('mesh')
        return self._groups.get(axes[0])


class PartitionSpec(tuple):
    """A spec: a tuple of axis names (or ``None``) per dimension, equal to
    the plain tuple of its axes (``PartitionSpec('data') == ('data',)``);
    a leaf in a tree of specs."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f'PartitionSpec{tuple(self)!r}'


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``)."""
    mesh: Mesh
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, 'spec', PartitionSpec(*self.spec))

    def axis(self, dim):
        """The axis of dimension ``dim`` (``None`` where replicated)."""
        return self.spec[dim] if dim < len(self.spec) else None


def make_mesh(data: Optional[int] = None, model: int = 1, ranks=None,
              device=None) -> Mesh:
    """A ``(data, model)`` mesh over ``ranks`` (default: the world's).

    ``data=None`` takes every rank not claimed by ``model``. ``device`` is
    this rank's (default :func:`~dgmc_tpu_torch.parallel.distributed.
    rank_device`). Every rank of the world calls this with the same
    arguments (the process groups are collective to create)."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f'{n} ranks not divisible by model={model}')
        data = n // model
    if data * model != n:
        raise ValueError(f'mesh {data}x{model} != {n} ranks')
    grid = np.asarray(ranks).reshape(data, model)
    groups = {}
    if world > 1 or (dist.is_available() and dist.is_initialized()):
        me = dist.get_rank()
        lines = {DATA_AXIS: [grid[:, j].tolist() for j in range(model)],
                 MODEL_AXIS: [grid[i].tolist() for i in range(data)],
                 'mesh': [ranks]}
        for axis, members in lines.items():
            for line in members:
                g = dist.new_group(line)
                if me in line:
                    groups[axis] = g
    return Mesh(grid, groups, rank_device(device))


def batch_spec():
    """The spec of a leading pair-batch axis over ``data``."""
    return PartitionSpec(DATA_AXIS)


def corr_spec():
    """The spec of correspondence-shaped arrays ``[B, N_s, ...]``: batch
    over ``data``, source rows over ``model``."""
    return PartitionSpec(DATA_AXIS, MODEL_AXIS)


def corr_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, corr_spec())
