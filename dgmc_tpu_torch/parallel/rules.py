"""Partition rules: declarative regex → spec sharding config.

The JAX package's config object (``dgmc_tpu/parallel/rules.py``): an
ordered list of ``(regex, spec)`` rules matched against the ``/``-joined
path of every leaf of the train state, and named activation rules for
the arrays that dominate memory at DBP15K scale and beyond:

- ``'corr'``: the correspondence ``S`` (``S_hat``, ``S_0``, ``S_L``,
  dense ``[B, N_s, N_t]`` or sparse ``[B, N_s, K]``);
- ``'topk'``: the shortlist ``S_idx [B, N_s, K]`` (``'corr'``'s rule
  where it has none);
- ``'psi2'``: ψ₂'s source-row intermediates (``r_s``, ``o_s``);
- ``'psi1'`` / ``'corpus'`` (JAX's opt-in ψ₁ tables, off in every
  builder): ψ₁'s source table ``h_s`` / target table ``h_t``, each rank
  computing and holding its row block (the correspondence rows' axis),
  the target ring passing the ``h_t`` shards rank to rank.

The port's train state is no pytree: :func:`state_tree` presents it as
one, with JAX's leaf paths (``params/psi_1/conv_0/lin1/kernel``,
``opt_state/0/mu/...``, ``opt_state/0/nu/...``, ``opt_state/0/count``,
``batch_stats/...``, ``step``, ``skip_count``, ``consec_bad``; the names
of :func:`~dgmc_tpu_torch.convert.flax_names`, a ``Linear`` weight as its
``[in, out]`` transpose), so the same regexes match the same leaves.

Matching (``tests/parallel/test_rules.py``'s semantics): the first
matching rule wins; a scalar leaf (rank 0 or one element) gets ``()``
without a rule; a non-scalar leaf no rule matches raises, naming its
path.

The port's train state is replicated on every rank (ψ₁, where its
tables are sharded, computes its rows on each rank with the same
parameters): :meth:`PartitionRules.place` refuses a state rule that
shards a leaf. :func:`shard_tree` places any tree (each leaf this rank's
block of its spec). :meth:`PartitionRules.apply_to_model` gives the model
the row layout (:meth:`~dgmc_tpu_torch.models.dgmc.DGMC.with_layout`)
and the search's knobs.
"""

import dataclasses
import re
from typing import Mapping, Optional, Tuple

import torch

from dgmc_tpu_torch.ops.topk import DEFAULT_STREAM_CHUNK, DEFAULT_TOPK_BLOCK
from dgmc_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                          NamedSharding, PartitionSpec)

__all__ = ['DEFAULT_TOPK_BLOCK', 'DEFAULT_STREAM_CHUNK', 'leaf_paths',
           'state_tree', 'match_partition_rules', 'tree_shardings',
           'shard_tree', 'PartitionRules', 'replicated_rules',
           'corr_row_rules', 'streamed_rules']


def _items(tree):
    if isinstance(tree, PartitionSpec):
        return None
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaf_paths(tree, prefix=''):
    """``[(path, leaf)]`` of a nested dict / list / tuple tree, paths
    ``/``-joined."""
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaf_paths(v, f'{prefix}/{k}' if prefix else str(k))
    return out


def _map_paths(fn, tree, prefix=''):
    items = _items(tree)
    if items is None:
        return fn(prefix, tree)
    mapped = {k: _map_paths(fn, v, f'{prefix}/{k}' if prefix else str(k))
              for k, v in items}
    if isinstance(tree, dict):
        return mapped
    return type(tree)(mapped[i] for i in range(len(tree)))


def _nest(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        *scopes, name = path.split('/')
        for s in scopes:
            node = node.setdefault(s, {})
        node[name] = leaf
    return out


def state_tree(state, model):
    """The train state as JAX's pytree: nested dicts keyed by JAX's leaf
    paths (see the module docstring); each leaf a tensor of the state (a
    ``Linear`` weight and its moments as their ``[in, out]`` transposes,
    views of the state's storage)."""
    from dgmc_tpu_torch.convert import flax_names
    names = flax_names(model)
    flat = {'step': torch.tensor(state.step)}
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    by_param = {id(p): key for key, p in model.named_parameters()}
    for key, (collection, path, transpose) in names.items():
        t = tensors[key]
        flat[f'{collection}/{path}'] = t.T if transpose else t
    count = None
    for group in state.optimizer.param_groups:
        for p in group['params']:
            st = state.optimizer.state.get(p)
            if not st:
                continue
            _, path, transpose = names[by_param[id(p)]]
            for mom, name in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
                t = st[name]
                flat[f'opt_state/0/{mom}/{path}'] = t.T if transpose else t
            count = st['step']
    flat['opt_state/0/count'] = (torch.tensor(0, dtype=torch.int32)
                                 if count is None else count)
    for name in ('skip_count', 'consec_bad'):
        if getattr(state, name, None) is not None:
            flat[name] = getattr(state, name)
    return _nest(flat)


def _is_scalar(leaf):
    shape = tuple(getattr(leaf, 'shape', ()))
    size = 1
    for d in shape:
        size *= d
    return len(shape) == 0 or size == 1


def match_partition_rules(rules, tree):
    """A tree of specs matching ``tree``: ``rules`` is an ordered iterable
    of ``(regex, spec)``, ``re.search`` runs against each leaf's path and
    the first match wins. Scalar leaves get ``()`` without consulting the
    rules. A non-scalar leaf that no rule matches raises
    :class:`ValueError` naming its path (a final ``('.*', ())``
    replicates the rest explicitly)."""
    rules = tuple(rules)

    def spec_for(name, leaf):
        if _is_scalar(leaf):
            return PartitionSpec()
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                return PartitionSpec(*spec)
        raise ValueError(
            f'no partition rule matches leaf {name!r} (shape '
            f'{tuple(getattr(leaf, "shape", ()))}); rules tried: '
            f'{[r for r, _ in rules]!r} — append (".*", ()) to replicate '
            f'unmatched leaves explicitly')

    return _map_paths(spec_for, tree)


def tree_shardings(rules, tree, mesh):
    """:func:`match_partition_rules` as a tree of
    :class:`~dgmc_tpu_torch.parallel.mesh.NamedSharding` over ``mesh``."""
    specs = match_partition_rules(rules, tree)
    return _map_paths(lambda _, spec: NamedSharding(mesh, spec), specs)


def _block(leaf, spec, mesh):
    """This rank's block of ``leaf`` under ``spec``, on the mesh's
    device."""
    out = torch.as_tensor(leaf)
    for dim, axis in enumerate(spec):
        n = mesh.axis_size(axis)
        if axis is None or n == 1:
            continue
        size = out.shape[dim]
        if size % n:
            raise ValueError(f'dimension {dim} ({size}) not divisible by '
                             f'{n} shards of {axis!r}')
        per = size // n
        out = out.narrow(dim, mesh.axis_index(axis) * per, per)
    return out.to(mesh.device)


def shard_tree(tree, rules, mesh):
    """``tree`` with every leaf placed per its matched rule: this rank's
    block of it, on the mesh's device."""
    specs = dict(leaf_paths(match_partition_rules(rules, tree)))
    return _map_paths(lambda path, leaf: _block(leaf, specs[path], mesh),
                      tree)


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """One declarative sharding config for a training setup (JAX's
    fields).

    Args:
        state: ordered ``(regex, spec)`` rules over :func:`state_tree`.
        batch: the spec of the pair batch's leading ``B`` axis
            (``('data',)`` for data parallelism; ``None`` / ``()`` for a
            replicated single pair).
        activations: the named activation rules ``'corr'``, ``'topk'``,
            ``'psi2'`` and JAX's opt-in ``'psi1'`` / ``'corpus'`` (ψ₁'s
            tables in row blocks; on the correspondence rows' axis).
        topk_block: the plain search's target block.
        stream_chunk: stream the candidate search over source chunks of
            this many rows.
        ring_targets: rotate target shards rank to rank in the search
            (:func:`~dgmc_tpu_torch.parallel.topk.corr_sharded_topk`
            ``ring=True``).
    """
    state: Tuple[Tuple[str, tuple], ...] = (('.*', ()),)
    batch: Optional[tuple] = None
    activations: Mapping[str, tuple] = dataclasses.field(
        default_factory=dict)
    topk_block: int = DEFAULT_TOPK_BLOCK
    stream_chunk: Optional[int] = None
    ring_targets: bool = False

    def check_state(self, state, model):
        """Raise unless every state rule replicates its leaves of
        ``state`` (``model``'s train state): the port runs the whole model
        on every rank, so it cannot honour a rule that shards one."""
        specs = leaf_paths(match_partition_rules(
            self.state, state_tree(state, model)))
        sharded = [p for p, s in specs if any(a is not None for a in s)]
        if sharded:
            raise ValueError(
                f'the port runs the whole model on every rank: its '
                f'train state is replicated, and rules that shard '
                f'{sharded} are not supported')

    def place(self, state, batch, mesh, model=None):
        """``(state, batch)`` per this config: the state replicated (its
        parameters, buffers and Adam moments broadcast from the mesh's
        first rank, which ``model`` names; a rule that shards a state leaf
        raises, :meth:`check_state`), the batch this rank's block of the
        batch rule on its device
        (:func:`~dgmc_tpu_torch.parallel.sharding.shard_batch`)."""
        from dgmc_tpu_torch.parallel.sharding import replicate, shard_batch
        if model is not None:
            self.check_state(state, model)
            replicate(state, mesh, model)
        axis = self.batch[0] if self.batch else None
        return state, shard_batch(batch, mesh, axis)

    def activation_spec(self, name):
        spec = self.activations.get(name)
        if spec is None and name == 'topk':
            spec = self.activations.get('corr')
        return spec

    def activation_sharding(self, name, mesh):
        spec = self.activation_spec(name)
        return None if spec is None else NamedSharding(mesh, tuple(spec))

    def apply_to_model(self, model, mesh):
        """The model with every knob this config owns: the row layout
        (``corr``, ``topk``, ``psi2``), ψ₁'s tables (``psi1``,
        ``corpus``), the stream chunk, the ring and the search block (a
        shallow copy sharing the parameters,
        :meth:`~dgmc_tpu_torch.models.dgmc.DGMC.with_layout`)."""
        return model.with_layout(
            corr_sharding=self.activation_sharding('corr', mesh),
            topk_sharding=self.activation_sharding('topk', mesh),
            psi2_sharding=self.activation_sharding('psi2', mesh),
            psi1_sharding=self.activation_sharding('psi1', mesh),
            corpus_sharding=self.activation_sharding('corpus', mesh),
            stream_chunk=self.stream_chunk,
            ring_targets=self.ring_targets,
            topk_block=self.topk_block)


def replicated_rules(batch_axis=DATA_AXIS, **kw):
    """Data parallelism: state replicated, the pair batch over
    ``batch_axis``, no activation rules."""
    return PartitionRules(
        state=(('.*', ()),),
        batch=None if batch_axis is None else (batch_axis,), **kw)


def corr_row_rules(batch_axis=DATA_AXIS, row_axis=MODEL_AXIS, **kw):
    """The ``--model_shards`` layout: batch over ``data``, correspondence
    rows over ``model``."""
    corr = (batch_axis, row_axis)
    return PartitionRules(
        state=(('.*', ()),),
        batch=None if batch_axis is None else (batch_axis,),
        activations={'corr': corr, 'psi2': corr}, **kw)


def streamed_rules(row_axis=DATA_AXIS, stream_chunk=DEFAULT_STREAM_CHUNK,
                   **kw):
    """The ``--row_shards`` layout (JAX's million-entity config): one
    ``B = 1`` pair replicated, the correspondence rows over ``row_axis``
    (the source rows are the data), the shortlist and ψ₂'s source rows
    following, the search streamed ``stream_chunk`` rows at a time and
    the targets ringing over the same axis (``ring_targets=False`` for
    the replicated targets). JAX's defaults: ψ₁'s tables replicated; a
    caller adds ``'psi1'`` / ``'corpus'`` with ``dataclasses.replace``
    (``activations={..., 'psi1': row, 'corpus': row}``)."""
    row = (None, row_axis)
    kw.setdefault('ring_targets', True)
    return PartitionRules(
        state=(('.*', ()),), batch=None,
        activations={'corr': row, 'topk': row, 'psi2': row},
        stream_chunk=stream_chunk, **kw)
