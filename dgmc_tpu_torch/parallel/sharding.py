"""Sharded training: data-parallel and row-sharded train and eval steps.

JAX compiles its step over a mesh and GSPMD inserts the collectives. In
the port each rank runs the port's own step
(:func:`~dgmc_tpu_torch.train.steps.make_train_step`,
:func:`~dgmc_tpu_torch.train.steps.make_eval_step`) on its part of the
work, and the sums across ranks are written out (:class:`StepComm`):

- **Data parallelism** (``batch_axis``): each rank takes its slice of the
  pair batch (:func:`shard_batch`); its pairs draw their indicator noise
  and negatives at their place in the whole batch, and the dropout masks
  are the whole batch's cut to the slice
  (:class:`~dgmc_tpu_torch.models.rel.BatchBlock`); batch norm's masked
  sums, sums of squares and counts are summed over the data group (the
  model's batch norms carry it,
  :func:`~dgmc_tpu_torch.models.norm.sync_batch_stats`), so its
  statistics and running averages are the global batch's.
- **Row sharding** (a model carrying a row layout,
  :meth:`~dgmc_tpu_torch.parallel.rules.PartitionRules.apply_to_model`):
  each rank owns a block of the correspondence rows; the model sums each
  consensus step's ``r_t`` over the row group itself. With ψ₁'s tables
  sharded (the ``'psi1'`` / ``'corpus'`` rules) each rank's ψ₁
  computes its rows only, so its gradient of ψ₁'s parameters is its
  rows' part, the all-gathers' backward having handed each rank the
  gradient of its rows from every rank: the one sum over the mesh below
  adds each row's part once.
- Either way the loss is each rank's part, normalized by the count summed
  over the mesh; the gradients of the replicated parameters are summed
  over the mesh before Adam, so one update equals the one-process step on
  the whole batch (up to the order of the float sums); the metrics are
  sums and counts reduced over the mesh.

``jit=True`` (the default, as in the one-process builders) captures the
step on the card with its collectives inside the CUDA graph where the
backend allows it (NCCL); under gloo the step runs eagerly, recorded in
the dispatch ledger as ``sharded_step`` ``eager`` with the reason
``backend=gloo``. The CPU runs the static-buffer code eagerly in either
case.

JAX's ``_gspmd_safe`` / ``_reject_explicit_fused`` have no counterpart:
each rank runs local code, as JAX's ``shard_map`` regions do, so its
kernels stay on.
"""

import torch

from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.models.norm import sync_batch_stats
from dgmc_tpu_torch.models.rel import BatchBlock
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.parallel.comm import (all_gather, all_reduce_,
                                          backend_of, broadcast_)
from dgmc_tpu_torch.parallel.distributed import cut, tree_map
from dgmc_tpu_torch.parallel.mesh import DATA_AXIS
from dgmc_tpu_torch.train import steps as _steps

__all__ = ['replicate', 'shard_batch', 'StepComm',
           'make_sharded_train_step', 'make_sharded_eval_step']


def _state_tensors(state, model=None):
    """The tensors a replicated train state holds: parameters, Adam's
    moments and counts, the guard counters and, with ``model``, its
    buffers."""
    out = [p for g in state.optimizer.param_groups for p in g['params']]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    out += [getattr(state, k) for k in ('skip_count', 'consec_bad')
            if getattr(state, k, None) is not None]
    if model is not None:
        out += list(model.buffers())
    return out


def replicate(tree, mesh, model=None):
    """Every leaf replicated over the mesh. A train state stays where it
    lies (its parameters on this rank's device) and its tensors (and
    ``model``'s buffers) are overwritten in place with the mesh's first
    rank's; a batch is placed whole on this rank's device; any other tree
    is moved there leaf by leaf."""
    from dgmc_tpu_torch.train.state import TrainState
    if isinstance(tree, TrainState):
        group = mesh.group()
        with torch.no_grad():
            for t in _state_tensors(tree, model):
                broadcast_(t, group)
        return tree
    if isinstance(tree, (_steps.DeviceBatch,)) or hasattr(tree, 'y_mask'):
        return _steps.batch_to_device(tree, mesh.device)
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def _batch_slice(batch, parts, index):
    if parts == 1:
        return batch
    if isinstance(batch, _steps.DeviceBatch):
        return _steps.DeviceBatch(
            *(g._mapped(lambda t: cut(t, parts, index))
              if hasattr(g, '_mapped') else cut(g, parts, index)
              for g in batch))
    return tree_map(lambda x: cut(x, parts, index), batch)


def shard_batch(batch, mesh, axis=DATA_AXIS):
    """This rank's block of ``batch``'s leading axis over ``axis`` (whole
    for ``None``), on its device."""
    batch = _batch_slice(batch, mesh.axis_size(axis), mesh.axis_index(axis))
    return _steps.batch_to_device(batch, mesh.device)


class StepComm:
    """The cross-rank reductions of a sharded step over ``mesh``:
    ``batch_axis`` (data parallelism, or ``None``) and the model's row
    layout. Gives ``model``'s batch norms the data group
    (:func:`~dgmc_tpu_torch.models.norm.sync_batch_stats`)."""

    def __init__(self, mesh, batch_axis, model):
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.group = mesh.group()
        self.data_group = (mesh.group(batch_axis)
                           if mesh.axis_size(batch_axis) > 1 else None)
        layout = getattr(model, 'row_layout', lambda: None)()
        self.row_group = None if layout is None else layout.group
        self.model = sync_batch_stats(model, self.data_group)

    def pair_offset(self, batch):
        """The first pair of this rank's slice in the per-pair random
        streams, so that its pairs draw what they draw in one process."""
        if self.data_group is None:
            return 0
        return self.mesh.axis_index(self.batch_axis) * batch.y.shape[0]

    def draws(self, generator):
        """The dropout masks' source for this rank's slice of the batch:
        ``generator`` drawing the whole batch's masks, cut to the slice
        (:class:`~dgmc_tpu_torch.models.rel.BatchBlock`); ``generator``
        itself without data parallelism."""
        if self.data_group is None or generator is None:
            return generator
        return BatchBlock(generator, self.mesh.axis_size(self.batch_axis),
                          self.mesh.axis_index(self.batch_axis))

    def local(self, x):
        """This rank's rows of a ``[B, N_s, ...]`` tensor (the model's row
        block; all of it without a row layout)."""
        layout = self.model.row_layout()
        return x if layout is None else layout.take(x)

    def total(self, x):
        """``x`` summed over the mesh (not differentiable)."""
        return all_reduce_(x.detach().clone(), self.group)

    def nll(self, S, y, y_mask):
        """This rank's part of the mean NLL: its sum over the global
        count."""
        total, count = metrics.nll_terms(S, y, y_mask)
        return total / self.total(count).clamp(min=1)

    def grads(self, state):
        """Sum the gradients over the mesh (one flat buffer)."""
        grads = [p.grad for g in state.optimizer.param_groups
                 for p in g['params'] if p.grad is not None]
        flat = self.sum_grads(grads)
        if flat is None:
            return
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def sum_grads(self, grads):
        """``grads`` flattened into one buffer summed over the mesh (None
        without a mesh or a gradient)."""
        if self.group is None or not grads:
            return None
        return all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                           self.group)

    def metrics(self, loss, S_L, y, y_mask, hits_ks):
        """A train step's metrics over the mesh: ``loss`` (summed over the
        mesh already), the per-pair NLL with its sums over the rows and
        the pairs gathered over the data group, accuracy and Hits@k as
        global rates."""
        total, count = metrics.nll_terms(S_L, y, y_mask, per_pair=True)
        pair = torch.stack([total, count.to(total.dtype)])
        if self.row_group is not None:
            all_reduce_(pair, self.row_group)
        per_pair = pair[0] / pair[1].clamp(min=1)
        if self.data_group is not None:
            per_pair = all_gather(per_pair, self.data_group)
        n = self.total(y_mask.sum()).clamp(min=1)
        out = {'loss': loss,
               'loss_per_pair': per_pair,
               'acc': self.total(metrics.acc(S_L, y, y_mask,
                                             reduction='sum')) / n}
        for k in hits_ks:
            out[f'hits@{k}'] = self.total(metrics.hits_at_k(
                k, S_L, y, y_mask, reduction='sum')) / n
        return out

    def eval_sums(self, out):
        """An eval step's sums over the mesh."""
        return {k: self.total(v) for k, v in out.items()}


def _resolve(model, mesh, rules, batch_axis, state):
    """The model and batch axis of ``rules`` (``model`` and ``batch_axis``
    without); ``state``, JAX's example state, is checked against the
    rules' state rules (:meth:`~dgmc_tpu_torch.parallel.rules.
    PartitionRules.check_state`)."""
    if rules is not None:
        if state is not None:
            rules.check_state(state, model)
        model = rules.apply_to_model(model, mesh)
        batch_axis = rules.batch[0] if rules.batch else None
    return model, batch_axis


def _jit_for(mesh, jit):
    """Whether the step is captured: on the card only where the backend
    captures collectives (NCCL); recorded in the dispatch ledger."""
    if not jit:
        return False
    backend = backend_of(mesh.group())
    if mesh.device.type == 'cuda':
        if backend == 'gloo':
            dispatch.record('sharded_step', 'eager', 'backend=gloo')
            return False
        dispatch.record('sharded_step', 'captured',
                        f'backend={backend or "none"}')
    return True


def make_sharded_train_step(model, mesh, loss_on_s0=False, num_steps=None,
                            detach=None, hits_ks=(), batch_axis=DATA_AXIS,
                            rules=None, state=None, guard=False,
                            fault_nan_step=None, jit=True):
    """A train step over ``mesh``: the contract of
    :func:`~dgmc_tpu_torch.train.steps.make_train_step`, called with the
    state replicated (:func:`replicate`) and this rank's batch
    (:func:`shard_batch`, or whole where ``batch_axis`` is ``None``); with
    ``rules`` (a :class:`~dgmc_tpu_torch.parallel.rules.PartitionRules`)
    the model takes the config's row layout and knobs and the batch its
    rule, and ``state`` (JAX's example state for the rules) is checked
    against the rules: the port's train state is replicated, so a rule
    that shards a leaf of it raises. The metrics are the mesh's."""
    model, batch_axis = _resolve(model, mesh, rules, batch_axis, state)
    comm = StepComm(mesh, batch_axis, model)
    return _steps.make_train_step(
        model, loss_on_s0=loss_on_s0, num_steps=num_steps,
        detach=bool(detach), hits_ks=hits_ks, jit=_jit_for(mesh, jit),
        guard=guard, fault_nan_step=fault_nan_step, comm=comm)


def make_sharded_eval_step(model, mesh, hits_ks=(1,), num_steps=None,
                           detach=None, batch_axis=DATA_AXIS, rules=None,
                           state=None, jit=True):
    """An eval step over ``mesh``: ``step(batch, noise_seed, r_s=None)``
    with ``count``, ``correct`` and ``hits@k`` summed over the mesh;
    ``rules`` and ``state`` as for :func:`make_sharded_train_step`."""
    model, batch_axis = _resolve(model, mesh, rules, batch_axis, state)
    comm = StepComm(mesh, batch_axis, model)
    return _steps.make_eval_step(model, hits_ks=hits_ks,
                                 num_steps=num_steps, detach=detach,
                                 jit=_jit_for(mesh, jit), comm=comm)
