"""Train state: the Adam optimizer over a model's parameters and a step
counter.

Adam with optax's defaults (``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``,
``eps_root = 0``), the optimizer every experiment of the JAX package
uses: ``torch.optim.Adam`` computes the same update,
``lr * m_hat / (sqrt(v_hat) + eps)``, once every parameter takes part in
every step, as :func:`apply_gradients` sees to. Unlike the JAX package's
immutable pytree, the state is updated in place by each step.

On the card the optimizer is built ``capturable``: its step counts live
on the device and its bias correction is float32 arithmetic there, as
optax's is, so that a CUDA graph can record the update
(:mod:`~dgmc_tpu_torch.train.compiled`); the eager step on the card uses
the same optimizer, so the two compare bit for bit. torch refuses
``capturable`` for CPU tensors, so the CPU keeps the plain one.

:class:`GuardedTrainState` adds the non-finite guard's counters
(``make_train_step(guard=True)``), 0-d int32 tensors on the
parameters' device that the step updates in place; the host reads them
at print and eval boundaries only. :func:`snapshot_params` and
:func:`restore_params` are the willow protocol's reset (the JAX
package's ``train/checkpoint.py``): parameters and buffers come back, the
optimizer starts afresh. Every restore of a state writes in place,
since a captured graph reads that storage: :func:`write_state` is the
one writer.
"""

import dataclasses

import torch

__all__ = ['TrainState', 'GuardedTrainState', 'create_train_state',
           'with_guard_counters', 'fill_grads', 'optimizer_update',
           'apply_gradients', 'write_state', 'save_in_place',
           'snapshot', 'snapshot_params', 'restore_params']


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class GuardedTrainState(TrainState):
    """A :class:`TrainState` with the non-finite guard's ledger: how many
    optimizer updates were skipped for a non-finite loss or gradient
    (``skip_count``) and how many of those are consecutive now
    (``consec_bad``, the rollback's trigger,
    :class:`~dgmc_tpu_torch.resilience.guard.RollbackGuard`)."""
    skip_count: torch.Tensor = None
    consec_bad: torch.Tensor = None


def _params(state):
    return [p for g in state.optimizer.param_groups for p in g['params']]


def with_guard_counters(state):
    """``state`` as a :class:`GuardedTrainState`, its counters 0-d int32
    zeros on the parameters' device."""
    dev = _params(state)[0].device
    return GuardedTrainState(
        optimizer=state.optimizer, step=state.step,
        skip_count=torch.zeros((), dtype=torch.int32, device=dev),
        consec_bad=torch.zeros((), dtype=torch.int32, device=dev))


def create_train_state(model, learning_rate=1e-3):
    """A :class:`TrainState` over ``model``'s parameters with plain Adam
    at ``learning_rate`` (``capturable`` where the parameters lie on the
    card)."""
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8,
                           capturable=all(p.is_cuda for p in params))
    return TrainState(optimizer=opt)


def fill_grads(state):
    """Give every parameter without a ``.grad`` a zero one (see
    :func:`optimizer_update`)."""
    for p in _params(state):
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def optimizer_update(state):
    """One Adam update of the state's parameters from their ``.grad``, as
    optax updates them: every parameter every step, one step count for
    all. A parameter without a gradient this step (ψ₂ and
    the consensus MLP through DBP15K's phase 1, ψ₁ through phase 2) takes
    a zero one: optax's update for it, its moments decaying (and a
    parameter with moments still moving), where ``torch.optim.Adam``
    would skip it and count its steps apart (another bias correction
    once it takes part). Leaves the host's ``state.step`` alone: this is
    the part of a step a CUDA graph records."""
    fill_grads(state)
    state.optimizer.step()


def apply_gradients(state):
    """:func:`optimizer_update`, then ``state.step += 1``."""
    optimizer_update(state)
    state.step += 1


def _counters(state):
    """A guarded state's counters by name (none for a plain state)."""
    return {k: getattr(state, k) for k in ('skip_count', 'consec_bad')
            if getattr(state, k, None) is not None}


def _adam_tensor(group, p, name, value):
    """Adam's tensor ``name`` of parameter ``p`` from ``value``, made as
    Adam makes it: the step count in float32, on the device under
    ``capturable`` (else on the host), a moment in the parameter's device
    and dtype."""
    if name == 'step':
        return value.to(p.device if group.get('capturable') else 'cpu',
                        torch.float32, copy=True)
    return value.to(p.device, p.dtype, copy=True)


def write_state(state, model, model_sd, adam=None, counters=None,
                pick=None):
    """Write a train state in place: the one writer behind a capture's
    warm-up restore, the guard's select of a bad step, the willow reset
    and a checkpoint's restore. Each tensor takes ``pick(tensor, new)``
    (default ``new``) by ``copy_``, so it keeps its storage, which a
    captured graph reads.

    - ``model_sd``: a ``state_dict`` of ``model`` (parameters and
      buffers) with every name and shape; else a ``KeyError`` or
      ``ValueError`` before anything is written.
    - ``adam``: Adam's state as an optimizer ``state_dict`` holds it,
      ``{parameter index: {name: tensor}}``; ``None`` is Adam's fresh
      state. One rule for what does not match: an Adam tensor without a
      value in ``adam`` is written zeros (a zeroed state takes the same
      next update as none), and a value whose tensor Adam has not made
      yet is made as Adam would make it.
    - ``counters``: a guarded state's ``skip_count`` and ``consec_bad``;
      ``None`` leaves them.

    ``state`` ``None`` writes the model alone."""
    pick = pick or (lambda _tensor, new: new)
    current = model.state_dict()
    if set(model_sd) != set(current):
        raise KeyError(f'state_dict keys differ: missing '
                       f'{sorted(set(current) - set(model_sd))}, unexpected '
                       f'{sorted(set(model_sd) - set(current))}')
    for k, t in current.items():
        if model_sd[k].shape != t.shape:
            raise ValueError(f'{k}: shape {tuple(model_sd[k].shape)} where '
                             f'the model has {tuple(t.shape)}')
    with torch.no_grad():
        for k, t in current.items():
            t.copy_(pick(t, model_sd[k]))
        if state is None:
            return
        opt, adam = state.optimizer, adam or {}
        i = 0
        for group in opt.param_groups:
            for p in group['params']:
                st, new = opt.state[p], adam.get(i, {})
                for k, v in st.items():
                    if torch.is_tensor(v):
                        v.copy_(pick(v, new[k] if k in new
                                     else torch.zeros_like(v)))
                for k, v in new.items():
                    if k not in st:
                        st[k] = _adam_tensor(group, p, k, v)
                if not st:
                    del opt.state[p]
                i += 1
        if counters is not None:
            for k, t in _counters(state).items():
                t.copy_(pick(t, counters[k]))


def _cloned(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()
            if torch.is_tensor(v)}


def save_in_place(state, model):
    """Save what a training step changes in place (``model``'s parameters
    and buffers, batch norm's running averages among them, Adam's moments
    and step counts, and a guarded state's counters) and return
    ``write_back(pick)``, which writes them back through
    :func:`write_state` with ``pick``: an Adam tensor made since the save
    (Adam makes them at its first step) takes zeros, Adam's fresh
    state."""
    opt = state.optimizer
    model_sd = _cloned(model.state_dict())
    adam = {i: _cloned(opt.state[p]) for i, p in enumerate(_params(state))
            if p in opt.state}
    counters = _cloned(_counters(state))

    def write_back(pick):
        write_state(state, model, model_sd, adam, counters, pick)

    return write_back


def snapshot(state, model):
    """:func:`save_in_place` and the host's step count; returns
    ``restore()``, which writes them back. What a capture's warm-up runs
    use, so that the captured run starts from the state the eager one
    would."""
    write_back = save_in_place(state, model)
    step = state.step

    def restore():
        write_back(lambda _tensor, saved: saved)
        state.step = step

    return restore


def snapshot_params(model):
    """An in-memory copy of ``model``'s parameters and buffers (its
    ``state_dict``, cloned): the willow protocol's snapshot and the
    rollback guard's last good state."""
    return _cloned(model.state_dict())


def restore_params(state, model, snapshot):
    """Roll ``model`` back to ``snapshot`` with a fresh optimizer (the
    willow protocol's per-run reset) through :func:`write_state`: the
    parameters and buffers are copied in place (every name and shape
    must match), Adam's moments and step counts are zeroed in place, and
    ``state.step`` goes back to 0. The snapshot stays intact for the next
    restore. Returns ``state``."""
    write_state(state, model, snapshot)
    state.step = 0
    return state
