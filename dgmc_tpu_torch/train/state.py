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
"""

import dataclasses

import torch

__all__ = ['TrainState', 'create_train_state', 'optimizer_update',
           'apply_gradients', 'snapshot']


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model, learning_rate=1e-3):
    """A :class:`TrainState` over ``model``'s parameters with plain Adam
    at ``learning_rate`` (``capturable`` where the parameters lie on the
    card)."""
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8,
                           capturable=all(p.is_cuda for p in params))
    return TrainState(optimizer=opt)


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
    for group in state.optimizer.param_groups:
        for p in group['params']:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()


def apply_gradients(state):
    """:func:`optimizer_update`, then ``state.step += 1``."""
    optimizer_update(state)
    state.step += 1


def snapshot(state, model=None):
    """Save the state's parameters, optimizer moments and step counts
    (and ``model``'s buffers: batch norm's running averages, which a
    training step updates too) and return ``restore()``, which writes
    them back in place (the tensors keep their storage, which a captured
    graph reads). Moments that did not exist yet (Adam creates them at
    its first step) are reset to zeros, Adam's fresh state. What a
    capture's warm-up runs use, so that the captured run starts from the
    state the eager one would."""
    opt = state.optimizer
    tensors = [p for g in opt.param_groups for p in g['params']]
    tensors += [] if model is None else list(model.buffers())
    saved = [t.detach().clone() for t in tensors]
    moments = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
               for p, st in opt.state.items()}
    step = state.step

    def restore():
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
            for p, st in opt.state.items():
                old = moments.get(p)
                for k, v in st.items():
                    if not torch.is_tensor(v):
                        continue
                    if old is None:
                        v.zero_()
                    else:
                        v.copy_(old[k])
        state.step = step

    return restore
