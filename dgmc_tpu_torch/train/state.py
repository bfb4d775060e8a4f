"""Train state: the Adam optimizer over a model's parameters and a step
counter.

Adam with optax's defaults (``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``,
``eps_root = 0``), the optimizer every experiment of the JAX package
uses: ``torch.optim.Adam`` computes the same update,
``lr * m_hat / (sqrt(v_hat) + eps)``, once every parameter takes part in
every step, as :func:`apply_gradients` sees to. Unlike the JAX package's
immutable pytree, the state is updated in place by each step.
"""

import dataclasses

import torch

__all__ = ['TrainState', 'create_train_state', 'apply_gradients']


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model, learning_rate=1e-3):
    """A :class:`TrainState` over ``model``'s parameters with plain Adam
    at ``learning_rate``."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(optimizer=opt)


def apply_gradients(state):
    """One Adam update of the state's parameters from their ``.grad``, as
    optax updates them: every parameter every step, one step count for
    all. A parameter without a gradient this step (ψ₂ and
    the consensus MLP through DBP15K's phase 1, ψ₁ through phase 2) takes
    a zero one: optax's update for it, its moments decaying (and a
    parameter with moments still moving), where ``torch.optim.Adam``
    would skip it and count its steps apart (another bias correction
    once it takes part)."""
    for group in state.optimizer.param_groups:
        for p in group['params']:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
