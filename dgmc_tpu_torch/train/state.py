"""Train state: the Adam optimizer over a model's parameters and a step
counter.

Adam with optax's defaults (``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``,
``eps_root = 0``), the optimizer every experiment of the JAX package
uses: ``torch.optim.Adam`` computes the same update,
``lr * m_hat / (sqrt(v_hat) + eps)``. Unlike the JAX package's
immutable pytree, the state is updated in place by each step.
"""

import dataclasses

import torch

__all__ = ['TrainState', 'create_train_state']


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
