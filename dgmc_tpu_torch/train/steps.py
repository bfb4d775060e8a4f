"""Train and eval steps.

``make_train_step(model, loss_on_s0=...)`` returns
``step(state, batch, noise_seed, r_s=None) -> (state, metrics)``: one
forward on the padded :class:`~dgmc_tpu_torch.utils.data.PairBatch`, the
NLL of ``S_L`` (plus that of ``S_0`` with ``loss_on_s0``, as the keypoint
experiments train), its backward and one Adam update, in place. The
indicator noise is the step's one explicit random source: drawn by
:func:`~dgmc_tpu_torch.models.dgmc.draw_noise` from ``noise_seed``, or
given as ``r_s [num_steps, B, N_s, R_in]``.

``make_eval_step`` returns ``step(batch, noise_seed, r_s=None)`` with
``count``, ``correct`` and ``hits@k`` as sums, so callers aggregate
across batches exactly.
"""

import torch

from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.ops.graph import GraphBatch

__all__ = ['batch_to_device', 'loss_and_outputs', 'make_train_step',
           'make_eval_step']


def _device_of(model):
    return next(model.parameters()).device


def batch_to_device(batch, device):
    """``(graph_s, graph_t, y, y_mask)`` on ``device`` from a host
    :class:`~dgmc_tpu_torch.utils.data.PairBatch`."""
    return (GraphBatch.from_numpy(batch.s, device),
            GraphBatch.from_numpy(batch.t, device),
            torch.as_tensor(batch.y).to(device=device, dtype=torch.int64),
            torch.as_tensor(batch.y_mask).to(device=device))


def loss_and_outputs(model, batch, loss_on_s0=False, noise_seed=0,
                     r_s=None):
    """``(loss, S_0, S_L, y, y_mask)`` of one forward in the model's
    current mode, with the graph on the model's device."""
    g_s, g_t, y, y_mask = batch_to_device(batch, _device_of(model))
    S_0, S_L = model(g_s, g_t, noise_seed=noise_seed, r_s=r_s)
    loss = metrics.nll_loss(S_L, y, y_mask)
    if loss_on_s0:
        loss = loss + metrics.nll_loss(S_0, y, y_mask)
    return loss, S_0, S_L, y, y_mask


def make_train_step(model, loss_on_s0=False):
    """Build ``step(state, batch, noise_seed, r_s=None)`` for ``model``,
    whose parameters ``state``'s optimizer updates. The metrics are
    ``loss`` (the scalar trained on), ``loss_per_pair`` ``[B]`` and
    ``acc`` (device tensors)."""

    def train_step(state, batch, noise_seed, r_s=None):
        model.train()
        loss, _, S_L, y, y_mask = loss_and_outputs(model, batch, loss_on_s0,
                                                   noise_seed, r_s)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            out = {'loss': loss.detach(),
                   'loss_per_pair': metrics.nll_loss(
                       S_L, y, y_mask, reduction='per_pair'),
                   'acc': metrics.acc(S_L, y, y_mask)}
        return state, out

    return train_step


def make_eval_step(model, hits_ks=(1,)):
    """Build ``step(batch, noise_seed, r_s=None) -> metrics`` with
    ``count``, ``correct`` and ``hits@k`` summed over the batch. The
    consensus steps draw indicator noise at eval time too."""

    def eval_step(batch, noise_seed, r_s=None):
        model.eval()
        with torch.no_grad():
            _, _, S_L, y, y_mask = loss_and_outputs(model, batch, False,
                                                    noise_seed, r_s)
            out = {'count': y_mask.sum(),
                   'correct': metrics.acc(S_L, y, y_mask, reduction='sum')}
            for k in hits_ks:
                out[f'hits@{k}'] = metrics.hits_at_k(k, S_L, y, y_mask,
                                                     reduction='sum')
        return out

    return eval_step
