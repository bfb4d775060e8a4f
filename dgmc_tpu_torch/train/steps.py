"""Train and eval steps.

``make_train_step(model, ...)`` returns
``step(state, batch, noise_seed, r_s=None, negatives=None) ->
(state, metrics)``: one forward in training mode on the padded batch, the
NLL of ``S_L`` (plus that of ``S_0`` with ``loss_on_s0``, as the keypoint
experiments train), its backward and one Adam update, in place. The phase
(``num_steps``, ``detach``) is fixed per step function, as the JAX
package compiles one program per phase. ``noise_seed`` is the step's one
random seed: the indicator noise and the sparse variant's negatives are
drawn from it per pair (:func:`~dgmc_tpu_torch.models.dgmc.draw_noise`,
:func:`~dgmc_tpu_torch.models.dgmc.draw_negatives`), the dropout masks
from a generator on the model's device seeded from it. ``r_s`` and
``negatives`` replace the drawn ones (tests inject JAX's).

``make_eval_step`` returns ``step(batch, noise_seed, r_s=None)`` with
``count``, ``correct`` and ``hits@k`` as sums, so callers aggregate
across batches exactly.

A batch is a host :class:`~dgmc_tpu_torch.utils.data.PairBatch`, uploaded
per call, or a :class:`DeviceBatch`: from :func:`batch_to_device`, which
a loop over one fixed pair uploads once (its graphs then also keep their
sorted edge orders and routings across steps), or from
:func:`batch_to_host`, the host part of an upload (validated CPU tensors,
pinned for the card; :class:`HostBatches`), which the step copies to the
device without blocking.
"""

from typing import NamedTuple

import numpy as np
import torch

from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.ops.graph import GraphBatch, canonical_device, host_tensor
from dgmc_tpu_torch.train.state import apply_gradients

__all__ = ['DeviceBatch', 'HostBatches', 'batch_to_host', 'batch_to_device',
           'dropout_generator', 'loss_and_outputs', 'make_train_step',
           'make_eval_step']


class DeviceBatch(NamedTuple):
    graph_s: GraphBatch
    graph_t: GraphBatch
    y: torch.Tensor        # [B, N_s] int64
    y_mask: torch.Tensor   # [B, N_s] bool


def _device_of(model):
    return next(model.parameters()).device


def batch_to_host(batch, pin_memory=False):
    """The host part of an upload: a :class:`DeviceBatch` of CPU tensors
    (pinned with ``pin_memory``) from a host
    :class:`~dgmc_tpu_torch.utils.data.PairBatch`, validated as
    :meth:`GraphBatch.host` says (a DeviceBatch passes through). Ground
    truths outside ``[0, N_t)`` under ``y_mask`` raise: the sparse variant
    injects them into the shortlist, whose kernels index target rows
    unchecked."""
    if isinstance(batch, DeviceBatch):
        return batch
    y, y_mask = np.asarray(batch.y), np.asarray(batch.y_mask, bool)
    N_t = np.shape(batch.t['x'])[1]
    if y_mask.any() and (y[y_mask].min() < 0 or y[y_mask].max() >= N_t):
        raise ValueError(f'ground truth outside [0, {N_t}) under y_mask')
    return DeviceBatch(GraphBatch.host(batch.s, pin_memory),
                       GraphBatch.host(batch.t, pin_memory),
                       host_tensor(y, torch.int64, pin_memory),
                       host_tensor(y_mask, torch.bool, pin_memory))


def batch_to_device(batch, device):
    """A :class:`DeviceBatch` on ``device``: a host
    :class:`~dgmc_tpu_torch.utils.data.PairBatch` through
    :func:`batch_to_host` (pinned for the card), then copied without
    blocking on the current stream; a DeviceBatch already on ``device``
    passes through unchanged."""
    device = canonical_device(device)
    batch = batch_to_host(batch, pin_memory=device.type == 'cuda')
    if batch.y.device == device:
        return batch
    return DeviceBatch(batch.graph_s.to(device), batch.graph_t.to(device),
                       batch.y.to(device, non_blocking=True),
                       batch.y_mask.to(device, non_blocking=True))


class HostBatches:
    """The batches of ``loader`` through :func:`batch_to_host`, pinned
    when ``device`` is a card: a training loop's host batches, which a
    :class:`~dgmc_tpu_torch.utils.data.PrefetchLoader` can also produce
    in a background thread."""

    def __init__(self, loader, device):
        self.loader = loader
        self.pin_memory = canonical_device(device).type == 'cuda'

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield batch_to_host(batch, self.pin_memory)


def dropout_generator(noise_seed, device):
    """The dropout masks' generator of one step, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (int(noise_seed) * 1_000_003 + 7) % (1 << 63))


def loss_and_outputs(model, batch, loss_on_s0=False, noise_seed=0,
                     r_s=None, **kw):
    """``(loss, S_0, S_L, y, y_mask)`` of one forward in the model's
    current mode, with the graph on the model's device; ``kw`` goes to the
    model (``num_steps``, ``detach``, ``pair_offset``, ``negatives``,
    ``generator``)."""
    g_s, g_t, y, y_mask = batch_to_device(batch, _device_of(model))
    S_0, S_L = model(g_s, g_t, y=y, y_mask=y_mask, noise_seed=noise_seed,
                     r_s=r_s, **kw)
    loss = metrics.nll_loss(S_L, y, y_mask)
    if loss_on_s0:
        loss = loss + metrics.nll_loss(S_0, y, y_mask)
    return loss, S_0, S_L, y, y_mask


def _hits(out, hits_ks, S_L, y, y_mask, reduction):
    for k in hits_ks:
        out[f'hits@{k}'] = metrics.hits_at_k(k, S_L, y, y_mask,
                                             reduction=reduction)
    return out


def make_train_step(model, loss_on_s0=False, num_steps=None, detach=False,
                    pair_offset=0, hits_ks=()):
    """Build ``step(state, batch, noise_seed, r_s=None, negatives=None)``
    for ``model``, whose parameters ``state``'s optimizer updates. The
    metrics are ``loss`` (the scalar trained on), ``loss_per_pair``
    ``[B]``, ``acc`` and ``hits@k`` for ``hits_ks`` (device tensors).
    ``pair_offset`` is the first pair's index in the per-pair random
    streams: a ``B = 1`` step at offset ``i`` draws what pair ``i`` of a
    batched step draws."""

    def train_step(state, batch, noise_seed, r_s=None, negatives=None):
        model.train()
        dev = _device_of(model)
        loss, _, S_L, y, y_mask = loss_and_outputs(
            model, batch, loss_on_s0, noise_seed, r_s, num_steps=num_steps,
            detach=detach, pair_offset=pair_offset, negatives=negatives,
            generator=dropout_generator(noise_seed, dev))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state)
        with torch.no_grad():
            out = {'loss': loss.detach(),
                   'loss_per_pair': metrics.nll_loss(
                       S_L, y, y_mask, reduction='per_pair'),
                   'acc': metrics.acc(S_L, y, y_mask)}
            _hits(out, hits_ks, S_L, y, y_mask, 'mean')
        return state, out

    return train_step


def make_eval_step(model, hits_ks=(1,), num_steps=None):
    """Build ``step(batch, noise_seed, r_s=None) -> metrics`` with
    ``count``, ``correct`` and ``hits@k`` summed over the batch. The
    consensus steps draw indicator noise at eval time too."""

    def eval_step(batch, noise_seed, r_s=None):
        model.eval()
        with torch.no_grad():
            _, _, S_L, y, y_mask = loss_and_outputs(
                model, batch, False, noise_seed, r_s, num_steps=num_steps)
            out = {'count': y_mask.sum(),
                   'correct': metrics.acc(S_L, y, y_mask, reduction='sum')}
            _hits(out, hits_ks, S_L, y, y_mask, 'sum')
        return out

    return eval_step
