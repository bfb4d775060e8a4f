"""Train and eval steps.

``make_train_step(model, ..., jit=True)`` returns
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

``guard=True`` adds the in-graph non-finite guard (a
:class:`~dgmc_tpu_torch.train.state.GuardedTrainState`): a step whose
loss or gradients' global norm is not finite keeps the old parameters,
Adam moments and step counts and batch-norm buffers wholesale (the
update is made, then the old values selected back into place on the
device; no host read), counts ``skip_count`` and ``consec_bad``, and
reports ``bad_step``; a finite step resets ``consec_bad``. The host's
``state.step`` advances either way, as the JAX package's does.
``fault_nan_step=N`` (the ``nan-grads@N`` fault) poisons every gradient
with NaN on optimizer step N (``state.step == N - 1`` before it); the
step number reaches the compiled step as a device input written before
each call. With both off the step records the graph it always did.

With probes on (:mod:`~dgmc_tpu_torch.obs.probes`, read when the step
runs eagerly or is captured) a train step records the model's probes and
its own (the gradients' global norm ``grad_norm``, ``check_finite`` of
the loss, order 1000, and of that norm, order 1001, after the fault and
before the guard, as in the JAX package) onto a probe tape, a static
output of a captured step, which the step's wrapper hands to
:func:`~dgmc_tpu_torch.obs.probes.submit` after every call; the metrics
a caller gets carry no tape. Eval steps carry no probes.

The train step runs its loss, optimizer update and metrics under the
stage ranges ``loss``, ``optimizer`` and ``metrics``
(:func:`~dgmc_tpu_torch.obs.stages.stage`, JAX's scopes), beside the
model's. ``step.cost_pass(state, batch, noise_seed, ...)`` runs the
forward, the loss, ``torch.autograd.grad`` and the metrics of one step
for the work counter (:func:`~dgmc_tpu_torch.obs.cost.cost_summary`)
and leaves the run as it was (see :func:`_cost_pass`).

``make_eval_step`` returns ``step(batch, noise_seed, r_s=None)`` with
``count``, ``correct`` and ``hits@k`` as sums, so callers aggregate
across batches exactly.

``jit`` (the JAX signature's switch, on by default) compiles the step
once per input signature (:mod:`~dgmc_tpu_torch.train.compiled`): on the
card a CUDA graph of the whole step (forward, backward and the Adam
update) captured at the first call and replayed after, on the CPU the
same static-buffer code run eagerly. The seed is then a static device
input (the draw kernel reads it there) and the dropout masks come from
one generator per step function on the model's device, reseeded before
each call with the seed :func:`dropout_generator` derives and
registered with each graph, so they equal the eager step's. The metrics
of a compiled step are static: the next call overwrites them, so a
caller that keeps one clones it. ``jit=False`` runs the eager step
(``chip_smoke.py`` and the card tests hold the two equal bit for bit).
Under ``jit`` on the card, injected ``negatives`` are refused: their range
check reads the device, which a captured step may not (tests inject
them on the CPU or with ``jit=False``).

A batch is a host :class:`~dgmc_tpu_torch.utils.data.PairBatch`, uploaded
per call, or a :class:`DeviceBatch`: from :func:`batch_to_device`, which
a loop over one fixed pair uploads once (its graphs then also keep their
sorted edge orders and routings across steps), or from
:func:`batch_to_host`, the host part of an upload (validated CPU tensors,
pinned for the card; :class:`HostBatches`), which the step copies to the
device without blocking.

Which batch a compiled step copies: a batch already on the model's card
(a :class:`DeviceBatch` from :func:`batch_to_device`, as the KG CLI
uploads its one pair) is read in place, so its caches (CSR orders) are
built once, by the warm-up, outside the graph, and each such batch object
gets a graph of its own; any other batch (host batches, as the dense CLI
makes one per step, and every batch on the CPU) is copied into the
step's static buffers, whose caches the graph builds from the data each
call copies in.
"""

import operator

from typing import NamedTuple

import numpy as np
import torch

from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.obs import probes
from dgmc_tpu_torch.obs.stages import stage
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.graph import GraphBatch, canonical_device, host_tensor
from dgmc_tpu_torch.train.compiled import Fixed, compiled
from dgmc_tpu_torch.train.state import (fill_grads, optimizer_update,
                                        save_in_place, snapshot)

__all__ = ['DeviceBatch', 'HostBatches', 'batch_to_host', 'batch_to_device',
           'dropout_seed', 'dropout_generator', 'loss_and_outputs',
           'make_train_step', 'make_eval_step']


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


def dropout_seed(noise_seed):
    """The dropout masks' generator seed of the step seeded
    ``noise_seed``."""
    return (int(noise_seed) * 1_000_003 + 7) % (1 << 63)


def dropout_generator(noise_seed, device):
    """The dropout masks' generator of one eager step, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        dropout_seed(noise_seed))


def loss_and_outputs(model, batch, loss_on_s0=False, noise_seed=0,
                     r_s=None, **kw):
    """``(loss, S_0, S_L, y, y_mask)`` of one forward in the model's
    current mode, with the graph on the model's device; ``kw`` goes to the
    model (``num_steps``, ``detach``, ``pair_offset``, ``negatives``,
    ``generator``)."""
    g_s, g_t, y, y_mask = batch_to_device(batch, _device_of(model))
    S_0, S_L = model(g_s, g_t, y=y, y_mask=y_mask, noise_seed=noise_seed,
                     r_s=r_s, **kw)
    with stage('loss'):
        loss = metrics.nll_loss(S_L, y, y_mask)
        if loss_on_s0:
            loss = loss + metrics.nll_loss(S_0, y, y_mask)
    return loss, S_0, S_L, y, y_mask


def _hits(out, hits_ks, S_L, y, y_mask, reduction):
    for k in hits_ks:
        out[f'hits@{k}'] = metrics.hits_at_k(k, S_L, y, y_mask,
                                             reduction=reduction)
    return out


def _step_input(batch, device):
    """A compiled step's batch input: in place where it lies on the card
    already, else its host part, to be copied."""
    if (isinstance(batch, DeviceBatch) and device.type == 'cuda'
            and batch.y.device == device):
        return Fixed(batch)
    return batch_to_host(batch, pin_memory=device.type == 'cuda')


class _Jit:
    """A step compiled on first use on the model's device (the device is
    known only once the model is on it). The model is its first input,
    read in place (its parameters and buffers count among the step's
    arguments); the warm-ups of a train step's capture restore the
    model's buffers with the train state."""

    def __init__(self, model, body, train):
        self.model = model
        self.body = body
        self.train = train
        self.compiled = None
        self.generator = None

    def _compiled(self):
        dev = canonical_device(_device_of(self.model))
        if self.compiled is None or self.compiled.device != dev:
            kw = {}
            if self.train:
                gen = self.generator = torch.Generator(device=dev)
                # The train inputs: (Fixed(model), Fixed(state), batch,
                # seed, r_s, negatives, step number).
                kw = {'snapshot': lambda model, state, *_: snapshot(
                          state.value, model.value),
                      'prepare': lambda *inputs: gen.manual_seed(
                          dropout_seed(inputs[3])),
                      'generators': (gen,) if dev.type == 'cuda' else ()}
            self.compiled = compiled(
                lambda _model, *a: self.body(*a, self.generator), dev, **kw)
        return self.compiled

    def inputs(self, batch, noise_seed, r_s, negatives=None):
        c = self._compiled()
        if negatives is not None and c.on_card:
            raise ValueError('injected negatives are range-checked on the '
                             'host, which a captured step cannot do: pass '
                             'them with jit=False or on the CPU')
        return c, (Fixed(self.model), _step_input(batch, c.device),
                   operator.index(noise_seed), r_s, negatives)


def _count_bad(state, good):
    """Count the step in the state's ledger: ``skip_count`` +1 and
    ``consec_bad`` +1 where ``good`` is false, ``consec_bad`` 0 where it
    is true."""
    with torch.no_grad():
        bad = (~good).to(torch.int32)
        state.skip_count.add_(bad)
        state.consec_bad.copy_((state.consec_bad + 1) * bad)


def _grads_finite(state, loss):
    """``isfinite(loss) & isfinite(global norm of the gradients)``, on the
    device."""
    grads = [p.grad for g in state.optimizer.param_groups
             for p in g['params']]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    return torch.isfinite(loss) & torch.isfinite(norm)


def make_train_step(model, loss_on_s0=False, num_steps=None, detach=False,
                    pair_offset=0, hits_ks=(), jit=True, guard=False,
                    fault_nan_step=None):
    """Build ``step(state, batch, noise_seed, r_s=None, negatives=None)``
    for ``model``, whose parameters ``state``'s optimizer updates. The
    metrics are ``loss`` (the scalar trained on), ``loss_per_pair``
    ``[B]``, ``acc`` and ``hits@k`` for ``hits_ks`` (device tensors).
    ``pair_offset`` is the first pair's index in the per-pair random
    streams: a ``B = 1`` step at offset ``i`` draws what pair ``i`` of a
    batched step draws. ``jit`` compiles it (see the module docstring);
    ``step.capture(state, batch, noise_seed, ...)`` then builds a
    signature's record ahead of the first call and returns it, and
    ``step.jit.compiled.records`` holds the records built so far.
    ``guard`` and ``fault_nan_step``: see the module docstring (with
    ``guard`` the metrics also carry ``bad_step``, ``skip_count`` and
    ``consec_bad``)."""

    def body(state, batch, noise_seed, r_s, negatives, step_no, generator):
        with probes.recording() as recorder:
            out = update(state, batch, noise_seed, r_s, negatives, step_no,
                         generator)
        tape = recorder.tape() if recorder is not None else None
        if tape is not None:
            out[probes.PROBE_KEY] = tape
        return out

    def update(state, batch, noise_seed, r_s, negatives, step_no,
               generator):
        model.train()
        # Saved before the forward: batch norm's buffers move in it.
        kept = save_in_place(state, model) if guard else None
        loss, _, S_L, y, y_mask = loss_and_outputs(
            model, batch, loss_on_s0, noise_seed, r_s, num_steps=num_steps,
            detach=detach, pair_offset=pair_offset, negatives=negatives,
            generator=generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if guard or fault_nan_step is not None:
            # A parameter this phase leaves without a gradient takes a
            # zero one now, as optax's global norm sees it.
            fill_grads(state)
        if fault_nan_step is not None:
            fire = step_no == fault_nan_step - 1
            for g in state.optimizer.param_groups:
                for p in g['params']:
                    p.grad.masked_fill_(fire, float('nan'))
        if probes.enabled():
            gnorm = probes.global_norm(
                [p.grad for g in state.optimizer.param_groups
                 for p in g['params'] if p.grad is not None])
            probes.emit('grad_norm', gnorm)
            # The loss precedes the gradient in the pipeline.
            probes.check_finite('loss', loss.detach(), order=1000)
            probes.check_finite('grad', gnorm, order=1001)
        good = _grads_finite(state, loss.detach()) if guard else None
        with stage('optimizer'):
            optimizer_update(state)
        if guard:
            # A bad step gives everything back (selected on the device).
            kept(lambda tensor, saved: torch.where(good, tensor, saved))
            _count_bad(state, good)
        with torch.no_grad():
            out = _metrics(loss, S_L, y, y_mask, hits_ks)
            if guard:
                out.update(bad_step=~good,
                           skip_count=state.skip_count.clone(),
                           consec_bad=state.consec_bad.clone())
        return out

    if fault_nan_step is not None and operator.index(fault_nan_step) < 1:
        raise ValueError(f'fault_nan_step is a 1-based optimizer step; got '
                         f'{fault_nan_step}')

    def step_number(state):
        """The host's step count as an input (``fault_nan_step`` only)."""
        if fault_nan_step is None:
            return None
        return torch.tensor(state.step, dtype=torch.int64)

    def cost_pass(state, batch, noise_seed, r_s=None, negatives=None):
        return _cost_pass(model, state, batch, noise_seed, r_s, negatives,
                          {'num_steps': num_steps, 'detach': detach,
                           'pair_offset': pair_offset}, loss_on_s0,
                          hits_ks)

    if not jit:
        def train_step(state, batch, noise_seed, r_s=None, negatives=None):
            _check_guarded(state, guard)
            dev = _device_of(model)
            step_no = step_number(state)
            out = body(state, batch, noise_seed, r_s, negatives,
                       None if step_no is None else step_no.to(dev),
                       dropout_generator(noise_seed, dev))
            state.step += 1
            return state, probes.take(out)

        train_step.cost_pass = cost_pass
        return train_step

    jitted = _Jit(model, body, train=True)

    def inputs(state, batch, noise_seed, r_s, negatives):
        _check_guarded(state, guard)
        c, (model_, b, seed, r_s, negatives) = jitted.inputs(
            batch, noise_seed, r_s, negatives)
        return c, (model_, Fixed(state), b, seed, r_s, negatives,
                   step_number(state))

    def train_step(state, batch, noise_seed, r_s=None, negatives=None):
        c, args = inputs(state, batch, noise_seed, r_s, negatives)
        out = probes.take(c(*args))
        state.step += 1
        return state, out

    def capture(state, batch, noise_seed, r_s=None, negatives=None):
        c, args = inputs(state, batch, noise_seed, r_s, negatives)
        return c.capture(*args)

    train_step.capture = capture
    train_step.cost_pass = cost_pass
    train_step.jit = jitted
    return train_step


def _metrics(loss, S_L, y, y_mask, hits_ks):
    """A train step's metrics, under the ``metrics`` range (JAX's scope,
    counted as ``other``)."""
    with stage('metrics'):
        out = {'loss': loss.detach(),
               'loss_per_pair': metrics.nll_loss(S_L, y, y_mask,
                                                 reduction='per_pair'),
               'acc': metrics.acc(S_L, y, y_mask)}
        return _hits(out, hits_ks, S_L, y, y_mask, 'mean')


def _cost_pass(model, state, batch, noise_seed, r_s, negatives, kw,
               loss_on_s0, hits_ks):
    """The forward, loss, ``torch.autograd.grad`` and metrics of one step
    for the work counter (:func:`~dgmc_tpu_torch.obs.cost.cost_summary`),
    leaving the run as it was: no update, no ``.grad`` written, the
    batch-norm buffers, the model's mode, the random states and the
    dispatch ledger set back, the probes recorded onto a tape that is
    dropped, the dropout masks from a generator of its own. Returns the
    parameters that took a gradient."""
    dev = _device_of(model)
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    training = model.training
    buffers = [(b, b.clone()) for b in model.buffers()]
    ledger = dispatch.snapshot()
    cpu_rng = torch.get_rng_state()
    cuda_rng = (torch.cuda.get_rng_state(dev) if dev.type == 'cuda'
                else None)
    try:
        with dispatch.quiet(), probes.recording(), torch.enable_grad():
            model.train()
            loss, _, S_L, y, y_mask = loss_and_outputs(
                model, batch, loss_on_s0, noise_seed, r_s,
                negatives=negatives,
                generator=dropout_generator(noise_seed, dev), **kw)
            grads = torch.autograd.grad(
                loss, [p for p in params if p.requires_grad],
                allow_unused=True)
            with torch.no_grad():
                _metrics(loss, S_L, y, y_mask, hits_ks)
    finally:
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
        model.train(training)
        dispatch.restore(ledger)
        torch.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state(cuda_rng, dev)
    trained = iter(grads)
    return [p for p in params
            if p.requires_grad and next(trained) is not None]


def _check_guarded(state, guard):
    if guard and getattr(state, 'skip_count', None) is None:
        raise TypeError('a guarded step takes a GuardedTrainState (see '
                        'train.state.with_guard_counters)')


def make_eval_step(model, hits_ks=(1,), num_steps=None, jit=True):
    """Build ``step(batch, noise_seed, r_s=None) -> metrics`` with
    ``count``, ``correct`` and ``hits@k`` summed over the batch. The
    consensus steps draw indicator noise at eval time too. ``jit`` as for
    :func:`make_train_step` (``step.capture(batch, noise_seed, r_s=None)``
    builds a record ahead of time)."""

    def body(batch, noise_seed, r_s, negatives, generator):
        model.eval()
        with torch.no_grad():
            _, _, S_L, y, y_mask = loss_and_outputs(
                model, batch, False, noise_seed, r_s, num_steps=num_steps)
            out = {'count': y_mask.sum(),
                   'correct': metrics.acc(S_L, y, y_mask, reduction='sum')}
            _hits(out, hits_ks, S_L, y, y_mask, 'sum')
        return out

    if not jit:
        def eval_step(batch, noise_seed, r_s=None):
            return body(batch, noise_seed, r_s, None, None)

        return eval_step

    jitted = _Jit(model, body, train=False)

    def eval_step(batch, noise_seed, r_s=None):
        c, args = jitted.inputs(batch, noise_seed, r_s)
        return c(*args)

    def capture(batch, noise_seed, r_s=None):
        c, args = jitted.inputs(batch, noise_seed, r_s)
        return c.capture(*args)

    eval_step.capture = capture
    eval_step.jit = jitted
    return eval_step
