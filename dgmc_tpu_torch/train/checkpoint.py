"""Checkpoints: save, verify and restore a training run.

The port's counterpart of ``dgmc_tpu/train/checkpoint.py``. Orbax is a
JAX library, so the on-disk format is the port's own:

- one step is the directory ``<dir>/<step>/`` holding one file,
  ``state.pt`` (:data:`STATE_FILE`), written by ``torch.save`` and read
  with ``torch.load(weights_only=True)``: the model's ``state_dict``
  (parameters and batch-norm buffers), the optimizer's ``state_dict``,
  the checkpoint's step and the train state's, and a guarded state's
  counters;
- the step is written into a temporary directory beside it and
  ``os.rename``d into place, so a step directory is whole or absent;
- each step gets a manifest, ``<dir>/manifests/<step>.json``: the
  sha256 and size of every file of the step, written atomically.

The JAX semantics hold: the newest ``max_to_keep`` steps are kept (3 by
default) and retired steps lose their manifests; :meth:`Checkpointer.
verify` re-hashes a step against its manifest; a save over an existing
step replaces it; :meth:`Checkpointer.restore` walks from the newest
step to the oldest past steps that fail verification or do not load,
with a warning for each, and a pinned step that is missing or corrupt
raises. Saves are synchronous: the tensors are copied to the host after
the step, then written (JAX's asynchronous save is not ported).

A restore writes in place, through the train state's one writer
(:func:`~dgmc_tpu_torch.train.state.write_state`): the parameters,
buffers, Adam's moments and step counts keep their storage (Adam's
tensors not made yet are made as Adam would make them, ``capturable``
included), so a CUDA graph captured before the restore reads the
restored values. The optimizer's hyperparameters stay the
caller's, as they are the JAX package's ``tx``.
"""

import json
import os
import shutil
import sys
import time

import torch

from dgmc_tpu_torch.train.state import GuardedTrainState, write_state
from dgmc_tpu_torch.utils.io import sha256_file, write_json_atomic

__all__ = ['CheckpointError', 'CheckpointCorruptError', 'Checkpointer',
           'MANIFEST_DIRNAME', 'STATE_FILE', 'resume_or_init']

#: Subdirectory of the checkpoint root holding the per-step manifests.
MANIFEST_DIRNAME = 'manifests'
#: The one file of a step directory.
STATE_FILE = 'state.pt'
#: The payload's format, checked at restore.
FORMAT = 1


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored; the message says what to do."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed manifest verification or did not load."""


def _file_table(step_dir):
    """``{relpath: {sha256, bytes}}`` over every file under a step."""
    out = {}
    for root, _dirs, files in os.walk(step_dir):
        for name in sorted(files):
            p = os.path.join(root, name)
            out[os.path.relpath(p, step_dir)] = {
                'sha256': sha256_file(p), 'bytes': os.path.getsize(p)}
    return out


def _params(optimizer):
    return [p for g in optimizer.param_groups for p in g['params']]


def _host(x):
    """``x`` with every tensor copied to the host."""
    if torch.is_tensor(x):
        return x.detach().to('cpu', copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _payload(step, model, state):
    out = {'format': FORMAT, 'step': int(step),
           'model': _host(model.state_dict()),
           'optimizer': None if state is None
           else _host(state.optimizer.state_dict()),
           'state_step': None if state is None else int(state.step)}
    if getattr(state, 'skip_count', None) is not None:
        out['guard'] = {'skip_count': _host(state.skip_count),
                        'consec_bad': _host(state.consec_bad)}
    return out


def _check_payload(payload, model, state):
    """Raise unless ``payload`` fits ``model`` (and ``state``): every
    name, shape and dtype of the model's ``state_dict``, and one
    optimizer state of the parameters' shapes per parameter."""
    if not isinstance(payload, dict) or payload.get('format') != FORMAT:
        raise ValueError(f'not a checkpoint of format {FORMAT}')
    want = model.state_dict()
    got = payload['model']
    if set(got) != set(want):
        raise KeyError(f'model state_dict keys differ: missing '
                       f'{sorted(set(want) - set(got))}, unexpected '
                       f'{sorted(set(got) - set(want))}')
    for k, v in want.items():
        if got[k].shape != v.shape or got[k].dtype != v.dtype:
            raise ValueError(f'{k}: {tuple(got[k].shape)} {got[k].dtype} '
                             f'where the model has {tuple(v.shape)} '
                             f'{v.dtype}')
    if state is None:
        return
    opt = payload['optimizer']
    if opt is None or not isinstance(payload.get('state_step'), int):
        raise ValueError('the checkpoint holds no optimizer state')
    params = _params(state.optimizer)
    saved = [i for g in opt['param_groups'] for i in g['params']]
    if len(saved) != len(params):
        raise ValueError(f'the checkpoint\'s optimizer has {len(saved)} '
                         f'parameters, this one {len(params)}')
    for i, st in opt['state'].items():
        for k, v in st.items():
            if k != 'step' and v.shape != params[i].shape:
                raise ValueError(f'optimizer state {i}.{k}: '
                                 f'{tuple(v.shape)} where the parameter is '
                                 f'{tuple(params[i].shape)}')


def _apply(payload, model, state):
    """Write a checked payload into ``model`` and ``state`` in place
    (:func:`~dgmc_tpu_torch.train.state.write_state`); returns the state
    (a guarded one keeps its counters' tensors, at 0 where the checkpoint
    has none)."""
    counters = None
    if isinstance(state, GuardedTrainState):
        counters = payload.get('guard') or {
            k: torch.zeros((), dtype=torch.int32)
            for k in ('skip_count', 'consec_bad')}
    write_state(state, model, payload['model'],
                None if state is None else payload['optimizer']['state'],
                counters)
    if state is not None:
        state.step = payload['state_step']
    return state


class Checkpointer:
    """Checkpoints of one run under ``directory`` (see the module
    docstring).

    Args:
        directory: the checkpoint root (created if absent).
        max_to_keep: how many of the newest steps to keep (``None``: all).
        verify: write a manifest for every step and verify each restore
            against it.
    """

    def __init__(self, directory, max_to_keep=3, verify=True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._verify = verify
        #: The step the last :meth:`restore` loaded (older than the
        #: latest after a fallback).
        self.restored_step = None
        #: Set by the last :meth:`restore`: ``'counters-added'`` (a plain
        #: checkpoint into a guarded state), ``'counters-dropped'`` (a
        #: guarded one into a plain state) or ``None``.
        self.restored_toggle = None
        #: ``{'step', 'seconds', 'bytes'}`` of the last :meth:`save`.
        self.last_save = None
        #: ``{'step', 'seconds'}`` of the last :meth:`restore`.
        self.last_restore = None

    # -- layout and manifests ---------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step):
        return os.path.join(self.directory, MANIFEST_DIRNAME, f'{step}.json')

    def all_steps(self):
        """The committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def write_manifest(self, step):
        """Hash every file of ``step`` into ``manifests/<step>.json``
        (atomic tmp+rename)."""
        path = self._manifest_path(step)
        write_json_atomic(path, {'step': int(step), 'files': _file_table(
            self._step_dir(step))}, indent=1, sort_keys=True)
        return path

    def verify(self, step):
        """Problems of ``step``'s files against its manifest, as strings:
        empty when they match, or when there is no manifest (an
        unverifiable step is no evidence of corruption; the restore still
        guards its load)."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return []
        except (OSError, ValueError) as e:
            return [f'manifest unreadable: {e}']
        problems = []
        step_dir = self._step_dir(step)
        for rel, want in sorted(manifest.get('files', {}).items()):
            p = os.path.join(step_dir, rel)
            if not os.path.isfile(p):
                problems.append(f'missing file {rel}')
                continue
            size = os.path.getsize(p)
            if size != want['bytes']:
                problems.append(
                    f'{rel}: size {size} != manifest {want["bytes"]}')
            elif sha256_file(p) != want['sha256']:
                problems.append(f'{rel}: sha256 mismatch')
        return problems

    def _retire(self):
        """Drop the steps past ``max_to_keep`` and the manifests whose
        step is gone."""
        steps = self.all_steps()
        if self.max_to_keep is not None:
            for s in steps[:max(0, len(steps) - self.max_to_keep)]:
                self.delete_step(s)
            steps = self.all_steps()
        mdir = os.path.join(self.directory, MANIFEST_DIRNAME)
        if os.path.isdir(mdir):
            for name in os.listdir(mdir):
                base, ext = os.path.splitext(name)
                if ext == '.json' and base.isdigit() \
                        and int(base) not in steps:
                    os.remove(os.path.join(mdir, name))

    # -- save / restore ----------------------------------------------------

    def save(self, step, model, state=None):
        """Save ``model`` (and ``state``: its optimizer, step and guard
        counters) as ``step``, replacing a step of that number, then
        retire old steps. Returns the step directory."""
        t0 = time.perf_counter()
        payload = _payload(step, model, state)
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f'.tmp-{step}-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            # A re-save (a resumed run re-running the epoch of a step it
            # fell back past) replaces the step and its manifest.
            self.delete_step(step)
        os.rename(tmp, final)
        if self._verify:
            self.write_manifest(step)
        self._retire()
        self.last_save = {'step': int(step),
                          'seconds': time.perf_counter() - t0,
                          'bytes': sum(e['bytes'] for e in
                                       _file_table(final).values())}
        return final

    def delete_step(self, step):
        """Remove a step and its manifest."""
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        try:
            os.remove(self._manifest_path(step))
        except FileNotFoundError:
            pass

    def _load(self, step, model, state):
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location='cpu', weights_only=True)
        _check_payload(payload, model, state)
        return payload

    def restore(self, model, state=None, step=None, fallback=None):
        """Restore ``model`` (and ``state``) in place from a step; returns
        ``state``.

        Without ``step``, tries the newest step and, unless
        ``fallback=False``, walks back past steps that fail verification
        or do not load (a truncated or corrupt file, a step of another
        model), warning for each. With ``step``, a missing step raises
        :class:`FileNotFoundError` naming the available steps and a
        corrupt one :class:`CheckpointCorruptError`, unless
        ``fallback=True``, which walks back from ``step``. When no step
        restores, :class:`CheckpointCorruptError` lists each step's
        failure and what to do. The step loaded lands in
        :attr:`restored_step`.

        A checkpoint without guard counters restores into a
        :class:`~dgmc_tpu_torch.train.state.GuardedTrainState` with its
        counters at 0; a guarded one into a plain state drops its
        counters (:attr:`restored_toggle` says which)."""
        t0 = time.perf_counter()
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise FileNotFoundError(
                    f'no checkpoint for step {step} under {self.directory}; '
                    f'available steps: {steps or "none"} (pass step=None '
                    f'to resume from the latest)')
            fallback = bool(fallback)
            candidates = ([s for s in reversed(steps) if s <= step]
                          if fallback else [step])
        else:
            if not steps:
                raise FileNotFoundError(
                    f'no checkpoint found under {self.directory}')
            candidates = list(reversed(steps))
            fallback = True if fallback is None else fallback
        failures = []
        for s in candidates:
            problems = self.verify(s) if self._verify else []
            what = 'failed verification'
            if not problems:
                try:
                    payload = self._load(s, model, state)
                except Exception as e:  # a torn or alien step raises deep
                    problems, what = [f'{type(e).__name__}: {e}'], \
                        'could not be restored'
            if problems:
                detail = '; '.join(problems)
                failures.append(f'step {s}: {detail}')
                if not fallback:
                    raise CheckpointCorruptError(
                        f'checkpoint step {s} under {self.directory} {what}'
                        f': {detail}. Pick another step ({steps}) or delete '
                        f'the corrupt one.')
                print(f'checkpoint: step {s} {what} ({detail}); falling '
                      f'back to the previous checkpoint', file=sys.stderr)
                continue
            self.restored_toggle = None
            if state is not None:
                guarded = isinstance(state, GuardedTrainState)
                if guarded and 'guard' not in payload:
                    self.restored_toggle = 'counters-added'
                elif not guarded and 'guard' in payload:
                    self.restored_toggle = 'counters-dropped'
            state = _apply(payload, model, state)
            self.restored_step = s
            self.last_restore = {'step': s,
                                 'seconds': time.perf_counter() - t0}
            return state
        raise CheckpointCorruptError(
            f'every checkpoint under {self.directory} failed to restore:\n  '
            + '\n  '.join(failures) + f'\nDelete {self.directory} to start '
            f'fresh, or repair or replace a step directory and retry.')


def resume_or_init(ckpt_dir, state, model):
    """A run's resume: open a :class:`Checkpointer` under ``ckpt_dir``
    (``None``: no checkpoints) and restore the newest restorable step
    into ``model`` and ``state`` in place, if there is one.

    Returns ``(ckpt, state, start_epoch)``, ``start_epoch`` the first
    epoch still to run (1 for a fresh start: ``None`` or an empty
    directory). A directory whose every step is corrupt raises
    :class:`CheckpointCorruptError` rather than silently training from
    scratch. Toggling ``--guard-bad-steps`` between runs is not
    corruption: a plain checkpoint restores into a guarded state with its
    counters at 0, and a guarded one into a plain state with its skip
    ledger dropped; each says so on standard error. Run it before the
    first capture (the restore writes in place either way)."""
    if not ckpt_dir:
        return None, state, 1
    ckpt = Checkpointer(ckpt_dir)
    steps = ckpt.all_steps()
    if not steps:
        return ckpt, state, 1
    state = ckpt.restore(model, state)
    step = ckpt.restored_step
    if ckpt.restored_toggle == 'counters-added':
        print(f'checkpoint: step {step} under {ckpt.directory} was written '
              f'without guard counters; counters start at 0 '
              f'(--guard-bad-steps toggled between runs)', file=sys.stderr)
    elif ckpt.restored_toggle == 'counters-dropped':
        print(f'checkpoint: step {step} under {ckpt.directory} was written '
              f'with guard counters; the skip ledger is dropped '
              f'(--guard-bad-steps toggled between runs)', file=sys.stderr)
    note = '' if step == steps[-1] else \
        f' (latest step {steps[-1]} was unrestorable)'
    print(f'Resumed from {ckpt.directory} at epoch {step}.{note}')
    return ckpt, state, step + 1
