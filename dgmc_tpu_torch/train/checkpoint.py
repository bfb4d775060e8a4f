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
raises.

Saves are asynchronous by default, as orbax's are in the JAX package
(``save(step, model, state, wait=False)``):

- the state is snapshotted on the caller's thread before :meth:`save`
  returns: every tensor is copied to the host, a card's into pinned
  buffers on the current stream, behind one CUDA event. A step that runs
  next on that stream (a captured step's replay writes the parameters in
  place) runs after the copies; the writer waits on the event before it
  reads the buffers;
- only the file write, the rename into place and the retirement of old
  steps run in the background, one save at a time: a save first waits
  for the write before it;
- manifests are hashed on the caller's thread, by
  :meth:`Checkpointer.finalize_manifests`, for committed steps only: at
  the next save, :meth:`~Checkpointer.wait_until_finished` and
  :meth:`~Checkpointer.close` (which waits);
- a step is committed once its directory is renamed into place. Listing
  and restoring see committed steps only, so a write still in flight
  (or cut by a crash, which leaves a ``.tmp-*`` directory that the next
  :class:`Checkpointer` removes) is never restored; a restore by the
  saving :class:`Checkpointer` waits for its write first.

``wait=True`` returns once the step is committed and manifested.

Across ranks (a process group of more than one,
:mod:`~dgmc_tpu_torch.parallel.distributed`) the coordinator rule holds:
rank 0 writes each step, waiting for its write, while the other ranks
wait at a barrier until it is committed; a restore starts at a barrier
and every rank reads the same file (the directory is shared).

A restore writes in place, through the train state's one writer
(:func:`~dgmc_tpu_torch.train.state.write_state`): the parameters,
buffers, Adam's moments and step counts keep their storage (Adam's
tensors not made yet are made as Adam would make them, ``capturable``
included), so a CUDA graph captured before the restore reads the
restored values. The optimizer's hyperparameters stay the
caller's, as they are the JAX package's ``tx``.
"""

import concurrent.futures
import json
import os
import shutil
import sys
import threading
import time

import torch

from dgmc_tpu_torch.parallel import distributed
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
#: The prefix of a step's directory while it is written.
TMP_PREFIX = '.tmp-'


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


def _host(x, copies):
    """``x`` with every tensor copied to the host: a card's tensor into a
    pinned buffer without blocking (appended to ``copies``), a host
    tensor cloned."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.is_cuda:
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x, non_blocking=True)
            copies.append(out)
            return out
        return x.clone()
    if isinstance(x, dict):
        return {k: _host(v, copies) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v, copies) for v in x)
    return x


def _payload(step, model, state):
    """The step's payload on the host, and the event recorded after its
    copies from the card (``None`` when no tensor lay on one)."""
    copies = []
    out = {'format': FORMAT, 'step': int(step),
           'model': _host(model.state_dict(), copies),
           'optimizer': None if state is None
           else _host(state.optimizer.state_dict(), copies),
           'state_step': None if state is None else int(state.step)}
    if getattr(state, 'skip_count', None) is not None:
        out['guard'] = {'skip_count': _host(state.skip_count, copies),
                        'consec_bad': _host(state.consec_bad, copies)}
    done = None
    if copies:
        done = torch.cuda.Event()
        done.record()
    return out, done


def _step_dirs(directory):
    """The committed steps under ``directory``, oldest first."""
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit()
                  and os.path.isdir(os.path.join(directory, n)))


def _write_step(directory, step, payload, done, max_to_keep):
    """The background half of a save: wait for the snapshot's copies,
    write the step into a temporary directory, rename it into place
    (replacing a step of that number), then retire the steps past
    ``max_to_keep``. Returns ``{'step', 'write_s', 'bytes'}``."""
    t0 = time.perf_counter()
    if done is not None:
        done.synchronize()
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f'{TMP_PREFIX}{step}-{os.getpid()}')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    nbytes = sum(e['bytes'] for e in _file_table(tmp).values())
    if os.path.isdir(final):
        # A re-save (a resumed run re-running the epoch of a step it
        # fell back past) replaces the step.
        shutil.rmtree(final)
    os.rename(tmp, final)
    if max_to_keep is not None:
        steps = _step_dirs(directory)
        for s in steps[:max(0, len(steps) - max_to_keep)]:
            shutil.rmtree(os.path.join(directory, str(s)),
                          ignore_errors=True)
    return {'step': int(step), 'write_s': time.perf_counter() - t0,
            'bytes': nbytes}


#: The write in flight per checkpoint directory of this process: another
#: :class:`Checkpointer` on the directory waits for it before it
#: restores or clears temporary directories.
_writes = {}
_writes_lock = threading.Lock()


def _await_writes(directory):
    with _writes_lock:
        pending = _writes.get(directory)
    if pending is not None:
        concurrent.futures.wait([pending])


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
        #: ``{'step', 'seconds'}`` of the last :meth:`save`: the seconds
        #: the caller was blocked; once the step is committed also
        #: ``'write_s'`` (the background write) and ``'bytes'``.
        self.last_save = None
        #: ``{'step', 'seconds'}`` of the last :meth:`restore`.
        self.last_restore = None
        self._pool = None
        self._pending = None     # (step, future) of the write in flight
        self._commits = []
        # A write cut by a crash leaves its temporary directory behind.
        _await_writes(self.directory)
        for name in os.listdir(self.directory):
            if name.startswith(TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- layout and manifests ---------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step):
        return os.path.join(self.directory, MANIFEST_DIRNAME, f'{step}.json')

    def all_steps(self):
        """The committed steps, oldest first; while a write is in flight,
        orbax's listing: its step with the committed ones, less those
        its commit retires."""
        steps = _step_dirs(self.directory)
        if self._pending is None:
            return steps
        steps = sorted(set(steps) | {self._pending[0]})
        if self.max_to_keep is not None:
            steps = steps[max(0, len(steps) - self.max_to_keep):]
        return steps

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
        guards its load). A step this checkpointer is writing is waited
        for first."""
        if self._pending is not None and self._pending[0] == step:
            self.wait_until_finished()
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

    def finalize_manifests(self):
        """Collect a finished write (its error raises here), hash a
        manifest for each committed step that lacks one and drop the
        manifests whose step was retired. Runs on the caller's thread:
        at each save, :meth:`wait_until_finished` and :meth:`close`; a
        write still in flight gets its manifest at the next of them."""
        if self._pending is not None and self._pending[1].done():
            _, future = self._pending
            self._pending = None
            with _writes_lock:
                if _writes.get(self.directory) is future:
                    del _writes[self.directory]
            done = future.result()
            if self.last_save is not None \
                    and self.last_save['step'] == done['step']:
                self.last_save.update(write_s=done['write_s'],
                                      bytes=done['bytes'])
                self._commits.append(self.last_save)
            else:
                self._commits.append(dict(done, seconds=None))
        writing = None if self._pending is None else self._pending[0]
        steps = self.all_steps()
        if self._verify:
            for step in steps:
                if step != writing and \
                        not os.path.exists(self._manifest_path(step)):
                    self.write_manifest(step)
        mdir = os.path.join(self.directory, MANIFEST_DIRNAME)
        if os.path.isdir(mdir):
            for name in os.listdir(mdir):
                base, ext = os.path.splitext(name)
                if ext == '.json' and base.isdigit() \
                        and int(base) not in steps:
                    os.remove(os.path.join(mdir, name))

    def wait_until_finished(self):
        """Block until the write in flight (if any) is committed, then
        finalize its manifest."""
        if self._pending is not None:
            concurrent.futures.wait([self._pending[1]])
        self.finalize_manifests()

    def take_commits(self):
        """The saves committed since the last call, oldest first, as
        :attr:`last_save` records them (``step``, ``seconds``,
        ``write_s``, ``bytes``)."""
        out, self._commits = self._commits, []
        return out

    def close(self):
        """Wait for the write in flight and stop the writer thread."""
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- save / restore ----------------------------------------------------

    def save(self, step, model, state=None, wait=False):
        """Save ``model`` (and ``state``: its optimizer, step and guard
        counters) as ``step``, replacing a step of that number; the
        steps past ``max_to_keep`` retire once it is committed. The
        snapshot is taken before this returns; the write runs in the
        background unless ``wait`` (see the module docstring). Returns
        the step directory."""
        t0 = time.perf_counter()
        if distributed.process_count() > 1:
            # The coordinator writes, the others wait until it is
            # committed.
            if distributed.is_coordinator():
                self._save(step, model, state, True, t0)
            distributed.barrier()
            return self._step_dir(step)
        return self._save(step, model, state, wait, t0)

    def _save(self, step, model, state, wait, t0):
        self.wait_until_finished()
        payload, done = _payload(step, model, state)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix='checkpoint')
        # A re-save's old manifest goes now (orbax deletes the step).
        try:
            os.remove(self._manifest_path(step))
        except FileNotFoundError:
            pass
        future = self._pool.submit(_write_step, self.directory, int(step),
                                   payload, done, self.max_to_keep)
        self._pending = (int(step), future)
        with _writes_lock:
            _writes[self.directory] = future
        self.last_save = record = {'step': int(step)}
        # The manifests of the steps this write retires go now (JAX's
        # finalize after each save).
        self.finalize_manifests()
        if wait:
            self.wait_until_finished()
        record['seconds'] = time.perf_counter() - t0
        return self._step_dir(step)

    def delete_step(self, step):
        """Remove a step and its manifest (after the write in flight)."""
        self.wait_until_finished()
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
        distributed.barrier()
        self.wait_until_finished()
        _await_writes(self.directory)
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


def resume_or_init(ckpt_dir, state, model, mesh=None, rules=None):
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
    first capture (the restore writes in place either way).

    ``mesh`` (JAX's argument): every rank of the mesh restores the same
    step, and the state is then replicated from the mesh's first rank
    (:func:`~dgmc_tpu_torch.parallel.sharding.replicate`). ``rules`` (a
    :class:`~dgmc_tpu_torch.parallel.rules.PartitionRules`) are checked
    against the state first: the port's train state is replicated, so a
    rule that shards a leaf of it raises
    (:meth:`~dgmc_tpu_torch.parallel.rules.PartitionRules.check_state`)."""
    if rules is not None:
        rules.check_state(state, model)
    if not ckpt_dir:
        return None, state, 1
    ckpt = Checkpointer(ckpt_dir)
    distributed.barrier()
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
    if distributed.is_coordinator():
        print(f'Resumed from {ckpt.directory} at epoch {step}.{note}')
    if mesh is not None:
        from dgmc_tpu_torch.parallel.sharding import replicate
        replicate(state, mesh, model)
    return ckpt, state, step + 1
