"""Deterministic, flag-driven fault injection.

The port's copy of ``dgmc_tpu/resilience/faults.py``, its single-process
kinds. Faults are armed from the CLI (``--inject-fault SPEC``,
repeatable) and fire at exact, reproducible points:

=====================  ==================================================
``raise@N``            raise :class:`FaultInjected` before epoch N
``sigterm@N``          ``SIGTERM`` to self before epoch N (preemption)
``sigkill@N``          ``SIGKILL`` to self before epoch N (hard crash)
``stall@N`` /          sleep ``S`` seconds (default 3600) before epoch N
``stall@N:S``
``nan-grads@N``        NaN into every gradient on optimizer step N (in the
                       step: ``make_train_step(fault_nan_step=N)``)
``ckpt-truncate@N``    truncate the largest file of the step-N checkpoint
                       right after it is saved
``ckpt-corrupt@N``     flip bytes in the largest file of the step-N
                       checkpoint right after it is saved
=====================  ==================================================

The JAX package's other kinds need other hosts, the obs fence or
downloads, which the port does not have yet; :func:`parse_spec` refuses
them by name (:data:`NOT_PORTED`), never ignoring one silently.

**Fire once across restarts.** A resumed run replays its schedule from
the checkpoint; a ``sigkill@5`` that fired again on the replayed epoch 5
would crash forever. The process-killing and checkpoint faults record
themselves in ``<state_dir>/faults_fired.json`` the moment they fire
(before the kill), and a restarted process skips them. The CLIs place
the ledger with :func:`ledger_dir` (the checkpoint directory, else the
obs root above a supervised attempt's ``attempt_<k>``, else the
directory the supervisor exports in :data:`LEDGER_ENV`). ``nan-grads`` is
deliberately not recorded: it is part of the deterministic step stream,
and a resumed run must replay it to follow the uninterrupted one.
"""

import json
import os
import signal
import sys
import time

from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['FaultInjected', 'FaultSpec', 'FaultPlan', 'KINDS', 'NOT_PORTED',
           'LEDGER_ENV', 'add_fault_args', 'ledger_dir', 'parse_spec',
           'corrupt_checkpoint']

FIRED_LEDGER = 'faults_fired.json'

#: Host-side kinds that fire in the training loop, once.
_STEP_KINDS = ('raise', 'sigterm', 'sigkill', 'stall')
_CKPT_KINDS = ('ckpt-truncate', 'ckpt-corrupt')
KINDS = _STEP_KINDS + _CKPT_KINDS + ('nan-grads',)
#: The JAX package's kinds the port refuses, and what they wait for.
NOT_PORTED = {
    'peer-death': 'multi-GPU runs and the supervisor\'s elastic restart '
                  '(ROADMAP A8)',
    'coord-partition': 'multi-GPU runs and the supervisor\'s elastic '
                       'restart (ROADMAP A8)',
    'collective-stall': 'multi-GPU runs and the obs fence (ROADMAP A8/A9)',
    'straggler': 'multi-GPU runs and the obs plane (ROADMAP A8/A9)',
    'download-fail': 'the dataset downloads (ROADMAP A6)',
}


class FaultInjected(RuntimeError):
    """The ``raise@N`` fault."""


class FaultSpec:
    """One parsed ``kind@step[:arg]`` spec."""

    def __init__(self, kind, step, arg=None):
        self.kind = kind
        self.step = step
        self.arg = arg

    @property
    def key(self):
        return f'{self.kind}@{self.step}'

    def __repr__(self):
        return f'FaultSpec({self.key}' + \
            (f':{self.arg})' if self.arg is not None else ')')


def parse_spec(text):
    """``'sigkill@5'`` / ``'stall@3:20'`` -> :class:`FaultSpec`. Raises
    ``ValueError`` with the grammar on junk, and names the JAX package's
    kinds the port has not ported yet."""
    body, arg = (text.split(':', 1) + [None])[:2]
    kind, step = (body.split('@', 1) + [None])[:2]
    kind = kind.strip()
    if kind in NOT_PORTED:
        raise ValueError(f'fault kind {kind!r} in spec {text!r} is not '
                         f'ported yet: it needs {NOT_PORTED[kind]}; ported: '
                         f'{", ".join(KINDS)}')
    if kind not in KINDS:
        raise ValueError(
            f'unknown fault kind {kind!r} in spec {text!r}; known: '
            f'{", ".join(KINDS)} (grammar: kind@step[:arg])')
    if step is None:
        raise ValueError(f'{text!r}: {kind} needs a step (e.g. {kind}@3)')
    step = int(step)
    if arg is not None:
        if kind != 'stall':
            raise ValueError(f'{text!r}: only stall takes an argument')
        arg = float(arg)
    elif kind == 'stall':
        arg = 3600.0
    return FaultSpec(kind, step, arg)


def add_fault_args(parser):
    """Register ``--inject-fault`` on an argparse parser."""
    parser.add_argument(
        '--inject-fault', '--inject_fault', dest='inject_fault',
        action='append', default=[], metavar='SPEC',
        help='deterministic fault injection (repeatable): raise@N, '
             'sigterm@N, sigkill@N, stall@N[:SEC], nan-grads@N, '
             'ckpt-truncate@N, ckpt-corrupt@N. Process-killing and '
             'checkpoint faults fire once across supervised restarts (a '
             'ledger in the checkpoint or obs dir); nan-grads replays '
             'deterministically. See dgmc_tpu_torch/resilience/faults.py')
    return parser


LEDGER_ENV = 'DGMC_TPU_FAULT_LEDGER_DIR'


def ledger_dir(ckpt_dir, obs_dir):
    """Where the fire-once ledger lives: the checkpoint dir, else the
    obs ROOT — a supervised child's ``--obs-dir`` is rewritten to
    ``<root>/attempt_<k>`` per attempt, and a ledger inside one attempt
    would be invisible to the next — else :data:`LEDGER_ENV`, which the
    supervisor exports to every child, so a run with neither flag still
    fires each fault once."""
    if ckpt_dir:
        return ckpt_dir
    if not obs_dir:
        return os.environ.get(LEDGER_ENV) or None
    from dgmc_tpu_torch.resilience.supervisor import is_attempt_dirname
    base = os.path.basename(os.path.normpath(obs_dir))
    if is_attempt_dirname(base):
        return os.path.dirname(os.path.normpath(obs_dir))
    return obs_dir


class FaultPlan:
    """The armed faults of one run, with the fire-once ledger.

    Args:
        specs: spec strings (or :class:`FaultSpec`).
        state_dir: where ``faults_fired.json`` lives
            (:func:`ledger_dir`); ``None`` keeps the record in memory
            only.
    """

    def __init__(self, specs=(), state_dir=None):
        self.specs = [s if isinstance(s, FaultSpec) else parse_spec(s)
                      for s in (specs or ())]
        self._state_dir = state_dir
        self._fired = set(self._load_ledger())

    @classmethod
    def from_args(cls, args, state_dir=None):
        return cls(getattr(args, 'inject_fault', ()) or (),
                   state_dir=state_dir)

    # -- ledger ------------------------------------------------------------

    def _ledger_path(self):
        if not self._state_dir:
            return None
        return os.path.join(self._state_dir, FIRED_LEDGER)

    def _load_ledger(self):
        path = self._ledger_path()
        if not path or not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                return json.load(f).get('fired', [])
        except (OSError, ValueError):
            return []

    def _mark_fired(self, spec):
        self._fired.add(spec.key)
        path = self._ledger_path()
        if path:
            write_json_atomic(path, {'fired': sorted(self._fired)}, indent=1)

    # -- hooks -------------------------------------------------------------

    @property
    def nan_grads_step(self):
        """The step for ``make_train_step(fault_nan_step=...)``, or
        ``None``."""
        for spec in self.specs:
            if spec.kind == 'nan-grads':
                return spec.step
        return None

    def before_step(self, step):
        """Fire any armed host-side fault scheduled for ``step`` (the
        1-based epoch). The ledger is written before the fault delivers,
        so a killed and restarted run does not fire it again."""
        for spec in self.specs:
            if spec.kind not in _STEP_KINDS or spec.step != step \
                    or spec.key in self._fired:
                continue
            self._mark_fired(spec)
            print(f'[faults] firing {spec.key} at step {step}',
                  file=sys.stderr, flush=True)
            if spec.kind == 'raise':
                raise FaultInjected(f'injected fault {spec.key}')
            if spec.kind == 'stall':
                time.sleep(spec.arg)
                continue
            os.kill(os.getpid(), signal.SIGTERM
                    if spec.kind == 'sigterm' else signal.SIGKILL)
            # A handler that swallowed the signal must not let the run go
            # on as if nothing happened.
            time.sleep(30)
            raise FaultInjected(
                f'{spec.key} delivered but the process survived')

    def after_checkpoint(self, ckpt, step):
        """Damage the just-saved step when a ``ckpt-*@step`` fault is
        armed; ``ckpt`` is a
        :class:`~dgmc_tpu_torch.train.checkpoint.Checkpointer`."""
        for spec in self.specs:
            if spec.kind not in _CKPT_KINDS or spec.step != step \
                    or spec.key in self._fired:
                continue
            target = corrupt_checkpoint(
                ckpt.directory, step,
                mode='truncate' if spec.kind == 'ckpt-truncate'
                else 'corrupt')
            self._mark_fired(spec)
            print(f'[faults] {spec.key}: damaged {target}',
                  file=sys.stderr, flush=True)


def corrupt_checkpoint(directory, step, mode='corrupt'):
    """Damage the largest file of checkpoint ``step`` under ``directory``
    (truncate it to half, or flip the bytes of its first 64). Returns the
    damaged path. The step's manifest is left intact on purpose:
    verification catching the damage is the recovery under test."""
    step_dir = os.path.join(directory, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f'no checkpoint step dir {step_dir}')
    largest, size = None, -1
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            p = os.path.join(root, name)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
    if largest is None:
        raise FileNotFoundError(f'checkpoint step dir {step_dir} is empty')
    with open(largest, 'r+b') as f:
        if mode == 'truncate':
            f.truncate(max(1, size // 2))
        else:
            head = f.read(min(64, size))
            f.seek(0)
            f.write(bytes(b ^ 0xFF for b in head))
    return largest
