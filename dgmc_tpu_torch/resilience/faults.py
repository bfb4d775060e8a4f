"""Deterministic, flag-driven fault injection.

The port's copy of ``dgmc_tpu/resilience/faults.py``. Faults are armed
from the CLI (``--inject-fault SPEC``, repeatable) and fire at exact,
reproducible points:

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
``peer-death@N`` /     a rank dies at epoch N: write a control-plane
``peer-death@N:H``     tombstone for rank H (default: this rank) then
                       ``SIGKILL`` self — the supervisor must classify it
                       as a *distributed* failure and shrink the world
``straggler@N:MS``     sleep MS milliseconds (default 1000) before every
                       epoch >= N — a persistently slow rank (a
                       *condition*: it re-fires every epoch, unledgered)
``coord-partition@N``  from epoch N on, write no control-plane
                       heartbeats: the rank looks dead to its peers while
                       still running; heals on restart (ledgered)
``collective-stall@N``/ sleep S seconds (default 3600) INSIDE the epoch-N
``collective-stall@N:S`` fence — the wedged-collective stand-in the fence
                       deadline must turn into a ``hang_report.json`` and
                       a ``FENCE_TIMEOUT_RC`` exit
=====================  ==================================================

JAX's ``download-fail`` needs the dataset downloads, which the port does
not have (they need a network); :func:`parse_spec` refuses it by name
(:data:`NOT_PORTED`), never ignoring it silently.

**Fire once across restarts.** A resumed run replays its schedule from
the checkpoint; a ``sigkill@5`` that fired again on the replayed epoch 5
would crash forever. The process-killing, fence and checkpoint faults
record themselves in ``<state_dir>/faults_fired.json`` the moment they
fire (before the kill), and a restarted process skips them. The CLIs
place the ledger with :func:`ledger_dir` (the checkpoint directory, else
the obs root above a supervised attempt's ``attempt_<k>``, else the
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
_STEP_KINDS = ('raise', 'sigterm', 'sigkill', 'stall', 'peer-death',
               'coord-partition')
_CKPT_KINDS = ('ckpt-truncate', 'ckpt-corrupt')
#: Fence-scoped kinds (fire inside the fence guard, once).
_FENCE_KINDS = ('collective-stall',)
#: Condition kinds: persistent states, not events — unledgered, re-fire
#: deliberately (a straggler is slow on every epoch, replays included).
_CONDITION_KINDS = ('straggler',)
KINDS = _STEP_KINDS + _CKPT_KINDS + _FENCE_KINDS + _CONDITION_KINDS + \
    ('nan-grads',)
#: Kinds that take ``:arg`` (a duration; ``peer-death``'s a rank).
_ARG_KINDS = ('stall', 'collective-stall', 'straggler', 'peer-death')
#: The JAX package's kinds the port refuses, and what they wait for.
NOT_PORTED = {
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
        if kind not in _ARG_KINDS:
            raise ValueError(f'{text!r}: only {", ".join(_ARG_KINDS)} '
                             f'take an argument')
        # peer-death's argument is a rank, not a duration.
        arg = int(arg) if kind == 'peer-death' else float(arg)
    elif kind in ('stall', 'collective-stall'):
        arg = 3600.0
    elif kind == 'straggler':
        arg = 1000.0   # milliseconds of lag per epoch
    return FaultSpec(kind, step, arg)


def add_fault_args(parser):
    """Register ``--inject-fault`` on an argparse parser."""
    parser.add_argument(
        '--inject-fault', '--inject_fault', dest='inject_fault',
        action='append', default=[], metavar='SPEC',
        help='deterministic fault injection (repeatable): raise@N, '
             'sigterm@N, sigkill@N, stall@N[:SEC], nan-grads@N, '
             'ckpt-truncate@N, ckpt-corrupt@N, peer-death@N[:RANK], '
             'straggler@N:MS, coord-partition@N, '
             'collective-stall@N[:SEC]. Process-killing, fence and '
             'checkpoint faults fire once across supervised restarts (a '
             'ledger in the checkpoint or obs dir); nan-grads replays '
             'deterministically; straggler re-fires every epoch by '
             'design. See dgmc_tpu_torch/resilience/faults.py')
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
        control_dir: the control-plane directory
            (``distributed_guard.control_dir(obs_dir)``) where
            ``peer-death`` writes its tombstone; defaults to
            ``<state_dir>/control`` when there is a ledger dir.
        host_index: this rank — the default tombstone target of
            ``peer-death@N`` and the identity ``coord-partition``
            silences.
    """

    def __init__(self, specs=(), state_dir=None, control_dir=None,
                 host_index=0):
        self.specs = [s if isinstance(s, FaultSpec) else parse_spec(s)
                      for s in (specs or ())]
        self._state_dir = state_dir
        self._control_dir = control_dir or (
            os.path.join(state_dir, 'control') if state_dir else None)
        self.host_index = int(host_index)
        #: Set once ``coord-partition`` fires; :class:`~dgmc_tpu_torch.
        #: resilience.distributed_guard.HostChannel` checks it before
        #: every heartbeat write. Always starts False: a ledgered
        #: partition does not fire again after a restart, so the restart
        #: heals it (the restart is the recovery under test).
        self.coord_partitioned = False
        self._fired = set(self._load_ledger())

    @classmethod
    def from_args(cls, args, state_dir=None, control_dir=None,
                  host_index=0):
        return cls(getattr(args, 'inject_fault', ()) or (),
                   state_dir=state_dir, control_dir=control_dir,
                   host_index=host_index)

    def __bool__(self):
        return bool(self.specs)

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
        so a killed and restarted run does not fire it again. Condition
        kinds (``straggler``) re-fire on every step >= N by design — a
        slow rank is slow on replays too."""
        for spec in self.specs:
            if spec.kind == 'straggler' and spec.step <= step:
                time.sleep(spec.arg / 1000.0)
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
            if spec.kind == 'coord-partition':
                # From here on this rank writes no heartbeats: it looks
                # dead to its peers while still computing.
                self.coord_partitioned = True
                continue
            if spec.kind == 'peer-death':
                host = self.host_index if spec.arg is None \
                    else int(spec.arg)
                if self._control_dir:
                    from dgmc_tpu_torch.resilience.distributed_guard \
                        import write_tombstone
                    write_tombstone(self._control_dir, host, step=step)
            os.kill(os.getpid(), signal.SIGTERM
                    if spec.kind == 'sigterm' else signal.SIGKILL)
            # A handler that swallowed the signal must not let the run go
            # on as if nothing happened.
            time.sleep(30)
            raise FaultInjected(
                f'{spec.key} delivered but the process survived')

    def before_fence(self, step):
        """Fire any armed fence-scoped fault for ``step`` — called by
        :meth:`RunObserver.fence_devices
        <dgmc_tpu_torch.obs.run.RunObserver.fence_devices>` INSIDE its
        deadline guard, so a ``collective-stall`` is seen by exactly the
        machinery that must turn it into a ``hang_report.json``."""
        for spec in self.specs:
            if spec.kind not in _FENCE_KINDS or spec.step != step \
                    or spec.key in self._fired:
                continue
            self._mark_fired(spec)
            print(f'[faults] firing {spec.key} inside the step-{step} '
                  f'fence', file=sys.stderr, flush=True)
            time.sleep(spec.arg)

    def after_checkpoint(self, ckpt, step):
        """Damage the just-saved step when a ``ckpt-*@step`` fault is
        armed; ``ckpt`` is a
        :class:`~dgmc_tpu_torch.train.checkpoint.Checkpointer` (the save
        may be asynchronous: the damage waits for the commit)."""
        for spec in self.specs:
            if spec.kind not in _CKPT_KINDS or spec.step != step \
                    or spec.key in self._fired:
                continue
            ckpt.wait_until_finished()
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
