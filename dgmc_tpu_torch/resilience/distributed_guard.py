"""The distributed control plane: heartbeats, tombstones, the ledger, fences.

The port of the JAX package's ``dgmc_tpu/resilience/distributed_guard.py``,
with its names, file names, JSON fields and :data:`FENCE_TIMEOUT_RC`. A
JAX "host" is a rank of the port: one process driving one card, its
index the rank (``--process_id``). Three pieces that work while a
collective is wedged — and that therefore import no torch:

- :class:`HostChannel` — a per-rank heartbeat side channel under the obs
  directory (``<obs>/control/host_<i>.json``, atomic tmp+rename, a
  daemon refresher thread keeps it fresh while the rank lives). Peers
  read each other's files: a stale file means the *process* died
  (peer death — the refresher thread dies with it); a step counter that
  stops advancing while the file stays fresh means a straggler or a
  wedged collective. :meth:`HostChannel.dead_peers` /
  :meth:`HostChannel.stragglers` are the detection queries the
  supervisor and the fence guard share.
- :class:`RecoveryLedger` — one shared decision file
  (``<obs-root>/control/ledger.json``) with **rank-0 leadership**: only
  the leader writes, every rank reads, so all ranks agree on the attempt
  number and the (possibly shrunk) world before rejoining. Followers
  :meth:`~RecoveryLedger.wait_for_attempt` instead of guessing.
- :class:`FenceGuard` — a deadline on one *blocking* section (an epoch
  fence's collective, ``init_process_group``'s rendezvous). A fence that
  misses its deadline dumps ``hang_report.json`` naming the fence's
  phase/step and the ranks that never reached it (from the channel's
  last-fence records), then exits with :data:`FENCE_TIMEOUT_RC`: a
  process blocked in one C++ collective cannot be unblocked from Python,
  and an attributable death is what the supervisor needs.

The supervisor (:mod:`~dgmc_tpu_torch.resilience.supervisor`) consumes
all three: stale peer heartbeats and peer-death tombstones
(:mod:`~dgmc_tpu_torch.resilience.faults`' ``peer-death@N``) classify a
failure as *distributed*, and a distributed failure triggers an
**elastic restart** — halve the shard flag and the world, record the
decision in the ledger, resume from the latest checkpoint (the port's
train state is replicated, so any world restores it as saved).
"""

import json
import os
import sys
import threading
import time

from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['HostChannel', 'RecoveryLedger', 'LedgerError', 'FenceGuard',
           'control_dir', 'control_root', 'write_tombstone',
           'read_tombstones', 'read_heartbeats', 'FENCE_TIMEOUT_RC',
           'CONTROL_DIRNAME', 'LEDGER_FILE']

#: Subdirectory of an obs dir holding the control-plane files. Heartbeats
#: and tombstones live under the *attempt* obs dir (liveness is
#: per-attempt); the ledger lives under the obs ROOT (decisions span
#: attempts) — see :func:`control_root`.
CONTROL_DIRNAME = 'control'
LEDGER_FILE = 'ledger.json'

#: Exit code of a process whose :class:`FenceGuard` deadline fired. Kept
#: far from the shell/timeout conventions (124/125/126/127) and from
#: 128+signal so the supervisor can classify it unambiguously as a
#: distributed failure (``exit:67`` → elastic restart, not plain retry).
FENCE_TIMEOUT_RC = 67

#: Default refresher cadence of the heartbeat daemon thread.
DEFAULT_BEAT_INTERVAL_S = 1.0

_HOST_FILE = 'host_{}.json'
_TOMBSTONE_FILE = 'host_{}.tombstone.json'


def control_dir(obs_dir):
    """The control-plane directory of one run/attempt's obs dir."""
    return os.path.join(obs_dir, CONTROL_DIRNAME)


def control_root(obs_dir):
    """The obs ROOT's control dir — where the ledger lives. A supervised
    child's ``--obs-dir`` is rewritten to ``<root>/attempt_<k>``; ledger
    decisions must span attempts, so the attempt suffix is stripped
    (as :func:`~dgmc_tpu_torch.resilience.faults.ledger_dir` does)."""
    from dgmc_tpu_torch.resilience.supervisor import is_attempt_dirname
    base = os.path.basename(os.path.normpath(obs_dir))
    if is_attempt_dirname(base):
        return control_dir(os.path.dirname(os.path.normpath(obs_dir)))
    return control_dir(obs_dir)


def host_heartbeat_path(cdir, host_index):
    return os.path.join(cdir, _HOST_FILE.format(int(host_index)))


def tombstone_path(cdir, host_index):
    return os.path.join(cdir, _TOMBSTONE_FILE.format(int(host_index)))


def write_tombstone(cdir, host_index, step=None, reason='peer-death'):
    """Declare rank ``host_index`` dead (the ``peer-death@N`` fault and
    any orderly shutdown path use this): peers and the supervisor treat
    a tombstone as definitive, no staleness argument needed."""
    path = tombstone_path(cdir, host_index)
    write_json_atomic(path, {
        'host': int(host_index), 'pid': os.getpid(),
        'time': round(time.time(), 3), 'step': step, 'reason': reason,
    }, indent=1)
    return path


def read_tombstones(cdir):
    """``{host_index: record}`` for every tombstone in ``cdir``."""
    out = {}
    try:
        names = os.listdir(cdir)
    except OSError:
        return out
    for name in names:
        if not name.endswith('.tombstone.json'):
            continue
        try:
            with open(os.path.join(cdir, name)) as f:
                rec = json.load(f)
            out[int(rec['host'])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def read_heartbeats(cdir):
    """``{host_index: record}`` for every rank heartbeat in ``cdir``."""
    out = {}
    try:
        names = os.listdir(cdir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith('host_') and name.endswith('.json')
                and not name.endswith('.tombstone.json')):
            continue
        stem = name[len('host_'):-len('.json')]
        if not stem.isdigit():
            continue
        try:
            with open(os.path.join(cdir, name)) as f:
                out[int(stem)] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


class HostChannel:
    """This rank's heartbeat writer + the peer-state reader.

    Args:
        obs_dir: the run's obs directory (the *attempt* dir under a
            supervisor, shared by the world's ranks); heartbeats land in
            ``<obs_dir>/control/``.
        host_index: this rank (0 = leader).
        num_hosts: the world size (recorded for readers; a reader must
            not infer it from the file count while ranks still start).
        fault_plan: optional
            :class:`~dgmc_tpu_torch.resilience.faults.FaultPlan`; once
            its ``coord-partition`` fault has fired, every write is
            suppressed — the rank *looks* dead to its peers while still
            running, which is the partition being simulated.
        interval_s: refresher-thread cadence (:meth:`start`).
    """

    def __init__(self, obs_dir, host_index=0, num_hosts=1,
                 fault_plan=None, interval_s=DEFAULT_BEAT_INTERVAL_S):
        self.dir = control_dir(obs_dir)
        self.host_index = int(host_index)
        self.num_hosts = int(num_hosts)
        self.interval_s = float(interval_s)
        self._plan = fault_plan
        self._lock = threading.Lock()
        # The refresher and the caller's beats share one tmp file name
        # (write_json_atomic's is per process): one write at a time.
        self._write_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._phase = 'startup'
        self._step = None
        self._last_fence = None
        os.makedirs(self.dir, exist_ok=True)

    @property
    def path(self):
        return host_heartbeat_path(self.dir, self.host_index)

    # -- writing -----------------------------------------------------------

    def _partitioned(self):
        return bool(getattr(self._plan, 'coord_partitioned', False))

    def _write(self):
        if self._partitioned():
            return False
        with self._lock:
            payload = {
                'host': self.host_index,
                'pid': os.getpid(),
                'time': round(time.time(), 3),
                'phase': self._phase,
                'step': self._step,
                'last_fence': self._last_fence,
                'mesh': {'hosts': self.num_hosts},
            }
        with self._write_lock:
            return write_json_atomic(self.path, payload, indent=1,
                                     quiet=True)

    def beat(self, phase, step=None):
        """Record this rank's current activity and refresh the file."""
        with self._lock:
            self._phase = phase
            if step is not None:
                self._step = step
        self._write()

    def record_fence(self, phase, step):
        """Record a *completed* fence — the attribution a hang report
        needs: a peer whose ``last_fence`` is behind the fence that
        timed out is precisely the missing rank."""
        with self._lock:
            self._last_fence = {'phase': phase, 'step': step,
                                'time': round(time.time(), 3)}
            if step is not None:
                self._step = step
        self._write()

    def start(self):
        """Write the first heartbeat and start the refresher thread.
        The thread only refreshes the timestamp — liveness means *the
        process is alive*, so peer-death detection keys on staleness
        (the thread dies with the process) while wedged-collective
        detection is the fence guard's job, not staleness."""
        self._write()
        self._thread = threading.Thread(
            target=self._refresh, name='dgmc-host-channel', daemon=True)
        self._thread.start()
        return self

    def _refresh(self):
        while not self._stop.wait(self.interval_s):
            self._write()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 2 + 1.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- reading -----------------------------------------------------------

    def peers(self):
        """``{host_index: heartbeat_record}`` including this rank."""
        return read_heartbeats(self.dir)

    def tombstones(self):
        return read_tombstones(self.dir)

    def dead_peers(self, stale_s, now=None):
        """Ranks that must be presumed dead: tombstoned, or their
        heartbeat file went stale (the refresher thread died with the
        process). Ranks that never wrote a file are *absent*, not dead —
        they may still be starting; the fence guard's deadline bounds
        that doubt."""
        now = time.time() if now is None else now
        dead = dict(self.tombstones())
        for host, rec in self.peers().items():
            if host == self.host_index or host in dead:
                continue
            age = now - rec.get('time', 0)
            if age > stale_s:
                dead[host] = dict(rec, stale_s=round(age, 3))
        return dead

    def stragglers(self, behind_steps=1):
        """Ranks whose step counter lags the front of the pack by more
        than ``behind_steps`` (fresh heartbeats only — a stale rank is
        dead, not slow)."""
        peers = {h: r for h, r in self.peers().items()
                 if r.get('step') is not None}
        if len(peers) < 2:
            return {}
        ahead = max(r['step'] for r in peers.values())
        return {h: dict(r, behind=ahead - r['step'])
                for h, r in peers.items()
                if ahead - r['step'] > behind_steps}


class LedgerError(RuntimeError):
    """A non-leader tried to write the recovery ledger."""


class RecoveryLedger:
    """The shared recovery-decision file, rank-0 leadership.

    Every rank's supervisor must agree on the attempt number and the
    world before rejoining a shrunk run — two ranks restarting with
    different ``--row_shards`` would wedge (or refuse) the very first
    rendezvous. Only the **leader** (rank 0's supervisor) writes;
    followers read, or block in :meth:`wait_for_attempt` until the
    leader has published the decision for their next attempt. The
    decision's ``mesh`` is ``{'shards': N}``: in the port a shard count
    equals the world size, so it names the next attempt's world.
    """

    def __init__(self, root_dir, host_index=0):
        self.dir = root_dir
        self.host_index = int(host_index)
        self.path = os.path.join(root_dir, LEDGER_FILE)

    @property
    def is_leader(self):
        return self.host_index == 0

    def read(self):
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {'attempt': None, 'mesh': None, 'decisions': []}

    def decide(self, attempt, reason, mesh=None, dead_hosts=(),
               detail=None):
        """Publish the decision for ``attempt`` (leader only): why the
        previous attempt ended, the mesh the next one runs on, and which
        ranks are excluded. Atomic rewrite — a follower sees the old
        complete decision or the new one, never a torn file."""
        if not self.is_leader:
            raise LedgerError(
                f'host {self.host_index} is not the ledger leader '
                f'(host 0 decides; followers wait_for_attempt)')
        ledger = self.read()
        decision = {
            'attempt': int(attempt),
            'time': round(time.time(), 3),
            'reason': reason,
            'mesh': mesh,
            'dead_hosts': sorted(int(h) for h in dead_hosts),
            'detail': detail,
        }
        ledger['attempt'] = int(attempt)
        ledger['mesh'] = mesh
        decisions = ledger.setdefault('decisions', [])
        decisions.append(decision)
        write_json_atomic(self.path, ledger, indent=1)
        return decision

    def wait_for_attempt(self, attempt, timeout_s, poll_s=0.2):
        """Follower path: block until the leader has published a
        decision for ``attempt`` (or newer). Returns the ledger dict, or
        ``None`` on timeout — a follower that cannot see a decision must
        not invent its own world size."""
        deadline = time.time() + timeout_s
        while True:
            ledger = self.read()
            if ledger.get('attempt') is not None \
                    and ledger['attempt'] >= attempt:
                return ledger
            if time.time() >= deadline:
                return None
            time.sleep(poll_s)


class FenceGuard:
    """Deadline on one blocking section; miss → report → exit.

    Usage::

        with FenceGuard(report_path, deadline_s=120.0,
                        phase='epoch-fence', step=epoch,
                        channel=host_channel):
            dist.all_reduce(flag)   # the blocking collective

    If the block does not exit within ``deadline_s``, a timer thread
    writes ``hang_report.json`` — reason ``fence-deadline``, the fence's
    phase/step, every peer's last completed fence, and the ranks that
    never reached this fence — then calls ``os._exit(FENCE_TIMEOUT_RC)``
    (``on_timeout='exit'``). Exiting is deliberate: a process blocked in
    one C++ collective or rendezvous cannot be unblocked from Python, and
    a prompt, attributable death is what the supervisor's elastic restart
    needs.

    ``on_timeout='report'`` only writes the report (tests, and callers
    that have their own kill path). The guard is reusable but not
    reentrant; entering arms a fresh timer, a clean exit cancels it.

    A section whose collective *raised* instead (gloo raises when a peer
    drops the connection, where NCCL and XLA block) can never complete
    either: :meth:`expire` holds it until the deadline fires, so that
    both behaviours end the same way.
    """

    def __init__(self, report_path, deadline_s, phase, step=None,
                 channel=None, on_timeout='exit', context_fn=None,
                 on_dump=None):
        if on_timeout not in ('exit', 'report'):
            raise ValueError(f'on_timeout must be "exit" or "report", '
                             f'got {on_timeout!r}')
        self.report_path = report_path
        self.deadline_s = float(deadline_s)
        self.phase = phase
        self.step = step
        self.channel = channel
        self.on_timeout = on_timeout
        self._context_fn = context_fn
        #: Anomaly fan-out (the flight recorder's fence-timeout
        #: trigger): called with the report's reason string after the
        #: report is written, BEFORE any os._exit — the last code this
        #: process runs, so it must never raise (and is wrapped anyway).
        self._on_dump = on_dump
        self._timer = None
        self._entered_at = None
        self._lock = threading.Lock()
        self._completed = False
        self._fired_event = threading.Event()
        self._error = None
        self.fired = False

    def _missing_hosts(self):
        """Peers that never completed this fence — the attribution."""
        if self.channel is None:
            return []
        out = []
        now = time.time()
        for host, rec in sorted(self.channel.peers().items()):
            if host == self.channel.host_index:
                continue
            fence = rec.get('last_fence') or {}
            reached = (fence.get('phase') == self.phase
                       and fence.get('step') is not None
                       and self.step is not None
                       and fence['step'] >= self.step)
            if not reached:
                out.append({
                    'host': host,
                    'phase': rec.get('phase'),
                    'step': rec.get('step'),
                    'last_fence': fence or None,
                    'heartbeat_age_s': round(now - rec.get('time', 0), 3),
                })
        for host, tomb in sorted(self.channel.tombstones().items()):
            out.append({'host': host, 'dead': True,
                        'tombstone': tomb})
        return out

    def _fire(self):
        # A fence that completed right AT the deadline races the timer
        # thread — Timer.cancel() is a no-op once the callback started.
        # The completed flag (set first thing in __exit__, same lock)
        # keeps a just-successful fence from being reported dead and
        # os._exit()ing a healthy run.
        with self._lock:
            if self._completed:
                return
            self.fired = True
        now = time.time()
        # Late import: obs.watchdog imports no torch either.
        from dgmc_tpu_torch.obs.watchdog import thread_stacks
        report = {
            'reason': f'fence-deadline: {self.phase} incomplete after '
                      f'{self.deadline_s}s',
            'time': now,
            'pid': os.getpid(),
            'argv': sys.argv,
            'deadline_s': self.deadline_s,
            'stalled_for_s': round(now - (self._entered_at or now), 3),
            'in_flight': {'phase': 'fence', 'name': self.phase,
                          'since_s': round(
                              now - (self._entered_at or now), 3)},
            'fence': {'phase': self.phase, 'step': self.step},
            'missing_hosts': self._missing_hosts(),
            'threads': thread_stacks(),
        }
        if self._context_fn is not None:
            try:
                report['context'] = self._context_fn()
            except Exception:
                pass
        if self._error is not None:
            report['context'] = dict(report.get('context') or {},
                                     collective_error=self._error)
        write_json_atomic(self.report_path, report, indent=1, quiet=True)
        if self._on_dump is not None:
            try:
                self._on_dump(report['reason'])
            except Exception:
                pass
        self._fired_event.set()
        if self.on_timeout == 'exit':
            os._exit(FENCE_TIMEOUT_RC)

    def expire(self, error):
        """The guarded section raised ``error`` and can never complete:
        record it (the report's ``context.collective_error``) and wait
        for the deadline to fire. Under ``on_timeout='exit'`` the process
        ends there; otherwise this returns once the report is written
        and the caller re-raises."""
        self._error = f'{type(error).__name__}: {error}'
        self._fired_event.wait()

    def __enter__(self):
        self._entered_at = time.time()
        with self._lock:
            self._completed = False
            self.fired = False
        self._fired_event.clear()
        self._error = None
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._completed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return False
