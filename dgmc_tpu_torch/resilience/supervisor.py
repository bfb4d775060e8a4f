"""Fault-tolerant run supervisor: detect → kill → resume → degrade.

The port of the JAX package's ``dgmc_tpu/resilience/supervisor.py``.
``--supervise`` re-runs the same CLI command in a child process and
closes the detection → recovery loop:

- **Crash / preemption** (nonzero exit, death by signal — what a
  scheduler preemption or an injected ``sigkill@N`` looks like): restart
  from the latest checkpoint (the CLIs resume through ``--ckpt_dir``)
  after a bounded exponential backoff.
- **Hang**: the child's watchdog heartbeat
  (``<obs>/attempt_<k>/heartbeat.json``, or any rank's
  ``<obs>/attempt_<k>/host_<i>/heartbeat.json``) goes stale past the
  deadline, or a deadline or fence-deadline ``hang_report.json``
  appears. A child that advertises a live-plane port in its heartbeat
  (``--obs-port``) is judged by its ``/healthz`` first — the same
  staleness verdict, evaluated by the child's own plane — with the file
  heartbeat as the fallback whenever the scrape fails; a 503 kills the
  child as ``healthz-stale``. The supervisor SIGTERMs the child,
  escalates to SIGKILL after a grace period (a stopped process keeps
  SIGTERM pending), and restarts.
- **Repeated failure at the same step**: a degradation ladder rewrites
  the child's command before the next restart: ``--f32`` (the bf16
  policy off), then halving the shard flag (shrink the mesh).
- **Distributed failure → elastic restart**: a dead peer rank (stale
  control-plane heartbeat or a ``peer-death`` tombstone — see
  :mod:`~dgmc_tpu_torch.resilience.distributed_guard`), a fence that
  exited ``FENCE_TIMEOUT_RC``, or a watchdog-caught hang means the
  world broke, not the program. The supervisor halves ``--row_shards`` /
  ``--model_shards`` and ``--num_processes`` together at once (in the
  port a shard count equals the world size), publishes the attempt
  number and the new shard count to the rank-0 recovery ledger so every
  rank rejoins in agreement, and restarts from the latest checkpoint
  (the port's train state is replicated: a smaller world restores the
  save as it is). ``--no-elastic`` opts out.
- **Budget**: ``--max-restarts`` bounds the loop; exhausting it records
  ``outcome: gave-up`` and exits nonzero with the last failure's
  evidence on disk.

A JAX host is a rank of the port (one process, one card): multi-rank
runs start one supervisor per rank, each with its child's
``--process_id`` as its host index, all over one obs root. The attempt
directories ``<obs>/attempt_<k>/`` and their ``control/`` are shared
(the ranks' children write ``host_<i>/`` inside). Rank 0 leads: its
``<obs>/recovery.json`` is the run's record (the file ``obs.report`` and
``obs.diff`` read), and it alone writes ``<obs>/control/ledger.json``.
A follower keeps its own record at ``<obs>/host_<i>/recovery.json``,
waits for the leader's decision before each restart, adopts its shard
count, and **retires** (outcome ``retired``, exit 0) when its rank falls
outside the new world. A world of one needs no rendezvous: shrinking to
it drops ``--coordinator`` and ``--process_id`` and sets
``--num_processes 1``, so the remaining rank restarts as one process.

JAX's ``disable-fused`` rung has no counterpart: the port's kernel gates
run their plain versions only for CPU tensors, so no restart on the card
trades a kernel for plain PyTorch. A kernel that fails on the card fails
every attempt, and the budget runs out with its evidence on disk. A
ladder that names the rung drops it.

The monitor is a plain host process: it never creates a CUDA context
(each CLI's ``main`` branches here before anything touches the device),
so the card's memory belongs to the child alone across restarts.
"""

import json
import os
import signal
import subprocess
import sys
import time

from dgmc_tpu_torch.resilience.faults import LEDGER_ENV
from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['Supervisor', 'add_supervisor_args', 'strip_supervisor_args',
           'supervise_cli', 'attempt_dirname', 'is_attempt_dirname',
           'mesh_size', 'recovery_path', 'LADDER_RUNGS', 'DEFAULT_LADDER',
           'DEFAULT_MAX_RESTARTS', 'DEFAULT_HANG_DEADLINE_S',
           'DEFAULT_PEER_STALE_S', 'RECOVERY_FILE']

DEFAULT_MAX_RESTARTS = 5
#: Watchdog deadline given to supervised children that have an obs dir
#: but no ``--watchdog-deadline`` of their own.
DEFAULT_HANG_DEADLINE_S = 600.0
#: How stale a PEER rank's control-plane heartbeat may go before the
#: supervisor declares that rank dead and elastically restarts. The
#: heartbeat refresher writes every ~1 s while its process lives, so this
#: only needs to outlast filesystem jitter — it is NOT a progress
#: deadline (that is the watchdog's and the fence guard's job).
DEFAULT_PEER_STALE_S = 15.0
RECOVERY_FILE = 'recovery.json'
#: The per-attempt obs subdirectory naming contract: the supervisor
#: writes these, ``faults.ledger_dir`` parses them.
ATTEMPT_PREFIX = 'attempt_'


def attempt_dirname(k):
    return f'{ATTEMPT_PREFIX}{k}'


def is_attempt_dirname(name):
    return (name.startswith(ATTEMPT_PREFIX)
            and name[len(ATTEMPT_PREFIX):].isdigit())


def recovery_path(base_dir, host_index=0):
    """Where rank ``host_index``'s supervisor keeps its record: the
    leader's at ``<base>/recovery.json`` (JAX's place, the file the obs
    readers open), a follower's at ``<base>/host_<i>/recovery.json``."""
    if int(host_index) == 0:
        return os.path.join(base_dir, RECOVERY_FILE)
    return os.path.join(base_dir, f'host_{int(host_index)}', RECOVERY_FILE)


#: "no failure yet" sentinel for same-step tracking — distinct from
#: None, which is a real observation ("died with no step evidence").
_NO_FAILURE = object()

#: Supervisor-only flags (name -> number of value tokens) stripped from
#: the child's argv: the child must run unsupervised or it would recurse.
_OWN_FLAGS = {
    '--supervise': 0,
    '--max-restarts': 1, '--max_restarts': 1,
    '--restart-backoff': 1, '--restart_backoff': 1,
    '--no-elastic': 0, '--no_elastic': 0,
}


def add_supervisor_args(parser):
    """Register ``--supervise`` / ``--max-restarts`` /
    ``--restart-backoff`` / ``--no-elastic`` on an argparse parser."""
    parser.add_argument(
        '--supervise', action='store_true',
        help='run this command under the fault-tolerant supervisor: the '
             'run executes in a child process; on crash, preemption or '
             'hang (/healthz 503, watchdog heartbeat stale or '
             'hang_report.json) the child is killed and restarted from '
             'the latest checkpoint with exponential backoff and a '
             'degradation ladder (the f32 policy where the CLI has one, '
             'then shrink the mesh). Multi-rank runs start one '
             'supervisor per rank over one --obs-dir (the host index is '
             '--process_id). Recovery timeline: <obs-dir>/recovery.json')
    parser.add_argument(
        '--max-restarts', '--max_restarts', dest='max_restarts', type=int,
        default=DEFAULT_MAX_RESTARTS, metavar='N',
        help='restart budget under --supervise (default %(default)s); '
             'exhausting it exits nonzero with outcome "gave-up"')
    parser.add_argument(
        '--restart-backoff', '--restart_backoff', dest='restart_backoff',
        type=float, default=1.0, metavar='SEC',
        help='base of the exponential restart backoff (default '
             '%(default)s s, doubling per restart, capped at 60 s)')
    parser.add_argument(
        '--no-elastic', '--no_elastic', dest='elastic',
        action='store_false', default=True,
        help='disable elastic restarts under --supervise: by default a '
             'DISTRIBUTED failure (peer death, stale peer heartbeat, '
             'fence-deadline exit, watchdog hang) immediately halves '
             '--row_shards / --model_shards with --num_processes, '
             'records the decision in the control-plane ledger, and '
             'resumes from the latest checkpoint on the smaller world '
             '(ranks outside it retire)')
    return parser


def strip_supervisor_args(argv):
    """argv minus the supervisor's own flags (child command line)."""
    return _drop_flags(argv, _OWN_FLAGS)


def _drop_flags(argv, flags):
    """argv without ``flags`` (name -> number of value tokens), in either
    spelling, ``--flag V`` or ``--flag=V``."""
    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        name = tok.split('=', 1)[0]
        if name in flags:
            i += 1 + (0 if '=' in tok else flags[name])
            continue
        out.append(tok)
        i += 1
    return out


def _replace_flag_value(argv, names, value):
    """Return argv with flag ``names``'s value replaced (appended when
    absent). Handles both ``--flag V`` and ``--flag=V``."""
    out, i, done = [], 0, False
    while i < len(argv):
        tok = argv[i]
        name = tok.split('=', 1)[0]
        if name in names:
            out.append(f'{name}={value}' if '=' in tok else name)
            if '=' not in tok:
                out.append(str(value))
                i += 1
            done = True
            i += 1
            continue
        out.append(tok)
        i += 1
    if not done:
        out.extend([names[0], str(value)])
    return out


def _flag_value(argv, names):
    for i, tok in enumerate(argv):
        name, _, inline = tok.partition('=')
        if name in names:
            if inline:
                return inline
            if i + 1 < len(argv):
                return argv[i + 1]
    return None


# -- degradation ladder ----------------------------------------------------

def _rung_force_f32(argv, env):
    # Already-f32 runs (--f32, --precision f32, --precision=f32) get no
    # rung: a no-op rewrite would burn a ladder slot.
    if '--f32' in argv or _flag_value(argv, ('--precision',)) == 'f32':
        return argv, env, None
    return argv + ['--f32'], env, '--f32 (bf16 policy off)'


#: Mesh-size flag families the shrink rung (and the elastic restart)
#: knows how to halve — the correspondence sharding and the
#: partition-rule streamed layout.
_MESH_FLAGS = (('--model_shards', '--model-shards'),
               ('--row_shards', '--row-shards'))
#: The world's flags (``parallel.distributed.add_distributed_args``).
_WORLD_FLAG = ('--num_processes', '--num-processes')
_RENDEZVOUS_FLAGS = {'--coordinator': 1, '--process_id': 1,
                     '--process-id': 1}


def _set_mesh(argv, names, shards):
    """argv with the shard flag ``names`` at ``shards`` and, where the
    command names its world (``--num_processes``), the world resized
    with it: a shard count equals the world size in the port. A world
    of one needs no rendezvous, so ``--coordinator`` and
    ``--process_id`` go."""
    argv = _replace_flag_value(argv, names, shards)
    if _flag_value(argv, _WORLD_FLAG) is not None:
        argv = _replace_flag_value(argv, _WORLD_FLAG, shards)
        if int(shards) == 1:
            argv = _drop_flags(argv, _RENDEZVOUS_FLAGS)
    return argv


def _rung_shrink_mesh(argv, env):
    for names in _MESH_FLAGS:
        cur = _flag_value(argv, names)
        if cur is None or int(cur) <= 1:
            continue
        new = max(1, int(cur) // 2)
        argv = _set_mesh(argv, names, new)
        return argv, env, f'{names[0]} {cur} -> {new} (shrink the mesh)'
    return argv, env, None


def mesh_size(argv):
    """The current mesh-shard count named by ``argv`` (or ``None``)."""
    for names in _MESH_FLAGS:
        cur = _flag_value(argv, names)
        if cur is not None:
            return int(cur)
    return None


#: name -> rewrite(argv, env) -> (argv, env, description-or-None).
LADDER_RUNGS = {
    'f32': _rung_force_f32,
    'shrink-mesh': _rung_shrink_mesh,
}
DEFAULT_LADDER = ('f32', 'shrink-mesh')




class Supervisor:
    """Run ``cmd + argv`` under crash/hang supervision.

    Args:
        cmd: interpreter prefix, e.g. ``[sys.executable, '-m',
            'dgmc_tpu_torch.experiments.dbp15k']``.
        argv: the child's own arguments (already stripped of supervisor
            flags). Its ``--obs-dir`` is rewritten per attempt to
            ``<obs_dir>/attempt_<k>``.
        obs_dir: root obs directory (recovery.json + per-attempt
            telemetry); ``None`` disables hang detection and puts
            recovery.json next to ``ckpt_dir`` (or the cwd).
        ckpt_dir: the run's checkpoint dir (restart = resume); ``None``
            means restarts re-run from scratch.
        hang_deadline_s: child watchdog deadline; a heartbeat older than
            ``STALE_AFTER_FACTOR x`` this is a wedged child. ``None``
            disables the heartbeat watch (hang_report detection stays).
        first_heartbeat_s: how long after spawn a child may go without
            its FIRST heartbeat before it counts as wedged (default
            ``max(4x hang_deadline, 300)``): a child stuck before its
            watchdog thread exists (imports, a rendezvous that a rank
            never joins) writes neither heartbeat nor hang_report.
        ladder: rung names from :data:`LADDER_RUNGS` (others, such as
            JAX's ``disable-fused``, are dropped), applied one per
            escalation after ``same_step_threshold`` failures at the
            same step.
        elastic: perform an **elastic restart** on a *distributed*
            failure (peer death, stale peer heartbeat, fence-deadline
            exit, watchdog hang): halve the shard flag and the world at
            once, publish the decision to the control-plane ledger
            (rank-0 leadership — see
            :mod:`~dgmc_tpu_torch.resilience.distributed_guard`), and
            resume from the latest checkpoint.
        host_index: this supervisor's rank. Rank 0 leads: it writes the
            recovery ledger; followers wait for its decision before
            restarting, so every rank rejoins with the same attempt
            number and world, and retire when their rank falls outside
            it. A follower's record is ``<obs>/host_<i>/recovery.json``
            (:func:`recovery_path`).
        peer_stale_s: staleness bound on PEER control-plane heartbeats
            (``<attempt>/control/host_<i>.json``) before a peer counts
            as dead and the child (blocked in a collective with it) is
            killed.
    """

    def __init__(self, cmd, argv, *, obs_dir=None, ckpt_dir=None,
                 max_restarts=DEFAULT_MAX_RESTARTS, backoff_s=1.0,
                 backoff_max_s=60.0, grace_s=10.0, hang_deadline_s=None,
                 first_heartbeat_s=None, ladder=DEFAULT_LADDER,
                 same_step_threshold=2, poll_s=0.5, env=None,
                 elastic=True, host_index=0,
                 peer_stale_s=DEFAULT_PEER_STALE_S):
        self.cmd = list(cmd)
        self.argv = list(argv)
        self.obs_dir = obs_dir
        self.ckpt_dir = ckpt_dir
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.grace_s = float(grace_s)
        self.hang_deadline_s = hang_deadline_s
        self.first_heartbeat_s = first_heartbeat_s
        self.ladder = [r for r in ladder if r in LADDER_RUNGS]
        self.same_step_threshold = int(same_step_threshold)
        self.poll_s = float(poll_s)
        self._base_env = dict(os.environ if env is None else env)
        self.elastic = bool(elastic)
        self.host_index = int(host_index)
        self.peer_stale_s = float(peer_stale_s)
        self.recovery_path = recovery_path(obs_dir or ckpt_dir or '.',
                                           self.host_index)
        # Children with neither --ckpt_dir nor --obs-dir still need a
        # home for the fire-once fault ledger: the recovery file's
        # directory survives restarts.
        self._base_env.setdefault(
            LEDGER_ENV,
            os.path.dirname(os.path.abspath(self.recovery_path)))
        #: How long a FOLLOWER waits for the leader's ledger decision
        #: before restarting on its own terms (a follower that cannot
        #: see the leader must still make progress eventually).
        self.ledger_wait_s = 30.0
        self._t_created = time.time()
        self._ledger = None
        if obs_dir:
            from dgmc_tpu_torch.resilience.distributed_guard import (
                RecoveryLedger, control_dir)
            self._ledger = RecoveryLedger(control_dir(obs_dir),
                                          host_index=self.host_index)
        self.events = []
        self.attempts = []
        self.degradations = []
        self.elastic_events = []
        self.restarts = 0
        self.outcome = 'running'
        self._stop_signal = None
        #: port -> (scrape_time, verdict) for the /healthz watch.
        self._healthz_cache = {}

    # -- recording ---------------------------------------------------------

    def _event(self, event, **detail):
        rec = {'time': round(time.time(), 3), 'event': event,
               'attempt': len(self.attempts) - 1, **detail}
        self.events.append(rec)
        line = ' '.join(f'{k}={v}' for k, v in detail.items())
        print(f'[supervisor] {event} {line}'.rstrip(),
              file=sys.stderr, flush=True)
        self._write_recovery()

    def _write_recovery(self):
        payload = {
            'tool': 'dgmc_tpu_torch.resilience.supervisor',
            'cmd': self.cmd,
            'argv': self.argv,
            'max_restarts': self.max_restarts,
            'hang_deadline_s': self.hang_deadline_s,
            'outcome': self.outcome,
            'restarts': self.restarts,
            'degradations': self.degradations,
            'elastic': self.elastic_events,
            'attempts': self.attempts,
            'events': self.events,
        }
        # quiet: a supervisor must never die of its own telemetry.
        write_json_atomic(self.recovery_path, payload, indent=1,
                          quiet=True)

    # -- child plumbing ----------------------------------------------------

    def _attempt_dirs(self, k):
        if not self.obs_dir:
            return None, None, None, None
        from dgmc_tpu_torch.resilience.distributed_guard import control_dir
        adir = os.path.join(self.obs_dir, attempt_dirname(k))
        return (adir, os.path.join(adir, 'heartbeat.json'),
                os.path.join(adir, 'hang_report.json'),
                control_dir(adir))

    @staticmethod
    def _candidate_paths(path):
        """The watched file plus its multi-rank homes: a rank of a
        multi-process child writes under ``<attempt>/host_<i>/``
        (``parallel.distributed.host_obs_dir``). Any rank's file counts —
        the straggling rank is exactly the evidence."""
        if not path:
            return []
        adir, name = os.path.split(path)
        out = [path]
        try:
            hosts = [d for d in os.listdir(adir)
                     if d.startswith('host_')
                     and os.path.isdir(os.path.join(adir, d))]
        except OSError:
            hosts = []
        out.extend(os.path.join(adir, d, name) for d in sorted(hosts))
        return out

    def _older_than_session(self, path):
        # 2 s slack: filesystems truncate mtimes, and a file another
        # rank wrote a moment before this supervisor started must
        # survive; stale evidence is minutes to hours old.
        return os.path.getmtime(path) < self._t_created - 2.0

    def _clear_stale_evidence(self, *paths):
        """Drop liveness evidence left in a reused attempt dir by a
        PREVIOUS supervisor run (same ``--obs-dir``; attempt numbering
        restarts at 0): an old deadline ``hang_report.json`` or
        heartbeat would read as this child's and kill it on the first
        poll. The attempt root's files and this rank's ``host_<i>/`` ones
        go unconditionally (no child of this session has written them
        yet); another rank's only when older than this session — its
        monitor may have started the attempt first, and its child's
        evidence is this attempt's."""
        own = f'host_{self.host_index}'
        for path in paths:
            for p in self._candidate_paths(path):
                sub = os.path.basename(os.path.dirname(p))
                try:
                    if p == path or sub == own \
                            or self._older_than_session(p):
                        os.remove(p)
                except OSError:
                    pass

    def _clear_control_dir(self, cdir):
        """Control-plane liveness (rank heartbeats, tombstones) is
        per-attempt like the watchdog heartbeat: a PREVIOUS session's
        files in a reused attempt dir would read as instantly-dead
        peers. Only files older than this supervisor session are
        cleared: another rank's supervisor may reach the attempt first
        and its child may already have written THIS attempt's heartbeats
        or tombstones — wiping those would hide exactly the peer-death
        evidence this session must classify on."""
        if not cdir:
            return
        try:
            names = os.listdir(cdir)
        except OSError:
            return
        for name in names:
            p = os.path.join(cdir, name)
            try:
                if self._older_than_session(p):
                    os.remove(p)
            except OSError:
                pass

    def _child_argv(self, attempt_dir):
        argv = list(self.argv)
        if attempt_dir:
            argv = _replace_flag_value(argv, ('--obs-dir', '--obs_dir'),
                                       attempt_dir)
        return argv

    @staticmethod
    def _read_json(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _healthz_verdict(self, host, port, now):
        """Scrape a child's ``/healthz``: ``True`` = healthy, ``False`` =
        the endpoint says stale (a ``healthy: false`` body, the 503),
        ``None`` = the scrape failed (unreachable, garbage, or a 500
        with no verdict) — fall back to the heartbeat file; a failed
        scrape never condemns the child on its own. A verdict under 1 s
        old is reused."""
        key = (host, port)
        cached = self._healthz_cache.get(key)
        if cached is not None and now - cached[0] < 1.0:
            return cached[1]
        from dgmc_tpu_torch.obs.live import probe_healthz
        res = probe_healthz(port, host=host, timeout_s=2.0)
        verdict = None
        if res is not None:
            code, payload = res
            if 'healthy' in payload:
                verdict = bool(payload['healthy'])
            elif code == 200:
                verdict = True
        self._healthz_cache[key] = (now, verdict)
        return verdict

    def _latest_ckpt_step(self):
        if self.ckpt_dir and os.path.isdir(self.ckpt_dir):
            steps = [int(d) for d in os.listdir(self.ckpt_dir)
                     if d.isdigit()
                     and os.path.isdir(os.path.join(self.ckpt_dir, d))]
            if steps:
                return max(steps)
        return None

    def _steps_completed(self, heartbeat_path, start_step=None):
        """Best evidence of where the attempt died, in global schedule
        units: the heartbeat's step counter (any rank's — the minimum,
        so a straggler counts) is per process and resets on every
        restart, so it is offset by ``start_step`` (the checkpoint step
        the attempt resumed from); a committed checkpoint floors it.
        Fallback: the newest checkpoint step."""
        steps = [hb['steps_completed']
                 for hb in map(self._read_json,
                               self._candidate_paths(heartbeat_path))
                 if hb and hb.get('steps_completed') is not None]
        ck = self._latest_ckpt_step()
        if steps:
            derived = (start_step or 0) + min(steps)
            return derived if ck is None else max(derived, ck)
        return ck

    def _kill(self, proc, reason):
        """SIGTERM (lets the child's watchdog dump its report), grace,
        SIGKILL."""
        self._event('kill', reason=reason, pid=proc.pid)
        try:
            proc.terminate()
            try:
                proc.wait(timeout=self.grace_s)
                return
            except subprocess.TimeoutExpired:
                pass
            proc.kill()
            proc.wait(timeout=self.grace_s)
        except OSError:
            pass

    def _dead_peer(self, cdir):
        """A peer rank the control plane says is dead: tombstoned, or its
        heartbeat refresher stopped (the process died with it). Returns
        ``'host_<i>'`` or ``None``. Ranks that never wrote a heartbeat
        are absent (still starting), not dead — and this rank's OWN child
        is left out of the staleness scan: its liveness is the watchdog
        heartbeat's job, and a delayed write from it must not read as a
        dead *peer* and shrink a healthy world (a tombstone for it still
        counts — tombstones are written deliberately)."""
        if not cdir:
            return None
        from dgmc_tpu_torch.resilience.distributed_guard import (
            read_heartbeats, read_tombstones)
        tombs = read_tombstones(cdir)
        if tombs:
            return f'host_{min(tombs)}'
        beats = read_heartbeats(cdir)
        if len(beats) < 2:
            return None
        now = time.time()
        stale = [h for h, rec in beats.items()
                 if h != self.host_index
                 and now - rec.get('time', 0) > self.peer_stale_s]
        if stale and len(stale) < len(beats):
            return f'host_{min(stale)}'
        return None

    def _dead_peer_tombstone(self, cdir):
        """Post-mortem tombstone check (``'host_<i>'`` or ``None``)."""
        if not cdir:
            return None
        from dgmc_tpu_torch.resilience.distributed_guard import \
            read_tombstones
        tombs = read_tombstones(cdir)
        return f'host_{min(tombs)}' if tombs else None

    def _is_distributed_failure(self, reason):
        """Failures that mean the WORLD broke, not the program: a dead or
        partitioned peer, a fence that missed its deadline, or a wedged
        collective the watchdog/heartbeat layer caught. These trigger the
        elastic restart; ordinary crashes just retry.
        ``no-first-heartbeat`` is deliberately NOT here: a slow start
        looks identical to a rendezvous wedge from this vantage point,
        and halving a healthy world for it is the worse error — the
        rendezvous wedge gets its crisp signal from the fence-guarded
        ``initialize_distributed`` (``exit:FENCE_TIMEOUT_RC``), and
        failing that, the same-step ladder still reaches the shrink
        rung."""
        from dgmc_tpu_torch.resilience.distributed_guard import \
            FENCE_TIMEOUT_RC
        return (reason.startswith(('peer-death', 'hang-report',
                                   'heartbeat-stale', 'healthz-stale'))
                or reason == f'exit:{FENCE_TIMEOUT_RC}')

    def _adopt_ledger_mesh(self, argv, attempt):
        """Follower path: block (bounded) for the leader's decision on
        ``attempt`` and rewrite this rank's shard flag (and world) to the
        decided size. Returns ``(argv, decided shards or None)``."""
        led = self._ledger.wait_for_attempt(
            attempt, timeout_s=self.ledger_wait_s,
            poll_s=min(self.poll_s, 0.2))
        if led is None:
            self._event('ledger-timeout', attempt=attempt,
                        waited_s=self.ledger_wait_s)
            return argv, None
        shards = (led.get('mesh') or {}).get('shards')
        cur = mesh_size(argv)
        if not shards or cur is None or shards == cur:
            return argv, shards
        for names in _MESH_FLAGS:
            if _flag_value(argv, names) is not None:
                argv = _set_mesh(argv, names, shards)
                self._event('ledger-adopt', attempt=attempt,
                            detail=f'{names[0]} {cur} -> {shards} '
                                   f'(leader decision)')
                break
        return argv, shards

    def _outside_world(self, argv, shards):
        """Whether this rank has no place in the next attempt: the
        command names a world (``--num_processes``) and this rank is at
        or above the decided shard count, which is the new world size."""
        if self.host_index == 0 or _flag_value(argv, _WORLD_FLAG) is None:
            return False
        world = shards if shards else mesh_size(argv)
        return world is not None and self.host_index >= int(world)

    def _watch(self, proc, heartbeat_path, hang_report_path,
               control_dir=None):
        """Wait for child exit; return a hang reason if WE killed it."""
        # One health definition: the factor the child's /healthz applies
        # (obs/live.py), so a 503 and a stale file are the same verdict.
        from dgmc_tpu_torch.obs.live import STALE_AFTER_FACTOR
        stale_after = (STALE_AFTER_FACTOR * self.hang_deadline_s
                       if self.hang_deadline_s else None)
        first_beat_by = None
        if stale_after and heartbeat_path:
            first_beat_by = time.time() + (
                self.first_heartbeat_s if self.first_heartbeat_s
                is not None else max(4.0 * self.hang_deadline_s, 300.0))
        while True:
            if self._stop_signal is not None:
                return f'preempted:{self._stop_signal}'
            try:
                proc.wait(timeout=self.poll_s)
                return None
            except subprocess.TimeoutExpired:
                pass
            dead = self._dead_peer(control_dir)
            if dead is not None:
                # The surviving child is (or soon will be) blocked in a
                # collective its dead peer can never join: kill it now
                # and let the elastic restart shrink the world.
                self._kill(proc, f'peer-death:{dead}')
                return f'peer-death:{dead}'
            for path in self._candidate_paths(hang_report_path):
                if not os.path.exists(path):
                    continue
                rep = self._read_json(path) or {}
                # The watchdog also dumps on SIGTERM during shutdown; only
                # a deadline dump (the watchdog's staleness dump, or a
                # fence-deadline dump whose process somehow survived)
                # means "wedged, kill me".
                if str(rep.get('reason', '')).startswith(
                        ('deadline', 'fence-deadline')):
                    self._kill(proc, 'hang-report')
                    return 'hang-report'
            if stale_after and heartbeat_path:
                # Any rank's heartbeat going stale condemns the run — one
                # wedged rank wedges the collective.
                beats = [hb for hb in map(
                    self._read_json,
                    self._candidate_paths(heartbeat_path)) if hb]
                now = time.time()
                for hb in beats:
                    # A heartbeat advertising a live port gets its
                    # verdict from /healthz (immune to file write lag);
                    # the file's age is the fallback when the scrape
                    # fails.
                    port = hb.get('port')
                    verdict = None
                    if port:
                        verdict = self._healthz_verdict(
                            hb.get('host') or '127.0.0.1', port, now)
                    if verdict is True:
                        continue
                    if verdict is False:
                        self._kill(proc, 'healthz-stale')
                        return 'healthz-stale'
                    if now - hb.get('time', 0) > stale_after:
                        self._kill(proc, 'heartbeat-stale')
                        return 'heartbeat-stale'
                # The benefit of the doubt before the first heartbeat is
                # bounded.
                if not beats and first_beat_by \
                        and time.time() > first_beat_by:
                    self._kill(proc, 'no-first-heartbeat')
                    return 'no-first-heartbeat'

    def _on_signal(self, signum, frame):
        self._stop_signal = signal.Signals(signum).name

    # -- the loop ----------------------------------------------------------

    def run(self):
        """Supervise until completion, preemption of the supervisor
        itself, retirement, or an exhausted restart budget. Returns the
        exit code."""
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                break
        try:
            return self._run()
        finally:
            for sig, prev in prev_handlers.items():
                signal.signal(sig, prev)
            self._write_recovery()

    def _preempted(self):
        self.outcome = 'preempted'
        self._event('preempted', signal=self._stop_signal)
        return 128 + getattr(signal, self._stop_signal or 'SIGTERM',
                             signal.SIGTERM)

    def _run(self):
        argv, env = self.argv, dict(self._base_env)
        # Not None: an attempt with no step evidence at all reports
        # steps_completed=None, and repeated no-progress deaths are a
        # "same step" pattern the ladder must escalate on.
        rung_idx, same_step_fails, last_fail_step = 0, 0, _NO_FAILURE
        attempt = 0
        while True:
            attempt_dir, hb_path, hang_path, ctrl_dir = \
                self._attempt_dirs(attempt)
            if attempt_dir:
                os.makedirs(attempt_dir, exist_ok=True)
                self._clear_stale_evidence(hb_path, hang_path)
                self._clear_control_dir(ctrl_dir)
            start_step = self._latest_ckpt_step()
            child_argv = self._child_argv(attempt_dir)
            rec = {'attempt': attempt,
                   'obs_dir': attempt_dir,
                   'argv': child_argv,
                   'env_overrides': {
                       k: v for k, v in env.items()
                       if self._base_env.get(k) != v},
                   'start_time': round(time.time(), 3)}
            self.attempts.append(rec)
            self._event('start', cmd=' '.join(self.cmd + child_argv))
            try:
                proc = subprocess.Popen(self.cmd + child_argv, env=env)
            except OSError as e:
                # A failed fork/exec (EAGAIN under memory pressure) is
                # transient like any crash: backoff and budget, not an
                # instant give-up.
                proc, hang_reason = None, None
                spawn_failure = f'spawn-failed:{type(e).__name__}: {e}'
            else:
                spawn_failure = None
                hang_reason = self._watch(proc, hb_path, hang_path,
                                          ctrl_dir)
                if hang_reason and hang_reason.startswith('preempted'):
                    # Reap the child before recording: its rc and final
                    # step evidence exist only once it is dead.
                    self._kill(proc, hang_reason)
            rec['end_time'] = round(time.time(), 3)
            rec['rc'] = proc.returncode if proc else None
            rec['steps_completed'] = self._steps_completed(hb_path,
                                                           start_step)

            if hang_reason and hang_reason.startswith('preempted'):
                rec['reason'] = hang_reason
                return self._preempted()
            if proc and hang_reason is None and proc.returncode == 0:
                rec['reason'] = 'completed'
                self.outcome = 'completed'
                self._event('complete', restarts=self.restarts)
                return 0

            reason = spawn_failure or hang_reason or (
                f'signal:{signal.Signals(-proc.returncode).name}'
                if proc.returncode < 0 else f'exit:{proc.returncode}')
            # A child that died by its own hand can still carry
            # distributed evidence the poll loop never saw: a peer-death
            # tombstone (the injected fault SIGKILLs right after writing
            # it; under gloo the survivor's collective raises at once)
            # means a RANK died, not the run — reclassify so the elastic
            # path fires.
            if not reason.startswith('peer-death'):
                dead = self._dead_peer_tombstone(ctrl_dir)
                if dead is not None:
                    reason = f'peer-death:{dead} ({reason})'
            rec['reason'] = reason
            self._event('failure', reason=reason,
                        steps_completed=rec['steps_completed'])

            self.restarts += 1
            if self.restarts > self.max_restarts:
                self.outcome = 'gave-up'
                self._event('give-up', restarts=self.restarts - 1,
                            max_restarts=self.max_restarts)
                return proc.returncode if proc and proc.returncode \
                    and proc.returncode > 0 else 1

            # Elastic restart: a DISTRIBUTED failure (a peer died, a
            # fence timed out, a collective wedged) is not a bug to retry
            # harder against — the world itself must shrink. Fires at
            # once, without waiting for the same-step ladder: restarting
            # on the same world would block in the same collective.
            elastically_shrunk = False
            if self.elastic and self._is_distributed_failure(reason):
                new_argv, new_env, desc = _rung_shrink_mesh(argv, env)
                if desc:
                    argv, env = new_argv, new_env
                    self.argv = argv
                    self.elastic_events.append(
                        {'attempt': attempt, 'reason': reason,
                         'detail': desc, 'mesh_after': mesh_size(argv)})
                    self._event('elastic-shrink', reason=reason,
                                detail=desc)
                    elastically_shrunk = True
                    # The world changed; old same-step evidence is moot.
                    same_step_fails, last_fail_step = 0, _NO_FAILURE

            # Same-step escalation: repeated death at one step (or with
            # no progress evidence at all) means retrying harder won't
            # help — degrade instead.
            if not elastically_shrunk:
                step = rec['steps_completed']
                if step == last_fail_step:
                    same_step_fails += 1
                else:
                    same_step_fails = 0
                last_fail_step = step
                if same_step_fails >= self.same_step_threshold - 1:
                    while rung_idx < len(self.ladder):
                        rung = self.ladder[rung_idx]
                        rung_idx += 1
                        argv, env, desc = LADDER_RUNGS[rung](argv, env)
                        self.argv = argv
                        if desc:
                            self.degradations.append(
                                {'rung': rung, 'attempt': attempt,
                                 'detail': desc})
                            self._event('degrade', rung=rung, detail=desc)
                            break
                    same_step_fails = 0

            # Publish the next attempt's terms before any child can start
            # it: with rank-0 leadership every rank's supervisor restarts
            # onto the SAME attempt number and world. A FOLLOWER waits
            # for the leader's decision and ADOPTS its shard count — two
            # ranks rejoining with different --row_shards would refuse
            # or block the first rendezvous. A follower that cannot see
            # a decision within ledger_wait_s proceeds on its own terms.
            # One outside the decided world retires.
            if self._ledger is not None:
                shards = None
                if self._ledger.is_leader:
                    try:
                        self._ledger.decide(
                            attempt + 1, reason,
                            mesh={'shards': mesh_size(argv)},
                            detail=(self.elastic_events[-1]['detail']
                                    if elastically_shrunk else None))
                    except OSError:
                        pass  # the ledger never takes the monitor down
                else:
                    argv, shards = self._adopt_ledger_mesh(argv,
                                                           attempt + 1)
                    self.argv = argv
                if self._outside_world(argv, shards):
                    self.outcome = 'retired'
                    self._event('retire', host=self.host_index,
                                world=shards or mesh_size(argv))
                    return 0

            delay = min(self.backoff_max_s,
                        self.backoff_s * (2 ** (self.restarts - 1)))
            self._event('restart', number=self.restarts,
                        backoff_s=round(delay, 2),
                        resume_from=('checkpoint' if self.ckpt_dir
                                     else 'scratch'))
            end = time.time() + delay
            while time.time() < end:
                if self._stop_signal is not None:
                    return self._preempted()
                time.sleep(min(self.poll_s, max(0.0, end - time.time())))
            attempt += 1


def _host_index(args):
    """This supervisor's rank: the child's ``--process_id``, else
    torchrun's ``RANK``, else JAX's ``DGMC_TPU_HOST_INDEX``, else 0."""
    pid = getattr(args, 'process_id', None)
    if pid is not None:
        return int(pid)
    for var in ('RANK', 'DGMC_TPU_HOST_INDEX'):
        if os.environ.get(var):
            return int(os.environ[var])
    return 0


def supervise_cli(module, args, argv=None, *, ladder=DEFAULT_LADDER,
                  cmd=None):
    """``--supervise`` glue for a CLI ``main()``: re-run the same command
    (minus supervisor flags) in supervised children.

    Args:
        module: the child's ``python -m`` module path (ignored when
            ``cmd`` is given).
        args: the parsed namespace (reads obs_dir / ckpt_dir /
            watchdog_deadline / fence_deadline / max_restarts /
            restart_backoff / elastic / process_id).
        argv: the original argv (defaults to ``sys.argv[1:]``).
        ladder: degradation rungs valid for this CLI's flag surface.

    Multi-rank runs start one supervisor per rank (the same command with
    its own ``--process_id``, one shared ``--obs-dir``); the rank is the
    host index (:func:`_host_index`). Returns the supervisor's exit code
    (0 = run completed, or this rank retired).
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    child_argv = strip_supervisor_args(argv)
    obs_dir = getattr(args, 'obs_dir', None)
    ckpt_dir = getattr(args, 'ckpt_dir', None)
    deadline = getattr(args, 'watchdog_deadline', None)
    if obs_dir and deadline is None:
        # Hang detection needs an armed watchdog in the child. An
        # explicit --watchdog-deadline 0 is the opt-out and is honored.
        deadline = DEFAULT_HANG_DEADLINE_S
        child_argv = child_argv + ['--watchdog-deadline', str(deadline)]
    elif not deadline:
        deadline = None
    if obs_dir and deadline \
            and getattr(args, 'fence_deadline', None) is None:
        # Arm the fence deadline alongside the watchdog: a fence (or a
        # rendezvous) that misses it exits FENCE_TIMEOUT_RC with a
        # hang_report.json naming the missing rank and phase — prompt,
        # attributable evidence. --fence-deadline 0 is honored.
        child_argv = child_argv + ['--fence-deadline', str(deadline)]
    if not obs_dir:
        print('[supervisor] no --obs-dir: hang detection disabled '
              '(crash/preemption recovery only)', file=sys.stderr)
        deadline = None
    if not ckpt_dir:
        print('[supervisor] no --ckpt_dir: restarts re-run from scratch',
              file=sys.stderr)
    sup = Supervisor(
        cmd or [sys.executable, '-m', module], child_argv,
        obs_dir=obs_dir, ckpt_dir=ckpt_dir,
        max_restarts=getattr(args, 'max_restarts', DEFAULT_MAX_RESTARTS),
        backoff_s=getattr(args, 'restart_backoff', 1.0),
        hang_deadline_s=deadline, ladder=ladder,
        elastic=getattr(args, 'elastic', True),
        host_index=_host_index(args))
    return sup.run()
