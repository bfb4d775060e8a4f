"""Fault-tolerant run supervisor: detect → kill → resume → degrade.

The port of the JAX package's ``dgmc_tpu/resilience/supervisor.py``, its
single-card half. ``--supervise`` re-runs the same CLI command in a
child process and closes the detection → recovery loop:

- **Crash / preemption** (nonzero exit, death by signal — what a
  scheduler preemption or an injected ``sigkill@N`` looks like): restart
  from the latest checkpoint (the CLIs resume through ``--ckpt_dir``)
  after a bounded exponential backoff.
- **Hang**: the child's watchdog heartbeat
  (``<obs>/attempt_<k>/heartbeat.json``) goes stale past the deadline,
  or a deadline ``hang_report.json`` appears. A child that advertises a
  live-plane port in its heartbeat (``--obs-port``) is judged by its
  ``/healthz`` first — the same staleness verdict, evaluated by the
  child's own plane — with the file heartbeat as the fallback whenever
  the scrape fails; a 503 kills the child as ``healthz-stale``. The
  supervisor SIGTERMs the child, escalates to SIGKILL after a grace
  period (a stopped process keeps SIGTERM pending), and restarts.
- **Repeated failure at the same step**: a degradation ladder rewrites
  the child's command before the next restart: ``--f32`` (the bf16
  policy off).
- **Budget**: ``--max-restarts`` bounds the loop; exhausting it records
  ``outcome: gave-up`` and exits nonzero with the last failure's
  evidence on disk.

Everything the supervisor does lands in ``<obs>/recovery.json`` (events,
attempts, degradations; rewritten atomically as the run goes), and each
attempt keeps its own telemetry under ``<obs>/attempt_<k>/``.

Not ported (they wait for multi-GPU runs, ``ROADMAP.md`` A8): the
``shrink-mesh`` rung, the elastic restart (peer heartbeats, tombstones,
the host-0 recovery ledger, halving the mesh) and the ``--fence-deadline``
that JAX's :func:`supervise_cli` appends — the port's CLIs have no such
flag. ``--no-elastic`` is accepted, so JAX command lines carry over.

JAX's ``disable-fused`` rung has no counterpart either: the port's
kernel gates run their plain versions only for CPU tensors, so no
restart on the card trades a kernel for plain PyTorch. A kernel that
fails on the card fails every attempt, and the budget runs out with its
evidence on disk. A ladder that names the rung (or ``shrink-mesh``)
drops it.

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
           'LADDER_RUNGS', 'DEFAULT_LADDER', 'DEFAULT_MAX_RESTARTS',
           'DEFAULT_HANG_DEADLINE_S', 'RECOVERY_FILE']

DEFAULT_MAX_RESTARTS = 5
#: Watchdog deadline given to supervised children that have an obs dir
#: but no ``--watchdog-deadline`` of their own.
DEFAULT_HANG_DEADLINE_S = 600.0
RECOVERY_FILE = 'recovery.json'
#: The per-attempt obs subdirectory naming contract: the supervisor
#: writes these, ``faults.ledger_dir`` parses them.
ATTEMPT_PREFIX = 'attempt_'


def attempt_dirname(k):
    return f'{ATTEMPT_PREFIX}{k}'


def is_attempt_dirname(name):
    return (name.startswith(ATTEMPT_PREFIX)
            and name[len(ATTEMPT_PREFIX):].isdigit())


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
             'degradation ladder (the f32 policy where the CLI has '
             'one). Recovery timeline: <obs-dir>/recovery.json')
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
        help='accepted for the JAX command lines; the port has no '
             'elastic (mesh-shrinking) restart yet')
    return parser


def strip_supervisor_args(argv):
    """argv minus the supervisor's own flags (child command line)."""
    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        name = tok.split('=', 1)[0]
        if name in _OWN_FLAGS:
            i += 1 + (0 if '=' in tok else _OWN_FLAGS[name])
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


#: name -> rewrite(argv, env) -> (argv, env, description-or-None).
LADDER_RUNGS = {
    'f32': _rung_force_f32,
}
DEFAULT_LADDER = ('f32',)


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
            watchdog thread exists writes neither heartbeat nor
            hang_report.
        ladder: rung names from :data:`LADDER_RUNGS` (others, such as
            JAX's ``disable-fused`` and ``shrink-mesh``, are dropped),
            applied one per escalation after ``same_step_threshold``
            failures at the same step.
    """

    def __init__(self, cmd, argv, *, obs_dir=None, ckpt_dir=None,
                 max_restarts=DEFAULT_MAX_RESTARTS, backoff_s=1.0,
                 backoff_max_s=60.0, grace_s=10.0, hang_deadline_s=None,
                 first_heartbeat_s=None, ladder=DEFAULT_LADDER,
                 same_step_threshold=2, poll_s=0.5, env=None):
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
        self.recovery_path = os.path.join(
            obs_dir or ckpt_dir or '.', RECOVERY_FILE)
        # Children with neither --ckpt_dir nor --obs-dir still need a
        # home for the fire-once fault ledger: the recovery file's
        # directory survives restarts.
        self._base_env.setdefault(
            LEDGER_ENV,
            os.path.dirname(os.path.abspath(self.recovery_path)))
        self.events = []
        self.attempts = []
        self.degradations = []
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
            'attempts': self.attempts,
            'events': self.events,
        }
        # quiet: a supervisor must never die of its own telemetry.
        write_json_atomic(self.recovery_path, payload, indent=1,
                          quiet=True)

    # -- child plumbing ----------------------------------------------------

    def _attempt_dirs(self, k):
        if not self.obs_dir:
            return None, None, None
        adir = os.path.join(self.obs_dir, attempt_dirname(k))
        return (adir, os.path.join(adir, 'heartbeat.json'),
                os.path.join(adir, 'hang_report.json'))

    @staticmethod
    def _clear_stale_evidence(*paths):
        """Drop liveness evidence left in a reused attempt dir by a
        PREVIOUS supervisor run (same ``--obs-dir``; attempt
        numbering restarts at 0): an old deadline ``hang_report.json``
        or heartbeat would read as this child's and kill it on the
        first poll."""
        for path in paths:
            try:
                os.remove(path)
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
        units: the heartbeat's step counter is per process and resets on
        every restart, so it is offset by ``start_step`` (the checkpoint
        step the attempt resumed from); a committed checkpoint floors
        it. Fallback: the newest checkpoint step."""
        hb = self._read_json(heartbeat_path) if heartbeat_path else None
        ck = self._latest_ckpt_step()
        if hb and hb.get('steps_completed') is not None:
            derived = (start_step or 0) + hb['steps_completed']
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

    def _watch(self, proc, heartbeat_path, hang_report_path):
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
            if hang_report_path and os.path.exists(hang_report_path):
                rep = self._read_json(hang_report_path) or {}
                # The watchdog also dumps on SIGTERM during shutdown; only
                # a deadline dump means "wedged, kill me".
                if str(rep.get('reason', '')).startswith('deadline'):
                    self._kill(proc, 'hang-report')
                    return 'hang-report'
            if stale_after and heartbeat_path:
                hb = self._read_json(heartbeat_path)
                now = time.time()
                if hb:
                    # A heartbeat advertising a live port gets its
                    # verdict from /healthz (immune to file write lag);
                    # the file's age is the fallback when the scrape
                    # fails.
                    port = hb.get('port')
                    verdict = None
                    if port:
                        verdict = self._healthz_verdict(
                            hb.get('host') or '127.0.0.1', port, now)
                    if verdict is False:
                        self._kill(proc, 'healthz-stale')
                        return 'healthz-stale'
                    if verdict is None \
                            and now - hb.get('time', 0) > stale_after:
                        self._kill(proc, 'heartbeat-stale')
                        return 'heartbeat-stale'
                elif first_beat_by and now > first_beat_by:
                    # The benefit of the doubt before the first
                    # heartbeat is bounded.
                    self._kill(proc, 'no-first-heartbeat')
                    return 'no-first-heartbeat'

    def _on_signal(self, signum, frame):
        self._stop_signal = signal.Signals(signum).name

    # -- the loop ----------------------------------------------------------

    def run(self):
        """Supervise until completion, preemption of the supervisor
        itself, or an exhausted restart budget. Returns the exit code."""
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
            attempt_dir, hb_path, hang_path = self._attempt_dirs(attempt)
            if attempt_dir:
                os.makedirs(attempt_dir, exist_ok=True)
                self._clear_stale_evidence(hb_path, hang_path)
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
                hang_reason = self._watch(proc, hb_path, hang_path)
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

            # Same-step escalation: repeated death at one step (or with
            # no progress evidence at all) means retrying harder won't
            # help — degrade instead.
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


def supervise_cli(module, args, argv=None, *, ladder=DEFAULT_LADDER,
                  cmd=None):
    """``--supervise`` glue for a CLI ``main()``: re-run the same command
    (minus supervisor flags) in supervised children.

    Args:
        module: the child's ``python -m`` module path (ignored when
            ``cmd`` is given).
        args: the parsed namespace (reads obs_dir / ckpt_dir /
            watchdog_deadline / max_restarts / restart_backoff).
        argv: the original argv (defaults to ``sys.argv[1:]``).
        ladder: degradation rungs valid for this CLI's flag surface.

    Unlike JAX's, appends no ``--fence-deadline`` (no port CLI has the
    flag). Returns the supervisor's exit code (0 = run completed).
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
        hang_deadline_s=deadline, ladder=ladder)
    return sup.run()
