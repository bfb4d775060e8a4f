"""Schedule model over a recorded run: overlap, serialization, critical
path.

The port's counterpart of the JAX package's ``analysis/hlo_sched.py``,
over the tape of :mod:`~dgmc_tpu_torch.analysis.trace_rules` in the
place of post-GSPMD HLO:

- **Dependency DAG** from the tape's storages: an op depends on the last
  op that wrote (or made) each buffer it reads; an op that writes a
  buffer also depends on its last writer and on every read of it since
  (a write must wait for the readers of the old value). Views, and
  allocations without compute, are free ops (JAX's ``FREE_OPS``), as
  are the ops a kernel entry's plain version runs inside it: the entry's
  mark carries the cost (its results' bytes), so the CPU's tape and the
  card's cost a kernel alike.
- **Conservative list schedule** (JAX's): ops run in program order on two
  streams, a compute stream and a communication stream, each starting no
  earlier than its dependencies finish. Durations are JAX's byte
  proxies: the result bytes of a compute op (at least 1), the payload of
  a collective. A collective occupies only the communication stream;
  whether compute falls inside its window is decided by the dependency
  structure alone.
- **Per-collective overlap fraction**: the share of its window covered by
  busy compute time; the run's ``overlap_fraction`` is the
  payload-weighted mean. A collective with none is **serialized**.
- **Critical-path share**: the longest dependency path's cost over the
  total cost (1.0: one chain).

Two differences from JAX's model:

- A PyTorch run is flat: a Python loop is unrolled on the tape, so there
  are no trip factors (``loop_collectives`` is 0), and each iteration's
  collective counts where it happens.
- The port's collectives are synchronous calls. As in JAX's model of a
  synchronous collective, it takes only the communication stream, and
  the dependencies alone decide whether compute can fall inside its
  window: the model measures dependency slack, not wall time. An
  asynchronous collective (none is issued today) is an op whose
  ``collective['async']`` is set, joined by a later ``'wait'`` op whose
  ``collective['start']`` names it: JAX's ``-start`` / ``-done`` pair.

``python -m dgmc_tpu_torch.analysis.schedule [--specimens A,B] [--device
cpu] [--json]`` prints JAX's report over the registered mesh specimens
(run on gloo ranks, :mod:`~dgmc_tpu_torch.analysis.ranks`). Imports no
torch: a tape is plain data (the CLI imports the registry lazily).
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ['ScheduledOp', 'CollectiveInterval', 'ComputationSchedule',
           'duration', 'dependencies', 'schedule_tape', 'schedule_summary',
           'main']


@dataclasses.dataclass
class ScheduledOp:
    """One op's placement in the modeled schedule."""
    index: int
    op: object
    stream: str               # 'compute' | 'comm' | 'free'
    duration: int             # byte proxy
    start: float
    finish: float
    deps: Tuple[int, ...]


@dataclasses.dataclass
class CollectiveInterval:
    """One collective's modeled window."""
    op: object
    kind: str
    nbytes: int
    start: float
    finish: float
    #: Busy compute time inside [start, finish).
    overlapped: float
    #: ``overlapped / duration`` (0..1); 0.0 = fully serialized.
    overlap_fraction: float
    #: An asynchronous one: the compute cost of the ops strictly between
    #: it and its wait in program order. None for a synchronous one.
    program_gap_cost: Optional[int] = None
    #: The index of its wait; None for a synchronous one and for one
    #: whose wait is not on the tape.
    done_index: Optional[int] = None


@dataclasses.dataclass
class ComputationSchedule:
    """The schedule model of one run (JAX's fields)."""
    name: str
    ops: List[ScheduledOp]
    collectives: List[CollectiveInterval]
    compute_cost: int
    comm_cost: int
    critical_path_cost: int
    critical_path_share: float
    critical_ops: frozenset

    @property
    def overlap_fraction(self) -> Optional[float]:
        total = sum(c.nbytes for c in self.collectives)
        if not total:
            return None
        return sum(c.overlap_fraction * c.nbytes
                   for c in self.collectives) / total


def _is_wait(op):
    return op.kind == 'wait'


def duration(op) -> int:
    """JAX's byte proxy of one op: 0 for a free op, a wait and an op run
    inside a kernel entry; the payload of a collective; else the result
    bytes, at least 1."""
    if op.kind == 'collective':
        return max(int(op.collective['payload']), 1)
    if _is_wait(op) or op.free or op.in_kernel:
        return 0
    return max(int(op.out_bytes), 1)


def dependencies(tape) -> List[Tuple[int, ...]]:
    """Each op's dependencies (see the module docstring)."""
    last_write: Dict[int, int] = {}
    readers: Dict[int, List[int]] = {}
    out = []
    for i, op in enumerate(tape.ops):
        deps = set()
        for b in op.reads:
            if b in last_write:
                deps.add(last_write[b])
        written = list(op.writes) + [b for b, _ in op.allocs]
        for b in written:
            if b in last_write:
                deps.add(last_write[b])
            deps.update(readers.get(b, ()))
        if _is_wait(op) and op.collective.get('start') is not None:
            deps.add(op.collective['start'])
        deps.discard(i)
        out.append(tuple(sorted(deps)))
        for b in op.reads:
            readers.setdefault(b, []).append(i)
        for b in written:
            last_write[b] = i
            readers[b] = []
    return out


def _async_pairs(tape) -> Dict[int, int]:
    """``{start index: wait index}`` of the asynchronous collectives."""
    pairs = {}
    for i, op in enumerate(tape.ops):
        if _is_wait(op):
            s = op.collective.get('start')
            if s is not None and 0 <= s < i:
                pairs[s] = i
    return pairs


def schedule_tape(tape, name='run') -> ComputationSchedule:
    """Run the conservative list schedule over one tape (JAX's
    ``schedule_computation``: program order kept per stream, an op
    starting at ``max(stream frontier, dependencies ready)``)."""
    ops = tape.ops
    deps = dependencies(tape)
    pairs = _async_pairs(tape)
    wait_of = {d: s for s, d in pairs.items()}
    finish: Dict[int, float] = {}
    scheduled: List[ScheduledOp] = []
    busy: List[Tuple[float, float]] = []
    t_compute = t_comm = 0.0
    windows = []
    for i, op in enumerate(ops):
        dur = duration(op)
        ready = max((finish[d] for d in deps[i] if d in finish),
                    default=0.0)
        if i in wait_of:
            s = f = max(ready, finish.get(wait_of[i], 0.0))
            stream = 'free'
        elif op.kind == 'collective':
            s = max(t_comm, ready)
            f = s + dur
            t_comm = f
            stream = 'comm'
            windows.append((i, s, f))
        elif dur == 0:
            s = f = ready
            stream = 'free'
        else:
            s = max(t_compute, ready)
            f = s + dur
            t_compute = f
            busy.append((s, f))
            stream = 'compute'
        finish[i] = f
        scheduled.append(ScheduledOp(index=i, op=op, stream=stream,
                                     duration=dur, start=s, finish=f,
                                     deps=deps[i]))
    collectives = []
    for i, s, f in windows:
        op = ops[i]
        overlapped = sum(max(0.0, min(f, b1) - max(s, b0))
                         for b0, b1 in busy)
        span = max(f - s, 1e-9)
        gap = None
        done = pairs.get(i)
        if op.collective.get('async'):
            end = done if done is not None else len(ops)
            gap = sum(scheduled[j].duration for j in range(i + 1, end)
                      if scheduled[j].stream == 'compute')
        collectives.append(CollectiveInterval(
            op=op, kind=op.collective['kind'], nbytes=duration(op),
            start=s, finish=f, overlapped=overlapped,
            overlap_fraction=min(1.0, overlapped / span),
            program_gap_cost=gap, done_index=done))
    compute_cost = sum(o.duration for o in scheduled
                       if o.stream == 'compute')
    comm_cost = sum(o.duration for o in scheduled if o.stream == 'comm')
    lp: List[float] = []
    for i in range(len(ops)):
        lp.append(max((lp[d] for d in deps[i]), default=0.0)
                  + scheduled[i].duration)
    cp = max(lp, default=0.0)
    total = compute_cost + comm_cost
    critical = set()
    if cp > 0:
        consumers: List[List[int]] = [[] for _ in ops]
        for j, ds in enumerate(deps):
            for d in ds:
                consumers[d].append(j)
        down = [0.0] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            down[i] = max((down[j] + scheduled[j].duration
                           for j in consumers[i]), default=0.0)
            if lp[i] + down[i] >= cp - 1e-9:
                critical.add(i)
    return ComputationSchedule(
        name=name, ops=scheduled, collectives=collectives,
        compute_cost=compute_cost, comm_cost=comm_cost,
        critical_path_cost=int(cp),
        critical_path_share=(cp / total if total else 0.0),
        critical_ops=frozenset(critical))


def schedule_summary(tape, sched=None) -> dict:
    """JAX's program-level account: ``computations``,
    ``critical_path_share`` and, when the run moved anything between
    ranks, ``collective_count``, ``collective_bytes``,
    ``loop_collectives`` (0: no trip factors), ``overlap_fraction`` (the
    payload-weighted mean) and ``serialized_collectives``; rounded as
    JAX rounds them. Pass ``sched`` (a :func:`schedule_tape` result) to
    reuse a built model."""
    if sched is None:
        sched = schedule_tape(tape)
    out = {'computations': 1,
           'critical_path_share': round(sched.critical_path_share, 4)}
    colls = sched.collectives
    if colls:
        total = sum(c.nbytes for c in colls)
        out['collective_count'] = len(colls)
        out['collective_bytes'] = total
        out['loop_collectives'] = 0
        out['overlap_fraction'] = round(
            sum(c.overlap_fraction * c.nbytes for c in colls) / total, 4)
        out['serialized_collectives'] = sum(
            1 for c in colls if c.overlap_fraction <= 0.0)
    return out


# ---------------------------------------------------------------------------
# CLI: the schedule report over the registered mesh specimens
# ---------------------------------------------------------------------------


def specimen_report(names=None, on_progress=None, device='cpu'):
    """``{specimen: schedule_summary + static peak}`` over the registered
    sched-tier specimens, each from rank 0's tape of its one run on the
    ranks (JAX's ``_specimen_report``)."""
    from dgmc_tpu_torch.analysis.liveness import peak_summary
    from dgmc_tpu_torch.analysis.registry import (iter_runnable_specimens,
                                                  shared_cache)
    cache = shared_cache(device)
    out = {}
    for spec in iter_runnable_specimens('sched', names=names,
                                        on_progress=on_progress):
        if on_progress:
            on_progress(f'schedule {spec.name} on {cache.where(spec)}')
        try:
            tape = cache.artifacts(spec).recorded()['tape']
            row = schedule_summary(tape)
            row.update(peak_summary(tape))
            out[spec.name] = row
        except Exception as e:
            out[spec.name] = {'error': f'{type(e).__name__}: {e}'}
    return out


def main(argv=None):
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.analysis.schedule',
        description='Schedule/liveness report over the registered mesh '
                    'specimens (run on gloo ranks): modeled collective '
                    'overlap, serialized collectives, critical-path share '
                    'and static peak-live bytes per program.')
    parser.add_argument('--specimens', default=None,
                        help='comma-separated specimen names (default: '
                             'every sched-tier specimen)')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable report')
    parser.add_argument('--device', default='cuda',
                        help='where the ranks run the specimens (default '
                             'cuda: the ranks share the card; cpu)')
    args = parser.parse_args(argv)

    def progress(msg):
        if not args.json:
            print(f'[schedule] {msg}', file=sys.stderr)

    names = ({n.strip() for n in args.specimens.split(',') if n.strip()}
             if args.specimens else None)
    report = specimen_report(names=names, on_progress=progress,
                             device=args.device)
    if not report:
        print('schedule: no runnable sched-tier specimens matched',
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    for name, row in report.items():
        if 'error' in row:
            print(f'-- {name}: ERROR {row["error"]}')
            continue
        print(f'-- {name} --')
        ov = row.get('overlap_fraction')
        print(f'   overlap_fraction     '
              f'{"-" if ov is None else f"{ov:.4f}"}   '
              f'({row.get("collective_count", 0)} collective(s), '
              f'{row.get("serialized_collectives", 0)} serialized)')
        print(f'   critical_path_share  '
              f'{row.get("critical_path_share", 0):.4f}')
        print(f'   static_peak_bytes    '
              f'{row.get("static_peak_bytes", 0)}')
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
