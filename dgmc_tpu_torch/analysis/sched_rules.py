"""SCH/MEM tier: schedule and liveness rules over the mesh specimens' runs.

The port's counterpart of the JAX package's ``analysis/sched_rules.py``:
the schedule model (:mod:`~dgmc_tpu_torch.analysis.schedule`) and the
liveness bound (:mod:`~dgmc_tpu_torch.analysis.liveness`) over rank 0's
tape of each sched-tier specimen's run on its ranks. Rule ids,
severities and budget keys are JAX's; a PyTorch run is flat, so "inside
a loop" reads "recurs at the same call stack" (a Python loop's
iterations, unrolled on the tape, share it):

``SCH401`` serialized-async-collective (error)
    An asynchronous collective, in a loop, whose wait follows it with no
    compute in between in program order. It reads only collectives
    issued asynchronously: the port issues none (its collectives are
    synchronous calls), so it holds on crafted tapes.
``SCH402`` overlap-budget (warning)
    The run's modeled collective overlap fraction below the specimen's
    ``overlap_budget``.
``SCH403`` double-buffer-opportunity (info)
    A fetch (a gather, ``index_select``, an indexing gather, a
    collective or a host → device copy) on the critical path that feeds
    compute and recurs at the same call stack, with at least
    ``double_buffer_min_bytes``.
``MEM404`` peak-budget (error)
    The static peak-live bytes above ``peak_bytes_budget``.
``MEM405`` residual-blowup (error)
    JAX reads a loop-carried buffer. Here it is a storage of rank >= 2
    made in the forward and read in the backward (an autograd residual),
    or made in a loop's iteration and read by the next one's same op
    (carried across the chunk loop), whose shape holds
    ``stream_full`` rather than ``stream_chunk`` (a dimension equal to
    it, or one slab a chunk stacked over the whole axis), with at least
    ``residual_min_bytes``.
"""

import collections
import dataclasses
import math
from typing import List, Optional

from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              disambiguate_contexts)
from dgmc_tpu_torch.analysis.liveness import module_peak
from dgmc_tpu_torch.analysis.schedule import schedule_summary, schedule_tape
from dgmc_tpu_torch.analysis.shd_rules import pow2_bucket

__all__ = ['SchedContext', 'analyze_schedule_tape', 'run_sched_tier',
           'check_serialized_async', 'check_overlap_budget',
           'check_double_buffer', 'check_peak_budget',
           'check_residual_blowup', 'FETCH_OPS']

#: The aten ops that fetch data for the compute after them (with the
#: collectives and the host → device copies).
FETCH_OPS = frozenset({'gather', 'index_select', 'index', 'take',
                       'embedding'})


@dataclasses.dataclass
class SchedContext:
    """Provenance prefix + budgets for one run (JAX's)."""
    specimen: str = 'program'
    overlap_budget: Optional[float] = None
    peak_bytes_budget: Optional[int] = None
    stream_full: Optional[int] = None
    stream_chunk: Optional[int] = None
    residual_min_bytes: int = 1 << 20
    double_buffer_min_bytes: int = 1 << 20


def _loc(prov, fallback):
    return prov if prov and prov != '<unknown>' else fallback


def _short(name):
    parts = name.split('.')
    return parts[1] if len(parts) >= 2 else name


def _recurring(ops):
    """``(name, site)`` pairs that occur more than once: an op in a Python
    loop (its iterations share the call stack, :func:`~dgmc_tpu_torch.
    analysis.trace_rules._site`)."""
    n = collections.Counter((_short(op.name), op.site) for op in ops)
    return {k for k, v in n.items() if v > 1}


def check_serialized_async(tape, ctx, sched=None) -> List[Finding]:
    """SCH401: an asynchronous collective in a loop with nothing between
    it and its wait."""
    sched = sched or schedule_tape(tape)
    loops = _recurring(op for op in tape.ops if op.kind == 'collective')
    out = []
    idx = 0
    for coll in sched.collectives:
        if coll.program_gap_cost is None or coll.done_index is None:
            continue
        op = coll.op
        if (_short(op.name), op.site) not in loops:
            continue
        idx += 1
        if coll.program_gap_cost > 0:
            continue
        fallback = f'{coll.kind}#{idx - 1}'
        out.append(Finding(
            rule='SCH401', severity=Severity.ERROR,
            where=f'{ctx.specimen}:{_loc(op.provenance, fallback)}',
            message=(f'async `{coll.kind}` inside a loop is serialized — '
                     f'its wait immediately follows it with no compute in '
                     f'between'),
            detail=(f'{coll.nbytes} B in flight with zero overlappable '
                    f'work; move independent compute between the '
                    f'collective and its wait (or double-buffer the loop) '
                    f'so the transfer hides behind it'),
            context=f'{coll.kind} {op.collective.get("dtype")}'
                    f'{list(op.collective.get("shape", ()))}'))
    return out


def check_overlap_budget(tape, ctx, sched=None) -> List[Finding]:
    """SCH402: modeled overlap fraction under the recorded budget."""
    if ctx.overlap_budget is None:
        return []
    summary = schedule_summary(tape, sched=sched)
    measured = summary.get('overlap_fraction')
    if measured is None or measured >= ctx.overlap_budget:
        return []
    return [Finding(
        rule='SCH402', severity=Severity.WARNING,
        where=f'{ctx.specimen}:sched-overlap',
        message=(f'modeled collective overlap fraction fell below the '
                 f'recorded budget {ctx.overlap_budget} — a dependency now '
                 f'forces serialization'),
        detail=(f'measured {measured} over '
                f'{summary.get("collective_count", 0)} collective(s) '
                f'({summary.get("serialized_collectives", 0)} fully '
                f'serialized, {summary.get("collective_bytes", 0)} B '
                f'payload); either the serialization is intended (lower '
                f'the overlap_budget in the registry and re-baseline) or '
                f'an edit chained the collectives to the compute'))]


def _is_fetch(op):
    if op.kind == 'collective':
        return True
    if op.kind != 'op':
        return False
    name = _short(op.name)
    if name in FETCH_OPS:
        return True
    return op.host_to_device


def check_double_buffer(tape, ctx, sched=None) -> List[Finding]:
    """SCH403: a big critical-path fetch re-issued per iteration that
    feeds compute."""
    sched = sched or schedule_tape(tape)
    fetches = [s for s in sched.ops if _is_fetch(s.op)]
    loops = _recurring(s.op for s in fetches)
    consumers = collections.defaultdict(list)
    for s in sched.ops:
        for d in s.deps:
            consumers[d].append(s.index)
    out = []
    hits = 0
    for s in fetches:
        op = s.op
        if s.duration < ctx.double_buffer_min_bytes:
            continue
        if (_short(op.name), op.site) not in loops:
            continue
        if s.index not in sched.critical_ops:
            continue
        stack, seen, feeds = list(consumers[s.index]), set(), False
        while stack and not feeds:
            j = stack.pop()
            if j in seen:
                continue
            seen.add(j)
            if sched.ops[j].stream == 'compute':
                feeds = True
            stack.extend(consumers[j])
        if not feeds:
            continue
        name = _short(op.name) if op.kind == 'op' else op.name
        shape = list(op.out_shapes[0]) if op.out_shapes else []
        fallback = f'{name}#{hits}'
        out.append(Finding(
            rule='SCH403', severity=Severity.INFO,
            where=f'{ctx.specimen}:{_loc(op.provenance, fallback)}',
            message=(f'`{name}` fetching {pow2_bucket(s.duration)} per '
                     f'iteration is strictly serialized behind the loop '
                     f'carry — double-buffer opportunity'),
            detail=('the fetch sits on the critical path and feeds the '
                    'compute after it: iteration k+1\'s fetch cannot start '
                    'until iteration k finishes. Fetch chunk k+1 while '
                    'computing chunk k (ROADMAP item 4) to hide it'),
            context=f'{name} {shape}'))
        hits += 1
    return out


def check_peak_budget(tape, ctx) -> List[Finding]:
    """MEM404: static peak-live bytes over the recorded budget."""
    if not ctx.peak_bytes_budget:
        return []
    lv = module_peak(tape)
    if lv.peak_bytes <= ctx.peak_bytes_budget:
        return []
    stages = ', '.join(f'{k}: {v} B' for k, v in sorted(
        lv.stage_bytes().items(), key=lambda kv: -kv[1])[:5])
    return [Finding(
        rule='MEM404', severity=Severity.ERROR,
        where=f'{ctx.specimen}:peak-live',
        message=(f'static peak-live bytes {pow2_bucket(lv.peak_bytes)} '
                 f'exceed the recorded {ctx.peak_bytes_budget} B device '
                 f'budget'),
        detail=(f'exact peak {lv.peak_bytes} B at tape index '
                f'{lv.peak_index} — top stages: {stages}; either the '
                f'growth is intended (raise peak_bytes_budget in the '
                f'registry and re-baseline) or a buffer began outliving '
                f'its consumer'))]


def check_residual_blowup(tape, ctx) -> List[Finding]:
    """MEM405: a residual or carried buffer scaling with the full
    streamed axis."""
    if not ctx.stream_full or not ctx.stream_chunk:
        return []
    full, chunk = ctx.stream_full, ctx.stream_chunk
    trips = math.ceil(full / chunk)
    readers = collections.defaultdict(list)
    for op in tape.ops:
        for b in op.reads:
            readers[b].append(op)
    out = []
    for bid, buf in sorted(tape.buffers.items()):
        dims = tuple(buf.shape)
        if buf.origin != 'op' or buf.nbytes < ctx.residual_min_bytes \
                or len(dims) < 2:
            continue
        n = math.prod(dims)
        full_dim = any(d == full for d in dims)
        stacked = trips > 1 and dims[0] == trips and n >= full * chunk
        if not (full_dim or stacked):
            continue
        maker = tape.ops[buf.index]
        residual = not maker.backward and any(r.backward
                                              for r in readers[bid])
        carried = any(r.index > maker.index and r.site == maker.site
                      and _short(r.name) == _short(maker.name)
                      for r in readers[bid])
        if not (residual or carried):
            continue
        shape = f'{buf.dtype}[{",".join(map(str, dims))}]'
        how = ('made in the forward and read in the backward'
               if residual else 'carried to the next iteration')
        spelling = ('holds a full streamed-axis dimension' if full_dim
                    else f'stacks one slab per chunk (leading dim '
                         f'{dims[0]} = trip count)')
        fallback = f'buffer#{bid}'
        out.append(Finding(
            rule='MEM405', severity=Severity.ERROR,
            where=f'{ctx.specimen}:{_loc(maker.provenance, fallback)}',
            message=(f'{how}: {shape} ({buf.nbytes} B) scales with the '
                     f'full streamed axis ({full}) instead of the chunk '
                     f'({chunk}) — residual blowup class'),
            detail=(f'the buffer {spelling}; keep the search out of '
                    f'autograd (no_grad) or recompute in the backward '
                    f'instead of keeping full-axis residuals'),
            context=f'residual {shape}'))
    return out


def analyze_schedule_tape(tape, ctx: Optional[SchedContext] = None
                          ) -> List[Finding]:
    """All SCH/MEM rules over one run (one schedule build)."""
    ctx = ctx or SchedContext()
    sched = schedule_tape(tape)
    out = []
    out += check_serialized_async(tape, ctx, sched)
    out += check_overlap_budget(tape, ctx, sched)
    out += check_double_buffer(tape, ctx, sched)
    out += check_peak_budget(tape, ctx)
    out += check_residual_blowup(tape, ctx)
    return disambiguate_contexts(out)


def run_sched_tier(specimens=None, *, cache=None, on_progress=None,
                   skipped=None, device=None) -> List[Finding]:
    """The SCH/MEM rules over every sched-tier specimen's run (rank 0's
    tape; ``cache`` shared with the other tiers, a new one on ``device``
    starting 4 ranks when none is given)."""
    from dgmc_tpu_torch.analysis.registry import (SpecimenCache,
                                                  iter_runnable_specimens)
    cache = cache if cache is not None else SpecimenCache(device)
    findings = []
    for spec in iter_runnable_specimens('sched', specimens=specimens,
                                        on_progress=on_progress,
                                        skipped=skipped):
        if on_progress:
            on_progress(f'schedule {spec.name} on {cache.where(spec)}')
        art = cache.artifacts(spec)
        built = art.built()
        ctx = SchedContext(
            specimen=spec.name, overlap_budget=built.get('overlap_budget'),
            peak_bytes_budget=built.get('peak_bytes_budget'),
            stream_full=built.get('stream_full'),
            stream_chunk=built.get('stream_chunk'))
        if built.get('residual_min_bytes') is not None:
            ctx.residual_min_bytes = built['residual_min_bytes']
        if built.get('double_buffer_min_bytes') is not None:
            ctx.double_buffer_min_bytes = built['double_buffer_min_bytes']
        findings.extend(analyze_schedule_tape(art.recorded()['tape'], ctx))
    return findings
