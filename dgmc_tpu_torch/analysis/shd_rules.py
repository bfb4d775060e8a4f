"""SHD tier: rules over the collectives of the mesh specimens' runs.

The port's counterpart of the JAX package's ``analysis/shd_rules.py``.
JAX compiles each mesh specimen under its mesh and reads the partitioned
HLO; the port runs each mesh specimen once on its ranks
(:mod:`~dgmc_tpu_torch.analysis.ranks`) and reads the collectives marked
on the tapes (:mod:`~dgmc_tpu_torch.analysis.comm`). Rule ids,
severities, thresholds and budget keys are JAX's:

``SHD301`` branch-divergent-collectives (error)
    A tape is one path, so the rule compares the ranks' collective
    sequences for one specimen run (the tapes in rank order): kind,
    group, dtype and shape, each pair of ranks over the groups they
    share. The first position where a rank differs from rank 0 (or from
    the lowest peer it shares a group with) is the finding, at that
    op's provenance: the runtime face of the same hang (a rank posting a
    collective its peers never enter).
``SHD302`` corr-replication (error)
    An all-gather or broadcast whose result has rank >= 3 and at least
    the specimen's ``corr_bytes``: the full ``[B, N_s, N_t]`` S
    un-sharded.
``SHD303`` reshard-churn (warning)
    Two or more resharding collectives (all-to-all; a send / recv, JAX's
    collective-permute, when its input derives from another resharding
    collective's output) in one step. The port issues none today: its
    ring moves no data (``parallel/topk.py``).
``SHD304`` comm-budget (warning)
    The run's total collective payload above ``comm_budget_bytes``,
    reported in JAX's power-of-two buckets.
``SHD305`` precision-contract (error)
    An accumulation whose accumulator is bf16: an all-reduce of a bf16
    tensor (NCCL sums in bf16) or a scatter / ``index_add`` accumulation
    in bf16, at least ``accum_elems`` addends; worst where an explicit
    float32 → bf16 ``_to_copy`` feeds it. Torch's matmuls and reductions
    accumulate in float32 internally, so they are no finding.
"""

import dataclasses
from typing import List, Optional, Sequence

from dgmc_tpu_torch.analysis.comm import collective_schedule
from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              disambiguate_contexts)

__all__ = ['ShardedContext', 'analyze_sharded_tape', 'run_sharded_tier',
           'check_branch_divergence', 'check_corr_replication',
           'check_reshard_churn', 'check_comm_budget',
           'check_precision_contract', 'pow2_bucket']

#: Collectives that re-replicate a sharded tensor (SHD302).
_REPLICATING = ('all-gather', 'collective-broadcast')
#: Collectives that move a tensor between layouts (SHD303).
_RESHARDING = ('collective-permute', 'all-to-all')
#: Accumulating aten ops (SHD305's scatter class).
_ACCUMULATING = frozenset({'scatter_add', 'scatter_add_', 'scatter_reduce',
                           'scatter_reduce_', 'index_add', 'index_add_',
                           'index_put', 'index_put_', '_index_put_impl_'})


@dataclasses.dataclass
class ShardedContext:
    """Provenance prefix + thresholds for one specimen (JAX's)."""
    specimen: str = 'program'
    corr_bytes: Optional[int] = None
    comm_budget_bytes: Optional[int] = None
    accum_elems: int = 64
    reshard_churn_min: int = 2


def _loc(prov, fallback):
    """The op's provenance, else a structural fallback (JAX's
    ``_loc``)."""
    return prov if prov and prov != '<unknown>' else fallback


def pow2_bucket(nbytes: int) -> str:
    """JAX's ``<= 2^k`` byte bucket."""
    k = max(1, nbytes)
    bucket = 1
    while bucket < k:
        bucket <<= 1
    if bucket >= 1 << 20:
        return f'<= {bucket >> 20} MiB'
    if bucket >= 1 << 10:
        return f'<= {bucket >> 10} KiB'
    return f'<= {bucket} B'


def _prod(dims):
    out = 1
    for d in dims:
        out *= d
    return out


def _render(c):
    return f'{c.kind} {c.dtype}{list(c.shape)} over {list(c.group)}'


def check_branch_divergence(tapes: Sequence, ctx) -> List[Finding]:
    """SHD301: a rank whose collectives differ from a peer's. Two ranks
    must agree on the collectives of the groups they share: each rank's
    sequence restricted to the collectives whose group holds the other
    rank, compared in order (kind, group, dtype, shape); the first
    difference is the finding, one per rank, against the lowest peer it
    differs from (rank 0 where they share a group)."""
    scheds = [collective_schedule(t) for t in tapes]
    ranks = list(range(len(scheds)))
    out = []
    for q in range(1, len(scheds)):
        for p in range(q):
            a = [c for c in scheds[p] if ranks[q] in c.group]
            b = [c for c in scheds[q] if ranks[p] in c.group]
            i = next((i for i in range(max(len(a), len(b)))
                      if i >= len(a) or i >= len(b)
                      or a[i].signature != b[i].signature), None)
            if i is None:
                continue
            x = a[i] if i < len(a) else None
            y = b[i] if i < len(b) else None
            at = y if y is not None else x
            rendered = (f'[{_render(x) if x else "none"}] vs '
                        f'[{_render(y) if y else "none"}]')
            out.append(Finding(
                rule='SHD301', severity=Severity.ERROR,
                context=f'rank {ranks[q]} vs {ranks[p]} {rendered}',
                where=f'{ctx.specimen}:'
                      f'{_loc(at.source_loc, f"collective#{i}")}',
                message=(f'collective sequence of rank {ranks[q]} '
                         f'diverges from rank {ranks[p]}\'s at position '
                         f'{i} of their shared groups ({rendered}) — a '
                         f'collective one rank posts and its peer does '
                         f'not'),
                detail=('the peers block on a collective that never '
                        'comes (distributed deadlock, the multichip-hang '
                        'class); make every rank issue the same '
                        'collectives in the same order, whatever its '
                        'data')))
            break
    return out


def check_corr_replication(tape, ctx) -> List[Finding]:
    """SHD302: an all-gather / broadcast materializing a full
    correspondence-shaped tensor."""
    if not ctx.corr_bytes:
        return []
    out = []
    for c in collective_schedule(tape):
        if c.kind not in _REPLICATING:
            continue
        if len(c.result_shape) < 3 or c.nbytes < ctx.corr_bytes:
            continue
        shape = f'{c.dtype}{list(c.result_shape)}'
        out.append(Finding(
            rule='SHD302', severity=Severity.ERROR,
            context=f'{c.kind} {shape}',
            where=f'{ctx.specimen}:{_loc(c.source_loc, c.kind)}',
            message=(f'`{c.kind}` materializes a full '
                     f'correspondence-shaped tensor ({shape}) — '
                     f'replication defeats the S-matrix sharding'),
            detail=(f'payload {c.nbytes} B >= declared full '
                    f'correspondence payload {ctx.corr_bytes} B (group '
                    f'{list(c.group)}); keep S in its row blocks and '
                    f'reduce shard-locally')))
    return out


def _derives(tape, index, sources):
    """Whether op ``index``'s inputs derive from the results of an op in
    ``sources`` (through the tape's dataflow)."""
    made = {}
    for op in tape.ops[:index]:
        for b in list(op.writes) + [b for b, _ in op.allocs]:
            made[b] = op.index
    seen, stack = set(), list(tape.ops[index].reads)
    while stack:
        b = stack.pop()
        if b in seen:
            continue
        seen.add(b)
        j = made.get(b)
        if j is None:
            continue
        if j in sources:
            return True
        stack.extend(tape.ops[j].reads)
    return False


def check_reshard_churn(tape, ctx) -> List[Finding]:
    """SHD303: resharding collectives that bounce the layout in one step:
    all-to-alls, and permutes fed by another resharding collective."""
    resh = [c for c in collective_schedule(tape) if c.kind in _RESHARDING]
    idx = {c.index for c in resh}
    composed = set()
    for c in resh:
        if _derives(tape, c.index, idx - {c.index}):
            composed.add(c.index)
            for d in resh:
                if d.index < c.index and _derives(tape, c.index,
                                                  {d.index}):
                    composed.add(d.index)
    churn = [c for c in resh if c.kind != 'collective-permute'
             or c.index in composed]
    if len(churn) < ctx.reshard_churn_min:
        return []
    kinds = sorted({c.kind for c in churn})
    first = churn[0]
    return [Finding(
        rule='SHD303', severity=Severity.WARNING,
        context=f'step {"/".join(kinds)}',
        where=f'{ctx.specimen}:{_loc(first.source_loc, "step")}',
        message=(f'resharding churn inside one step ({"/".join(kinds)} '
                 f'round-trip) — the layout is bounced every step'),
        detail=(f'{len(churn)} resharding collective(s), '
                f'{sum(c.nbytes for c in churn)} B payload; settle the '
                f'layout once instead of round-tripping it'))]


def check_comm_budget(tape, ctx) -> List[Finding]:
    """SHD304: the run's collective payload over the recorded budget."""
    if not ctx.comm_budget_bytes:
        return []
    sched = collective_schedule(tape)
    total = sum(c.nbytes for c in sched)
    if total <= ctx.comm_budget_bytes:
        return []
    per_kind = {}
    for c in sched:
        per_kind[c.kind] = per_kind.get(c.kind, 0) + c.nbytes
    breakdown = ', '.join(f'{k}: {v} B' for k, v in sorted(per_kind.items()))
    return [Finding(
        rule='SHD304', severity=Severity.WARNING,
        where=f'{ctx.specimen}:comm-budget',
        message=(f'collective payload {pow2_bucket(total)} per step '
                 f'exceeds the recorded {ctx.comm_budget_bytes} B '
                 f'communication budget'),
        detail=(f'exact total {total} B over {len(sched)} collective(s) '
                f'— {breakdown}; either the new communication is intended '
                f'(raise the specimen budget in the registry and '
                f're-baseline) or a sharding boundary moved'))]


def _short(name):
    parts = name.split('.')
    return parts[1] if len(parts) >= 2 else name


def _bf16(dtype):
    return str(dtype).replace('torch.', '') == 'bfloat16'


def _downcast_makers(tape):
    """Buffers made by an explicit float32 → bf16 ``_to_copy``."""
    out = set()
    for op in tape.ops:
        if op.kind == 'op' and _short(op.name) in ('_to_copy', 'to') and \
                op.in_dtypes and str(op.in_dtypes[0]).endswith('float32') \
                and op.out_dtypes and _bf16(op.out_dtypes[0]):
            out.update(b for b, _ in op.allocs)
    return out


def check_precision_contract(tape, ctx) -> List[Finding]:
    """SHD305: an accumulation into a bf16 accumulator, worst when an
    explicit float32 → bf16 cast feeds it."""
    downcast = _downcast_makers(tape)
    out = []
    hits = 0
    for op in tape.ops:
        if op.kind == 'collective':
            info = op.collective
            if info['kind'] != 'all-reduce' or info['dtype'] != 'bfloat16':
                continue
            acc = _prod(info['shape']) * len(info['group'])
            what, context = 'all-reduce', (
                f'all-reduce bfloat16{list(info["shape"])}')
        elif op.kind == 'op' and _short(op.name) in _ACCUMULATING:
            if not op.out_dtypes or not _bf16(op.out_dtypes[0]):
                continue
            if _short(op.name).startswith('index_put') and not op.atomic:
                continue
            # The addends: the source tensor's elements (the largest
            # input that is not the accumulator).
            acc = max((_prod(s) for s in op.in_shapes[1:]), default=0) \
                if op.in_shapes else 0
            what = _short(op.name)
            context = f'{what} bfloat16{list(op.out_shapes[0])}'
        else:
            continue
        if acc < ctx.accum_elems:
            continue
        fed = any(b in downcast for b in op.reads + op.writes)
        if fed:
            message = (f'float32->bf16 downcast feeds `{what}` with a bf16 '
                       f'accumulator — float32-accumulation contract '
                       f'violation')
        else:
            message = (f'`{what}` accumulates in bf16 — '
                       f'float32-accumulation contract violation')
        out.append(Finding(
            rule='SHD305', severity=Severity.ERROR, context=context,
            where=f'{ctx.specimen}:'
                  f'{_loc(op.provenance, f"{what}#{hits}")}',
            message=message,
            detail=(f'{acc} element(s) accumulated into a bf16 result; a '
                    f'bf16 running sum stops absorbing addends at ~256x '
                    f'scale — sum in float32 and cast after '
                    f'(models/precision.py contract)')))
        hits += 1
    return out


def analyze_sharded_tape(tapes, ctx: Optional[ShardedContext] = None
                         ) -> List[Finding]:
    """All SHD rules over one specimen's run: ``tapes`` its ranks' tapes
    (rank 0 first; one tape for a single rank)."""
    ctx = ctx or ShardedContext()
    tapes = list(tapes) if isinstance(tapes, (list, tuple)) else [tapes]
    tape = tapes[0]
    out = []
    out += check_branch_divergence(tapes, ctx)
    out += check_corr_replication(tape, ctx)
    out += check_reshard_churn(tape, ctx)
    out += check_comm_budget(tape, ctx)
    out += check_precision_contract(tape, ctx)
    return disambiguate_contexts(out)


def run_sharded_tier(specimens=None, *, cache=None, comm_budget_bytes=None,
                     on_progress=None, skipped=None,
                     device=None) -> List[Finding]:
    """The SHD rules over every shd-tier specimen's run on its ranks
    (``cache``'s, shared with the other tiers; a new one on ``device``
    starting 4 ranks when none is given). ``comm_budget_bytes`` is
    SHD304's budget for a specimen without its own."""
    from dgmc_tpu_torch.analysis.registry import (SpecimenCache,
                                                  iter_runnable_specimens)
    cache = cache if cache is not None else SpecimenCache(device)
    findings = []
    for spec in iter_runnable_specimens('shd', specimens=specimens,
                                        on_progress=on_progress,
                                        skipped=skipped):
        if on_progress:
            on_progress(f'sharded {spec.name} on {cache.where(spec)}')
        art = cache.artifacts(spec)
        built = art.built()
        tapes = ([r['tape'] for r in art.ranks()] if hasattr(art, 'ranks')
                 else [art.recorded()['tape']])
        ctx = ShardedContext(
            specimen=spec.name, corr_bytes=built.get('corr_bytes'),
            comm_budget_bytes=built.get('comm_budget_bytes',
                                        comm_budget_bytes))
        findings.extend(analyze_sharded_tape(tapes, ctx))
    return findings
