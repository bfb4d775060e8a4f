"""Recompile-hazard pass: abstract step signatures across padding buckets.

The port's copy of the JAX package's ``dgmc_tpu/analysis/recompile.py``
(the same signatures, findings and messages; the CPU tests hold them
equal). Every distinct padding bucket the host-side collation emits
(``utils/data.pad_pair_batch`` — ``(batch, N_s x N_t, E_s x E_t)``) is a
distinct input signature for whatever compiled step consumes the batch,
i.e. one more captured CUDA graph (:mod:`~dgmc_tpu_torch.train.compiled`):
warm-up and capture time and the graph's private memory pool.

Two findings:

``RCP201`` avoidable-compile-churn
    A bucket is *dominated* by another (every padded dimension <= at the
    SAME pair-batch size): collating into the bigger bucket's padding
    would serve both batches with ONE program at the cost of a few
    masked rows. Dominated buckets are pure churn. The pair-batch axis
    (``B`` — ``--pairs-per-step`` replicas x pairs) is deliberately NOT
    a padding axis: padding ``B`` up replicates the entire per-pair cost
    (not a few masked rows) and changes how many independent gradient
    samples one step averages, so buckets that differ only in ``B`` are
    distinct programs by design, never churn.
``RCP202`` compile-churn-telemetry
    Cross-check against a recorded ``obs`` run (``--obs-dir``): the run
    captured far more graphs than its distinct padding buckets can
    explain — recaptures are coming from somewhere else (an input whose
    identity changes per call, a dtype flip), which the padding analysis
    alone cannot see.

**What the RCP202 budget counts.** The port's run plane records two
kinds of compile event (``timings.json``'s ``compile.by_kind``): a
``capture`` (one per step function and input signature) and an
``nvcc`` build of a kernel source (one per source under ``csrc/`` that
the process finds unbuilt in ``_build/``). Only captures are programs
of a padding bucket: builds are keyed by the source's hash, happen at
most once per source however many buckets run, and vanish once
``_build/`` is warm. :func:`load_obs_buckets` therefore returns the
capture count where the telemetry splits the kinds (a cold ``_build/``
adds six ``nvcc`` events, which against the budget of ``distinct x 8``
would flag a one-bucket KG run's four captures), and the total where it
does not (a JAX run's ``timings.json``).

The signature hash is over flattened ``(shape, dtype)`` leaves only —
what a compiled step's record is keyed on for tensor inputs.
"""

import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from dgmc_tpu_torch.analysis.findings import Finding, Severity


def signature_of(avals: Sequence[Tuple[Tuple[int, ...], str]]) -> str:
    """Stable hash of a flattened abstract signature:
    ``[(shape, dtype), ...]``."""
    ident = ';'.join(f'{tuple(s)}:{d}' for s, d in avals)
    return hashlib.sha256(ident.encode()).hexdigest()[:16]


def pair_batch_avals(batch: int, nodes_s: int, nodes_t: int, edges_s: int,
                     edges_t: int, feat_dim: int = 32,
                     edge_dim: Optional[int] = None, dtype: str = 'float32',
                     ) -> List[Tuple[Tuple[int, ...], str]]:
    """The abstract leaves of a collated ``PairBatch`` for one padding
    bucket — mirrors the port's ``utils/data.pad_pair_batch`` exactly
    (the same arrays in the same order, the same dtypes: ``s``'s dict,
    ``t``'s, then ``y`` and ``y_mask``), without building a single
    array."""
    def side(n, e):
        leaves = [((batch, n, feat_dim), dtype),        # x
                  ((batch, e), 'int32'),                # senders
                  ((batch, e), 'int32'),                # receivers
                  ((batch, n), 'bool'),                 # node_mask
                  ((batch, e), 'bool')]                 # edge_mask
        if edge_dim:
            leaves.append(((batch, e, edge_dim), dtype))
        return leaves

    return (side(nodes_s, edges_s) + side(nodes_t, edges_t)
            + [((batch, nodes_s), 'int32'),             # y
               ((batch, nodes_s), 'bool')])             # y_mask


def bucket_signature(bucket: Dict) -> str:
    """Signature of one padding-bucket dict
    (``{batch, nodes: 'AxB', edges: 'CxD'}`` — the obs telemetry row
    format of ``registry.padding_bucket_table``)."""
    ns, nt = _split_pair(bucket['nodes'])
    es, et = _split_pair(bucket['edges'])
    return signature_of(pair_batch_avals(int(bucket['batch']), ns, nt,
                                         es, et))


def _split_pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    m = re.match(r'^(\d+)x(\d+)$', str(v))
    if m:
        return int(m.group(1)), int(m.group(2))
    n = int(v)
    return n, n


def _dims(bucket: Dict) -> Tuple[int, ...]:
    ns, nt = _split_pair(bucket['nodes'])
    es, et = _split_pair(bucket['edges'])
    return (int(bucket['batch']), ns, nt, es, et)


def _bucket_label(bucket: Dict) -> str:
    return (f'B={bucket["batch"]},nodes={bucket["nodes"]},'
            f'edges={bucket["edges"]}')


def analyze_buckets(buckets: Sequence[Dict], *, specimen='padding',
                    compile_events: Optional[int] = None,
                    programs_per_bucket: int = 8) -> List[Finding]:
    """Churn findings over padding-bucket rows.

    Args:
        buckets: rows of ``{batch, nodes, edges[, count]}`` (obs
            telemetry format).
        compile_events: compile-event count of a recorded run (obs
            ``timings.json``), for the RCP202 cross-check.
        programs_per_bucket: how many captures one bucket legitimately
            feeds (the steps that consume its batches: a KG run's
            phase-1, eval, phase-2 and eval steps share one bucket); the
            telemetry check allows ``distinct_signatures * this`` before
            flagging.
    """
    findings = []
    dims = [(_dims(b), b) for b in buckets]
    for d, b in dims:
        # Domination holds the pair-batch axis fixed (od[0] == d[0]):
        # B is a structural axis — a B=1 batch cannot ride a B=2
        # program without doubling the step's work and changing its
        # gradient semantics — so only the node/edge PADDING axes are
        # collatable.
        dominators = [ob for od, ob in dims
                      if od != d and od[0] == d[0]
                      and all(x >= y for x, y in zip(od, d))]
        if dominators:
            dom = max(dominators, key=lambda ob: _dims(ob))
            # The JAX package's words, kept so that one bucket table
            # gives the same findings and fingerprints in both packages.
            findings.append(Finding(
                rule='RCP201', severity=Severity.WARNING,
                where=f'{specimen}:{_bucket_label(b)}',
                message=(f'padding bucket ({_bucket_label(b)}) is '
                         f'dominated by ({_bucket_label(dom)}) — '
                         f'collating into the larger padding removes '
                         f'one XLA program per consuming step'),
                detail=f'seen {b.get("count", "?")} time(s); each '
                       f'distinct bucket recompiles every jitted step '
                       f'that consumes the batch'))
    if compile_events is not None and buckets:
        distinct = len({bucket_signature(b) for b in buckets})
        budget = max(1, distinct) * programs_per_bucket
        if compile_events > budget:
            findings.append(Finding(
                rule='RCP202', severity=Severity.WARNING,
                where=f'{specimen}:telemetry',
                message=(f'{compile_events} compile events for '
                         f'{distinct} distinct padding signature(s) '
                         f'(budget {budget}) — recompiles not explained '
                         f'by padding (unstable static args / trace-time '
                         f'Python values?)'),
                detail='cross-checked against obs compile telemetry '
                       '(timings.json compile.events)'))
    return findings


def load_obs_buckets(obs_dir: str) -> Tuple[List[Dict], Optional[int]]:
    """``(padding_bucket_rows, compile_events)`` from a recorded obs run
    directory (``timings.json``); ``([], None)`` when absent. The events
    are the captures where ``compile.by_kind`` splits them from the
    kernel builds, else every event (see the module docstring)."""
    path = os.path.join(obs_dir, 'timings.json')
    if not os.path.exists(path):
        return [], None
    with open(path) as f:
        t = json.load(f)
    compile_ = t.get('compile') or {}
    events = compile_.get('events')
    by_kind = compile_.get('by_kind')
    if events is not None and by_kind is not None:
        events = int(by_kind.get('capture', 0))
    return list(t.get('padding_buckets') or []), events
