"""The collectives of one recorded run: their schedule and their table.

The port's counterpart of the JAX package's ``analysis/hlo_comm.py``.
JAX reads a partitioned program's collectives out of its compiled HLO;
the port's collectives are written out (:mod:`~dgmc_tpu_torch.parallel.
comm`) and each marks itself on the tape of the run that calls it
(:class:`~dgmc_tpu_torch.analysis.trace_rules.TapeRecorder`): one op of
kind ``'collective'`` carrying its kind in JAX's spelling, the group's
ranks, the dtype and shape of the tensor the caller holds, the payload
(JAX's ``result_bytes``: the gathered result of an all-gather) and,
like any op, its provenance, stage and the buffers it reads and writes.

- :func:`collective_schedule`: each collective in program order, with
  its kind, group, payload, stage and provenance — what the SHD tier
  (:mod:`~dgmc_tpu_torch.analysis.shd_rules`) reads.
- :func:`collective_table`: JAX's ``{'ops': {kind: {'count', 'bytes'}},
  'count', 'bytes'}``, the account ``obs/cost.py`` writes into
  ``efficiency.json``.

A PyTorch run is flat: a Python loop is unrolled on the tape, so a
collective in a loop appears once per iteration, where it ran (JAX's
table counts a while body's collective once). Imports no torch: a tape
is plain data.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ['COLLECTIVE_OPS', 'CollectiveOp', 'collective_schedule',
           'collective_table']

#: Cross-device collective kinds, JAX's spelling (``hlo_comm``).
COLLECTIVE_OPS = ('all-reduce', 'all-gather', 'reduce-scatter',
                  'all-to-all', 'collective-permute',
                  'collective-broadcast')


@dataclasses.dataclass
class CollectiveOp:
    """One collective in a run's communication schedule."""
    index: int
    kind: str
    group: Tuple[int, ...]
    dtype: str
    shape: Tuple[int, ...]
    #: Payload bytes (the result's, as JAX counts them).
    nbytes: int
    #: The result's shape (the gathered one for an all-gather).
    result_shape: Tuple[int, ...]
    stage: str
    source_loc: Optional[str]
    backward: bool = False

    @property
    def signature(self):
        """What every rank must agree on (SHD301): kind, group, dtype and
        shape."""
        return (self.kind, self.group, self.dtype, self.shape)


def collective_schedule(tape) -> List[CollectiveOp]:
    """The run's collectives in program order (see the module
    docstring)."""
    out = []
    for op in tape.ops:
        info = op.collective
        if op.kind != 'collective' or info is None:
            continue
        out.append(CollectiveOp(
            index=op.index, kind=info['kind'], group=tuple(info['group']),
            dtype=info['dtype'], shape=tuple(info['shape']),
            nbytes=int(info['payload']),
            result_shape=tuple(op.out_shapes[0]) if op.out_shapes else (),
            stage=op.stage,
            source_loc=(None if op.provenance in (None, '<unknown>')
                        else op.provenance),
            backward=op.backward))
    return out


def collective_table(tape) -> Dict:
    """Collective counts and payload bytes of one run: ``{'ops': {kind:
    {'count', 'bytes'}}, 'count', 'bytes'}`` (empty ``ops`` when the run
    moved nothing between ranks)."""
    ops: Dict[str, Dict[str, int]] = {}
    for c in collective_schedule(tape):
        row = ops.setdefault(c.kind, {'count': 0, 'bytes': 0})
        row['count'] += 1
        row['bytes'] += c.nbytes
    return {'ops': ops,
            'count': sum(r['count'] for r in ops.values()),
            'bytes': sum(r['bytes'] for r in ops.values())}
