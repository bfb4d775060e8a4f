"""Buffer liveness: the static peak-live bytes of one recorded run.

The port's counterpart of the JAX package's ``analysis/hlo_liveness.py``,
over the tape of :mod:`~dgmc_tpu_torch.analysis.trace_rules` in the
place of post-GSPMD HLO:

- each op's new storages are allocated at its index and freed after
  their last use (a read, an in-place write, a kernel launch that was
  given them);
- views allocate nothing: a view's reads are its base's, so a view in
  use keeps its base alive (JAX's ``ALIAS_OPS``);
- the arguments (parameters, buffers, the optimizer's state, the batch)
  and any other storage there before the run stay live throughout, as
  JAX's parameters do; the run's outputs and what it leaves in its
  state (Adam's first moments, say) stay live to its end;
- no in-place aliasing of the declared state is assumed: an update
  that allocates a new storage is charged in full (JAX's conservative
  choice about donation).

The bound counts storages, not the caching allocator's blocks: it is
what the program needs, the allocator's measured peak what one run took
(``obs/cost.py``'s specimen rows print both on the card). No region
model: a PyTorch run is one flat sequence (JAX's ``while`` bodies have
no counterpart). Imports no torch: a tape is plain data.
"""

import dataclasses
from typing import Dict, List, Optional

__all__ = ['LiveBuffer', 'ComputationLiveness', 'module_peak',
           'peak_summary']


@dataclasses.dataclass
class LiveBuffer:
    """One buffer live at the peak point."""
    index: int
    buffer: int
    nbytes: int
    stage: str


@dataclasses.dataclass
class ComputationLiveness:
    """One run's liveness account (JAX's fields; the region fields stay
    empty)."""
    name: str
    #: Static peak-live bytes.
    peak_bytes: int
    #: Tape index of the peak point (-1: the arguments alone).
    peak_index: int
    #: Buffers live at the peak.
    live_at_peak: List[LiveBuffer]
    region_bytes: int = 0
    region_name: Optional[str] = None
    region_stage: Optional[str] = None

    def stage_bytes(self) -> Dict[str, int]:
        """Live bytes at the peak by pipeline stage (arguments under
        ``other``); the buckets sum to :attr:`peak_bytes`."""
        out: Dict[str, int] = {}
        for buf in self.live_at_peak:
            out[buf.stage] = out.get(buf.stage, 0) + buf.nbytes
        return out


def module_peak(tape, name='run') -> ComputationLiveness:
    """The static peak-live bound of one recorded run (see the module
    docstring)."""
    n = len(tape.ops)
    last = {}
    for op in tape.ops:
        for b in (*op.reads, *op.writes, *(b for b, _ in op.allocs)):
            last[b] = op.index
    for b in tape.outputs:
        last[b] = n
    live = {}
    current = 0
    for bid, buf in tape.buffers.items():
        if buf.origin != 'op':
            live[bid] = buf.nbytes
            current += buf.nbytes
    peak, peak_i, peak_live = current, -1, dict(live)
    frees = {}
    for bid, buf in tape.buffers.items():
        if buf.origin == 'op':
            frees.setdefault(last.get(bid, buf.index), []).append(bid)
    for op in tape.ops:
        for bid, nbytes in op.allocs:
            live[bid] = nbytes
            current += nbytes
        if current > peak:
            peak, peak_i, peak_live = current, op.index, dict(live)
        for bid in frees.get(op.index, ()):
            current -= live.pop(bid, 0)
    return ComputationLiveness(
        name=name, peak_bytes=peak, peak_index=peak_i,
        live_at_peak=[LiveBuffer(index=tape.buffers[b].index, buffer=b,
                                 nbytes=v,
                                 stage=tape.buffers[b].stage)
                      for b, v in sorted(peak_live.items())])


def peak_summary(tape) -> dict:
    """The fields ``obs/cost.py`` merges into ``efficiency.json``:
    ``static_peak_bytes`` (the one key this number carries on every
    surface, as in JAX) and the peak point's bytes by stage
    (``peak_stage_bytes``)."""
    lv = module_peak(tape)
    out = {'static_peak_bytes': lv.peak_bytes}
    stages = {k: v for k, v in sorted(lv.stage_bytes().items(),
                                      key=lambda kv: -kv[1]) if v}
    if stages:
        out['peak_stage_bytes'] = stages
    return out
