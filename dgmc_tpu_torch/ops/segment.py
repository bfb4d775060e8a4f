"""Segment reductions by segment ids (``dgmc_tpu/ops/segment.py``).

``data [E, ...]`` rows summed (or averaged) into ``num_segments``
buckets by ``segment_ids [E]``, as ``jax.ops.segment_sum`` does: ids
outside ``[0, num_segments)`` are dropped and empty segments give zeros.
Deterministic on every device: a stable sort of the ids, then
``torch.segment_reduce`` over the sorted rows (no ``index_add_``, whose
CUDA form adds with atomics in no fixed order), accumulated in float32 at
least and cast back to the data's dtype once; integer data (exact in any
order) by differences of a running sum. The graph layers use
:func:`~dgmc_tpu_torch.ops.graph.segment_sum`, which takes a sort made
once per batch instead of ids.
"""

import torch

__all__ = ['segment_sum', 'segment_mean']


def segment_sum(data, segment_ids, num_segments):
    """Sum ``data`` rows into ``num_segments`` buckets per
    ``segment_ids``: ``[E, ...]``, ``[E]`` → ``[num_segments, ...]``."""
    ids, order = torch.sort(segment_ids.reshape(-1).long(), stable=True)
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    # The rows of ids in [0, num_segments), first at bounds[0]; taken
    # without reading bounds on the host (the tail past them is summed
    # into one extra segment and dropped).
    E = order.shape[0]
    at = (bounds[0] + torch.arange(E, device=ids.device)).clamp(max=E - 1)
    rows = data[order[at]]
    lengths = bounds[1:] - bounds[:-1]
    if not data.is_floating_point():
        # Integers add exactly in any order: differences of a running sum.
        run = torch.cat([rows.new_zeros((1,) + rows.shape[1:]),
                         rows.cumsum(0)])
        return run[bounds[1:] - bounds[0]] - run[bounds[:-1] - bounds[0]]
    acc = torch.promote_types(data.dtype, torch.float32)
    rest = (E - lengths.sum()).reshape(1)
    out = torch.segment_reduce(rows.to(acc), 'sum',
                               lengths=torch.cat([lengths, rest]), axis=0)
    return out[:num_segments].to(data.dtype)


def segment_mean(data, segment_ids, num_segments, weights=None):
    """Mean of ``data`` rows per segment. ``weights`` (optional ``[E]``
    float, e.g. an edge-validity mask) scales each row's contribution and
    the denominator; empty segments give zeros."""
    if weights is not None:
        data = data * weights[..., None]
        counts = segment_sum(weights, segment_ids, num_segments)
    else:
        counts = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype,
                                        device=data.device),
                             segment_ids, num_segments)
    totals = segment_sum(data, segment_ids, num_segments)
    return totals / torch.clamp(counts, min=1.0)[..., None]
