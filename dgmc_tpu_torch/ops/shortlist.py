"""The candidate shortlist of a sparse correspondence and its receiver
order.

A :class:`Shortlist` holds ``S_idx [B, N_s, K]`` (candidate target
columns per source row) and, built once, the stable sort of its ``B·N_s·K``
slots by target (:func:`~dgmc_tpu_torch.ops.graph.segments`). Every
reduction onto the targets of one forward reads that one order: the
``r_t = Sᵀ r_s`` projection of each consensus step, the gradient of the
candidate gather, and the sparse-consensus kernel's ``d_o_t`` pass. So
each sums in a fixed order without atomics, on every device.
"""

import functools

import torch

from dgmc_tpu_torch.ops.graph import gather_nodes, segment_sum, segments

__all__ = ['CHUNK', 'Shortlist']

#: Slots per chunk of a target's slot list (:attr:`Shortlist.chunks`):
#: one warp of the sparse-consensus kernel's target pass sums one chunk.
CHUNK = 32


class Shortlist:
    """``idx [B, N_s, K]`` int candidates in ``[0, num_targets)``.

    Indices are not range-checked here: whoever uploads them checks
    (the kernels index target rows unchecked).
    """

    def __init__(self, idx, num_targets):
        if idx.dim() != 3:
            raise ValueError(f'a shortlist is [B, N_s, K]; got '
                             f'{tuple(idx.shape)}')
        self.idx = idx.long().contiguous()
        self.num_targets = int(num_targets)
        B, N_s, K = self.idx.shape
        self.flat = self.idx.reshape(B, N_s * K)
        # (order, offsets): slot ids of the flattened batch sorted by
        # (b, target); target (b, t) owns order[offsets[b*N_t+t] :
        # offsets[b*N_t+t+1]].
        self.order, self.offsets = segments(self.flat, None,
                                            self.num_targets)

    @property
    def shape(self):
        return tuple(self.idx.shape)

    @property
    def device(self):
        return self.idx.device

    @functools.cached_property
    def chunks(self):
        """``(chunk_start, max_chunks)``: each target's slot list cut into
        chunks of :data:`CHUNK`; ``chunk_start [B*N_t + 1]`` is the
        exclusive prefix sum of ``ceil(slots / CHUNK)`` per target (on the
        device, computed once) and ``max_chunks`` a host bound on its last
        entry (no device read)."""
        B, N_s, K = self.idx.shape
        rows = B * self.num_targets
        deg = self.offsets[1:rows + 1] - self.offsets[:rows]
        start = torch.zeros(rows + 1, dtype=torch.int64, device=self.device)
        start[1:] = torch.cumsum((deg + CHUNK - 1) // CHUNK, dim=0)
        return start, rows + -(-B * N_s * K // CHUNK)

    def gather(self, feat):
        """``feat [B, N_t, C]`` → candidate rows ``[B, N_s, K, C]``; the
        gradient w.r.t. ``feat`` sums in the shortlist's order."""
        B, N_s, K = self.idx.shape
        rows = gather_nodes(feat, self.flat, (self.order, self.offsets))
        return rows.reshape(B, N_s, K, feat.shape[-1])

    def scatter(self, msgs):
        """``msgs [B, N_s, K, C]`` summed onto the targets →
        ``[B, N_t, C]`` (float32 accumulation, cast back once)."""
        B, N_s, K, C = msgs.shape
        out = segment_sum(msgs.reshape(B, N_s * K, C), self.order,
                          self.offsets, self.num_targets)
        return out.to(msgs.dtype)

    @classmethod
    def identity(cls, B, N_s, K, device):
        """Slot ``(s, k)`` points at target row ``s*K + k`` of a
        ``[B, N_s*K, ...]`` table: the narrow form's pre-gathered
        candidates seen as a target table."""
        idx = torch.arange(N_s * K, device=device).reshape(1, N_s, K)
        return cls(idx.expand(B, N_s, K), N_s * K)
