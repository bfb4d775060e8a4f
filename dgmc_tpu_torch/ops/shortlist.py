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

__all__ = ['CHUNK', 'Shortlist', 'chunk_len']

#: Slots per chunk of a target's slot list (:attr:`Shortlist.chunks`) are
#: a multiple of CHUNK: one warp of the sparse-consensus backward sums one
#: chunk, CHUNK slots at a time.
CHUNK = 32


def chunk_len(deg):
    """Slots per chunk of a target with ``deg`` slots (int tensor):
    ``CHUNK * ceil(sqrt(deg) / CHUNK)``, at least CHUNK. A hub of d slots
    then has about sqrt(d) chunks of about sqrt(d) slots, so the warps
    that sum its chunks and the warp that adds the chunk sums each take
    about sqrt(d) / 32 rounds."""
    root = torch.sqrt(deg.double()).ceil().long()
    return CHUNK * torch.clamp((root + CHUNK - 1) // CHUNK, min=1)


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
    def idx32(self):
        """``idx`` as int32 ``[B, N_s, K]`` (the kernels' index type, as
        top-k emits it), made once."""
        return self.idx.int()

    @functools.cached_property
    def order32(self):
        """``order`` as int32, made once."""
        return self.order.int()

    @functools.cached_property
    def _deg(self):
        rows = self.idx.shape[0] * self.num_targets
        return self.offsets[1:rows + 1] - self.offsets[:rows]

    @functools.cached_property
    def chunks(self):
        """``(chunk_start, max_chunks)``: each target's slot list cut into
        chunks of :func:`chunk_len` slots; ``chunk_start [B*N_t + 1]``
        int32 is the exclusive prefix sum of ``ceil(slots / chunk_len)``
        per target (on the device, computed once) and ``max_chunks`` a
        host bound on its last entry (no device read)."""
        B, N_s, K = self.idx.shape
        deg = self._deg
        start = torch.zeros(deg.numel() + 1, dtype=torch.int32,
                            device=self.device)
        start[1:] = torch.cumsum(-(-deg // chunk_len(deg)), dim=0)
        return start, deg.numel() + -(-B * N_s * K // CHUNK)

    @functools.cached_property
    def chunk_map(self):
        """``[max_chunks, 4]`` int32, one row per chunk of :attr:`chunks`:
        ``(target row b*N_t + t, its first position in order, its slots,
        0)``; rows past the last chunk are ``(-1, 0, 0, 0)``. The
        sparse-consensus backward's chunk warps read their work from it,
        made once per shortlist on the device (no host sync)."""
        start, bound = self.chunks
        rows = start.numel() - 1
        c = torch.arange(bound, device=self.device, dtype=torch.int32)
        tgt = torch.searchsorted(start[1:], c, right=True)
        real = tgt < rows
        t = tgt.clamp(max=rows - 1)
        length = chunk_len(self._deg)[t]
        first = self.offsets[t] + (c - start[t]).long() * length
        slots = torch.minimum(self.offsets[t + 1] - first, length)
        # torch.where, not a masked assignment: no device-to-host sync.
        zero = torch.zeros_like(first)
        out = torch.stack([torch.where(real, t.long(), -1),
                           torch.where(real, first, zero),
                           torch.where(real, slots, zero), zero], dim=1)
        return out.int().contiguous()

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
