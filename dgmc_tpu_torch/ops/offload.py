"""Host-RAM offload tier: corpus tables in host memory, device chunks
streamed through an N-deep prefetch ring.

The port of ``dgmc_tpu/ops/offload.py``. The streamed search
(:func:`~dgmc_tpu_torch.ops.topk.streamed_topk`) bounds the search's
memory by a chunk of rows, but its table still lives on the device. Here
the table stays in host RAM (pinned, so copies run without blocking) and
a :class:`PrefetchRing` keeps the next ``depth`` chunks in flight to the
device while the current one is searched; the results stream back to
pinned host memory. The device holds at most ``depth + 1`` chunks of the
table, whatever its size.

- :class:`PrefetchRing`: chunk ``i`` is copied host → device on a copy
  stream of its own; an event per slot, recorded after its copy, is what
  the compute stream waits on when :meth:`PrefetchRing.get` serves the
  chunk (the card's form of the JAX package's ``_pinned_put``). ``get(i)``
  tops the window ``i+1 .. i+depth`` back up and evicts every slot behind
  the cursor. One device: the JAX ring's round-robin over devices is not
  ported.
- :func:`offloaded_streamed_topk`: the source table in host RAM, source
  chunks through the ring against a device-resident target table;
  bit-identical to ``streamed_topk`` on the same inputs (the same
  searches of the same chunks in the same order).
- :func:`offloaded_corpus_topk`: the target (corpus) table in host RAM,
  target chunks through the ring, each chunk's top-k merged into a running
  per-row carry, carry first (a stable descending sort), so earlier target
  indices win ties as in the unchunked scan; unfilled carry slots hold
  ``(-inf, 0)``. Bit-identical to ``chunked_topk`` on the same inputs.

Both return host tensors ``(vals, idx)`` (``h``'s dtype — bfloat16 too —
and int32, ``[B, N_s, k]``) and an :class:`OffloadStats` account.

``python -m dgmc_tpu_torch.ops.offload`` runs the tier at scale
(:func:`main`): a synthetic corpus of ``--rows`` ψ₁ embeddings in host RAM
shortlisted against ``--targets`` device-resident targets through the
ring, a prefix re-shortlisted by the device-resident streamed search and
compared exactly, one JSON line.
"""

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.ops.graph import canonical_device
from dgmc_tpu_torch.ops.topk import (DEFAULT_BLOCK, chunked_topk,
                                     stable_topk)

__all__ = ['DEFAULT_PREFETCH_DEPTH', 'PrefetchRing', 'OffloadStats',
           'offloaded_streamed_topk', 'offloaded_corpus_topk', 'main']

#: The JAX package's measured default (depth 2 hides the copy behind the
#: per-chunk search there; a deeper ring only holds more device memory).
DEFAULT_PREFETCH_DEPTH = 2


class PrefetchRing:
    """N-deep host → device prefetch ring over a chunked host table.

    ``source`` is a host table whose leading axis is the chunk axis, or a
    callable ``i -> host chunk`` (``n_chunks`` then required). ``get(i)``
    takes a non-decreasing cursor: it returns chunk ``i`` on ``device``,
    issues the copies of ``i+1 .. i+depth`` and evicts every slot behind
    the cursor, so at most ``depth + 1`` chunks are on the device.
    ``puts`` / ``misses`` / ``evictions`` count copies issued, chunks
    served cold and slots dropped. ``device``: ``cuda`` by default.
    """

    def __init__(self, source, depth=DEFAULT_PREFETCH_DEPTH, n_chunks=None,
                 device=None):
        self._fn = (source.__getitem__ if hasattr(source, '__getitem__')
                    else source)
        if n_chunks is None:
            if not hasattr(source, 'shape'):
                raise ValueError('n_chunks is required for a callable '
                                 'source')
            n_chunks = source.shape[0]
        self.n_chunks = int(n_chunks)
        self.depth = max(1, int(depth))
        self.device = canonical_device(resolve_device(device))
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == 'cuda' else None)
        self._slots = {}   # i -> (device chunk, copy event, host chunk)
        self.puts = 0
        self.misses = 0
        self.evictions = 0

    def _issue(self, i):
        if i >= self.n_chunks or i in self._slots:
            return
        host = torch.as_tensor(self._fn(i))
        if self._copy is None:
            self._slots[i] = (host.to(self.device), None, host)
        else:
            if not host.is_pinned():
                host = host.pin_memory()
            with torch.cuda.stream(self._copy):
                dev = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy)
            self._slots[i] = (dev, done, host)
        self.puts += 1

    def get(self, i):
        """Device chunk ``i`` (its copy issued now on a cold miss), the
        current stream made to wait for its copy; the window ``i+1 ..
        i+depth`` re-armed and the slots behind the cursor evicted."""
        if i not in self._slots:
            self.misses += 1
            self._issue(i)
        out, done, _ = self._slots[i]
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            # Allocated on the copy stream, used on this one: its memory
            # is not reused before this stream's work on it is done.
            out.record_stream(compute)
        for j in range(i + 1, min(i + 1 + self.depth, self.n_chunks)):
            self._issue(j)
        for j in [j for j in self._slots if j < i]:
            del self._slots[j]
            self.evictions += 1
        return out

    @property
    def in_flight(self):
        return len(self._slots)


@dataclasses.dataclass
class OffloadStats:
    """The account one offloaded sweep returns: what lived where, and how
    the ring behaved."""
    rows: int
    chunks: int
    chunk: int
    prefetch_depth: int
    devices: int
    host_resident_bytes: int        # table + results, host RAM
    bytes_streamed: int             # table bytes copied host -> device
    ring_misses: int                # chunks served cold (no prefetch)
    ring_evictions: int
    wall_s: float

    def to_json(self):
        return dataclasses.asdict(self)


def _host_table(a, pin):
    """``a`` as a contiguous CPU tensor, pinned with ``pin`` (one copy
    where it is not already)."""
    t = torch.as_tensor(a).contiguous()
    if t.device.type != 'cpu':
        raise ValueError('the offloaded table lives in host memory')
    return t.pin_memory() if pin and not t.is_pinned() else t


def _nbytes(t):
    return t.numel() * t.element_size()


def _drain(pending, limit):
    """Wait for the oldest copies back to the host until at most ``limit``
    are pending."""
    while len(pending) > limit:
        done = pending.pop(0)
        if done is not None:
            done.synchronize()


def offloaded_streamed_topk(h_s_host, h_t, k, chunk, t_mask=None,
                            block=DEFAULT_BLOCK,
                            depth=DEFAULT_PREFETCH_DEPTH, device=None,
                            on_chunk: Optional[Callable[[int], None]] = None):
    """Chunk-streamed top-k with the source table ``h_s_host [B, N_s, C]``
    in host memory and ``h_t`` (``t_mask``) put on ``device`` once.

    Bit-identical to ``streamed_topk(h_s, h_t, k, chunk, t_mask, block)``
    on the device: the same searches of the same chunks (the last one
    ragged) in the same order; the ring only changes where a chunk waits.
    Each chunk's results are copied back to pinned host memory as soon as
    they are computed; at most ``depth`` such copies are outstanding.
    ``on_chunk(i)`` runs after chunk ``i`` is dispatched. Returns host
    ``(vals, idx, OffloadStats)``."""
    device = canonical_device(resolve_device(device))
    on_card = device.type == 'cuda'
    h_s_host = _host_table(h_s_host, on_card)
    B, N_s, C = h_s_host.shape
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f'chunk must be >= 1; got {chunk}')
    n_chunks = -(-N_s // chunk)
    ring = PrefetchRing(lambda i: h_s_host[:, i * chunk:(i + 1) * chunk],
                        depth=depth, n_chunks=n_chunks, device=device)
    h_t = torch.as_tensor(h_t).to(device)
    t_mask = None if t_mask is None else torch.as_tensor(t_mask).to(device)
    vals = torch.empty((B, N_s, k), dtype=h_s_host.dtype,
                       pin_memory=on_card)
    idx = torch.empty((B, N_s, k), dtype=torch.int32, pin_memory=on_card)
    pending, streamed = [], 0
    t0 = time.perf_counter()
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, N_s)
        dv, di = chunked_topk(ring.get(i), h_t, k, t_mask, block,
                              return_values=True)
        streamed += B * (hi - lo) * C * h_s_host.element_size()
        vals[:, lo:hi].copy_(dv, non_blocking=True)
        idx[:, lo:hi].copy_(di, non_blocking=True)
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record()
        pending.append(done)
        _drain(pending, ring.depth)
        if on_chunk is not None:
            on_chunk(i)
    _drain(pending, 0)
    wall = time.perf_counter() - t0
    stats = OffloadStats(
        rows=N_s, chunks=n_chunks, chunk=chunk, prefetch_depth=ring.depth,
        devices=1,
        host_resident_bytes=(_nbytes(h_s_host) + _nbytes(vals)
                             + _nbytes(idx)),
        bytes_streamed=streamed, ring_misses=ring.misses,
        ring_evictions=ring.evictions, wall_s=round(wall, 6))
    return vals, idx, stats


def offloaded_corpus_topk(h_s, h_t_host, k, chunk, t_mask=None,
                          block=DEFAULT_BLOCK,
                          depth=DEFAULT_PREFETCH_DEPTH, device=None,
                          on_chunk: Optional[Callable[[int], None]] = None):
    """Top-k candidate search with the target (corpus) table
    ``h_t_host [B, N_t, C]`` in host memory and the queries ``h_s`` on
    ``device``: target chunks of ``chunk`` rows through the ring, each
    chunk's top ``min(k, chunk rows)`` (their global indices) merged into
    a running ``[B, N_s, k]`` carry by one stable descending sort over
    (carry ‖ chunk), carry first.

    Bit-identical to ``chunked_topk(h_s, h_t, k, t_mask, block)`` on the
    same inputs, tie order included: each row's k best keep the lowest
    indices among equal values, masked columns score ``finfo.min`` with
    their own index. ``k`` may not exceed ``N_t``, as there. Returns host
    ``(vals, idx, OffloadStats)``."""
    device = canonical_device(resolve_device(device))
    on_card = device.type == 'cuda'
    h_t_host = _host_table(h_t_host, on_card)
    B, N_t, C = h_t_host.shape
    if not 1 <= k <= N_t:
        raise ValueError(f'k={k} must lie in [1, N_t={N_t}]')
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f'chunk must be >= 1; got {chunk}')
    n_chunks = -(-N_t // chunk)
    h_s = torch.as_tensor(h_s).to(device)
    t_mask = None if t_mask is None else torch.as_tensor(t_mask).to(device)
    ring = PrefetchRing(lambda i: h_t_host[:, i * chunk:(i + 1) * chunk],
                        depth=depth, n_chunks=n_chunks, device=device)
    N_s = h_s.shape[1]
    run_v = torch.full((B, N_s, k), -float('inf'), dtype=h_t_host.dtype,
                       device=device)
    run_i = torch.zeros((B, N_s, k), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, N_t)
        cv, ci = chunked_topk(h_s, ring.get(i), min(k, hi - lo),
                              None if t_mask is None else t_mask[:, lo:hi],
                              block, return_values=True)
        sv, pos = stable_topk(torch.cat([run_v, cv], dim=-1), k)
        run_i = torch.gather(torch.cat([run_i, ci + lo], dim=-1), -1, pos)
        run_v = sv
        if on_chunk is not None:
            on_chunk(i)
    vals, idx = run_v.cpu(), run_i.cpu()
    wall = time.perf_counter() - t0
    stats = OffloadStats(
        rows=N_t, chunks=n_chunks, chunk=chunk, prefetch_depth=ring.depth,
        devices=1,
        host_resident_bytes=(_nbytes(h_t_host) + _nbytes(vals)
                             + _nbytes(idx)),
        bytes_streamed=_nbytes(h_t_host), ring_misses=ring.misses,
        ring_evictions=ring.evictions, wall_s=round(wall, 6))
    return vals, idx, stats


# ---------------------------------------------------------------------------
# The offloaded-corpus run at scale
# ---------------------------------------------------------------------------


def _synthetic_corpus(rows, dim, seed, batch=1 << 20):
    """Host-side synthetic ψ₁ table ``[1, rows, dim]`` float32, drawn in
    bounded pieces, as the JAX package draws it)."""
    rng = np.random.RandomState(seed)
    out = np.empty((1, rows, dim), np.float32)
    for start in range(0, rows, batch):
        n = min(batch, rows - start)
        out[0, start:start + n] = rng.randn(n, dim).astype(np.float32)
    return out


def main(argv=None):
    import argparse
    import json

    from dgmc_tpu_torch.ops.topk import streamed_topk

    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.ops.offload',
        description='Offloaded shortlist at scale: a host-RAM ψ₁ table, an '
                    'N-deep device prefetch ring, the chunk-streamed top-k '
                    'on one device.')
    parser.add_argument('--rows', type=int, default=1 << 23,
                        help='corpus rows (source entities)')
    parser.add_argument('--targets', type=int, default=1 << 17)
    parser.add_argument('--dim', type=int, default=16)
    parser.add_argument('--k', type=int, default=10)
    parser.add_argument('--chunk', type=int, default=1 << 15)
    parser.add_argument('--block', type=int, default=8192,
                        help='target block of the plain scan (the kernels '
                             'ignore it)')
    parser.add_argument('--prefetch-depth', '--prefetch_depth',
                        dest='prefetch_depth', type=int,
                        default=DEFAULT_PREFETCH_DEPTH)
    parser.add_argument('--seed', type=int, default=8)
    parser.add_argument('--verify-rows', '--verify_rows', dest='verify_rows',
                        type=int, default=1 << 12,
                        help='leading corpus rows re-shortlisted by the '
                             'device-resident streamed search and compared '
                             'exactly (0 = skip)')
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             'plain path)')
    args = parser.parse_args(argv)

    device = canonical_device(resolve_device(args.device))
    t0 = time.perf_counter()
    corpus = _synthetic_corpus(args.rows, args.dim, args.seed)
    rng = np.random.RandomState(args.seed + 1)
    h_t = torch.from_numpy(
        rng.randn(1, args.targets, args.dim).astype(np.float32)).to(device)
    setup_s = time.perf_counter() - t0
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    vals, idx, stats = offloaded_streamed_topk(
        corpus, h_t, args.k, args.chunk, block=args.block,
        depth=args.prefetch_depth, device=device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else None)

    verified = None
    if args.verify_rows:
        n = min(args.verify_rows, args.rows)
        dv, di = streamed_topk(
            torch.from_numpy(np.ascontiguousarray(corpus[:, :n])).to(device),
            h_t, args.k, args.chunk, block=args.block, return_values=True)
        verified = bool(torch.equal(di.cpu(), idx[:, :n])
                        and torch.equal(dv.cpu(), vals[:, :n]))

    rec = {
        'metric': 'offloaded_shortlist',
        'rows': args.rows, 'targets': args.targets, 'dim': args.dim,
        'k': args.k, 'chunk': args.chunk, 'block': args.block,
        'device': str(device),
        'setup_s': setup_s,
        'rows_per_sec': args.rows / max(stats.wall_s, 1e-9),
        'offload': stats.to_json(),
        'device_peak_bytes': peak,
        'verified_rows': (None if verified is None
                          else min(args.verify_rows, args.rows)),
        'verified_equal': verified,
    }
    print(json.dumps(rec), flush=True)
    return 0 if verified is not False else 1


if __name__ == '__main__':
    import sys
    sys.exit(main())
