"""Rank-sharded top-k candidate search: every rank runs the port's own
search (:func:`~dgmc_tpu_torch.ops.topk.chunked_topk` /
:func:`~dgmc_tpu_torch.ops.topk.streamed_topk`: the CUDA top-k kernel on
the card, its plain version on the CPU) on its part of the
``N_s x N_t`` sweep.

- **Rows** (:func:`sharded_topk_rows`): source rows split over a mesh
  axis, each rank scanning every target for its rows. No communication;
  an all-gather only where the caller asks for the whole.
- **Columns** (:func:`sharded_topk_cols`): targets split; each rank's
  top-k over its column shard, lifted to global columns, then one
  all-gather of the ``[B, N_s, k]`` values and indices and the merge in
  the dense tie order.
- **Correspondence sharding** (:func:`corr_sharded_topk`): the rows of a
  ``corr`` layout (batch over one axis, rows over another), ragged rows
  padded to the rank count; with ``ring`` the targets are split over the
  row axis too and each rank visits the shards in JAX's ring order
  (its own first, then the one its left neighbour held, and so on),
  merging the shards' candidates once after the ring. Where the corpus
  table ``h_t`` is sharded (DGMC's ``corpus_sharding``: ψ₁ computed this
  rank's shard only), the ring moves the shards as JAX's does: each
  rotation issues a
  :func:`~dgmc_tpu_torch.parallel.comm.collective_permute` of the shard
  it holds (and its ``t_mask`` slice) to the right neighbour before it
  searches that shard, and waits for the left neighbour's before the
  next rotation: ``n - 1`` permutes a search. Otherwise ψ₁ ran whole on
  every rank, every rank holds every shard and takes each from its own
  copy: the ring moves no data.

Indices are bit-identical to :func:`~dgmc_tpu_torch.ops.topk.dense_topk`,
ties included, and the search is not differentiable (it runs under
``torch.no_grad``), as JAX's ``_ad_opaque`` makes it.
"""

import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.topk import (DEFAULT_TOPK_BLOCK, chunked_topk,
                                     stable_topk, streamed_topk)
from dgmc_tpu_torch.parallel.comm import all_gather, collective_permute
from dgmc_tpu_torch.parallel.mesh import MODEL_AXIS

__all__ = ['sharded_topk_rows', 'sharded_topk_cols', 'corr_sharded_topk',
           'row_block']


def _search(h_s, h_t, k, t_mask, block, chunk, return_values=False):
    if chunk:
        return streamed_topk(h_s, h_t, k, int(chunk), t_mask=t_mask,
                             block=block, return_values=return_values)
    return chunked_topk(h_s, h_t, k, t_mask=t_mask, block=block,
                        return_values=return_values)


def _record(h_s):
    """The decision JAX records as ``topk_embedded``: the kernel on the
    card (its wrapper launches or raises), the plain version on the
    CPU."""
    if h_s.is_cuda:
        dispatch.record('topk_embedded', 'kernel', 'cuda', h_s.dtype)
    else:
        dispatch.record('topk_embedded', 'plain', 'device=cpu', h_s.dtype)


def row_block(num_rows, parts, index):
    """``(lo, hi, padded)``: block ``index`` of ``num_rows`` rows padded up
    to ``parts`` equal blocks."""
    padded = num_rows + (-num_rows) % parts
    per = padded // parts
    return index * per, (index + 1) * per, padded


def sharded_topk_rows(mesh, h_s, h_t, k, t_mask=None,
                      block=DEFAULT_TOPK_BLOCK, axis=MODEL_AXIS, chunk=None,
                      gather=False):
    """Top-k of this rank's source rows of ``h_s [B, N_s, C]`` (``N_s``
    divisible by the axis size) against every target: ``[B, N_s / n, k]``
    int32, or, with ``gather``, every rank's rows ``[B, N_s, k]``.
    ``chunk`` streams the rank's rows ``chunk`` at a time."""
    n = mesh.axis_size(axis)
    if h_s.shape[1] % n:
        raise ValueError(f'N_s={h_s.shape[1]} not divisible by {n} shards '
                         f'(pad rows first)')
    lo, hi, _ = row_block(h_s.shape[1], n, mesh.axis_index(axis))
    _record(h_s)
    with torch.no_grad():
        out = _search(h_s[:, lo:hi], h_t, k, t_mask, block, chunk)
    return all_gather(out, mesh.group(axis), dim=1) if gather else out


def _merge_candidates(vals, idx, tile_vals, tile_idx, k):
    """Merge two candidate sets into the running top-k in the dense tie
    order: sorted by global column first, so equal values resolve to the
    lowest column whatever order the shards arrive in."""
    all_vals = torch.cat([vals, tile_vals], dim=-1)
    all_idx = torch.cat([idx, tile_idx], dim=-1)
    order = torch.sort(all_idx, dim=-1, stable=True)[1]
    all_vals = torch.gather(all_vals, -1, order)
    all_idx = torch.gather(all_idx, -1, order)
    new_vals, pos = stable_topk(all_vals, k)
    return new_vals, torch.gather(all_idx, -1, pos)


def sharded_topk_cols(mesh, h_s, h_t, k, t_mask=None,
                      block=DEFAULT_TOPK_BLOCK, axis=MODEL_AXIS):
    """Top-k with target columns split over ``axis``: each rank searches
    its ``N_t / n`` columns, one all-gather of the candidates merges them;
    every rank returns the whole ``[B, N_s, k]`` int32. Refuses ``N_t``
    not divisible by the shard count and ``k`` above the columns per
    shard."""
    B, N_t = h_t.shape[0], h_t.shape[1]
    n = mesh.axis_size(axis)
    if N_t % n:
        raise ValueError(f'N_t={N_t} not divisible by {n} shards')
    shard_cols = N_t // n
    if k > shard_cols:
        raise ValueError(f'k={k} exceeds columns per shard ({shard_cols})')
    me = mesh.axis_index(axis)
    cols = slice(me * shard_cols, (me + 1) * shard_cols)
    _record(h_s)
    with torch.no_grad():
        vals, idx = chunked_topk(
            h_s, h_t[:, cols], k,
            t_mask=None if t_mask is None else t_mask[:, cols], block=block,
            return_values=True)
        idx = idx + me * shard_cols
        group = mesh.group(axis)
        all_vals = all_gather(vals, group, dim=-1)
        all_idx = all_gather(idx, group, dim=-1)
        return _merge_candidates(all_vals[..., :0], all_idx[..., :0],
                                 all_vals, all_idx, k)[1]


def corr_sharded_topk(sharding, h_s, h_t, k, t_mask,
                      block=DEFAULT_TOPK_BLOCK, chunk=None, ring=False,
                      local_rows=False, t_shard=None):
    """This rank's block of the top-k under a correspondence sharding
    (``sharding.spec``: the batch axis, then the rows' axis): ``h_s``,
    ``h_t`` and ``t_mask`` whole on every rank, the result this rank's
    ``[B / n_b, rows, k]`` int32, ``rows`` the source rows padded up to
    the row ranks' count and split evenly (padded rows are discarded
    work). A batch that does not divide over its axis returns ``None``.
    ``chunk`` streams the rank's rows; ``ring`` splits the targets over
    the row axis too and rotates them (see the module docstring), falling
    back to the whole targets when ``k`` exceeds a shard's columns or the
    row axis has one rank. ``local_rows``: ``h_s`` is already this rank's
    rows (ψ₁ row-restricted). ``t_shard``: this rank's shard of the
    targets (``[B, shard_cols, C]``, the rows of
    :func:`row_block` over the row axis; ``h_t`` ``None``), which the
    ring moves rank to rank; where the ring falls back, the shards are
    all-gathered first."""
    mesh = sharding.mesh
    b_ax, s_ax = sharding.axis(0), sharding.axis(1)
    B, N_s = h_s.shape[0], h_s.shape[1]
    n_b = mesh.axis_size(b_ax)
    if B % n_b:
        return None
    if n_b > 1:
        per_b = B // n_b
        take = slice(mesh.axis_index(b_ax) * per_b,
                     (mesh.axis_index(b_ax) + 1) * per_b)
        h_s = h_s[take]
        h_t = None if h_t is None else h_t[take]
        t_shard = None if t_shard is None else t_shard[take]
        t_mask = None if t_mask is None else t_mask[take]
    n_s = mesh.axis_size(s_ax)
    me = mesh.axis_index(s_ax)
    if not local_rows:
        lo, hi, padded = row_block(N_s, n_s, me)
        if padded != N_s:
            h_s = torch.nn.functional.pad(h_s, (0, 0, 0, padded - N_s))
        h_s = h_s[:, lo:hi]
    ref = h_t if h_t is not None else t_shard
    if t_mask is None:
        N_t = (h_t.shape[1] if h_t is not None
               else t_shard.shape[1] * n_s)
        t_mask = torch.ones((ref.shape[0], N_t), dtype=torch.bool,
                            device=ref.device)
    N_t = t_mask.shape[1]
    _record(h_s)
    with torch.no_grad():
        rows = h_s
        if ring and n_s > 1 and isinstance(s_ax, str):
            shard_cols = (N_t + (-N_t) % n_s) // n_s
            if k <= shard_cols:
                return _ring_topk(n_s, me, shard_cols, rows, h_t, t_mask, k,
                                  block, chunk, t_shard=t_shard,
                                  group=None if t_shard is None
                                  else mesh.group(s_ax))
        if h_t is None:
            h_t = all_gather(t_shard, mesh.group(s_ax), dim=1)[:, :N_t]
        return _search(rows, h_t, k, t_mask, block, chunk)


def _ring_topk(n_ring, me, shard_cols, rows, h_t, t_mask, k, block,
               chunk, t_shard=None, group=None):
    """The rotating-shard search of :func:`corr_sharded_topk`.

    One rotation per target shard: after ``j`` rotations rank ``d``
    searches shard ``(d - j) mod n`` (the one JAX's ring hands it then):
    received from the left neighbour where the ranks hold their shards
    (``t_shard``; each rotation's permute of the shard held is issued
    before its search and waited for after it), else taken from the
    rank's own whole ``h_t`` (see the module docstring). Local positions
    lift to global columns at ``shard_id * shard_cols``; a position past
    a shard's width maps beyond the padded range, where it can never take
    an equal-value tie from a real column. Targets are padded up to the
    ring (masked columns). The shards' candidates are merged once, after
    the ring."""
    N_t = t_mask.shape[1]
    pad = n_ring * shard_cols - N_t
    if pad:
        t_mask = torch.nn.functional.pad(t_mask, (0, pad))
        if h_t is not None:
            h_t = torch.nn.functional.pad(h_t, (0, 0, 0, pad))
    if t_shard is not None:
        own = slice(me * shard_cols, (me + 1) * shard_cols)
        held = (t_shard, t_mask[:, own].contiguous())
    vals, idx = [], []
    for j in range(n_ring):
        shard_id = (me - j) % n_ring
        if t_shard is None:
            cols = slice(shard_id * shard_cols, (shard_id + 1) * shard_cols)
            shard, mask = h_t[:, cols], t_mask[:, cols]
        else:
            shard, mask = held
            if j + 1 < n_ring:
                moving = collective_permute(held, group)
        tv, tp = _search(rows, shard, k, mask, block, chunk,
                         return_values=True)
        vals.append(tv)
        idx.append(torch.where(tp < shard_cols, shard_id * shard_cols + tp,
                               n_ring * shard_cols + tp).to(torch.int32))
        if t_shard is not None and j + 1 < n_ring:
            held = moving.wait()
    # One merge of every shard's candidates after the ring: the searches
    # are independent (no merge on the loop's chain), and the dense tie
    # order makes it the running merge's result.
    vals, idx = torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)
    return _merge_candidates(vals[..., :0], idx[..., :0], vals, idx, k)[1]
