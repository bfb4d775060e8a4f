"""Scatter-free routing for the sparse correspondence candidate set.

The port of ``dgmc_tpu/ops/corr_route.py``. Per consensus step the sparse
loop projects the indicator functions onto the targets through the
candidate set (``r_t[t] += S[s, k] * r_s[s]`` for every
``S_idx[s, k] == t``) and gathers the targets' colourings back at the
candidates, whose gradient is a sum onto the targets again. ``S_idx`` is
the same for every step of one forward and for the backward, so it is
sorted once per forward, on its device (:func:`build_corr_route`), and
every one of those sums reads that order:

- :func:`sparse_project` (``r_t``): the routed sum of ``r_s``'s rows,
  each scaled by its ``S`` value. Its backward needs no routing: in the
  ``[N_s, K]`` order the cotangent is ``d_r_t`` gathered at ``S_idx``,
  reduced over ``K``.
- :func:`sparse_gather` (the candidate rows): a plain row gather forward;
  its backward routes the cotangent's ``N_s * K`` rows onto the targets.

Both sums go through :mod:`~dgmc_tpu_torch.ops.kernels.blocked`'s routed
wrappers: on a CUDA tensor the hand-written blocked kernel
(``csrc/blocked.cu``, ``dgmc_blocked_route``) sums each target's entries
over the route's row table, in the table's order; on a CPU tensor the
plain version is JAX's one-hot form over the blocked fields
(:func:`~dgmc_tpu_torch.ops.blocked.plain_aggregate` with a scale).

:class:`CorrRoute` holds JAX's fields bit for bit (``ent``, ``src``,
``dst_local``, ``mask``, ``range_id``: the candidates sorted by target
with a stable sort, cut into ``num_ranges + E // block_entries`` blocks
of ``block_entries`` whose targets lie in one range of ``rows``) and the
row table the kernel reads: ``row_ptr [B, n_t + 1]`` and, per target in
the stable sort's order (JAX's block order), ``row_ent`` (the flat
candidate ``s * K + k``) and ``row_src`` (its source row ``s``). Every
candidate is in the table, those of padded source rows too: ``S`` is 0
there (the projection) or the cotangent is (the gather), so the shapes
are static and a captured step builds the route itself.
"""

import dataclasses

import torch

from dgmc_tpu_torch.ops import blocked as blocked_ops

__all__ = ['CorrRoute', 'RouteTable', 'build_corr_route', 'sparse_project',
           'sparse_gather']

_TENSORS = ('ent', 'src', 'dst_local', 'mask', 'range_id', 'row_ptr',
            'row_ent', 'row_src')


@dataclasses.dataclass(frozen=True)
class RouteTable:
    """One routed sum's tables, in the fields
    :func:`~dgmc_tpu_torch.ops.blocked.plain_aggregate` and
    :func:`~dgmc_tpu_torch.ops.blocked.ordered_aggregate` read: the
    blocked form (``src``, the rows of the summed table) and the row
    table (``row_src``, the same rows in each target's order)."""
    src: torch.Tensor
    dst_local: torch.Tensor
    mask: torch.Tensor
    range_id: torch.Tensor
    row_ptr: torch.Tensor
    row_src: torch.Tensor
    rows: int
    num_ranges: int
    gather_dtype: None = None


@dataclasses.dataclass(frozen=True)
class CorrRoute:
    """The blocked routing of one candidate set ``S_idx [B, N_s, K]``.

    JAX's fields: ``ent [B, NB, E_b]`` int32 flat candidate (``s * K +
    k``) per blocked entry, ``src`` its source row, ``dst_local`` /
    ``mask`` / ``range_id`` / ``rows`` / ``num_ranges`` as in
    :class:`~dgmc_tpu_torch.ops.blocked.EdgeBlocks`, ``n_t`` the target
    count. The row table: ``row_ptr [B, n_t + 1]`` int32, target ``t``'s
    entries at ``row_ptr[t]:row_ptr[t + 1]`` of ``row_ent`` / ``row_src``
    ``[B, N_s * K]`` int32 (every candidate, in the stable sort's order).
    """
    ent: torch.Tensor
    src: torch.Tensor
    dst_local: torch.Tensor
    mask: torch.Tensor
    range_id: torch.Tensor
    row_ptr: torch.Tensor
    row_ent: torch.Tensor
    row_src: torch.Tensor
    rows: int
    num_ranges: int
    n_t: int

    def tensors(self):
        """The tables, in a fixed order."""
        return [getattr(self, f) for f in _TENSORS]

    def table(self, which):
        """The tables of the sum over ``r_s``'s rows (``'src'``, the
        projection) or over the candidates' rows (``'ent'``, the gather's
        backward)."""
        if which not in ('src', 'ent'):
            raise ValueError(f'a route sums rows by src or ent, not '
                             f'{which!r}')
        return RouteTable(
            src=getattr(self, which), dst_local=self.dst_local,
            mask=self.mask, range_id=self.range_id, row_ptr=self.row_ptr,
            row_src=self.row_src if which == 'src' else self.row_ent,
            rows=self.rows, num_ranges=self.num_ranges)

    def block_scale(self, S):
        """``S [B, N_s, K]`` at the blocked entries, 0 where masked
        (JAX's ``sparse_project`` scale) → ``[B, NB, E_b]``."""
        B = S.shape[0]
        at = S.reshape(B, -1).gather(1, self.ent.reshape(B, -1).long())
        return torch.where(self.mask, at.reshape(self.ent.shape), 0.0)

    def row_scale(self, S, dtype=torch.float32):
        """``S`` in the row table's order, rounded to ``dtype`` (the rows'),
        as float32 ``[B, N_s * K]``: the kernel's ``row_scale``."""
        B = S.shape[0]
        at = S.reshape(B, -1).gather(1, self.row_ent.long())
        return at.to(dtype).float()

    def plain_sum(self, table, which, scale=None):
        """The plain version of a routed sum: JAX's ``_routed`` over
        :meth:`table` (``scale``: :meth:`block_scale`'s) →
        ``[B, n_t, C]`` in ``promote(table, float32)``."""
        return blocked_ops.plain_aggregate(table, self.table(which), scale)


def build_corr_route(S_idx, n_t, rows=128, block_entries=512):
    """Sort and block the candidate set on its device, without reading it
    on the host (JAX's ``build_corr_route``, ``dgmc_tpu/ops/
    corr_route.py:71-113``, plus the row table).

    ``S_idx [B, N_s, K]`` int target ids in ``[0, n_t)``; entries of
    padded source rows may hold any valid id."""
    B, N_s, K = S_idx.shape
    E = N_s * K
    num_ranges = -(-n_t // rows)
    nb = num_ranges + E // block_entries
    dev = S_idx.device
    sdst, order = torch.sort(S_idx.reshape(B, E).long(), dim=1, stable=True)
    bounds = torch.arange(num_ranges + 1, device=dev) * rows
    starts = torch.searchsorted(sdst, bounds.expand(B, -1).contiguous())
    counts = starts[:, 1:] - starts[:, :-1]                 # [B, NR]
    cum = torch.cumsum(-(-counts // block_entries), dim=1)  # blocks so far
    j = torch.arange(nb, device=dev).expand(B, -1).contiguous()
    rid = torch.searchsorted(cum, j, right=True)
    live = rid < num_ranges
    rid_c = rid.clamp(max=num_ranges - 1)
    prev = torch.where(rid_c > 0, cum.gather(1, (rid_c - 1).clamp(min=0)),
                       0)
    within = j - prev
    bstart = starts.gather(1, rid_c) + within * block_entries
    nvalid = (counts.gather(1, rid_c) - within * block_entries).clamp(
        0, block_entries)
    eb = torch.arange(block_entries, device=dev)
    offs = (bstart[..., None] + eb).clamp(0, E - 1).reshape(B, -1)
    mask = (eb < nvalid[..., None]) & live[..., None]
    ent = order.gather(1, offs).reshape(B, nb, block_entries)
    loc = (sdst.gather(1, offs).reshape(B, nb, block_entries)
           - rid_c[..., None] * rows).clamp(0, rows - 1)
    row_ptr = torch.searchsorted(
        sdst, torch.arange(n_t + 1, device=dev).expand(B, -1).contiguous())
    return CorrRoute(
        ent=ent.int(), src=(ent // K).int(), dst_local=loc.int(), mask=mask,
        range_id=rid_c.int(), row_ptr=row_ptr.int(), row_ent=order.int(),
        row_src=(order // K).int(), rows=rows, num_ranges=num_ranges,
        n_t=n_t)


def _route_sum(table, route, S=None):
    """The routed sum of ``table``'s rows onto the targets: scaled by ``S``
    over ``r_s``'s rows (the projection), else over the candidates' rows
    (the gather's backward). The wrapper is looked up at call time, so
    that a comparison can patch it."""
    from dgmc_tpu_torch.ops.kernels import blocked
    if S is None:
        return blocked.route_gather_bwd(table, route)
    return blocked.route_project(table, S, route)


class _SparseProject(torch.autograd.Function):

    @staticmethod
    def forward(ctx, S, r_s, S_idx, route):
        ctx.save_for_backward(S, r_s, S_idx)
        return _route_sum(r_s, route, S)

    @staticmethod
    def backward(ctx, d_r_t):
        S, r_s, S_idx = ctx.saved_tensors
        B, N_s, K = S_idx.shape
        # In the [N_s, K] order the transpose is gathers and a K-reduction:
        # d_S[s,k] = <d_r_t[S_idx[s,k]], r_s[s]>; d_r_s[s] = Σ_k S[s,k] g[s,k].
        flat = S_idx.reshape(B, N_s * K, 1).long()
        g = d_r_t.gather(1, flat.expand(-1, -1, d_r_t.shape[-1]))
        g = g.reshape(B, N_s, K, -1)
        d_S = torch.einsum('bskr,bsr->bsk', g, r_s.to(g.dtype))
        d_r_s = torch.einsum('bsk,bskr->bsr', S.to(g.dtype), g)
        return d_S, d_r_s, None, None


def sparse_project(S, r_s, S_idx, route):
    """``r_t[b, t] = Σ_{s,k: S_idx[b,s,k] = t} S[b,s,k] * r_s[b,s]`` →
    ``[B, n_t, R]`` in ``promote(r_s, float32)``, without the
    ``[B, N_s, K, R]`` contribution tensor and without a scatter;
    differentiable in ``S`` and ``r_s``."""
    return _SparseProject.apply(S, r_s, S_idx, route)


class _SparseGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feat, S_idx, route):
        ctx.route, ctx.dtype = route, feat.dtype
        B, N_s, K = S_idx.shape
        flat = S_idx.reshape(B, N_s * K, 1).long()
        rows = feat.gather(1, flat.expand(-1, -1, feat.shape[-1]))
        return rows.reshape(B, N_s, K, feat.shape[-1])

    @staticmethod
    def backward(ctx, g):
        B = g.shape[0]
        table = g.reshape(B, -1, g.shape[-1])                  # [B, E, R]
        return (_route_sum(table, ctx.route).to(ctx.dtype), None, None)


def sparse_gather(feat, S_idx, route):
    """``feat[b, S_idx[b, s, k]]`` → ``[B, N_s, K, C]``, the candidate-row
    gather, whose backward is the routed sum of the cotangent (cast once
    to ``feat``'s dtype) instead of a scatter."""
    return _SparseGather.apply(feat, S_idx, route)
