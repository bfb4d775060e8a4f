"""Deep Graph Matching Consensus: dense and sparse matching.

The two-stage matcher: an initial soft correspondence ``S^0`` from the ψ₁
embeddings, refined for ``num_steps`` neighbourhood-consensus
iterations. Per step, random node indicator functions ``r_s`` are
projected through ``S`` onto the target graph, ψ₂ colours both graphs,
and an MLP on the colour difference updates the correspondence logits.

Ported here:

- the dense variant (``k = -1``), trained and evaluated: the similarity
  product, masked softmax over ``[B, N_s, N_t]``, per step ``r_t = Sᵀ r_s``
  and ψ₂ on both sides, and the consensus delta through
  :func:`~dgmc_tpu_torch.ops.kernels.consensus.consensus_update` (its
  CUDA kernel on the card) or the factored plain form;
- the sparse variant (``k >= 1``), trained and evaluated: the top-k
  shortlist (its CUDA kernel on the card; streamed over source chunks
  with ``stream_chunk``), in training extended by
  ``min(k, N_t - k)`` random negatives per row and the injected ground
  truth (:func:`include_gt`), and the consensus delta through
  :func:`~dgmc_tpu_torch.ops.kernels.sparse_consensus.
  fused_candidate_delta` (its CUDA kernels, forward and backward, on the
  card); plus the serving arguments ``h_t``, ``S_idx`` and ``h_t_cand``.
  The shortlist's receiver order is built once per forward
  (:class:`~dgmc_tpu_torch.ops.shortlist.Shortlist`) and serves every
  reduction onto the targets. With ``route_sparse`` the final shortlist
  is routed instead (:func:`~dgmc_tpu_torch.ops.corr_route.
  build_corr_route`, once per forward): ``r_t`` is
  :func:`~dgmc_tpu_torch.ops.corr_route.sparse_project`, the candidate
  rows of ``h_t`` and of each step's ``o_t`` are
  :func:`~dgmc_tpu_torch.ops.corr_route.sparse_gather`, whose sums run
  through the blocked kernel's routed entry, and the delta is the narrow
  :func:`~dgmc_tpu_torch.ops.kernels.sparse_consensus.
  sparse_consensus_delta` over the gathered candidates (JAX's ``use_sc
  and use_route`` branch).

``batch_pair`` (JAX's, default off as there): ψ₁ (``'psi_1'``), ψ₂
(``'psi_2'``) or both (``True``) run once on the node-axis union of the
pair (:class:`~dgmc_tpu_torch.ops.blocked.UnionPair`) instead of once a
side; blocked graphs on both sides only, with JAX's refusals.

ψ₂ in both variants (:meth:`DGMC.packs_source`): the source side's input
is noise, independent of ``S``, so where the JAX package's
``prefetch_source`` packs, all steps' source sides run as one
channel-packed ψ₂ call (``streams``); where it does not (one step, a ψ₂
with batch norm, with active dropout or without ``streams``), each step
calls ψ₂ on the source and then on the target, the order in which batch
norm updates its running averages.

Precision (``dtype``, a compute dtype or a precision policy,
:mod:`~dgmc_tpu_torch.models.precision`), at the JAX package's places:
under bf16, ``h_s``, ``h_t`` and ``h_t_cand`` are cast after ψ₁; the
initial scores ``S_hat`` are float32 products of them; the indicator
noise is drawn in float32 and rounded to bf16 once; ``r_t = Sᵀ r_s`` is
float32 (``S`` is); ψ₂ computes in bf16 and the consensus MLP's weights
are cast to its output's dtype, so the kernels take their bf16 variants;
``S_hat``, the softmaxes and the loss stay float32, as do the parameters.

Random streams: torch cannot reproduce JAX's threefry streams. Pair
``b`` draws its indicator noise and its negatives on the model's device,
as the JAX package draws them inside its step, from a counter-based
Philox stream keyed by the step's seed at ``(pair_offset + b, stream)``
(:mod:`~dgmc_tpu_torch.ops.kernels.rng`: one launch of its kernel per
draw on the card, its plain version on the CPU). Card and CPU compute the
same stream, so the CPU and CUDA paths of one call see the same draws,
and a batch of pairs draws what the same pairs would draw one at a time.
Tests inject JAX's own draws through ``r_s`` and ``negatives``. Dropout
masks come from the ``generator`` passed to the forward, on the model's
device (under data parallelism a
:class:`~dgmc_tpu_torch.models.rel.BatchBlock`: the whole batch's masks,
cut to the rank's slice).

Row sharding (:meth:`DGMC.with_layout`, which
:meth:`~dgmc_tpu_torch.parallel.rules.PartitionRules.apply_to_model`
calls): where the model carries a correspondence layout whose rows lie
over a mesh axis, each rank owns the rows ``[lo, hi)`` of ``S`` (the
source rows padded up to equal blocks, the padding masked). Replicated on
every rank from the same seeds, so that the draws equal one process's:
the indicator noise, the negatives (drawn whole, then cut to the rows),
ψ₂ on the whole graphs and, without JAX's opt-in ψ₁ table rules, ψ₁ and
its dropout. Row-local: the candidate search
(:func:`~dgmc_tpu_torch.parallel.topk.corr_sharded_topk`, rows or the
target ring), ``include_gt``, ``S_hat``, the softmaxes and the consensus
deltas. Each step's ``r_t`` is summed over the row group by a
differentiable all-reduce (its backward sums the gradient). The outputs
are the rank's rows. With ``psi1_sharding`` ψ₁ computes this rank's rows
of ``h_s`` only, and with ``corpus_sharding`` its block of ``h_t``
(row-restricted where the backbone computes by rows, RelCNN and GIN:
:mod:`~dgmc_tpu_torch.models.rel`; SplineCNN computes every row and
keeps the block, its routing being built per graph batch; the dispatch
ledger's ``psi1_rows``); the ring then passes the ``h_t`` shards rank to
rank, and the candidate rows come from ``h_t`` all-gathered after the
search (differentiably: each row's gradient returns to its rank); the
dense variant gathers ``h_t`` for ``S``.

Observability, at the JAX package's places: the stages run under
``torch.profiler.record_function`` ranges named as JAX's scopes
(``psi1``, ``initial_corr``, ``topk``, ``consensus_iter``, ``psi2``;
:func:`~dgmc_tpu_torch.obs.stages.stage`, which the work counter reads),
and in training mode with probes on (:mod:`~dgmc_tpu_torch.obs.probes`)
the forward emits ``check_finite`` at ψ₁, the initial scores and each
consensus iteration, the entropy and top-``PROBE_TOPK`` mass of ``S_0``
and ``S_L``, and each iteration's ``consensus_delta`` and entropy. With
probes off none of it runs.
"""

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from dgmc_tpu_torch.models.precision import compute_dtype_of
from dgmc_tpu_torch.obs import probes as _probes
from dgmc_tpu_torch.obs.stages import stage
from dgmc_tpu_torch.models.rel import lecun_normal_
from dgmc_tpu_torch.ops.kernels import dispatch, rng
from dgmc_tpu_torch.ops.kernels import sparse_consensus
from dgmc_tpu_torch.ops.kernels.consensus import (R_MAX, consensus_update,
                                                  plain_consensus)
from dgmc_tpu_torch.ops.blocked import UnionPair
from dgmc_tpu_torch.ops.corr_route import (build_corr_route, sparse_gather,
                                           sparse_project)
from dgmc_tpu_torch.ops.shortlist import Shortlist
from dgmc_tpu_torch.ops.softmax import masked_softmax
from dgmc_tpu_torch.ops.topk import (DEFAULT_TOPK_BLOCK, chunked_topk,
                                     streamed_topk)

__all__ = ['Correspondence', 'DGMC', 'NOISE_STREAM', 'NEGATIVES_STREAM',
           'PROBE_TOPK', 'draw_noise', 'draw_negatives', 'include_gt']

#: Row-mass window of the ``topk_mass`` probe: the probability the 10 best
#: entries of each correspondence row hold (the JAX package's).
PROBE_TOPK = 10


def _probe_corr_stage(S, row_mask, stage):
    """Entropy and top-k mass of a correspondence snapshot (S0 / SL)."""
    _probes.emit('corr_entropy', lambda: _probes.entropy(S, row_mask),
                 stage=stage)
    _probes.emit('topk_mass',
                 lambda: _probes.topk_mass(S, PROBE_TOPK, row_mask),
                 stage=stage)


def _probe_consensus_iter(S_next, S, row_mask, step):
    """One iteration's correction norm and sharpening entropy."""
    _probes.emit('consensus_delta',
                 lambda: _probes.delta_norm(S_next, S, row_mask),
                 iteration=step)
    _probes.emit('corr_entropy', lambda: _probes.entropy(S_next, row_mask),
                 iteration=step)


@dataclasses.dataclass
class Correspondence:
    """Soft correspondence: ``val [B, N_s, K]`` probabilities over the
    candidate targets ``idx [B, N_s, K]`` (``idx is None`` ⇒ dense
    ``val [B, N_s, N_t]``)."""
    val: torch.Tensor
    idx: Optional[torch.Tensor]
    src_mask: torch.Tensor  # [B, N_s]
    tgt_mask: torch.Tensor  # [B, N_t]

    @property
    def is_sparse(self):
        return self.idx is not None

    def to_dense(self):
        """Scatter a sparse correspondence back to ``[B, N_s, N_t]``;
        candidates that repeat a target column add up, as in the JAX
        package. Each slot first takes the sum over the equal slots of
        its row (a ``K x K`` compare), so the scatter writes one value per
        column whichever duplicate lands last."""
        if not self.is_sparse:
            return self.val
        B, N_s, _ = self.val.shape
        same = self.idx[..., :, None] == self.idx[..., None, :]
        summed = (same * self.val[..., None, :]).sum(-1)
        out = self.val.new_zeros((B, N_s, self.tgt_mask.shape[1]))
        return out.scatter(-1, self.idx.long(), summed)


#: The counter words of the two random streams of a pair
#: (:mod:`~dgmc_tpu_torch.ops.kernels.rng`).
NOISE_STREAM, NEGATIVES_STREAM = 0, 1


def draw_noise(num_steps, B, N_s, R, seed=0, pair_offset=0, device='cpu'):
    """Indicator noise ``[num_steps, B, N_s, R]`` float32, drawn on
    ``device`` (one launch of the draw kernel on the card): pair ``b``'s
    from the Philox stream keyed by ``seed`` at counters
    ``(q, pair_offset + b, NOISE_STREAM)``."""
    z = rng.philox_normal(num_steps, B, N_s * R, seed, pair_offset,
                          NOISE_STREAM, device)
    return z.view(num_steps, B, N_s, R)


def draw_negatives(n_valid, N_s, num_rnd, seed=0, pair_offset=0):
    """Random negative columns ``[B, N_s, num_rnd]`` int64 on
    ``n_valid``'s device: ``floor(u * n_valid[b])`` with ``u`` uniform in
    ``[0, 1)`` from pair ``b``'s Philox stream ``NEGATIVES_STREAM``
    (keyed by ``seed``, at ``pair_offset + b``), so every column is a
    valid target. ``n_valid`` ``[B]`` counts each pair's valid targets; it
    is not read on the host."""
    cols = rng.philox_negatives(n_valid, N_s * num_rnd, seed, pair_offset,
                                NEGATIVES_STREAM)
    return cols.view(n_valid.shape[0], N_s, num_rnd)


class RowLayout:
    """A model's row block under a correspondence sharding: the rows'
    mesh axis (``sharding.spec[1]``), its process group and this rank's
    block of it. The batch axis is the step's (each rank already holds its
    pairs)."""

    def __init__(self, sharding):
        from dgmc_tpu_torch.parallel.mesh import NamedSharding
        mesh, axis = sharding.mesh, sharding.axis(1)
        self.sharding = NamedSharding(mesh, (None, axis))
        self.parts = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.group = mesh.group(axis)
        self.mesh_group = mesh.group()

    def bounds(self, num_rows):
        from dgmc_tpu_torch.parallel.topk import row_block
        return row_block(num_rows, self.parts, self.index)

    def take(self, x, dim=1):
        """This rank's rows of ``x`` along ``dim`` (padded with zeros up to
        equal blocks)."""
        return self.node_rows(x.shape[dim]).take(x, dim)

    def sum(self, x):
        """``x`` summed over the row group, differentiably."""
        from dgmc_tpu_torch.parallel.comm import all_reduce_sum
        return all_reduce_sum(x, self.group)

    def node_rows(self, num_nodes):
        """This rank's block of a graph's ``num_nodes`` node rows
        (:class:`~dgmc_tpu_torch.models.rel.NodeRows`): ψ₁'s row-restricted
        compute under ``psi1_sharding`` / ``corpus_sharding``."""
        from dgmc_tpu_torch.models.rel import NodeRows
        lo, hi, _ = self.bounds(num_nodes)
        return NodeRows(lo, hi, num_nodes, self.group, self.mesh_group)

    def topk(self, h_s, h_t, k, t_mask, block, chunk, ring, local=False,
             t_shard=None):
        """This rank's rows of the shortlist, from the whole ``h_s`` (its
        rows with ``local``) against the whole ``h_t``, or against this
        rank's target shard ``t_shard`` (``h_t`` ``None``: the corpus
        table sharded; the ring moves the shards)."""
        from dgmc_tpu_torch.parallel.topk import corr_sharded_topk
        return corr_sharded_topk(self.sharding, h_s, h_t, k, t_mask,
                                 block=block, chunk=chunk, ring=ring,
                                 local_rows=local, t_shard=t_shard)


def include_gt(S_idx, y_col, y_mask, return_replaced=False):
    """Overwrite the last candidate slot with the ground-truth column in
    every valid row whose ground truth is not already a candidate.

    S_idx: ``[B, N_s, K]``; y_col: ``[B, N_s]``; y_mask: ``[B, N_s]``.
    With ``return_replaced`` also returns the ``[B, N_s]`` bool mask of
    the rows whose last slot was overwritten.
    """
    y_col = y_col.to(S_idx.dtype)
    present = (S_idx == y_col[..., None]).any(dim=-1)
    replace = y_mask & ~present
    out = S_idx.clone()
    out[..., -1] = torch.where(replace, y_col, S_idx[..., -1])
    return (out, replace) if return_replaced else out


class DGMC(nn.Module):
    """Two-stage graph matching with iterative neighbourhood consensus.

    Args:
        psi_1: feature GNN, called as ``psi_1(x, graph, generator=...)``
            (the dropout masks' generator).
        psi_2: consensus GNN exposing ``in_channels``/``out_channels``
            (``SplineCNN``, ``RelCNN``, ``GIN``).
        num_steps: default number of consensus iterations.
        k: ``-1`` for the dense variant, else the top-k sparsity.
        generator: optional ``torch.Generator`` the initial weights are
            drawn from (:meth:`reset_parameters`).
        dtype: the compute dtype or precision policy of the matching
            itself (the casts after ψ₁ and of the noise and the consensus
            MLP); ψ₁ and ψ₂ take their own, as in the JAX package.
        topk_block: the candidate search's target block (the plain scan's
            tile; the kernels ignore it).
        stream_chunk: ``None``, or the source rows per search of the
            candidate search streamed over source chunks
            (:func:`~dgmc_tpu_torch.ops.topk.streamed_topk`: one top-k
            launch per chunk on the card, the same shortlist). Sparse
            (``k >= 1``) only.
        route_sparse: route the sparse consensus loop's sums onto the
            targets through a once-per-forward blocked sort of the final
            shortlist (:mod:`~dgmc_tpu_torch.ops.corr_route`) instead of
            the shortlist's receiver order; off by default, as in JAX.
        batch_pair: ``None`` / ``False`` (off, the default), ``True``,
            ``'psi_1'`` or ``'psi_2'``: run that backbone once on the
            node-axis union of the pair
            (:class:`~dgmc_tpu_torch.ops.blocked.UnionPair`). It needs
            blocked graphs on both sides with matching ``rows`` and edge
            attribute widths, and refuses (``ValueError``, JAX's
            wording) a backbone with batch norm, a ψ₁ union of differing
            feature widths, and the serving ``h_t`` / ``h_t_cand``.

    The consensus delta goes through :func:`consensus_update` (dense) or
    :func:`~dgmc_tpu_torch.ops.kernels.sparse_consensus.
    fused_candidate_delta` (sparse): their kernels on CUDA tensors, their
    plain versions on the CPU, whenever ``R`` is within the kernel's own
    limit. Above it the plain form runs, and the gate's decision is
    recorded in the dispatch ledger.
    """

    def __init__(self, psi_1, psi_2, num_steps, k=-1, generator=None,
                 dtype=None, topk_block=DEFAULT_TOPK_BLOCK,
                 stream_chunk=None, route_sparse=None, batch_pair=None):
        super().__init__()
        self.psi_1 = psi_1
        self.psi_2 = psi_2
        self.num_steps = num_steps
        self.k = k
        self.route_sparse = route_sparse
        self.batch_pair = batch_pair
        self.topk_block = int(topk_block)
        self.stream_chunk = None if stream_chunk is None else int(
            stream_chunk)
        self.dtype = compute_dtype_of(dtype)
        self.corr_sharding = self.topk_sharding = self.psi2_sharding = None
        self.psi1_sharding = self.corpus_sharding = None
        self.ring_targets = False
        self._layout = None
        R = psi_2.out_channels
        # Explicit consensus-MLP parameters, in the JAX package's layout
        # ([in, out] kernels).
        self.mlp_hidden_kernel = nn.Parameter(torch.empty(R, R))
        self.mlp_hidden_bias = nn.Parameter(torch.zeros(R))
        self.mlp_out_kernel = nn.Parameter(torch.empty(R, 1))
        self.mlp_out_bias = nn.Parameter(torch.zeros(1))
        self.reset_parameters(generator)

    def with_layout(self, corr_sharding=None, topk_sharding=None,
                    psi2_sharding=None, psi1_sharding=None,
                    corpus_sharding=None, stream_chunk=None,
                    ring_targets=False, topk_block=None):
        """A shallow copy of the model (the same parameters, buffers and
        backbones) with JAX's layout fields: ``corr_sharding`` /
        ``topk_sharding`` / ``psi2_sharding``
        (:class:`~dgmc_tpu_torch.parallel.mesh.NamedSharding` of
        ``[B, N_s, ...]`` arrays; their rows' axis is the row layout, the
        same for the three), ``psi1_sharding`` / ``corpus_sharding``
        (JAX's opt-in ψ₁ tables ``h_s [B, N_s, C]`` and ``h_t [B, N_t,
        C]``: where set, ψ₁ computes and holds this rank's row block of
        that table only; their row axis must be the row layout's),
        ``stream_chunk``, ``ring_targets`` (the search's target ring) and
        ``topk_block``. Without either ψ₁ rule ψ₁ runs whole on every
        rank."""
        axes = {s.axis(1) for s in (corr_sharding, topk_sharding,
                                    psi2_sharding) if s is not None}
        if len(axes) > 1:
            raise ValueError(f'corr / topk / psi2 shardings must put the '
                             f'rows on one axis; got {sorted(map(str, axes))}')
        rows = next((s for s in (corr_sharding, topk_sharding, psi2_sharding)
                     if s is not None and s.axis(1) is not None), None)
        for name, table in (('psi1_sharding', psi1_sharding),
                            ('corpus_sharding', corpus_sharding)):
            if table is not None and (rows is None
                                      or table.axis(1) != rows.axis(1)):
                raise ValueError(
                    f'{name} puts ψ₁\'s rows on {table.axis(1)!r}; it '
                    f'must be the correspondence rows\' axis '
                    f'({None if rows is None else rows.axis(1)!r}), as '
                    f'JAX\'s rules set them alike')
        out = copy.copy(self)
        out.corr_sharding = corr_sharding
        out.topk_sharding = topk_sharding
        out.psi2_sharding = psi2_sharding
        out.psi1_sharding = psi1_sharding
        out.corpus_sharding = corpus_sharding
        out.stream_chunk = None if stream_chunk is None else int(
            stream_chunk)
        out.ring_targets = bool(ring_targets)
        if topk_block is not None:
            out.topk_block = int(topk_block)
        out._layout = None if rows is None else RowLayout(rows)
        return out

    def row_layout(self):
        """The model's :class:`RowLayout`, or ``None`` (every row)."""
        return self._layout

    def reset_parameters(self, generator=None):
        """Flax-default init (lecun-normal kernels, zero biases) drawn from
        ``generator``."""
        self.psi_1.reset_parameters(generator)
        self.psi_2.reset_parameters(generator)
        R = self.mlp_hidden_kernel.shape[0]
        with torch.no_grad():
            lecun_normal_(self.mlp_hidden_kernel, R, generator)
            lecun_normal_(self.mlp_out_kernel, R, generator)
            self.mlp_hidden_bias.zero_()
            self.mlp_out_bias.zero_()

    def _mlp(self, dtype):
        """The consensus MLP's parameters cast to ``dtype`` (ψ₂'s output
        dtype), as the JAX package casts them for its kernels: anew in
        each consensus step, so that each step's gradient of the cast
        lands in float32 and the steps' gradients sum there (one cast
        shared by the steps would sum them in ``dtype``)."""
        return tuple(p.to(dtype) for p in (
            self.mlp_hidden_kernel, self.mlp_hidden_bias,
            self.mlp_out_kernel, self.mlp_out_bias))

    def _cast(self, h):
        """``h`` in the compute dtype (unchanged under float32)."""
        return h if h is None or self.dtype is None else h.to(self.dtype)

    def _noise(self, r_s, num_steps, B, N_s, noise_seed, pair_offset,
               device):
        """The indicator noise in the compute dtype: drawn in float32 and
        rounded once, or ``r_s`` as given (rounded the same way)."""
        R_in = self.psi_2.in_channels
        if r_s is None:
            r_s = draw_noise(num_steps, B, N_s, R_in, noise_seed,
                             pair_offset, device=device)
        elif tuple(r_s.shape) != (num_steps, B, N_s, R_in):
            raise ValueError(f'r_s must be [num_steps, B, N_s, R_in] = '
                             f'{(num_steps, B, N_s, R_in)}; got '
                             f'{tuple(r_s.shape)}')
        return self._cast(r_s)

    def packs_source(self, num_steps):
        """Whether ψ₂'s source side of all ``num_steps`` steps runs as
        one channel-packed call: exactly where the JAX package's
        ``prefetch_source`` packs (``dgmc_tpu/models/dgmc.py:551-558``),
        with more than one step, ψ₂ not merged by ``batch_pair`` and a ψ₂
        that has no batch norm, no active dropout (training mode with
        ``dropout > 0``) and channel-packed evaluation
        (``supports_streams``)."""
        psi_2 = self.psi_2
        return (num_steps > 1
                and self.batch_pair not in (True, 'psi_2')
                and not getattr(psi_2, 'batch_norm', False)
                and not (self.training and getattr(psi_2, 'dropout', 0.0))
                and getattr(psi_2, 'supports_streams', False))

    def _packed_source(self, r_s, graph_s, generator):
        """ψ₂ of every step's source-side noise in one channel-packed
        call, ``[T, B, N_s, R_out]``, where :meth:`packs_source`; else
        ``None`` (each step then calls ψ₂ itself)."""
        T, B, N_s, R_in = r_s.shape
        if not self.packs_source(T):
            return None
        with stage('psi2'):
            o = self.psi_2(r_s.permute(1, 2, 0, 3).reshape(
                B, N_s, T * R_in), graph_s, streams=T, generator=generator)
        return o.reshape(B, N_s, T, -1).permute(2, 0, 1, 3)

    def _delta_fn(self):
        """:func:`consensus_update`, or the factored plain form above the
        kernel's ``R <= R_MAX`` limit. The JAX package's auto gate also
        asks ``N_s, N_t >= 128`` because its kernel pads to the TPU's
        128 x 128 tile; the CUDA kernel masks ragged tiles, so only its
        own R limit remains."""
        R = self.mlp_hidden_kernel.shape[0]
        if R > R_MAX:
            dispatch.record('consensus_fwd', 'plain', f'R>{R_MAX}')
            return plain_consensus
        return consensus_update

    def _sparse_delta_fn(self, narrow=False):
        """:func:`fused_candidate_delta` (``narrow``:
        :func:`~dgmc_tpu_torch.ops.kernels.sparse_consensus.
        sparse_consensus_delta` over gathered candidates, ``route_sparse``'s
        form), or its plain form above the kernels' ``R <= R_MAX`` limit
        (recorded)."""
        sc = sparse_consensus
        R = self.mlp_hidden_kernel.shape[0]
        if R > sc.R_MAX:
            dispatch.record('sparse_consensus_fwd', 'plain', f'R>{sc.R_MAX}')
            return (sc.plain_sparse_consensus_delta if narrow
                    else sc.plain_fused_candidate_delta)
        return sc.sparse_consensus_delta if narrow else sc.fused_candidate_delta

    def _union(self, graph_s, graph_t, serving):
        """``(pair, merge_1, merge_2)``: the :class:`UnionPair` and which
        backbones run on it, under JAX's rules and refusals
        (``dgmc_tpu/models/dgmc.py:373-420``); ``serving``: a precomputed
        ``h_t`` or ``h_t_cand`` was passed."""
        bp = self.batch_pair
        if bp not in (None, False, True, 'psi_1', 'psi_2'):
            raise ValueError(
                f"batch_pair must be None/False/True/'psi_1'/'psi_2', "
                f'got {bp!r}')
        if bp not in (True, 'psi_1', 'psi_2'):
            return None, False, False
        ea_s, ea_t = graph_s.edge_attr, graph_t.edge_attr
        bs, bt = graph_s.blocks_in, graph_t.blocks_in
        if ((ea_s is None) != (ea_t is None)
                or (ea_s is not None and ea_s.shape[-1] != ea_t.shape[-1])
                or bs is None or bt is None or bs.rows != bt.rows):
            raise ValueError(
                'batch_pair requires blocked-adjacency graphs on both '
                'sides (ops/blocked.attach_blocks) with matching block '
                'rows and edge_attr widths; this pair cannot be stacked')

        def merges(m, role):
            if bp not in (True, role):
                return False
            if getattr(m, 'batch_norm', False):
                raise ValueError(
                    'batch_pair is invalid with a BatchNorm '
                    'backbone: merged batch statistics would span '
                    'both graphs')
            return True

        merge_1 = merges(self.psi_1, 'psi_1')
        if merge_1 and graph_s.x.shape[-1] != graph_t.x.shape[-1]:
            raise ValueError(
                f'batch_pair={bp!r} cannot union psi_1: '
                f'source/target feature widths differ '
                f'({graph_s.x.shape[-1]} vs {graph_t.x.shape[-1]})')
        merge_2 = merges(self.psi_2, 'psi_2')
        if (merge_1 or merge_2) and serving:
            raise ValueError(
                'precomputed h_t / h_t_cand are incompatible with '
                'batch_pair union evaluation: the union stacks both '
                'sides through one backbone call, but a precomputed '
                'target table means the target side never runs ψ₁')
        return UnionPair(graph_s, graph_t), merge_1, merge_2

    def _table_rows(self, graph_s, graph_t, serving, merge_1):
        """``(rows_s, rows_t)``: the :class:`~dgmc_tpu_torch.models.rel.
        NodeRows` ψ₁ computes on each side (``None``: every row), per
        ``psi1_sharding`` / ``corpus_sharding``; the target's only where ψ₁
        computes ``h_t`` (not ``serving``)."""
        lay = self.row_layout()
        if lay is None:
            return None, None
        rows_s = (lay.node_rows(graph_s.num_nodes)
                  if self.psi1_sharding is not None else None)
        rows_t = (lay.node_rows(graph_t.num_nodes)
                  if self.corpus_sharding is not None and not serving
                  else None)
        if merge_1 and (rows_s is not None or rows_t is not None):
            raise ValueError('batch_pair unions ψ₁\'s two sides; '
                             'psi1_sharding / corpus_sharding shard each '
                             'side\'s rows: not both')
        return rows_s, rows_t

    def _psi1(self, x, graph, generator, rows):
        """ψ₁ on one side: every row, or ``rows``' block (row-restricted
        where the backbone computes by rows, ``supports_rows``; else the
        whole table, its block kept), recorded as ``psi1_rows``."""
        if rows is None:
            return self.psi_1(x, graph, generator=generator)
        name = type(self.psi_1).__name__
        if getattr(self.psi_1, 'supports_rows', False):
            dispatch.record('psi1_rows', 'rows', name)
            return self.psi_1(x, graph, generator=generator, rows=rows)
        dispatch.record('psi1_rows', 'whole',
                        f'{name}: every row computed, the block kept (its '
                        f'routing is built per graph batch)')
        return rows.take(self.psi_1(x, graph, generator=generator))

    def _psi1_pair(self, graph_s, graph_t, pair, generator, rows_s, rows_t):
        """ψ₁ on both sides (:meth:`_on_pair`, or row-restricted)."""
        if pair is not None or (rows_s is None and rows_t is None):
            return self._on_pair(self.psi_1, graph_s.x, graph_t.x, graph_s,
                                 graph_t, pair, generator)
        return (self._psi1(graph_s.x, graph_s, generator, rows_s),
                self._psi1(graph_t.x, graph_t, generator, rows_t))

    @staticmethod
    def _on_pair(m, x_s, x_t, graph_s, graph_t, pair, generator):
        """``m`` on both sides: once on the union where ``pair`` is given,
        else on the source, then on the target."""
        if pair is None:
            return (m(x_s, graph_s, generator=generator),
                    m(x_t, graph_t, generator=generator))
        return pair.apply(lambda x, g: m(x, g, generator=generator), x_s,
                          x_t)

    def _psi2(self, x, graph, generator):
        with stage('psi2'):
            return self.psi_2(x, graph, generator=generator)

    def _step_psi2(self, r_s, r_t, o_s_all, step, graph_s, graph_t, pair,
                   generator):
        """One consensus step's ψ₂ outputs ``(o_s, o_t)``: the packed
        source side's, or ψ₂ on the union (``pair``), or ψ₂ on the
        source, then on the target."""
        if o_s_all is not None:
            return o_s_all[step], self._psi2(r_t, graph_t, generator)
        with stage('psi2'):
            return self._on_pair(self.psi_2, r_s, r_t, graph_s, graph_t,
                                 pair, generator)

    def _dense(self, graph_s, graph_t, num_steps, detach, noise_seed,
               pair_offset, r_s, generator):
        pair, merge_1, merge_2 = self._union(graph_s, graph_t, False)
        rows_s, rows_t = self._table_rows(graph_s, graph_t, False, merge_1)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not detach), \
                stage('psi1'):
            h_s, h_t = self._psi1_pair(graph_s, graph_t,
                                       pair if merge_1 else None, generator,
                                       rows_s, rows_t)
        # Probes document the train step only (the JAX package's rule).
        probe = _probes.enabled() and self.training
        if probe:
            _probes.check_finite('psi1', h_s, h_t, order=0)
        h_s, h_t = self._cast(h_s), self._cast(h_t)
        if rows_t is not None:
            # S spans every target: the corpus table gathered.
            h_t = rows_t.gather(h_t)
        s_mask, t_mask = graph_s.node_mask, graph_t.node_mask
        N_src = s_mask.shape[1]
        lay = self.row_layout()
        if lay is not None:
            s_mask = lay.take(s_mask)
            if rows_s is None:
                h_s = lay.take(h_s)
        B = s_mask.shape[0]
        S_mask = s_mask[:, :, None] & t_mask[:, None, :]
        with stage('initial_corr'):
            # float32 logits of compute-dtype embeddings (exact products).
            acc = torch.promote_types(h_s.dtype, torch.float32)
            S_hat = h_s.to(acc) @ h_t.to(acc).transpose(1, 2)
            S_0 = masked_softmax(S_hat, S_mask)
        if probe:
            _probes.check_finite('initial_corr', S_hat, order=1)
            _probe_corr_stage(S_0, s_mask, 'S0')
        if num_steps > 0:
            r_s = self._noise(r_s, num_steps, B, N_src, noise_seed,
                              pair_offset, h_s.device)
            o_s_all = self._packed_source(r_s, graph_s, generator)
            delta_fn = self._delta_fn()
            for step in range(num_steps):
                with stage('consensus_iter'):
                    S = masked_softmax(S_hat, S_mask)
                    r_rows = r_s[step] if lay is None else lay.take(r_s[step])
                    r_t = S.transpose(1, 2) @ r_rows.to(S.dtype)
                    if lay is not None:
                        r_t = lay.sum(r_t)
                    o_s, o_t = self._step_psi2(r_s[step], r_t, o_s_all,
                                               step, graph_s, graph_t,
                                               pair if merge_2 else None,
                                               generator)
                    if lay is not None:
                        o_s = lay.take(o_s)
                    delta = delta_fn(o_s, o_t, *self._mlp(o_s.dtype))
                    S_hat = S_hat + torch.where(S_mask, delta, 0.0)
                if probe:
                    with torch.no_grad():
                        _probe_consensus_iter(masked_softmax(S_hat, S_mask),
                                              S, s_mask, step)
                    _probes.check_finite('consensus_iter', S_hat,
                                         order=2 + step, iteration=step)
        S_L = masked_softmax(S_hat, S_mask)
        if probe:
            _probe_corr_stage(S_L, s_mask, 'SL')
        return (Correspondence(S_0, None, s_mask, t_mask),
                Correspondence(S_L, None, s_mask, t_mask))

    def forward(self, graph_s, graph_t, y=None, y_mask=None, h_t=None,
                S_idx=None, h_t_cand=None, num_steps=None, detach=False,
                noise_seed=0, pair_offset=0, r_s=None, negatives=None,
                generator=None, check_idx=True):
        """Compute ``(S_0, S_L)``: dense ``[B, N_s, N_t]`` correspondences
        for ``k = -1``, sparse ``[B, N_s, K]`` ones otherwise.

        Args:
            graph_s / graph_t: padded :class:`~dgmc_tpu_torch.ops.graph.
                GraphBatch` pairs.
            y / y_mask: ``[B, N_s]`` ground-truth target columns and their
                validity. In training mode the sparse variant extends the
                shortlist with random negatives and injects ``y`` (which
                must lie in ``[0, N_t)`` where valid; ``batch_to_device``
                checks on upload); otherwise unused.
            h_t: optional precomputed ψ₁ target table ``[B, N_t, C]`` (the
                serving corpus cache; sparse only); ψ₁ then runs on the
                source only and ``graph_t.x`` is never read.
            S_idx: optional precomputed top-k shortlist ``[B, N_s, k]``
                (sparse only; in training it is extended as the search's
                would be).
            h_t_cand: optional pre-gathered candidate rows
                ``[B, N_s, k, C]`` (needs ``S_idx``).
            num_steps: consensus iterations (default: the module's).
            detach: cut ψ₁'s gradients; ψ₁ still runs in its own mode
                (dropout stays active in training), as in the JAX CLI's
                phase 2.
            noise_seed / pair_offset: the random streams of pair ``b``
                (:func:`draw_noise`, :func:`draw_negatives`).
            r_s: optional indicator noise ``[num_steps, B, N_s, R_in]``
                used instead of drawing it.
            negatives: optional negative columns ``[B, N_s, num_rnd]``
                (``num_rnd = min(k, N_t - k)``) used instead of drawing
                them (sparse training only).
            generator: the dropout masks' ``torch.Generator`` on the
                model's device (training with dropout only).
            check_idx: check a precomputed ``S_idx`` against ``[0, N_t)``
                (a read on the host); a caller that checked it before it
                reached the device (the serve engine's offload tier, whose
                rerank is a captured graph) passes ``False``.
        """
        num_steps = self.num_steps if num_steps is None else num_steps
        if self.stream_chunk is not None and self.k < 1:
            raise ValueError(
                'stream_chunk streams the sparse candidate search; the '
                'dense variant (k=-1) materializes S and cannot stream '
                '(set k >= 1 or stream_chunk=None)')
        if self.k < 1:
            if h_t is not None or S_idx is not None or h_t_cand is not None:
                raise ValueError('h_t / S_idx / h_t_cand are serving '
                                 'arguments of the sparse variant; the '
                                 'dense variant has no shortlist')
            return self._dense(graph_s, graph_t, num_steps, detach,
                               noise_seed, pair_offset, r_s, generator)
        if h_t_cand is not None and S_idx is None:
            raise ValueError('h_t_cand (pre-gathered candidate rows) is '
                             'meaningless without the S_idx it was '
                             'gathered at')
        train = self.training and y is not None
        if train and h_t_cand is not None:
            raise ValueError('h_t_cand is an inference argument: training '
                             'extends the shortlist with negatives and the '
                             'ground truth, whose rows it lacks')
        if negatives is not None and not train:
            raise ValueError('negatives are drawn in training mode only '
                             '(with y)')
        serving = h_t is not None or h_t_cand is not None
        pair, merge_1, merge_2 = self._union(graph_s, graph_t, serving)
        rows_s, rows_t = self._table_rows(graph_s, graph_t, serving, merge_1)
        # detach: ψ₁ runs without a graph, still in its own mode (the
        # same dropout masks as with one).
        with torch.set_grad_enabled(torch.is_grad_enabled() and not detach), \
                stage('psi1'):
            if not serving:
                h_s, h_t = self._psi1_pair(graph_s, graph_t,
                                           pair if merge_1 else None,
                                           generator, rows_s, rows_t)
            else:
                h_s = self._psi1(graph_s.x, graph_s, generator, rows_s)
        probe = _probes.enabled() and self.training
        if probe:
            _probes.check_finite('psi1', h_s,
                                 *(() if h_t is None else (h_t,)), order=0)
        h_s, h_t, h_t_cand = (self._cast(h_s), self._cast(h_t),
                              self._cast(h_t_cand))
        if detach and h_t_cand is not None:
            h_t_cand = h_t_cand.detach()

        s_mask, t_mask = graph_s.node_mask, graph_t.node_mask
        N_src = s_mask.shape[1]
        h_s_all, lay = h_s, self.row_layout()
        # With the corpus table sharded, h_t is this rank's shard until
        # the search has run.
        h_t_shard, h_t = (h_t, None) if rows_t is not None else (None, h_t)
        if lay is not None:
            # This rank's rows of every [B, N_s, ...] input.
            s_mask = lay.take(s_mask)
            if rows_s is None:
                h_s = lay.take(h_s)
            y, y_mask, S_idx, h_t_cand = (
                None if v is None else lay.take(v)
                for v in (y, y_mask, S_idx, h_t_cand))
        (B, N_s), N_t = s_mask.shape, t_mask.shape[1]
        dev = h_s.device
        if S_idx is None:
            if h_t is None and h_t_shard is None:
                raise ValueError('the candidate search needs the full h_t '
                                 'table (or a precomputed S_idx)')
            with stage('topk'):
                if lay is not None:
                    S_idx = lay.topk(h_s_all, h_t, self.k, t_mask,
                                     self.topk_block, self.stream_chunk,
                                     self.ring_targets,
                                     local=rows_s is not None,
                                     t_shard=h_t_shard)
                elif self.stream_chunk is not None:
                    S_idx = streamed_topk(h_s, h_t, self.k,
                                          self.stream_chunk, t_mask=t_mask,
                                          block=self.topk_block)
                else:
                    S_idx = chunked_topk(h_s, h_t, self.k, t_mask=t_mask,
                                         block=self.topk_block)
        elif S_idx.shape[-1] != self.k:
            raise ValueError(f'precomputed S_idx carries {S_idx.shape[-1]} '
                             f'candidates but the model was built with '
                             f'k={self.k}')
        elif check_idx and bool(((S_idx < 0) | (S_idx >= N_t)).any()):
            # The kernels index target rows unchecked.
            raise ValueError(f'precomputed S_idx outside [0, {N_t})')
        S_idx = S_idx.long()
        if h_t_shard is not None:
            # The candidate rows (the search's, the negatives, the ground
            # truth) lie anywhere in the targets: the corpus table
            # gathered, its gradient back to the rank that owns each row.
            h_t = rows_t.gather(h_t_shard)

        # Candidate-slot validity without gathering t_mask at S_idx: masked
        # columns score finfo.min / -inf in the search, strictly below any
        # real inner product, so slot j is valid exactly when j < n_valid;
        # a negative floor(u * n_valid) is valid when n_valid > 0, and an
        # injected ground truth by the caller's contract.
        n_valid_t = t_mask.sum(dim=-1)
        entry_mask = (torch.arange(self.k, device=dev)[None, None]
                      < n_valid_t[:, None, None]).expand(B, N_s, self.k)
        if train:
            if y_mask is None:
                y_mask = torch.ones(y.shape, dtype=torch.bool, device=dev)
            num_rnd = min(self.k, N_t - self.k)
            if num_rnd > 0:
                if negatives is None:
                    # Drawn whole (the one-process draws), then cut.
                    negatives = draw_negatives(n_valid_t, N_src, num_rnd,
                                               noise_seed, pair_offset)
                elif tuple(negatives.shape) != (B, N_src, num_rnd):
                    raise ValueError(f'negatives must be [B, N_s, num_rnd] '
                                     f'= {(B, N_src, num_rnd)}; got '
                                     f'{tuple(negatives.shape)}')
                elif bool(((negatives < 0) | (negatives >= N_t)).any()):
                    raise ValueError(f'negatives outside [0, {N_t})')
                if lay is not None:
                    negatives = lay.take(negatives)
                S_idx = torch.cat([S_idx, negatives.to(dev).long()], dim=-1)
                entry_mask = torch.cat(
                    [entry_mask, (n_valid_t > 0)[:, None, None].expand(
                        B, N_s, num_rnd)], dim=-1)
            S_idx, replaced = include_gt(S_idx, y.long(), y_mask & s_mask,
                                         return_replaced=True)
            entry_mask = entry_mask.clone()
            entry_mask[..., -1] |= replaced
        # The final shortlist's order onto the targets, built once: the
        # routed tables, or the shortlist's receiver order.
        if self.route_sparse:
            route, shortlist = build_corr_route(S_idx, N_t), None

            def cand_rows(feat):
                return sparse_gather(feat, S_idx, route)
        else:
            shortlist = Shortlist(S_idx, N_t)
            S_idx, cand_rows = shortlist.idx, shortlist.gather
        row_mask = s_mask[..., None]

        with stage('initial_corr'):
            h_t_rows = (h_t_cand if h_t_cand is not None
                        else cand_rows(h_t))
            # float32 logits of compute-dtype embeddings (exact products).
            acc = torch.promote_types(h_s.dtype, torch.float32)
            S_hat = torch.einsum('bsc,bskc->bsk', h_s.to(acc),
                                 h_t_rows.to(acc))
            S_0 = masked_softmax(S_hat, entry_mask) * row_mask
        if probe:
            _probes.check_finite('initial_corr', S_hat, order=1)
            _probe_corr_stage(S_0, s_mask, 'S0')

        if num_steps > 0:
            r_s = self._noise(r_s, num_steps, B, N_src, noise_seed,
                              pair_offset, dev)
            o_s_all = self._packed_source(r_s, graph_s, generator)
            delta_fn = self._sparse_delta_fn(narrow=shortlist is None)
            for step in range(num_steps):
                with stage('consensus_iter'):
                    S = masked_softmax(S_hat, entry_mask) * row_mask
                    r_rows = r_s[step] if lay is None else lay.take(r_s[step])
                    # float32: S is; the noise is widened exactly.
                    if shortlist is None:
                        r_t = sparse_project(S, r_rows, S_idx, route)
                    else:
                        r_t = shortlist.scatter(
                            S[..., None]
                            * r_rows.to(S.dtype)[:, :, None, :])
                    if lay is not None:
                        r_t = lay.sum(r_t)
                    o_s, o_t = self._step_psi2(r_s[step], r_t, o_s_all,
                                               step, graph_s, graph_t,
                                               pair if merge_2 else None,
                                               generator)
                    if lay is not None:
                        o_s = lay.take(o_s)
                    o_t = o_t.to(o_s.dtype)
                    if shortlist is None:
                        delta = delta_fn(o_s, cand_rows(o_t),
                                         *self._mlp(o_s.dtype))
                    else:
                        delta = delta_fn(o_s, o_t, shortlist,
                                         *self._mlp(o_s.dtype))
                    S_hat = S_hat + delta
                if probe:
                    with torch.no_grad():
                        _probe_consensus_iter(
                            masked_softmax(S_hat, entry_mask) * row_mask, S,
                            s_mask, step)
                    _probes.check_finite('consensus_iter', S_hat,
                                         order=2 + step, iteration=step)

        S_L = masked_softmax(S_hat, entry_mask) * row_mask
        if probe:
            _probe_corr_stage(S_L, s_mask, 'SL')
        return (Correspondence(S_0, S_idx, s_mask, t_mask),
                Correspondence(S_L, S_idx, s_mask, t_mask))
