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
- the sparse (``k >= 1``) inference branch with the serving arguments
  (``h_t``, ``S_idx``, ``h_t_cand``), the channel-packed source side of
  ψ₂ and the arithmetic candidate mask. The sparse training branch
  (negatives and ground-truth injection) is later work.

Indicator noise: torch cannot reproduce JAX's threefry streams, so pair
``b`` draws its noise from a CPU ``torch.Generator`` seeded from
``(noise_seed, pair_offset + b)`` — the same numbers on every device, so
the CPU and CUDA paths of one call see the same noise. Tests inject
JAX's own draws through ``r_s``.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from dgmc_tpu_torch.models.rel import lecun_normal_
from dgmc_tpu_torch.ops.graph import scatter_to_nodes
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.consensus import (R_MAX, consensus_update,
                                                  plain_consensus)
from dgmc_tpu_torch.ops.softmax import masked_softmax
from dgmc_tpu_torch.ops.topk import chunked_topk

__all__ = ['Correspondence', 'DGMC', 'draw_noise']


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
        """Scatter a sparse correspondence back to ``[B, N_s, N_t]``."""
        if not self.is_sparse:
            return self.val
        B, N_s, _ = self.val.shape
        out = self.val.new_zeros((B, N_s, self.tgt_mask.shape[1]))
        return out.scatter(-1, self.idx, self.val)


def draw_noise(num_steps, B, N_s, R, seed=0, pair_offset=0, device='cpu'):
    """Indicator noise ``[num_steps, B, N_s, R]``: pair ``b`` from its own
    CPU generator seeded by ``(seed, pair_offset + b)``, then moved to
    ``device``."""
    out = torch.empty((num_steps, B, N_s, R), dtype=torch.float32)
    for b in range(B):
        g = torch.Generator().manual_seed(
            int(seed) * 1_000_003 + int(pair_offset) + b)
        out[:, b] = torch.randn((num_steps, N_s, R), generator=g)
    return out.to(device)


def _gather_t(feat, idx):
    """``feat [B, N_t, C]``, ``idx [B, N_s, K]`` → ``[B, N_s, K, C]``."""
    B, N_s, K = idx.shape
    C = feat.shape[-1]
    flat = torch.gather(feat, 1, idx.reshape(B, N_s * K, 1).expand(-1, -1,
                                                                   C))
    return flat.reshape(B, N_s, K, C)


class DGMC(nn.Module):
    """Two-stage graph matching with iterative neighbourhood consensus.

    Args:
        psi_1: feature GNN, called as ``psi_1(x, graph)``.
        psi_2: consensus GNN exposing ``in_channels``/``out_channels``
            (``SplineCNN``, ``RelCNN``). The sparse variant also needs
            channel-packed evaluation (``streams``), as RelCNN has.
        num_steps: default number of consensus iterations.
        k: ``-1`` for the dense variant, else the top-k sparsity.
        generator: optional ``torch.Generator`` the initial weights are
            drawn from (:meth:`reset_parameters`).

    The dense consensus delta goes through :func:`consensus_update` (its
    kernel on CUDA tensors, its plain version on the CPU) whenever
    ``R <= R_MAX``, the kernel's own limit, and through the factored
    plain form above it; the gate's decision is recorded in the dispatch
    ledger.
    """

    def __init__(self, psi_1, psi_2, num_steps, k=-1, generator=None):
        super().__init__()
        if k >= 1 and not getattr(psi_2, 'supports_streams', False):
            raise NotImplementedError('the sparse variant needs a psi_2 with '
                                      'channel-packed evaluation (streams), '
                                      'as RelCNN has')
        self.psi_1 = psi_1
        self.psi_2 = psi_2
        self.num_steps = num_steps
        self.k = k
        R = psi_2.out_channels
        # Explicit consensus-MLP parameters, in the JAX package's layout
        # ([in, out] kernels).
        self.mlp_hidden_kernel = nn.Parameter(torch.empty(R, R))
        self.mlp_hidden_bias = nn.Parameter(torch.zeros(R))
        self.mlp_out_kernel = nn.Parameter(torch.empty(R, 1))
        self.mlp_out_bias = nn.Parameter(torch.zeros(1))
        self.reset_parameters(generator)

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

    def consensus_mlp(self, d):
        h = torch.relu(d @ self.mlp_hidden_kernel + self.mlp_hidden_bias)
        return (h @ self.mlp_out_kernel)[..., 0] + self.mlp_out_bias[0]

    def _noise(self, r_s, num_steps, B, N_s, noise_seed, pair_offset,
               device):
        R_in = self.psi_2.in_channels
        if r_s is None:
            return draw_noise(num_steps, B, N_s, R_in, noise_seed,
                              pair_offset, device=device)
        if tuple(r_s.shape) != (num_steps, B, N_s, R_in):
            raise ValueError(f'r_s must be [num_steps, B, N_s, R_in] = '
                             f'{(num_steps, B, N_s, R_in)}; got '
                             f'{tuple(r_s.shape)}')
        return r_s

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

    def _dense(self, graph_s, graph_t, num_steps, noise_seed, pair_offset,
               r_s):
        h_s = self.psi_1(graph_s.x, graph_s)
        h_t = self.psi_1(graph_t.x, graph_t)
        s_mask, t_mask = graph_s.node_mask, graph_t.node_mask
        B, N_s = s_mask.shape
        S_mask = s_mask[:, :, None] & t_mask[:, None, :]
        S_hat = h_s @ h_t.transpose(1, 2)
        S_0 = masked_softmax(S_hat, S_mask)
        if num_steps > 0:
            r_s = self._noise(r_s, num_steps, B, N_s, noise_seed,
                              pair_offset, h_s.device)
            delta_fn = self._delta_fn()
            mlp = (self.mlp_hidden_kernel, self.mlp_hidden_bias,
                   self.mlp_out_kernel, self.mlp_out_bias)
            for step in range(num_steps):
                S = masked_softmax(S_hat, S_mask)
                r_t = S.transpose(1, 2) @ r_s[step]
                o_s = self.psi_2(r_s[step], graph_s)
                o_t = self.psi_2(r_t, graph_t)
                delta = delta_fn(o_s, o_t, *mlp)
                S_hat = S_hat + torch.where(S_mask, delta, 0.0)
        S_L = masked_softmax(S_hat, S_mask)
        return (Correspondence(S_0, None, s_mask, t_mask),
                Correspondence(S_L, None, s_mask, t_mask))

    def forward(self, graph_s, graph_t, h_t=None, S_idx=None, h_t_cand=None,
                num_steps=None, noise_seed=0, pair_offset=0, r_s=None):
        """Compute ``(S_0, S_L)``: dense ``[B, N_s, N_t]`` correspondences
        for ``k = -1``, sparse ``[B, N_s, k]`` ones otherwise.

        Args:
            graph_s / graph_t: padded :class:`~dgmc_tpu_torch.ops.graph.
                GraphBatch` pairs.
            h_t: optional precomputed ψ₁ target table ``[B, N_t, C]`` (the
                serving corpus cache; sparse only); ψ₁ then runs on the
                source only and ``graph_t.x`` is never read.
            S_idx: optional precomputed shortlist ``[B, N_s, k]`` (sparse
                only).
            h_t_cand: optional pre-gathered candidate rows
                ``[B, N_s, k, C]`` (needs ``S_idx``).
            noise_seed / pair_offset: the indicator-noise stream (see
                :func:`draw_noise`).
            r_s: optional indicator noise ``[num_steps, B, N_s, R_in]``
                used instead of drawing it.
        """
        num_steps = self.num_steps if num_steps is None else num_steps
        if self.k < 1:
            if h_t is not None or S_idx is not None or h_t_cand is not None:
                raise ValueError('h_t / S_idx / h_t_cand are serving '
                                 'arguments of the sparse variant; the '
                                 'dense variant has no shortlist')
            return self._dense(graph_s, graph_t, num_steps, noise_seed,
                               pair_offset, r_s)
        if h_t_cand is not None and S_idx is None:
            raise ValueError('h_t_cand (pre-gathered candidate rows) is '
                             'meaningless without the S_idx it was '
                             'gathered at')
        h_s = self.psi_1(graph_s.x, graph_s)
        if h_t is None and h_t_cand is None:
            h_t = self.psi_1(graph_t.x, graph_t)

        s_mask, t_mask = graph_s.node_mask, graph_t.node_mask
        (B, N_s), N_t = s_mask.shape, t_mask.shape[1]
        if S_idx is None:
            if h_t is None:
                raise ValueError('the candidate search needs the full h_t '
                                 'table (or a precomputed S_idx)')
            S_idx = chunked_topk(h_s, h_t, self.k, t_mask=t_mask)
        elif S_idx.shape[-1] != self.k:
            raise ValueError(f'precomputed S_idx carries {S_idx.shape[-1]} '
                             f'candidates but the model was built with '
                             f'k={self.k}')
        S_idx = S_idx.long()

        # Candidate-slot validity without gathering t_mask at S_idx: masked
        # columns score finfo.min / -inf in the search, strictly below any
        # real inner product, so slot j is valid exactly when j < n_valid.
        n_valid_t = t_mask.sum(dim=-1)
        entry_mask = (torch.arange(self.k, device=s_mask.device)[None, None]
                      < n_valid_t[:, None, None]).expand(B, N_s, self.k)
        row_mask = s_mask[..., None]

        h_t_rows = h_t_cand if h_t_cand is not None else _gather_t(h_t,
                                                                   S_idx)
        S_hat = torch.einsum('bsc,bskc->bsk', h_s, h_t_rows)
        S_0 = masked_softmax(S_hat, entry_mask) * row_mask

        if num_steps > 0:
            R_in = self.psi_2.in_channels
            r_s = self._noise(r_s, num_steps, B, N_s, noise_seed,
                              pair_offset, h_s.device)
            # The source-side ψ₂ input is noise, independent of S: all
            # steps run as ONE channel-packed ψ₂ call on the source graph.
            T = num_steps
            o = self.psi_2(r_s.permute(1, 2, 0, 3).reshape(B, N_s, T * R_in),
                           graph_s, streams=T)
            o_s_all = o.reshape(B, N_s, T, -1).permute(2, 0, 1, 3)
            flat_idx = S_idx.reshape(B, N_s * self.k)
            all_edges = torch.ones_like(flat_idx, dtype=torch.bool)
            for step in range(num_steps):
                S = masked_softmax(S_hat, entry_mask) * row_mask
                contrib = S[..., None] * r_s[step][:, :, None, :]
                r_t = scatter_to_nodes(
                    contrib.reshape(B, N_s * self.k, R_in), flat_idx,
                    all_edges, N_t, aggr='sum')
                o_t = self.psi_2(r_t, graph_t)
                delta = self.consensus_mlp(o_s_all[step][:, :, None, :]
                                           - _gather_t(o_t, S_idx))
                S_hat = S_hat + delta

        S_L = masked_softmax(S_hat, entry_mask) * row_mask
        return (Correspondence(S_0, S_idx, s_mask, t_mask),
                Correspondence(S_L, S_idx, s_mask, t_mask))
