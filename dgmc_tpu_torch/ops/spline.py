"""Closed-form open B-spline basis of degree 1 (SplineConv's edge weights).

Each pseudo-coordinate dimension has exactly two active knots with hat
weights ``(1 - frac, frac)``, so an edge activates ``2^D`` of the ``K^D``
kernel matrices with product weights: a handful of elementwise ops, the
same as the JAX package's ``open_spline_basis``.
"""

import itertools

import torch

__all__ = ['open_spline_basis']


def open_spline_basis(pseudo, kernel_size, degree=1):
    """Degree-1 open B-spline basis over pseudo-coordinates in ``[0, 1]``.

    Args:
        pseudo: ``[..., D]`` edge pseudo-coordinates.
        kernel_size: knots per dimension.
        degree: only 1 is supported.

    Returns:
        ``(basis, combo)`` of shape ``[..., 2**D]``: the product weight of
        each active knot combination (``pseudo``'s dtype) and its index
        into the ``K**D`` kernel axis (int64; dimension 0 has stride 1:
        ``idx = sum_d knot_d * K**d``).
    """
    if degree != 1:
        raise NotImplementedError('only degree-1 (linear) open B-splines '
                                  'are supported')
    K = kernel_size
    D = pseudo.shape[-1]
    p = pseudo.clamp(0.0, 1.0) * (K - 1)
    lo = torch.floor(p).clamp(0, K - 2)
    frac = p - lo
    lo = lo.long()
    w = torch.stack([1.0 - frac, frac], dim=-1)        # [..., D, 2]
    knot = torch.stack([lo, lo + 1], dim=-1)           # [..., D, 2]
    basis_terms, idx_terms = [], []
    for combo in itertools.product((0, 1), repeat=D):
        bw = torch.ones(pseudo.shape[:-1], dtype=pseudo.dtype,
                        device=pseudo.device)
        fi = torch.zeros(pseudo.shape[:-1], dtype=torch.int64,
                         device=pseudo.device)
        for d, c in enumerate(combo):
            bw = bw * w[..., d, c]
            fi = fi + knot[..., d, c] * (K ** d)
        basis_terms.append(bw)
        idx_terms.append(fi)
    return torch.stack(basis_terms, dim=-1), torch.stack(idx_terms, dim=-1)
