"""Synthetic DBP15K-shaped knowledge-graph alignment (NumPy).

A random source KG whose entities are injectively mapped into a larger
target KG as variance-preserving noisy copies, with a fraction of the
mapped edges rewired and distractor entities/edges added. The same
construction, draw for draw, as the JAX package's generator, so one
seed gives the same arrays in both.
"""

from typing import NamedTuple

import numpy as np

__all__ = ['SyntheticKG', 'synthetic_kg_alignment']


class SyntheticKG(NamedTuple):
    """Raw arrays of one synthetic KG-alignment pair."""
    x_s: np.ndarray          # [n_s, dim] source entity features
    senders_s: np.ndarray    # [e_s] int32
    receivers_s: np.ndarray  # [e_s] int32
    x_t: np.ndarray          # [n_t, dim] target entity features
    senders_t: np.ndarray    # [e_t] int32
    receivers_t: np.ndarray  # [e_t] int32
    perm: np.ndarray         # [n_s] int32: source i aligns to target perm[i]
    train_mask: np.ndarray   # [n_s] bool: the seed-alignment split


def synthetic_kg_alignment(n_s, n_t, e_s, e_t, dim, noise_min=0.5,
                           noise_max=2.5, rewire=0.15, seed_frac=0.3,
                           rng=None):
    """DBP15K-protocol synthetic KG alignment at arbitrary scale.

    Features have unit norm (``1/sqrt(dim)`` per component); each aligned
    entity draws its noise sigma uniformly in ``[noise_min, noise_max]``
    and its target copy is ``(x + sigma*noise)/sqrt(1+sigma^2)``. Seeds
    follow the reference's 30% split (``seed_frac``).
    """
    if rng is None:
        rng = np.random.RandomState(0)
    if n_t < n_s or e_t < e_s:
        raise ValueError('the target KG must be at least as large as the '
                         'source KG')

    x_s = (rng.randn(n_s, dim) / np.sqrt(dim)).astype(np.float32)
    snd = rng.randint(0, n_s, e_s).astype(np.int32)
    rcv = rng.randint(0, n_s, e_s).astype(np.int32)

    perm = rng.permutation(n_t)[:n_s].astype(np.int32)
    x_t = (rng.randn(n_t, dim) / np.sqrt(dim)).astype(np.float32)
    sigma = rng.uniform(noise_min, noise_max, (n_s, 1)).astype(np.float32)
    noise = (rng.randn(n_s, dim) / np.sqrt(dim)).astype(np.float32)
    x_t[perm] = (x_s + sigma * noise) / np.sqrt(1.0 + sigma ** 2)
    keep = rng.rand(e_s) >= rewire
    snd_t = np.where(keep, perm[snd], rng.randint(0, n_t, e_s))
    rcv_t = np.where(keep, perm[rcv], rng.randint(0, n_t, e_s))
    extra = e_t - e_s
    snd_t = np.concatenate([snd_t, rng.randint(0, n_t, extra)])
    rcv_t = np.concatenate([rcv_t, rng.randint(0, n_t, extra)])

    train_mask = np.zeros(n_s, bool)
    train_mask[:int(seed_frac * n_s)] = True
    return SyntheticKG(x_s=x_s, senders_s=snd, receivers_s=rcv, x_t=x_t,
                       senders_t=snd_t.astype(np.int32),
                       receivers_t=rcv_t.astype(np.int32),
                       perm=perm, train_mask=train_mask)
