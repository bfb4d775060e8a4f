"""Synthetic matching workloads (NumPy), draw for draw the JAX
package's generators, so one seed gives the same arrays in both.

- :class:`RandomGraphPairs`: random matchable point-cloud pairs (30-60
  inliers uniform in ``[-1, 1]^2``, a target copy jittered with Gaussian
  noise, 0-20 per-side outliers in ``[2, 3]^2``), the PascalPF training
  data; no download.
- :func:`synthetic_kg_alignment`: a random source KG whose entities are
  injectively mapped into a larger target KG as variance-preserving
  noisy copies, with a fraction of the mapped edges rewired and
  distractor entities/edges added (the DBP15K stand-in).
"""

from typing import NamedTuple

import numpy as np

from dgmc_tpu_torch.utils.data import Graph, GraphPair

__all__ = ['RandomGraphPairs', 'SyntheticKG', 'synthetic_kg_alignment']


class RandomGraphPairs:
    """Virtual dataset of random matchable point-cloud pairs.

    Item ``idx`` of epoch ``epoch`` is drawn from its own
    ``RandomState`` seeded by ``(seed, epoch, idx)``; inlier ``i`` of the
    source matches inlier ``i`` of the target, outliers have no ground
    truth (``y_col = -1``).
    """

    def __init__(self, min_inliers=30, max_inliers=60, min_outliers=0,
                 max_outliers=20, noise=0.05, transform=None, length=1024,
                 seed=0):
        self.min_inliers = min_inliers
        self.max_inliers = max_inliers
        self.min_outliers = min_outliers
        self.max_outliers = max_outliers
        self.noise = noise
        self.transform = transform
        self.length = length
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        """Advance the virtual dataset so each epoch draws fresh pairs."""
        self.epoch = epoch

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7919 + idx) % (2 ** 31))
        n_in = rng.randint(self.min_inliers, self.max_inliers + 1)
        n_out_s = rng.randint(self.min_outliers, self.max_outliers + 1)
        n_out_t = rng.randint(self.min_outliers, self.max_outliers + 1)

        pos_in = rng.uniform(-1.0, 1.0, (n_in, 2))
        pos_s = np.concatenate(
            [pos_in, rng.uniform(2.0, 3.0, (n_out_s, 2))]).astype(np.float32)
        pos_t_in = pos_in + self.noise * rng.randn(n_in, 2)
        pos_t = np.concatenate(
            [pos_t_in, rng.uniform(2.0, 3.0, (n_out_t, 2))]).astype(
                np.float32)

        g_s = Graph(edge_index=np.zeros((2, 0), np.int64), pos=pos_s)
        g_t = Graph(edge_index=np.zeros((2, 0), np.int64), pos=pos_t)
        if self.transform is not None:
            g_s = self.transform(g_s)
            g_t = self.transform(g_t)
        y_col = np.concatenate([np.arange(n_in),
                                np.full(n_out_s, -1)]).astype(np.int64)
        return GraphPair(s=g_s, t=g_t, y_col=y_col)


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
