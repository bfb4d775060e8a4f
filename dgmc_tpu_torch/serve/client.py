"""Client-side query sampling (NumPy, no device)."""

import numpy as np

from dgmc_tpu_torch.utils.data import Graph

__all__ = ['sample_query']


def sample_query(corpus_x, num_nodes, num_edges, seed=0, noise=0.6):
    """One synthetic query against a corpus feature table.

    Picks ``num_nodes`` random corpus entities, emits variance-preserving
    noisy copies of their features plus random edges among the picked
    nodes. Returns ``(Graph, gt)`` where ``gt[i]`` is the corpus index
    query node ``i`` was sampled from. Same draws as the JAX package's
    ``sample_query`` for one seed.
    """
    rng = np.random.RandomState(seed)
    n_t, dim = corpus_x.shape
    picks = rng.choice(n_t, size=num_nodes, replace=False)
    sigma = rng.uniform(0.2, noise, (num_nodes, 1)).astype(np.float32)
    eps = (rng.randn(num_nodes, dim) / np.sqrt(dim)).astype(np.float32)
    x = ((corpus_x[picks] + sigma * eps)
         / np.sqrt(1.0 + sigma ** 2)).astype(np.float32)
    snd = rng.randint(0, num_nodes, num_edges)
    rcv = rng.randint(0, num_nodes, num_edges)
    g = Graph(edge_index=np.stack([snd, rcv]).astype(np.int64), x=x)
    return g, picks.astype(np.int64)
