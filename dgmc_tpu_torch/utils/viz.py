"""Correspondence visualization on the host (``dgmc_tpu/utils/viz.py``):
a (source, target) keypoint-graph pair side by side and the predicted
matches as lines, coloured by correctness where the ground truth is
given. Matplotlib is imported inside :func:`plot_matches` only."""

import numpy as np

__all__ = ['predicted_targets', 'plot_matches']


def _numpy(a):
    return a.detach().cpu().numpy() if hasattr(a, 'detach') else np.asarray(a)


def predicted_targets(corr):
    """Per-source-row argmax target of a
    :class:`~dgmc_tpu_torch.models.dgmc.Correspondence` (dense or sparse)
    as a ``[B, N_s]`` numpy int array."""
    val = _numpy(corr.val)
    if corr.idx is None:
        return val.argmax(axis=-1)
    idx = _numpy(corr.idx)
    best = val.argmax(axis=-1)
    return np.take_along_axis(idx, best[..., None], axis=-1)[..., 0]


def plot_matches(pos_s, pos_t, pred, y=None, edges_s=None, edges_t=None,
                 ax=None, offset=None, point_color='#1f77b4',
                 edge_color='#cccccc'):
    """Render one pair's predicted matches.

    Args:
        pos_s / pos_t: ``[N_s, 2]`` / ``[N_t, 2]`` keypoint coordinates.
        pred: ``[N_s]`` predicted target index per source keypoint (see
            :func:`predicted_targets`), ``-1`` to skip a row.
        y: optional ``[N_s]`` ground-truth targets (``-1`` = no ground
            truth); correct matches draw green, wrong ones red, unlabelled
            grey.
        edges_s / edges_t: optional ``[E, 2]`` (sender, receiver) arrays
            drawn as light graph structure.
        offset: translation of the target cloud so that the two graphs
            sit side by side; by default 1.5 times the source's width to
            the right.
        ax: matplotlib axes to draw on (one is created otherwise).

    Returns the matplotlib axes.
    """
    import matplotlib.pyplot as plt

    pos_s = _numpy(pos_s).astype(float)
    pos_t = _numpy(pos_t).astype(float)
    pred = _numpy(pred)
    y = None if y is None else _numpy(y)
    if offset is None:
        width = max(pos_s[:, 0].max() - pos_s[:, 0].min(), 1e-6)
        offset = np.array([1.5 * width, 0.0])
    pos_t = pos_t + np.asarray(offset, float)

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))

    for pos, edges in ((pos_s, edges_s), (pos_t, edges_t)):
        if edges is not None:
            for a, b in _numpy(edges):
                ax.plot([pos[a, 0], pos[b, 0]], [pos[a, 1], pos[b, 1]],
                        color=edge_color, linewidth=0.8, zorder=1)
    ax.scatter(pos_s[:, 0], pos_s[:, 1], s=28, c=point_color, zorder=3)
    ax.scatter(pos_t[:, 0], pos_t[:, 1], s=28, c=point_color, zorder=3)

    for i, j in enumerate(pred):
        if j < 0 or j >= len(pos_t):
            continue
        if y is None or y[i] < 0:
            color = '#999999'
        else:
            color = '#2ca02c' if int(y[i]) == int(j) else '#d62728'
        ax.plot([pos_s[i, 0], pos_t[j, 0]], [pos_s[i, 1], pos_t[j, 1]],
                color=color, linewidth=1.2, alpha=0.85, zorder=2)

    ax.set_aspect('equal')
    ax.axis('off')
    return ax
