"""Padding-waste accounting: goodput = useful FLOPs ÷ executed FLOPs.

The port's copy of the JAX package's ``dgmc_tpu/obs/goodput.py``. Every
padded batch (``utils/data.pad_graphs``, the serve router's
``pad_query``) executes the full bucket shape whatever the real graph
sizes were. This module turns the validity masks and the real-size
totals into:

- **fill fractions** — real ÷ padded, per axis (nodes and edges, plus
  the correspondence axis ``corr = node_fill_s · node_fill_t``, the
  axis the O(N_s·N_t)-shaped stages scale on);
- a **goodput ratio** — useful FLOPs ÷ executed FLOPs, composed with a
  per-stage FLOP table when one is given (each stage discounts along the
  axis its cost scales with, :data:`STAGE_AXES`), else the conservative
  mask-only fallback. The port records no per-stage FLOP table yet, so
  its serving engine passes ``stages=None``;
- the padding rows joined with their real totals
  (:func:`merge_real_rows`, ``timings.json``'s ``padding_buckets``).
  ``goodput.json`` waits for the FLOP table.

Touches no device.
"""

import math

__all__ = ['STAGE_AXES', 'fill_fraction', 'pair_fills', 'goodput_ratio',
           'merge_real_rows']

#: Which fill axis each cost stage's FLOPs scale along (the model stages
#: of :data:`~dgmc_tpu_torch.obs.qtrace.SERVE_SPAN_STAGES`): the ψ nets
#: are message passing over edges; the
#: correspondence/shortlist/consensus stages carry O(N_s·N_t)-shaped
#: work; loss reductions scale with source nodes; the optimizer touches
#: parameters only (no padding axis at all — fill 1.0).
STAGE_AXES = {
    'psi1': 'edges',
    'psi2': 'edges',
    'initial_corr': 'corr',
    'topk': 'corr',
    'consensus_iter': 'corr',
    'loss': 'nodes',
    'optimizer': 'none',
    'other': 'nodes',
}


def fill_fraction(real, padded):
    """real ÷ padded, clamped to [0, 1]; ``None`` when undefined."""
    try:
        real, padded = float(real), float(padded)
    except (TypeError, ValueError):
        return None
    if padded <= 0 or not math.isfinite(real) or not math.isfinite(padded):
        return None
    return max(0.0, min(1.0, real / padded))


def _axis_fills(nodes_real, nodes_padded, edges_real, edges_padded,
                node_fill_s=None, node_fill_t=None):
    fills = {
        'nodes': fill_fraction(nodes_real, nodes_padded),
        'edges': fill_fraction(edges_real, edges_padded),
    }
    if node_fill_s is not None and node_fill_t is not None:
        fills['corr'] = node_fill_s * node_fill_t
    else:
        fills['corr'] = fills['nodes']
    return fills


def pair_fills(s_account, t_account):
    """Combined fill fractions for a padded pair (two accounts
    ``{nodes_real, nodes_padded, edges_real, edges_padded}``): per-axis real ÷ padded over both
    sides, plus the correspondence axis ``corr`` = node fill of the
    source side × node fill of the target side."""
    nf_s = fill_fraction(s_account['nodes_real'], s_account['nodes_padded'])
    nf_t = fill_fraction(t_account['nodes_real'], t_account['nodes_padded'])
    return _axis_fills(
        s_account['nodes_real'] + t_account['nodes_real'],
        s_account['nodes_padded'] + t_account['nodes_padded'],
        s_account['edges_real'] + t_account['edges_real'],
        s_account['edges_padded'] + t_account['edges_padded'],
        node_fill_s=nf_s, node_fill_t=nf_t)


def goodput_ratio(fills, stages=None):
    """Useful FLOPs ÷ executed FLOPs for one padded execution.

    ``fills`` is an axis→fill dict (:func:`pair_fills` output). With a ``stages`` table
    (``{stage: {'flops', ...}}``) each
    stage's FLOPs are discounted along its :data:`STAGE_AXES` axis and
    the ratio is the FLOP-weighted mean; without one, the conservative
    fallback is the smallest defined axis fill (every stage scales
    along SOME padded axis, so no stage can be more useful than the
    emptiest axis claims).
    """
    if stages:
        useful = executed = 0.0
        for stage, row in stages.items():
            flops = float(row.get('flops') or 0) or float(
                row.get('bytes_out') or 0)
            if flops <= 0:
                continue
            axis = STAGE_AXES.get(stage, 'nodes')
            fill = 1.0 if axis == 'none' else fills.get(axis)
            if fill is None:
                fill = _fallback_fill(fills)
                if fill is None:
                    continue
            executed += flops
            useful += flops * fill
        if executed > 0:
            return useful / executed
    return _fallback_fill(fills)


def _fallback_fill(fills):
    defined = [v for v in fills.values() if v is not None]
    return min(defined) if defined else None


def merge_real_rows(bucket_rows, real_rows):
    """Join the real-size totals (``registry.padding_real_table`` rows:
    ``{batch, nodes, edges, axis, count}``) onto their padding-bucket
    rows as ``real_<axis>`` fields. Rows without a recorded real
    account pass through untouched; the bucket identity stays
    batch/nodes/edges."""
    reals = {}
    for r in real_rows or []:
        key = (r.get('batch'), r.get('nodes'), r.get('edges'))
        reals.setdefault(key, {})[f'real_{r.get("axis")}'] = r.get('count')
    out = []
    for row in bucket_rows or []:
        extra = reals.get((row.get('batch'), row.get('nodes'),
                           row.get('edges')))
        out.append(dict(row, **extra) if extra else dict(row))
    return out
