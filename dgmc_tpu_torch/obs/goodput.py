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
  per-stage FLOP table when one is given (the work counter's,
  :func:`~dgmc_tpu_torch.obs.cost.cost_summary`: each stage discounts
  along the axis its cost scales with, :data:`STAGE_AXES`), else the
  conservative mask-only fallback;
- the ``goodput.json`` artifact (:func:`payload_from_rows`) rebuilt
  from any recorded obs dir's padding rows — pad waste is recomputable
  post-hoc, not just live.

Touches no device.
"""


import math

__all__ = ['STAGE_AXES', 'fill_fraction', 'mask_fills', 'pair_fills',
           'goodput_ratio', 'row_fills', 'payload_from_rows',
           'merge_real_rows']

#: Which fill axis each cost stage's FLOPs scale along (the stages of
#: :data:`~dgmc_tpu_torch.obs.stages.STAGE_NAMES`): the ψ nets are
#: message passing over edges; the
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


def mask_fills(node_mask, edge_mask):
    """Fill account of one padded ``GraphBatch`` side from its validity
    masks (``[B, N]`` / ``[B, E]`` bool arrays or tensors — any object
    exposing ``.sum()`` and ``.size`` (an attribute, or a tensor's
    method) works)."""
    return {
        'nodes_real': int(node_mask.sum()),
        'nodes_padded': _size(node_mask),
        'edges_real': int(edge_mask.sum()),
        'edges_padded': _size(edge_mask),
    }


def _size(mask):
    size = mask.size
    return int(mask.numel() if callable(size) else size)


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
    """Combined fill fractions for a padded pair (two
    :func:`mask_fills` accounts): per-axis real ÷ padded over both
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

    ``fills`` is an axis→fill dict (:func:`pair_fills` /
    :func:`row_fills` output). With a ``stages`` table
    (``{stage: {'flops', ...}}``, a cost summary's) each
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


def _split_pair(value):
    try:
        a, b = str(value).split('x')
        return int(a), int(b)
    except (ValueError, AttributeError):
        return None, None


def row_fills(row):
    """Fill fractions recomputed from one recorded padding-bucket row
    (``registry.padding_bucket_table`` format plus the
    ``real_nodes_s/real_nodes_t/real_edges_s/real_edges_t`` totals the
    collation layer records). ``None`` when the row predates the real-
    size account — absence is honest, never guessed."""
    reals = [row.get(k) for k in ('real_nodes_s', 'real_nodes_t',
                                  'real_edges_s', 'real_edges_t')]
    if any(v is None for v in reals):
        return None
    n_s, n_t = _split_pair(row.get('nodes'))
    e_s, e_t = _split_pair(row.get('edges'))
    if None in (n_s, n_t, e_s, e_t):
        return None
    collations = int(row.get('count', 0)) * int(row.get('batch', 1) or 1)
    if collations <= 0:
        return None
    rn_s, rn_t, re_s, re_t = (int(v) for v in reals)
    nf_s = fill_fraction(rn_s, collations * n_s)
    nf_t = fill_fraction(rn_t, collations * n_t)
    return _axis_fills(rn_s + rn_t, collations * (n_s + n_t),
                       re_s + re_t, collations * (e_s + e_t),
                       node_fill_s=nf_s, node_fill_t=nf_t)


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


def payload_from_rows(rows, stages=None, source='padding_bucket_table'):
    """The ``goodput.json`` body from (merged) padding rows.

    Per-bucket pad fraction + goodput ratio, and the collation-weighted
    aggregate — weighted by each bucket's executed (padded) node total,
    the closest artifact-only proxy for its executed FLOPs. ``stages``
    (a cost summary's stage table) upgrades every ratio from the
    mask-only fallback to the FLOP-composed account. ``None`` when no
    row carries the real-size account (an old recording) — the diff
    gate's lost-account rule needs absence to stay absent.
    """
    buckets = []
    agg_useful = agg_weight = 0.0
    for row in rows or []:
        fills = row_fills(row)
        if fills is None:
            continue
        ratio = goodput_ratio(fills, stages)
        n_s, n_t = _split_pair(row.get('nodes'))
        weight = (int(row.get('count', 0))
                  * int(row.get('batch', 1) or 1)
                  * ((n_s or 0) + (n_t or 0)))
        buckets.append({
            'batch': row.get('batch'),
            'nodes': row.get('nodes'),
            'edges': row.get('edges'),
            'count': row.get('count'),
            'node_fill': _round(fills.get('nodes')),
            'edge_fill': _round(fills.get('edges')),
            'corr_fill': _round(fills.get('corr')),
            'pad_fraction': _round(1.0 - fills['nodes']
                                   if fills.get('nodes') is not None
                                   else None),
            'goodput_ratio': _round(ratio),
        })
        if ratio is not None and weight > 0:
            agg_useful += ratio * weight
            agg_weight += weight
    if not buckets:
        return None
    ratio = agg_useful / agg_weight if agg_weight > 0 else None
    pads = [b['pad_fraction'] for b in buckets
            if b['pad_fraction'] is not None]
    return {
        'source': source,
        'composed_with_stage_flops': bool(stages),
        'goodput_ratio': _round(ratio),
        'pad_fraction_max': _round(max(pads)) if pads else None,
        'buckets': buckets,
    }


def _round(v, digits=6):
    return None if v is None else round(float(v), digits)
