"""Host-side eval accounting: raw correct-counts to fractions.

The port's copy of ``dgmc_tpu/models/evalsum.py``. The eval steps
return summed counts (``metrics.acc(..., reduction='sum')`` and
``hits_at_k``) and the number of scored pairs; the host divides once, in
:func:`eval_summary`.
"""

__all__ = ['eval_summary']


def eval_summary(count, loss=None, **counts):
    """Named eval fractions from raw summed counts.

    ``count`` is the number of scored pairs (the denominator); each
    keyword is a raw correct-count (``hits1=correct_sum,
    hits10=hits10_sum``) and comes back divided by ``count`` under the
    same name. ``loss`` passes through unchanged (it is already a mean).
    ``max(count, 1)`` keeps an empty eval split at 0.0 rather than NaN,
    and ``count`` itself is reported as it is, so an empty split stays
    visible.
    """
    n = float(count)
    denom = max(n, 1.0)
    out = {'count': n}
    if loss is not None:
        out['loss'] = float(loss)
    for name, c in counts.items():
        out[name] = float(c) / denom
    return out
