"""Dispatch ledger for the hand-written kernels.

Every gate in front of a kernel reports its outcome here: ``kernel``
(the CUDA kernel launched) or ``plain`` (the plain PyTorch version ran),
with the reason — so a run shows which kernels its main path actually
used instead of leaving it to inference from timings.

Each kernel wrapper also carries a plain integer ``launches`` counter
that it increments where it launches its kernel and nowhere else;
:func:`launch_counts` reads them and :func:`reset` clears them for every
wrapper registered with :func:`kernel_wrapper`.
"""

import threading

__all__ = ['record', 'decisions', 'reset', 'kernel_wrapper',
           'launch_counts']

_lock = threading.Lock()
_decisions = {}   # kernel name -> {'path', 'reason', 'counts'}
_wrappers = {}    # kernel name -> wrapper function (carries .launches)


def record(kernel, path, reason):
    """Record one gate decision: ``path`` is ``'kernel'`` or ``'plain'``."""
    if path not in ('kernel', 'plain'):
        raise ValueError(f'unknown dispatch path {path!r}')
    with _lock:
        entry = _decisions.setdefault(
            kernel, {'path': path, 'reason': reason,
                     'counts': {'kernel': 0, 'plain': 0}})
        entry['path'], entry['reason'] = path, reason
        entry['counts'][path] += 1


def decisions():
    """``{kernel: {'path', 'reason', 'counts'}}`` — the latest decision
    per kernel and how often each path was taken."""
    with _lock:
        return {k: {'path': v['path'], 'reason': v['reason'],
                    'counts': dict(v['counts'])}
                for k, v in _decisions.items()}


def reset():
    """Clear the decisions and every wrapper's launch counter."""
    with _lock:
        _decisions.clear()
        for fn in _wrappers.values():
            fn.launches = 0


def kernel_wrapper(name):
    """Decorator registering a kernel wrapper under ``name`` and giving
    it a ``launches`` counter starting at 0."""
    def register(fn):
        fn.launches = 0
        with _lock:
            _wrappers[name] = fn
        return fn
    return register


def launch_counts():
    """``{kernel: launches}`` for every registered wrapper."""
    with _lock:
        return {k: fn.launches for k, fn in _wrappers.items()}
