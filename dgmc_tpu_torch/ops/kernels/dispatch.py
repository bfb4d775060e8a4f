"""Dispatch ledger for the hand-written kernels.

Every gate in front of a kernel reports its outcome here: ``kernel``
(the CUDA kernel launched) or ``plain`` (the plain PyTorch version ran),
or, for the host's C++ collation (``collate``), ``native`` or ``numpy``,
with the reason and the dtype of the inputs it ran on (``float32`` or
``bfloat16``: the precision policy's variant) — so a run shows which
kernels its main path actually used, and in which dtype, instead of
leaving it to inference from timings.

Each kernel wrapper also carries a plain integer ``launches`` counter
that it increments where it launches its kernel and nowhere else;
:func:`launch_counts` reads them and :func:`reset` clears them for every
wrapper registered with :func:`kernel_wrapper`. A CUDA graph's replay
runs no Python, so the captured step (:mod:`dgmc_tpu_torch.train.
compiled`) reads the ledger around its capture (:func:`snapshot`,
:func:`changes`), sets it back to what it was before its warm-up runs
(:func:`restore`), and adds what the capture recorded on every replay
(:func:`replay`): the counts and decisions are those of the steps
executed, on either path.

Each kernel entry also carries its work (:func:`counted`): a function
of the call's arguments that gives the FLOPs and bytes of the kernel's
contract (its shapes, k, R, dtype), which the work counter of
:mod:`~dgmc_tpu_torch.obs.cost` adds in place of the operations inside
the call, so a kernel and its plain version count the same work.

Every decision executed also feeds the telemetry registry
(:func:`dgmc_tpu_torch.obs.registry.record_dispatch`: ``dispatch.json``
and ``/metrics``), a replay its capture's decisions; a capture's
warm-up runs and the capture itself run under :func:`quiet` and feed
nothing, as they count nothing here.
"""

import contextlib
import functools
import threading

__all__ = ['record', 'decisions', 'reset', 'kernel_wrapper',
           'launch_counts', 'snapshot', 'restore', 'changes', 'replay',
           'quiet', 'counted', 'WORK']

_lock = threading.Lock()
_local = threading.local()   # .quiet: depth of quiet() on this thread
_decisions = {}   # kernel name -> {'path', 'reason', 'dtype', 'counts',
                  #                 'dtypes'}
_wrappers = {}    # kernel name -> wrapper function (carries .launches)
#: The two paths of each kind of gate.
_PATHS = (('kernel', 'plain'), ('native', 'numpy'))
#: The active work counter (``obs.cost.WorkCounter``), or None.
counter = None
#: Kernel entry name -> its work function (:func:`counted`).
WORK = {}


def record(kernel, path, reason, dtype=None):
    """Record one gate decision: ``path`` is ``'kernel'`` or ``'plain'``
    (``'native'`` or ``'numpy'`` for the host's collation); ``dtype`` the
    inputs' (a ``torch.dtype`` or its name, ``None`` where the gate has no
    float input)."""
    pair = next((p for p in _PATHS if path in p), None)
    if pair is None:
        raise ValueError(f'unknown dispatch path {path!r}')
    name = None if dtype is None else str(dtype).replace('torch.', '')
    with _lock:
        entry = _decisions.setdefault(
            kernel, {'path': path, 'reason': reason, 'dtype': name,
                     'counts': dict.fromkeys(pair, 0), 'dtypes': {}})
        entry['path'], entry['reason'], entry['dtype'] = path, reason, name
        entry['counts'][path] += 1
        key = f'{path}:{name}'
        entry['dtypes'][key] = entry['dtypes'].get(key, 0) + 1
    _feed(kernel, path, reason, 1)


def _feed(kernel, path, reason, count):
    """Forward executed decisions to the telemetry registry (imported
    here: the obs package imports this module's importers)."""
    if getattr(_local, 'quiet', 0):
        return
    from dgmc_tpu_torch.obs.registry import record_dispatch
    record_dispatch(kernel, path, reason, count)


@contextlib.contextmanager
def quiet():
    """Decisions recorded on this thread inside the block are not fed to
    the telemetry registry (a capture's warm-up runs and its capture,
    whose decisions the ledger sets back too)."""
    _local.quiet = getattr(_local, 'quiet', 0) + 1
    try:
        yield
    finally:
        _local.quiet -= 1


def decisions():
    """``{kernel: {'path', 'reason', 'dtype', 'counts', 'dtypes'}}`` —
    the latest decision per kernel (its path, reason and dtype), how
    often each path was taken, and how often each ``'path:dtype'``."""
    with _lock:
        return {k: {'path': v['path'], 'reason': v['reason'],
                    'dtype': v['dtype'], 'counts': dict(v['counts']),
                    'dtypes': dict(v['dtypes'])}
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


def counted(name, work=None):
    """Decorator giving a kernel entry (a wrapper, its plain version or
    the differentiable function around it) its work: ``work(*args,
    **kw)`` → ``{'kernel', 'flops', 'bytes', 'out_bytes', 'dot'}`` and,
    for a differentiable function, ``'bwd'``, the same for its backward
    kernel (counted once if the nodes the call made run backward).
    ``work`` defaults to the one registered under ``name`` before.
    Without an active counter the call costs one global read."""
    if work is not None:
        WORK[name] = work
    work = WORK[name]

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            c = counter
            if c is None:
                return fn(*args, **kw)
            return c.kernel(work, fn, args, kw)
        return call
    return wrap


def launch_counts():
    """``{kernel: launches}`` for every registered wrapper."""
    with _lock:
        return {k: fn.launches for k, fn in _wrappers.items()}


def snapshot():
    """The whole ledger as it stands: ``(decisions, launch counts)``."""
    return decisions(), launch_counts()


def restore(state):
    """Set the ledger back to a :func:`snapshot` (a wrapper registered
    since then back to 0 launches)."""
    recorded, counts = state
    with _lock:
        _decisions.clear()
        for k, v in recorded.items():
            _decisions[k] = {**v, 'counts': dict(v['counts']),
                             'dtypes': dict(v['dtypes'])}
        for k, fn in _wrappers.items():
            fn.launches = counts.get(k, 0)


def changes(before, after):
    """What the ledger recorded between two snapshots: ``(launches,
    decisions)``, ``{kernel: launches}`` and, per gate, its latest
    decision with the counts by path and by ``'path:dtype'`` that it
    added."""
    (dec0, cnt0), (dec1, cnt1) = before, after
    launches = {k: n - cnt0.get(k, 0) for k, n in cnt1.items()
                if n != cnt0.get(k, 0)}
    added = {}
    for k, v in dec1.items():
        old = dec0.get(k, {'counts': {}, 'dtypes': {}})
        counts = {p: n - old['counts'].get(p, 0)
                  for p, n in v['counts'].items()}
        if any(counts.values()):
            added[k] = {'path': v['path'], 'reason': v['reason'],
                        'dtype': v['dtype'], 'counts': counts,
                        'dtypes': {d: n - old['dtypes'].get(d, 0)
                                   for d, n in v['dtypes'].items()
                                   if n != old['dtypes'].get(d, 0)}}
    return launches, added


def replay(launches, recorded=None):
    """Add what one replay of a captured graph executed: ``launches``
    (``{kernel: launches}``) to the wrappers' counters and ``recorded``
    (:func:`changes`' decisions) to the ledger."""
    with _lock:
        for k, n in launches.items():
            _wrappers[k].launches += n
        for k, v in (recorded or {}).items():
            pair = next(p for p in _PATHS if v['path'] in p)
            entry = _decisions.setdefault(
                k, {'path': v['path'], 'reason': v['reason'],
                    'dtype': v['dtype'], 'counts': dict.fromkeys(pair, 0),
                    'dtypes': {}})
            entry['path'], entry['reason'] = v['path'], v['reason']
            entry['dtype'] = v['dtype']
            for p, n in v['counts'].items():
                entry['counts'][p] = entry['counts'].get(p, 0) + n
            for d, n in v['dtypes'].items():
                entry['dtypes'][d] = entry['dtypes'].get(d, 0) + n
    for k, v in (recorded or {}).items():
        for p, n in v['counts'].items():
            if n:
                _feed(k, p, v['reason'], n)
