"""Pipeline stages: the ranges the model and the train step run under.

The JAX package names its stages with ``jax.named_scope`` and reads them
back from each op's scope path (``dgmc_tpu/analysis/hlo_comm.py``:
``STAGE_NAMES``, ``stage_of``). The port runs the same names as
``torch.profiler.record_function`` ranges through :func:`stage`, which
also keeps the innermost stage of each thread where the work counter
(:mod:`~dgmc_tpu_torch.obs.cost`) reads it:

- the model's ``psi1``, ``initial_corr``, ``topk``, ``consensus_iter``
  and ``psi2`` (``models/dgmc.py``; ``psi2`` nests in
  ``consensus_iter``);
- the train step's ``loss``, ``optimizer`` and ``metrics``
  (``train/steps.py``); ``metrics`` is no stage of :data:`STAGE_NAMES`,
  so its work counts as ``other``, as in the JAX package.

While a work counter listens (:func:`listen`), every change of the
innermost stage is reported with the autograd sequence number in force,
so that a backward node is put in the stage its forward op ran in.
Without a listener a range costs one list push and pop beside the
``record_function``.
"""

import contextlib
import threading

from torch.profiler import record_function

__all__ = ['STAGE_NAMES', 'stage_of', 'stage', 'current', 'listen']

#: Pipeline stages, innermost scope wins (the JAX package's
#: ``hlo_comm.STAGE_NAMES``; ``psi2`` nests inside ``consensus_iter``).
STAGE_NAMES = ('psi1', 'psi2', 'initial_corr', 'topk', 'consensus_iter',
               'loss', 'optimizer')

_local = threading.local()    # .stack: the open range names, outer first
_listener = None              # listen()'s callback, or None


def stage_of(op_name):
    """Map one scope path (``'/'``-separated range names) to its pipeline
    stage: the innermost segment naming a stage wins; ``'other'`` when
    none does (JAX's ``stage_of``)."""
    for seg in reversed(op_name.split('/')):
        for name in STAGE_NAMES:
            if name in seg:
                return name
    return 'other'


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current():
    """The innermost stage of this thread's open ranges (``'other'``
    outside every stage)."""
    return stage_of('/'.join(_stack()))


@contextlib.contextmanager
def stage(name):
    """Run the block under the ``record_function`` range ``name`` and as
    this thread's innermost range."""
    stack = _stack()
    with record_function(name):
        stack.append(name)
        listener = _listener
        if listener is not None:
            listener(current())
        try:
            yield
        finally:
            stack.pop()
            if listener is not None:
                listener(current())


@contextlib.contextmanager
def listen(callback):
    """Report each change of the innermost stage on any thread to
    ``callback(stage)`` inside the block (one listener at a time)."""
    global _listener
    if _listener is not None:
        raise RuntimeError('a stage listener is already active')
    _listener = callback
    try:
        yield
    finally:
        _listener = None
