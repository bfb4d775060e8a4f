"""Steps compiled once per input signature: CUDA graphs on the card.

The port's counterpart of ``jax.jit``'s cache. :func:`compiled` wraps a
function of tensors and keeps one :class:`Captured` record per input
signature (the shapes and dtypes of its tensors, which optional inputs
are present, the identity of the inputs it reads in place). A record
holds the static input buffers each call copies its inputs into, the
captured ``torch.cuda.CUDAGraph``, the static outputs, the kernel
launches the graph makes and what it allocated. The first call of a
signature builds its record, as a lazy ``jit`` compiles; :meth:`Compiled.
capture` builds it ahead of time, as ``lower().compile()`` does.

On the card a record is built by torch's whole-network recipe: warm-up
runs on a side stream (kernel builds, lazy module loads, Adam's state
and the allocator's first blocks all happen there, never inside a
capture), then one run captured into the graph, then replays. Every
warm-up run and the capture run under ``torch.cuda.set_sync_debug_mode(
'error')``, so an operation that reads the device from the host raises
(:func:`sync_errors`); a capture that fails raises, it never falls back to
eager code. Two traps of the recipe:

- **Warm-up runs real steps.** A ``snapshot`` callable saves what they
  change and returns ``restore()``, run after them
  (:func:`~dgmc_tpu_torch.train.state.snapshot`): the captured run starts
  from the state the eager one would, as ``lower().compile()`` never
  runs a step. The dispatch ledger and launch counters are set back too:
  warm-up and capture count nothing, each replay adds the launches and
  gate decisions the capture recorded
  (:mod:`~dgmc_tpu_torch.ops.kernels.dispatch`).
- **Outputs are static.** Each replay overwrites the tensors the call
  returns; a caller that keeps a value past the next call clones it.

Inputs (positional, nested in tuples and NamedTuples):

- a tensor or a :class:`~dgmc_tpu_torch.ops.graph.GraphBatch` is copied
  into the record's buffer of its shape (non-blocking from pinned host
  memory). A static :class:`GraphBatch`'s caches (CSR orders, SplineCNN's
  routing) are built inside the captured region and dropped after each
  run (:meth:`GraphBatch.copy_from` refuses a stale one), so every replay
  builds them from the data copied in;
- a Python int (a step's seed) becomes a 0-d int64 device tensor holding
  its key's bits (:func:`~dgmc_tpu_torch.ops.kernels.rng.key_bits`),
  written by a fill launch before each replay;
- :class:`Fixed` ``(value)`` is read in place: the graph reads its
  storage, so its identity is part of the signature (the train state, the
  model, a batch uploaded once with its caches built once, outside the
  graph, by the warm-up);
- ``None`` marks an absent optional input.

On the CPU nothing is captured: each call copies its inputs into the
same static buffers and runs the function eagerly on them, caches
dropped after each run, and returns that run's outputs.

Each record built is one compile event of the run plane
(:func:`~dgmc_tpu_torch.obs.registry.record_compile`, kind ``capture``,
its ``capture_s``), so a warm steady state records none.

For the measured per-stage account (:mod:`~dgmc_tpu_torch.obs.trace_events`)
each record has a key: its last warm-up runs under the range
``dgmc_warmup#<key>`` (with ``--profile-dir`` and no profiler running,
profiled into a trace of its own, :func:`~dgmc_tpu_torch.obs.trace.
warmup_profile`) and, while a profiler runs, each replay under
``dgmc_replay#<key>``: a replay's kernels take their stages from the
warm-up's.
"""

import contextlib
import gc
import itertools
import os
import time

import torch

from dgmc_tpu_torch.obs.registry import record_compile
from dgmc_tpu_torch.obs.trace import warmup_profile
from dgmc_tpu_torch.obs.trace_events import REPLAY_RANGE
from dgmc_tpu_torch.ops.graph import GraphBatch, canonical_device
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.rng import key_bits

__all__ = ['WARMUP', 'Fixed', 'Captured', 'Compiled', 'compiled',
           'sync_errors', 'tensors_of']

#: Eager runs on a side stream before a capture: the first builds the
#: kernels and Adam's state, the second runs as every later step does.
WARMUP = 2


class Fixed:
    """An input read in place (see the module docstring)."""

    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


@contextlib.contextmanager
def sync_errors(device):
    """Within the block an operation on ``device`` that synchronizes with
    the host raises (``torch.cuda.set_sync_debug_mode('error')``); a no-op
    on the CPU."""
    if canonical_device(device).type != 'cuda':
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _signature(x):
    if x is None:
        return None
    if isinstance(x, Fixed):
        return ('fixed', id(x.value))
    if isinstance(x, bool):
        raise TypeError('a compiled step takes no bool inputs')
    if isinstance(x, int):
        return 'int'
    if torch.is_tensor(x):
        return ('tensor', tuple(x.shape), x.dtype)
    if isinstance(x, GraphBatch):
        return ('graph', tuple((tuple(t.shape), t.dtype)
                               for t in x.fields()), x.meta)
    if isinstance(x, tuple):
        return (type(x).__name__, tuple(_signature(e) for e in x))
    raise TypeError(f'a compiled step takes tensors, graph batches, ints, '
                    f'Fixed and None (in tuples); got {type(x).__name__}')


def _static(x, device):
    """The buffers ``x`` is copied into (``Fixed`` values as they are)."""
    if x is None:
        return None
    if isinstance(x, Fixed):
        return x.value
    if isinstance(x, int):
        return torch.zeros((), dtype=torch.int64, device=device)
    if torch.is_tensor(x):
        return torch.empty(x.shape, dtype=x.dtype, device=device)
    if isinstance(x, GraphBatch):
        return x.static_like(device)
    items = [_static(e, device) for e in x]
    return type(x)(*items) if hasattr(x, '_fields') else type(x)(items)


def _load(static, x):
    """Copy ``x`` into its buffers ``static`` on the current stream."""
    if x is None or isinstance(x, Fixed):
        return
    if isinstance(x, int):
        static.fill_(key_bits(x))
    elif torch.is_tensor(x):
        static.copy_(x, non_blocking=True)
    elif isinstance(x, GraphBatch):
        static.copy_from(x)
    else:
        for s, e in zip(static, x):
            _load(s, e)


def _graphs(static, x):
    """The static graph batches among the buffers (not ``Fixed`` ones)."""
    if isinstance(x, GraphBatch):
        yield static
    elif isinstance(x, tuple):
        for s, e in zip(static, x):
            yield from _graphs(s, e)


def tensors_of(x):
    """Every tensor an input holds: a tensor, a graph batch's fields, a
    module's parameters and buffers, a train state's parameters and
    optimizer state, and those of tuples, lists and dicts of them."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, Fixed):
        return tensors_of(x.value)
    if isinstance(x, GraphBatch):
        return x.fields()
    if isinstance(x, torch.nn.Module):
        return [*x.parameters(), *x.buffers()]
    opt = getattr(x, 'optimizer', None)
    if isinstance(opt, torch.optim.Optimizer):
        params = [p for g in opt.param_groups for p in g['params']]
        return params + [v for st in opt.state.values()
                         for v in st.values() if torch.is_tensor(v)]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in tensors_of(e)]
    return []


#: Record keys, unique in the process.
_keys = itertools.count()

class Captured:
    """One input signature's record.

    ``static``: the input buffers (``Fixed`` inputs as they are);
    ``graph``: the ``torch.cuda.CUDAGraph`` (``None`` on the CPU);
    ``outputs``: the static outputs (each replay overwrites them);
    ``launches``: ``{kernel: launches}`` one replay makes (the capture's);
    ``decisions``: the dispatch decisions the capture recorded;
    ``pool_bytes``: what the graph's private memory pool reserved;
    ``capture_s``: the seconds the record took to build, warm-up
    included; ``key``: the name of its warm-up and replay ranges."""

    def __init__(self, static, graph=None, outputs=None, launches=None,
                 decisions=None, pool_bytes=0, capture_s=0.0, key=None):
        self.static = static
        self.graph = graph
        self.outputs = outputs
        self.launches = dict(launches or {})
        self.decisions = dict(decisions or {})
        self.pool_bytes = pool_bytes
        self.capture_s = capture_s
        self.key = key

    def replay(self):
        """Replay the graph and count its launches and decisions; returns
        the static outputs."""
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(
                    f'{REPLAY_RANGE}#{self.key}'):
                self.graph.replay()
        else:
            self.graph.replay()
        dispatch.replay(self.launches, self.decisions)
        return self.outputs


class Compiled:
    """``fn`` compiled per input signature (see the module docstring).

    Args:
        fn: the step, ``fn(*inputs)`` with each input replaced by its
            static buffer (a ``Fixed`` input by its value).
        device: where the buffers live; ``cuda`` captures graphs.
        snapshot: optional ``snapshot(*inputs) -> restore``, which saves
            the state that ``fn`` changes in place; ``restore()`` runs
            after the warm-up runs.
        prepare: optional ``prepare(*inputs)`` run before every run of
            ``fn`` and every replay, with the caller's inputs (the train
            steps reseed their dropout generator there).
        generators: CUDA generators ``fn`` draws from, registered with
            each graph so that a replay draws from their state at replay
            time.
    """

    def __init__(self, fn, device, snapshot=None, prepare=None,
                 generators=()):
        self.fn = fn
        self.device = canonical_device(device)
        self.snapshot = snapshot
        self.prepare = prepare
        self.generators = tuple(generators)
        self.records = {}

    @property
    def on_card(self):
        return self.device.type == 'cuda'

    def _record(self, inputs):
        key = _signature(inputs)
        rec = self.records.get(key)
        if rec is None:
            rec = self.records[key] = self._build(inputs)
            # A compile event of the run plane (``timings.json``'s
            # compile summary, ``/metrics``), under the label in force.
            record_compile('capture', rec.capture_s)
        return rec

    def capture(self, *inputs):
        """Build the record of ``inputs``' signature ahead of the first
        call (on the CPU: its buffers and one run of ``fn`` from the
        state the snapshot restores); returns it."""
        rec = self._record(inputs)
        if rec.outputs is None:
            t0 = time.perf_counter()
            restore = self.snapshot(*inputs) if self.snapshot else None
            rec.outputs = self._run(rec, inputs)
            if restore is not None:
                restore()
            rec.capture_s += time.perf_counter() - t0
        return rec

    def __call__(self, *inputs):
        rec = self._record(inputs)
        if not self.on_card:
            return self._run(rec, inputs)
        _load(rec.static, inputs)
        if self.prepare is not None:
            self.prepare(*inputs)
        return rec.replay()

    def _run(self, rec, inputs):
        """One eager run of ``fn`` on the buffers (the CPU's path)."""
        _load(rec.static, inputs)
        if self.prepare is not None:
            self.prepare(*inputs)
        try:
            return self.fn(*rec.static)
        finally:
            for g in _graphs(rec.static, inputs):
                g.clear_memo()

    def _build(self, inputs):
        t0 = time.perf_counter()
        static = _static(inputs, self.device)
        if not self.on_card:
            return Captured(static, capture_s=time.perf_counter() - t0)
        with dispatch.quiet():
            return self._capture(inputs, static, t0)

    def _capture(self, inputs, static, t0):
        """The card's record: warm-up runs, then the capture."""
        dev = self.device
        ledger = dispatch.snapshot()
        restore = self.snapshot(*inputs) if self.snapshot else None
        _load(static, inputs)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        key = f'{os.getpid()}-{next(_keys)}'
        with torch.cuda.stream(side), warmup_profile(key, dev) as last:
            for i in range(WARMUP):
                if self.prepare is not None:
                    self.prepare(*inputs)
                # The last warm-up names the stages of the replays'
                # kernels (obs/trace_events.py).
                with (last() if i == WARMUP - 1
                      else contextlib.nullcontext()):
                    with sync_errors(dev):
                        self.fn(*static)
                for g in _graphs(static, inputs):
                    g.clear_memo()
        main.wait_stream(side)
        if restore is not None:
            restore()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # Free dead graphs (and their pools) now: a graph destroyed while
        # another is being captured invalidates that capture, so the
        # collector stays off until the capture ends.
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dispatch.snapshot()
        enabled = gc.isenabled()
        gc.disable()
        try:
            # Thread-local: another thread (a batch prefetcher allocating
            # pinned memory) may call the runtime while this one captures.
            with torch.cuda.graph(graph, capture_error_mode='thread_local'):
                with sync_errors(dev):
                    outputs = self.fn(*static)
        finally:
            if enabled:
                gc.enable()
        for g in _graphs(static, inputs):
            g.clear_memo()
        launches, decisions = dispatch.changes(before, dispatch.snapshot())
        dispatch.restore(ledger)
        torch.cuda.synchronize(dev)
        return Captured(static, graph, outputs, launches, decisions,
                        torch.cuda.memory_reserved(dev) - reserved,
                        time.perf_counter() - t0, key)


def compiled(fn, device, **kw):
    """:class:`Compiled` ``(fn, device, **kw)``."""
    return Compiled(fn, device, **kw)
