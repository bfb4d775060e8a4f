"""In-graph numerics probes: per-step model internals without host syncs.

The port of the JAX package's ``dgmc_tpu/obs/probes.py``: the same
probe names, metadata and helpers (``corr_entropy``, ``topk_mass``,
``consensus_delta``, ``grad_norm``, ``nonfinite`` with its static
pipeline ``order``). JAX streams each value out of its compiled program
through ``jax.debug.callback``; a captured CUDA graph can hold no host
callback, so the port streams them through a **probe tape**:

- The switch (:func:`enabled`) is a Python bool read when a step's code
  runs: on the card, when its graph is captured
  (:meth:`~dgmc_tpu_torch.train.compiled.Compiled._build`); on the CPU,
  at every call. Probe call sites pass their metric as a 0-argument
  thunk, so with probes off neither the metric nor anything else of a
  probe runs, and a captured graph has the launches and outputs of a
  build without probe call sites.
- With probes on, a train step records under :func:`recording`: each
  :func:`emit` and :func:`check_finite` appends one float32 device
  scalar, in order, and the step returns them stacked (a
  :class:`ProbeTape`: its ``layout``, each slot's name and metadata, is
  fixed when the step's code runs, so a captured graph's replays
  overwrite the same static ``values`` tensor). Nothing is read on the
  host inside the step (the capture's sync-debug mode would raise).
- After each call the step hands its tape to :func:`submit`: on the
  card, a non-blocking copy into pinned memory behind a CUDA event; on
  the CPU, the values read at once. :func:`drain` hands the records of
  every copy that has landed to the sinks, in order (``wait=True``
  waits for all of them, the port's ``jax.effects_barrier()``). Each
  record is ``{'probe', 'value', 'time', **meta}`` as in JAX; the
  :func:`set_step` tag in force when the tape was submitted is
  :func:`delivering_step` while its records are dispatched, so a sink
  attributes a record to the step that made it, however late it lands.
- An :func:`emit` outside :func:`recording` (a forward called directly)
  reads its value at once and dispatches it.

Records of one step arrive in the step's order; the first-offender rule
(:meth:`~dgmc_tpu_torch.obs.run.RunObserver._on_probe`) still sorts on
``(step, order)``, as JAX's unordered callbacks require.
"""

import collections
import contextlib
import math
import threading
import time

import torch

__all__ = [
    'enabled', 'enable', 'disable', 'add_sink', 'remove_sink',
    'activated', 'ProbeLog', 'Aggregator', 'ProbeTape', 'recording',
    'emit', 'check_finite', 'submit', 'take', 'drain', 'pending',
    'set_step', 'delivering_step', 'PROBE_KEY',
    'entropy', 'topk_mass', 'delta_norm', 'global_norm',
]

#: The key under which a train step's metrics carry its tape until the
#: step's wrapper :func:`take` s it.
PROBE_KEY = '_probe_tape'

_lock = threading.Lock()
_enabled = False
_sinks = []
_pending = collections.deque()   # (layout, host values, event, time, tag)
_step_tag = None
_local = threading.local()       # .entries: the tape being recorded;
                                 # .delivering: the tag being dispatched


def enabled():
    """The probe switch (a plain Python bool)."""
    return _enabled


def enable(sink=None):
    """Turn probes on (idempotent); optionally register ``sink``. Must
    run before a step that should carry probes is captured."""
    global _enabled
    with _lock:
        _enabled = True
        if sink is not None and sink not in _sinks:
            _sinks.append(sink)


def disable(sink=None):
    """Turn probes off for steps run or captured from now on; optionally
    unregister ``sink``. Graphs captured with probes on keep writing
    their tapes."""
    global _enabled
    with _lock:
        _enabled = False
        if sink is not None and sink in _sinks:
            _sinks.remove(sink)


def add_sink(fn):
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn):
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


class ProbeLog:
    """Minimal list sink: ``ProbeLog()`` collects records for tests."""

    def __init__(self):
        self.records = []

    def __call__(self, rec):
        self.records.append(rec)

    def by_name(self, name):
        return [r for r in self.records if r['probe'] == name]


class Aggregator:
    """Streaming per-probe aggregates (count/mean/last/min/max).

    Non-finite values are counted (``nonfinite_values``) but kept out of
    mean/min/max/last: one NaN must not poison the run's statistics."""

    def __init__(self):
        self._agg = {}

    def add(self, name, value):
        a = self._agg.setdefault(
            name, {'count': 0, 'finite': 0, 'sum': 0.0, 'min': None,
                   'max': None, 'last': None, 'nonfinite': 0})
        a['count'] += 1
        if math.isfinite(value):
            a['finite'] += 1
            a['sum'] += value
            a['min'] = value if a['min'] is None else min(a['min'], value)
            a['max'] = value if a['max'] is None else max(a['max'], value)
            a['last'] = value
        else:
            a['nonfinite'] += 1

    def __bool__(self):
        return bool(self._agg)

    def summary(self):
        out = {}
        for name, a in sorted(self._agg.items()):
            r = lambda v: None if v is None else round(v, 6)  # noqa: E731
            s = {'count': a['count'],
                 'mean': r(a['sum'] / a['finite']) if a['finite'] else None,
                 'last': r(a['last']),
                 'min': r(a['min']),
                 'max': r(a['max'])}
            if a['nonfinite']:
                s['nonfinite_values'] = a['nonfinite']
            out[name] = s
        return out


@contextlib.contextmanager
def activated(sink=None):
    """Scoped enable for tests: probes on (with ``sink``) inside the
    block; on exit every submitted tape is drained into the sinks, then
    the prior switch state is restored."""
    global _enabled
    prev = _enabled
    enable(sink)
    try:
        yield sink
    finally:
        drain(wait=True)
        with _lock:
            _enabled = prev
            if sink is not None and sink in _sinks:
                _sinks.remove(sink)


def _dispatch(rec):
    with _lock:
        sinks = list(_sinks)
    for s in sinks:
        try:
            s(rec)
        except Exception:
            # A broken sink must never take down the step that streams
            # diagnostics through it.
            pass


class ProbeTape:
    """One step's probes: ``layout`` (each slot's ``(name, meta)``, in
    emission order) and ``values`` (float32 ``[len(layout)]`` on the
    step's device; a captured graph's static output)."""

    __slots__ = ('layout', 'values')

    def __init__(self, layout, values):
        self.layout = layout
        self.values = values


class _Recorder:
    def __init__(self):
        self.entries = []

    def tape(self):
        """The :class:`ProbeTape` of what was recorded (``None`` if
        nothing was)."""
        if not self.entries:
            return None
        return ProbeTape([(n, m) for n, m, _ in self.entries],
                         torch.stack([v for _, _, v in self.entries]))


@contextlib.contextmanager
def recording():
    """Record the probes emitted inside the block on this thread onto a
    tape: yields a recorder whose ``tape()`` stacks them, or ``None``
    (and records nothing) while probes are off."""
    if not _enabled:
        yield None
        return
    prev = getattr(_local, 'entries', None)
    rec = _Recorder()
    _local.entries = rec.entries
    try:
        yield rec
    finally:
        _local.entries = prev


def emit(name, value, **meta):
    """Stream one scalar probe out of the running step.

    Args:
        name: probe name (``corr_entropy``, ``grad_norm``, ...).
        value: a scalar tensor, or a **0-argument callable** returning
            one (a thunk: skipped entirely while probes are off).
        **meta: static metadata attached to the record (``stage=...``,
            ``iteration=...``, ``order=...``).
    """
    if not _enabled:
        return
    with torch.no_grad():
        v = value() if callable(value) else value
        v = torch.as_tensor(v).detach().to(torch.float32).reshape(())
    entries = getattr(_local, 'entries', None)
    if entries is not None:
        entries.append((name, meta, v))
        return
    _deliver([(name, meta)], [v.item()], time.time(), _step_tag)


def check_finite(stage, *arrays, order=0, **meta):
    """Emit a ``nonfinite`` probe (0.0 / 1.0) for ``stage`` covering
    ``arrays`` (at least one). ``order`` is the stage's static position
    in the pipeline (psi1 0 < initial_corr 1 < consensus_iter 2 + i <
    loss 1000 < grad 1001): the sink picks the firing check with the
    lowest ``(step, order)``."""
    if not _enabled:
        return

    def bad():
        flag = ~torch.isfinite(arrays[0]).all()
        for a in arrays[1:]:
            flag = flag | ~torch.isfinite(a).all()
        return flag

    emit('nonfinite', bad, stage=stage, order=order, **meta)


def set_step(tag):
    """The tag (the observer's step index) given to tapes submitted from
    now on."""
    global _step_tag
    _step_tag = tag


def delivering_step():
    """The tag of the tape whose records are being dispatched (``None``
    outside a dispatch, and for an :func:`emit` outside a tape with no
    tag set)."""
    return getattr(_local, 'delivering', None)


def _deliver(layout, values, now, tag):
    prev = getattr(_local, 'delivering', None)
    _local.delivering = tag
    try:
        for (name, meta), v in zip(layout, values):
            _dispatch({'probe': name, 'value': float(v), 'time': now,
                       **meta})
    finally:
        _local.delivering = prev


def submit(tape):
    """Hand one step's tape over for delivery: read at once on the CPU;
    on the card copied without blocking into pinned memory behind an
    event, delivered by a later :func:`drain`."""
    if tape is None:
        return
    now, tag, vals = time.time(), _step_tag, tape.values
    if vals.device.type != 'cuda':
        _deliver(tape.layout, vals.tolist(), now, tag)
        return
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with _lock:
        _pending.append((tape.layout, host, event, now, tag))


def take(out):
    """``out`` without its tape (a train step's metrics), the tape
    :func:`submit` ted; ``out`` itself when it carries none."""
    if PROBE_KEY not in out:
        return out
    out = dict(out)
    submit(out.pop(PROBE_KEY))
    return out


def pending():
    """Tapes submitted and not yet delivered."""
    with _lock:
        return len(_pending)


def drain(wait=False):
    """Deliver, in submission order, every pending tape whose copy has
    landed (with ``wait``, all of them, waiting on each copy's event);
    returns how many were delivered."""
    n = 0
    while True:
        with _lock:
            if not _pending:
                return n
            layout, host, event, now, tag = _pending[0]
            if not wait and not event.query():
                return n
            _pending.popleft()
        event.synchronize()
        _deliver(layout, host.tolist(), now, tag)
        n += 1


# ---------------------------------------------------------------------------
# Metric helpers (device tensors in, a 0-d float32 tensor out)
# ---------------------------------------------------------------------------

_EPS = 1e-12


def _row_mean(per_row, row_mask):
    if row_mask is None:
        return per_row.mean()
    m = row_mask.to(per_row.dtype)
    return (per_row * m).sum() / m.sum().clamp(min=1.0)


def entropy(S, row_mask=None):
    """Mean per-row entropy of a probability tensor ``[..., rows, C]``
    (zero entries contribute zero; ``row_mask`` selects valid rows)."""
    S = S.to(torch.float32)
    h = -torch.where(S > 0, S * torch.log(S.clamp(min=_EPS)),
                     0.0).sum(dim=-1)
    return _row_mean(h, row_mask)


def topk_mass(S, k, row_mask=None):
    """Mean per-row probability mass of the ``k`` largest entries."""
    S = S.to(torch.float32)
    k = max(1, min(int(k), S.shape[-1]))
    return _row_mean(torch.topk(S, k, dim=-1).values.sum(dim=-1), row_mask)


def delta_norm(S_new, S_old, row_mask=None):
    """Mean-over-batch Frobenius norm of ``S_new - S_old`` (rows outside
    ``row_mask`` zeroed): Algorithm 1's per-iteration correction size."""
    d = (S_new - S_old).to(torch.float32)
    if row_mask is not None:
        d = d * row_mask[..., None].to(d.dtype)
    dims = tuple(range(1, d.dim()))
    return torch.sqrt((d * d).sum(dim=dims)).mean()


def global_norm(tensors):
    """The L2 norm of ``tensors`` taken together (optax's
    ``global_norm``): one ``foreach`` norm a tensor, then their norm."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.to(torch.float32) for t in tensors])))
