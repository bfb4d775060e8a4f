"""Trace-tier rules: one recorded run of a specimen, op by op.

The port's counterpart of the JAX package's ``analysis/jaxpr_rules.py``.
A PyTorch program has no jaxpr; the port records one run of it instead
(:class:`TapeRecorder`, a ``TorchDispatchMode``): every aten op of the
forward and the backward, in order, with its output dtypes and sizes,
the buffers (storages) it reads, writes and allocates, the pipeline
stage it ran under (:mod:`~dgmc_tpu_torch.obs.stages`) and its
provenance: the first frame outside torch, the standard library and
this ``analysis/`` package (``dgmc_tpu_torch/ops/graph.py:101``). A
backward op takes the provenance and stage of the forward op that made
its autograd node. The hand-written CUDA kernels launch through ctypes,
out of the dispatcher's sight: each kernel entry
(:func:`~dgmc_tpu_torch.ops.kernels.dispatch.counted`) marks its call on
the tape with the tensors it was given (:meth:`TapeRecorder.mark`), so
the liveness bound (:mod:`~dgmc_tpu_torch.analysis.liveness`) keeps
what a kernel reads alive until it ran.

Rule ids, severities and thresholds are JAX's (``--explain`` has the
port's what / why / fix):

``TRC001`` dtype-promotion (error)
    An op introduces a float64 or complex128 result from inputs none of
    which is one. int64 is torch's index dtype (``sort``, ``argsort``,
    ``nonzero`` return it), so it is no drift here.
``TRC002`` giant-constant (warning)
    The run reads a tensor of at least ``const_bytes`` (1 MiB) that is
    no argument, parameter, buffer or optimizer state and was not made
    in the run: a closed-over table, baked into every captured replay.
``TRC003`` host-read (error)
    A host read in the step while probes are off:
    ``_local_scalar_dense`` (``.item()``, ``float(t)``), ``is_nonzero``
    (``bool(t)``), ``equal``, ops whose output size depends on the data
    (``nonzero``, ``masked_select``, ``unique``, boolean indexing), or a
    copy from the card to the host. The dynamic counterpart of SRC102.
    One read is the optimizer's by contract, not the program's: torch's
    Adam keeps its step counts on the host and reads them there when it
    is not ``capturable``, which torch refuses for CPU tensors (on the
    card the port's Adam is capturable and reads nothing); a
    ``_local_scalar_dense`` of such a step count is no finding.
``TRC004`` inplace-state (error)
    After one step, a tensor of the state the step declares it updates
    in place (parameters, buffers, Adam's moments and step counts, the
    guard's counters) is not the tensor or the storage it was: it was
    rebound or written out of place, so a captured replay updates a
    storage nobody reads (JAX: a donation dropped).
``TRC005`` atomic-accumulation (info)
    A floating-point accumulation through atomics on the card:
    ``scatter_add``, ``scatter_reduce``, ``index_add``,
    ``index_put(accumulate=True)``, an ``embedding`` backward (a
    ``gather``'s backward is a ``scatter_add``). Their sums are not
    bit-identical from run to run (``ops/graph.py``'s promise).
``TRC006`` large-sort (warning)
    A ``sort`` / ``argsort`` / ``topk`` over an axis of at least
    ``sort_dim`` (4096) elements.
"""

import collections
import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              disambiguate_contexts,
                                              read_source_line)
from dgmc_tpu_torch.obs import stages as stages_mod

__all__ = ['TraceContext', 'TapeOp', 'Tape', 'TapeRecorder',
           'analyze_tape', 'identities', 'inplace_findings',
           'state_tensors',
           'DEFAULT_CONST_BYTES', 'DEFAULT_SORT_DIM']

DEFAULT_CONST_BYTES = 1 << 20       # 1 MiB
DEFAULT_SORT_DIM = 4096

#: Result dtypes that must not appear from narrower inputs.
_WIDE = (torch.float64, torch.complex128)

#: Ops that read the device from the host (TRC003), by overload packet.
_HOST_READS = frozenset({
    '_local_scalar_dense', 'is_nonzero', 'equal', 'nonzero',
    'masked_select', '_unique', '_unique2', 'unique_dim',
    'unique_consecutive', 'argwhere'})

#: Floating-point accumulations through atomics (TRC005).
_ATOMIC = frozenset({'scatter_add', 'scatter_add_', 'scatter_reduce',
                     'scatter_reduce_', 'index_add', 'index_add_',
                     'embedding_dense_backward',
                     '_embedding_bag_backward'})
_ACCUMULATING_PUTS = frozenset({'index_put', 'index_put_',
                                '_index_put_impl_', '_index_put_impl'})

#: Sorting ops and their default axis (TRC006).
_SORTS = frozenset({'sort', 'argsort', 'topk', 'msort'})

#: Ops that allocate without computing (with the views: the schedule
#: model's free ops, JAX's ``FREE_OPS``).
_ALLOCS = frozenset({'empty', 'empty_like', 'empty_strided', 'new_empty',
                     'new_empty_strided', 'detach', 'alias', 'lift_fresh',
                     'lift_fresh_copy'})

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__))
_ANCHORS = ('dgmc_tpu_torch', 'tests', 'examples', 'benchmarks')
#: The collectives' own module: a collective's provenance is its caller.
_COMM_FILES = (os.path.join(os.path.dirname(_ANALYSIS_DIR), 'parallel',
                            'comm.py'),)


@dataclasses.dataclass
class TraceContext:
    """Provenance prefix + thresholds for one analyzed program (JAX's)."""
    specimen: str = 'program'
    const_bytes: int = DEFAULT_CONST_BYTES
    sort_dim: int = DEFAULT_SORT_DIM
    expect_no_callbacks: bool = True


@dataclasses.dataclass
class TapeOp:
    """One recorded op (``kind='op'``) or kernel launch (``'kernel'``).

    ``allocs`` are the ``(buffer, bytes)`` it created, ``reads`` and
    ``writes`` the buffers it read and wrote in place (views read their
    base: a view's buffer is its base's)."""
    index: int
    name: str
    kind: str = 'op'
    provenance: str = '<unknown>'
    stage: str = 'other'
    backward: bool = False
    in_dtypes: Tuple[torch.dtype, ...] = ()
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_dtypes: Tuple[torch.dtype, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    allocs: Tuple[Tuple[int, int], ...] = ()
    #: Sorting ops: the size of the sorted axis.
    sort_size: Optional[int] = None
    #: Why this op reads the host (TRC003), or None.
    host_read: Optional[str] = None
    #: A floating-point accumulation through atomics (TRC005).
    atomic: bool = False
    #: A copy from the host to the card (a fetch of SCH403).
    host_to_device: bool = False
    #: Bytes of its results (the schedule model's cost of a compute op).
    out_bytes: int = 0
    #: A view or an allocation without compute (the schedule's free ops).
    free: bool = False
    #: Run inside a kernel entry (its plain version's ops): the entry's
    #: mark carries the cost.
    in_kernel: bool = False
    #: The call stack's identity (:func:`_site`; a backward op's is its
    #: forward op's): equal for a Python loop's iterations.
    site: int = 0
    #: A collective (``kind='collective'``): ``{'kind', 'group', 'dtype',
    #: 'shape', 'payload', 'async'}``.
    collective: Optional[dict] = None


@dataclasses.dataclass
class Buffer:
    """One storage of the run: made by the op at ``index`` (``origin
    'op'``), or there before it (``'argument'``: reachable from the
    specimen's arguments; ``'closure'``: not)."""
    nbytes: int
    origin: str
    index: int = -1
    shape: Tuple[int, ...] = ()
    dtype: str = ''
    stage: str = 'other'


@dataclasses.dataclass
class Tape:
    """A recorded run: its ops in order, its buffers, and the buffers
    still referenced at its end (its outputs and the state it updated)."""
    ops: List[TapeOp] = dataclasses.field(default_factory=list)
    buffers: Dict[int, Buffer] = dataclasses.field(default_factory=dict)
    outputs: set = dataclasses.field(default_factory=set)


def _frame_path(filename):
    """A stable spelling of a source path: from the package or repo
    directory it lies in (JAX's anchors), else absolute."""
    parts = os.path.abspath(filename).split(os.sep)
    for anchor in _ANCHORS:
        if anchor in parts:
            return '/'.join(parts[parts.index(anchor):])
    return os.sep.join(parts)


#: The autograd engine's entry: frames past it (outward) belong to the
#: caller of ``backward``, not to the backward being run.
_ENGINE = (os.path.join(_TORCH_DIR, 'autograd', 'graph.py'),
           os.path.join(_TORCH_DIR, 'autograd', '__init__.py'))


def _user_frame(depth=2, backward=False, skip=()):
    """``path:line`` of the innermost frame outside torch, the standard
    library, site-packages and this package. With ``backward``, only a
    frame inside the backward being run counts (a custom
    ``autograd.Function``'s): the search stops at the autograd engine's
    entry and gives None."""
    f = sys._getframe(depth)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if backward and name in _ENGINE:
            return None
        if not (name.startswith(_TORCH_DIR) or name.startswith(_ANALYSIS_DIR)
                or name.startswith(_STDLIB_DIR) or '<' in name
                or name in skip
                or 'site-packages' in name or 'dist-packages' in name):
            return f'{_frame_path(name)}:{f.f_lineno}'
        f = f.f_back
    return None if backward else '<unknown>'


def _site(depth=2):
    """The identity of the call stack (every frame's file and line):
    equal for the iterations of a Python loop, different for two calls
    of one function from two lines."""
    f = sys._getframe(depth)
    frames = []
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    return hash(tuple(frames))


def _key(t):
    """A tensor's storage key, or None for one without bytes."""
    if t.layout != torch.strided or t.device.type == 'meta':
        return None
    st = t.untyped_storage()
    if st.nbytes() == 0:
        return None
    return (t.device.type, t.device.index, st.data_ptr())


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _reachable(obj, seen=None, depth=0):
    """``obj`` and everything reachable from it: containers, modules
    (their parameters, buffers and attributes), optimizers (their
    parameters and state), dataclasses and the port's own objects. A
    tensor ends its branch."""
    seen = set() if seen is None else seen
    if depth > 12 or id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if isinstance(obj, torch.Tensor):
        return
    if isinstance(obj, dict):
        children = list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        children = list(obj)
    elif isinstance(obj, torch.optim.Optimizer):
        children = [g['params'] for g in obj.param_groups] + \
            list(obj.state.values())
    elif isinstance(obj, torch.nn.Module) or dataclasses.is_dataclass(obj) \
            or type(obj).__module__.startswith('dgmc_tpu_torch'):
        children = list(vars(obj).values()) if hasattr(obj, '__dict__') \
            else []
        children += [getattr(obj, n, None)
                     for n in getattr(type(obj), '__slots__', ())]
    else:
        return
    for child in children:
        yield from _reachable(child, seen, depth + 1)


def reachable_tensors(*objs):
    """The tensors reachable from ``objs`` (see :func:`_reachable`)."""
    return [t for t in _reachable(objs) if isinstance(t, torch.Tensor)]


def _arg(func, args, kwargs, name, default=None):
    """The value of ``func``'s schema argument ``name`` in a call."""
    names = [a.name for a in func._schema.arguments]
    if name not in names:
        return default
    i = names.index(name)
    return args[i] if i < len(args) else kwargs.get(name, default)


def _seq():
    return torch._C._autograd._get_sequence_nr()


class TapeRecorder(TorchDispatchMode):
    """Record the ops run inside ``with TapeRecorder(args) as rec`` into
    ``rec.tape`` (see the module docstring). ``declared`` are the
    specimen's arguments: every tensor reachable from them is an
    argument, not a closed-over constant. The forward is recorded on the
    thread that enters; the autograd backward it starts on any thread."""

    @classmethod
    def _should_skip_dynamo(cls):
        return False

    def __init__(self, declared=()):
        super().__init__()
        self.tape = Tape()
        self._declared = {_key(t) for t in reachable_tensors(declared)}
        self._declared.discard(None)
        self._optimizers = [o for o in _reachable(declared)
                            if isinstance(o, torch.optim.Optimizer)]
        self._live = {}       # storage key -> buffer id
        self._next = 0
        self._thread = None
        self._by_seq = {}     # autograd sequence nr -> (provenance, stage)
        self._lock = threading.Lock()
        self._hidden = set()  # threads whose ops go unrecorded
        self._prev = None

    def __enter__(self):
        from dgmc_tpu_torch.ops.kernels import dispatch
        self._thread = threading.get_ident()
        self._prev, dispatch.tape = dispatch.tape, self
        return super().__enter__()

    def __exit__(self, *exc):
        from dgmc_tpu_torch.ops.kernels import dispatch
        try:
            return super().__exit__(*exc)
        finally:
            dispatch.tape = self._prev

    @contextlib.contextmanager
    def hidden(self):
        """The ops this thread runs in the block go unrecorded (a
        collective's own copies and communication, marked as one op by
        :meth:`collective`)."""
        me = threading.get_ident()
        self._hidden.add(me)
        try:
            yield
        finally:
            self._hidden.discard(me)

    # -- buffers ------------------------------------------------------------

    def _buffer_of(self, t):
        """The buffer ``t`` reads (registered on first sight as an
        argument or a closed-over constant)."""
        k = _key(t)
        if k is None:
            return None
        bid = self._live.get(k)
        if bid is not None and \
                self.tape.buffers[bid].nbytes != t.untyped_storage().nbytes():
            bid = None      # a storage made out of sight at a freed address
        if bid is None:
            bid = self._new_buffer(k, t, 'argument' if k in self._declared
                                   else 'closure', -1, 'other')
        return bid

    def _new_buffer(self, k, t, origin, index, stage):
        bid = self._next
        self._next += 1
        self._live[k] = bid
        self.tape.buffers[bid] = Buffer(
            nbytes=t.untyped_storage().nbytes(), origin=origin, index=index,
            shape=tuple(t.shape), dtype=str(t.dtype).replace('torch.', ''),
            stage=stage)
        return bid

    # -- provenance ---------------------------------------------------------

    def _where(self, skip=()):
        """``(provenance, stage, backward, site)`` of the op running
        now (``site``: :func:`_site`); the files in ``skip`` are no
        provenance."""
        node = torch._C._current_autograd_node()
        if node is not None:
            # A backward op: the forward op that made its node ran with
            # the sequence number one past the node's. Its line, unless
            # the op runs in the port's own backward code (a custom
            # autograd.Function's), which names it better.
            got = self._by_seq.get(node._sequence_nr() + 1,
                                   ('<unknown>', 'other', 0))
            return (_user_frame(3, backward=True, skip=skip) or got[0],
                    got[1], True, got[2])
        prov = _user_frame(3, skip=skip)
        stage = (stages_mod.current()
                 if threading.get_ident() == self._thread else 'other')
        site = _site(3)
        self._by_seq.setdefault(_seq(), (prov, stage, site))
        return prov, stage, False, site

    # -- recording ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == 'profiler' or \
                threading.get_ident() in self._hidden:
            return out
        with self._lock:
            self._record(func, name, args, kwargs, out)
        return out

    def _record(self, func, name, args, kwargs, out):
        index = len(self.tape.ops)
        prov, stage, backward, site = self._where()
        ins = _tensors((args, kwargs))
        schema_args = func._schema.arguments
        written = set()
        for i, a in enumerate(schema_args):
            info = a.alias_info
            if info is not None and info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors(v):
                    written.add(id(t))
        reads, writes = [], []
        in_keys = {}
        if name in ('lift_fresh', 'lift_fresh_copy'):
            # ``torch.tensor``'s data, made out of the dispatcher's sight:
            # a new constant, whatever freed storage its address reuses.
            for t in ins:
                if _key(t) is not None:
                    self._new_buffer(_key(t), t, 'closure', -1, 'other')
        for t in ins:
            bid = self._buffer_of(t)
            if bid is None:
                continue
            in_keys[_key(t)] = bid
            (writes if id(t) in written else reads).append(bid)
        allocs = []
        outs = _tensors(out)
        for t in outs:
            k = _key(t)
            if k is None or k in in_keys:
                continue        # a view or an in-place result
            bid = self._new_buffer(k, t, 'op', index, stage)
            allocs.append((bid, self.tape.buffers[bid].nbytes))
        from dgmc_tpu_torch.ops.kernels import dispatch
        op = TapeOp(
            index=index, name=str(func), provenance=prov, stage=stage,
            backward=backward,
            in_dtypes=tuple(t.dtype for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_dtypes=tuple(t.dtype for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            reads=tuple(reads), writes=tuple(writes), allocs=tuple(allocs),
            out_bytes=sum(t.numel() * t.element_size() for t in outs),
            free=bool(func.is_view) or name in _ALLOCS,
            in_kernel=bool(getattr(dispatch.counter, 'suppress', 0)),
            site=site)
        if name in _SORTS and ins:
            x = ins[0]
            op.sort_size = (int(x.shape[_arg(func, args, kwargs, 'dim', -1)])
                            if x.dim() else 1)
        op.host_read = self._host_read(func, name, args, kwargs, ins, out)
        op.host_to_device = bool(
            name in ('_to_copy', 'copy_', '_copy_from') and outs
            and outs[0].is_cuda and any(t.device.type == 'cpu'
                                        for t in ins))
        if name == '_local_scalar_dense' and self._host_step(ins[0]):
            op.host_read = None
        floating = any(d.is_floating_point or d.is_complex
                       for d in op.out_dtypes)
        if floating and (name in _ATOMIC or (
                name in _ACCUMULATING_PUTS
                and _arg(func, args, kwargs, 'accumulate', False))):
            op.atomic = True
        self.tape.ops.append(op)

    @staticmethod
    def _host_read(func, name, args, kwargs, ins, out):
        if name in _HOST_READS:
            return name
        if name in ('index', 'index_put', 'index_put_', '_index_put_impl_'):
            idx = args[1] if len(args) > 1 else kwargs.get('indices')
            if any(t is not None and t.dtype == torch.bool
                   for t in (idx or ())):
                return f'{name} with a boolean mask'
        if name in ('_to_copy', 'copy_', 'copy', '_copy_from'):
            outs = _tensors(out)
            if any(t.is_cuda for t in ins) and outs and \
                    outs[0].device.type == 'cpu':
                return 'a copy from the card to the host'
        if name == 'repeat_interleave' and \
                kwargs.get('output_size') is None and \
                func._overloadname in ('Tensor', 'self_Tensor'):
            return 'repeat_interleave without output_size'
        return None

    def _host_step(self, t):
        """``t`` is a host step count of a non-capturable optimizer."""
        if t.is_cuda:
            return False
        for opt in self._optimizers:
            for g in opt.param_groups:
                if g.get('capturable'):
                    continue
                for p in g['params']:
                    if opt.state.get(p, {}).get('step') is t:
                        return True
        return False

    def _results(self, index, outs, stage, skip=()):
        """``(writes, allocs)`` of the tensors ``outs`` an op at
        ``index`` left: the buffers already live, and the new ones."""
        writes, allocs = [], []
        for t in outs:
            k = _key(t)
            if k is None or k in skip:
                continue
            bid = self._live.get(k)
            if bid is None:
                bid = self._new_buffer(k, t, 'op', index, stage)
                allocs.append((bid, self.tape.buffers[bid].nbytes))
            elif bid not in writes:
                writes.append(bid)
        return writes, allocs

    def mark(self, name, args, kw, out=None):
        """A kernel entry ``name`` ran on the tensors in ``args`` /
        ``kw`` (its reads, out of the dispatcher's sight) and returned
        ``out`` (its results: written, or made, by the entry)."""
        with self._lock:
            index = len(self.tape.ops)
            stage = stages_mod.current()
            reads = [b for b in map(self._buffer_of, _tensors((args, kw)))
                     if b is not None]
            outs = _tensors(out)
            writes, allocs = self._results(index, outs, stage)
            self.tape.ops.append(TapeOp(
                index=index, name=name, kind='kernel', reads=tuple(reads),
                writes=tuple(writes), allocs=tuple(allocs),
                out_bytes=sum(t.numel() * t.element_size() for t in outs),
                provenance=_user_frame(2), stage=stage, site=_site(2)))

    def collective(self, kind, group, tensor, out, payload, inplace,
                   asynchronous=False):
        """One collective of :mod:`~dgmc_tpu_torch.parallel.comm`: its
        ``kind`` (JAX's spelling), the ``group``'s ranks, the caller's
        ``tensor`` (read, and written where ``inplace``; a tuple of
        tensors moved by one call) and ``out`` (new tensors otherwise),
        its ``payload`` bytes. ``asynchronous``: a start, joined later by
        :meth:`wait`. Returns the op's index."""
        ins = tensor if isinstance(tensor, tuple) else (tensor,)
        outs = out if isinstance(out, tuple) else (out,)
        with self._lock:
            index = len(self.tape.ops)
            prov, stage, backward, site = self._where(skip=_COMM_FILES)
            reads = tuple(b for b in map(self._buffer_of, ins)
                          if b is not None)
            writes, allocs = list(reads), []
            if not inplace:
                # A new tensor, made out of the dispatcher's sight: its
                # storage may reuse a freed one's address.
                writes = []
                for t in _tensors(outs):
                    k = _key(t)
                    if k is not None:
                        bid = self._new_buffer(k, t, 'op', index, stage)
                        allocs.append((bid, self.tape.buffers[bid].nbytes))
            self.tape.ops.append(TapeOp(
                index=index, name=kind, kind='collective', provenance=prov,
                stage=stage, backward=backward, site=site,
                in_dtypes=tuple(t.dtype for t in ins),
                out_dtypes=tuple(t.dtype for t in outs),
                out_shapes=tuple(tuple(t.shape) for t in outs),
                reads=reads, writes=tuple(writes), allocs=tuple(allocs),
                out_bytes=int(payload),
                collective={'kind': kind, 'group': tuple(group),
                            'dtype': str(ins[0].dtype).replace('torch.',
                                                               ''),
                            'shape': tuple(ins[0].shape),
                            'payload': int(payload),
                            'async': bool(asynchronous)}))
            return index

    def wait(self, start, out):
        """The end of the asynchronous collective at op ``start``: a
        ``'wait'`` op that writes its results ``out`` (a tensor or a
        tuple), so that their readers follow it."""
        outs = out if isinstance(out, tuple) else (out,)
        with self._lock:
            index = len(self.tape.ops)
            prov, stage, backward, site = self._where(skip=_COMM_FILES)
            writes = tuple(b for b in map(self._buffer_of, outs)
                           if b is not None)
            self.tape.ops.append(TapeOp(
                index=index, name='wait', kind='wait', provenance=prov,
                stage=stage, backward=backward, site=site, writes=writes,
                free=True, collective={'start': int(start)}))
            return index

    def finish(self, *alive):
        """Mark the buffers of every tensor reachable from ``alive`` (the
        run's outputs, the state it updated) as referenced at the end."""
        for t in reachable_tensors(*alive):
            k = _key(t)
            if k is not None and k in self._live:
                self.tape.outputs.add(self._live[k])
        return self.tape


# ---------------------------------------------------------------------------
# Rules over a tape
# ---------------------------------------------------------------------------


def _prov_context(prov, fallback):
    """The provenance line's stripped text, else ``fallback`` (the
    fingerprint's line-independent context, as JAX's)."""
    path, sep, line = prov.rpartition(':')
    if sep:
        try:
            text = read_source_line(path, int(line))
        except ValueError:
            text = None
        if text is None and os.path.isabs(path):
            import linecache
            text = linecache.getline(path, int(line)).strip() or None
        if text:
            return text
    return fallback


def _short(name):
    """``aten.scatter_add.default`` -> ``scatter_add``."""
    parts = name.split('.')
    return parts[1] if len(parts) >= 2 else name


def check_dtype_promotion(tape, ctx):
    sites = {}
    for op in tape.ops:
        if op.kind != 'op':
            continue
        wide = sorted({str(d).replace('torch.', '') for d in op.out_dtypes
                       if d in _WIDE})
        if not wide or any(d in _WIDE for d in op.in_dtypes):
            continue
        key = (_short(op.name), op.provenance, tuple(wide))
        n, shapes = sites.get(key, (0, set()))
        shapes.update(op.out_shapes)
        sites[key] = (n + 1, shapes)
    return [
        Finding(
            rule='TRC001', severity=Severity.ERROR,
            where=f'{ctx.specimen}:{prov}',
            message=(f'64-bit value introduced by `{name}` '
                     f'({", ".join(dtypes)}) in a <=32-bit pipeline'),
            detail=f'{n} op(s) at this site; out shapes {sorted(shapes)}',
            context=_prov_context(prov, f'{name} {" ".join(dtypes)}'))
        for (name, prov, dtypes), (n, shapes) in sorted(sites.items())]


def check_giant_constants(tape, ctx):
    out = []
    per_shape = collections.Counter()
    readers = collections.defaultdict(list)
    for op in tape.ops:
        for b in op.reads + op.writes:
            readers[b].append(op)
    for bid, buf in sorted(tape.buffers.items()):
        if buf.origin != 'closure' or buf.nbytes < ctx.const_bytes:
            continue
        key = (buf.shape, buf.dtype)
        idx = per_shape[key]
        per_shape[key] += 1
        first = readers[bid][0] if readers[bid] else None
        out.append(Finding(
            rule='TRC002', severity=Severity.WARNING,
            where=f'{ctx.specimen}:const{list(buf.shape)}#{idx}',
            message=(f'giant constant (shape {buf.shape}, dtype '
                     f'{buf.dtype}) read by the program'),
            detail=(f'{buf.nbytes / (1 << 20):.1f} MiB, first read by '
                    f'`{_short(first.name) if first else "?"}` at '
                    f'{first.provenance if first else "?"}; pass it as an '
                    f'argument instead of closing over it')))
    return out


def check_host_reads(tape, ctx):
    if not ctx.expect_no_callbacks:
        return []
    sites = collections.Counter()
    for op in tape.ops:
        if op.host_read:
            sites[(op.host_read, op.provenance)] += 1
    return [
        Finding(
            rule='TRC003', severity=Severity.ERROR,
            where=f'{ctx.specimen}:{prov}',
            message=(f'host read `{what}` in a program expected free of '
                     f'them (probes off): it synchronizes the host with '
                     f'the card every step and cannot be captured'),
            detail=f'{n} op(s) at this site',
            context=_prov_context(prov, what))
        for (what, prov), n in sorted(sites.items())]


def check_accumulations_and_sorts(tape, ctx):
    atomics, sorts = {}, {}
    for op in tape.ops:
        if op.atomic:
            key = (_short(op.name), op.provenance)
            n, shapes = atomics.get(key, (0, set()))
            shapes.update(op.out_shapes[:1])
            atomics[key] = (n + 1, shapes)
        if op.sort_size is not None and op.sort_size >= ctx.sort_dim:
            key = (_short(op.name), op.provenance)
            n, dims = sorts.get(key, (0, set()))
            dims.add(op.sort_size)
            sorts[key] = (n + 1, dims)
    out = []
    for (name, prov), (n, shapes) in sorted(atomics.items()):
        out.append(Finding(
            rule='TRC005', severity=Severity.INFO,
            where=f'{ctx.specimen}:{prov}',
            message=(f'`{name}` accumulates floats through atomics on the '
                     f'card: not bit-identical from run to run'),
            detail=(f'{n} op(s) at this site, out shapes {sorted(shapes)}; '
                    f'a gather\'s or an index\'s backward — prefer the '
                    f'sorted or blocked sums on hot paths'),
            context=_prov_context(prov, name)))
    for (name, prov), (n, dims) in sorted(sorts.items()):
        out.append(Finding(
            rule='TRC006', severity=Severity.WARNING,
            where=f'{ctx.specimen}:{prov}',
            message=(f'sort over axis of >= {ctx.sort_dim} elements — '
                     f'prefer the top-k kernel or the streaming blockwise '
                     f'top-k'),
            detail=f'{n} op(s) at this site, axis sizes {sorted(dims)}',
            context=_prov_context(prov, name)))
    return out


def analyze_tape(tape, ctx: Optional[TraceContext] = None) -> List[Finding]:
    """All tape-level rules (TRC001-003, 005, 006) over one recorded run
    (JAX's ``analyze_closed_jaxpr``)."""
    ctx = ctx or TraceContext()
    out = []
    out += check_dtype_promotion(tape, ctx)
    out += check_giant_constants(tape, ctx)
    out += check_host_reads(tape, ctx)
    out += check_accumulations_and_sorts(tape, ctx)
    return disambiguate_contexts(out)


# ---------------------------------------------------------------------------
# The in-place state (TRC004)
# ---------------------------------------------------------------------------


def state_tensors(model=None, state=None):
    """``{name: tensor}`` of what a train step updates in place: the
    model's parameters and buffers, Adam's tensors per parameter, a
    guarded state's counters."""
    out = {}
    if model is not None:
        for k, v in model.named_parameters():
            out[f'param:{k}'] = v
        for k, v in model.named_buffers():
            out[f'buffer:{k}'] = v
    if state is not None:
        opt = state.optimizer
        names = {}
        if model is not None:
            names = {id(p): k for k, p in model.named_parameters()}
        i = 0
        for g in opt.param_groups:
            for p in g['params']:
                pname = names.get(id(p), str(i))
                out.setdefault(f'param:{pname}', p)
                for k, v in opt.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        out[f'adam:{pname}.{k}'] = v
                i += 1
        for k in ('skip_count', 'consec_bad'):
            v = getattr(state, k, None)
            if torch.is_tensor(v):
                out[f'guard:{k}'] = v
    return out


def identities(tensors):
    """``{name: (tensor, storage key)}`` of :func:`state_tensors`' map,
    taken now (a ``.data`` swap keeps the object, not the storage)."""
    return {k: (v, _key(v)) for k, v in tensors.items()}


def inplace_findings(before, after, specimen, argnums=(0,),
                     ran='the step'):
    """TRC004 from the declared state's :func:`identities` before one
    step and its tensors (:func:`state_tensors`) after: one finding per
    tensor rebound or written into another storage. A tensor made by
    the step (Adam's moments at its first update) is no finding."""
    b, a = before, identities(after)
    out = []
    for name in sorted(b):
        if name not in a:
            continue
        (t0, k0), (t1, k1) = b[name], a[name]
        if t1 is t0 and k1 == k0:
            continue
        what = ('rebound to another tensor' if t1 is not t0
                else 'moved to another storage')
        out.append(Finding(
            rule='TRC004', severity=Severity.ERROR,
            where=f'{specimen}:inplace{tuple(argnums)}:{name}',
            message=(f'state the step declares in place was {what} — a '
                     f'captured replay keeps writing the old storage'),
            detail=f'after {ran}'))
    return out
