"""Cost and efficiency account: FLOPs and bytes per pipeline stage, MFU.

The port of the JAX package's ``dgmc_tpu/obs/cost.py``. JAX reads its
program's cost from XLA (``cost_analysis()`` and the lowered module's
scope paths); a CUDA graph carries no such count, so the port counts the
work itself, on one eager forward and backward of the step:

- **The count** (:class:`WorkCounter`, a ``TorchDispatchMode``): every
  aten op adds one op and its result bytes to its stage's
  ``bytes_out``; the matmul-class ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``; ``linear``, ``matmul`` and
  ``einsum`` as they decompose) add one ``dot_ops`` and ``2·M·N·K``
  FLOPs, as JAX's ``_dot_flops`` counts a ``dot_general``. A kernel
  entry (:func:`~dgmc_tpu_torch.ops.kernels.dispatch.counted`: each
  CUDA kernel's wrapper, its plain version and the differentiable
  function around it) adds its work by its contract
  (``topk_work``, ``consensus_work``, ``route_work``, ``sc_work``,
  ``blocked_work``, ``draw_work`` in ``ops/kernels/``) in place of the
  aten ops inside it, so the CUDA kernel and its plain version count
  the same work.
- **Stages** (:mod:`~dgmc_tpu_torch.obs.stages`): a forward op goes to
  the innermost stage range it runs under. A backward op goes to the
  stage of the forward op that made its autograd node, as JAX's
  transposes do: the counter logs each change of stage with the autograd
  sequence number in force (``torch._C._autograd._get_sequence_nr``)
  and reads the running node's number in the backward
  (``torch._C._current_autograd_node()._sequence_nr()``). The nodes a
  differentiable kernel entry makes form a region whose backward adds
  the entry's backward work once, in place of what runs inside.
- **The optimizer** is counted from the parameters that took a gradient,
  as Adam's elementwise work (:data:`ADAM_FLOPS` a value, the parameter
  and both moments read and written, the gradient read): the count runs
  no update.

``flops`` is the sum of the stages' FLOPs: the products (and the
kernels' formulas, whose elementwise terms are part of their contract)
and Adam's update. XLA's ``flops`` total also counts every elementwise
op, so the port's total is lower than JAX's for the same program; the
stages' FLOPs compare one for one. ``bytes`` sums each aten op's input
and output bytes (views move none) and each kernel's contract bytes: an
upper account of the traffic, where XLA's ``bytes accessed`` is its
fused program's.

The count must not touch the run: a train step's
``cost_pass`` (``train/steps.py``) runs the forward, the loss and
``torch.autograd.grad`` with the batch-norm buffers, the random streams,
the probe tape and the launch counters set back after it, and never
replays or captures a graph. The draws are Philox streams keyed by seed
and step, so the pass consumes nothing.

The specimen CLI (``python -m dgmc_tpu_torch.obs.cost [--specimens A,B]
[--obs-dir DIR] [--json] [--device cpu]``, JAX's): one row a registered
specimen of the trace tier (:mod:`~dgmc_tpu_torch.analysis.registry`,
sharing its one recorded run per process), named ``specimen.<name>``,
with this count's FLOPs, bytes and stages, the static peak-live bytes
of the same run (``static_peak_bytes``,
:mod:`~dgmc_tpu_torch.analysis.liveness`, with ``peak_stage_bytes``), the
kernels it launched (``launches``, from the dispatch ledger) and, on the
card, the allocator's measured peak above what the arguments held
(``measured_peak_bytes``). ``--obs-dir`` merges the rows into that run's
``efficiency.json`` (run rows kept verbatim; a rerun replaces the
specimen rows), which ``obs/diff.py --max-peak-regression`` reads. The
mesh specimens' rows come from rank 0's run on the ranks the CLI starts
(:mod:`~dgmc_tpu_torch.analysis.ranks`).

**The collective account** (JAX's ``_schedule_fields``,
:func:`schedule_fields`): where the program runs on several ranks (a
mesh specimen, or a program counted in a world of more than one rank),
the counted run is also recorded on the trace tier's tape
(:class:`~dgmc_tpu_torch.analysis.trace_rules.TapeRecorder`, on which
each collective of :mod:`~dgmc_tpu_torch.parallel.comm` marks itself),
and the program's row carries ``collectives`` (JAX's table,
:mod:`~dgmc_tpu_torch.analysis.comm`), ``overlap_fraction`` (omitted
when nothing moved) and ``critical_path_share`` (the schedule model,
:mod:`~dgmc_tpu_torch.analysis.schedule`) and ``static_peak_bytes``,
all from that one run; a model's failure leaves ``schedule_error`` /
``liveness_error`` in their place. ``obs/diff.py --min-overlap`` reads
``overlap_fraction``. On one process the run account carries none of
them, as JAX's lowered one-device account carries none.
"""

import argparse
import bisect
import json
import os
import sys
import threading

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

from dgmc_tpu_torch.obs import stages as stages_mod
from dgmc_tpu_torch.obs.stages import STAGE_NAMES, stage_of
from dgmc_tpu_torch.ops.kernels import dispatch

__all__ = ['PEAK_FLOPS', 'CPU_PEAK_FLOPS', 'STAGE_NAMES', 'ADAM_FLOPS',
           'peak_flops_entry', 'stage_of', 'WorkCounter', 'cost_summary',
           'schedule_fields', 'efficiency_payload', 'headline_of',
           'render_costs', 'specimen_costs', 'main']

#: Dense bf16 tensor-core peak per card, by
#: ``torch.cuda.get_device_name()``: NVIDIA's H100 datasheet (SXM5:
#: 989.4 TFLOP/s without sparsity, written as the 989 that ``PERF.md``
#: and ``chip_smoke.py`` use; PCIe: 756). MFU = flops / (step time x
#: peak) against the bf16 peak whatever the run's dtype, as the JAX
#: package's table is its chips' bf16 peaks: a float32 run's MFU is
#: against the same peak.
PEAK_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,
    'NVIDIA H100 PCIe': 756e12,
}

#: CPU fallback peak: one core x ~3 GHz x 16 f32 FLOP/cycle (AVX2 FMA),
#: the JAX package's nominal anchor, so CPU runs report a small but
#: comparable MFU.
CPU_PEAK_FLOPS = 48e9

#: Adam's elementwise FLOPs a parameter value: the first moment 3, the
#: second 4, the update 5 (square root, epsilon, division, step size,
#: subtraction).
ADAM_FLOPS = 12


def headline_of(payload, key):
    """The efficiency payload's headline value for one per-program
    ``key`` (``arith_intensity``, ``flops``, ...): the ``train_step``
    program's when present, else the first program carrying one (JAX's
    convention, shared by the report and the attribution)."""
    programs = (payload or {}).get('programs') or {}
    ts = programs.get('train_step') or {}
    if ts.get(key) is not None:
        return ts[key]
    for p in programs.values():
        if p.get(key) is not None:
            return p[key]
    return None


def _device_fields(device=None):
    """``(device_kind, platform)``: the card's name and ``'gpu'``, or
    ``('cpu', 'cpu')``. ``device`` defaults to the first card if there
    is one."""
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device), 'gpu'
    return 'cpu', 'cpu'


def peak_flops_entry(device=None):
    """``{'peak_flops', 'ref', 'source'}`` for ``device`` (default: the
    first card, else the CPU): ``'table'`` for a known card,
    ``'cpu-fallback'`` for the nominal CPU entry, ``'unknown'`` (with
    ``peak_flops: None``) for a card missing from the table, whose MFU is
    left out rather than made up."""
    kind, platform = _device_fields(device)
    peak = PEAK_FLOPS.get(kind)
    if peak:
        return {'peak_flops': peak, 'ref': f'{kind} bf16', 'source': 'table'}
    if platform == 'cpu':
        return {'peak_flops': CPU_PEAK_FLOPS,
                'ref': 'cpu nominal (1 core x 3 GHz x 16 f32 FLOP/cycle)',
                'source': 'cpu-fallback'}
    return {'peak_flops': None, 'ref': kind, 'source': 'unknown'}


# ---------------------------------------------------------------------------
# The count
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _mm(a, b):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


#: Matmul-class aten ops → their FLOPs from the arguments.
_PRODUCTS = {
    _aten.mm: lambda a: _mm(a[0], a[1]),
    _aten.addmm: lambda a: _mm(a[1], a[2]),
    _aten.bmm: lambda a: _bmm(a[0], a[1]),
    _aten.baddbmm: lambda a: _bmm(a[1], a[2]),
    _aten.mv: lambda a: 2 * a[0].shape[0] * a[0].shape[1],
    _aten.addmv: lambda a: 2 * a[1].shape[0] * a[1].shape[1],
    _aten.dot: lambda a: 2 * a[0].shape[0],
}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _seq():
    return torch._C._autograd._get_sequence_nr()


class WorkCounter(TorchDispatchMode):
    """Count the work of the ops run inside ``with WorkCounter() as c``
    per stage (see the module docstring); :meth:`summary` gives the
    account. One counter at a time; the count is of the thread that
    enters it and of the autograd backward it starts. ``on_kernel(name,
    args, kw, out)``, if given, is told of each kernel entry's call after it
    returns (the trace tier's tape marks the launch there: it shares
    the counter's slot in the dispatch ledger)."""

    @classmethod
    def _should_skip_dynamo(cls):
        # Nothing here is compiled: without this, TorchDispatchMode wraps
        # __torch_dispatch__ in torch._disable_dynamo, whose first call
        # imports torch._dynamo (seconds in a fresh serving worker).
        return False

    def __init__(self, on_kernel=None):
        super().__init__()
        self.on_kernel = on_kernel
        self.rows = {}
        self.kernels = {}
        self.bytes = 0.0
        self.suppress = 0
        self._thread = None
        self._seqs, self._stages = [], []
        self._regions = []   # [s0, s1, stage, bwd work, counted]
        self._listening = None

    # -- entering -----------------------------------------------------------

    def __enter__(self):
        if dispatch.counter is not None:
            raise RuntimeError('a work counter is already active')
        self._thread = threading.get_ident()
        self._on_stage(stages_mod.current())
        self._listening = stages_mod.listen(self._on_stage)
        self._listening.__enter__()
        dispatch.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            dispatch.counter = None
            self._listening.__exit__(None, None, None)

    def _on_stage(self, stage):
        if threading.get_ident() == self._thread:
            self._seqs.append(_seq())
            self._stages.append(stage)

    # -- stages -------------------------------------------------------------

    def _stage_of_seq(self, seq):
        i = bisect.bisect_right(self._seqs, seq) - 1
        return self._stages[i] if i >= 0 else 'other'

    def _node(self):
        """The autograd node running on this thread (backward), or
        None."""
        return torch._C._current_autograd_node()

    def _region_of(self, node):
        """The differentiable kernel region ``node`` belongs to, its
        backward work counted once on first sight; None outside every
        region."""
        seq = node._sequence_nr()
        for region in self._regions:
            if region[0] <= seq < region[1]:
                if not region[4]:
                    region[4] = True
                    self._add(region[2], region[3])
                return region
        return None

    def _row(self, stage):
        return self.rows.setdefault(stage, {'ops': 0, 'dot_ops': 0,
                                            'flops': 0, 'bytes_out': 0})

    # -- adding -------------------------------------------------------------

    def _add(self, stage, work):
        """Add one kernel entry's ``work`` to ``stage``."""
        row = self._row(stage)
        row['ops'] += 1
        row['dot_ops'] += int(bool(work.get('dot')))
        row['flops'] += int(round(work['flops']))
        row['bytes_out'] += int(round(work.get('out_bytes', 0)))
        self.bytes += work['bytes']
        k = self.kernels.setdefault(work['kernel'],
                                    {'calls': 0, 'flops': 0, 'bytes': 0})
        k['calls'] += 1
        k['flops'] += int(round(work['flops']))
        k['bytes'] += int(round(work['bytes']))

    def kernel(self, work_fn, fn, args, kw):
        """One call of a counted kernel entry (see
        :func:`~dgmc_tpu_torch.ops.kernels.dispatch.counted`)."""
        out = self._kernel(work_fn, fn, args, kw)
        if self.on_kernel is not None:
            self.on_kernel(getattr(fn, '__name__', 'kernel'), args, kw, out)
        return out

    def _kernel(self, work_fn, fn, args, kw):
        if self.suppress:
            return fn(*args, **kw)
        node = self._node()
        if node is not None:
            if self._region_of(node) is not None:
                return fn(*args, **kw)
            stage = self._stage_of_seq(node._sequence_nr())
        elif threading.get_ident() == self._thread:
            stage = stages_mod.current()
        else:
            return fn(*args, **kw)   # another thread's forward
        self.suppress += 1
        try:
            # The account's own reads (a work function may read the
            # device) run outside every dispatch mode: they are no part
            # of the program.
            with _disable_current_modes():
                work = work_fn(*args, **kw)
            s0 = _seq()
            out = fn(*args, **kw)
            s1 = _seq()
        finally:
            self.suppress -= 1
        self._add(stage, work)
        if work.get('bwd') and s1 > s0:
            self._regions.append([s0, s1, stage, work['bwd'], False])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.suppress:
            return out
        node = self._node()
        if node is not None:
            if self._region_of(node) is not None:
                return out
            stage = self._stage_of_seq(node._sequence_nr())
        elif threading.get_ident() == self._thread:
            stage = stages_mod.current()
        else:
            stage = 'other'
        row = self._row(stage)
        row['ops'] += 1
        out_bytes = _nbytes(out)
        row['bytes_out'] += out_bytes
        if not func.is_view:
            self.bytes += out_bytes + _nbytes((args, kwargs))
        flops = _PRODUCTS.get(func.overloadpacket)
        if flops is not None:
            row['dot_ops'] += 1
            row['flops'] += int(flops(args))
        return out

    def add_optimizer(self, params):
        """Adam's update of ``params`` as the ``optimizer`` stage."""
        n = sum(p.numel() for p in params)
        elem = 4.0
        row = self._row('optimizer')
        row['ops'] += len(params)
        row['flops'] += ADAM_FLOPS * n
        row['bytes_out'] += int(3 * elem * n)
        self.bytes += 7 * elem * n

    def summary(self):
        """``{'flops', 'bytes', 'arith_intensity', 'stages', 'kernels',
        'source': 'counted'}``: stages in pipeline order."""
        order = {s: i for i, s in enumerate((*STAGE_NAMES, 'other'))}
        stages = {s: dict(r) for s, r in sorted(
            self.rows.items(), key=lambda kv: order.get(kv[0], 99))}
        flops = sum(r['flops'] for r in stages.values())
        out = {'flops': flops, 'bytes': int(round(self.bytes)),
               'stages': stages,
               'kernels': {k: dict(v) for k, v in sorted(
                   self.kernels.items())},
               'source': 'counted'}
        if flops and out['bytes']:
            out['arith_intensity'] = round(flops / out['bytes'], 3)
        return out


def schedule_fields(tape):
    """The collective account of one recorded run (JAX's
    ``_schedule_fields``): ``collectives``, ``overlap_fraction`` (omitted
    when the run moved nothing between ranks), ``critical_path_share``
    and ``static_peak_bytes``; a model that fails leaves
    ``schedule_error`` / ``liveness_error`` instead, so a vanished field
    has its cause beside it."""
    out = {}
    try:
        from dgmc_tpu_torch.analysis.comm import collective_table
        from dgmc_tpu_torch.analysis.schedule import schedule_summary
        out['collectives'] = collective_table(tape)
        sched = schedule_summary(tape)
        if sched.get('overlap_fraction') is not None:
            out['overlap_fraction'] = sched['overlap_fraction']
        out['critical_path_share'] = sched['critical_path_share']
    except Exception as e:
        out['schedule_error'] = f'{type(e).__name__}: {e}'
    try:
        from dgmc_tpu_torch.analysis.liveness import peak_summary
        peak = peak_summary(tape)
        if peak.get('static_peak_bytes'):
            out['static_peak_bytes'] = peak['static_peak_bytes']
    except Exception as e:
        out['liveness_error'] = f'{type(e).__name__}: {e}'
    return out


def _several_ranks():
    from dgmc_tpu_torch.parallel.distributed import process_count
    return process_count() > 1


def cost_summary(target, *args, step_time_s=None):
    """Cost account of one program: ``target`` a train step (one with a
    ``cost_pass``, whose forward, loss and backward are counted and whose
    optimizer is counted from the parameters that took a gradient) or any
    callable, run once on ``*args`` under the counter without a gradient.

    Returns ``{'flops', 'bytes', 'arith_intensity', 'stages', 'kernels',
    'source', ['step_time_s']}`` and, in a world of several ranks, the
    run's collective account (:func:`schedule_fields`).
    """
    import contextlib
    counter = WorkCounter()
    recorder = None
    if _several_ranks():
        from dgmc_tpu_torch.analysis.trace_rules import TapeRecorder
        recorder = TapeRecorder(declared=args)
    params = None
    with counter, (recorder or contextlib.nullcontext()):
        if hasattr(target, 'cost_pass'):
            params = target.cost_pass(*args)
        else:
            with torch.no_grad():
                target(*args)
    if params is not None:
        counter.add_optimizer(params)
    out = counter.summary()
    if recorder is not None:
        out.update(schedule_fields(recorder.finish(params, args)))
    if step_time_s:
        out['step_time_s'] = step_time_s
    return out


def efficiency_payload(programs, fallback_step_time_s=None, device=None):
    """The ``efficiency.json`` artifact from named :func:`cost_summary`
    results (JAX's keys). MFU is computed per program from its own
    ``step_time_s`` when the caller measured one, else from
    ``fallback_step_time_s`` (the run's observed step p50, marked
    ``step_time_source: 'observed_p50'``), to 4 significant digits; the
    headline ``mfu`` is the ``train_step`` program's when present, else
    the first program with one."""
    peak = peak_flops_entry(device)
    kind, platform = _device_fields(device)
    out = {
        'device_kind': kind,
        'platform': platform,
        'peak_flops': peak['peak_flops'],
        'peak_flops_ref': peak['ref'],
        'peak_flops_source': peak['source'],
        'programs': {},
    }
    for name, summary in programs.items():
        entry = dict(summary)
        flops = entry.get('flops')
        step_s = entry.get('step_time_s')
        if step_s is None and fallback_step_time_s:
            step_s = fallback_step_time_s
            entry['step_time_s'] = round(step_s, 6)
            entry['step_time_source'] = 'observed_p50'
        if flops and step_s and peak['peak_flops']:
            entry['mfu'] = float(
                f'{flops / (step_s * peak["peak_flops"]):.4g}')
        out['programs'][name] = entry
    headline = None
    if 'train_step' in out['programs']:
        headline = out['programs']['train_step'].get('mfu')
    if headline is None:
        for entry in out['programs'].values():
            if entry.get('mfu') is not None:
                headline = entry['mfu']
                break
    if headline is not None:
        out['mfu'] = headline
    return out


def _fmt_num(v):
    from dgmc_tpu_torch.obs.observe import fmt_si
    return fmt_si(v)


def render_costs(payload):
    """The efficiency payload as text (JAX's layout)."""
    lines = ['== cost / efficiency ==',
             f'  device           {payload.get("device_kind")} '
             f'({payload.get("platform")})',
             f'  peak flops       {_fmt_num(payload.get("peak_flops"))} '
             f'[{payload.get("peak_flops_source")}: '
             f'{payload.get("peak_flops_ref")}]']
    if payload.get('mfu') is not None:
        lines.append(f'  MFU              {payload["mfu"]:.4%}')
    for name, p in payload.get('programs', {}).items():
        if 'error' in p:
            lines.append(f'  -- {name}: ERROR {p["error"]}')
            continue
        lines.append(f'  -- {name} --')
        lines.append(f'    flops / bytes / AI   '
                     f'{_fmt_num(p.get("flops"))} / '
                     f'{_fmt_num(p.get("bytes"))} / '
                     f'{p.get("arith_intensity", "-")}')
        if p.get('mfu') is not None:
            st = p.get('step_time_s')
            lines.append(f'    MFU                  {p["mfu"]:.4%} '
                         f'(step {st * 1e3:.3f} ms)' if st else
                         f'    MFU                  {p["mfu"]:.4%}')
        if p.get('static_peak_bytes') is not None:
            measured = p.get('measured_peak_bytes')
            lines.append(f'    static peak          '
                         f'{_fmt_num(p["static_peak_bytes"])}B'
                         + (f' (measured {_fmt_num(measured)}B above the '
                            f'arguments)' if measured is not None else ''))
        if p.get('launches'):
            lines.append(f'    launches             {p["launches"]}')
        if p.get('overlap_fraction') is not None:
            lines.append(f'    overlap / cp-share   '
                         f'{p["overlap_fraction"]:.4f} / '
                         f'{p.get("critical_path_share", 0):.4f}')
        coll = p.get('collectives') or {}
        if coll.get('count'):
            kinds = ', '.join(f'{k} x{v["count"]} ({v["bytes"]} B)'
                              for k, v in sorted(coll['ops'].items()))
            lines.append(f'    collectives          {kinds}')
        for stage, row in (p.get('stages') or {}).items():
            lines.append(f'    stage {stage:<15} '
                         f'flops {_fmt_num(row.get("flops")):>8}  '
                         f'bytes {_fmt_num(row.get("bytes_out")):>8}  '
                         f'ops {row.get("ops", 0)}')
    return '\n'.join(lines)


# ---------------------------------------------------------------------------
# Specimen mode (the trace tier's registry, one recorded run each)
# ---------------------------------------------------------------------------


def specimen_costs(names=None, on_progress=None, device=None, cache=None):
    """``{specimen_name: row}`` over the registered specimens
    (:func:`dgmc_tpu_torch.analysis.registry.default_specimens`), each
    from its one recorded run in ``cache`` (this process's shared cache
    on ``device``, default ``cuda``, starting ranks for the mesh
    specimens, when none is given): the work count, ``static_peak_bytes``
    and ``peak_stage_bytes``, ``argument_bytes`` (what was live before
    the run), the collective account (:func:`schedule_fields`),
    ``launches``, ``measured_peak_bytes`` (the card's allocator; None on
    the CPU) and ``run_s``; a mesh specimen's from rank 0's run. Probes
    are forced off (the registry's contract); a specimen that fails to
    build or run is an ``{'error': ...}`` row."""
    from dgmc_tpu_torch.analysis.liveness import peak_summary
    from dgmc_tpu_torch.analysis.registry import (iter_runnable_specimens,
                                                  shared_cache)
    cache = cache if cache is not None else shared_cache(device)
    out = {}
    for spec in iter_runnable_specimens(None, names=names,
                                        on_progress=on_progress):
        if on_progress:
            on_progress(f'run {spec.name} on {cache.where(spec)}')
        try:
            rec = cache.artifacts(spec).recorded()
            row = dict(rec['cost'])
            row.update(schedule_fields(rec['tape']))
            row.update(peak_summary(rec['tape']))
            row['argument_bytes'] = sum(
                b.nbytes for b in rec['tape'].buffers.values()
                if b.origin != 'op')
            row['launches'] = dict(sorted(rec['launches'].items()))
            row['measured_peak_bytes'] = rec['measured_peak_bytes']
            row['run_s'] = round(rec['seconds'], 6)
            out[spec.name] = row
        except Exception as e:
            out[spec.name] = {'error': f'{type(e).__name__}: {e}'}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.obs.cost',
        description='FLOPs, bytes, static peak and kernel launches over '
                    'the registered specimens; --obs-dir merges the rows '
                    "into that run's efficiency.json.")
    parser.add_argument('--specimens', default=None,
                        help='comma-separated specimen names '
                             '(default: all runnable)')
    parser.add_argument('--obs-dir', '--obs_dir', dest='obs_dir',
                        default=None,
                        help='obs run directory whose efficiency.json '
                             'receives the specimen rows (created if '
                             'absent; run rows are preserved)')
    parser.add_argument('--json', action='store_true',
                        help='print the machine-readable payload')
    parser.add_argument('--device', default='cuda',
                        help='where the specimens run (default cuda; cpu '
                             'runs the kernels\' plain versions)')
    args = parser.parse_args(argv)

    def progress(msg):
        if not args.json:
            print(f'[obs.cost] {msg}', file=sys.stderr)

    names = (set(n.strip() for n in args.specimens.split(',') if n.strip())
             if args.specimens else None)
    costs = specimen_costs(names=names, on_progress=progress,
                           device=args.device)
    if not costs:
        print('obs.cost: no runnable specimens matched', file=sys.stderr)
        return 2
    local = efficiency_payload({f'specimen.{k}': v
                                for k, v in costs.items()},
                               device=args.device)
    if args.obs_dir:
        from dgmc_tpu_torch.utils.io import write_json_atomic
        path = os.path.join(args.obs_dir, 'efficiency.json')
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = {}
        if existing:
            # The recording machine's account stays verbatim: only the
            # specimen rows (namespaced, so a rerun replaces them) are
            # this machine's facts.
            payload = dict(existing)
            programs = dict(existing.get('programs', {}))
            programs.update(local['programs'])
            payload['programs'] = programs
            if payload.get('device_kind') is None:
                for key in ('device_kind', 'platform', 'peak_flops',
                            'peak_flops_ref', 'peak_flops_source'):
                    payload[key] = local.get(key)
        else:
            payload = local
        write_json_atomic(path, payload, indent=1)
    else:
        payload = local
    if args.json:
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        print(render_costs(payload))
    return 0


if __name__ == '__main__':
    sys.exit(main())
