"""Hot-function registry: what the trace tier runs, at which shapes.

The port's counterpart of the JAX package's ``analysis/registry.py``.
Each :class:`Specimen` names one program the pipeline runs — the DGMC
forward (dense and sparse top-k), the train step and the eval step of
``train/steps.py``, and three ops underneath them — under JAX's names,
in JAX's order and at JAX's shapes: DGMC(RelCNN(4, 8, 1), RelCNN(4, 4,
1), num_steps=2, k) over a pair of 8 / 16 and 10 / 20 nodes / edges,
the top-k at [1, 16, 8] x [1, 24, 8] with k = 4, the softmax at
[1, 8, 10], the segment sum of [1, 16, 4] into 8 segments, each drawn
from JAX's seeds. JAX keeps them "deliberately tiny": every hazard the
rules look for is shape-independent. JAX's mesh specimens
(``min_devices`` 2 or 4: the sharded train steps, the row-sharded
forward, the streamed step, the sharded top-k) belong to multi-GPU work
and are not registered.

A specimen is built on a device (``cuda`` by default; no fallback
between the two): on the card its kernels launch, on the CPU their
plain versions run. Probes are forced off while it is built and run
(:func:`probes_forced_off`), as in JAX: TRC003 asserts the probes-off
contract.

Each specimen is built once and run once per process however many
consumers ask (:class:`SpecimenArtifacts`, shared through a
:class:`SpecimenCache`; JAX's compile-count contract): the one run is
recorded by the trace tier's tape
(:class:`~dgmc_tpu_torch.analysis.trace_rules.TapeRecorder`) and counted
by the cost account's
:class:`~dgmc_tpu_torch.obs.cost.WorkCounter` together, which read its
rules, its static peak (:mod:`~dgmc_tpu_torch.analysis.liveness`), its
FLOPs and its kernel launches. A train-step specimen declares the state
it updates in place (``'inplace'``: the model's parameters and buffers,
Adam's tensors, the counters), the counterpart of JAX's
``donate_argnums=(0,)``: TRC004 runs the step as the CLIs do (captured
on the card, ``jit=True``; on the CPU the same code run eagerly), once,
and compares that state before and after.
"""

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ['Specimen', 'probes_forced_off', 'default_specimens',
           'iter_runnable_specimens', 'SpecimenArtifacts', 'SpecimenCache',
           'shared_cache', 'run_specimen', 'run_trace_tier']


@dataclasses.dataclass
class Specimen:
    """One registered hot function + config.

    ``build(device)`` returns ``{'fn': callable, 'args': tuple}`` plus,
    for a train step, ``'inplace'`` (``() -> {name: tensor}``, the state
    it updates in place), ``'inplace_argnums'`` (the argument holding it)
    and ``'compiled'`` (the step as the CLIs run it, ``jit=True``), and
    ``'keep'`` (what the run leaves alive besides its output).
    """
    name: str
    build: Callable[..., Dict]
    #: 0 = always runnable; else the minimum device count.
    min_devices: int = 0
    #: Which lint tiers analyze this specimen (``'trace'`` only here).
    tiers: Tuple[str, ...] = ('trace',)


@contextlib.contextmanager
def probes_forced_off():
    """Probe call sites must not run in specimens."""
    from dgmc_tpu_torch.obs import probes
    prev = probes.enabled()
    probes.disable()
    try:
        yield
    finally:
        if prev:
            probes.enable()


# ---------------------------------------------------------------------------
# Tiny concrete fixtures (host-side numpy from JAX's seeds)
# ---------------------------------------------------------------------------


def _graph_side(rng, n, e, c=4):
    return {'x': rng.randn(1, n, c).astype(np.float32),
            'senders': rng.randint(0, n, (1, e)).astype(np.int32),
            'receivers': rng.randint(0, n, (1, e)).astype(np.int32),
            'node_mask': np.ones((1, n), bool),
            'edge_mask': np.ones((1, e), bool)}


def pair_batch(rng=None, n_s=8, e_s=16, n_t=10, e_t=20):
    """JAX's specimen pair (``_pair_batch``) as a host
    :class:`~dgmc_tpu_torch.utils.data.PairBatch`."""
    from dgmc_tpu_torch.utils.data import PairBatch
    rng = np.random.RandomState(0) if rng is None else rng
    return PairBatch(
        s=_graph_side(rng, n_s, e_s), t=_graph_side(rng, n_t, e_t),
        y=(np.arange(n_s, dtype=np.int32) % n_t)[None],
        y_mask=np.ones((1, n_s), bool))


def specimen_model(k, num_steps=2):
    """JAX's specimen model: DGMC(RelCNN(4, 8, 1), RelCNN(4, 4, 1),
    num_steps, k), initialized from seed 0."""
    import torch
    from dgmc_tpu_torch.models import DGMC, RelCNN
    return DGMC(RelCNN(4, 8, num_layers=1), RelCNN(4, 4, num_layers=1),
                num_steps=num_steps, k=k,
                generator=torch.Generator().manual_seed(0))


def _model_state_batch(k, device):
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import batch_to_device
    model = specimen_model(k).to(device)
    state = create_train_state(model, learning_rate=1e-3)
    return model, state, batch_to_device(pair_batch(), device)


def _forward_specimen(k):
    def build(device):
        import torch
        model, _, batch = _model_state_batch(k, device)
        model.eval()

        def forward(model, batch, noise_seed, r_s=None):
            with torch.no_grad():
                return model(batch.graph_s, batch.graph_t,
                             noise_seed=noise_seed, r_s=r_s)

        return {'fn': forward, 'args': (model, batch, 1)}
    return build


def _train_step_specimen(k):
    def build(device):
        from dgmc_tpu_torch.analysis.trace_rules import state_tensors
        from dgmc_tpu_torch.train.steps import make_train_step
        model, state, batch = _model_state_batch(k, device)
        return {'fn': make_train_step(model, jit=False),
                'args': (state, batch, 1),
                'inplace': lambda: state_tensors(model, state),
                'inplace_argnums': (0,),
                'compiled': make_train_step(model, jit=True),
                'keep': (model, state)}
    return build


def _eval_step_specimen():
    def build(device):
        from dgmc_tpu_torch.train.steps import make_eval_step
        model, _, batch = _model_state_batch(-1, device)
        return {'fn': make_eval_step(model, jit=False), 'args': (batch, 1),
                'keep': (model,)}
    return build


def _topk_specimen(dtype):
    def build(device):
        import torch
        from dgmc_tpu_torch.ops.topk import chunked_topk
        rng = np.random.RandomState(1)
        h_s = torch.from_numpy(rng.randn(1, 16, 8).astype(dtype)).to(device)
        h_t = torch.from_numpy(rng.randn(1, 24, 8).astype(dtype)).to(device)

        def topk(h_s, h_t):
            return chunked_topk(h_s, h_t, 4, block=8)

        return {'fn': topk, 'args': (h_s, h_t)}
    return build


def _softmax_specimen():
    def build(device):
        import torch
        from dgmc_tpu_torch.ops.softmax import masked_softmax
        rng = np.random.RandomState(2)
        s = torch.from_numpy(rng.randn(1, 8, 10).astype(np.float32))
        mask = torch.ones((1, 8, 10), dtype=torch.bool)
        return {'fn': masked_softmax, 'args': (s.to(device), mask.to(device))}
    return build


def _segment_specimen():
    def build(device):
        import torch
        from dgmc_tpu_torch.ops.segment import segment_sum
        rng = np.random.RandomState(3)
        vals = torch.from_numpy(rng.randn(1, 16, 4).astype(np.float32))
        idx = torch.from_numpy(rng.randint(0, 8, (1, 16)).astype(np.int32))

        def seg(vals, idx):
            # The 16 rows into 8 segments (JAX's call on these shapes
            # broadcasts its one batch row into each id's segment).
            return segment_sum(vals.reshape(-1, vals.shape[-1]),
                               idx.reshape(-1), 8)

        return {'fn': seg, 'args': (vals.to(device), idx.to(device))}
    return build


def default_specimens() -> List[Specimen]:
    """The registered hot functions (order = report order; JAX's
    single-device specimens)."""
    return [
        Specimen('forward_dense', _forward_specimen(k=-1)),
        Specimen('forward_sparse_k3', _forward_specimen(k=3)),
        Specimen('train_step_dense', _train_step_specimen(k=-1)),
        Specimen('train_step_sparse_k3', _train_step_specimen(k=3)),
        Specimen('eval_step_dense', _eval_step_specimen()),
        Specimen('ops.chunked_topk_f32', _topk_specimen(np.float32)),
        Specimen('ops.masked_softmax', _softmax_specimen()),
        Specimen('ops.segment_sum', _segment_specimen()),
    ]


def _device_count(device):
    import torch
    if device.type == 'cuda':
        return torch.cuda.device_count()
    return 1


def iter_runnable_specimens(tier, *, names=None, specimens=None,
                            on_progress=None, skipped=None, device='cpu'):
    """The one specimen-selection loop of the specimen consumers (JAX's):
    each registered specimen of ``tier`` that this process has enough
    devices for; skips go to ``on_progress`` and ``skipped`` (the
    baseline writers' preservation signal). ``names`` restricts to a
    name set."""
    import torch
    n_dev = _device_count(torch.device(device))
    for spec in (specimens if specimens is not None
                 else default_specimens()):
        if tier not in spec.tiers:
            continue
        if names is not None and spec.name not in names:
            continue
        if spec.min_devices and n_dev < spec.min_devices:
            if on_progress:
                on_progress(f'skip {spec.name} (needs >= '
                            f'{spec.min_devices} devices, have {n_dev})')
            if skipped is not None and spec.name not in skipped:
                skipped.append(spec.name)
            continue
        yield spec


_warmed = set()


def _warm_cublas(device):
    """One tiny product forward and backward on ``device``, once: cuBLAS
    allocates a workspace per handle and stream at its first call (the
    backward runs on the autograd engine's thread), which would
    otherwise count in the first specimen's measured peak."""
    import torch
    if str(device) in _warmed:
        return
    a = torch.ones(2, 2, device=device, requires_grad=True)
    (a @ a).sum().backward()
    _warmed.add(str(device))


class SpecimenArtifacts:
    """One specimen's build, recorded run and in-place check, each done
    at most once per process however many consumers ask (the trace
    rules, the liveness bound, the cost CLI's FLOPs)."""

    def __init__(self, spec: Specimen, device):
        import torch
        self.spec = spec
        self.device = torch.device(device)
        self.stats = {'builds': 0, 'runs': 0, 'captures': 0}
        self._built = None
        self._recorded = None
        self._inplace = None

    def built(self) -> Dict:
        if self._built is None:
            with probes_forced_off():
                self._built = self.spec.build(self.device)
            self.stats['builds'] += 1
        return self._built

    def recorded(self) -> Dict:
        """The one run: ``{'tape', 'cost', 'launches', 'seconds',
        'measured_peak_bytes' (the card's allocator above what was
        allocated before the run, cuBLAS's workspaces excluded; None on
        the CPU), 'output'}``. The tape and the work counter share it: the counter
        holds the dispatch ledger's counter slot and hands each kernel
        entry to the tape."""
        if self._recorded is not None:
            return self._recorded
        import torch
        from dgmc_tpu_torch.analysis.trace_rules import TapeRecorder
        from dgmc_tpu_torch.obs.cost import WorkCounter
        from dgmc_tpu_torch.ops.kernels import dispatch
        built = self.built()
        args = built['args']
        recorder = TapeRecorder(declared=(args, built.get('keep')))
        counter = WorkCounter(on_kernel=recorder.mark)
        on_card = self.device.type == 'cuda'
        before = dispatch.launch_counts()
        if on_card:
            _warm_cublas(self.device)
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        with probes_forced_off(), counter, recorder:
            out = built['fn'](*args)
        if on_card:
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        after = dispatch.launch_counts()
        self.stats['runs'] += 1
        self._recorded = {
            'tape': recorder.finish(out, args, built.get('keep')),
            'cost': counter.summary(),
            'launches': {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)},
            'seconds': seconds,
            'measured_peak_bytes': (
                torch.cuda.max_memory_allocated(self.device) - base
                if on_card else None),
            'output': out}
        return self._recorded

    def inplace(self):
        """TRC004 of a specimen that declares in-place state (``[]``
        otherwise): its step as the CLIs run it, once, with the declared
        state compared before and after."""
        built = self.built()
        if 'inplace' not in built:
            return []
        if self._inplace is None:
            import torch
            from dgmc_tpu_torch.analysis.trace_rules import (
                identities, inplace_findings)
            self.recorded()       # the recorded run first: Adam's moments
            before = identities(built['inplace']())
            with probes_forced_off():
                built['compiled'](*built['args'])
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            self.stats['captures'] += 1
            self._inplace = inplace_findings(
                before, built['inplace'](), self.spec.name,
                built.get('inplace_argnums', (0,)),
                ran=('the captured step (jit=True)'
                     if self.device.type == 'cuda'
                     else 'the compiled step run eagerly (jit=True)'))
        return list(self._inplace)


class SpecimenCache:
    """Shared :class:`SpecimenArtifacts` across consumers: one build and
    one run per specimen per process."""

    def __init__(self, device=None):
        from dgmc_tpu_torch import resolve_device
        self.device = resolve_device(device)
        self._arts: Dict[str, SpecimenArtifacts] = {}

    def artifacts(self, spec: Specimen) -> SpecimenArtifacts:
        art = self._arts.get(spec.name)
        if art is None:
            art = self._arts[spec.name] = SpecimenArtifacts(spec,
                                                            self.device)
        return art

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {name: dict(a.stats) for name, a in self._arts.items()}


_shared = {}


def shared_cache(device=None) -> SpecimenCache:
    """This process's :class:`SpecimenCache` on ``device`` (default
    ``cuda``): the lint CLI and the cost CLI share it, so a process that
    runs both builds and runs each specimen once."""
    cache = SpecimenCache(device)
    return _shared.setdefault(str(cache.device), cache)


def run_specimen(spec: Specimen, *, const_bytes=None,
                 artifacts: Optional[SpecimenArtifacts] = None,
                 device=None) -> List:
    """Every trace-tier rule over one specimen's recorded run, and
    TRC004 where it declares in-place state. Pass ``artifacts`` (from a
    :class:`SpecimenCache`) to share its run with the other
    consumers."""
    from dgmc_tpu_torch.analysis.trace_rules import TraceContext, analyze_tape
    kw = {}
    if const_bytes is not None:
        kw['const_bytes'] = const_bytes
    if artifacts is None:
        from dgmc_tpu_torch import resolve_device
        artifacts = SpecimenArtifacts(spec, resolve_device(device))
    ctx = TraceContext(specimen=spec.name, **kw)
    findings = analyze_tape(artifacts.recorded()['tape'], ctx)
    return findings + artifacts.inplace()


def run_trace_tier(specimens: Optional[List[Specimen]] = None, *,
                   const_bytes=None,
                   on_progress: Optional[Callable[[str], None]] = None,
                   skipped: Optional[List[str]] = None,
                   cache: Optional[SpecimenCache] = None,
                   device=None) -> List:
    """Run every runnable trace-tier specimen on ``cache``'s device (a
    new cache on ``device``, default ``cuda``, when none is given);
    skipped specimens are reported through ``on_progress`` and appended
    to ``skipped``."""
    findings = []
    cache = cache if cache is not None else SpecimenCache(device)
    for spec in iter_runnable_specimens('trace', specimens=specimens,
                                        on_progress=on_progress,
                                        skipped=skipped,
                                        device=cache.device):
        if on_progress:
            on_progress(f'trace {spec.name} on {cache.device}')
        findings.extend(run_specimen(spec, const_bytes=const_bytes,
                                     artifacts=cache.artifacts(spec)))
    return findings
