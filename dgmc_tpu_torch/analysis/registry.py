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
rules look for is shape-independent.

JAX's five mesh specimens follow, with JAX's names, order, models,
shapes, meshes, seeds, ``min_devices`` (2 or 4) and tiers, built on the
port's ``parallel/``: the data-parallel train step (also in the trace
tier, as in JAX), the row-sharded forward, the pairs-per-step-2 train
step, the streamed phase-2 step (``streamed_rules(stream_chunk=8)``)
and the column-sharded top-k. A mesh is a group of ranks, one card each:
a mesh specimen's ``build(device, inject=None)`` runs on every rank of a
world (:mod:`~dgmc_tpu_torch.analysis.ranks`: the consumers start 4
local gloo ranks when the process is in no world of enough ranks) and
gives ``None`` on a rank outside its mesh. Its build also declares JAX's
thresholds and budgets (``corr_bytes``, ``comm_budget_bytes``,
``overlap_budget``, ``peak_bytes_budget``, ``stream_full`` /
``stream_chunk``, ``residual_min_bytes``, ``double_buffer_min_bytes``),
each specimen's docstring gives the port's measured values beside
JAX's.

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
FLOPs and its kernel launches; a mesh specimen's run is its ranks' (rank
0's tape for the rules that read one program, every rank's collectives
for SHD301). A train-step specimen declares the state
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
           'iter_runnable_specimens', 'SpecimenArtifacts', 'MeshArtifacts',
           'SpecimenCache', 'shared_cache', 'run_specimen', 'run_trace_tier']


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
    #: 0 = always runnable; else the minimum rank count.
    min_devices: int = 0
    #: Which lint tiers analyze this specimen: ``'trace'`` (the tape
    #: rules), ``'shd'`` (the collectives) and / or ``'sched'`` (the
    #: schedule and liveness rules).
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


# ---------------------------------------------------------------------------
# Mesh specimens (run on every rank of a world; None outside the mesh)
# ---------------------------------------------------------------------------


def _repeat(one, reps):
    """JAX's ``np.repeat`` of the specimen pair over the batch axis."""
    from dgmc_tpu_torch.utils.data import PairBatch
    return PairBatch(
        s={k: np.repeat(v, reps, 0) for k, v in one.s.items()},
        t={k: np.repeat(v, reps, 0) for k, v in one.t.items()},
        y=np.repeat(one.y, reps, 0), y_mask=np.repeat(one.y_mask, reps, 0))


def _mesh_model(device, inject, k=-1, num_steps=1):
    """JAX's mesh specimen model, DGMC(RelCNN(4, 8, 1), RelCNN(4, 4, 1),
    num_steps=1, k), its weights from seed 0 or ``inject['state_dict']``,
    and Adam at 1e-3 (JAX's ``create_train_state``)."""
    import torch
    from dgmc_tpu_torch.train.state import create_train_state
    model = specimen_model(k, num_steps)
    if inject and inject.get('state_dict') is not None:
        model.load_state_dict({n: torch.as_tensor(v) for n, v in
                               inject['state_dict'].items()})
    model = model.to(device)
    return model, create_train_state(model, learning_rate=1e-3)


def _draws(inject, mesh, data):
    """``(r_s, negatives)`` of ``inject`` (None without), on ``mesh``'s
    device; with ``data`` each this rank's block of the batch over the
    data axis (JAX's draws are the whole batch's)."""
    import torch
    from dgmc_tpu_torch.parallel.distributed import cut
    out = []
    for key, axis in (('r_s', 1), ('negatives', 0)):
        x = (inject or {}).get(key)
        if x is None:
            out.append(None)
            continue
        x = torch.as_tensor(x)
        if data:
            n, me = mesh.axis_size('data'), mesh.axis_index('data')
            x = cut(x.transpose(0, axis), n, me).transpose(0, axis)
        out.append(x.to(mesh.device))
    return out


def _step_build(model, state, step, compiled, args, draws):
    import functools
    from dgmc_tpu_torch.analysis.trace_rules import state_tensors
    r_s, neg = draws
    if r_s is not None or neg is not None:
        step = functools.partial(step, r_s=r_s, negatives=neg)
    return {'fn': step, 'args': args,
            'inplace': lambda: state_tensors(model, state),
            'inplace_argnums': (0,), 'compiled': compiled,
            'keep': (model, state)}


def _sharded_train_step_specimen():
    """The data-parallel train step (JAX's ``parallel.sharded_train_step``,
    the configuration of JAX's persistent-cache aliasing bug): B = 2 (the
    specimen pair twice), num_steps 1, k = -1, over a ``data=2`` mesh of
    ranks 0 and 1 (:func:`~dgmc_tpu_torch.parallel.sharding.
    make_sharded_train_step`, each rank one pair). JAX declares no budget
    for it; the port neither. Measured on 2 of 4 gloo CPU ranks and on
    the card's (``chip_smoke.py`` ``lint`` (f)): 1,320 B a step, the one
    flat gradient all-reduce (4 B x the 321 trained values = 1,284 B)
    and five scalar or per-pair sums of the loss and metrics (JAX's
    compiled program: 2,556 B in two all-reduces and one all-gather; the
    port writes each metric's sum as a collective of its own)."""
    def build(device, inject=None):
        from dgmc_tpu_torch.parallel import (make_mesh,
                                             make_sharded_train_step,
                                             replicate, shard_batch)
        from dgmc_tpu_torch.parallel.distributed import process_index
        mesh = make_mesh(data=2, model=1, ranks=[0, 1], device=device)
        if process_index() not in (0, 1):
            return None
        model, state = _mesh_model(mesh.device, inject)
        batch = shard_batch(_repeat(pair_batch(), 2), mesh)
        return _step_build(
            model, state, make_sharded_train_step(model, mesh, jit=False),
            make_sharded_train_step(model, mesh, jit=True),
            (replicate(state, mesh, model), batch, 1),
            _draws(inject, mesh, True))
    return build


def _sharded_forward_rows_specimen():
    """The row-sharded dense forward (JAX's
    ``parallel.sharded_forward_rows``): B = 2, num_steps 1, k = -1, S
    under ``corr_sharding`` (batch over ``data``, source rows over
    ``model``) on a ``data=2 x model=2`` mesh of 4 ranks, each rank its
    pair and its rows. SHD302 watches for an all-gather of the full
    ``[B, N_s, N_t]`` S (``corr_bytes`` = 2 x 8 x 10 x 4 = 640 B).
    ``comm_budget_bytes``: measured on 4 gloo CPU ranks and on the
    card's, the port moves 160 B (the consensus step's sum of ``r_t``
    over the rows, [1, 10, 4] float32; the softmax over the targets is
    row-local), so JAX's 8x headroom gives 1,280 B (JAX: 1 MiB, against
    its compiled program's 672 B)."""
    def build(device, inject=None):
        import torch
        from dgmc_tpu_torch.parallel import (corr_sharding, make_mesh,
                                             shard_batch)
        mesh = make_mesh(data=2, model=2, device=device)
        model, _ = _mesh_model(mesh.device, inject)
        model = model.with_layout(corr_sharding=corr_sharding(mesh))
        model.eval()
        batch = shard_batch(_repeat(pair_batch(), 2), mesh)
        r_s, _ = _draws(inject, mesh, True)

        def forward(model, batch, noise_seed):
            with torch.no_grad():
                return model(batch.graph_s, batch.graph_t,
                             noise_seed=noise_seed, r_s=r_s)

        return {'fn': forward, 'args': (model, batch, 1),
                'corr_bytes': 2 * 8 * 10 * 4,
                'comm_budget_bytes': 1280}
    return build


def _sharded_train_step_pairs_specimen():
    """The pairs-per-step-2 train step on the whole ``data x model`` mesh
    (JAX's ``parallel.sharded_train_step_pairs2``, the program family of
    JAX's multichip hangs): B = 4 (2 pair replicas x 2 data ranks) on a
    ``data=2 x model=2`` mesh of 4 ranks, batch over ``data``, no row
    layout (the two model ranks of a data rank run the same pairs, as
    GSPMD replicates over ``model``; the loss's count over the mesh
    cancels the duplicate). ``comm_budget_bytes``: measured on 4 gloo CPU
    ranks and on the card's, the port moves 1,328 B (the gradient
    all-reduce, 1,284 B, the loss and metric sums, the per-pair losses
    gathered over ``data``), so 8x: 10,624 B (JAX: 1 MiB, against its
    compiled program's 2,564 B)."""
    def build(device, inject=None):
        from dgmc_tpu_torch.parallel import (make_mesh,
                                             make_sharded_train_step,
                                             replicate, shard_batch)
        mesh = make_mesh(data=2, model=2, device=device)
        model, state = _mesh_model(mesh.device, inject)
        batch = shard_batch(_repeat(pair_batch(), 4), mesh)
        build = _step_build(
            model, state, make_sharded_train_step(model, mesh, jit=False),
            make_sharded_train_step(model, mesh, jit=True),
            (replicate(state, mesh, model), batch, 1),
            _draws(inject, mesh, True))
        build['comm_budget_bytes'] = 10624
        return build
    return build


def _streamed_train_step_specimen():
    """The streamed phase-2 train step (JAX's
    ``parallel.streamed_train_step``, ROADMAP item 3's million-entity
    layout at fixture scale): the pair of 16 / 32 and 32 / 64 nodes /
    edges, k = 4, num_steps 1, ``detach=True`` (dbp15k's phase 2), the
    correspondence rows over a ``data=4`` mesh of 4 ranks with
    ``streamed_rules(stream_chunk=8)`` (the search streamed over source
    chunks, the targets ringing). ``corr_bytes`` is the full dense S
    (1 x 16 x 32 x 4 = 2,048 B) no collective may materialize (SHD302).

    Budgets by JAX's headroom rule, each measured on 4 gloo CPU ranks
    (``python -m dgmc_tpu_torch.analysis.schedule --device cpu``) and on
    the card's (``chip_smoke.py`` ``lint`` (f)) beside JAX's values (its
    ``registry.py``):

    - communication: the port moves 1,000 B a step (the consensus step's
      sum of ``r_t`` over the rows, 512 B; the gradient all-reduce of ψ₂
      and the consensus MLP, 4 B x 113 values, ψ₁ being detached; the
      loss and metric sums) against JAX's ~7.5 KiB (4,832 B at the
      installed JAX: its ring permutes the target shards and it gathers
      the candidates, where each port rank holds every shard, ψ₁ running
      whole on every rank); 8x: 8,000 B (JAX: 64 KiB);
    - overlap: 0.516 modeled, on the CPU ranks and on the card (JAX:
      0.3118), so ``overlap_budget`` = 0.77 x 0.516 = 0.3973 (JAX: 0.24
      = 0.77 x 0.3118);
    - static peak: 20,876-21,156 B on the CPU ranks, 21,549 B on the
      card (JAX: 27,232 B), so ``peak_bytes_budget`` = 1.5 x 21,156 =
      31,734 B (JAX: 40 KiB).

    ``stream_full`` / ``stream_chunk`` (16 / 8) arm MEM405 with JAX's
    ``residual_min_bytes`` of 4 KiB; ``double_buffer_min_bytes`` is JAX's
    128 (SCH403). The ring moves no data in the port (each rank holds
    every target shard, ``parallel/topk.py``), so its fetches are the
    chunk slices of the search."""
    def build(device, inject=None):
        from dgmc_tpu_torch.parallel import (make_mesh,
                                             make_sharded_train_step,
                                             streamed_rules)
        mesh = make_mesh(data=4, model=1, device=device)
        model, state = _mesh_model(mesh.device, inject, k=4)
        one = pair_batch(np.random.RandomState(0), n_s=16, e_s=32, n_t=32,
                         e_t=64)
        rules = streamed_rules(stream_chunk=8)
        step = make_sharded_train_step(model, mesh, num_steps=1,
                                       detach=True, rules=rules,
                                       state=state, jit=False)
        compiled = make_sharded_train_step(model, mesh, num_steps=1,
                                           detach=True, rules=rules,
                                           state=state, jit=True)
        state, batch = rules.place(state, one, mesh, model)
        build = _step_build(model, state, step, compiled, (state, batch, 1),
                            _draws(inject, mesh, False))
        build.update({'corr_bytes': 1 * 16 * 32 * 4,
                      'comm_budget_bytes': 8000,
                      'overlap_budget': 0.3973,
                      'peak_bytes_budget': 31734,
                      'stream_full': 16, 'stream_chunk': 8,
                      'residual_min_bytes': 4 << 10,
                      'double_buffer_min_bytes': 128})
        return build
    return build


def _sharded_topk_cols_specimen():
    """The column-sharded top-k (JAX's ``parallel.sharded_topk_cols``):
    [1, 16, 8] x [1, 24, 8] from seed 1, k = 4, block 8, the target
    columns over a ``model=2`` mesh of ranks 0 and 1, one all-gather of
    the candidates' values and indices. ``corr_bytes`` is the 16 x 24
    score matrix (1,536 B). ``comm_budget_bytes``: on 2 of 4 gloo CPU
    ranks and on the card's the port moves 1,024 B, as JAX's compiled
    program does (the all-gathers of the [1, 16, 4] candidate values and
    indices), so 8x: 8,192 B (JAX: 64 KiB)."""
    def build(device, inject=None):
        import torch
        from dgmc_tpu_torch.parallel import make_mesh, sharded_topk_cols
        from dgmc_tpu_torch.parallel.distributed import process_index
        mesh = make_mesh(data=1, model=2, ranks=[0, 1], device=device)
        if process_index() not in (0, 1):
            return None
        rng = np.random.RandomState(1)
        h_s = torch.from_numpy(rng.randn(1, 16, 8).astype(np.float32))
        h_t = torch.from_numpy(rng.randn(1, 24, 8).astype(np.float32))

        def topk(h_s, h_t):
            return sharded_topk_cols(mesh, h_s, h_t, 4, block=8)

        return {'fn': topk,
                'args': (h_s.to(mesh.device), h_t.to(mesh.device)),
                'corr_bytes': 1 * 16 * 24 * 4,
                'comm_budget_bytes': 8192}
    return build


def default_specimens() -> List[Specimen]:
    """The registered hot functions (order = report order; JAX's)."""
    return [
        Specimen('forward_dense', _forward_specimen(k=-1)),
        Specimen('forward_sparse_k3', _forward_specimen(k=3)),
        Specimen('train_step_dense', _train_step_specimen(k=-1)),
        Specimen('train_step_sparse_k3', _train_step_specimen(k=3)),
        Specimen('eval_step_dense', _eval_step_specimen()),
        Specimen('ops.chunked_topk_f32', _topk_specimen(np.float32)),
        Specimen('ops.masked_softmax', _softmax_specimen()),
        Specimen('ops.segment_sum', _segment_specimen()),
        Specimen('parallel.sharded_train_step',
                 _sharded_train_step_specimen(), min_devices=2,
                 tiers=('trace', 'shd', 'sched')),
        Specimen('parallel.sharded_forward_rows',
                 _sharded_forward_rows_specimen(), min_devices=4,
                 tiers=('shd', 'sched')),
        Specimen('parallel.sharded_train_step_pairs2',
                 _sharded_train_step_pairs_specimen(), min_devices=4,
                 tiers=('shd', 'sched')),
        Specimen('parallel.streamed_train_step',
                 _streamed_train_step_specimen(), min_devices=4,
                 tiers=('shd', 'sched')),
        Specimen('parallel.sharded_topk_cols',
                 _sharded_topk_cols_specimen(), min_devices=2,
                 tiers=('shd', 'sched')),
    ]


def iter_runnable_specimens(tier, *, names=None, specimens=None,
                            on_progress=None, skipped=None):
    """The one specimen-selection loop of the specimen consumers (JAX's):
    each registered specimen of ``tier`` that this process can run: a
    one-device specimen always, a mesh specimen where this process's
    world or the :data:`~dgmc_tpu_torch.analysis.ranks.DEFAULT_RANKS`
    local ranks its consumer starts are enough; every tier's for
    ``tier`` ``None``. Skips go to ``on_progress`` and ``skipped`` (the
    baseline writers' preservation signal). ``names`` restricts to a
    name set."""
    from dgmc_tpu_torch.analysis.ranks import DEFAULT_RANKS
    from dgmc_tpu_torch.parallel.distributed import process_count
    ranks = max(process_count(), DEFAULT_RANKS)
    for spec in (specimens if specimens is not None
                 else default_specimens()):
        if tier is not None and tier not in spec.tiers:
            continue
        if names is not None and spec.name not in names:
            continue
        if spec.min_devices and ranks < spec.min_devices:
            if on_progress:
                on_progress(f'skip {spec.name} (needs >= '
                            f'{spec.min_devices} ranks, have {ranks})')
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

    def __init__(self, spec: Specimen, device, inject=None):
        import torch
        self.spec = spec
        self.device = torch.device(device)
        self.inject = inject
        self.stats = {'builds': 0, 'runs': 0, 'captures': 0}
        self._built = None
        self._recorded = None
        self._inplace = None

    def built(self) -> Dict:
        """The specimen's build (``None`` on a rank outside a mesh
        specimen's mesh)."""
        if self.stats['builds'] == 0:
            kw = {'inject': self.inject} if self.inject else {}
            with probes_forced_off():
                self._built = self.spec.build(self.device, **kw)
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


class MeshArtifacts:
    """A mesh specimen's runs on its ranks
    (:class:`~dgmc_tpu_torch.analysis.ranks.MeshRuns`), read as
    :class:`SpecimenArtifacts` reads one run: :meth:`built` gives its
    thresholds and budgets, :meth:`recorded` and :meth:`inplace` rank 0's
    record, :meth:`ranks` every rank's."""

    def __init__(self, spec: Specimen, runs):
        self.spec = spec
        self.runs = runs
        self.device = runs.device

    def ranks(self):
        recs = self.runs.records(self.spec.name)
        if not recs:
            raise RuntimeError(f'{self.spec.name}: no rank ran it')
        return recs

    @property
    def stats(self):
        return dict(self.ranks()[0]['stats'])

    def built(self) -> Dict:
        return dict(self.ranks()[0]['budgets'])

    def recorded(self) -> Dict:
        return self.ranks()[0]

    def inplace(self):
        return list(self.ranks()[0]['inplace'])


class SpecimenCache:
    """Shared :class:`SpecimenArtifacts` across consumers: one build and
    one run per specimen per process; the mesh specimens' runs on their
    ranks through one :class:`~dgmc_tpu_torch.analysis.ranks.MeshRuns`."""

    def __init__(self, device=None):
        from dgmc_tpu_torch import resolve_device
        self.device = resolve_device(device)
        self._arts: Dict[str, SpecimenArtifacts] = {}
        self._mesh = None

    def mesh_runs(self):
        """This cache's :class:`~dgmc_tpu_torch.analysis.ranks.MeshRuns`
        (one start of the ranks for every mesh specimen)."""
        if self._mesh is None:
            from dgmc_tpu_torch.analysis.ranks import MeshRuns
            self._mesh = MeshRuns(str(self.device))
        return self._mesh

    def artifacts(self, spec: Specimen):
        art = self._arts.get(spec.name)
        if art is None:
            if spec.min_devices:
                art = MeshArtifacts(spec, self.mesh_runs())
            else:
                art = SpecimenArtifacts(spec, self.device)
            self._arts[spec.name] = art
        return art

    def where(self, spec):
        """Where ``spec`` runs, for the progress lines."""
        if spec.min_devices:
            return self.mesh_runs().where
        return str(self.device)

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
                                        skipped=skipped):
        if on_progress:
            on_progress(f'trace {spec.name} on {cache.where(spec)}')
        findings.extend(run_specimen(spec, const_bytes=const_bytes,
                                     artifacts=cache.artifacts(spec)))
    return findings
