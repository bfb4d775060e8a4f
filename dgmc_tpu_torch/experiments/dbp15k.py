"""DBP15K cross-lingual entity alignment: train sparse DGMC.

``python -m dgmc_tpu_torch.experiments.dbp15k --synthetic [--device cpu]``

RelCNN ψ₁ (300 → ``--dim``, ``--num_layers`` layers, concat, final
linear, dropout 0.5) and ψ₂ (``--rnd_dim`` → ``--rnd_dim``, no dropout),
sparse DGMC with the top ``--k`` candidates per entity, in training
extended by ``min(k, N_t - k)`` random negatives and the injected ground
truth. The two-phase schedule: epochs ``1..--phase1_epochs`` train
feature matching alone (``num_steps=0``), the rest refine with
``--num_steps`` consensus steps and ψ₁ detached (its dropout still
active). Each epoch is one Adam step on loss(S_L) over the whole pair
(``--pairs-per-step`` replicas, each drawing its own noise and
negatives). The test alignments are evaluated with Hits@1 and Hits@10 at
every 10th phase-1 epoch and every phase-2 epoch, one line each (and,
with ``--metrics_log PATH``, one JSONL record each, the JAX CLI's:
``loss``, ``hits1``, ``hits10``, ``phase``). The defaults are the JAX
CLI's (``dgmc_tpu/experiments/dbp15k.py``), its precision policy
included: bf16 compute with float32 accumulation (``--precision bf16``);
``--f32`` computes in float32 throughout.

Every step runs compiled (``jit=True``): on the card each of the four
(phase 1, phase 2 and their evaluations) is a CUDA graph captured at its
first call and replayed after, reading the pair uploaded once in place;
on the CPU the same static-buffer code runs eagerly.
``--aot_compile`` captures the steps the schedule will run before epoch
1 and logs each one's static memory, as the JAX CLI does.

Memory tiers (the JAX CLI's flags): ``--blocked_adjacency {auto,on,off}``
attaches the blocked adjacency tables (:mod:`~dgmc_tpu_torch.ops.blocked`,
RelCNN then aggregates through the blocked kernel); ``auto``, the
default, is on unless ``--stream_chunk`` is set, as in the JAX CLI.
``--stream_chunk N`` streams the candidate search over source chunks of N
rows (one top-k launch per chunk), ``--topk_block`` sets the plain scan's
target block. ``--offload-corpus`` adds a pass after training: the test
pair's source ψ₁ table in host RAM, re-shortlisted through the
``--prefetch-depth``-deep ring (:func:`~dgmc_tpu_torch.ops.offload.
offloaded_streamed_topk`) and compared bit for bit with the
device-resident streamed search; it prints ``# offload shortlist:
equal=...``, logs an ``offload_shortlist`` record under ``--metrics_log``
and exits non-zero when the two differ.

Checkpoints (the JAX CLI's flags): ``--ckpt_dir DIR`` saves the model,
the Adam state and the step every ``--ckpt_every`` epochs and at the
last (:mod:`~dgmc_tpu_torch.train.checkpoint`), and a run started over
a directory that holds steps resumes from the newest restorable one,
before any step is captured: the phase is a function of the epoch and
every draw a function of (seed, split, epoch), so a resumed run
continues as the uninterrupted one would, bit for bit. ``--guard-bad-steps
M`` turns on the in-graph non-finite guard (a bad step keeps the old
state, its counters printed at each eval) and rolls back to the last
good eval's parameters, with a fresh optimizer, after M consecutive bad
steps (:mod:`~dgmc_tpu_torch.resilience.guard`). ``--inject-fault SPEC``
arms a deterministic fault (:mod:`~dgmc_tpu_torch.resilience.faults`).
With ``--metrics_log`` a resume logs ``event='resume'`` (with the
restore's seconds) and ``'resume_first_step'`` (the seconds from the
restore's start to the end of the first step run), each save
``event='checkpoint'`` (its seconds and bytes) and each rollback
``event='rollback'``.

``--category {zh_en,ja_en,fr_en}`` trains on that language pair of
DBP15K, parsed from the JAPE release under ``--data_root``
(:class:`~dgmc_tpu_torch.datasets.DBP15K`: word vectors summed per
entity, the ``sup`` alignments as the train ground truth, the ``ref``
ones as the test's). ``--synthetic`` trains on the synthetic KG
alignment instead (the JAX CLI's offline stand-in, 15000 / 20000
entities and 100000 / 120000 edges by default). One of the two is
required.

The run plane (the JAX CLI's flags, :mod:`~dgmc_tpu_torch.obs`):
``--obs-dir DIR`` writes the run's telemetry there (``metrics.jsonl``,
``timings.json``, ``memory.json``, ``dispatch.json``, ``quality.json``,
``trace.json``, ``anomalies.json``; ``--slo FILE`` adds ``slo.json``),
``--probes`` streams the in-graph probes of every train step,
``--watchdog-deadline SEC`` arms the watchdog (``heartbeat.json``, and
``hang_report.json`` with ``flight.json`` on a stall or SIGTERM) and
``--obs-port PORT`` serves ``/healthz``, ``/metrics`` and ``/status``.
The observer is built before any step is captured (``--aot_compile``'s
too). Each step is timed on the host (its replay call: no step is
fenced, as in the JAX CLI); each eval epoch reads the loss as the
device's completion fence. ``--profile-dir DIR`` (``--profile-steps
A:B``) and ``--profile DIR`` (one step of the second epoch run) write
``torch.profiler`` Chrome traces.
"""

import argparse
import os
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.data.synthetic import synthetic_kg_alignment
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.evalsum import eval_summary
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.obs.memory import captured_memory, memory_snapshot
from dgmc_tpu_torch.obs.observe import MetricLogger, trace
from dgmc_tpu_torch.obs.run import (RunObserver, add_obs_flag,
                                    padding_baseline)
from dgmc_tpu_torch.obs.trace import add_profile_flag, start_profile
from dgmc_tpu_torch.resilience.supervisor import (add_supervisor_args,
                                                  supervise_cli)
from dgmc_tpu_torch.ops.blocked import attach_blocks, repeat_graph
from dgmc_tpu_torch.ops.topk import DEFAULT_STREAM_CHUNK, DEFAULT_TOPK_BLOCK
from dgmc_tpu_torch.resilience import (FaultPlan, RollbackGuard,
                                       add_fault_args, ledger_dir)
from dgmc_tpu_torch.train.checkpoint import resume_or_init
from dgmc_tpu_torch.train.state import create_train_state, with_guard_counters
from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import (Graph, GraphPair, PairBatch,
                                       pad_pair_batch)

__all__ = ['parse_args', 'use_blocked_adjacency', 'synthetic_batches',
           'load_batches', 'build', 'noise_seed', 'offload_pass', 'main']


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.experiments.dbp15k',
        description=__doc__.split('\n\n')[0])
    p.add_argument('--category', type=str, default=None,
                   choices=['zh_en', 'ja_en', 'fr_en'],
                   help='the DBP15K language pair to train on')
    p.add_argument('--data_root', type=str,
                   default=os.path.join('data', 'DBP15K'),
                   help='the DBP15K (JAPE) release directory')
    p.add_argument('--synthetic', action='store_true',
                   help='train on the synthetic KG alignment instead')
    p.add_argument('--syn_nodes_s', type=int, default=15000)
    p.add_argument('--syn_nodes_t', type=int, default=20000)
    p.add_argument('--syn_edges_s', type=int, default=100000)
    p.add_argument('--syn_edges_t', type=int, default=120000)
    p.add_argument('--syn_dim', type=int, default=300)
    p.add_argument('--syn_noise', type=float, default=2.5,
                   help='max feature-noise sigma on aligned entities')
    p.add_argument('--syn_noise_min', type=float, default=0.5,
                   help='min feature-noise sigma (each aligned entity draws '
                        'its own in [min, max])')
    p.add_argument('--syn_rewire', type=float, default=0.15,
                   help='fraction of source edges rewired on the target side')
    p.add_argument('--syn_seed_frac', type=float, default=0.3,
                   help='seed-alignment (training) fraction')
    p.add_argument('--pairs-per-step', '--pairs_per_step',
                   dest='pairs_per_step', type=int, default=1, metavar='N',
                   help='batch N replicas of the training pair per step, '
                        'each drawing its own noise and negatives')
    p.add_argument('--dim', type=int, default=256)
    p.add_argument('--rnd_dim', type=int, default=32)
    p.add_argument('--num_layers', type=int, default=3)
    p.add_argument('--num_steps', type=int, default=10)
    p.add_argument('--k', type=int, default=10)
    p.add_argument('--lr', type=float, default=0.001)
    p.add_argument('--epochs', type=int, default=200)
    p.add_argument('--phase1_epochs', type=int, default=100)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        'PyTorch path)')
    p.add_argument('--metrics_log', type=str, default=None,
                   help='append per-evaluation metrics to this JSONL file')
    p.add_argument('--profile', type=str, default=None,
                   help='write a torch.profiler trace of one training step '
                        '(of the second epoch run) into this directory; a '
                        'captured step shows as its graph launch and '
                        'kernels')
    p.add_argument('--aot_compile', action='store_true',
                   help='capture the executed phase/eval steps up front '
                        '(each a CUDA graph on the card, replacing the '
                        'capture at first call; the static-buffer steps on '
                        'the CPU) and record each one\'s static memory '
                        '(argument + output + temp bytes, the temps its '
                        'graph\'s private pool) into the metrics log as '
                        'aot_memory_<name> events')
    p.add_argument('--stream_chunk', type=int, default=0,
                   help='stream the sparse candidate search over source-node '
                        'chunks of this many rows, one search each (0 = '
                        'off)')
    p.add_argument('--blocked_adjacency', choices=['auto', 'on', 'off'],
                   default='auto',
                   help='aggregate RelCNN through the blocked adjacency '
                        'tables and the blocked kernel (ops/blocked.py); '
                        '"auto" = on, except with --stream_chunk (the JAX '
                        "CLI's rule: the tables are O(E) per device, "
                        'dropped where memory is the budget)')
    p.add_argument('--offload-corpus', '--offload_corpus',
                   dest='offload_corpus', action='store_true',
                   help='after training, re-shortlist the test pair with '
                        'the source ψ₁ table in host RAM through the '
                        'prefetch ring and require it bit-equal to the '
                        'device-resident streamed search')
    p.add_argument('--prefetch-depth', '--prefetch_depth',
                   dest='prefetch_depth', type=int, default=0, metavar='N',
                   help='prefetch ring depth for --offload-corpus (0 = '
                        'ops/offload.DEFAULT_PREFETCH_DEPTH)')
    p.add_argument('--topk_block', type=int, default=0,
                   help='candidate-search target block of the plain scan '
                        '(0 = ops/topk.DEFAULT_TOPK_BLOCK; the kernels '
                        'ignore it)')
    p.add_argument('--ckpt_dir', type=str, default=None,
                   help='periodic checkpoint and resume directory (a run '
                        'over saved steps resumes at the newest restorable '
                        'one)')
    p.add_argument('--ckpt_every', type=int, default=10)
    p.add_argument('--guard-bad-steps', '--guard_bad_steps',
                   dest='guard_bad_steps', type=int, default=0, metavar='M',
                   help='in-graph non-finite guard: a step with a '
                        'non-finite loss or gradient keeps the old state '
                        '(skip counted); M consecutive bad steps roll back '
                        'to the last good snapshot with a fresh optimizer '
                        '(0 = off). See dgmc_tpu_torch/resilience/guard.py')
    add_fault_args(p)
    precision.add_precision_args(p)
    add_obs_flag(p)
    add_profile_flag(p)
    add_supervisor_args(p)
    args = p.parse_args(argv)
    if args.ckpt_every < 1:
        p.error('--ckpt_every must be at least 1')
    return args


def use_blocked_adjacency(args):
    """``--blocked_adjacency`` resolved as the JAX CLI resolves it:
    ``auto`` is on unless the search is streamed (``--stream_chunk``)."""
    if args.blocked_adjacency == 'on':
        return True
    if args.blocked_adjacency == 'off':
        return False
    return not args.stream_chunk


def _pair_batches(args, g_s, g_t, y_train, y_test):
    """``(train_batch, test_batch)`` of one KG pair with the ground truths
    ``y_train`` / ``y_test`` (``[N_s]``, -1 where unaligned), each graph
    padded to its own size: the blocked tables attached as
    :func:`use_blocked_adjacency` says (built once on the one pair under
    the precision policy's gather dtype), the train batch repeated for
    ``--pairs-per-step``."""
    sizes = (g_s.num_nodes, g_s.num_edges, g_t.num_nodes, g_t.num_edges)

    def batch(y):
        return pad_pair_batch([GraphPair(s=g_s, t=g_t, y_col=y)], *sizes)

    train, test = batch(y_train), batch(y_test)
    s, t = train.s, train.t
    if use_blocked_adjacency(args):
        prec = precision.from_args(args)
        s = attach_blocks(s, gather_dtype=prec)
        t = attach_blocks(t, gather_dtype=prec)
    reps = max(1, args.pairs_per_step)
    train = PairBatch(s=repeat_graph(s, reps), t=repeat_graph(t, reps),
                      y=np.repeat(train.y, reps, axis=0),
                      y_mask=np.repeat(train.y_mask, reps, axis=0))
    return train, PairBatch(s=s, t=t, y=test.y, y_mask=test.y_mask)


def synthetic_batches(args):
    """``(train_batch, test_batch, in_dim)``: the synthetic alignment as
    host :class:`~dgmc_tpu_torch.utils.data.PairBatch` es, the seed
    alignments as the train ground truth (``--pairs-per-step`` replicas)
    and the rest as the test ground truth (one pair). Same arrays as the
    JAX CLI's for the same flags, the blocked tables included."""
    kg = synthetic_kg_alignment(
        args.syn_nodes_s, args.syn_nodes_t, args.syn_edges_s,
        args.syn_edges_t, args.syn_dim, noise_min=args.syn_noise_min,
        noise_max=args.syn_noise, rewire=args.syn_rewire,
        seed_frac=args.syn_seed_frac, rng=np.random.RandomState(args.seed))
    g_s = Graph(edge_index=np.stack([kg.senders_s, kg.receivers_s]),
                x=kg.x_s)
    g_t = Graph(edge_index=np.stack([kg.senders_t, kg.receivers_t]),
                x=kg.x_t)
    y = kg.perm.astype(np.int64)
    return (*_pair_batches(args, g_s, g_t, np.where(kg.train_mask, y, -1),
                           np.where(~kg.train_mask, y, -1)), args.syn_dim)


def load_batches(args):
    """``(train_batch, test_batch, in_dim)`` of ``--synthetic`` or of
    ``--category``'s DBP15K pair under ``--data_root``, as the JAX CLI
    builds them."""
    if args.synthetic:
        return synthetic_batches(args)
    if args.category is None:
        raise SystemExit('--category is required unless --synthetic')
    from dgmc_tpu_torch.datasets import DBP15K
    data = DBP15K(args.data_root, args.category)
    g_s, g_t = data.graphs(sum_embedding=True)
    y_train = np.full(g_s.num_nodes, -1, np.int64)
    y_train[data.train_y[0]] = data.train_y[1]
    y_test = np.full(g_s.num_nodes, -1, np.int64)
    y_test[data.test_y[0]] = data.test_y[1]
    return (*_pair_batches(args, g_s, g_t, y_train, y_test),
            g_s.x.shape[1])


def build(args, in_dim):
    """The model on the CPU, flax-default weights drawn from a generator
    seeded with ``args.seed``, computing under ``args``' precision policy
    (its parameters float32 under either)."""
    prec = precision.from_args(args)
    psi_1 = RelCNN(in_dim, args.dim, args.num_layers, batch_norm=False,
                   cat=True, lin=True, dropout=0.5, dtype=prec)
    psi_2 = RelCNN(args.rnd_dim, args.rnd_dim, args.num_layers,
                   batch_norm=False, cat=True, lin=True, dropout=0.0,
                   dtype=prec)
    return DGMC(psi_1, psi_2, num_steps=args.num_steps, k=args.k,
                generator=torch.Generator().manual_seed(args.seed),
                dtype=prec,
                topk_block=args.topk_block or DEFAULT_TOPK_BLOCK,
                stream_chunk=args.stream_chunk or None)


def noise_seed(seed, split, epoch):
    """The random seed of one step: disjoint for the train (``split`` 0)
    and eval (1) streams and every epoch."""
    return (seed * 2 + split) * 1_000_033 + epoch


def main(argv=None, hook=None):
    """Train as the module docstring says; returns the train state.
    ``hook(kind, epoch, out)``, if given, is called after every train
    step (``kind='train'``) and evaluation (``'eval'``) with its
    metrics."""
    args = parse_args(argv)
    if args.supervise:
        # This process becomes the monitor, before anything touches the
        # device; the run executes in children that resume through
        # --ckpt_dir. Of JAX's ladder only f32: the port has no
        # shrink-mesh and no disable-fused rung (resilience/supervisor.py).
        raise SystemExit(supervise_cli(
            'dgmc_tpu_torch.experiments.dbp15k', args, argv,
            ladder=('f32',)))
    device = resolve_device(args.device)
    plan = FaultPlan.from_args(
        args, state_dir=ledger_dir(args.ckpt_dir, args.obs_dir))
    precision.apply(precision.from_args(args))
    # The pair's two collations belong to the run's padding account.
    padding_since = padding_baseline()
    train_batch, test_batch, in_dim = load_batches(args)
    model = build(args, in_dim).to(device)
    state = create_train_state(model, learning_rate=args.lr)
    guard = args.guard_bad_steps > 0
    if guard:
        state = with_guard_counters(state)
    # Phase 1: feature matching only. Phase 2: refinement with ψ₁'s
    # gradients cut (detach), its dropout still active.
    fault = plan.nan_grads_step
    phase1 = make_train_step(model, num_steps=0, guard=guard,
                             fault_nan_step=fault)
    phase2 = make_train_step(model, num_steps=args.num_steps, detach=True,
                             guard=guard, fault_nan_step=fault)
    eval1 = make_eval_step(model, hits_ks=(10,), num_steps=0)
    eval2 = make_eval_step(model, hits_ks=(10,), num_steps=args.num_steps)
    # One pair throughout: upload it once (its graphs keep their sorted
    # edge orders across steps).
    train_dev = batch_to_device(train_batch, device)
    test_dev = batch_to_device(test_batch, device)

    with MetricLogger(args.metrics_log) as logger:
        # Resume before anything is captured: the restore writes in place
        # either way, and a capture's warm-ups start from the restored
        # state.
        t_resume = time.perf_counter()
        ckpt, state, start_epoch = resume_or_init(args.ckpt_dir, state,
                                                  model)
        if start_epoch > 1:
            logger.log(start_epoch - 1, event='resume',
                       restore_s=ckpt.last_restore['seconds'])
        else:
            t_resume = None
        # Before any capture: the probe switch is read when a step's
        # graph is captured.
        obs = RunObserver(args.obs_dir, probes=args.probes,
                          watchdog_deadline_s=args.watchdog_deadline,
                          obs_port=args.obs_port, padding_since=padding_since)
        prof = None
        try:
            obs.attach_anomaly()
            obs.attach_slo(args.slo)
            # The per-stage FLOPs and bytes and the MFU account of both
            # phases (obs/cost.py), before their captures: the
            # refinement step is the headline 'train_step'.
            obs.record_cost('phase1_step', phase1, state, train_dev,
                            noise_seed(args.seed, 0, 1))
            obs.record_cost('train_step', phase2, state, train_dev,
                            noise_seed(args.seed, 0, args.phase1_epochs + 1))
            if args.aot_compile:
                _aot_compile(args, start_epoch, logger, obs, state,
                             (phase1, phase2), (eval1, eval2), train_dev,
                             test_dev)
            prof = obs.attach_profiler(
                start_profile(args.profile_dir, steps=args.profile_steps))
            print('Optimize initial feature matching...', flush=True)
            rollback = RollbackGuard(args.guard_bad_steps, logger, obs=obs) \
                if guard else None
            state = _train(args, model, state, start_epoch,
                           (phase1, phase2), (eval1, eval2), train_dev,
                           test_dev, logger, obs, hook, ckpt, plan, rollback,
                           t_resume)
            if args.offload_corpus:
                offload_pass(args, model, test_dev, logger, obs)
        finally:
            if prof is not None:
                prof.close()
            obs.close()
        return state


def offload_pass(args, model, test_dev, logger, obs=None):
    """The host-RAM offload pass after training (the JAX CLI's): the test
    pair's ψ₁ tables (eval mode, in the compute dtype), the source one
    moved to host RAM and re-shortlisted through the prefetch ring, then
    compared bit for bit with the device-resident streamed search. Prints
    the ``# offload shortlist`` line, logs ``offload_shortlist`` and exits
    non-zero when they differ; returns ``(equal, stats)``."""
    from dgmc_tpu_torch.ops.offload import (DEFAULT_PREFETCH_DEPTH,
                                            offloaded_streamed_topk)
    from dgmc_tpu_torch.ops.topk import streamed_topk
    g_s, g_t = test_dev.graph_s, test_dev.graph_t
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            h_s = model._cast(model.psi_1(g_s.x, g_s))
            h_t = model._cast(model.psi_1(g_t.x, g_t))
    finally:
        model.train(training)
    chunk = min(args.stream_chunk or DEFAULT_STREAM_CHUNK, h_s.shape[1])
    block = args.topk_block or model.topk_block
    depth = args.prefetch_depth or DEFAULT_PREFETCH_DEPTH
    ref_v, ref_i = streamed_topk(h_s, h_t, args.k, chunk, block=block,
                                 return_values=True)
    ov, oi, stats = offloaded_streamed_topk(h_s.cpu(), h_t, args.k, chunk,
                                            block=block, depth=depth,
                                            device=h_s.device)
    equal = bool(torch.equal(oi, ref_i.cpu()) and torch.equal(ov,
                                                              ref_v.cpu()))
    print(f'# offload shortlist: equal={equal} rows={stats.rows} '
          f'chunks={stats.chunks} depth={stats.prefetch_depth} host '
          f'{stats.host_resident_bytes >> 20} MiB '
          f'misses={stats.ring_misses} wall {stats.wall_s:.3f}s', flush=True)
    record = {'offload_equal': float(equal),
              'offload_host_bytes': stats.host_resident_bytes,
              'offload_prefetch_depth': stats.prefetch_depth,
              'offload_ring_misses': stats.ring_misses,
              'offload_wall_s': stats.wall_s}
    logger.log(args.epochs, event='offload_shortlist', **record)
    if obs is not None:
        obs.log(args.epochs, event='offload_shortlist', **record)
    if not equal:
        raise SystemExit('offloaded shortlist diverged from the '
                         'device-resident streamed search: the offload tier '
                         'must be pure scheduling')
    return equal, stats


def _aot_compile(args, start_epoch, logger, obs, state, phases, evals,
                 train_dev, test_dev):
    """Capture the steps this schedule will execute from ``start_epoch``
    on (eval1 runs only on phase-1 epochs divisible by 10) and log each
    one's static memory as an ``aot_memory_<name>`` event (with the
    host's resident set beside it), as the JAX CLI's ``--aot_compile``
    does. Capturing leaves the state as it found it, so training from the
    same seed follows."""
    (phase1, phase2), (eval1, eval2) = phases, evals

    def aot(name, record):
        mem = captured_memory(record)
        logger.log(0, event=f'aot_memory_{name}', **mem,
                   capture_s=record.capture_s,
                   **memory_snapshot(name)['host'])
        obs.log(0, event=f'aot_memory_{name}', **mem)
        print(f'# {name}: per-device static memory '
              f'{mem["total_bytes"] / 2**30:.3f} GiB '
              f'(args {mem["argument_bytes"] >> 20} MiB, '
              f'temps {mem["temp_bytes"] >> 20} MiB)', flush=True)

    # Clamp both gates to the epochs that will run: phase 1 ends at
    # min(phase1_epochs, epochs), and a run resumed past the last epoch
    # runs nothing.
    p1_last = min(args.phase1_epochs, args.epochs)
    if start_epoch <= p1_last:
        aot('phase1_step', phase1.capture(state, train_dev, 0))
        if any(e % 10 == 0 for e in range(start_epoch, p1_last + 1)):
            aot('eval1_step', eval1.capture(test_dev, 0))
    if args.epochs > args.phase1_epochs and start_epoch <= args.epochs:
        aot('train_step', phase2.capture(state, train_dev, 0))
        aot('eval_step', eval2.capture(test_dev, 0))


def _train(args, model, state, start_epoch, phases, evals, train_dev,
           test_dev, logger, obs, hook, ckpt, plan, rollback, t_resume):
    """The two-phase schedule from ``start_epoch``: a step per epoch, the
    evaluations, their printed lines and JSONL records, the observer's
    records, the guard's counters and rollbacks, the checkpoints and the
    armed faults."""
    (phase1, phase2), (eval1, eval2) = phases, evals
    last_print, t_span = start_epoch - 1, time.time()
    # --profile: the second epoch run (the first captures its step).
    profile_epoch = min(start_epoch + 1, args.epochs)
    for epoch in range(start_epoch, args.epochs + 1):
        refine = epoch > args.phase1_epochs
        if epoch == args.phase1_epochs + 1:
            print('Refine correspondence matrix...', flush=True)
        # Armed host-side faults fire here, on epochs that run only.
        plan.before_step(epoch)
        step = phase2 if refine else phase1
        profile = args.profile if epoch == profile_epoch else None
        with trace(profile), \
                obs.compile_label(f'phase{2 if refine else 1}'):
            with obs.step():
                state, out = step(state, train_dev,
                                  noise_seed(args.seed, 0, epoch))
            if profile:
                float(out['loss'])  # the trace ends after the step ran
        if t_resume is not None:
            float(out['loss'])  # the first step run, to its end
            logger.log(epoch, event='resume_first_step',
                       seconds=time.perf_counter() - t_resume)
            t_resume = None
        if hook is not None:
            # The step's metrics are static: the next step overwrites them.
            hook('train', epoch, {k: v.clone() for k, v in out.items()})
        if epoch % 10 == 0 or refine:
            ev = (eval2 if refine else eval1)(
                test_dev, noise_seed(args.seed, 1, epoch))
            if hook is not None:
                hook('eval', epoch, {k: v.clone() for k, v in ev.items()})
            # The device's completion fence (the read below waits anyway).
            obs.fence_devices(out['loss'], tag=epoch)
            per_epoch = (time.time() - t_span) / (epoch - last_print)
            last_print, t_span = epoch, time.time()
            summary = eval_summary(ev['count'], loss=out['loss'],
                                   hits1=ev['correct'], hits10=ev['hits@10'])
            loss, hits1, hits10 = (summary['loss'], summary['hits1'],
                                   summary['hits10'])
            obs.quality_eval('dbp15k', summary, step=epoch)
            guard_metrics = {}
            if rollback is not None:
                consec_bad = int(out['consec_bad'])
                guard_metrics = {'skipped_steps': int(out['skip_count']),
                                 'consec_bad': consec_bad}
                # The live plane's gauges (/healthz, dgmc_guard_*).
                obs.set_gauge('guard_skip_count',
                              guard_metrics['skipped_steps'])
                obs.set_gauge('guard_consec_bad', consec_bad)
                if consec_bad == 0 and np.isfinite(loss):
                    rollback.note_good(state, model, step=epoch)
                else:
                    state, _ = rollback.maybe_rollback(state, model,
                                                       consec_bad,
                                                       step=epoch)
            print(f'{epoch:03d}: Loss: {loss:.4f}, Hits@1: {hits1:.4f}, '
                  f'Hits@10: {hits10:.4f} ({per_epoch:.2f}s/epoch)'
                  + ''.join(f', {k}: {v}' for k, v in guard_metrics.items()),
                  flush=True)
            logger.log(epoch, loss=loss, hits1=hits1, hits10=hits10,
                       phase=2 if refine else 1, **guard_metrics)
            obs.log(epoch, loss=loss, hits1=hits1, hits10=hits10,
                    phase=2 if refine else 1, epoch_s=round(per_epoch, 3),
                    **guard_metrics)
            obs.snapshot_memory(f'epoch{epoch}')
        if ckpt is not None and (epoch % args.ckpt_every == 0
                                 or epoch == args.epochs):
            ckpt.save(epoch, model, state)
            logger.log(epoch, event='checkpoint',
                       save_s=ckpt.last_save['seconds'],
                       save_bytes=ckpt.last_save['bytes'])
            # Armed ckpt-truncate / ckpt-corrupt faults damage the step
            # just saved.
            plan.after_checkpoint(ckpt, epoch)
    return state


if __name__ == '__main__':
    main()
