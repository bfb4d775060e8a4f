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

``--synthetic`` trains on the synthetic KG alignment (the JAX CLI's
offline stand-in, 15000 / 20000 entities and 100000 / 120000 edges by
default). The real DBP15K data needs the dataset's parser, which is not
ported: without ``--synthetic`` the CLI exits with a notice.
"""

import argparse
import sys
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.data.synthetic import synthetic_kg_alignment
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.obs.memory import captured_memory, memory_snapshot
from dgmc_tpu_torch.obs.observe import MetricLogger
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import Graph, GraphPair, pad_pair_batch

__all__ = ['parse_args', 'synthetic_batches', 'build', 'noise_seed', 'main']


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.experiments.dbp15k',
        description=__doc__.split('\n\n')[0])
    p.add_argument('--synthetic', action='store_true',
                   help='train on the synthetic KG alignment (the real '
                        'DBP15K parser is not ported)')
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
    p.add_argument('--aot_compile', action='store_true',
                   help='capture the executed phase/eval steps up front '
                        '(each a CUDA graph on the card, replacing the '
                        'capture at first call; the static-buffer steps on '
                        'the CPU) and record each one\'s static memory '
                        '(argument + output + temp bytes, the temps its '
                        'graph\'s private pool) into the metrics log as '
                        'aot_memory_<name> events')
    precision.add_precision_args(p)
    return p.parse_args(argv)


def synthetic_batches(args):
    """``(train_batch, test_batch, in_dim)``: the synthetic alignment as
    host :class:`~dgmc_tpu_torch.utils.data.PairBatch` es, the seed
    alignments as the train ground truth (``--pairs-per-step`` replicas)
    and the rest as the test ground truth (one pair). Same arrays as the
    JAX CLI's for the same flags."""
    kg = synthetic_kg_alignment(
        args.syn_nodes_s, args.syn_nodes_t, args.syn_edges_s,
        args.syn_edges_t, args.syn_dim, noise_min=args.syn_noise_min,
        noise_max=args.syn_noise, rewire=args.syn_rewire,
        seed_frac=args.syn_seed_frac, rng=np.random.RandomState(args.seed))
    g_s = Graph(edge_index=np.stack([kg.senders_s, kg.receivers_s]),
                x=kg.x_s)
    g_t = Graph(edge_index=np.stack([kg.senders_t, kg.receivers_t]),
                x=kg.x_t)
    sizes = (args.syn_nodes_s, args.syn_edges_s, args.syn_nodes_t,
             args.syn_edges_t)

    def batch(mask, reps=1):
        y = np.where(mask, kg.perm, -1).astype(np.int64)
        return pad_pair_batch([GraphPair(s=g_s, t=g_t, y_col=y)], *sizes,
                              pairs_per_step=reps)

    return (batch(kg.train_mask, max(1, args.pairs_per_step)),
            batch(~kg.train_mask), args.syn_dim)


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
                dtype=prec)


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
    if not args.synthetic:
        print('[dbp15k] the DBP15K dataset parser is not ported yet; run '
              'with --synthetic to train on the synthetic KG alignment',
              file=sys.stderr)
        raise SystemExit(2)
    device = resolve_device(args.device)
    precision.apply(precision.from_args(args))
    train_batch, test_batch, in_dim = synthetic_batches(args)
    model = build(args, in_dim).to(device)
    state = create_train_state(model, learning_rate=args.lr)
    # Phase 1: feature matching only. Phase 2: refinement with ψ₁'s
    # gradients cut (detach), its dropout still active.
    phase1 = make_train_step(model, num_steps=0)
    phase2 = make_train_step(model, num_steps=args.num_steps, detach=True)
    eval1 = make_eval_step(model, hits_ks=(10,), num_steps=0)
    eval2 = make_eval_step(model, hits_ks=(10,), num_steps=args.num_steps)
    # One pair throughout: upload it once (its graphs keep their sorted
    # edge orders across steps).
    train_dev = batch_to_device(train_batch, device)
    test_dev = batch_to_device(test_batch, device)

    with MetricLogger(args.metrics_log) as logger:
        if args.aot_compile:
            _aot_compile(args, logger, state, (phase1, phase2),
                         (eval1, eval2), train_dev, test_dev)
        print('Optimize initial feature matching...', flush=True)
        return _train(args, state, (phase1, phase2), (eval1, eval2),
                      train_dev, test_dev, logger, hook)


def _aot_compile(args, logger, state, phases, evals, train_dev, test_dev):
    """Capture the steps this schedule will execute (eval1 runs only on
    phase-1 epochs divisible by 10) and log each one's static memory as
    an ``aot_memory_<name>`` event (with the host's resident set beside
    it), as the JAX CLI's ``--aot_compile`` does. Capturing leaves the
    state as it found it, so training from the same seed follows."""
    (phase1, phase2), (eval1, eval2) = phases, evals

    def aot(name, record):
        mem = captured_memory(record)
        logger.log(0, event=f'aot_memory_{name}', **mem,
                   capture_s=record.capture_s,
                   **memory_snapshot(name)['host'])
        print(f'# {name}: per-device static memory '
              f'{mem["total_bytes"] / 2**30:.3f} GiB '
              f'(args {mem["argument_bytes"] >> 20} MiB, '
              f'temps {mem["temp_bytes"] >> 20} MiB)', flush=True)

    # Clamp both gates to the epochs that will run: phase 1 ends at
    # min(phase1_epochs, epochs).
    p1_last = min(args.phase1_epochs, args.epochs)
    if p1_last >= 1:
        aot('phase1_step', phase1.capture(state, train_dev, 0))
        if any(e % 10 == 0 for e in range(1, p1_last + 1)):
            aot('eval1_step', eval1.capture(test_dev, 0))
    if args.epochs > args.phase1_epochs:
        aot('train_step', phase2.capture(state, train_dev, 0))
        aot('eval_step', eval2.capture(test_dev, 0))


def _train(args, state, phases, evals, train_dev, test_dev, logger, hook):
    """The two-phase schedule: a step per epoch, the evaluations, their
    printed lines and JSONL records."""
    (phase1, phase2), (eval1, eval2) = phases, evals
    last_print, t_span = 0, time.time()
    for epoch in range(1, args.epochs + 1):
        refine = epoch > args.phase1_epochs
        if epoch == args.phase1_epochs + 1:
            print('Refine correspondence matrix...', flush=True)
        step = phase2 if refine else phase1
        state, out = step(state, train_dev, noise_seed(args.seed, 0, epoch))
        if hook is not None:
            # The step's metrics are static: the next step overwrites them.
            hook('train', epoch, {k: v.clone() for k, v in out.items()})
        if epoch % 10 == 0 or refine:
            ev = (eval2 if refine else eval1)(
                test_dev, noise_seed(args.seed, 1, epoch))
            if hook is not None:
                hook('eval', epoch, {k: v.clone() for k, v in ev.items()})
            count = max(float(ev['count']), 1.0)
            per_epoch = (time.time() - t_span) / (epoch - last_print)
            last_print, t_span = epoch, time.time()
            loss = float(out['loss'])
            hits1 = float(ev['correct']) / count
            hits10 = float(ev['hits@10']) / count
            print(f'{epoch:03d}: Loss: {loss:.4f}, Hits@1: {hits1:.4f}, '
                  f'Hits@10: {hits10:.4f} ({per_epoch:.2f}s/epoch)',
                  flush=True)
            logger.log(epoch, loss=loss, hits1=hits1, hits10=hits10,
                       phase=2 if refine else 1)
    return state


if __name__ == '__main__':
    main()
