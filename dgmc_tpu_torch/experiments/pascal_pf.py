"""PascalPF geometric matching: train dense DGMC on synthetic pairs.

``python -m dgmc_tpu_torch.experiments.pascal_pf [--device cpu]``

SplineCNN ψ₁ (1 → ``--dim``, no concat) and ψ₂ (``--rnd_dim`` →
``--rnd_dim``, concat) over KNN(8) graphs with Cartesian
pseudo-coordinates, dense DGMC (``k = -1``) with ``--num_steps``
consensus steps, trained with Adam on ``loss(S_0) + loss(S_L)`` over
random point-cloud pairs (30-60 inliers, 0-20 outliers, sigma 0.05
jitter), padded to 80 nodes / 640 edges, one line per epoch. The defaults
are the JAX CLI's (``dgmc_tpu/experiments/pascal_pf.py``), its precision
policy included: bf16 compute with float32 accumulation
(``--precision bf16``); ``--f32`` computes in float32 throughout.

The train and eval steps run compiled (``jit=True``): on the card each is
a CUDA graph captured at its first call, each batch copied into its
static buffers and the graph replayed (its SplineCNN routing and edge
orders built inside the graph, from the batch copied in); on the CPU the
same static-buffer code runs eagerly.

Batches are collated (through the port's C++ collation) and prepared as
pinned host tensors two batches ahead in a background thread
(``utils.data.PrefetchLoader``), the role the reference gives its
DataLoader workers; the step copies each to the card without blocking. A
replayed step holds the GIL for a few calls only, so the thread's
collation overlaps the device's work (an eager step's Python held it
for most of the step, and the thread then cost more than it saved).

``--synthetic_eval N`` also evaluates on ``N`` held-out synthetic pairs
per epoch. With the PF-PASCAL release at ``--data_root``
(:class:`~dgmc_tpu_torch.datasets.PascalPF`), every epoch also evaluates
zero-shot on its pairs, one pair a step, padded to its category's
largest item (``8 x`` that many edges: one compiled eval step per
category size), and prints the per-category and mean accuracies; without
it a notice says the real-data eval is disabled. ``--metrics_log PATH``
appends the JAX CLI's per-epoch JSONL records (``loss``, ``train_acc``,
``synthetic_eval_acc``, ``mean_acc``) to ``PATH``.

The run plane (the JAX CLI's flags, :mod:`~dgmc_tpu_torch.obs`):
``--obs-dir``, ``--probes``, ``--watchdog-deadline``, ``--obs-port`` and
``--slo`` as in ``dbp15k``; each train step is timed on the host (the
replay call), the epoch's summed loss is the device's completion fence.
``--profile-dir`` / ``--profile-steps`` and ``--profile DIR`` (the
second epoch's training loop) write ``torch.profiler`` Chrome traces.
"""

import argparse
import os
import time

import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            KNNGraph)
from dgmc_tpu_torch.datasets.pascal_pf import CATEGORIES, PascalPF
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.evalsum import eval_summary
from dgmc_tpu_torch.models.spline import SplineCNN
from dgmc_tpu_torch.obs.observe import MetricLogger, trace
from dgmc_tpu_torch.obs.run import RunObserver, add_obs_flag
from dgmc_tpu_torch.obs.trace import add_profile_flag, start_profile
from dgmc_tpu_torch.resilience.supervisor import (add_supervisor_args,
                                                  supervise_cli)
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import (HostBatches, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import (GraphPair, PairLoader, PrefetchLoader,
                                       pad_pair_batch)

__all__ = ['NUM_NODES', 'NUM_EDGES', 'parse_args', 'build', 'noise_seed',
           'real_eval', 'main']

#: The padded graph size of every batch (the JAX CLI's).
NUM_NODES, NUM_EDGES = 80, 640


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.experiments.pascal_pf',
        description=__doc__.split('\n\n')[0])
    p.add_argument('--dim', type=int, default=256)
    p.add_argument('--rnd_dim', type=int, default=64)
    p.add_argument('--num_layers', type=int, default=2)
    p.add_argument('--num_steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=0.001)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--epochs', type=int, default=32)
    p.add_argument('--data_root', type=str,
                   default=os.path.join('data', 'PascalPF'),
                   help='PF-PASCAL dataset directory (the zero-shot eval '
                        'is disabled when it is missing)')
    p.add_argument('--synthetic_eval', type=int, default=0,
                   help='also evaluate on this many held-out synthetic '
                        'pairs per epoch (a disjoint generator stream)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        'PyTorch path)')
    p.add_argument('--metrics_log', type=str, default=None,
                   help='append per-epoch metrics to this JSONL file')
    p.add_argument('--profile', type=str, default=None,
                   help='write a torch.profiler trace of one training epoch '
                        '(the second) into this directory')
    precision.add_precision_args(p)
    add_obs_flag(p)
    add_profile_flag(p)
    add_supervisor_args(p)
    return p.parse_args(argv)


def build(args):
    """``(model, train_loader, transform)``: the model on the CPU with
    flax-default weights drawn from a generator seeded with
    ``args.seed``, computing under ``args``' precision policy (its
    parameters float32 under either)."""
    transform = Compose([Constant(), KNNGraph(k=8), Cartesian()])
    train_dataset = RandomGraphPairs(30, 60, 0, 20, transform=transform,
                                     seed=args.seed)
    train_loader = PairLoader(train_dataset, args.batch_size, shuffle=True,
                              seed=args.seed, num_nodes=NUM_NODES,
                              num_edges=NUM_EDGES)
    prec = precision.from_args(args)
    psi_1 = SplineCNN(1, args.dim, 2, args.num_layers, cat=False,
                      dropout=0.0, dtype=prec)
    psi_2 = SplineCNN(args.rnd_dim, args.rnd_dim, 2, args.num_layers,
                      cat=True, dropout=0.0, dtype=prec)
    model = DGMC(psi_1, psi_2, num_steps=args.num_steps, k=-1,
                 generator=torch.Generator().manual_seed(args.seed),
                 dtype=prec)
    return model, train_loader, transform


def noise_seed(seed, split, epoch, index):
    """The indicator-noise seed of one batch: disjoint for the train
    (``split`` 0), synthetic eval (1) and real eval (2) streams, every
    epoch and batch."""
    return ((seed * 2 + split) * 10_007 + epoch) * 100_003 + index


def main(argv=None, hook=None):
    """Train as the module docstring says; returns the train state.
    ``hook(kind, index, out)``, if given, is called after every train
    step (``kind='train'``), synthetic eval batch (``'eval'``) and real
    eval pair (``'real_eval'``) with its metrics."""
    args = parse_args(argv)
    if args.supervise:
        # Crash/hang recovery (resilience/supervisor.py) before anything
        # touches the device. This CLI has no --ckpt_dir, so a restart
        # re-runs from scratch.
        raise SystemExit(supervise_cli(
            'dgmc_tpu_torch.experiments.pascal_pf', args, argv,
            ladder=('f32',)))
    device = resolve_device(args.device)
    precision.apply(precision.from_args(args))
    model, train_loader, transform = build(args)
    model.to(device)
    state = create_train_state(model, learning_rate=args.lr)
    step = make_train_step(model, loss_on_s0=True)

    try:
        test_datasets = [PascalPF(args.data_root, c, transform)
                         for c in CATEGORIES]
    except FileNotFoundError as e:
        print(f'[pascal_pf] real-data eval disabled: {e}')
        test_datasets = []

    eval_loader = None
    if args.synthetic_eval:
        eval_ds = RandomGraphPairs(30, 60, 0, 20, transform=transform,
                                   length=args.synthetic_eval,
                                   seed=args.seed + 10_000)
        eval_loader = PairLoader(eval_ds, args.batch_size, shuffle=False,
                                 num_nodes=NUM_NODES, num_edges=NUM_EDGES)

    eval_step = make_eval_step(model) if eval_loader or test_datasets \
        else None
    train_batches = PrefetchLoader(HostBatches(train_loader, device), 2)
    eval_batches = (PrefetchLoader(HostBatches(eval_loader, device), 2)
                    if eval_loader else None)
    # The cost count's example batch, collated before the observer (its
    # collation is not the run's) and without moving the loader's streams.
    batch0 = train_loader.first_batch() if args.obs_dir else None
    # Before the first step is captured (the probe switch is read then).
    obs = RunObserver(args.obs_dir, probes=args.probes,
                      watchdog_deadline_s=args.watchdog_deadline,
                      obs_port=args.obs_port)
    with MetricLogger(args.metrics_log) as logger, obs:
        obs.attach_anomaly()
        obs.attach_slo(args.slo)
        # The per-stage FLOPs and bytes and the MFU account in
        # <obs-dir>/efficiency.json (obs/cost.py), before the capture.
        if batch0 is not None:
            obs.record_cost('train_step', step, state, batch0,
                            noise_seed(args.seed, 0, 1, 0))
        prof = obs.attach_profiler(
            start_profile(args.profile_dir, steps=args.profile_steps))
        for epoch in range(1, args.epochs + 1):
            train_loader.dataset.set_epoch(epoch)
            state, loss = _epoch(args, epoch, state, step, train_batches,
                                 eval_batches, eval_step, device, logger,
                                 obs, hook)
            if test_datasets:
                seeds = (noise_seed(args.seed, 2, epoch, i)
                         for i in range(1 << 30))
                accs = [100 * real_eval(ds, eval_step, device, seeds, hook)
                        for ds in test_datasets]
                accs.append(sum(accs) / len(accs))
                print(' '.join(c[:5].ljust(5) for c in CATEGORIES) + ' mean')
                print(' '.join(f'{a:.1f}'.ljust(5) for a in accs),
                      flush=True)
                logger.log(epoch, mean_acc=accs[-1])
                obs.quality_eval('pascal_pf', step=epoch, loss=loss,
                                 hits1=accs[-1] / 100)
        prof.close()
    return state


def real_eval(ds, eval_step, device, seeds, hook=None):
    """Zero-shot accuracy on one PascalPF category: each pair alone,
    padded to the category's largest item and 8 edges a node (one
    compiled eval step for each such size), keypoint i matched to
    keypoint i. ``seeds`` yields each pair's seed."""
    n_pad = max(g.pos.shape[0] for g in ds.items.values())
    correct = torch.zeros((), device=device)
    n = 0.0
    for i, (g_s, g_t, y) in enumerate(ds.pair_graphs()):
        b = pad_pair_batch([GraphPair(s=g_s, t=g_t, y_col=y)], n_pad,
                           8 * n_pad)
        out = eval_step(b, next(seeds))
        if hook is not None:
            hook('real_eval', i, {k: v.clone() for k, v in out.items()})
        correct += out['correct']
        n += float(b.y_mask.sum())
    return eval_summary(n, hits1=correct)['hits1']


def _epoch(args, epoch, state, step, train_loader, eval_loader, eval_step,
           device, logger, obs, hook):
    """One training epoch and, with ``--synthetic_eval``, its held-out
    evaluation: the printed lines, the JSONL records and the observer's;
    returns ``(state, mean train loss)``. The loaders yield host
    :class:`~dgmc_tpu_torch.train.steps.DeviceBatch` es."""
    t0 = time.time()
    tot_loss = torch.zeros((), device=device)
    tot_correct = torch.zeros((), device=device)
    tot_n = 0.0
    profile = args.profile if epoch == min(2, args.epochs) else None
    with trace(profile), obs.compile_label(f'epoch{epoch}'):
        for i, batch in enumerate(train_loader):
            with obs.step():
                state, out = step(state, batch,
                                  noise_seed(args.seed, 0, epoch, i))
            if hook is not None:
                # The step's metrics are static: the next step overwrites
                # them.
                hook('train', i, {k: v.clone() for k, v in out.items()})
            n_b = float(batch.y_mask.sum())
            tot_loss += out['loss']
            tot_correct += out['acc'] * n_b
            tot_n += n_b
        if profile:
            float(tot_loss)  # the trace ends after the steps ran
    # The device's completion fence (the read below waits anyway).
    obs.fence_devices(tot_loss)
    loss = float(tot_loss) / len(train_loader)
    acc = float(tot_correct) / max(tot_n, 1.0)
    print(f'Epoch: {epoch:02d}, Loss: {loss:.4f}, Acc: {acc:.2f}, '
          f'{time.time() - t0:.1f}s', flush=True)
    logger.log(epoch, loss=loss, train_acc=acc)
    obs.log(epoch, loss=loss, train_acc=acc,
            epoch_s=round(time.time() - t0, 3))
    # The train split first: an eval split below overwrites the
    # headline, so the headline is the most meaningful split run.
    obs.quality_eval('pascal_pf_train', step=epoch, loss=loss, hits1=acc)
    obs.snapshot_memory(f'epoch{epoch}')

    if eval_loader is not None:
        correct = torch.zeros((), device=device)
        n = 0.0
        for i, b in enumerate(eval_loader):
            out = eval_step(b, noise_seed(args.seed, 1, epoch, i))
            if hook is not None:
                hook('eval', i, {k: v.clone() for k, v in out.items()})
            correct += out['correct']
            n += float(b.y_mask.sum())
        eval_acc = float(correct) / max(n, 1.0)
        print(f'Held-out synthetic: {100 * eval_acc:.2f}', flush=True)
        # A 0-1 fraction, as the JAX CLI logs it.
        logger.log(epoch, synthetic_eval_acc=eval_acc)
        obs.log(epoch, synthetic_eval_acc=eval_acc)
        obs.quality_eval('pascal_pf', step=epoch, loss=loss, hits1=eval_acc)
    return state, loss


if __name__ == '__main__':
    main()
