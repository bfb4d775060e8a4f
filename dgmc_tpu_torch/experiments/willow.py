"""WILLOW-ObjectClass transfer: pretrain on PascalVOC, then per-run
fine-tuning and evaluation on the five WILLOW categories.

``python -m dgmc_tpu_torch.experiments.willow --voc_root DIR
--willow_root DIR [--device cpu]``

The model and transforms are :mod:`~dgmc_tpu_torch.experiments.pascal`'s.
Pretraining runs ``--pre_epochs`` epochs over the 20 PascalVOC
categories' sampled valid pairs (the 2007 images of car and motorbike
left out: WILLOW's come from them), padded to at least 10 nodes and 90
edges. Then the parameters are snapshot and each of ``--runs`` runs
restores them in place with a fresh Adam
(:func:`~dgmc_tpu_torch.train.state.restore_params`: one captured train
step serves pretraining and every run), trains ``--epochs`` epochs on
all ordered pairs of 20 random items a category (identity ground truth
over the 10 keypoints), and evaluates each category's other items: two
independently shuffled orders zipped into pairs, ``--eval_batch_size``
pairs a step (the ragged last batch padded with pairs whose ground truth
is masked), sweeps repeated until ``--test_samples`` keypoints are
scored. Each run prints its five accuracies, the end a mean ± std table.
The defaults are the JAX CLI's (``dgmc_tpu/experiments/willow.py``).

The eval's permutations come from ``np.random.RandomState`` seeded by
:func:`eval_seed` from (seed, run, category): the JAX CLI seeds them
from its threefry key, which the port does not reproduce, so the two
evaluate different pair orders.

``--ckpt_dir`` saves the pretrained snapshot as step 0 and each finished
run's accuracies in ``runs.json`` (written atomically); a restart over
the directory restores the snapshot, skips pretraining and the runs
already done, and continues with the next run.

The run plane (the JAX CLI's flags, :mod:`~dgmc_tpu_torch.obs`):
``--obs-dir``, ``--probes``, ``--watchdog-deadline``, ``--obs-port`` and
``--slo`` as in ``dbp15k``; each train step is timed on the host (the
replay call), each pretraining epoch's summed loss is the device's
completion fence. ``--profile-dir`` / ``--profile-steps`` and
``--profile DIR`` (the first step of the second pretraining epoch, or
of the first run when pretraining is resumed) write ``torch.profiler``
Chrome traces.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.experiments.pascal import (GraphReport, build_model,
                                               keypoint_transform,
                                               timed_batches)
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.evalsum import eval_summary
from dgmc_tpu_torch.obs.observe import MetricLogger, trace
from dgmc_tpu_torch.obs.run import RunObserver, add_obs_flag
from dgmc_tpu_torch.obs.trace import add_profile_flag, start_profile
from dgmc_tpu_torch.resilience.supervisor import (add_supervisor_args,
                                                  supervise_cli)
from dgmc_tpu_torch.train.checkpoint import Checkpointer
from dgmc_tpu_torch.train.state import (create_train_state, restore_params,
                                        snapshot_params)
from dgmc_tpu_torch.train.steps import (HostBatches, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import (ConcatDataset, GraphPair,
                                       PairDataset, PairLoader,
                                       PrefetchLoader, ValidPairDataset,
                                       graph_limits, pad_pair_batch)
from dgmc_tpu_torch.utils.io import write_json_atomic

__all__ = ['NUM_KP', 'TRAIN_ITEMS', 'parse_args', 'noise_seed',
           'eval_seed', 'identity_pairs', 'run_loader', 'zipped_eval',
           'main']

NUM_KP = 10          # every WILLOW item has exactly 10 keypoints
TRAIN_ITEMS = 20     # training items per category and run


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.experiments.willow',
        description=__doc__.split('\n\n')[0])
    p.add_argument('--isotropic', action='store_true')
    p.add_argument('--dim', type=int, default=256)
    p.add_argument('--rnd_dim', type=int, default=128)
    p.add_argument('--num_layers', type=int, default=2)
    p.add_argument('--num_steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=0.001)
    p.add_argument('--batch_size', type=int, default=512)
    p.add_argument('--pre_epochs', type=int, default=15)
    p.add_argument('--epochs', type=int, default=15)
    p.add_argument('--runs', type=int, default=20)
    p.add_argument('--test_samples', type=int, default=100)
    p.add_argument('--voc_root', type=str,
                   default=os.path.join('data', 'PascalVOC-WILLOW'))
    p.add_argument('--willow_root', type=str,
                   default=os.path.join('data', 'WILLOW'))
    p.add_argument('--vgg_weights', type=str, default='random',
                   help="'random', 'none', or the path of converted .npz "
                        'weights')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--eval_batch_size', type=int, default=32,
                   help='test pairs evaluated per step')
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        'PyTorch path)')
    p.add_argument('--ckpt_dir', type=str, default=None,
                   help='pretrained-snapshot and finished-run directory: a '
                        'restart resumes at the next unfinished run')
    p.add_argument('--metrics_log', type=str, default=None,
                   help='append per-epoch and per-run metrics to this '
                        'JSONL file')
    p.add_argument('--profile', type=str, default=None,
                   help='write a torch.profiler trace of one training step '
                        'into this directory (the first of the second '
                        'pretraining epoch, or of the first run when '
                        'pretraining is resumed)')
    precision.add_precision_args(p)
    add_obs_flag(p)
    add_profile_flag(p)
    add_supervisor_args(p)
    return p.parse_args(argv)


def noise_seed(seed, split, run, epoch, index):
    """The random seed of one step: disjoint for pretraining (``run``
    0), every run, epoch and batch, and for the train (``split`` 0) and
    eval (1) streams."""
    return (((seed * 2 + split) * 1_009 + run) * 10_007
            + epoch) * 1_000_003 + index


def eval_seed(seed, run, category):
    """The NumPy seed of one run's permutations of one category's test
    items."""
    return (seed * 1_009 + run) * 31 + category


def identity_pairs(train_ds):
    """All ordered pairs of ``train_ds``'s items, each with the identity
    ground truth over the 10 keypoints."""
    pairs = PairDataset(train_ds, train_ds, sample=False)
    gt = np.arange(NUM_KP, dtype=np.int64)

    class WithY:
        def __len__(self):
            return len(pairs)

        def __getitem__(self, i):
            p = pairs[i]
            return GraphPair(s=p.s, t=p.t, y_col=gt)

    return WithY()


def run_loader(args, willow, run, num_nodes, num_edges):
    """Run ``run``'s training loader: identity pairs of the 20 items each
    category's split (seeded ``args.seed + run``) puts in training."""
    parts = [identity_pairs(ds.shuffled_split(
        TRAIN_ITEMS, seed=args.seed + run)[0]) for ds in willow]
    return PairLoader(ConcatDataset(parts), args.batch_size, shuffle=True,
                      seed=args.seed + run, num_nodes=num_nodes,
                      num_edges=num_edges)


def zipped_eval(eval_step, ds, rng, batch_size, test_samples, num_nodes,
                num_edges, device, seeds, hook=None):
    """Accuracy on ``ds``: sweeps of ``zip(rng.permutation(n),
    rng.permutation(n))`` pairs, ``batch_size`` a step (a short batch
    filled with the sweep's first pair under a ground truth of -1, which
    counts nothing), until ``test_samples`` keypoints are scored or a
    sweep scores none. ``seeds`` yields each step's seed."""
    gt = np.arange(NUM_KP, dtype=np.int64)
    eb = max(1, min(batch_size, len(ds)))
    correct = torch.zeros((), device=device)
    n = 0.0
    while n < test_samples:
        seen = n
        o1, o2 = rng.permutation(len(ds)), rng.permutation(len(ds))
        pairs = [GraphPair(s=ds[int(i)], t=ds[int(j)], y_col=gt)
                 for i, j in zip(o1, o2)]
        masked = GraphPair(s=pairs[0].s, t=pairs[0].t,
                           y_col=np.full(NUM_KP, -1, np.int64))
        for c in range(0, len(pairs), eb):
            chunk = pairs[c:c + eb]
            chunk += [masked] * (eb - len(chunk))
            batch = pad_pair_batch(chunk, num_nodes, num_edges)
            out = eval_step(batch, next(seeds))
            if hook is not None:
                hook('eval', None, {k: v.clone() for k, v in out.items()})
            correct += out['correct']
            n += float(batch.y_mask.sum())
            if n >= test_samples:
                return eval_summary(n, hits1=correct)['hits1']
        if n == seen:
            break
    return eval_summary(n, hits1=correct)['hits1']


def main(argv=None, hook=None):
    """Run the protocol as the module docstring says; returns the
    ``[runs, 5]`` accuracies (those of earlier invocations over
    ``--ckpt_dir`` included). ``hook(kind, index, payload)``, if given, is
    called with ``'snapshot'`` (0, ``{'model', 'state', 'params'}``) once
    the pretrained parameters are snapshot, ``'run_start'`` (run, None)
    after each run's restore, and with each step's metrics: ``'pretrain'``
    ((epoch, batch)), ``'train'`` ((run, epoch, batch)) and ``'eval'``."""
    args = parse_args(argv)
    if args.supervise:
        # Crash/hang/preemption recovery (resilience/supervisor.py)
        # before anything touches the device; restarts resume at the
        # next unfinished run through --ckpt_dir.
        raise SystemExit(supervise_cli(
            'dgmc_tpu_torch.experiments.willow', args, argv,
            ladder=('f32',)))
    device = resolve_device(args.device)
    precision.apply(precision.from_args(args))
    from dgmc_tpu_torch.datasets import (PascalVOCKeypoints, VGG16Features,
                                         WILLOWObjectClass)
    from dgmc_tpu_torch.datasets.pascal_voc import CATEGORIES as VOC
    from dgmc_tpu_torch.datasets.willow import CATEGORIES as WILLOW

    transform = keypoint_transform(args.isotropic)
    features = VGG16Features(weights=args.vgg_weights, device=device)

    # Pretraining data: PascalVOC without the 2007 car and motorbike
    # images, which WILLOW's come from.
    t0 = time.perf_counter()
    pretrain_sets = []
    for category in VOC:
        skip_2007 = category in ('car', 'motorbike')
        ds = PascalVOCKeypoints(
            args.voc_root, category, train=True, transform=transform,
            features=features,
            pre_filter=lambda g, s=skip_2007: g.num_nodes > 0 and not (
                s and (g.name or '').startswith('2007')))
        pretrain_sets.append(ValidPairDataset(ds, ds, sample=True,
                                              seed=args.seed))
    num_nodes, num_edges = graph_limits([s.dataset_s for s in pretrain_sets])
    num_nodes = max(num_nodes, NUM_KP)
    num_edges = max(num_edges, NUM_KP * (NUM_KP - 1))
    willow = [WILLOWObjectClass(args.willow_root, c, transform=transform,
                                features=features) for c in WILLOW]
    print(f'# data: {sum(len(s) for s in pretrain_sets)} VOC and '
          f'{sum(len(w) for w in willow)} WILLOW items in '
          f'{time.perf_counter() - t0:.2f}s (features '
          f'{features.seconds:.2f}s in {features.calls} extractions on '
          f'{device}); padded to {num_nodes} nodes / {num_edges} edges',
          flush=True)
    in_dim = pretrain_sets[0].dataset_s.num_node_features
    pretrain_loader = PairLoader(ConcatDataset(pretrain_sets),
                                 args.batch_size, shuffle=True,
                                 seed=args.seed, num_nodes=num_nodes,
                                 num_edges=num_edges)

    model = build_model(args, in_dim).to(device)
    state = create_train_state(model, learning_rate=args.lr)
    step = make_train_step(model, loss_on_s0=True)
    eval_step = make_eval_step(model)
    report = GraphReport(train_step=step, eval_step=eval_step)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    runs_path = (os.path.join(args.ckpt_dir, 'runs.json')
                 if args.ckpt_dir else None)
    done = []
    if runs_path and os.path.exists(runs_path):
        with open(runs_path) as f:
            done = json.load(f)

    # The cost count's example batch, collated before the observer and
    # without moving the loader's streams.
    batch0 = pretrain_loader.first_batch() if args.obs_dir else None
    # Before the first step is captured (the probe switch is read then).
    obs = RunObserver(args.obs_dir, probes=args.probes,
                      watchdog_deadline_s=args.watchdog_deadline,
                      obs_port=args.obs_port)
    # One --profile trace an invocation: see the module docstring.
    need_profile = args.profile

    def observed_step(state, batch, seed, arm):
        with trace(arm):
            with obs.step():
                state, out = step(state, batch, seed)
            if arm:
                float(out['loss'])  # the trace ends after the step ran
        return state, out

    with MetricLogger(args.metrics_log) as logger, obs:
        obs.attach_anomaly()
        obs.attach_slo(args.slo)
        # The per-stage FLOPs and bytes and the MFU account in
        # <obs-dir>/efficiency.json (obs/cost.py), before the capture.
        if batch0 is not None:
            obs.record_cost('train_step', step, state, batch0,
                            noise_seed(args.seed, 0, 0, 1, 0))
        prof = obs.attach_profiler(
            start_profile(args.profile_dir, steps=args.profile_steps))
        if ckpt is not None and ckpt.latest_step() is not None:
            state = ckpt.restore(model, state, 0)
            print(f'Resumed pretrained snapshot from {args.ckpt_dir} '
                  f'({len(done)} runs already complete).', flush=True)
        else:
            print('Pretraining model on PascalVOC...', flush=True)
            batches = PrefetchLoader(HostBatches(pretrain_loader, device), 2)
            for epoch in range(1, args.pre_epochs + 1):
                t0 = time.perf_counter()
                total = torch.zeros((), device=device)
                waits = []
                with obs.compile_label('pretrain'):
                    for i, batch in enumerate(timed_batches(batches,
                                                            waits)):
                        arm = need_profile if epoch == 2 and i == 0 \
                            else None
                        state, out = observed_step(state, batch, noise_seed(
                            args.seed, 0, 0, epoch, i), arm)
                        if arm:
                            need_profile = None
                        if hook is not None:
                            hook('pretrain', (epoch, i),
                                 {k: v.clone() for k, v in out.items()})
                        total += out['loss']
                # The device's completion fence (the read below waits).
                obs.fence_devices(total)
                loss = float(total) / len(pretrain_loader)
                print(f'Epoch: {epoch:02d}, Loss: {loss:.4f}, '
                      f'{time.perf_counter() - t0:.1f}s (waited '
                      f'{sum(waits):.1f}s for {len(waits)} batches)',
                      flush=True)
                report()
                logger.log(epoch, loss=loss, stage='pretrain')
                obs.log(epoch, loss=loss, stage='pretrain',
                        epoch_s=round(time.perf_counter() - t0, 3))
                obs.snapshot_memory(f'pretrain_epoch{epoch}')
            if ckpt is not None:
                ckpt.save(0, model, state)
        snapshot = snapshot_params(model)
        print('Done!', flush=True)
        if hook is not None:
            hook('snapshot', 0, {'model': model, 'state': state,
                                 'params': snapshot})

        for run in range(len(done) + 1, args.runs + 1):
            restore_params(state, model, snapshot)
            if hook is not None:
                hook('run_start', run, None)
            loader = PrefetchLoader(HostBatches(run_loader(
                args, willow, run, num_nodes, num_edges), device), 2)
            with obs.compile_label(f'run{run}'):
                for epoch in range(1, args.epochs + 1):
                    for i, batch in enumerate(loader):
                        state, out = observed_step(state, batch, noise_seed(
                            args.seed, 0, run, epoch, i), need_profile)
                        need_profile = None
                        if hook is not None:
                            hook('train', (run, epoch, i),
                                 {k: v.clone() for k, v in out.items()})
            seeds = (noise_seed(args.seed, 1, run, 0, j)
                     for j in range(1 << 30))
            accs = []
            for c, ds in enumerate(willow):
                _, test_ds = ds.shuffled_split(TRAIN_ITEMS,
                                               seed=args.seed + run)
                rng = np.random.RandomState(eval_seed(args.seed, run, c))
                accs.append(100 * zipped_eval(
                    eval_step, test_ds, rng, args.eval_batch_size,
                    args.test_samples, num_nodes, num_edges, device, seeds,
                    hook))
            report()
            print(f'Run {run:02d}:')
            print(' '.join(c.ljust(13) for c in WILLOW))
            print(' '.join(f'{a:.2f}'.ljust(13) for a in accs), flush=True)
            logger.log(run, stage='run', accs=accs)
            obs.log(run, stage='run', mean_acc=sum(accs) / len(accs))
            obs.quality_eval('willow', step=run,
                             hits1=sum(accs) / len(accs) / 100)
            obs.snapshot_memory(f'run{run}')
            done.append(accs)
            if runs_path:
                write_json_atomic(runs_path,
                                  [list(map(float, a)) for a in done])
        prof.close()
    all_accs = np.array(done)
    mean = all_accs.mean(axis=0)
    std = (all_accs.std(axis=0, ddof=1) if len(all_accs) > 1
           else np.zeros_like(mean))
    print('-' * 14 * 5)
    print(' '.join(c.ljust(13) for c in WILLOW))
    print(' '.join(f'{m:.2f} ± {s:.2f}'.ljust(13)
                   for m, s in zip(mean, std)), flush=True)
    return all_accs


if __name__ == '__main__':
    main()
