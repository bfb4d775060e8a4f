"""PascalVOC keypoint matching across 20 categories: train dense DGMC.

``python -m dgmc_tpu_torch.experiments.pascal --data_root DIR [--device cpu]``

SplineCNN ψ₁ (1024 VGG16 channels → ``--dim``, ``--num_layers`` layers,
no concat, dropout 0.5) and ψ₂ (``--rnd_dim`` → ``--rnd_dim``, concat)
over Delaunay graphs of the keypoints with Cartesian (or, with
``--isotropic``, Distance) edge pseudo-coordinates; dense DGMC with
``--num_steps`` consensus steps, trained with Adam on ``loss(S_0) +
loss(S_L)``. Per category a ``ValidPairDataset(sample=True)`` pairs each
training instance with a random instance holding all its keypoint
classes; the 20 are concatenated into one loader of ``--batch_size``
pairs, padded to the largest graph of every split. After each epoch,
each category's test pairs are sampled until ``--test_samples``
keypoints are scored; two lines print the per-category and mean
accuracies. The defaults are the JAX CLI's
(``dgmc_tpu/experiments/pascal.py``), its bf16 precision policy included
(``--f32`` computes in float32 throughout).

The data is the Berkeley keypoint annotations of PascalVOC
(:class:`~dgmc_tpu_torch.datasets.PascalVOCKeypoints`: the raw layout,
nothing downloaded) with node features from the VGG16 extractor on the
device (``--vgg_weights {random,none,PATH.npz}``: He-initialized
filters, zeros, or converted pretrained weights), extracted once per
instance at dataset build and cached under ``<data_root>/processed``.

The train and eval steps run compiled (a CUDA graph each on the card,
one per batch shape; each graph's static memory is printed after its
capture). Training batches are sampled, transformed (Qhull on every
access) and collated two ahead in a background thread; the epoch line
prints the seconds the loop waited for them. ``--ckpt_dir`` saves every
epoch and resumes from the newest restorable one; ``--metrics_log PATH``
appends one JSONL record an epoch (``loss``, ``mean_acc``).

The run plane (the JAX CLI's flags, :mod:`~dgmc_tpu_torch.obs`):
``--obs-dir``, ``--probes``, ``--watchdog-deadline``, ``--obs-port`` and
``--slo`` as in ``dbp15k``, built after a resume and before the first
capture; each train step is timed on the host (the replay call), the
epoch's summed loss is the device's completion fence.
``--profile-dir`` / ``--profile-steps`` and ``--profile DIR`` (the
second epoch run's training loop) write ``torch.profiler`` Chrome
traces.
"""

import argparse
import os
import time

import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Delaunay,
                                            Distance, FaceToEdge)
from dgmc_tpu_torch.experiments.pascal_pf import noise_seed
from dgmc_tpu_torch.models import precision
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.evalsum import eval_summary
from dgmc_tpu_torch.models.spline import SplineCNN
from dgmc_tpu_torch.obs.memory import captured_memory
from dgmc_tpu_torch.obs.observe import MetricLogger, trace
from dgmc_tpu_torch.obs.run import RunObserver, add_obs_flag
from dgmc_tpu_torch.obs.trace import add_profile_flag, start_profile
from dgmc_tpu_torch.resilience.supervisor import (add_supervisor_args,
                                                  supervise_cli)
from dgmc_tpu_torch.train.checkpoint import resume_or_init
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import (HostBatches, make_eval_step,
                                        make_train_step)
from dgmc_tpu_torch.utils.data import (ConcatDataset, PairLoader,
                                       PrefetchLoader, ValidPairDataset,
                                       graph_limits)

__all__ = ['parse_args', 'keypoint_transform', 'build_model', 'GraphReport',
           'timed_batches', 'sample_eval', 'main']


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.experiments.pascal',
        description=__doc__.split('\n\n')[0])
    p.add_argument('--isotropic', action='store_true')
    p.add_argument('--dim', type=int, default=256)
    p.add_argument('--rnd_dim', type=int, default=128)
    p.add_argument('--num_layers', type=int, default=2)
    p.add_argument('--num_steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=0.001)
    p.add_argument('--batch_size', type=int, default=512)
    p.add_argument('--epochs', type=int, default=15)
    p.add_argument('--test_samples', type=int, default=1000)
    p.add_argument('--data_root', type=str,
                   default=os.path.join('data', 'PascalVOC'))
    p.add_argument('--vgg_weights', type=str, default='random',
                   help="'random', 'none', or the path of converted .npz "
                        'weights')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        'PyTorch path)')
    p.add_argument('--ckpt_dir', type=str, default=None,
                   help='per-epoch checkpoint and resume directory')
    p.add_argument('--metrics_log', type=str, default=None,
                   help='append per-epoch metrics to this JSONL file')
    p.add_argument('--profile', type=str, default=None,
                   help='write a torch.profiler trace of one training epoch '
                        '(the second run) into this directory')
    precision.add_precision_args(p)
    add_obs_flag(p)
    add_profile_flag(p)
    add_supervisor_args(p)
    return p.parse_args(argv)


def keypoint_transform(isotropic):
    """Delaunay triangulation, its faces as undirected edges, and Distance
    (``isotropic``) or Cartesian pseudo-coordinates."""
    return Compose([Delaunay(), FaceToEdge(),
                    Distance() if isotropic else Cartesian()])


def build_model(args, in_dim):
    """The keypoint experiments' model on the CPU: flax-default weights
    drawn from a generator seeded with ``args.seed``, computing under
    ``args``' precision policy (its parameters float32 under either)."""
    prec = precision.from_args(args)
    edge_dim = 1 if args.isotropic else 2
    psi_1 = SplineCNN(in_dim, args.dim, edge_dim, args.num_layers,
                      cat=False, dropout=0.5, dtype=prec)
    psi_2 = SplineCNN(args.rnd_dim, args.rnd_dim, edge_dim, args.num_layers,
                      cat=True, dropout=0.0, dtype=prec)
    return DGMC(psi_1, psi_2, num_steps=args.num_steps, k=-1,
                generator=torch.Generator().manual_seed(args.seed),
                dtype=prec)


class GraphReport:
    """Prints each captured graph of the given steps once, after its
    capture: its seconds and static memory
    (:func:`~dgmc_tpu_torch.obs.memory.captured_memory`)."""

    def __init__(self, **steps):
        self.steps = steps
        self.seen = set()

    def __call__(self):
        for name, step in self.steps.items():
            c = step.jit.compiled
            for key, rec in ({} if c is None else c.records).items():
                if (name, key) in self.seen:
                    continue
                self.seen.add((name, key))
                mem = captured_memory(rec)
                print(f'# graph {name}: captured in {rec.capture_s:.2f}s, '
                      f'static memory {mem["total_bytes"] / 2**30:.3f} GiB '
                      f'(args {mem["argument_bytes"] >> 20} MiB, outputs '
                      f'{mem["output_bytes"] >> 20} MiB, pool temps '
                      f'{mem["temp_bytes"] >> 20} MiB)', flush=True)


def timed_batches(loader, waits):
    """``loader``'s batches; appends the seconds each one was waited for
    to ``waits``."""
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield batch


def sample_eval(eval_step, pairs, args, num_nodes, num_edges, device, seeds,
                hook=None):
    """One category's test accuracy: batches of ``pairs`` (a sampled
    :class:`ValidPairDataset`, a new draw each pass) until
    ``args.test_samples`` keypoints are scored, stopping early on a
    split with nothing to score. ``seeds`` yields each batch's seed."""
    loader = HostBatches(PairLoader(pairs, args.batch_size, shuffle=False,
                                    num_nodes=num_nodes,
                                    num_edges=num_edges), device)
    correct = torch.zeros((), device=device)
    n = 0.0
    while n < args.test_samples:
        seen = n
        for batch in loader:
            out = eval_step(batch, next(seeds))
            if hook is not None:
                hook('eval', None, {k: v.clone() for k, v in out.items()})
            correct += out['correct']
            n += float(batch.y_mask.sum())
            if n >= args.test_samples:
                break
        if n == seen:
            break
    return eval_summary(n, hits1=correct)['hits1']


def main(argv=None, hook=None):
    """Train as the module docstring says; returns the train state.
    ``hook(kind, index, out)``, if given, is called after every train
    step (``kind='train'``) and eval batch (``'eval'``) with its
    metrics."""
    args = parse_args(argv)
    if args.supervise:
        # Crash/hang/preemption recovery (resilience/supervisor.py)
        # before anything touches the device; restarts resume through
        # --ckpt_dir.
        raise SystemExit(supervise_cli(
            'dgmc_tpu_torch.experiments.pascal', args, argv,
            ladder=('f32',)))
    device = resolve_device(args.device)
    precision.apply(precision.from_args(args))
    from dgmc_tpu_torch.datasets import PascalVOCKeypoints, VGG16Features
    from dgmc_tpu_torch.datasets.pascal_voc import CATEGORIES

    transform = keypoint_transform(args.isotropic)
    features = VGG16Features(weights=args.vgg_weights, device=device)
    pre_filter = lambda g: g.num_nodes > 0  # noqa: E731

    t0 = time.perf_counter()
    train_sets, test_sets = [], []
    for category in CATEGORIES:
        tr, te = (PascalVOCKeypoints(args.data_root, category, train=train,
                                     transform=transform,
                                     pre_filter=pre_filter,
                                     features=features)
                  for train in (True, False))
        train_sets.append(ValidPairDataset(tr, tr, sample=True,
                                           seed=args.seed))
        test_sets.append(ValidPairDataset(te, te, sample=True,
                                          seed=args.seed + 1))
    num_nodes, num_edges = graph_limits([s.dataset_s for s in train_sets] +
                                        [s.dataset_s for s in test_sets])
    print(f'# data: {sum(len(s) for s in train_sets)} train / '
          f'{sum(len(s.dataset_s) for s in test_sets)} test instances in '
          f'{time.perf_counter() - t0:.2f}s (features '
          f'{features.seconds:.2f}s in {features.calls} extractions on '
          f'{device}); padded to {num_nodes} nodes / {num_edges} edges',
          flush=True)
    in_dim = train_sets[0].dataset_s.num_node_features
    train_loader = PairLoader(ConcatDataset(train_sets), args.batch_size,
                              shuffle=True, seed=args.seed,
                              num_nodes=num_nodes, num_edges=num_edges)

    model = build_model(args, in_dim).to(device)
    state = create_train_state(model, learning_rate=args.lr)
    step = make_train_step(model, loss_on_s0=True)
    eval_step = make_eval_step(model)
    report = GraphReport(train_step=step, eval_step=eval_step)
    batches = PrefetchLoader(HostBatches(train_loader, device), 2)

    with MetricLogger(args.metrics_log) as logger:
        ckpt, state, start_epoch = resume_or_init(args.ckpt_dir, state,
                                                  model)
        # The cost count's example batch, collated before the observer
        # and without moving the loader's streams.
        batch0 = train_loader.first_batch() if args.obs_dir else None
        obs = RunObserver(args.obs_dir, probes=args.probes,
                          watchdog_deadline_s=args.watchdog_deadline,
                          obs_port=args.obs_port)
        with obs:
            # The per-stage FLOPs and bytes and the MFU account in
            # <obs-dir>/efficiency.json (obs/cost.py), before the capture.
            if batch0 is not None:
                obs.record_cost('train_step', step, state, batch0,
                                noise_seed(args.seed, 0, start_epoch, 0))
            state = _train(args, start_epoch, state, model, step, eval_step,
                           report, batches, train_loader, test_sets,
                           num_nodes, num_edges, device, logger, obs, ckpt,
                           hook)
    return state


def _train(args, start_epoch, state, model, step, eval_step, report,
           batches, train_loader, test_sets, num_nodes, num_edges, device,
           logger, obs, ckpt, hook):
    """The epochs from ``start_epoch``: training, the sampled evaluation,
    the printed lines, the JSONL and observer records, the checkpoints."""
    from dgmc_tpu_torch.datasets.pascal_voc import CATEGORIES
    obs.attach_anomaly()
    obs.attach_slo(args.slo)
    prof = obs.attach_profiler(
        start_profile(args.profile_dir, steps=args.profile_steps))
    if start_epoch > 1:
        logger.log(start_epoch - 1, event='resume')
    profile_epoch = min(start_epoch + 1, args.epochs)
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.perf_counter()
        total = torch.zeros((), device=device)
        waits = []
        profile = args.profile if epoch == profile_epoch else None
        with trace(profile), obs.compile_label(f'epoch{epoch}'):
            for i, batch in enumerate(timed_batches(batches, waits)):
                with obs.step():
                    state, out = step(state, batch,
                                      noise_seed(args.seed, 0, epoch, i))
                if hook is not None:
                    hook('train', i, {k: v.clone() for k, v in out.items()})
                total += out['loss']
            if profile:
                float(total)  # the trace ends after the steps ran
        # The device's completion fence (the read below waits anyway).
        obs.fence_devices(total)
        loss = float(total) / len(train_loader)
        print(f'Epoch: {epoch:02d}, Loss: {loss:.4f}, '
              f'{time.perf_counter() - t0:.1f}s (waited {sum(waits):.1f}s '
              f'for {len(waits)} batches)', flush=True)
        report()

        seeds = (noise_seed(args.seed, 1, epoch, j)
                 for j in range(1 << 30))
        accs = [100 * sample_eval(eval_step, ds, args, num_nodes,
                                  num_edges, device, seeds, hook)
                for ds in test_sets]
        accs.append(sum(accs) / len(accs))
        print(' '.join(c[:5].ljust(5) for c in CATEGORIES) + ' mean')
        print(' '.join(f'{a:.1f}'.ljust(5) for a in accs), flush=True)
        report()
        logger.log(epoch, loss=loss, mean_acc=accs[-1])
        obs.log(epoch, loss=loss, mean_acc=accs[-1],
                epoch_s=round(time.perf_counter() - t0, 3))
        obs.quality_eval('pascal', step=epoch, loss=loss,
                         hits1=accs[-1] / 100)
        obs.snapshot_memory(f'epoch{epoch}')
        if ckpt is not None:
            ckpt.save(epoch, model, state)
    prof.close()
    return state


if __name__ == '__main__':
    main()
