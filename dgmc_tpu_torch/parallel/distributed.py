"""Multi-process bring-up: one process (a rank) per card.

The JAX package brings up its distributed runtime so that
``jax.devices()`` spans every host and GSPMD inserts the collectives. The
port has no GSPMD: a rank drives one card, the world's ranks take the
place of ``jax.devices()`` and the world size that of
``jax.process_count()``, and every cross-rank sum is written out
(:mod:`~dgmc_tpu_torch.parallel.comm`).

Typical usage (the same script on every rank)::

    from dgmc_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed()    # torchrun's environment; a no-op solo
    mesh = make_mesh(model=2)   # the world's ranks as a 1 x 2 mesh

Without torchrun, pass ``coordinator_address`` (``host:port``),
``num_processes`` and ``process_id`` explicitly. The backend is an
argument: NCCL for CUDA tensors, gloo for CPU tensors; by default NCCL
where each rank has a card of its own, gloo otherwise (CPU ranks, or
ranks that share a card, which NCCL refuses).
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['initialize_distributed', 'is_coordinator', 'process_index',
           'process_count', 'host_obs_dir', 'local_batch_slice',
           'global_batch', 'default_backend', 'rank_device', 'barrier',
           'shutdown', 'add_distributed_args', 'from_args',
           'init_report_path']

_initialized = False

#: torchrun's environment, the port's counterpart of JAX's cluster
#: detection.
TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def _already_initialized():
    return dist.is_available() and dist.is_initialized()


def process_count():
    """The world size (1 without a process group)."""
    return dist.get_world_size() if _already_initialized() else 1


def process_index():
    """This rank (0 without a process group)."""
    return dist.get_rank() if _already_initialized() else 0


def default_backend(world_size, device=None):
    """``'nccl'`` where every rank can have a card of its own, else
    ``'gloo'`` (CPU ranks, no card, or more ranks than cards: NCCL
    refuses two ranks on one device)."""
    if device is not None and torch.device(device).type == 'cpu':
        return 'gloo'
    if not torch.cuda.is_available():
        return 'gloo'
    return 'nccl' if world_size <= torch.cuda.device_count() else 'gloo'


def _init_method(address):
    if address is None:
        return None
    return address if '://' in address else f'tcp://{address}'


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device=None,
                           deadline_s=None, hang_report_path=None):
    """Bring up the default process group (idempotent); returns the world
    size.

    With explicit arguments it calls ``init_process_group`` with
    ``init_method='tcp://<coordinator_address>'``, ``world_size`` and
    ``rank``; a failure raises, never carrying on as a single process.
    Without them it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with no such
    environment it is a no-op returning 1, so a script can call it
    unconditionally. A second call, or a launcher that already
    initialized the group, is benign. ``backend``: ``'nccl'`` or
    ``'gloo'``, else :func:`default_backend` for ``device``.

    ``deadline_s`` + ``hang_report_path`` put the bring-up under a
    :class:`~dgmc_tpu_torch.resilience.distributed_guard.FenceGuard`
    (phase ``distributed-init``): ``init_process_group``'s rendezvous
    blocks in C++ until every rank of the declared world joins (up to
    its own timeout, 30 minutes by default), so one absent rank holds
    all the others; the guard turns that into a ``hang_report.json`` and
    a ``FENCE_TIMEOUT_RC`` exit the supervisor restarts elastically."""
    global _initialized
    if _already_initialized():
        _initialized = True
        return dist.get_world_size()
    guard = contextlib.nullcontext()
    if deadline_s and hang_report_path:
        from dgmc_tpu_torch.resilience.distributed_guard import FenceGuard
        guard = FenceGuard(hang_report_path, deadline_s,
                           phase='distributed-init')
    with guard:
        _init_group(coordinator_address, num_processes, process_id,
                    backend, device)
    _initialized = True
    return process_count()


def _init_group(coordinator_address, num_processes, process_id, backend,
                device):
    explicit = (coordinator_address is not None
                or num_processes not in (None, 1)
                or process_id is not None)
    if explicit:
        world = -1 if num_processes is None else int(num_processes)
        try:
            dist.init_process_group(
                backend or default_backend(max(world, 1), device),
                init_method=_init_method(coordinator_address),
                world_size=world,
                rank=-1 if process_id is None else int(process_id))
        except RuntimeError as e:
            if 'twice' not in str(e):
                raise
    elif all(k in os.environ for k in TORCHRUN_ENV):
        try:
            dist.init_process_group(
                backend or default_backend(int(os.environ['WORLD_SIZE']),
                                           device),
                init_method='env://')
        except RuntimeError as e:
            if 'twice' not in str(e):
                raise


def shutdown():
    """Destroy the default process group where there is one."""
    global _initialized
    if _already_initialized():
        dist.destroy_process_group()
    _initialized = False


def rank_device(device=None):
    """The device this rank runs on: ``device`` where it names the CPU or
    an indexed card; else ``cuda:<LOCAL_RANK>`` under torchrun, else
    ``cuda:<rank % device_count>`` (``cuda`` without a process group).
    A CUDA device becomes the current one."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type != 'cuda':
        return dev
    if dev.index is None and torch.cuda.is_available():
        if 'LOCAL_RANK' in os.environ:
            dev = torch.device('cuda', int(os.environ['LOCAL_RANK']))
        elif _already_initialized():
            dev = torch.device('cuda',
                               dist.get_rank() % torch.cuda.device_count())
    if dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def is_coordinator():
    """True on the rank that writes checkpoints, metrics and stdout."""
    return process_index() == 0


def barrier():
    """Wait for every rank (a no-op without a process group)."""
    if _already_initialized():
        dist.barrier()


def host_obs_dir(obs_dir):
    """This rank's obs directory: ``obs_dir`` itself in a one-process run,
    ``obs_dir/host_<rank>`` otherwise (every rank records; ``python -m
    dgmc_tpu_torch.obs.aggregate <obs_dir>`` merges them). A falsy
    ``obs_dir`` passes through."""
    if not obs_dir or process_count() == 1:
        return obs_dir
    return os.path.join(obs_dir, f'host_{process_index()}')


def tree_map(fn, tree):
    """``fn`` over the array and tensor leaves of nested dicts, lists,
    tuples, named tuples and dataclasses (``None`` and other objects
    pass through)."""
    import dataclasses
    if tree is None:
        return None
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def cut(x, parts, index):
    """Block ``index`` of ``parts`` equal blocks of ``x``'s leading axis
    (which must divide evenly)."""
    n = x.shape[0]
    if n % parts:
        raise ValueError(f'batch axis {n} not divisible by {parts} '
                         f'processes')
    per = n // parts
    return x[index * per:(index + 1) * per]


def local_batch_slice(batch):
    """This rank's rows of a host batch whose leading axis is split over
    the ranks: rank ``p`` of ``n`` owns rows ``[p*B/n, (p+1)*B/n)``."""
    n, p = process_count(), process_index()
    if n == 1:
        return batch
    return tree_map(lambda x: cut(x, n, p) if np.ndim(x) else x, batch)


def global_batch(batch, mesh=None, axis=None, replicate=False):
    """This rank's part of a host batch that every rank holds whole (every
    rank runs the same loader), placed on its device (``mesh.device``,
    else :func:`rank_device`) as a
    :class:`~dgmc_tpu_torch.train.steps.DeviceBatch`: with ``replicate``
    all of it; otherwise its block of the leading axis over ``axis`` (the
    mesh's ``data`` axis by default; without a mesh, over the world, as
    :func:`local_batch_slice` cuts). JAX's callers pass each process's
    slice and get one array spanning the processes; a rank of the port
    holds only its part, so the cut is made here, from the whole."""
    from dgmc_tpu_torch.train.steps import batch_to_device
    if mesh is None:
        return batch_to_device(batch if replicate else
                               local_batch_slice(batch), rank_device())
    if replicate:
        return batch_to_device(batch, mesh.device)
    from dgmc_tpu_torch.parallel.mesh import DATA_AXIS
    from dgmc_tpu_torch.parallel.sharding import shard_batch
    return shard_batch(batch, mesh, DATA_AXIS if axis is None else axis)


def add_distributed_args(parser):
    """The CLIs' multi-process flags (JAX's, and the backend)."""
    parser.add_argument('--coordinator', type=str, default=None,
                        help='multi-process: coordinator address host:port '
                             "(torchrun's environment is read without it)")
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    parser.add_argument('--dist_backend', choices=['nccl', 'gloo'],
                        default=None,
                        help='process group backend (default: nccl where '
                             'every rank has a card of its own, else gloo)')


def init_report_path(obs_dir, num_processes=None, process_id=None):
    """Where a rank's guarded bring-up writes its ``hang_report.json``:
    the directory :func:`host_obs_dir` will give the rank once the group
    is up (``obs_dir/host_<process_id>`` in a world above one — torchrun's
    ``WORLD_SIZE`` and ``RANK`` without the flags — else ``obs_dir``), so
    that two ranks' reports never collide. ``None`` without an obs
    dir."""
    if not obs_dir:
        return None
    if num_processes is None and all(k in os.environ for k in TORCHRUN_ENV):
        num_processes = os.environ['WORLD_SIZE']
        process_id = os.environ['RANK']
    if num_processes is not None and int(num_processes) > 1:
        obs_dir = os.path.join(obs_dir, f'host_{int(process_id or 0)}')
    return os.path.join(obs_dir, 'hang_report.json')


def from_args(args):
    """:func:`initialize_distributed` from a CLI's flags; returns ``(world
    size, this rank's device)`` (the device ``args.device`` resolves to,
    the rank's card with several ranks). Under ``--fence-deadline`` with
    ``--obs-dir`` the bring-up is guarded (:func:`init_report_path`)."""
    from dgmc_tpu_torch import resolve_device
    nproc = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.dist_backend, device=args.device,
        deadline_s=getattr(args, 'fence_deadline', None),
        hang_report_path=init_report_path(
            getattr(args, 'obs_dir', None), args.num_processes,
            args.process_id))
    return nproc, resolve_device(rank_device(args.device) if nproc > 1
                                 else args.device)


@contextlib.contextmanager
def process_group(coordinator_address, num_processes, process_id,
                  backend=None, device=None):
    """:func:`initialize_distributed` for the block, the group destroyed
    after it."""
    initialize_distributed(coordinator_address, num_processes, process_id,
                           backend=backend, device=device)
    try:
        yield process_count()
    finally:
        shutdown()
