"""The port's multi-process bring-up (``dgmc_tpu_torch/parallel/
distributed.py``), the cases of ``tests/parallel/test_distributed.py``
with ``torch.distributed.init_process_group`` and the environment
monkeypatched: a no-op without a launcher, torchrun's environment read
(JAX's cluster detection), explicit arguments forwarded, a second call or
a launcher's group benign, a failed explicit request raised. Beside
them: the backend and device rules, the per-rank obs directory and
batch slice, the coordinator rule of checkpoints across two gloo ranks,
and the package's imports (no JAX)."""

import ast
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dgmc_tpu_torch.parallel import distributed
from dgmc_tpu_torch.parallel import (host_obs_dir, initialize_distributed,
                                     is_coordinator, local_batch_slice)
from tests.torch_dist_worker import ROOT, run_ranks


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(distributed, '_initialized', False)
    for k in (*distributed.TORCHRUN_ENV, 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def calls(monkeypatch):
    """``init_process_group``'s calls, recorded instead of made."""
    seen = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend=None, **kw: seen.append(
                            dict(backend=backend, **kw)))
    return seen


def test_real_environment_noop():
    """No launcher: a no-op returning 1, idempotent, rank 0 coordinates."""
    assert initialize_distributed() == 1
    assert initialize_distributed() == 1
    assert is_coordinator() and not dist.is_initialized()


def test_torchrun_environment_is_read(monkeypatch, calls):
    """With no arguments, torchrun's environment brings the group up
    (``env://``), the port's counterpart of JAX's cluster detection."""
    for k, v in zip(distributed.TORCHRUN_ENV,
                    ('1', '2', '127.0.0.1', '29500')):
        monkeypatch.setenv(k, v)
    initialize_distributed(device='cpu')
    assert calls == [{'backend': 'gloo', 'init_method': 'env://'}]


@pytest.mark.parametrize('kwargs', [
    dict(coordinator_address='host:1234', num_processes=4, process_id=2),
    dict(process_id=3),  # a rank alone still reaches the call
])
def test_explicit_args_are_forwarded(calls, kwargs):
    initialize_distributed(**kwargs, backend='gloo')
    (call,) = calls
    assert call['rank'] == kwargs['process_id']
    assert call['world_size'] == kwargs.get('num_processes', -1)
    assert call['init_method'] == (
        'tcp://host:1234' if 'coordinator_address' in kwargs else None)
    assert call['backend'] == 'gloo'


def test_launcher_initialized_group_is_benign(monkeypatch, calls):
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    assert initialize_distributed('host:1', 4, 0) == 4
    assert calls == []


def test_second_initialization_is_benign(monkeypatch):
    def twice(*a, **kw):
        raise RuntimeError('trying to initialize the default process group '
                           'twice!')
    monkeypatch.setattr(dist, 'init_process_group', twice)
    assert initialize_distributed('host:1', 2, 0, backend='gloo') == 1


@pytest.mark.parametrize('error', [
    RuntimeError('coordinator unreachable at host:1234'),
    dist.DistNetworkError('The client socket has timed out')])
def test_genuine_failures_propagate(monkeypatch, error):
    """An explicit multi-process request that cannot be honoured raises;
    it never degrades into isolated single-process jobs."""
    def broken(*a, **kw):
        raise error
    monkeypatch.setattr(dist, 'init_process_group', broken)
    with pytest.raises(RuntimeError, match=str(error)[:20]):
        initialize_distributed('host:1234', 4, 0, backend='gloo')


def test_default_backend(monkeypatch):
    assert distributed.default_backend(2, 'cpu') == 'gloo'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert distributed.default_backend(1) == 'nccl'
    # Two ranks on one card: NCCL refuses them, gloo takes them.
    assert distributed.default_backend(2) == 'gloo'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert distributed.default_backend(1) == 'gloo'


def test_rank_device(monkeypatch):
    assert distributed.rank_device('cpu') == torch.device('cpu')
    set_to = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'set_device', set_to.append)
    monkeypatch.setenv('LOCAL_RANK', '1')
    assert distributed.rank_device() == torch.device('cuda', 1)
    monkeypatch.delenv('LOCAL_RANK')
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_rank', lambda group=None: 3)
    assert distributed.rank_device() == torch.device('cuda', 1)
    assert distributed.rank_device('cuda:0') == torch.device('cuda', 0)
    assert set_to == [torch.device('cuda', i) for i in (1, 1, 0)]


def test_host_obs_dir_and_batch_slice(monkeypatch, tmp_path):
    batch = {'x': np.arange(8).reshape(4, 2), 'n': 3}
    assert host_obs_dir(str(tmp_path)) == str(tmp_path)
    assert local_batch_slice(batch) is batch
    monkeypatch.setattr(distributed, 'process_count', lambda: 2)
    monkeypatch.setattr(distributed, 'process_index', lambda: 1)
    assert host_obs_dir(str(tmp_path)) == os.path.join(str(tmp_path),
                                                       'host_1')
    assert host_obs_dir(None) is None
    got = local_batch_slice(batch)
    np.testing.assert_array_equal(got['x'], [[4, 5], [6, 7]])
    assert got['n'] == 3
    with pytest.raises(ValueError, match='not divisible by 2'):
        local_batch_slice({'x': np.zeros(3)})


def test_global_batch_places_slice_or_whole(monkeypatch):
    """``global_batch``: with ``replicate`` every rank's whole batch on its
    device; otherwise its block of the leading axis over ``axis`` (the
    data axis by default), or over the world without a mesh."""
    from tests.torch_parallel_jobs import bn_batch
    batch = bn_batch()

    class Mesh:
        device = torch.device('cpu')
        sizes = {'data': 4, 'model': 2}

        def axis_size(self, axis):
            return 1 if axis is None else self.sizes[axis]

        def axis_index(self, axis):
            return 0 if axis is None else {'data': 2, 'model': 1}[axis]

    def ys(b):
        return b.y.numpy()

    np.testing.assert_array_equal(
        ys(distributed.global_batch(batch, Mesh(), replicate=True)),
        batch.y)
    np.testing.assert_array_equal(ys(distributed.global_batch(
        batch, Mesh())), batch.y[4:6])
    np.testing.assert_array_equal(ys(distributed.global_batch(
        batch, Mesh(), axis='model')), batch.y[4:8])
    monkeypatch.setattr(distributed, 'rank_device',
                        lambda device=None: torch.device('cpu'))
    monkeypatch.setattr(distributed, 'process_count', lambda: 2)
    monkeypatch.setattr(distributed, 'process_index', lambda: 1)
    np.testing.assert_array_equal(ys(distributed.global_batch(batch)),
                                  batch.y[4:])
    np.testing.assert_array_equal(
        ys(distributed.global_batch(batch, replicate=True)), batch.y)


def test_checkpoint_coordinator_rule(tmp_path):
    """Rank 0 writes each step (its weights), rank 1 waits at the barrier
    and commits nothing, and both restore the same file."""
    out = run_ranks('tests.torch_parallel_jobs:checkpoint_job', 2,
                    str(tmp_path))
    (c0, s0, p0, files), (c1, s1, p1, _) = out
    assert (c0, c1) == ([1, 2], [])
    assert s0 == s1 == 3
    assert files == ['1', '2', 'manifests']
    for k, v in p0.items():
        np.testing.assert_array_equal(p1[k], v)
        assert (v == 21).all(), k


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_parallel_package_imports_no_jax():
    """The package and what its ranks run import torch and the port only
    (the whole port's walk is ``tests/test_torch_serve.py``'s)."""
    files = [os.path.join(ROOT, 'dgmc_tpu_torch', 'parallel', f)
             for f in sorted(os.listdir(os.path.join(ROOT, 'dgmc_tpu_torch',
                                                     'parallel')))
             if f.endswith('.py')]
    assert len(files) >= 7
    files += [os.path.join(ROOT, 'tests', f) for f in (
        'torch_parallel_jobs.py', 'torch_dist_worker.py')]
    for path in files:
        for name in _imports(path):
            root = name.split('.')[0]
            assert root not in ('jax', 'jaxlib', 'flax', 'optax', 'dgmc_tpu'), \
                (path, name)
