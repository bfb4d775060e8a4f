"""The port's host data layer (``dgmc_tpu_torch/utils/data.py``,
``dgmc_tpu_torch/native``) against the JAX package's
(``dgmc_tpu/utils/data.py``, ``dgmc_tpu/native``) on the same seeded
inputs: the pair datasets, the collation on both of its paths (arrays
bit-equal to JAX's NumPy path), its checks, the prefetch loader, the
host/device split of the upload, and the dense CLI with and without
prefetch. Tolerance: none; every array and value compared is exact.
"""

import functools
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from dgmc_tpu.utils import data as jdata
from dgmc_tpu_torch import native
from dgmc_tpu_torch.experiments import pascal_pf
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.train.steps import (DeviceBatch, HostBatches,
                                        batch_to_device, batch_to_host)
from dgmc_tpu_torch.utils import data

GRAPH_KEYS = ('x', 'senders', 'receivers', 'node_mask', 'edge_mask',
              'edge_attr')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores (the CLI test trains)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def toy_graph(pkg, n=4, c=3, perm=None, seed=0, edge_dim=None):
    """``tests/utils/test_data.py``'s toy graph, in either package: a
    path graph with both directions, random features, classes ``perm``
    (default ``0..n-1``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32)
    ei = np.array([[i, i + 1] for i in range(n - 1)]).T
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    attr = (None if edge_dim is None
            else rng.rand(ei.shape[1], edge_dim).astype(np.float32))
    y = np.arange(n) if perm is None else np.asarray(perm)
    return pkg.Graph(edge_index=ei, x=x, y=y, edge_attr=attr)


def both(**kw):
    """The same graph in the JAX package's and in the port's container."""
    return toy_graph(jdata, **kw), toy_graph(data, **kw)


def assert_pairs_equal(jp, tp):
    for a, b in ((jp.s, tp.s), (jp.t, tp.t)):
        for key in ('edge_index', 'x', 'y'):
            np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
    if jp.y_col is None:
        assert tp.y_col is None
    else:
        np.testing.assert_array_equal(tp.y_col, jp.y_col)


def assert_graphs_equal(jb, tb):
    """A JAX ``GraphBatch`` of NumPy arrays against the port's dict."""
    for key in GRAPH_KEYS:
        want = getattr(jb, key)
        if want is None:
            assert key not in tb
            continue
        got = tb[key]
        assert got.dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=key)


def test_graph_carries_the_jax_fields():
    g = data.Graph(edge_index=np.zeros((2, 0), np.int64),
                   pos=np.zeros((3, 2)), y=np.arange(3),
                   face=np.zeros((3, 1), np.int64), name='a')
    assert g.num_nodes == 3 and g.num_edges == 0
    assert [f for f in data.Graph.__dataclass_fields__] == [
        f for f in jdata.Graph.__dataclass_fields__]


@pytest.mark.parametrize('sample', [False, True])
def test_pair_dataset_lengths_and_pairs_match_jax(sample):
    """``test_data.py:25``: the product (``sample=False``) and one random
    target per source (``sample=True``, the same draws from one seed)."""
    jg, tg = zip(*(both(seed=i) for i in range(3)))
    jds = jdata.PairDataset(list(jg), list(jg), sample=sample, seed=4)
    tds = data.PairDataset(list(tg), list(tg), sample=sample, seed=4)
    assert len(tds) == len(jds) == (3 if sample else 9)
    for i in range(len(tds)):
        assert_pairs_equal(jds[i], tds[i])
    assert repr(tds).startswith('PairDataset(')


def test_valid_pair_dataset_y_col_under_permutation_matches_jax():
    """``test_data.py:34``: target classes permuted; ``y_col`` maps each
    source node to its class's position in the target."""
    perm = np.array([2, 0, 3, 1])
    js, ts = both()
    jt, tt = both(perm=perm)
    jds = jdata.ValidPairDataset([js], [jt])
    tds = data.ValidPairDataset([ts], [tt])
    assert len(tds) == len(jds) == 1
    assert_pairs_equal(jds[0], tds[0])
    np.testing.assert_array_equal(
        tds[0].y_col, [np.argwhere(perm == c)[0, 0] for c in range(4)])


@pytest.mark.parametrize('sample', [False, True])
def test_valid_pair_dataset_with_missing_classes_matches_jax(sample):
    """``test_data.py:49``: a source class missing from a target rules
    the pair out; the precomputed pairs, their per-source offsets and the
    sampled pairs equal JAX's."""
    classes = ([0, 1, 2, 5], [0, 1, 2, 3], [3, 2, 1, 0], [0, 1, 5, 3])
    jg, tg = zip(*(both(perm=p, seed=i) for i, p in enumerate(classes)))
    jds = jdata.ValidPairDataset(list(jg), list(jg[1:]), sample=sample,
                                 seed=2)
    tds = data.ValidPairDataset(list(tg), list(tg[1:]), sample=sample,
                                seed=2)
    np.testing.assert_array_equal(tds.pairs, jds.pairs)
    np.testing.assert_array_equal(tds.cumdeg, jds.cumdeg)
    assert len(tds) == len(jds)
    for i in range(len(tds)):
        if sample and tds.cumdeg[i] == tds.cumdeg[i + 1]:
            for ds in (jds, tds):   # source 0 has no valid partner
                with pytest.raises(IndexError):
                    ds[i]
            continue
        assert_pairs_equal(jds[i], tds[i])


def test_concat_dataset_and_graph_limits_match_jax():
    jg, tg = zip(*(both(n=3 + i, seed=i) for i in range(4)))
    jparts = [jdata.PairDataset(list(jg[:2]), list(jg[2:])),
              jdata.PairDataset(list(jg[1:]), list(jg[:1]))]
    tparts = [data.PairDataset(list(tg[:2]), list(tg[2:])),
              data.PairDataset(list(tg[1:]), list(tg[:1]))]
    jcat, tcat = jdata.ConcatDataset(jparts), data.ConcatDataset(tparts)
    assert len(tcat) == len(jcat) == 7
    for i in (*range(7), -1, -7):
        assert_pairs_equal(jcat[i], tcat[i])
    assert data.graph_limits([tg[:2], tg[2:]]) == jdata.graph_limits(
        [jg[:2], jg[2:]]) == (6, 10)


def _mixed_graphs(pkg, edge_dim):
    """Graphs of several sizes, one without features and one without
    edge attributes (zeros in the padded batch)."""
    gs = [toy_graph(pkg, n=n, seed=n, edge_dim=edge_dim) for n in (2, 5, 6)]
    gs[1].edge_attr = None
    gs.append(pkg.Graph(edge_index=np.array([[0, 2], [1, 0]]), x=None,
                        pos=np.zeros((3, 2))))
    return gs


@pytest.mark.parametrize('native_mode', ['auto', 'never'])
@pytest.mark.parametrize('edge_dim', [None, 2])
def test_pad_graphs_matches_jax_on_both_paths(native_mode, edge_dim):
    """Both of the port's paths give JAX's ``pad_graphs(..., native=
    'never')`` arrays bit for bit, dtypes included."""
    jb = jdata.pad_graphs(_mixed_graphs(jdata, edge_dim), 7, 12,
                          feat_dim=3, native='never')
    tb = data.pad_graphs(_mixed_graphs(data, edge_dim), 7, 12, feat_dim=3,
                         native=native_mode)
    assert_graphs_equal(jb, tb)


@pytest.mark.parametrize('native_mode', ['auto', 'never'])
@pytest.mark.parametrize('pairs_per_step', [1, 2])
def test_pad_pair_batch_matches_jax_on_both_paths(native_mode,
                                                  pairs_per_step):
    """``test_data.py:57``: the padded pair batch (own target sizes, a
    ground truth with -1 entries and one pair without any) equals JAX's
    NumPy path bit for bit."""
    def pairs(pkg):
        out = []
        for i in range(3):
            s = toy_graph(pkg, n=3 + i, seed=i)
            t = toy_graph(pkg, n=5 + i, seed=10 + i, edge_dim=1)
            y = (None if i == 1 else
                 np.array([(j + i) % 5 if j % 2 else -1
                           for j in range(3 + i)]))
            out.append(pkg.GraphPair(s=s, t=t, y_col=y))
        return out
    jb = jdata.pad_pair_batch(pairs(jdata), 6, 10, 8, 16, native='never',
                              pairs_per_step=pairs_per_step)
    tb = data.pad_pair_batch(pairs(data), 6, 10, 8, 16, native=native_mode,
                             pairs_per_step=pairs_per_step)
    assert_graphs_equal(jb.s, tb.s)
    assert_graphs_equal(jb.t, tb.t)
    for key in ('y', 'y_mask'):
        got, want = getattr(tb, key), np.asarray(getattr(jb, key))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tb.y.shape == (3 * pairs_per_step, 6)


@pytest.mark.parametrize('native_mode', ['auto', 'never'])
@pytest.mark.parametrize('field', ['x', 'edge_attr'])
def test_width_mismatch_raises_on_both_paths(native_mode, field):
    """``test_data.py:89``: a graph narrower than the batch's width raises
    on the native path (which would copy out of bounds) as on NumPy's."""
    good = toy_graph(data, n=4, c=3, edge_dim=2)
    bad = (toy_graph(data, n=4, c=2, seed=1, edge_dim=2) if field == 'x'
           else toy_graph(data, n=4, c=3, seed=1, edge_dim=1))
    with pytest.raises(ValueError):
        data.pad_graphs([good, bad], num_nodes=6, num_edges=10,
                        native=native_mode)


@pytest.mark.parametrize('native_mode', ['auto', 'never'])
def test_graph_or_ground_truth_over_the_padding_raises(native_mode):
    big = toy_graph(data, n=7)
    with pytest.raises(ValueError, match='padding|broadcast'):
        data.pad_graphs([toy_graph(data), big], 6, 20, native=native_mode)
    pair = data.GraphPair(s=toy_graph(data), t=toy_graph(data),
                          y_col=np.arange(7))
    with pytest.raises(ValueError):
        data.pad_pair_batch([pair], 6, 10, native=native_mode)


def test_collation_paths_are_recorded_and_required():
    """``'auto'`` takes the C++ library here (``g++`` builds it), built
    into the package's ``_build/`` and not beside its source;
    ``'never'`` the NumPy loop; each call records its path in the
    dispatch ledger; an unknown mode raises."""
    graphs = [toy_graph(data, seed=i) for i in range(2)]
    dispatch.reset()
    data.pad_graphs(graphs, 6, 10, native='require')
    assert dispatch.decisions()['collate']['path'] == 'native'
    data.pad_graphs(graphs, 6, 10, native='never')
    d = dispatch.decisions()['collate']
    assert (d['path'], d['reason']) == ('numpy', 'graphs:native=never')
    assert d['counts'] == {'native': 1, 'numpy': 1}
    lib = native.load_library()
    built = os.path.normpath(lib._name)
    assert os.sep + os.path.join('dgmc_tpu_torch', '_build') in built
    assert not any(f.endswith('.so') for f in os.listdir(
        os.path.dirname(native.__file__)))
    with pytest.raises(ValueError, match='native'):
        data.pad_graphs(graphs, 6, 10, native='always')


def test_require_without_the_library_raises(monkeypatch):
    graphs = [toy_graph(data)]
    monkeypatch.setattr(native, 'available', lambda: False)
    with pytest.raises(RuntimeError, match='unavailable'):
        data.pad_graphs(graphs, 6, 10, native='require')
    dispatch.reset()
    out = data.pad_graphs(graphs, 6, 10, native='auto')
    d = dispatch.decisions()['collate']
    assert (d['path'], d['reason']) == ('numpy',
                                        'graphs:library unavailable')
    assert out['x'].shape == (1, 6, 3)


def _loader(length=7, batch_size=2):
    gs = [toy_graph(data, n=3 + i % 3, seed=i) for i in range(length)]
    return data.PairLoader(data.PairDataset(gs, gs, sample=True),
                           batch_size=batch_size, shuffle=False)


def test_prefetch_loader_yields_what_the_loader_yields():
    """``test_data.py:101``, first half: a full iteration (the worker two
    batches ahead) yields the loader's batches in order."""
    pf = data.PrefetchLoader(_loader(), depth=2)
    assert len(pf) == 4
    got = list(pf)
    want = list(_loader())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in GRAPH_KEYS[:-1]:
            np.testing.assert_array_equal(g.s[key], w.s[key])
        np.testing.assert_array_equal(g.y_mask, w.y_mask)


def _workers():
    return [t for t in threading.enumerate() if t.name == 'PrefetchLoader']


def test_prefetch_loader_abandoned_iteration_frees_its_worker():
    """``test_data.py:101``, second half: a consumer that stops after one
    batch sets the stop event; the worker, blocked on the full queue,
    ends."""
    it = iter(data.PrefetchLoader(_loader(length=20), depth=1))
    next(it)
    assert _workers()
    it.close()
    deadline = time.time() + 5.0
    while _workers() and time.time() < deadline:
        time.sleep(0.02)
    assert not _workers()


def test_prefetch_loader_raises_the_workers_error():
    class Broken:
        def __len__(self):
            return 3

        def __iter__(self):
            yield 1
            raise KeyError('collation failed')

    it = iter(data.PrefetchLoader(Broken()))
    assert next(it) == 1
    with pytest.raises(KeyError, match='collation failed'):
        next(it)


def test_upload_splits_into_host_part_and_copy():
    """:func:`batch_to_host` validates and converts on the host (what
    the prefetch worker runs), :func:`batch_to_device` passes a batch
    already on its device through unchanged, and :class:`HostBatches`
    pins only for the card."""
    batch = next(iter(_loader()))
    host = batch_to_host(batch)
    assert isinstance(host, DeviceBatch)
    assert host.graph_s.x.device.type == 'cpu'
    assert host.graph_s.senders.dtype == torch.int64
    assert host.y.dtype == torch.int64 and host.y_mask.dtype == torch.bool
    np.testing.assert_array_equal(host.y.numpy(), batch.y)
    assert batch_to_device(host, 'cpu') is host
    assert host.graph_s.to('cpu') is host.graph_s
    again = batch_to_device(batch, 'cpu')
    for key in GRAPH_KEYS[:-1]:
        assert torch.equal(getattr(again.graph_s, key),
                           getattr(host.graph_s, key))
    assert not HostBatches(_loader(), 'cpu').pin_memory
    assert len(list(HostBatches(_loader(), 'cpu'))) == 4
    bad = data.pad_pair_batch([data.GraphPair(
        s=toy_graph(data), t=toy_graph(data), y_col=np.array([0, 1, 9]))],
        6, 10, native='never')
    with pytest.raises(ValueError, match='ground truth'):
        batch_to_host(bad)
    arrays = dict(batch.s, senders=batch.s['senders'] + 100)
    with pytest.raises(ValueError, match='senders'):
        GraphBatch.host(arrays)


def _cli_lines(capsys, monkeypatch, argv, prefetch):
    """The dense CLI's printed lines at tiny widths (timings cut), with
    its host batches as they are or run through a ``PrefetchLoader``."""
    with monkeypatch.context() as m:
        if prefetch:
            m.setattr(pascal_pf, 'HostBatches', lambda loader, device:
                      data.PrefetchLoader(HostBatches(loader, device), 2))
        pascal_pf.main(argv)
    return [re.sub(r', [0-9.]+s$', '', line)
            for line in capsys.readouterr().out.splitlines()]


def test_dense_cli_prints_the_same_with_and_without_prefetch(capsys,
                                                             monkeypatch):
    """``pascal_pf.main`` on the CPU, 2 epochs at small widths: the same
    lines (losses, accuracies, held-out accuracy) with its loaders run
    through a ``PrefetchLoader`` as without."""
    from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
    monkeypatch.setattr(pascal_pf, 'RandomGraphPairs',
                        functools.partial(RandomGraphPairs, length=64))
    argv = ['--device', 'cpu', '--f32', '--epochs', '2', '--dim', '8',
            '--rnd_dim', '4', '--num_steps', '1', '--batch_size', '16',
            '--synthetic_eval', '32']
    with_prefetch = _cli_lines(capsys, monkeypatch, argv, True)
    without = _cli_lines(capsys, monkeypatch, argv, False)
    assert with_prefetch == without
    assert sum(line.startswith('Epoch: ') for line in without) == 2
    assert sum(line.startswith('Held-out') for line in without) == 2
