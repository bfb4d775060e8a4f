"""The port's package surface held against the JAX package's on the CPU:
each package ``__all__`` (the download faults left out), the two names that had no definition
(``train.aggregate_eval``, ``train.init_variables``), the top-level
``DGMC`` reached without importing torch with the package, the deprecated
``train.observe`` alias, and ``utils/viz.py`` (``predicted_targets``
equal to JAX's, dense and sparse; ``plot_matches`` drawn on the Agg
backend with JAX's lines and colours). Everything compared here is
exact.
"""

import importlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

#: JAX names the port leaves out: the download faults (no download
#: exists in the port).
LEFT_OUT = {'arm_download_faults', 'consume_download_fault'}

PACKAGES = ['', '.ops', '.train', '.utils', '.data', '.models', '.obs',
            '.resilience', '.datasets']


@pytest.mark.parametrize('sub', PACKAGES, ids=lambda s: s or 'top')
def test_package_all_covers_jax(sub):
    want = set(importlib.import_module('dgmc_tpu' + sub).__all__)
    port = importlib.import_module('dgmc_tpu_torch' + sub)
    got = set(port.__all__)
    assert want - LEFT_OUT <= got, sorted(want - LEFT_OUT - got)
    for name in got:
        assert getattr(port, name) is not None, name


def test_top_level_imports_no_torch_until_dgmc_is_read():
    code = ('import sys, dgmc_tpu_torch, dgmc_tpu_torch.analysis; '
            'assert "torch" not in sys.modules, "torch imported"; '
            'cls = dgmc_tpu_torch.DGMC; '
            'assert "torch" in sys.modules; print(cls.__module__)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'dgmc_tpu_torch.models.dgmc'
    import dgmc_tpu_torch
    with pytest.raises(AttributeError):
        dgmc_tpu_torch.NotAName


def test_train_observe_is_the_obs_alias():
    from dgmc_tpu_torch.obs import observe
    from dgmc_tpu_torch.train import observe as alias
    for name in ('MetricLogger', 'StepTimer', 'trace'):
        assert getattr(alias, name) is getattr(observe, name)
    assert alias.__all__ == importlib.import_module(
        'dgmc_tpu.train.observe').__all__


def test_aggregate_eval_matches_jax():
    from dgmc_tpu.train import aggregate_eval as jax_aggregate
    from dgmc_tpu_torch.train import aggregate_eval
    totals = [{'count': 10.0, 'correct': 7.0, 'hits@10': 9.0, 'loss': 4.5},
              {'count': 6.0, 'correct': 2.0, 'hits@10': 5.0, 'loss': 3.0}]
    want = jax_aggregate(totals)
    assert aggregate_eval(totals) == want
    as_tensors = [{k: torch.tensor(v) for k, v in t.items()}
                  for t in totals]
    assert aggregate_eval(as_tensors) == want
    assert aggregate_eval([]) == jax_aggregate([]) == {}
    zero = [{'count': 0.0, 'correct': 0.0}]
    assert aggregate_eval(zero) == jax_aggregate(zero)


def test_init_variables_matches_jax_names_and_shapes():
    """The port's variables are JAX's (converted names and shapes), made
    afresh from the key: the same key twice gives the same tensors,
    another key others."""
    from dgmc_tpu.models import DGMC as JaxDGMC
    from dgmc_tpu.models import RelCNN as JaxRelCNN
    from dgmc_tpu.train import init_variables as jax_init
    from dgmc_tpu.utils.data import GraphPair, pad_pair_batch
    from dgmc_tpu.utils.data import Graph as JaxGraph
    from dgmc_tpu_torch.convert import dgmc_from_flax
    from dgmc_tpu_torch.models import DGMC, RelCNN
    from dgmc_tpu_torch.train import init_variables
    r = np.random.RandomState(0)

    def g():
        return JaxGraph(edge_index=r.randint(0, 12, (2, 30)),
                        x=r.randn(12, 6).astype(np.float32))
    batch = pad_pair_batch([GraphPair(s=g(), t=g(),
                                      y_col=np.arange(12))], 12, 30)
    jm = JaxDGMC(JaxRelCNN(6, 8, 2), JaxRelCNN(4, 4, 2), num_steps=0, k=3)
    want = dgmc_from_flax(jax.device_get(
        jax_init(jm, jax.random.key(0), batch)['params']))
    tm = DGMC(RelCNN(6, 8, 2), RelCNN(4, 4, 2), num_steps=0, k=3)
    got = {k: v.clone() for k, v in init_variables(tm, 0).items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    again = {k: v.clone() for k, v in init_variables(tm, 0).items()}
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = init_variables(tm, 1)
    assert not torch.equal(other['mlp_hidden_kernel'],
                           again['mlp_hidden_kernel'])
    gen = torch.Generator().manual_seed(0)
    assert all(torch.equal(v, again[k])
               for k, v in init_variables(tm, gen).items())


def _corr(seed, sparse):
    r = np.random.RandomState(seed)
    val = r.rand(2, 7, 4 if sparse else 9).astype(np.float32)
    idx = r.randint(0, 9, (2, 7, 4)) if sparse else None
    return val, idx


@pytest.mark.parametrize('sparse', [False, True])
def test_predicted_targets_match_jax(sparse):
    from dgmc_tpu.utils.viz import predicted_targets as jax_pred
    from dgmc_tpu_torch.models.dgmc import Correspondence
    from dgmc_tpu_torch.utils.viz import predicted_targets
    val, idx = _corr(3, sparse)
    want = jax_pred(types.SimpleNamespace(val=val, idx=idx))
    got = predicted_targets(Correspondence(
        torch.from_numpy(val), None if idx is None else torch.from_numpy(idx),
        torch.ones(2, 7, dtype=torch.bool), torch.ones(2, 9,
                                                       dtype=torch.bool)))
    np.testing.assert_array_equal(got, want)


def test_plot_matches_draws_jax_lines_on_agg():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from dgmc_tpu.utils.viz import plot_matches as jax_plot
    from dgmc_tpu_torch.utils.viz import plot_matches
    r = np.random.RandomState(4)
    pos_s, pos_t = r.rand(6, 2), r.rand(7, 2)
    pred = np.array([0, 3, -1, 6, 2, 9])
    y = np.array([0, 2, 1, -1, 2, 5])
    edges = np.array([[0, 1], [1, 2], [3, 4]])

    def lines(ax):
        return [(tuple(np.round(np.asarray(ln.get_xydata()), 9).ravel()),
                 ln.get_color()) for ln in ax.get_lines()]

    ax_j = jax_plot(pos_s, pos_t, pred, y=y, edges_s=edges, edges_t=edges)
    ax_t = plot_matches(torch.from_numpy(pos_s), torch.from_numpy(pos_t),
                        torch.from_numpy(pred), y=torch.from_numpy(y),
                        edges_s=edges, edges_t=torch.from_numpy(edges))
    assert lines(ax_t) == lines(ax_j)
    colours = [c for _, c in lines(ax_t)]
    assert colours.count('#2ca02c') == 2 and colours.count('#d62728') == 1
    plt.close('all')
