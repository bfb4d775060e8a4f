"""The keypoint experiments' data path and training step held against the
JAX package on the CPU: the PascalVOC loader's and WILLOW's loaders'
batches, WILLOW's zipped evaluation batches, and one PascalVOC training
step (loss on S_0 and S_L, every gradient) and eval step of dense DGMC
with SplineCNN ψ₁ (1024 → 16) and ψ₂ (8 → 8), Cartesian and
isotropic.

Flax weights are carried across by ``dgmc_tpu_torch.convert``, ψ₁'s
dropout is off on both sides, JAX's indicator noise is captured on ψ₂'s
source calls and injected as ``r_s`` (as ``tests/test_torch_dense.py``
does). Tolerances: batches equal; the loss within rtol 1e-5; each
gradient within 1e-4 of its largest |entry| (plus rtol 1e-4), the two
gradients zero analytically below 1e-6 in both (the dense tests'); the
eval step's counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.data import Cartesian as JCartesian
from dgmc_tpu.data import Compose as JCompose
from dgmc_tpu.data import Delaunay as JDelaunay
from dgmc_tpu.data import Distance as JDistance
from dgmc_tpu.data import FaceToEdge as JFaceToEdge
from dgmc_tpu.datasets import PascalVOCKeypoints as JVOC
from dgmc_tpu.datasets import WILLOWObjectClass as JWillow
from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import metrics as jmetrics
from dgmc_tpu.models.spline import SplineCNN as JaxSplineCNN
from dgmc_tpu.train import create_train_state as jax_create_state
from dgmc_tpu.utils import ConcatDataset as JConcat
from dgmc_tpu.utils import PairDataset as JPairDataset
from dgmc_tpu.utils import PairLoader as JPairLoader
from dgmc_tpu.utils import ValidPairDataset as JValid
from dgmc_tpu.utils import graph_limits as jgraph_limits
from dgmc_tpu.utils import pad_pair_batch as jpad_pair_batch
from dgmc_tpu.utils.data import GraphPair as JGraphPair
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.datasets import PascalVOCKeypoints, WILLOWObjectClass
from dgmc_tpu_torch.datasets.fixtures import write_voc, write_willow
from dgmc_tpu_torch.datasets.pascal_voc import CATEGORIES
from dgmc_tpu_torch.datasets.willow import CATEGORIES as WILLOW
from dgmc_tpu_torch.experiments import pascal, willow
from dgmc_tpu_torch.train.steps import loss_and_outputs, make_eval_step
from dgmc_tpu_torch.utils.data import (ConcatDataset, PairLoader,
                                       ValidPairDataset, graph_limits)

B, STEPS, DIM, RND = 4, 2, 16, 8
GRAPH_KEYS = ('x', 'senders', 'receivers', 'node_mask', 'edge_mask',
              'edge_attr')
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RandomFeatures:
    """Seeded random node features, the same in both packages (no
    cache)."""
    tag = None

    def __call__(self, image, kps):
        rng = np.random.RandomState(int(np.asarray(kps).sum() * 100) % 2**31)
        return rng.randn(len(kps), 1024).astype(np.float32)


def _transforms(isotropic):
    """The CLIs' keypoint transform in both packages."""
    return (JCompose([JDelaunay(), JFaceToEdge(),
                      JDistance() if isotropic else JCartesian()]),
            pascal.keypoint_transform(isotropic))


def _assert_batches_equal(jb, tb):
    for side in ('s', 't'):
        jg, tg = getattr(jb, side), getattr(tb, side)
        for k in GRAPH_KEYS:
            np.testing.assert_array_equal(tg[k], np.asarray(getattr(jg, k)))
    np.testing.assert_array_equal(tb.y, np.asarray(jb.y))
    np.testing.assert_array_equal(tb.y_mask, np.asarray(jb.y_mask))


@pytest.fixture(scope='module')
def voc_root(tmp_path_factory):
    return write_voc(str(tmp_path_factory.mktemp('voc')), seed=7, train=5,
                     val=2)


def _pascal_loaders(root, isotropic, batch_size=B, seed=0):
    """The CLI's training loader (per category ValidPairDataset(sample=True)
    concatenated, padded over both splits) in both packages."""
    jt, tt = _transforms(isotropic)
    jsets, tsets, jall, tall = [], [], [], []
    for c in CATEGORIES:
        for train in (True, False):
            j = JVOC(root, c, train=train, transform=jt,
                     features=RandomFeatures())
            t = PascalVOCKeypoints(root, c, train=train, transform=tt,
                                   features=RandomFeatures())
            jall.append(j)
            tall.append(t)
            if train:
                jsets.append(JValid(j, j, sample=True, seed=seed))
                tsets.append(ValidPairDataset(t, t, sample=True, seed=seed))
    limits = graph_limits(tall)
    assert limits == jgraph_limits(jall)
    return (JPairLoader(JConcat(jsets), batch_size, shuffle=True, seed=seed,
                        num_nodes=limits[0], num_edges=limits[1]),
            PairLoader(ConcatDataset(tsets), batch_size, shuffle=True,
                       seed=seed, num_nodes=limits[0], num_edges=limits[1]))


@pytest.mark.parametrize('isotropic', [False, True])
def test_pascal_loader_batches_equal_jax(voc_root, isotropic):
    jl, tl = _pascal_loaders(voc_root, isotropic, batch_size=16)
    assert len(jl) == len(tl) >= 2
    for _, jb, tb in zip(range(2), jl, tl):
        _assert_batches_equal(jb, tb)
        assert tb.s['edge_attr'].shape[-1] == (1 if isotropic else 2)


@pytest.fixture(scope='module')
def willow_sets(tmp_path_factory):
    root = write_willow(str(tmp_path_factory.mktemp('willow')), seed=2,
                        items=23)
    jt, tt = _transforms(False)
    return ([JWillow(root, c, transform=jt, features=RandomFeatures())
             for c in WILLOW],
            [WILLOWObjectClass(root, c, transform=tt,
                               features=RandomFeatures()) for c in WILLOW])


def test_willow_identity_pairs_loader_equals_jax(willow_sets):
    """A run's loader: all ordered pairs of each category's 20 training
    items with the identity ground truth (the JAX CLI's
    ``identity_pairs``), shuffled with the run's seed."""
    jw, tw = willow_sets
    args = willow.parse_args(['--batch_size', '64', '--seed', '3'])
    run, n, e = 2, 20, 96

    def j_identity(ds):
        pairs = JPairDataset(ds, ds, sample=False)

        class WithY:
            def __len__(self):
                return len(pairs)

            def __getitem__(self, i):
                p = pairs[i]
                return JGraphPair(s=p.s, t=p.t,
                                  y_col=np.arange(10, dtype=np.int64))
        return WithY()

    jl = JPairLoader(JConcat([j_identity(ds.shuffled_split(
        20, seed=args.seed + run)[0]) for ds in jw]), 64, shuffle=True,
        seed=args.seed + run, num_nodes=n, num_edges=e)
    tl = willow.run_loader(args, tw, run, n, e)
    assert len(tl) == len(jl) == -(-5 * 20 * 20 // 64)
    for _, jb, tb in zip(range(2), jl, tl):
        _assert_batches_equal(jb, tb)


class Perms:
    """Injected permutations in place of the eval's RandomState."""

    def __init__(self, perms):
        self.perms = list(perms)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert len(p) == n
        return p


def test_willow_zipped_eval_batches(willow_sets):
    """Each eval batch is the JAX CLI's: the zipped pairs of two
    permutations, ``eval_batch_size`` a step, the last padded with the
    sweep's first pair under a masked ground truth; sweeps repeat until
    ``test_samples`` keypoints are scored."""
    jw, tw = willow_sets
    _, jtest = jw[1].shuffled_split(20, seed=5)
    _, ttest = tw[1].shuffled_split(20, seed=5)
    assert len(ttest) == 3
    rng = np.random.RandomState(0)
    perms = [rng.permutation(3) for _ in range(4)]
    seen = []

    def eval_step(batch, seed):
        seen.append((batch, seed))
        return {'count': torch.tensor(float(batch.y_mask.sum())),
                'correct': torch.tensor(float(batch.y_mask[0].sum()))}

    acc = willow.zipped_eval(eval_step, ttest, Perms(perms), 2, 55, 20, 96,
                             torch.device('cpu'), iter(range(100)))
    # Two sweeps of 3 pairs (2 + 1 padded) score 60 >= 55 keypoints.
    assert [s for _, s in seen] == [0, 1, 2, 3]
    gt, masked = np.arange(10), np.full(10, -1)
    want = []
    for o1, o2 in (perms[:2], perms[2:]):
        pairs = [JGraphPair(s=jtest[int(i)], t=jtest[int(j)], y_col=gt)
                 for i, j in zip(o1, o2)]
        pad = JGraphPair(s=pairs[0].s, t=pairs[0].t, y_col=masked)
        want += [pairs[:2], [pairs[2], pad]]
    for (tb, _), chunk in zip(seen, want):
        _assert_batches_equal(jpad_pair_batch(chunk, 20, 96,
                                              native='never'), tb)
    assert acc == pytest.approx(40 / 60)


@pytest.fixture(scope='module', params=[False, True],
                ids=['cartesian', 'isotropic'])
def setup(request, voc_root):
    """One PascalVOC batch in both packages, the JAX model with its
    parameters, JAX's forward and its captured noise, and the converted
    port model (ψ₁'s dropout off)."""
    isotropic = request.param
    jl, tl = _pascal_loaders(voc_root, isotropic)
    jb, tb = next(iter(jl)), next(iter(tl))
    _assert_batches_equal(jb, tb)
    edge_dim = 1 if isotropic else 2
    jm = JaxDGMC(JaxSplineCNN(1024, DIM, edge_dim, 2, cat=False,
                              dropout=0.0),
                 JaxSplineCNN(RND, RND, edge_dim, 2, cat=True, dropout=0.0),
                 num_steps=STEPS, k=-1)
    jstate = jax_create_state(jm, jax.random.key(0), jb)
    params = jax.device_get(jstate.params)
    k_noise = jax.random.key(11)

    def loss_fn(params):
        seen = []

        def capture(next_fun, args, kwargs, context):
            if (context.module.name == 'psi_2'
                    and context.method_name == '__call__'):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(capture):
            S_0, S_L = jm.apply({'params': params}, jb.s, jb.t, y=jb.y,
                                y_mask=jb.y_mask, train=True,
                                rngs={'noise': k_noise})
        loss = (jmetrics.nll_loss(S_L, jb.y, jb.y_mask)
                + jmetrics.nll_loss(S_0, jb.y, jb.y_mask))
        return loss, (S_L, jnp.stack(seen[0::2]))

    (jloss, (S_L, r_s)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    args = pascal.parse_args(['--dim', str(DIM), '--rnd_dim', str(RND),
                              '--num_steps', str(STEPS), '--f32']
                             + (['--isotropic'] if isotropic else []))

    def model():
        tm = pascal.build_model(args, 1024)
        tm.psi_1.dropout = 0.0
        tm.load_state_dict(dgmc_from_flax(params))
        return tm

    return {'jb': jb, 'tb': tb, 'jloss': float(jloss), 'S_L': S_L,
            'r_s': torch.from_numpy(np.array(r_s)),
            'grads': dgmc_from_flax(jax.device_get(jgrads)),
            'model': model}


def test_pascal_train_step_matches_jax(setup):
    tm = setup['model']()
    assert setup['r_s'].shape[:2] == (STEPS, B)
    loss, *_ = loss_and_outputs(tm, setup['tb'], loss_on_s0=True,
                                r_s=setup['r_s'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), setup['jloss'], rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(setup['grads'])
    for name, w in setup['grads'].items():
        g = got[name].grad.numpy()
        if name in ZERO_GRAD:
            assert np.abs(g).max() < 1e-6 and np.abs(w.numpy()).max() < 1e-6
            continue
        scale = float(np.abs(w.numpy()).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_pascal_eval_step_counts_equal_jax(setup):
    out = make_eval_step(setup['model']())(setup['tb'], 0,
                                           r_s=setup['r_s'])
    jb = setup['jb']
    assert int(out['count']) == int(np.asarray(jb.y_mask).sum())
    assert int(out['correct']) == int(jmetrics.acc(
        setup['S_L'], jb.y, jb.y_mask, reduction='sum'))
