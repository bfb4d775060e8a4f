"""The port's dense training slice held against the JAX package on the
CPU: synthetic PascalPF pairs and their collation, the dense DGMC forward
with SplineCNN ψ₁/ψ₂, one train step (loss, per-pair loss, accuracy and
every gradient), the Adam update, and a short run of the port's CLI.

Flax weights are carried across by ``dgmc_tpu_torch.convert``; JAX's
indicator noise is captured with ``flax.linen.intercept_methods`` on ψ₂'s
source-side calls and injected as ``r_s``.

Tolerances: host data must be array-equal. Correspondences are softmax
probabilities after three consensus steps of float32 products summed in
other orders: atol 1e-5. The loss agrees to rtol 1e-5. Gradients sum
thousands of such terms through three steps: each tensor within 1e-4 of
its largest |gradient| (plus rtol 1e-4), and the two whose gradient is
zero analytically (``ZERO_GRAD``) below 1e-6 in both. Adam agrees with optax to
rtol/atol 1e-6: the same update in float32, rounded in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.data import Cartesian as JCartesian
from dgmc_tpu.data import Compose as JCompose
from dgmc_tpu.data import Constant as JConstant
from dgmc_tpu.data import KNNGraph as JKNNGraph
from dgmc_tpu.data import RandomGraphPairs as JRandomGraphPairs
from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models.dgmc import Correspondence as JaxCorrespondence
from dgmc_tpu.models import metrics as jmetrics
from dgmc_tpu.models.spline import SplineCNN as JaxSplineCNN
from dgmc_tpu.train import create_train_state as jax_create_state
from dgmc_tpu.train import make_train_step as jax_train_step
from dgmc_tpu.utils import PairLoader as JPairLoader
from dgmc_tpu.utils import pad_pair_batch as jax_pad_pair_batch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            KNNGraph)
from dgmc_tpu_torch.experiments import pascal_pf
from dgmc_tpu_torch.models import dgmc as dgmc_module
from dgmc_tpu_torch.models import metrics
from dgmc_tpu_torch.models.dgmc import DGMC, Correspondence
from dgmc_tpu_torch.models.spline import SplineCNN
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.train.state import apply_gradients, create_train_state
from dgmc_tpu_torch.train.steps import (batch_to_device, loss_and_outputs,
                                        make_eval_step, make_train_step)
from dgmc_tpu_torch.utils.data import PairLoader, pad_pair_batch

N, E, B, STEPS, DIM, RND = 16, 128, 4, 3, 16, 8
GRAPH_KEYS = ('x', 'senders', 'receivers', 'node_mask', 'edge_mask',
              'edge_attr')
# Parameters whose gradient is zero but for rounding, in both packages:
# ψ₂'s final bias shifts o_s and o_t alike and the consensus MLP sees only
# their difference; the MLP's output bias shifts a whole row of S_hat,
# which the row softmax cancels.
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tensors here are small, and the suite's
    parallel workers would otherwise oversubscribe the cores (a training
    loop here ran ~40x slower with 8 threads per worker under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _datasets(length=B, seed=3):
    """The same small pair stream in both packages (5-10 inliers, 0-3
    outliers, the PascalPF transforms)."""
    jt = JCompose([JConstant(), JKNNGraph(k=8), JCartesian()])
    tt = Compose([Constant(), KNNGraph(k=8), Cartesian()])
    return (JRandomGraphPairs(5, 10, 0, 3, transform=jt, length=length,
                              seed=seed),
            RandomGraphPairs(5, 10, 0, 3, transform=tt, length=length,
                             seed=seed))


def _assert_batches_equal(jb, tb):
    for side in ('s', 't'):
        jg, tg = getattr(jb, side), getattr(tb, side)
        for k in GRAPH_KEYS:
            np.testing.assert_array_equal(tg[k], np.asarray(getattr(jg, k)))
    np.testing.assert_array_equal(tb.y, np.asarray(jb.y))
    np.testing.assert_array_equal(tb.y_mask, np.asarray(jb.y_mask))


def test_random_pairs_and_collation_equal_jax():
    jds, tds = _datasets(length=6)
    for epoch in (0, 2):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            jp, tp = jds[i], tds[i]
            for a, b in ((jp.s, tp.s), (jp.t, tp.t)):
                for k in ('edge_index', 'x', 'edge_attr', 'pos'):
                    np.testing.assert_array_equal(getattr(b, k),
                                                  getattr(a, k))
            np.testing.assert_array_equal(tp.y_col, jp.y_col)
        _assert_batches_equal(
            jax_pad_pair_batch([jds[i] for i in range(6)], N, E,
                               native='never'),
            pad_pair_batch([tds[i] for i in range(6)], N, E))


def test_pair_loader_batches_equal_jax():
    """Shuffled order and the padded short last batch (5 pairs, batch 2)."""
    jds, tds = _datasets(length=5)
    jl = JPairLoader(jds, 2, shuffle=True, seed=1, num_nodes=N,
                     num_edges=E)
    tl = PairLoader(tds, 2, shuffle=True, seed=1, num_nodes=N, num_edges=E)
    assert len(jl) == len(tl) == 3
    # The JAX loader collates natively where it can; the arrays are the
    # same either way.
    for jb, tb in zip(jl, tl):
        _assert_batches_equal(jb, tb)
    assert not tb.y_mask[1:].any()


@pytest.fixture(scope='module')
def setup():
    """One batch, a JAX dense DGMC with its parameters, the converted
    port model, and JAX's per-step noise for the train step's key."""
    jds, tds = _datasets()
    jb = jax_pad_pair_batch([jds[i] for i in range(B)], N, E,
                            native='never')
    tb = pad_pair_batch([tds[i] for i in range(B)], N, E)
    jm = JaxDGMC(JaxSplineCNN(1, DIM, 2, 2, cat=False, dropout=0.0),
                 JaxSplineCNN(RND, RND, 2, 2, cat=True, dropout=0.0),
                 num_steps=STEPS, k=-1)
    key = jax.random.key(7)
    jstate = jax.jit(lambda b: jax_create_state(jm, jax.random.key(0),
                                                b))(jb)
    params = jax.device_get(jstate.params)

    def forward(params, jb, k_noise):
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
        # Per step ψ₂ runs on the source (noise) first, then the target.
        return S_0, S_L, jnp.stack(seen[0::2])

    S_0, S_L, r_s = jax.jit(forward)(params, jb,
                                     jax.random.split(key, 3)[0])
    r_s = torch.from_numpy(np.array(r_s))

    def model():
        tm = DGMC(SplineCNN(1, DIM, 2, 2, cat=False),
                  SplineCNN(RND, RND, 2, 2, cat=True), num_steps=STEPS,
                  k=-1)
        tm.load_state_dict(dgmc_from_flax(params))
        return tm

    return {'jm': jm, 'jstate': jstate, 'params': params, 'jb': jb,
            'tb': tb, 'key': key, 'r_s': r_s, 'S_0': S_0, 'S_L': S_L,
            'model': model}


@pytest.mark.parametrize('r_max', [None, RND // 2])
def test_dense_forward_matches_jax(setup, r_max, monkeypatch):
    """Through ``consensus_update`` and, with the gate's limit lowered
    below R, through the factored plain form."""
    if r_max is not None:
        monkeypatch.setattr(dgmc_module, 'R_MAX', r_max)
    tm = setup['model']()
    assert setup['r_s'].shape == (STEPS, B, N, RND)
    g_s, g_t, _, _ = batch_to_device(setup['tb'], 'cpu')
    dispatch.reset()
    with torch.no_grad():
        S_0, S_L = tm(g_s, g_t, r_s=setup['r_s'])
    assert S_0.idx is None and S_L.val.shape == (B, N, N)
    np.testing.assert_allclose(S_0.val.numpy(), np.asarray(setup['S_0'].val),
                               atol=1e-5)
    np.testing.assert_allclose(S_L.val.numpy(), np.asarray(setup['S_L'].val),
                               atol=1e-5)
    d = dispatch.decisions()
    assert d['consensus_fwd']['reason'] == ('device=cpu' if r_max is None
                                            else f'R>{r_max}')
    assert d['spline_route_fwd']['counts']['plain'] == 2 * 2 + STEPS * 4


@pytest.mark.parametrize('sparse', [False, True])
def test_metrics_match_jax(sparse):
    """Dense and sparse correspondences with tied scores (quarters), a
    ground truth absent from some candidate sets, masked targets and
    rows."""
    rng = np.random.RandomState(11 + sparse)
    B, S, T, K = 3, 7, 9, 4
    t_mask = rng.rand(B, T) > 0.2
    t_mask[:, 0] = True
    s_mask = np.ones((B, S), bool)
    y = rng.randint(0, T, (B, S)).astype(np.int32)
    y_mask = rng.rand(B, S) > 0.3
    if sparse:
        val = rng.randint(0, 4, (B, S, K)).astype(np.float32) / 4
        idx = np.stack([rng.permutation(T)[:K] for _ in range(B * S)]
                       ).reshape(B, S, K)
    else:
        val = rng.randint(0, 4, (B, S, T)).astype(np.float32) / 4
        idx = None
    jS = JaxCorrespondence(jnp.asarray(val),
                           None if idx is None else jnp.asarray(idx),
                           jnp.asarray(s_mask), jnp.asarray(t_mask))
    tS = Correspondence(torch.from_numpy(val),
                        None if idx is None else torch.from_numpy(idx),
                        torch.from_numpy(s_mask), torch.from_numpy(t_mask))
    ty, tm = torch.from_numpy(y), torch.from_numpy(y_mask)
    jy, jm = jnp.asarray(y), jnp.asarray(y_mask)
    for red in ('mean', 'sum', 'none', 'per_pair'):
        np.testing.assert_allclose(
            metrics.nll_loss(tS, ty, tm, reduction=red).numpy(),
            np.asarray(jmetrics.nll_loss(jS, jy, jm, reduction=red)),
            rtol=1e-6)
    for red in ('mean', 'sum'):
        np.testing.assert_allclose(
            metrics.acc(tS, ty, tm, reduction=red).numpy(),
            np.asarray(jmetrics.acc(jS, jy, jm, reduction=red)))
        for k in (1, 3, 10):
            np.testing.assert_allclose(
                metrics.hits_at_k(k, tS, ty, tm, reduction=red).numpy(),
                np.asarray(jmetrics.hits_at_k(k, jS, jy, jm,
                                              reduction=red)))


def _grads_jax(setup):
    """JAX's loss and gradients of the train step's loss, with the key
    split as ``make_train_step`` splits it."""
    jm, jb = setup['jm'], setup['jb']
    k_noise = jax.random.split(setup['key'], 3)[0]

    def loss_fn(params):
        S_0, S_L = jm.apply({'params': params}, jb.s, jb.t, y=jb.y,
                            y_mask=jb.y_mask, train=True,
                            rngs={'noise': k_noise})
        return (jmetrics.nll_loss(S_L, jb.y, jb.y_mask)
                + jmetrics.nll_loss(S_0, jb.y, jb.y_mask))

    return jax.jit(jax.value_and_grad(loss_fn))(setup['params'])


def test_train_step_matches_jax(setup):
    jloss, jgrads = _grads_jax(setup)
    _, jout = jax_train_step(setup['jm'], loss_on_s0=True)(
        setup['jstate'], setup['jb'], setup['key'])
    tm = setup['model']()
    loss, *_ = loss_and_outputs(tm, setup['tb'], loss_on_s0=True,
                                r_s=setup['r_s'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = dgmc_from_flax(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        if name in ZERO_GRAD:
            assert np.abs(g).max() < 1e-6 and np.abs(w.numpy()).max() < 1e-6
            continue
        scale = float(np.abs(w.numpy()).max())
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)

    tm = setup['model']()
    state = create_train_state(tm)
    _, out = make_train_step(tm, loss_on_s0=True)(
        state, setup['tb'], 0, r_s=setup['r_s'])
    assert state.step == 1
    np.testing.assert_allclose(float(out['loss']), float(jout['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(out['loss_per_pair'].numpy(),
                               np.asarray(jout['loss_per_pair']), rtol=1e-5)
    assert float(out['acc']) == float(jout['acc'])


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    p0 = {'w': rng.randn(5, 3).astype(np.float32),
          'b': rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * s
              for k, v in p0.items()} for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    state = create_train_state(model, learning_rate=1e-3)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            model[k].grad = torch.from_numpy(v)
        state.optimizer.step()
        for k in p0:
            np.testing.assert_allclose(model[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)


def test_adam_updates_parameters_without_a_gradient_as_optax():
    """DBP15K's two phases leave some parameters without a gradient (ψ₂
    and the consensus MLP in phase 1, ψ₁ in phase 2): optax still updates
    them, on one step count, from a zero gradient (moments decaying), and
    ``apply_gradients`` does the same (``torch.optim.Adam`` alone skips
    them). Tolerance as above."""
    rng = np.random.RandomState(1)
    p0 = {'a': rng.randn(4, 3).astype(np.float32),
          'b': rng.randn(3).astype(np.float32)}
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    state = create_train_state(model, learning_rate=1e-3)
    for step in range(8):
        live = 'a' if step < 4 else 'b'
        g = {k: (rng.randn(*v.shape).astype(np.float32) if k == live
                 else np.zeros_like(v)) for k, v in p0.items()}
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        state.optimizer.zero_grad(set_to_none=True)
        model[live].grad = torch.from_numpy(g[live])
        apply_gradients(state)
        for k in p0:
            np.testing.assert_allclose(model[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f'{k} {step}')
    assert state.step == 8
    assert not np.allclose(model['a'].detach().numpy(), p0['a'])


def test_eval_step_sums(setup):
    out = make_eval_step(setup['model'](), hits_ks=(1, 3))(
        setup['tb'], 0, r_s=setup['r_s'])
    S_L = setup['S_L']
    jb = setup['jb']
    assert int(out['count']) == int(np.asarray(jb.y_mask).sum())
    assert int(out['correct']) == int(jmetrics.acc(S_L, jb.y, jb.y_mask,
                                                   reduction='sum'))
    assert int(out['hits@1']) == int(out['correct'])
    assert int(out['hits@3']) == int(jmetrics.hits_at_k(
        3, S_L, jb.y, jb.y_mask, reduction='sum'))


def test_cli_loss_falls_on_cpu(capsys):
    """One epoch (16 steps of 64 pairs) at tiny widths: the mean loss of
    the last four steps is below that of the first four."""
    losses = []

    def hook(kind, index, out):
        if kind == 'train':
            losses.append(float(out['loss']))

    pascal_pf.main(['--device', 'cpu', '--f32', '--epochs', '1', '--dim',
                    '16', '--rnd_dim', '8', '--num_steps', '2'], hook=hook)
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert 'Epoch: 01, Loss: ' in capsys.readouterr().out


def test_cli_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        pascal_pf.main(['--epochs', '1'])
