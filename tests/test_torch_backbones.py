"""The port's remaining backbones held against the JAX package on the CPU:
``MaskedBatchNorm``, ``MLP``, ``GIN`` and ``RelCNN(batch_norm=True)``,
in training mode (batch statistics, the running averages after each
update) and in eval mode (the running averages), under float32 and bf16;
the ports of ``tests/models/test_backbones.py`` (shapes, the ``(cat,
lin)`` width contract, masked nodes that do not leak, the streams
refusal); the weights carried across by ``convert.py``.

Inputs come from numpy seeds; the flax parameters (perturbed away from
their init, so that ``scale``, ``bias`` and GIN's ``eps`` are not the
identity) are converted, not re-drawn. Node masks are prefix masks, as
``GraphBatch.from_numpy`` takes them.

Tolerances: float32 outputs and running averages within rtol 1e-5 and
1e-5 of the largest |reference| (the port's float32 gate: sums in other
orders). bf16: the output dtype equal to JAX's; batch norm of bf16 input
within the float32 gate (both take float32 statistics of the same bf16
values and return float32); whole bf16 backbones within 2e-2 of the
largest |reference| (``test_torch_precision.py``'s slice tolerance:
bf16 products rounded after sums in other orders).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.models import GIN as JaxGIN
from dgmc_tpu.models import MLP as JaxMLP
from dgmc_tpu.models import MaskedBatchNorm as JaxMaskedBatchNorm
from dgmc_tpu.models import RelCNN as JaxRelCNN
from dgmc_tpu.models import precision as jprecision
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu_torch.convert import (dgmc_from_flax, gin_from_flax,
                                    mlp_from_flax, relcnn_from_flax)
from dgmc_tpu_torch.models import (DGMC, GIN, MLP, MaskedBatchNorm, RelCNN,
                                   precision)
from dgmc_tpu_torch.ops.graph import GraphBatch

B, N, E, C = 2, 9, 20, 6
N_REAL = (9, 6)
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, c=C, junk=0.0):
    """A padded batch: graph 1 has every node real, graph 2 its first 6
    (``junk`` fills the padded rows' features)."""
    r = np.random.RandomState(seed)
    x = r.randn(B, N, c).astype(np.float32)
    mask = np.zeros((B, N), bool)
    snd, rcv = np.zeros((B, E), np.int32), np.zeros((B, E), np.int32)
    for b, n in enumerate(N_REAL):
        mask[b, :n] = True
        x[b, n:] = junk
        snd[b], rcv[b] = r.randint(0, n, E), r.randint(0, n, E)
    return {'x': x, 'senders': snd, 'receivers': rcv, 'node_mask': mask,
            'edge_mask': r.rand(B, E) > 0.15}


def _graphs(a):
    return (JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                          edge_attr=None),
            GraphBatch.from_numpy(a, 'cpu'))


def _perturbed(variables, seed):
    """The variables with every parameter moved off its init."""
    keys = iter(jax.random.split(jax.random.key(seed), 64))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.3 * jax.random.normal(next(keys), p.shape),
        variables['params'])
    return {**variables, 'params': params}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, what='', tol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    if tol is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=what)


def _same_dtype(got, want):
    assert str(got.dtype).replace('torch.', '') == str(want.dtype)


def _stats_close(module, convert, params, stats, what):
    """The module's running averages against flax's ``batch_stats``."""
    want = convert(jax.device_get(params), batch_stats=jax.device_get(stats))
    got = module.state_dict()
    keys = [k for k in want if k.endswith(('.mean', '.var'))]
    assert keys
    for k in keys:
        _close(got[k], want[k], f'{what}: {k}')


# ---- MaskedBatchNorm ----

@pytest.mark.parametrize('masked', [False, True], ids=['no-mask', 'mask'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_masked_batch_norm_matches_flax(masked, dtype):
    """Three training-mode updates (output and running averages after
    the first and the third), then eval on the running averages; a bf16
    input gives a float32 output in both."""
    r = np.random.RandomState(1)
    xs = [r.randn(B, N, 5).astype(np.float32) * 3 + 1 for _ in range(3)]
    mask = _arrays(0)['node_mask'] if masked else None
    jbn = JaxMaskedBatchNorm()
    v = jbn.init(jax.random.key(0), jnp.asarray(xs[0]), None,
                 use_running_average=False)
    v = _perturbed(v, 2)
    tbn = MaskedBatchNorm(5)
    tbn.load_state_dict({'scale': torch.tensor(np.asarray(
        v['params']['scale'])), 'bias': torch.tensor(np.asarray(
            v['params']['bias'])), 'mean': torch.zeros(5),
        'var': torch.ones(5)})
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == 'bf16'
                else (jnp.float32, torch.float32))
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    tbn.train()
    for i, x in enumerate(xs):
        jx = jnp.asarray(x).astype(jdt)
        want, upd = jbn.apply(v, jx, jmask, use_running_average=False,
                              mutable=['batch_stats'])
        v = {**v, 'batch_stats': upd['batch_stats']}
        got = tbn(torch.from_numpy(x).to(tdt), tmask)
        _same_dtype(got, want)
        assert got.dtype == torch.float32
        if i in (0, 2):
            _close(got, want, f'train output {i}')
            _close(tbn.mean, v['batch_stats']['mean'], f'mean after {i + 1}')
            _close(tbn.var, v['batch_stats']['var'], f'var after {i + 1}')
    tbn.eval()
    x = jnp.asarray(xs[0]).astype(jdt)
    want = jbn.apply(v, x, jmask, use_running_average=True)
    got = tbn(torch.from_numpy(xs[0]).to(tdt), tmask)
    _same_dtype(got, want)
    _close(got, want, 'eval output')


def test_masked_batch_norm_updates_its_buffers_in_place():
    """A captured graph reads the buffers' storage: an update writes it,
    never rebinds the attribute, and leaves masked rows out."""
    bn = MaskedBatchNorm(3).train()
    mean, var = bn.mean, bn.var
    ptr = mean.data_ptr(), var.data_ptr()
    x = torch.zeros(1, 4, 3)
    x[0, :2] = torch.tensor([[1.0, 2, 3], [3, 2, 1]])
    x[0, 2:] = 1e3
    bn(x, torch.tensor([[True, True, False, False]]))
    assert bn.mean is mean and bn.var is var
    assert (bn.mean.data_ptr(), bn.var.data_ptr()) == ptr
    torch.testing.assert_close(bn.mean, torch.tensor([0.2, 0.2, 0.2]))
    # Batch variance [1, 0, 1] unbiased over n = 2: [2, 0, 2].
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * torch.tensor([2.0, 0, 2]))
    assert not bn.mean.requires_grad


# ---- MLP ----

def test_mlp_shapes_and_repr():
    """``test_backbones.py:24``."""
    a = _arrays(0, c=16)
    model = MLP(16, 32, num_layers=2, batch_norm=True)
    out = model(torch.from_numpy(a['x']), torch.from_numpy(a['node_mask']))
    assert out.shape == (B, N, 32)
    assert repr(model).startswith('MLP(')
    assert model.extra_repr() == ('16, 32, num_layers=2, batch_norm=True, '
                                  'dropout=0.0')


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_mlp_matches_flax(dtype):
    """Train mode (its running averages after the update) and eval mode,
    three layers with batch norm between them."""
    a = _arrays(3)
    jpol, tpol = ((jprecision.BF16, precision.BF16) if dtype == 'bf16'
                  else (None, None))
    jm = JaxMLP(C, 7, 3, batch_norm=True, dtype=jpol)
    x, mask = jnp.asarray(a['x']), jnp.asarray(a['node_mask'])
    v = _perturbed(jm.init(jax.random.key(0), x, mask), 4)
    tm = MLP(C, 7, 3, batch_norm=True, dtype=tpol)
    tm.load_state_dict(mlp_from_flax(jax.device_get(v['params']),
                                     batch_stats=jax.device_get(
                                         v['batch_stats'])))
    tol = BF16_TOL if dtype == 'bf16' else None
    want, upd = jm.apply(v, x, mask, train=True, mutable=['batch_stats'])
    got = tm.train()(torch.from_numpy(a['x']),
                     torch.from_numpy(a['node_mask']))
    _same_dtype(got, want)
    _close(got, want, 'train', tol)
    _stats_close(tm, mlp_from_flax, v['params'], upd['batch_stats'], 'MLP')
    v = {**v, 'batch_stats': upd['batch_stats']}
    want = jm.apply(v, x, mask, train=False)
    got = tm.eval()(torch.from_numpy(a['x']),
                    torch.from_numpy(a['node_mask']))
    _close(got, want, 'eval', tol)


def test_mlp_dropout_only_before_the_last_layer():
    """Dropout at rate 1 zeroes the last layer's input: the output is the
    last bias alone, whatever the input."""
    m = MLP(4, 5, 2, dropout=1.0).train()
    out = m(torch.randn(1, 3, 4), generator=torch.Generator())
    torch.testing.assert_close(out, m.lins[1].bias.expand(1, 3, 5))
    m.eval()
    assert not torch.allclose(m(torch.randn(1, 3, 4)), out)


# ---- GIN and RelCNN(batch_norm=True) ----

def _backbone(kind, cat=True, lin=True, batch_norm=True, dtype=None):
    jpol = jprecision.BF16 if dtype == 'bf16' else None
    tpol = precision.BF16 if dtype == 'bf16' else None
    if kind == 'gin':
        return (JaxGIN(C, 8, 2, batch_norm=batch_norm, cat=cat, lin=lin,
                       dtype=jpol),
                GIN(C, 8, 2, batch_norm=batch_norm, cat=cat, lin=lin,
                    dtype=tpol), gin_from_flax)
    return (JaxRelCNN(C, 8, 2, batch_norm=batch_norm, cat=cat, lin=lin,
                      dtype=jpol),
            RelCNN(C, 8, 2, batch_norm=batch_norm, cat=cat, lin=lin,
                   dtype=tpol), relcnn_from_flax)


def _hold_backbone(kind, cat, lin, dtype, seed=5):
    """Train-mode output and running averages after two updates, then the
    eval output, against flax."""
    a = _arrays(seed)
    jg, tg = _graphs(a)
    jm, tm, convert = _backbone(kind, cat, lin, dtype=dtype)
    v = _perturbed(jm.init(jax.random.key(0), jg.x, jg), seed)
    tm.load_state_dict(convert(jax.device_get(v['params']),
                               batch_stats=jax.device_get(
                                   v['batch_stats'])))
    assert tm.out_channels == jm.out_channels
    tol = BF16_TOL if dtype == 'bf16' else None
    tm.train()
    for i in range(2):
        want, upd = jm.apply(v, jg.x, jg, train=True,
                             mutable=['batch_stats'])
        v = {**v, 'batch_stats': upd['batch_stats']}
        got = tm(tg.x, tg)
        _same_dtype(got, want)
        _close(got, want, f'{kind} train {i}', tol)
    _stats_close(tm, convert, v['params'], v['batch_stats'], kind)
    want = jm.apply(v, jg.x, jg, train=False)
    got = tm.eval()(tg.x, tg)
    _same_dtype(got, want)
    _close(got, want, f'{kind} eval', tol)
    return got


@pytest.mark.parametrize('kind', ['gin', 'rel'])
@pytest.mark.parametrize('cat,lin', itertools.product([False, True],
                                                      repeat=2))
def test_out_channels_contract_and_values(kind, cat, lin):
    """``test_backbones.py:34,44`` with batch norm: the width is
    ``16 + 2 * 32`` exactly when ``cat and not lin`` (here ``C + 2 * 8``),
    and the values follow flax."""
    expected = C + 2 * 8 if cat and not lin else 8
    got = _hold_backbone(kind, cat, lin, None)
    assert got.shape == (B, N, expected)


@pytest.mark.parametrize('kind', ['gin', 'rel'])
def test_backbone_matches_flax_under_bf16(kind):
    _hold_backbone(kind, True, True, 'bf16')


def test_gin_without_batch_norm_matches_flax():
    a = _arrays(7)
    jg, tg = _graphs(a)
    jm, tm, _ = _backbone('gin', batch_norm=False)
    v = _perturbed(jm.init(jax.random.key(0), jg.x, jg), 7)
    tm.load_state_dict(gin_from_flax(jax.device_get(v['params'])))
    _close(tm(tg.x, tg), jm.apply(v, jg.x, jg), 'gin')
    assert not list(tm.buffers())


@pytest.mark.parametrize('kind', ['gin', 'rel'])
def test_masked_nodes_do_not_leak(kind):
    """``test_backbones.py:91``, with batch norm in training mode: junk
    features in the padded rows change no real node's output nor the
    running averages."""
    outs, stats = [], []
    for junk in (0.0, 1e3):
        a = _arrays(9, junk=junk)
        _, tg = _graphs(a)
        _, tm, _ = _backbone(kind)
        tm.reset_parameters(torch.Generator().manual_seed(0))
        outs.append(tm.train()(tg.x, tg))
        stats.append([b.clone() for b in tm.buffers()])
    mask = torch.from_numpy(_arrays(9)['node_mask'])
    torch.testing.assert_close(outs[0][mask], outs[1][mask], rtol=1e-5,
                               atol=1e-5)
    for s0, s1 in zip(*stats):
        torch.testing.assert_close(s0, s1, rtol=1e-5, atol=1e-5)


def test_relcnn_streams_rejects_batch_norm():
    a = _arrays(0)
    _, tg = _graphs(a)
    m = RelCNN(3, 4, 1, batch_norm=True).eval()
    x2 = torch.zeros(B, N, 6)
    with pytest.raises(ValueError, match='batch_norm'):
        m(x2, tg, streams=2)


def test_repr_formats():
    """``test_backbones.py:67``: torch's repr carries the JAX repr's
    fields as its ``extra_repr``."""
    assert GIN(16, 32, num_layers=2).extra_repr() == (
        '16, 32, num_layers=2, batch_norm=False, cat=True, lin=True')
    assert RelCNN(16, 32, 2, batch_norm=True, dropout=0.5).extra_repr() == (
        '16, 32, num_layers=2, batch_norm=True, cat=True, lin=True, '
        'dropout=0.5')


# ---- Weights carried across ----

@pytest.mark.parametrize('kind', ['mlp', 'gin', 'gin-bn', 'rel-bn'])
def test_convert_round_trip(kind):
    """Every tensor of the flax tree (parameters and ``batch_stats``)
    lands in exactly one entry of the module's state dict, with its
    values (a Dense kernel transposed)."""
    a = _arrays(0)
    jg, _ = _graphs(a)
    if kind == 'mlp':
        jm, tm = JaxMLP(C, 7, 3, batch_norm=True), MLP(C, 7, 3, True)
        v = jm.init(jax.random.key(0), jg.x, jg.node_mask)
        convert = mlp_from_flax
    else:
        jm, tm, convert = _backbone(kind.split('-')[0],
                                    batch_norm=kind.endswith('-bn'))
        v = jm.init(jax.random.key(0), jg.x, jg)
    v = jax.device_get(_perturbed(v, 1))
    sd = convert(v['params'], batch_stats=v.get('batch_stats'))
    assert set(sd) == set(tm.state_dict())
    leaves = jax.tree_util.tree_leaves(v)
    assert len(sd) == len(leaves)
    np.testing.assert_array_equal(
        np.sort(np.concatenate([t.numpy().ravel() for t in sd.values()])),
        np.sort(np.concatenate([np.ravel(t) for t in leaves])))
    tm.load_state_dict(sd)
    with pytest.raises(KeyError):
        convert({**v['params'], 'stray_0': {}})


@pytest.mark.parametrize('kind', ['gin', 'rel'])
def test_dgmc_tree_with_batch_stats_converts(kind):
    """A full ``DGMC(GIN, GIN)`` / ``DGMC(RelCNN bn, RelCNN bn)`` tree with
    its ``batch_stats`` loads strictly; without the stats, only the
    running averages are missing."""
    from dgmc_tpu.models import DGMC as JaxDGMC
    a = _arrays(0)
    jg, _ = _graphs(a)
    j1, t1, _ = _backbone(kind)
    if kind == 'gin':
        j2, t2 = JaxGIN(4, 4, 2, batch_norm=True), GIN(4, 4, 2, True)
    else:
        j2, t2 = (JaxRelCNN(4, 4, 2, batch_norm=True),
                  RelCNN(4, 4, 2, batch_norm=True))
    jm = JaxDGMC(j1, j2, num_steps=2, k=-1)
    v = jax.device_get(jm.init({'params': jax.random.key(0),
                                'noise': jax.random.key(1)}, jg, jg))
    tm = DGMC(t1, t2, num_steps=2)
    tm.load_state_dict(dgmc_from_flax(v['params'], v['batch_stats']))
    missing, unexpected = tm.load_state_dict(dgmc_from_flax(v['params']),
                                             strict=False)
    assert not unexpected
    assert missing and all(k.endswith(('.mean', '.var')) for k in missing)
    with pytest.raises(KeyError):
        dgmc_from_flax(v['params'], {**v['batch_stats'], 'psi_3': {}})
