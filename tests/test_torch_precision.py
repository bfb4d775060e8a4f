"""The port's precision policy (bf16 compute, float32 accumulation, the
training CLIs' default) held against the JAX package's on the CPU.

- The policy object and its CLI flags, ports of
  ``tests/models/test_precision.py:88-140``; that the entry points, not an
  import, select cuBLAS's float32 reduction of bf16 products.
- The float32-accumulation pins (``tests/models/test_precision.py:142-200``):
  bf16 messages, gather cotangents and candidate cotangents summed past
  the point where a bf16 running sum stalls (256 times an addend).
- Each kernel's plain bf16 version against the JAX kernel under bf16
  inputs, run as the JAX package's own tests run it on the CPU (Pallas
  interpret mode).
- The slice: one dense train step and the sparse training forward with
  its gradients under the JAX package's ``BF16`` policy, converted
  parameters and JAX's draws injected; both CLIs at tiny width under each
  policy, with ``--metrics_log``.

Tolerances, stated per check:

- top-k: indices and values equal on exact inputs (small integers: every
  product and sum is exact in float32, so both round the same score).
- SplineConv routing: within one bf16 ulp (``rtol`` 2^-7), plus 1e-6 of
  the largest |value| for sums that cancel to nearly 0. Both sum in
  float32 with float32 basis weights and round each output once; the
  orders differ, so a sum on a rounding boundary may round the other way
  (seed 1: one value of 1152).
- Consensus deltas (float32 outputs): within ``FORM_TOL`` = 2e-2 of the
  largest |delta| of the JAX kernel's (measured: at most 0.8%). The port
  rounds the factored form (``u_s - u_t``), the JAX kernels the direct
  one (``o_s - o_t``): each pre-activation differs by about a bf16 ulp of
  ``u`` (2^-8 relative).
- Their gradients: within ``FORM_GRAD_TOL`` = 1e-1 of the JAX kernel's,
  as a norm (``|g - w| / |w|``; measured: at most 6%). Besides the
  rounding above, a pre-activation within that ulp of 0 takes the other
  side of the ReLU in the two forms and moves single entries by ``g * w2
  * w1`` (15% of the largest here; in float32 one such flip moved d_o_s
  by 1.1%, ROADMAP §C), and the JAX backward rounds its cotangents to
  bf16 on the way. So each delta and gradient is also held against the
  exact derivative of the port's own bf16 forward: the factored form in
  float64 on the same bf16 inputs, rounding where the kernels round but
  passing the gradient through unrounded (:class:`_RoundBF16`): deltas
  within rtol/atol 1e-5 (float32 against float64 sums), gradients within
  one bf16 ulp (``rtol`` 2^-7) plus 1e-3 of the largest |gradient|.
- The slice: losses within ``SLICE_LOSS_RTOL`` = 2e-2 and the
  correspondences within 2e-2 of their largest entry; gradients as norms,
  within ``SLICE_GRAD_TOL`` = 1e-1 (dense; measured: at most 6.4%) and
  ``SPARSE_GRAD_TOL`` = 4e-1 (sparse; measured: at most 31%, in ψ₂'s
  first ``lin1`` kernel; next ``mlp_hidden_bias`` 17% and ψ₂'s second
  ``lin1`` kernel 17%, every other ψ₂ and MLP leaf at most 11%, ψ₁'s
  below 1%: the leaves downstream of the consensus step). The JAX
  package's SplineConv off the TPU rounds its basis weights and messages
  to bf16 where the port's routing (as the JAX kernel) keeps them
  float32, its autodiff rounds cotangents to bf16 (the transposes of bf16
  gathers, its sparse kernel's backward) where the port sums them in
  float32, and the two frameworks' bf16 GEMMs sum in other orders. At
  random init ψ₂'s gradients cancel (ill-conditioned even in float32,
  ROADMAP §C), which magnifies each package's roundings, so each stands
  apart from an exact gradient and the two from each other by up to
  their sum. The two gradients that are zero analytically
  (``ZERO_GRAD``) are rounding noise in both packages and not compared.
- So the sparse slice is also held, as the kernels are, against the
  exact derivative of the port's own bf16 forward
  (:func:`_sparse_slice_exact`: the same model in float64, rounding where
  the port rounds, gradients passed through unrounded): the loss within
  rtol 1e-5, each gradient as a norm within ``SPARSE_EXACT_TOL`` = 1e-2
  (measured: at most 0.67%, ψ₂'s first ``lin1`` kernel again, about two
  bf16 ulps; what remains is the port's backward rounding its
  cotangents to bf16 at each bf16 product, as autograd does). A wrong
  gradient term moves a leaf by far more: the sparse backward's d_u_t
  scaled by 0.9 moved ``mlp_hidden_kernel`` by 11%, a gradient leaking
  2% through the ReLU's closed side by 4.3%; both pass ``SPARSE_GRAD_TOL``.
"""

import argparse
import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dgmc_tpu.data import Cartesian as JCartesian
from dgmc_tpu.data import Compose as JCompose
from dgmc_tpu.data import Constant as JConstant
from dgmc_tpu.data import KNNGraph as JKNNGraph
from dgmc_tpu.data import RandomGraphPairs as JRandomGraphPairs
from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import metrics as jmetrics
from dgmc_tpu.models import precision as jprecision
from dgmc_tpu.models.rel import RelCNN as JaxRelCNN
from dgmc_tpu.models.spline import SplineCNN as JaxSplineCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu.ops.pallas import consensus_update as jax_consensus
from dgmc_tpu.ops.pallas import sparse_consensus as jsc
from dgmc_tpu.ops.pallas.spline import route_aggregate as jax_route
from dgmc_tpu.ops.pallas.topk import pallas_topk
from dgmc_tpu.ops.spline import open_spline_basis as jax_basis
from dgmc_tpu.train import create_train_state as jax_create_state
from dgmc_tpu.utils import pad_pair_batch as jax_pad_pair_batch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            KNNGraph)
from dgmc_tpu_torch.experiments import dbp15k, pascal_pf
from dgmc_tpu_torch.models import metrics, precision
from dgmc_tpu_torch.models.dgmc import DGMC, Correspondence
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.models.spline import SplineCNN
from dgmc_tpu_torch.ops import graph as tgraph
from dgmc_tpu_torch.ops.kernels import consensus as tcons
from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels import sparse_consensus as tsc
from dgmc_tpu_torch.ops.kernels.spline import (Routing,
                                               plain_route_aggregate,
                                               plain_route_d_t)
from dgmc_tpu_torch.ops.kernels.topk import plain_topk, streaming_topk
from dgmc_tpu_torch.ops.shortlist import Shortlist
from dgmc_tpu_torch.ops.softmax import masked_softmax
from dgmc_tpu_torch.train.state import create_train_state
from dgmc_tpu_torch.train.steps import loss_and_outputs, make_train_step
from dgmc_tpu_torch.utils.data import pad_pair_batch

BF16 = torch.bfloat16
FORM_TOL, FORM_GRAD_TOL = 2e-2, 1e-1
SLICE_LOSS_RTOL, SLICE_GRAD_TOL, SPARSE_GRAD_TOL = 2e-2, 1e-1, 4e-1
SPARSE_EXACT_TOL = 1e-2
FLOATS = ('o_s', 'o_t', 'w1', 'b1', 'w2', 'b2')
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the tensors here are small, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cublas_flags():
    """Restore the process-wide matmul flags a test (or a CLI) sets."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction, m.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield m
    (m.allow_bf16_reduced_precision_reduction, m.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _t16(a):
    """numpy float → torch bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _j16(a):
    """numpy float → jax bfloat16 (round to nearest even)."""
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np(x):
    """torch or jax array → float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _close_norm(got, want, tol, what):
    """``|got - want| / |want| <= tol`` over the whole tensor."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f'{what}: |got - want| / |want| = {err:.4g} > {tol}'


class _RoundBF16(torch.autograd.Function):
    """Rounds to bf16 (to nearest even) in the forward and passes the
    gradient through unrounded: differentiates a bf16 forward exactly."""

    @staticmethod
    def forward(ctx, x):
        return x.to(BF16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _factored_exact(o_s, o_t, w1, b1, w2, b2, pick):
    """The port's bf16 factored form in the inputs' (float64) dtype, with
    the kernels' rounding points; ``pick(u_s, u_t)`` pairs the rows
    (every target, or the shortlist's)."""
    rnd = _RoundBF16.apply
    u_s, u_t = rnd(rnd(o_s @ w1) + b1), rnd(o_t @ w1)
    pre = rnd(pick(u_s, u_t))
    return (torch.relu(pre) @ w2)[..., 0] + b2[0]


# -- The policy object and its flags ---------------------------------------

def test_policy_object():
    bf16 = precision.get('bf16')
    assert bf16.compute_dtype == BF16 and bf16.gather_dtype == 'bfloat16'
    f32 = precision.get('f32')
    assert f32.compute_dtype is None and f32.gather_dtype is None
    assert precision.get(None) is precision.F32
    assert precision.get(bf16) is bf16
    assert precision.get(BF16) is precision.BF16
    assert precision.get(torch.float32) is precision.F32
    assert precision.compute_dtype_of(bf16) == BF16
    assert precision.compute_dtype_of(BF16) == BF16
    assert precision.compute_dtype_of(torch.float32) is None
    assert precision.compute_dtype_of(None) is None
    with pytest.raises(ValueError):
        precision.get('fp8')
    for name in ('bf16', 'f32'):   # the JAX package's two policies
        j, t = jprecision.get(name), precision.get(name)
        assert (t.name, t.gather_dtype, t.compute_dtype is not None) == (
            j.name, j.gather_dtype, j.is_mixed)


@pytest.mark.parametrize('argv, want', [([], 'bf16'), (['--f32'], 'f32'),
                                        (['--bf16'], 'bf16'),
                                        (['--precision', 'f32'], 'f32'),
                                        (['--f32', '--bf16'], 'bf16')])
def test_policy_cli_flags(argv, want):
    """bf16 is the default; --f32 is the opt-out and --bf16 its alias,
    as in the JAX package (the last flag wins in both)."""
    for pkg in (precision, jprecision):
        parser = argparse.ArgumentParser()
        pkg.add_precision_args(parser)
        assert pkg.from_args(parser.parse_args(argv)).name == want
    assert pascal_pf.parse_args(argv).precision == want
    assert dbp15k.parse_args(argv).precision == want


def _path_graph(B=2, N=6, C=5, seed=0):
    r = np.random.RandomState(seed)
    E = 2 * (N - 1)
    s = np.concatenate([np.arange(N - 1), np.arange(1, N)])
    d = np.concatenate([np.arange(1, N), np.arange(N - 1)])
    return tgraph.GraphBatch.from_numpy({
        'x': r.randn(B, N, C).astype(np.float32),
        'senders': np.tile(s, (B, 1)), 'receivers': np.tile(d, (B, 1)),
        'node_mask': np.ones((B, N), bool), 'edge_mask': np.ones((B, E), bool),
        'edge_attr': r.rand(B, E, 2).astype(np.float32)}, 'cpu')


def test_policy_accepted_by_models():
    """A policy object in a module's dtype argument behaves exactly like
    the raw compute dtype; under bf16 the outputs are bf16 and the
    parameters float32."""
    g = _path_graph()
    for make in (lambda dt: RelCNN(5, 8, 2, dtype=dt),
                 lambda dt: SplineCNN(5, 8, 2, 2, dtype=dt)):
        outs = []
        for dt in (precision.BF16, BF16, 'bf16'):
            m = make(dt)
            m.reset_parameters(torch.Generator().manual_seed(0))
            outs.append(m(g.x, g))
            assert all(p.dtype == torch.float32 for p in m.parameters())
        assert outs[0].dtype == BF16
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        m = make(precision.F32)
        m.reset_parameters(torch.Generator().manual_seed(0))
        assert m(g.x, g).dtype == torch.float32


def test_apply_selects_float32_reduction_without_import_side_effects(
        cublas_flags):
    """cuBLAS may reduce a bf16 GEMM in bf16 unless told otherwise: the
    policy's apply() switches that off (and TF32); importing the package
    changes neither flag."""
    import importlib
    cublas_flags.allow_bf16_reduced_precision_reduction = True
    importlib.reload(precision)
    assert cublas_flags.allow_bf16_reduced_precision_reduction
    for spec in ('bf16', 'f32'):
        cublas_flags.allow_bf16_reduced_precision_reduction = True
        cublas_flags.allow_tf32 = True
        assert precision.apply(spec) is precision.get(spec)
        assert not cublas_flags.allow_bf16_reduced_precision_reduction
        assert not cublas_flags.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


def test_convert_refuses_parameters_that_are_not_float32():
    flax_like = {'psi_1': {'final': {'kernel': np.ones((2, 2), np.float32)}},
                 'psi_2': {}, 'mlp_hidden_kernel': np.ones((2, 2), np.float32),
                 'mlp_hidden_bias': np.zeros(2, np.float32),
                 'mlp_out_kernel': np.ones((2, 1), np.float32),
                 'mlp_out_bias': np.zeros(1, jnp.bfloat16)}
    with pytest.raises(TypeError, match='float32'):
        dgmc_from_flax(flax_like)
    flax_like['mlp_out_bias'] = np.zeros(1, np.float32)
    assert all(v.dtype == torch.float32
               for v in dgmc_from_flax(flax_like).values())


def test_metric_logger_appends_jsonl_with_null_for_non_finite(tmp_path):
    from dgmc_tpu_torch.obs.observe import MetricLogger
    path = tmp_path / 'sub' / 'm.jsonl'
    with MetricLogger(str(path)) as log:
        log.log(3, loss=torch.tensor(0.5), bad=float('nan'), phase=2,
                ok=True)
    with MetricLogger(str(path)) as log:
        log.log(4, loss=np.float32(0.25))
    MetricLogger(None).log(5, loss=1.0)   # disabled: no file, no error
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r['step'] for r in recs] == [3, 4]
    assert recs[0]['loss'] == 0.5 and recs[0]['bad'] is None
    assert recs[0]['phase'] == 2 and recs[0]['ok'] is True
    assert recs[1]['loss'] == 0.25 and isinstance(recs[1]['time'], float)


# -- The float32-accumulation pins ----------------------------------------

def test_scatter_and_gather_gradient_accumulate_f32_under_bf16():
    """1024 bf16 messages of 0.5 into one node sum to exactly 512 (a bf16
    running sum stalls at 256); the same for the gather's gradient, cast
    back to bf16 once, and for a shortlist's reduction onto a target."""
    e, n = 1024, 4
    msgs = torch.full((1, e, 8), 0.5, dtype=BF16)
    rcv = torch.zeros((1, e), dtype=torch.int64)
    out = tgraph.scatter_to_nodes(msgs, rcv, torch.ones(1, e, dtype=bool), n)
    assert out.dtype == BF16
    assert torch.equal(out[0, 0].float(), torch.full((8,), 512.0))
    x = torch.zeros((1, n, 8), dtype=BF16, requires_grad=True)
    tgraph.gather_nodes(x, rcv).backward(torch.full((1, e, 8), 0.5,
                                                    dtype=BF16))
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad[0, 0].float(), torch.full((8,), 512.0))
    assert not x.grad[0, 1:].float().any()
    sl = Shortlist(torch.zeros((1, e, 1), dtype=torch.int64), n)
    got = sl.scatter(torch.full((1, e, 1, 8), 0.5, dtype=BF16))
    assert torch.equal(got[0, 0].float(), torch.full((8,), 512.0))


def _d_o_t_pin(delta_fn, N_s, N_t=4, R=8):
    """d_o_t of ``0.5 * sum(delta)`` with every candidate on target 0 and
    the pre-activation 1 everywhere: each of the N_s cotangents adds
    -(0.5 * w2) @ w1^T = -0.5 per channel."""
    o_s = torch.zeros((1, N_s, R), dtype=BF16)
    o_t = torch.zeros((1, N_t, R), dtype=BF16, requires_grad=True)
    w1 = torch.eye(R, dtype=BF16)
    b1 = torch.ones(R, dtype=BF16)
    w2 = torch.ones((R, 1), dtype=BF16)
    b2 = torch.zeros(1, dtype=BF16)
    (0.5 * delta_fn(o_s, o_t, w1, b1, w2, b2).sum()).backward()
    assert o_t.grad.dtype == BF16
    return o_t.grad.float()


def test_sparse_backward_d_o_t_accumulates_f32():
    """The port of ``test_fused_kernel_d_o_t_accumulates_f32``: 2048
    cotangents of 0.5 into one target row give exactly -1024 (a bf16
    running sum would stall at -256), as in the JAX package."""
    N_s, R = 2048, 8
    idx = torch.zeros((1, N_s, 1), dtype=torch.int64)
    got = _d_o_t_pin(lambda *a: tsc.fused_candidate_delta(
        a[0], a[1], idx, *a[2:]), N_s)
    assert torch.equal(got[0, 0], torch.full((R,), -1024.0))
    assert not got[0, 1:].any()
    want = jax.grad(lambda t: 0.5 * jnp.sum(jsc.fused_candidate_delta(
        jnp.zeros((1, N_s, R), jnp.bfloat16), t,
        jnp.zeros((1, N_s, 1), jnp.int32), jnp.eye(R, dtype=jnp.bfloat16),
        jnp.ones((R,), jnp.bfloat16), jnp.ones((R, 1), jnp.bfloat16),
        jnp.zeros((1,), jnp.bfloat16), True)))(
            jnp.zeros((1, 4, R), jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_dense_backward_d_o_t_accumulates_f32():
    """The dense consensus backward the same way: 2048 source rows' 0.5
    onto each target give exactly -1024 per channel."""
    got = _d_o_t_pin(tcons.consensus_update, 2048)
    assert torch.equal(got, torch.full((1, 4, 8), -1024.0))


# -- Each kernel's plain bf16 version against the JAX kernel --------------

# (k, masked share, C, N_t): the earlier cases keep their ids; then the
# tensor-core tile's edges: C = 200 (a ragged last 64-channel chunk), a
# target count no multiple of its 128-target tile, k = 1.
@pytest.mark.parametrize('k, masked, C, N_t', [
    pytest.param(7, 0.3, 24, 600, id='7-0.3'),
    pytest.param(10, None, 24, 600, id='10-None'),
    pytest.param(25, 0.9, 24, 600, id='25-0.9'),
    pytest.param(10, 0.3, 200, 600, id='c200'),
    pytest.param(7, None, 24, 333, id='ragged_n_t'),
    pytest.param(1, 0.5, 200, 333, id='k1')])
def test_topk_plain_bf16_matches_jax_kernel_on_exact_inputs(k, masked, C,
                                                           N_t):
    r = np.random.RandomState(k)
    h_s, h_t = r.randint(-3, 4, (2, 40, C)), r.randint(-3, 4, (2, N_t, C))
    mask = None if masked is None else r.rand(2, N_t) > masked
    jv, ji = pallas_topk(_j16(h_s), _j16(h_t), k,
                         t_mask=None if mask is None else jnp.asarray(mask),
                         return_values=True, interpret=True)
    dispatch.reset()
    tv, ti = streaming_topk(_t16(h_s), _t16(h_t), k,
                            None if mask is None else torch.from_numpy(mask))
    assert dispatch.decisions()['topk']['dtype'] == 'bfloat16'
    assert tv.dtype == BF16 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    assert torch.equal(plain_topk(_t16(h_s), _t16(h_t), k, None if mask is
                                  None else torch.from_numpy(mask))[1], ti)


def _spline_problem(seed=0, B=3, N=24, E=80, O=16):
    r = np.random.RandomState(seed)
    x = r.randn(B, N, 8).astype(np.float32)
    W = (r.randn(25, 8, O) * 0.1).astype(np.float32)
    t = (x @ W.transpose(1, 0, 2).reshape(8, 25 * O)).reshape(B, N * 25, O)
    snd, rcv = r.randint(0, N, (B, E)), r.randint(0, N, (B, E))
    em = r.rand(B, E) > 0.2
    basis, combo = jax_basis(jnp.asarray(r.rand(B, E, 2).astype(np.float32)),
                             5, 1)
    flat = np.asarray(snd[..., None] * 25 + np.asarray(combo))
    g = r.randn(B, N, O).astype(np.float32)
    routing = Routing(torch.from_numpy(flat), torch.from_numpy(rcv),
                      torch.from_numpy(em), N, N * 25)
    jargs = (jnp.asarray(flat), basis, jnp.asarray(rcv), jnp.asarray(em), N,
             True)
    return t, g, np.array(basis), routing, jargs


@pytest.mark.parametrize('seed', [0, 1])
def test_spline_plain_bf16_matches_jax_kernel(seed):
    """bf16 t (and g): float32 basis and sums, each output rounded once,
    in both packages."""
    t, g, basis, routing, jargs = _spline_problem(seed)
    want, vjp = jax.vjp(lambda t_: jax_route(t_, *jargs), _j16(t))
    want_dt, = vjp(_j16(g))
    got = plain_route_aggregate(_t16(t), torch.from_numpy(basis), routing)
    got_dt = plain_route_d_t(_t16(g), torch.from_numpy(basis), routing)
    assert got.dtype == got_dt.dtype == BF16
    _close(got, want, 1e-6, 'route_fwd', rtol=2 ** -7)
    _close(got_dt, want_dt, 1e-6, 'd_t', rtol=2 ** -7)


def _consensus_floats(r, B, N_s, N_t, R):
    return [r.randn(B, N_s, R), r.randn(B, N_t, R), 0.3 * r.randn(R, R),
            0.1 * r.randn(R), 0.3 * r.randn(R, 1), 0.1 * r.randn(1)]


def _torch_grads(fn, floats, g, dtype=BF16):
    """``fn``'s output and gradients of ``sum(out * g)`` on the bf16
    inputs, carried in ``dtype`` (bf16, or float64 exactly)."""
    ts = [_t16(a).to(dtype).requires_grad_() for a in floats]
    out = fn(*ts)
    (out * torch.from_numpy(g).to(out.dtype)).sum().backward()
    return out, [t.grad for t in ts]


def _jax_grads(fn, floats, g):
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * jnp.asarray(g, jnp.float32)), out
    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(floats))), has_aux=True)(
            *map(_j16, floats))
    return out, grads


def _hold_against_jax(got, want, exact):
    """The port's bf16 delta and gradients against the JAX kernel's (the
    form tolerances) and against the exact derivative of the port's bf16
    forward (see the module docstring)."""
    (out, grads), (w_out, w_grads), (e_out, e_grads) = got, want, exact
    assert out.dtype == torch.float32
    _close(out, w_out, FORM_TOL, 'delta')
    _close(out, e_out, 1e-5, 'delta', rtol=1e-5)
    for name, gr, w, e in zip(FLOATS, grads, w_grads, e_grads):
        assert gr.dtype == BF16, name
        _close_norm(gr, w, FORM_GRAD_TOL, name)
        _close(gr, e, 1e-3, name, rtol=2 ** -7)


@pytest.mark.parametrize('shape', [(2, 20, 37, 16), (1, 80, 80, 64)])
def test_consensus_plain_bf16_matches_jax_kernel(shape):
    r = np.random.RandomState(sum(shape))
    floats = _consensus_floats(r, *shape)
    g = r.randn(*shape[:3])
    got = _torch_grads(tcons.consensus_update, floats, g)
    exact = _torch_grads(lambda *a: _factored_exact(
        *a, lambda u_s, u_t: u_s[:, :, None] - u_t[:, None]), floats, g,
        torch.float64)
    want = _jax_grads(lambda *a: jax_consensus(*a, True), floats, g)
    _hold_against_jax(got, want, exact)


@pytest.mark.parametrize('shape', [(2, 30, 24, 5, 16), (1, 60, 90, 20, 32)])
def test_sparse_plain_bf16_matches_jax_kernel(shape):
    B, N_s, N_t, K, R = shape
    r = np.random.RandomState(sum(shape))
    floats = _consensus_floats(r, B, N_s, N_t, R)
    idx = r.randint(0, N_t, (B, N_s, K))
    g = r.randn(B, N_s, K)
    t_idx, j_idx = torch.from_numpy(idx), jnp.asarray(idx.astype(np.int32))
    got = _torch_grads(lambda *a: tsc.fused_candidate_delta(
        a[0], a[1], t_idx, *a[2:]), floats, g)
    rows = torch.arange(B)[:, None, None]
    exact = _torch_grads(lambda *a: _factored_exact(
        *a, lambda u_s, u_t: u_s[:, :, None] - u_t[rows, t_idx]), floats, g,
        torch.float64)
    want = _jax_grads(lambda *a: jsc.fused_candidate_delta(
        a[0], a[1], j_idx, *a[2:], True), floats, g)
    _hold_against_jax(got, want, exact)
    # The unfused plain form rounds where the JAX reference does.
    cand = _t16(floats[1])[rows, t_idx]
    np.testing.assert_allclose(
        _np(tsc.plain_sparse_consensus_delta(_t16(floats[0]), cand,
                                             *map(_t16, floats[2:]))),
        _np(jsc.fused_candidate_delta_reference(
            *map(_j16, floats[:2]), j_idx, *map(_j16, floats[2:]))),
        rtol=1e-5, atol=1e-5)


# -- The slice under bf16 against JAX's BF16 policy ------------------------

def _hold_slice(loss, want_loss, model, want_grads, tol, skip=()):
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=SLICE_LOSS_RTOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, w in want_grads.items():
        p = got[name]
        assert p.dtype == torch.float32, name
        if name.startswith(skip):
            continue
        g = np.zeros_like(w.numpy()) if p.grad is None else p.grad.numpy()
        assert g.dtype == np.float32, name
        if name in ZERO_GRAD:
            continue
        _close_norm(g, w, tol, name)


def test_dense_train_step_matches_jax_under_bf16():
    """One dense train step (loss(S_0) + loss(S_L)) at tiny width: the JAX
    package's DGMC with the BF16 policy against the port's, converted
    weights and JAX's bf16 noise injected."""
    N, E, B, STEPS, DIM, RND = 16, 128, 4, 3, 16, 8
    jt = JCompose([JConstant(), JKNNGraph(k=8), JCartesian()])
    tt = Compose([Constant(), KNNGraph(k=8), Cartesian()])
    jds = JRandomGraphPairs(5, 10, 0, 3, transform=jt, length=B, seed=3)
    tds = RandomGraphPairs(5, 10, 0, 3, transform=tt, length=B, seed=3)
    jb = jax_pad_pair_batch([jds[i] for i in range(B)], N, E, native='never')
    tb = pad_pair_batch([tds[i] for i in range(B)], N, E)
    P = jprecision.BF16
    jm = JaxDGMC(JaxSplineCNN(1, DIM, 2, 2, cat=False, dtype=P),
                 JaxSplineCNN(RND, RND, 2, 2, cat=True, dtype=P),
                 num_steps=STEPS, k=-1, dtype=P)
    params = jax.device_get(jax.jit(lambda b: jax_create_state(
        jm, jax.random.key(0), b))(jb).params)
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
        return loss, jnp.stack(seen[0::2])

    (jloss, r_s), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    assert r_s.dtype == jnp.bfloat16
    tm = DGMC(SplineCNN(1, DIM, 2, 2, cat=False, dtype=precision.BF16),
              SplineCNN(RND, RND, 2, 2, cat=True, dtype=precision.BF16),
              num_steps=STEPS, k=-1, dtype=precision.BF16)
    tm.load_state_dict(dgmc_from_flax(params))
    dispatch.reset()
    loss, S_0, S_L, _, _ = loss_and_outputs(
        tm, tb, loss_on_s0=True, r_s=_t16(_np(r_s)))
    assert S_0.val.dtype == S_L.val.dtype == loss.dtype == torch.float32
    d = dispatch.decisions()
    for kernel in ('spline_route_fwd', 'consensus_fwd'):
        assert d[kernel]['dtypes'] == {
            'plain:bfloat16': d[kernel]['counts']['plain']}, kernel
    loss.backward()
    _hold_slice(loss, jloss, tm, dgmc_from_flax(jax.device_get(jgrads)),
                SLICE_GRAD_TOL)
    d = dispatch.decisions()['spline_route_bwd']
    assert set(d['dtypes']) == {'plain:bfloat16'}

    # The train step keeps the parameters and Adam's state float32.
    state = create_train_state(tm)
    _, out = make_train_step(tm, loss_on_s0=True)(state, tb, 0,
                                                  r_s=_t16(_np(r_s)))
    assert out['loss'].dtype == out['acc'].dtype == torch.float32
    for p in tm.parameters():
        assert p.dtype == torch.float32
        assert all(v.dtype == torch.float32 for v in
                   state.optimizer.state[p].values() if v.dim())


def _rel_exact(m, x, g):
    """The port's bf16 :class:`RelCNN` ``m`` in float64 with its rounding
    points (the input cast; each ``dense``: product, then bias; each
    aggregation's single rounding; the sums of a layer), differentiable
    exactly (:class:`_RoundBF16`). ``m``'s parameters are float64."""
    rnd = _RoundBF16.apply

    def lin(l, v):
        y = rnd(v @ rnd(l.weight).T)
        return y if l.bias is None else rnd(y + rnd(l.bias))

    def mean(h, src, dst):
        return rnd(tgraph.scatter_to_nodes(
            tgraph.gather_nodes(h, getattr(g, src)), getattr(g, dst),
            g.edge_mask, h.shape[1], aggr='mean'))

    xs = [rnd(x)]
    for conv in m.convs:
        v = xs[-1]
        a = rnd(mean(lin(conv.lin1, v), 'senders', 'receivers')
                + mean(lin(conv.lin2, v), 'receivers', 'senders'))
        xs.append(torch.relu(rnd(lin(conv.root, v) + a)))
    return lin(m.final, torch.cat(xs, dim=-1))


def _sparse_slice_exact(tm, g_s, g_t, y, y_mask, idx, r_s, num_steps,
                        detach):
    """The port's bf16 sparse training forward and its loss in float64 on
    a float64 copy of ``tm``, rounding where the port rounds (ψ₁ and ψ₂ by
    :func:`_rel_exact`, h after ψ₁, the MLP's cast, the fused delta by
    :func:`_factored_exact`) and passing gradients through unrounded: the
    exact derivative of the port's bf16 forward → ``(loss, {name:
    gradient})``. ``idx`` is the shortlist the forward built (top-k,
    negatives, ground truth); every slot is valid here."""
    m = copy.deepcopy(tm).double()
    rnd = _RoundBF16.apply
    with torch.set_grad_enabled(not detach):
        h_s, h_t = (rnd(_rel_exact(m.psi_1, g.x.double(), g))
                    for g in (g_s, g_t))
    sl = Shortlist(idx, g_t.x.shape[1])
    mask = torch.ones(idx.shape, dtype=torch.bool)
    S_hat = torch.einsum('bsc,bskc->bsk', h_s, sl.gather(h_t))
    mlp = [rnd(p) for p in (m.mlp_hidden_kernel, m.mlp_hidden_bias,
                            m.mlp_out_kernel, m.mlp_out_bias)]
    for step in range(num_steps):
        S = masked_softmax(S_hat, mask)
        r = r_s[step].double()
        r_t = sl.scatter(S[..., None] * r[:, :, None, :])
        o_s, o_t = _rel_exact(m.psi_2, r, g_s), _rel_exact(m.psi_2, r_t, g_t)
        S_hat = S_hat + _factored_exact(
            o_s, o_t, *mlp, lambda u_s, u_t: u_s[:, :, None] - sl.gather(u_t))
    S_L = Correspondence(masked_softmax(S_hat, mask), sl.idx,
                         g_s.node_mask, g_t.node_mask)
    loss = metrics.nll_loss(S_L, y, y_mask)
    loss.backward()
    return loss, {n: p.grad for n, p in m.named_parameters()}


def _kg_side(r, B, n, n_real, E, C):
    x = r.randn(B, n, C).astype(np.float32)
    x[:, n_real:] = 0
    mask = np.zeros((B, n), bool)
    mask[:, :n_real] = True
    return {'x': x, 'senders': r.randint(0, n_real, (B, E)).astype(np.int32),
            'receivers': r.randint(0, n_real, (B, E)).astype(np.int32),
            'node_mask': mask, 'edge_mask': r.rand(B, E) > 0.1}


@pytest.mark.parametrize('num_steps, detach', [(0, False), (2, True)])
def test_sparse_training_forward_and_gradients_match_jax_under_bf16(
        num_steps, detach):
    """The sparse training forward (top-k, negatives, ground truth,
    consensus) at tiny width under bf16: JAX's DGMC with the BF16 policy
    and its fused sparse-consensus kernel against the port's, JAX's noise
    and negatives injected; shortlists equal."""
    B, N_S, N_T, E, C, K, R_IN = 2, 20, 26, 60, 12, 4, 8
    r = np.random.RandomState(0)
    s, t = _kg_side(r, B, N_S, N_S, E, C), _kg_side(r, B, N_T, N_T - 3, E, C)
    y = np.stack([r.permutation(N_T - 3)[:N_S] for _ in range(B)])
    y_mask = r.rand(B, N_S) > 0.3
    y = np.where(y_mask, y, -1).astype(np.int32)
    P = jprecision.BF16
    jm = JaxDGMC(JaxRelCNN(C, 16, 2, dropout=0.0, dtype=P),
                 JaxRelCNN(R_IN, R_IN, 2, dtype=P), num_steps=2, k=K,
                 fused_sparse_consensus=True, dtype=P)

    def jg(a):
        return JaxGraphBatch(**{k: jnp.asarray(v) for k, v in a.items()},
                             edge_attr=None)

    g_s, g_t = jg(s), jg(t)
    params = jax.device_get(jax.jit(lambda a, b: jm.init(
        {'params': jax.random.key(0), 'noise': jax.random.key(1)}, a, b))(
            g_s, g_t)['params'])
    rngs = {'noise': jax.random.key(3), 'negatives': jax.random.key(4),
            'dropout': jax.random.key(5)}

    def forward(params):
        seen = []

        def capture(next_fun, args, kwargs, context):
            if (context.module.name == 'psi_2'
                    and context.method_name == '__call__' and not seen):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(capture):
            S_0, S_L = jm.apply({'params': params}, g_s, g_t,
                                y=jnp.asarray(y), y_mask=jnp.asarray(y_mask),
                                train=True, num_steps=num_steps,
                                detach=detach, rngs=rngs)
        loss = jmetrics.nll_loss(S_L, jnp.asarray(y), jnp.asarray(y_mask))
        return loss, (S_0.idx, S_L.val, seen[0] if seen else None)

    (jloss, (idx, vL, packed)), jgrads = jax.jit(jax.value_and_grad(
        forward, has_aux=True))(params)
    idx = np.array(idx)
    r_s = None
    if packed is not None:   # [B, N_s, T * R_in], steps packed channel-wise
        r_s = _t16(_np(packed).reshape(B, N_S, num_steps, R_IN).transpose(
            2, 0, 1, 3))
    tm = DGMC(RelCNN(C, 16, 2, dtype=precision.BF16),
              RelCNN(R_IN, R_IN, 2, dtype=precision.BF16), num_steps=2, k=K,
              dtype=precision.BF16)
    tm.load_state_dict(dgmc_from_flax(params))
    tm.train()
    dispatch.reset()
    S_0, S_L = tm(tgraph.GraphBatch.from_numpy(s, 'cpu'),
                  tgraph.GraphBatch.from_numpy(t, 'cpu'),
                  y=torch.from_numpy(y).long(),
                  y_mask=torch.from_numpy(y_mask), num_steps=num_steps,
                  detach=detach, r_s=r_s,
                  negatives=torch.from_numpy(idx[..., K:]).long())
    loss = metrics.nll_loss(S_L, torch.from_numpy(y).long(),
                            torch.from_numpy(y_mask))
    assert S_L.val.dtype == loss.dtype == torch.float32
    np.testing.assert_array_equal(S_0.idx.numpy(), idx)
    _close(S_L.val, vL, SLICE_LOSS_RTOL, 'S_L')
    d = dispatch.decisions()
    assert d['topk']['dtype'] == 'bfloat16'
    if num_steps:
        assert d['sparse_consensus_fwd']['dtype'] == 'bfloat16'
    loss.backward()
    _hold_slice(loss, jloss, tm, dgmc_from_flax(jax.device_get(jgrads)),
                SPARSE_GRAD_TOL, skip=('psi_1.',) if detach else ())
    # The exact derivative of the port's own bf16 forward.
    e_loss, e_grads = _sparse_slice_exact(
        tm, tgraph.GraphBatch.from_numpy(s, 'cpu'),
        tgraph.GraphBatch.from_numpy(t, 'cpu'), torch.from_numpy(y).long(),
        torch.from_numpy(y_mask), S_L.idx, r_s, num_steps, detach)
    np.testing.assert_allclose(loss.item(), e_loss.item(), rtol=1e-5)
    for name, p in tm.named_parameters():
        if name in ZERO_GRAD:
            continue
        if e_grads[name] is None:   # unused by this forward, or detached
            assert p.grad is None, name
        else:
            _close_norm(p.grad, e_grads[name], SPARSE_EXACT_TOL, name)


# -- Both CLIs under each policy -------------------------------------------

@pytest.mark.parametrize('policy', ['--bf16', '--f32'])
def test_pascal_pf_cli_under_each_policy_logs_metrics(policy, tmp_path,
                                                      cublas_flags,
                                                      monkeypatch):
    """One epoch of a 32-pair training stream (the CLI's is 1024 pairs
    long), then the held-out evaluation."""
    monkeypatch.setattr(pascal_pf, 'RandomGraphPairs', functools.partial(
        RandomGraphPairs, length=32))
    log = tmp_path / 'pf.jsonl'
    cublas_flags.allow_bf16_reduced_precision_reduction = True
    dispatch.reset()
    state = pascal_pf.main(['--device', 'cpu', policy, '--epochs', '1',
                            '--batch_size', '16', '--dim', '8', '--rnd_dim',
                            '4', '--num_steps', '1', '--synthetic_eval', '8',
                            '--metrics_log', str(log)])
    assert not cublas_flags.allow_bf16_reduced_precision_reduction
    want = 'bfloat16' if policy == '--bf16' else 'float32'
    assert dispatch.decisions()['consensus_fwd']['dtype'] == want
    for group in state.optimizer.param_groups:
        assert all(p.dtype == torch.float32 for p in group['params'])
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [sorted(r) for r in recs] == [
        ['loss', 'step', 'time', 'train_acc'],
        ['step', 'synthetic_eval_acc', 'time']]
    assert all(r['step'] == 1 for r in recs)
    assert np.isfinite(recs[0]['loss']) and 0 <= recs[1][
        'synthetic_eval_acc'] <= 1


@pytest.mark.parametrize('policy', ['--bf16', '--f32'])
def test_dbp15k_cli_under_each_policy_logs_metrics(policy, tmp_path,
                                                   cublas_flags):
    log = tmp_path / 'kg.jsonl'
    log.write_text('{"step": 0, "time": 0.0, "note": "appended to"}\n')
    cublas_flags.allow_bf16_reduced_precision_reduction = True
    dispatch.reset()
    dbp15k.main(['--device', 'cpu', policy, '--synthetic', '--syn_nodes_s',
                 '60', '--syn_nodes_t', '80', '--syn_edges_s', '200',
                 '--syn_edges_t', '240', '--syn_dim', '12', '--dim', '8',
                 '--rnd_dim', '4', '--num_layers', '2', '--num_steps', '1',
                 '--epochs', '11', '--phase1_epochs', '10',
                 '--metrics_log', str(log)])
    assert not cublas_flags.allow_bf16_reduced_precision_reduction
    want = 'bfloat16' if policy == '--bf16' else 'float32'
    d = dispatch.decisions()
    assert d['topk']['dtype'] == d['sparse_consensus_bwd']['dtype'] == want
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert recs[0]['note'] == 'appended to'
    assert [(r['step'], r['phase']) for r in recs[1:]] == [(10, 1), (11, 2)]
    for r in recs[1:]:
        assert sorted(r) == ['hits1', 'hits10', 'loss', 'phase', 'step',
                             'time']
        assert np.isfinite(r['loss']) and 0 <= r['hits1'] <= r['hits10'] <= 1
