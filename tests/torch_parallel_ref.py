"""The JAX side of the port's sharded-step tests: JAX's cases
(``tests/parallel/test_sharding.py``, ``test_batchnorm_dp.py``,
``test_rules.py``), its sharded steps on the virtual CPU devices, and its
random draws captured so that the port's steps can be run on the same
ones (:mod:`tests.torch_parallel_jobs` runs them on the ranks)."""

import jax
import numpy as np
import optax
from flax import linen as nn

from dgmc_tpu import parallel as jpar
from dgmc_tpu.models import DGMC as JaxDGMC
from dgmc_tpu.models import RelCNN as JaxRelCNN
from dgmc_tpu.ops.graph import GraphBatch as JaxGraphBatch
from dgmc_tpu.train import create_train_state, make_eval_step
from dgmc_tpu.utils.data import PairBatch as JaxPairBatch
from dgmc_tpu_torch.convert import dgmc_from_flax
from dgmc_tpu_torch.utils.data import PairBatch
from tests import torch_parallel_jobs as jobs
from tests.train.test_steps import tiny_loader, tiny_model

GRAPH_KEYS = ('x', 'senders', 'receivers', 'node_mask', 'edge_mask',
              'edge_attr')
LR = 1e-2


def port_batch(jb):
    """A JAX ``PairBatch`` as the port's host batch (the same arrays)."""
    def side(g):
        return {k: np.asarray(getattr(g, k)) for k in GRAPH_KEYS
                if getattr(g, k) is not None}
    return PairBatch(s=side(jb.s), t=side(jb.t), y=np.asarray(jb.y),
                     y_mask=np.asarray(jb.y_mask))


def _draws(jm, variables, jb, key, train, k):
    """JAX's indicator noise ``[T, B, N_s, R]`` (and, training a sparse
    model, its negatives) under ``key`` as its train step (``train``) or
    eval step splits it."""
    rngs = ({'noise': key} if not train else dict(zip(
        ('noise', 'negatives', 'dropout'), jax.random.split(key, 3))))
    mutable = ['batch_stats'] if 'batch_stats' in variables else False

    def forward(variables):
        seen = []

        def capture(next_fun, args, kwargs, context):
            if (context.module.name == 'psi_2'
                    and context.method_name == '__call__'):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(capture):
            out = jm.apply(variables, jb.s, jb.t, y=jb.y, y_mask=jb.y_mask,
                           train=train, rngs=rngs, mutable=mutable)
        S_0, _ = out[0] if mutable else out
        return seen, S_0.idx

    seen, idx = jax.jit(forward)(variables)
    T, R = jm.num_steps, jm.psi_2.in_channels
    B, N = np.shape(jb.y)
    first = np.asarray(seen[0])
    if T > 1 and first.shape[-1] == T * R:   # ψ₂'s source side packed
        r_s = first.reshape(B, N, T, R).transpose(2, 0, 1, 3)
    else:                                     # source, then target
        r_s = np.stack([np.asarray(s) for s in seen[0::2]])
    neg = None
    if train and k > 0:
        neg = np.asarray(idx)[..., k:].astype(np.int64)
    return np.ascontiguousarray(r_s, np.float32), neg


def bn_batch():
    """The batch-norm case's batch (:func:`tests.torch_parallel_jobs.
    bn_batch`) as JAX's."""
    b = jobs.bn_batch()

    def side(g):
        return JaxGraphBatch(edge_attr=None, **g)
    return JaxPairBatch(s=side(b.s), t=side(b.t), y=b.y, y_mask=b.y_mask)


def _state_dict(state):
    stats = jax.device_get(state.batch_stats) if state.batch_stats else None
    return {k: v.numpy() for k, v in dgmc_from_flax(
        jax.device_get(state.params), stats).items()}


def case(name):
    """``(port case, JAX's sharded results)`` of one of JAX's cases:
    ``dp`` (``test_dp_matches_single_device``), ``bn``
    (``test_bn_stats_match_single_device``), ``corr4`` / ``corr-1``
    (``test_corr_sharding_matches_unconstrained`` at k = 4 / -1) and
    ``streamed`` (``test_streamed_rules_train_eval_match_reference``), JAX
    on a two-device mesh; the port case carries the converted parameters,
    JAX's draws and the layout the ranks take."""
    key = jax.random.key(1 if name in ('dp', 'bn') else 2)
    if name == 'bn':
        jb = bn_batch()
        jm = JaxDGMC(JaxRelCNN(4, 6, num_layers=1, batch_norm=True),
                     JaxRelCNN(4, 4, num_layers=1), num_steps=1, k=-1)
        spec, k, loss_on_s0 = ('bn_rel',), -1, False
    else:
        k = {'dp': -1, 'corr4': 4, 'corr-1': -1, 'streamed': 4}[name]
        jm = tiny_model(k=k)
        jb = next(iter(tiny_loader(batch_size={'dp': 4, 'streamed': 1}.get(
            name, 2))))
        spec, loss_on_s0 = ('spline', k, jm.num_steps), name == 'dp'
    state = jax.jit(lambda b: create_train_state(
        jm, jax.random.key(0), b, tx=optax.sgd(LR)))(jb)
    variables = {'params': state.params}
    if state.batch_stats:
        variables['batch_stats'] = state.batch_stats
    r_s, neg = _draws(jm, variables, jb, key, True, k)
    port = {'model': spec, 'state_dict': _state_dict(state), 'lr': LR,
            'batch': port_batch(jb), 'r_s': r_s, 'negatives': neg,
            'loss_on_s0': loss_on_s0,
            'layout': {'dp': 'data', 'bn': 'data', 'streamed': 'rows'}.get(
                name, 'corr'), 'chunk': 4}
    host = jax.tree.map(np.asarray, state)
    devices = jax.devices()[:2]
    if name in ('dp', 'bn'):
        mesh = jpar.make_mesh(data=2, model=1, devices=devices)
        step = jpar.make_sharded_train_step(jm, mesh, loss_on_s0=loss_on_s0)
        new, out = step(jpar.replicate(host, mesh),
                        jpar.shard_batch(jb, mesh), key)
    elif name.startswith('corr'):
        mesh = jpar.make_mesh(data=1, model=2, devices=devices)
        sharded = JaxDGMC(jm.psi_1, jm.psi_2, num_steps=jm.num_steps, k=k,
                          corr_sharding=jpar.corr_sharding(mesh))
        step = jpar.make_sharded_train_step(sharded, mesh, batch_axis=None)
        new, out = step(jpar.replicate(host, mesh),
                        jpar.replicate(jb, mesh), key)
    else:
        mesh = jpar.make_mesh(data=2, model=1, devices=devices)
        rules = jpar.streamed_rules(stream_chunk=4)
        step = jpar.make_sharded_train_step(jm, mesh, rules=rules,
                                            state=state)
        state_sh, batch_sh = rules.place(host, jb, mesh)
        new, out = step(state_sh, batch_sh, key)
        ev_key = jax.random.key(3)
        port['eval_r_s'], _ = _draws(jm, variables, jb, ev_key, False, k)
        ev = jpar.make_sharded_eval_step(jm, mesh, hits_ks=(1,),
                                         rules=rules, state=state)(
            rules.place(host, jb, mesh)[0], batch_sh, ev_key)
        ref = make_eval_step(jm, hits_ks=(1,))(state, jb, ev_key)
        out = dict(out, eval=jax.device_get(ev),
                   eval_ref=jax.device_get(ref))
    want = {'metrics': jax.device_get(
        {k: v for k, v in out.items() if not k.startswith('eval')}),
        'state': _state_dict(new)}
    if 'eval' in out:
        want['eval'], want['eval_ref'] = out['eval'], out['eval_ref']
    return port, want
