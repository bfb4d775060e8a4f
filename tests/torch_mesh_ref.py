"""The JAX side of the mesh specimen tests: JAX's five mesh specimens
(``dgmc_tpu/analysis/registry.py``) built and run on the forced CPU
devices, their random draws captured (:func:`tests.torch_parallel_ref.
_draws`) and their parameters converted (``dgmc_tpu_torch/convert.py``),
so that the port's specimens can run on the same weights and draws."""

import jax
import numpy as np

from dgmc_tpu.models import DGMC, RelCNN
from tests.torch_jax_worker import jax_analysis
from tests.torch_parallel_ref import _draws, _state_dict, port_batch

#: JAX's mesh specimens, in its order.
MESH = ('parallel.sharded_train_step', 'parallel.sharded_forward_rows',
        'parallel.sharded_train_step_pairs2', 'parallel.streamed_train_step',
        'parallel.sharded_topk_cols')


def _model(k):
    return DGMC(RelCNN(4, 8, num_layers=1), RelCNN(4, 4, num_layers=1),
                num_steps=1, k=k)


def _repeat(jb, reps):
    return jax.tree.map(lambda x: np.repeat(np.asarray(x), reps, 0), jb)


def mesh_cases():
    """``(inject, want, tables)``: per specimen the port's injection
    (``{'state_dict', 'r_s', 'negatives'}``), JAX's outputs (``loss``,
    ``params`` after the step, ``S_0`` / ``S_L``, ``idx``) and JAX's
    collective table (``hlo_comm.collective_table`` of the compiled
    program: ``obs.cost``'s row)."""
    from dgmc_tpu.train import create_train_state
    inject, want, tables = {}, {}, {}
    with jax_analysis('dgmc_tpu.analysis.registry',
                      'dgmc_tpu.analysis.hlo_comm') as m:
        reg, hc = m['registry'], m['hlo_comm']
        specs = {s.name: s for s in reg.default_specimens()}
        cache = reg.SpecimenCache()
        for name in MESH:
            art = cache.artifacts(specs[name])
            built = art.built()
            compiled = art.compiled()
            tables[name] = hc.collective_table(compiled.as_text())
            if name == 'parallel.sharded_topk_cols':
                want[name] = {'idx': np.asarray(compiled(*built['args']))}
                continue
            k = 4 if name == 'parallel.streamed_train_step' else -1
            jm = _model(k)
            if name == 'parallel.streamed_train_step':
                one = reg._pair_batch(np.random.RandomState(0), n_s=16,
                                      e_s=32, n_t=32, e_t=64)
                jb = one
            else:
                one = reg._pair_batch(np.random.RandomState(0))
                jb = _repeat(one, {'parallel.sharded_train_step': 2,
                                   'parallel.sharded_forward_rows': 2}.get(
                                       name, 4))
            if name == 'parallel.sharded_forward_rows':
                params = jax.device_get(built['args'][0])
                r_s, _ = _draws(jm, {'params': params}, jb,
                                jax.random.key(1), False, k)
                S_0, S_L = compiled(*built['args'])
                inject[name] = {'state_dict': _params(params), 'r_s': r_s}
                want[name] = {'S_0': np.asarray(S_0.val),
                              'S_L': np.asarray(S_L.val)}
                continue
            state = create_train_state(jm, jax.random.key(0), one,
                                       learning_rate=1e-3)
            r_s, neg = _draws(jm, {'params': state.params}, jb,
                              jax.random.key(1), True, k)
            new, metrics = compiled(*built['args'])
            inject[name] = {'state_dict': _state_dict(state), 'r_s': r_s,
                            'negatives': neg}
            want[name] = {'loss': float(metrics['loss']),
                          'params': _params(jax.device_get(new.params))}
    return inject, want, tables


def _params(params):
    from dgmc_tpu_torch.convert import dgmc_from_flax
    return {k: v.numpy() for k, v in dgmc_from_flax(params).items()}


__all__ = ['MESH', 'mesh_cases', 'port_batch']
