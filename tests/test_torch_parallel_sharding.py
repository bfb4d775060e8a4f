"""The port's sharded train and eval steps (``dgmc_tpu_torch/parallel/
sharding.py``) on gloo ranks, each a CPU process, at world size 2 and 4,
held against the one-process step and against JAX's sharded step
(``dgmc_tpu.parallel.make_sharded_train_step`` on two virtual CPU
devices).

Cases (``tests/parallel/test_sharding.py``): data parallelism
(``test_dp_matches_single_device``: the dense tiny model, B = 4, each
rank its slice of the batch, ``loss_on_s0``; the port's own case also
with dropout 0.5 after ψ₁, the masks each rank's block of the whole
batch's) and correspondence sharding
(``test_corr_sharding_matches_unconstrained``: the rows over the model
axis, k = 4 and k = -1, N_s = 12 rows padded to the rank count). JAX's
cases run on JAX's weights with JAX's random draws injected (its noise
captured on ψ₂'s calls, its negatives read back from ``S_0.idx``); the
port's own cases on the port's weights and draws. One SGD step (lr 1e-2,
as JAX's test: Adam's division would magnify the float noise of the
reordered sums in near-zero gradients).

Tolerances: the loss within rel 1e-5 of the one-process step and rel
1e-4 of JAX's sharded step (JAX's own bound); the accuracy equal; the
parameters after the update within atol 1e-6 / rtol 1e-5 of both (the
sums across ranks are in another order than one process's); every rank
bit-identical to every other.
"""

import numpy as np
import pytest

from tests import torch_parallel_jobs as jobs
from tests.torch_dist_worker import run_groups
from tests.torch_parallel_ref import case as jax_case

WORLDS = (2, 4)
JAX_CASES = ('dp', 'corr4', 'corr-1')
#: The port's own cases: (name, layout, k, batch size).
PORT_CASES = (('port-dp', 'data', -1, 4), ('port-dp-drop', 'data', -1, 4),
              ('port-corr4', 'corr', 4, 2),
              ('port-corr-1', 'corr', -1, 2))


@pytest.fixture(scope='module')
def cases():
    ports = {name: jobs.port_case(name, layout, k, b)
             for name, layout, k, b in PORT_CASES}
    wants = {}
    for name in JAX_CASES:
        ports[name], wants[name] = jax_case(name)
    return ports, wants


@pytest.fixture(scope='module')
def ranks(cases):
    ports, _ = cases
    out = run_groups([('tests.torch_parallel_jobs:step_cases', w, (ports,))
                      for w in WORLDS])
    return dict(zip(WORLDS, out))


@pytest.fixture(scope='module')
def single(cases):
    return {name: jobs.one_step(c, False) for name, c in cases[0].items()}


def _hold_state(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


NAMES = [n for n, *_ in PORT_CASES] + list(JAX_CASES)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', NAMES)
def test_sharded_step_matches_one_process(ranks, single, world, name):
    got, want = ranks[world][0][name], single[name]
    for other in ranks[world][1:]:
        for key in got['state']:
            np.testing.assert_array_equal(other[name]['state'][key],
                                          got['state'][key])
    m, w = got['metrics'], want['metrics']
    assert float(m['loss']) == pytest.approx(float(w['loss']), rel=1e-5)
    assert float(m['acc']) == float(w['acc'])
    np.testing.assert_allclose(m['loss_per_pair'], w['loss_per_pair'],
                               rtol=1e-5)
    _hold_state(got['state'], want['state'])


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', [
    'dp', 'corr4', pytest.param('corr-1', marks=pytest.mark.slow)])
def test_sharded_step_matches_jax_sharded_step(cases, ranks, world, name):
    """JAX's dense corr-sharding case is marked slow where JAX marks it
    (its sharded compile); the port's side of it runs above."""
    got, want = ranks[world][0][name], cases[1][name]
    m, w = got['metrics'], want['metrics']
    assert float(m['loss']) == pytest.approx(float(w['loss']), rel=1e-4)
    assert float(m['acc']) == pytest.approx(float(w['acc']), abs=1e-6)
    np.testing.assert_allclose(m['loss_per_pair'], w['loss_per_pair'],
                               rtol=1e-4)
    _hold_state(got['state'], want['state'])


@pytest.mark.parametrize('parts', [2, 4])
def test_batch_block_dropout_is_the_whole_batch_mask(parts):
    """A rank's dropout masks (:class:`~dgmc_tpu_torch.models.rel.
    BatchBlock`) are its block of the mask one process draws for the
    whole batch, bit for bit, and the generator ends where one process's
    does; different blocks draw different masks."""
    import torch
    from dgmc_tpu_torch.models.rel import BatchBlock, dropout
    h = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(1))
    one = torch.Generator().manual_seed(7)
    whole = dropout(h, 0.5, one)
    per = 4 // parts
    blocks = []
    for index in range(parts):
        gen = torch.Generator().manual_seed(7)
        blocks.append(dropout(h[index * per:(index + 1) * per], 0.5,
                              BatchBlock(gen, parts, index)))
        assert torch.equal(gen.get_state(), one.get_state())
    torch.testing.assert_close(torch.cat(blocks), whole, rtol=0, atol=0)
    own = dropout(h[per:2 * per], 0.5, torch.Generator().manual_seed(7))
    assert not torch.equal(own != 0, blocks[1] != 0)


def test_capture_decision_is_recorded(monkeypatch):
    """A step on the card is captured with its collectives under NCCL and
    runs eagerly under gloo, each recorded as ``sharded_step``; the CPU
    records nothing and runs the static-buffer code."""
    import torch
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.parallel import sharding

    class Mesh:
        device = torch.device('cuda')

        def group(self, axis=None):
            return 'g'

    for backend, path, want in (('gloo', 'eager', False),
                                ('nccl', 'captured', True)):
        monkeypatch.setattr(sharding, 'backend_of', lambda g: backend)
        dispatch.reset()
        assert sharding._jit_for(Mesh(), True) is want
        d = dispatch.decisions()['sharded_step']
        assert (d['path'], d['reason']) == (path, f'backend={backend}')
    assert sharding._jit_for(Mesh(), False) is False
    Mesh.device = torch.device('cpu')
    dispatch.reset()
    assert sharding._jit_for(Mesh(), True) is True
    assert 'sharded_step' not in dispatch.decisions()
