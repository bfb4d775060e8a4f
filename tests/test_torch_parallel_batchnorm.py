"""Batch norm under the port's data parallelism: statistics over the
global batch (``tests/parallel/test_batchnorm_dp.py``'s contract).

The sharded step sums ``MaskedBatchNorm``'s masked sums, sums of squares
and counts over the data group (each batch norm's ``stats_group``, which
``models/norm.sync_batch_stats`` sets on the step's model), so
the loss and the running averages after a step over 2 and 4 gloo ranks
(each a CPU process with its slice of the B = 8 batch) equal the
one-process step's on the whole batch, and JAX's sharded step's on two
virtual devices (with JAX's weights and indicator noise). Tolerances:
the loss within rel 1e-5 of both, the running averages and parameters
within atol 1e-5 / rtol 1e-5 (JAX's)."""

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.models.norm import MaskedBatchNorm, sync_batch_stats
from tests import torch_parallel_jobs as jobs
from tests.torch_dist_worker import run_groups
from tests.torch_parallel_ref import case as jax_case

WORLDS = (2, 4)


@pytest.fixture(scope='module')
def cases():
    port, want = jax_case('bn')
    return {'bn': port, 'port-bn': jobs.port_case('bn', 'data', -1, 8)}, want


@pytest.fixture(scope='module')
def ranks(cases):
    out = run_groups([('tests.torch_parallel_jobs:step_cases', w,
                       (cases[0],)) for w in WORLDS])
    return dict(zip(WORLDS, out))


def _stats(state):
    return {k: v for k, v in state.items() if k.endswith(('.mean', '.var'))}


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['bn', 'port-bn'])
def test_bn_stats_match_single_device(cases, ranks, world, name):
    one = jobs.one_step(cases[0][name], False)
    got = ranks[world][0][name]
    assert _stats(one['state']), 'expected running averages'
    np.testing.assert_allclose(float(got['metrics']['loss']),
                               float(one['metrics']['loss']), rtol=1e-5)
    for key, w in one['state'].items():
        np.testing.assert_allclose(got['state'][key], w, atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    if name == 'bn':
        want = cases[1]
        np.testing.assert_allclose(float(got['metrics']['loss']),
                                   float(want['metrics']['loss']), rtol=1e-5)
        for key, w in _stats(want['state']).items():
            np.testing.assert_allclose(got['state'][key], w, atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def test_per_rank_statistics_would_differ(cases):
    """The check has teeth: one rank's half of the batch alone gives other
    running averages than the whole batch's."""
    half = cases[0]['port-bn']
    b = half['batch']
    cut = type(b)(s={k: v[:4] for k, v in b.s.items()},
                  t={k: v[:4] for k, v in b.t.items()}, y=b.y[:4],
                  y_mask=b.y_mask[:4])
    whole = jobs.one_step(half, False)['state']
    part = jobs.one_step(dict(half, batch=cut), False)['state']
    assert any(np.abs(whole[k] - part[k]).max() > 1e-3
               for k in _stats(whole))


def test_no_group_leaves_one_rank_statistics():
    """Without a group (``sync_batch_stats(model, None)``, a batch norm's
    default) the statistics are this rank's batch's, bit for bit the
    plain path's; the group is set on every batch norm of a model."""
    bn = MaskedBatchNorm(3).train()
    assert bn.stats_group is None
    x = torch.randn(2, 5, 3)
    mask = torch.arange(5)[None].expand(2, 5) < torch.tensor([[4], [2]])
    want = bn(x, mask)
    bn.reset_parameters()
    model = torch.nn.Sequential(torch.nn.Identity(), bn)
    assert sync_batch_stats(model, 'g') is model and bn.stats_group == 'g'
    sync_batch_stats(model, None)
    got = bn(x, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
