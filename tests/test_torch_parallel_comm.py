"""The collectives the sharded ψ₁ tables need
(``dgmc_tpu_torch/parallel/comm.py``), on 2 and 4 gloo ranks, each a CPU
process (:mod:`tests.torch_dist_worker`):

- :func:`collective_permute` moves float32, bfloat16, int32 and bool
  tensors bit for bit from each rank to its right neighbour, one at a
  time and all four in one call, whose handle is waited on after another
  collective has run;
- :func:`all_gather_grad`'s backward gives each rank the sum over the
  ranks of the gradient at its own rows, added in rank order (rank 0
  first), bit for bit;
- each call is one op on a tape (``TapeRecorder``): the permute an
  asynchronous ``collective-permute`` start with the bytes it sends,
  joined by a ``wait``; the gathered forward an ``all-gather`` and its
  backward a ``reduce-scatter``, each with its result's bytes (JAX's
  payload)."""

import numpy as np
import pytest

from tests import torch_parallel_jobs as jobs
from tests.torch_dist_worker import run_groups

WORLDS = (2, 4)
DTYPES = ('float32', 'bfloat16', 'int32', 'bool')


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ranks():
    out = run_groups([('tests.torch_parallel_jobs:comm_job', w, ())
                      for w in WORLDS])
    return dict(zip(WORLDS, out))


def _sent(rank):
    import torch
    sent = jobs._rank_tensors(rank)
    return {k: (v.view(torch.int16) if k == 'bfloat16' else v).numpy()
            for k, v in sent.items()}


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('dtype', DTYPES)
def test_permute_moves_each_dtype_to_the_right_neighbour(ranks, world,
                                                         dtype):
    for r, got in enumerate(ranks[world]):
        want = _sent((r - 1) % world)[dtype]
        assert got['single'][dtype].dtype == want.dtype
        np.testing.assert_array_equal(got['single'][dtype], want)
        np.testing.assert_array_equal(got['tuple'][DTYPES.index(dtype)],
                                      want)


@pytest.mark.parametrize('world', WORLDS)
def test_permute_handle_waits_after_other_work(ranks, world):
    for got in ranks[world]:
        assert got['after_other_work'] == float(world)
        assert got['route'] == 'gloo, cpu tensors'


@pytest.mark.parametrize('world', WORLDS)
def test_all_gather_grad_sums_the_ranks_gradients_in_rank_order(ranks,
                                                                world):
    for r, got in enumerate(ranks[world]):
        want = None
        for q in range(world):
            part = ranks[world][q]['w'][:, 3 * r:3 * (r + 1)]
            want = part.copy() if want is None else \
                (want + part).astype(np.float32)
        np.testing.assert_array_equal(got['grad'], want)


@pytest.mark.parametrize('world', WORLDS)
def test_each_call_is_one_op_on_the_tape(ranks, world):
    tape = ranks[world][0]['tape']
    start = [i for i, op in enumerate(tape) if op[0] == 'collective'
             and op[1] == 'collective-permute']
    assert len(start) == 1
    # float32 [2, 3, 5] and bool [2, 3, 5] in one call.
    assert tape[start[0]][2:4] == (30 * 4 + 30, True)
    waits = [op for op in tape if op[0] == 'wait']
    assert len(waits) == 1
    rows = [op[1:3] for op in tape if op[1] in ('all-gather',
                                                'reduce-scatter')]
    # The forward's [2, 3n, 4] and the backward's [2, 3, 4], float32.
    assert rows == [('all-gather', 2 * 3 * world * 4 * 4),
                    ('reduce-scatter', 2 * 3 * 4 * 4)]
    assert {tuple(r['tape']) for r in ranks[world]} == {tuple(tape)}
