"""The port's ring of target shards in the rank-sharded candidate search
(``corr_sharded_topk(..., ring=True)``, ``dgmc_tpu_torch/parallel/
topk.py``) held against JAX's ring (``dgmc_tpu.parallel.topk``) on a 2-
and a 4-device mesh and against ``dense_topk``, on gloo ranks, each a CPU
process. The cases are ``tests/parallel/test_ring_topk.py``'s: ragged
targets (padded to the ring), value ties across shard boundaries, random
masks, chunk streaming, all-equal scores (the lowest columns, though the
shards arrive rotated) and ``k`` above a shard's columns (the whole
targets instead). Each rank visits the shards in JAX's rotation order,
each from its own copy of the targets (ψ₁ runs whole on every rank, so
the ring moves no data: ``test_ring_moves_no_data``). Indices must be
equal, bit for bit."""

import numpy as np
import pytest

from tests.test_torch_parallel_topk import WORLDS, hold, ring_cases
from tests.torch_dist_worker import run_groups


@pytest.fixture(scope='module')
def ranks():
    results = run_groups([('tests.torch_parallel_jobs:topk_cases', w,
                           (ring_cases(w),)) for w in WORLDS])
    return dict(zip(WORLDS, results))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(ring_cases(2)))
def test_ring_matches_jax_and_dense(ranks, world, name):
    hold([r[name] for r in ranks[world]], world, *ring_cases(world)[name])


def test_all_equal_ring_is_the_lowest_columns(ranks):
    for world in WORLDS:
        np.testing.assert_array_equal(ranks[world][0]['ring-all-equal'],
                                      np.tile(np.arange(5), (1, 16, 1)))
