"""JAX's five mesh specimens in the port (``dgmc_tpu_torch/analysis/
registry.py``), run on one group of 4 gloo ranks (each a CPU process
pinned to one thread, ``tests.torch_dist_worker``) through the registry's
rank recorder, each rank's records gathered as a world of enough ranks
gathers them (``analysis/ranks.py``), held against JAX's same specimens
on the forced CPU devices (``tests/torch_mesh_ref.py``): JAX's weights,
converted by ``convert.py``, and JAX's draws injected.

- Outputs: the column-sharded top-k's indices bit-equal; the train
  steps' losses and updated parameters within rtol / atol 1e-5 (Adam's
  first update is ``lr * g / (|g| + eps)``: the two parameters whose
  gradient is zero in exact arithmetic move by noise and are left out,
  as in ``tests/test_torch_specimens.py``); the row-sharded forward's
  S blocks within rtol / atol 1e-5.
- The tiers: the trace tier over ``parallel.sharded_train_step`` and the
  SHD and SCH/MEM tiers over all five give no finding outside
  ``lint-baseline-torch.json``.
- The gradient all-reduce's payload is 4 bytes x the trained values.
- The port's collective table is printed beside JAX's ``obs.cost`` row
  of the same specimen (``python -m pytest -s``).
"""

import os

import numpy as np
import pytest

from dgmc_tpu_torch.analysis.comm import collective_schedule, collective_table
from dgmc_tpu_torch.analysis.findings import (default_baseline_path,
                                              load_baseline,
                                              split_by_baseline)
from tests.torch_dist_worker import run_groups
from tests.torch_mesh_ref import MESH, mesh_cases

#: Parameters whose gradient is zero in exact arithmetic.
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def cases():
    return mesh_cases()


@pytest.fixture(scope='module')
def ranks(cases):
    inject = cases[0]
    (out,) = run_groups([('tests.torch_parallel_jobs:mesh_specimens', 4,
                          (inject,))], timeout=300)
    # Every rank gathered every rank's records.
    assert all(list(o) == list(out[0]) for o in out[1:])
    return out[0]


def test_every_mesh_specimen_ran_on_its_ranks(ranks):
    assert list(ranks) == list(MESH)
    for name, recs in ranks.items():
        want = 2 if name in ('parallel.sharded_train_step',
                             'parallel.sharded_topk_cols') else 4
        assert [r['rank'] for r in recs] == list(range(want)), name
        for r in recs:
            assert (r['stats']['builds'], r['stats']['runs']) == (1, 1)


def test_sharded_topk_cols_indices_are_jax_bit_for_bit(cases, ranks):
    want = cases[1]['parallel.sharded_topk_cols']['idx']
    for r in ranks['parallel.sharded_topk_cols']:
        np.testing.assert_array_equal(r['output']['result'], want)


@pytest.mark.parametrize('name', ['parallel.sharded_train_step',
                                  'parallel.sharded_train_step_pairs2',
                                  'parallel.streamed_train_step'])
def test_train_step_loss_and_update_equal_jax(cases, ranks, name):
    want = cases[1][name]
    for r in ranks[name]:
        _, metrics = r['output']['result']
        np.testing.assert_allclose(float(metrics['loss']), want['loss'],
                                   **TOL)
        got = r['output']['params']
        assert set(got) == set(want['params'])
        for key, value in want['params'].items():
            if key not in ZERO_GRAD:
                np.testing.assert_allclose(got[key], value, **TOL,
                                           err_msg=f'{name} {key}')


def test_row_sharded_forward_blocks_equal_jax(cases, ranks):
    want = cases[1]['parallel.sharded_forward_rows']
    for r in ranks['parallel.sharded_forward_rows']:
        d, m = divmod(r['rank'], 2)
        S_0, S_L = r['output']['result']
        for got, key in ((S_0, 'S_0'), (S_L, 'S_L')):
            block = got['val']
            rows = block.shape[1]
            np.testing.assert_allclose(
                block, want[key][d:d + 1, m * rows:(m + 1) * rows], **TOL,
                err_msg=f'{key} rank {r["rank"]}')


def test_tiers_are_clean_against_the_baseline(ranks):
    from dgmc_tpu_torch.analysis.registry import (SpecimenCache,
                                                  default_specimens,
                                                  run_trace_tier)
    from dgmc_tpu_torch.analysis.sched_rules import run_sched_tier
    from dgmc_tpu_torch.analysis.shd_rules import run_sharded_tier
    cache = SpecimenCache('cpu')
    cache.mesh_runs().adopt(ranks)
    mesh = [s for s in default_specimens() if s.min_devices]
    found = (run_trace_tier(mesh, cache=cache)
             + run_sharded_tier(mesh, cache=cache)
             + run_sched_tier(mesh, cache=cache))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    new, _ = split_by_baseline(found, load_baseline(
        default_baseline_path(root)))
    assert new == [], [(f.rule, f.where, f.message) for f in new]
    assert not [f for f in found if f.rule[:3] in ('SHD', 'SCH', 'MEM')]


def test_gradient_all_reduce_carries_4_bytes_a_trained_value(ranks):
    from dgmc_tpu_torch.analysis.registry import specimen_model
    model = specimen_model(-1, 1)
    every = sum(p.numel() for p in model.parameters())
    trained = {
        'parallel.sharded_train_step': every,
        'parallel.sharded_train_step_pairs2': every,
        # Phase 2: ψ₁ detached, its parameters take no gradient.
        'parallel.streamed_train_step': every - sum(
            p.numel() for p in model.psi_1.parameters())}
    for name, n in trained.items():
        grads = [c for c in collective_schedule(ranks[name][0]['tape'])
                 if c.source_loc and 'sharding.py' in c.source_loc
                 and c.kind == 'all-reduce' and len(c.shape) == 1
                 and c.shape[0] > 2]
        assert [(c.dtype, c.nbytes) for c in grads] == [('float32', 4 * n)]


def test_collective_tables_beside_jax(cases, ranks, capsys):
    tables = cases[2]
    with capsys.disabled():
        for name in MESH:
            print(f'\n{name}: port (rank 0) '
                  f'{collective_table(ranks[name][0]["tape"])} | JAX '
                  f'obs.cost {tables[name]}')
    for name in MESH:
        assert collective_table(ranks[name][0]['tape'])['count'] > 0


# The launcher (``analysis/ranks.py``'s ``RankRun``) over stand-in ranks
# that import no torch.

def _stand_ins(tmp_path, bodies):
    import subprocess
    import sys
    from dgmc_tpu_torch.analysis.ranks import RankRun
    procs = []
    for r, body in enumerate(bodies):
        with open(tmp_path / f'rank{r}.log', 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, '-c', body.format(
                    pkl=str(tmp_path / f'rank{r}.pkl'), r=r)],
                stdout=log, stderr=subprocess.STDOUT))
    return RankRun(procs, str(tmp_path), timeout=60), procs


WRITES = ('import pickle, sys, time\n'
          'sys.stderr.write("w" * (1 << 20))\n'
          'pickle.dump({{"records": {{"s": {{"rank": {r}}}}},'
          ' "ended": time.time()}}, open({pkl!r}, "wb"))')


def test_launcher_reads_ranks_that_write_more_than_a_pipe_holds(tmp_path):
    run, _ = _stand_ins(tmp_path, [WRITES, WRITES])
    assert run.wait() == {'s': [{'rank': 0}, {'rank': 1}]}
    assert len(run.ended) == 2 and min(run.ended) >= run.started


def test_launcher_stops_every_rank_when_one_fails(tmp_path):
    import time
    run, procs = _stand_ins(tmp_path, [
        'import time; time.sleep(120)',
        'import sys; print("rank {r} broke"); sys.exit(3)'])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r'rank 1 exited 3:\nrank 1 broke'):
        run.wait()
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)
