"""The run's collective account (``obs/cost.py``, ``train/steps.py``'s
sharded cost pass): a tiny ``dbp15k --row_shards 2`` on 2 gloo CPU ranks
(``tests/test_torch_parallel_cli.py``'s ``TINY`` flags) writes
``collectives``, ``overlap_fraction`` and ``critical_path_share`` into
each rank's ``host_<r>/efficiency.json``, equal between the ranks, and
``obs.diff --min-overlap`` gates on them; a one-process run writes none
(JAX's one-device account carries none). With the sharded ψ₁ tables
(``streamed_rules`` plus ``'psi1'`` / ``'corpus'``, which no CLI flag
sets, as in JAX) the table lists the ring's permutes, the tables'
all-gathers and, in phase 1, their gradients' reduce-scatters."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.obs import diff as diff_mod
from tests.test_torch_parallel_cli import TINY
from tests.torch_dist_worker import ROOT, free_port, start_groups

ARGV = TINY + ['--epochs', '11']
KEYS = ('collectives', 'overlap_fraction', 'critical_path_share')


@pytest.fixture(scope='module')
def started():
    """The sharded-table account's ranks, started first so that they run
    beside the CLIs of :func:`obs`."""
    return start_groups([('tests.torch_parallel_jobs:table_account', 2,
                          (TINY[3:],))], timeout=180)


@pytest.fixture(scope='module')
def tables(started, obs):
    return started()[0]


@pytest.fixture(scope='module')
def obs(started, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('account')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k', *ARGV,
         '--row_shards', '2', '--obs-dir', str(tmp / 'rows'),
         '--coordinator', f'127.0.0.1:{port}', '--num_processes', '2',
         '--process_id', str(r)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    dbp15k.main(ARGV + ['--obs-dir', str(tmp / 'one')])
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
    return tmp


def _programs(d):
    with open(os.path.join(d, 'efficiency.json')) as f:
        return json.load(f)['programs']


def test_each_rank_writes_the_collective_account(obs):
    ranks = [_programs(obs / 'rows' / f'host_{r}') for r in range(2)]
    for name in ('phase1_step', 'train_step'):
        acc = [{k: p[name].get(k) for k in KEYS} for p in ranks]
        assert acc[0] == acc[1], name
        assert 0.0 <= acc[0]['overlap_fraction'] <= 1.0
        assert 0.0 < acc[0]['critical_path_share'] <= 1.0
        assert 'schedule_error' not in ranks[0][name]
        assert ranks[0][name]['static_peak_bytes'] > 0
    # Phase 2 (T = 3 consensus steps): the T row sums of r_t, their T
    # gradients, the loss's count, the gradient sum and the two metric
    # sums: 2T + 4 all-reduces.
    table = ranks[0]['train_step']['collectives']
    assert list(table['ops']) == ['all-reduce']
    assert table['ops']['all-reduce']['count'] == 2 * 3 + 4


def test_one_process_writes_no_account(obs):
    programs = _programs(obs / 'one')
    for name in ('phase1_step', 'train_step'):
        assert not set(KEYS) & set(programs[name])


def _diff(a, b, floor, capsys):
    capsys.readouterr()
    rc = diff_mod.main([str(a), str(b), '--json', '--min-overlap',
                        str(floor)])
    rows = json.loads(capsys.readouterr().out)['rows']
    return rc, [r for r in rows if r['metric'] == 'overlap_fraction']


def test_min_overlap_gates_on_the_account(obs, tmp_path, capsys):
    host0 = obs / 'rows' / 'host_0'
    floor = _programs(host0)['train_step']['overlap_fraction']
    rc, rows = _diff(host0, host0, floor, capsys)
    assert rc == 0 and rows[0]['status'] == 'ok' and rows[0]['b'] == floor
    below = tmp_path / 'below'
    shutil.copytree(host0, below)
    eff = json.loads((below / 'efficiency.json').read_text())
    eff['programs']['train_step']['overlap_fraction'] = round(
        floor - 0.01, 4)
    (below / 'efficiency.json').write_text(json.dumps(eff))
    rc, rows = _diff(host0, below, floor, capsys)
    assert rc == 1 and rows[0]['status'] == 'REGRESSION'


def test_sharded_tables_account_lists_the_permutes_and_gathers(tables):
    """Each rank's account of the sharded-table steps, equal between the
    ranks: a search's n - 1 = 1 permute of the target shard; the all-
    gathers of ψ₁'s messages (two a layer a side) and of the corpus table
    for the candidates; phase 1 (ψ₁ trains) their reduce-scatters."""
    (a, layers), (b, _) = tables
    for name in ('phase1_step', 'train_step'):
        assert {k: a[name].get(k) for k in KEYS} == {
            k: b[name].get(k) for k in KEYS}, name
    gathers = 2 * 2 * layers + 1
    ops = {name: {k: v['count'] for k, v in
                  a[name]['collectives']['ops'].items()}
           for name in ('phase1_step', 'train_step')}
    assert ops['phase1_step']['collective-permute'] == 1
    assert ops['phase1_step']['all-gather'] == gathers
    assert ops['phase1_step']['reduce-scatter'] == gathers
    assert ops['train_step']['collective-permute'] == 1
    assert ops['train_step']['all-gather'] == gathers
    assert 'reduce-scatter' not in ops['train_step']
