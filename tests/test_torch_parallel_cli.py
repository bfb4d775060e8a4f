"""The port's KG CLI across ranks: ``python -m
dgmc_tpu_torch.experiments.dbp15k --synthetic --row_shards 2
--num_processes 2 --device cpu`` (and ``--model_shards 2``) on a small
KG (300 / 400 entities), two gloo ranks, each a CPU process at one
intra-op thread.

Held: the epoch lines of both layouts against the one-process run's
(loss within rel 1e-4, JAX's bound; Hits@1 and Hits@10 within one test
alignment, 1/210: the sums over ranks are in another order, so a near
tie may flip), printed by the coordinator only; JAX's refusals (the two
shard flags together, a shard count that is not the world size);
``--obs-dir`` giving ``host_0/`` and ``host_1/`` (and the ranks'
``control/`` heartbeats), merged by the port's
``obs.aggregate`` as JAX's ``dgmc_tpu.obs.aggregate`` merges them; and
``--ckpt_dir`` under the coordinator rule: one writer, and a resumed
two-rank run printing the uninterrupted run's lines.
"""

import os
import re
import subprocess
import sys

import pytest

from dgmc_tpu_torch.experiments import dbp15k
from dgmc_tpu_torch.obs import aggregate as agg_mod
from tests.test_torch_diff import _call, jax_main
from tests.torch_dist_worker import ROOT, free_port

TINY = ['--synthetic', '--device', 'cpu', '--syn_nodes_s', '300',
        '--syn_nodes_t', '400', '--syn_edges_s', '1500', '--syn_edges_t',
        '1800', '--dim', '16', '--rnd_dim', '8', '--num_steps', '3',
        '--phase1_epochs', '10', '--f32']
LINE = re.compile(r'^(\d{3}): Loss: ([\d.]+), Hits@1: ([\d.]+), '
                  r'Hits@10: ([\d.]+)')


def _start(argv, ranks=None):
    """``dbp15k`` in fresh processes: one, or ``ranks`` joined over a
    free port."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    base = [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k',
            *TINY, *argv]
    if ranks is None:
        cmds = [base]
    else:
        port = free_port()
        cmds = [base + ['--coordinator', f'127.0.0.1:{port}',
                        '--num_processes', str(ranks), '--process_id',
                        str(r)] for r in range(ranks)]
    return [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for c in cmds]


def _finish(procs, timeout=180):
    out = []
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        out.append((p.returncode, o, e))
    return out


def _lines(stdout):
    return {m.group(1): tuple(float(x) for x in m.groups()[1:])
            for m in map(LINE.match, stdout.splitlines()) if m}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The runs, side by side: one process; ``--row_shards 2`` with
    ``--obs-dir``; ``--model_shards 2``; two ranks without a shard flag
    (refused); the first 12 epochs of a checkpointed two-rank run; then
    its resume to epoch 14."""
    tmp = tmp_path_factory.mktemp('cli')
    ckpt = str(tmp / 'ckpt')
    started = {
        'one': _start(['--epochs', '14']),
        'rows': _start(['--epochs', '14', '--row_shards', '2',
                        '--obs-dir', str(tmp / 'obs')], 2),
        'model': _start(['--epochs', '14', '--model_shards', '2'], 2),
        'unsharded': _start(['--epochs', '14'], 2),
        'ckpt': _start(['--epochs', '12', '--row_shards', '2', '--ckpt_dir',
                        ckpt, '--ckpt_every', '6'], 2)}
    out = {k: _finish(v) for k, v in started.items()}
    out['resume'] = _finish(_start(['--epochs', '14', '--row_shards', '2',
                                    '--ckpt_dir', ckpt, '--ckpt_every',
                                    '6'], 2))
    out['tmp'] = tmp
    return out


@pytest.mark.parametrize('layout', ['rows', 'model'])
def test_two_ranks_print_the_one_process_lines(runs, layout):
    (rc, one, err), = runs['one']
    assert rc == 0, err
    want = _lines(one)
    assert sorted(want) == ['010', '011', '012', '013', '014']
    (rc0, out0, err0), (rc1, out1, err1) = runs[layout]
    assert rc0 == rc1 == 0, err0 + err1
    got = _lines(out0)
    assert sorted(got) == sorted(want)
    assert _lines(out1) == {} and 'Optimize' not in out1
    for epoch, (loss, h1, h10) in want.items():
        g = got[epoch]
        assert g[0] == pytest.approx(loss, rel=1e-4), epoch
        assert abs(g[1] - h1) <= 1 / 210 + 1e-4, epoch
        assert abs(g[2] - h10) <= 1 / 210 + 1e-4, epoch


def test_refusals_match_jax(runs, capsys):
    with pytest.raises(SystemExit, match='mutually exclusive'):
        dbp15k.main(TINY + ['--row_shards', '2', '--model_shards', '2'])
    with pytest.raises(SystemExit, match='needs 2 ranks, one card each'):
        dbp15k.main(TINY + ['--row_shards', '2'])
    for rc, _, err in runs['unsharded']:
        assert rc == 1 and 'requires --model_shards or --row_shards == ' \
            'world size (2' in err


def test_each_rank_writes_its_obs_dir_and_aggregate_matches_jax(runs):
    root = str(runs['tmp'] / 'obs')
    # Each rank's obs dir, and the ranks' control plane (their heartbeats,
    # at JAX's place: <obs>/control/host_<rank>.json).
    assert sorted(os.listdir(root)) == ['control', 'host_0', 'host_1']
    assert sorted(os.listdir(os.path.join(root, 'control'))) \
        == ['host_0.json', 'host_1.json']
    for host in ('host_0', 'host_1'):
        assert 'metrics.jsonl' in os.listdir(os.path.join(root, host))
    for argv in ([root, '--no-write', '--json'], [root, '--no-write']):
        ours = _call(agg_mod.main, argv)
        assert ours == jax_main('aggregate', argv) and ours[0] == 0
    summary = agg_mod.aggregate(root)
    assert summary['hosts'] == 2


def test_checkpoints_follow_the_coordinator_rule(runs):
    (rc0, out0, err0), (rc1, out1, err1) = runs['ckpt']
    assert rc0 == rc1 == 0, err0 + err1
    ckpt = str(runs['tmp'] / 'ckpt')
    (rc0, out0, err0), (rc1, out1, err1) = runs['resume']
    assert rc0 == rc1 == 0, err0 + err1
    assert 'Resumed from' in out0 and 'at epoch 12.' in out0
    assert 'Resumed' not in out1
    assert sorted(os.listdir(ckpt)) == ['12', '14', '6', 'manifests']
    whole = _lines(runs['rows'][0][1])
    resumed = _lines(out0)
    assert sorted(resumed) == ['013', '014']
    for epoch in resumed:
        assert resumed[epoch] == whole[epoch], epoch
