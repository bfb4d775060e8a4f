"""The port's run report (``obs/report.py``), on the CPU.

``summarize`` of a port run dir (a tiny ``dbp15k --obs-dir`` run with its
cost account and a measured attribution merged in) equals the JAX
package's ``summarize`` of the same dir on every key JAX's produces: the
two dispatch counts aside, which read the port's outcome names
(``kernel`` for JAX's ``pallas``, ``plain`` for its ``fallback``). The
CLI prints the table and ``--json``; a supervised dir is read through
its last attempt, as JAX's reads it.
"""

import json
import os
import shutil

import pytest
import torch

from dgmc_tpu_torch.obs import report
from tests.torch_jax_worker import jax_worker

TINY_KG = ['--device', 'cpu', '--synthetic', '--syn_nodes_s', '300',
           '--syn_nodes_t', '400', '--syn_edges_s', '1500', '--syn_edges_t',
           '1800', '--dim', '16', '--rnd_dim', '8', '--num_steps', '2',
           '--epochs', '3', '--phase1_epochs', '1']
#: Summary keys whose meaning maps the port's dispatch outcomes onto JAX's
#: names (a CUDA kernel for a Pallas kernel, the plain version for the
#: fallback).
OUTCOME_KEYS = {'dispatch_pallas', 'dispatch_fallback'}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
    from dgmc_tpu_torch.experiments import dbp15k
    d = str(tmp_path_factory.mktemp('kg') / 'obs')
    dbp15k.main(TINY_KG + ['--obs-dir', d, '--probes'])
    attribution = {'device_available': True, 'stages': {}, 'occupancy': {
        'device_idle_fraction': 0.25, 'idle_fraction': 0.25,
        'idle_source': 'device'}, 'reconciliation': {'measured_mfu': 0.01},
        'source': {'kind': 'profiler', 'trace_files': []}}
    from dgmc_tpu_torch.obs.attribution import merge_into_efficiency
    merge_into_efficiency(d, attribution)
    with open(os.path.join(d, 'attribution.json'), 'w') as f:
        json.dump(attribution, f)
    return d


def _jax_summary(path):
    with jax_worker('dgmc_tpu.obs.report', 'dgmc_tpu.obs.cost',
                    'dgmc_tpu.obs.attribution') as mods:
        return mods['report'].summarize(mods['report'].load_run(path))


def test_summary_has_jax_keys_and_values(run_dir):
    ours = report.summarize(report.load_run(run_dir))
    theirs = _jax_summary(run_dir)
    assert set(theirs) <= set(ours)
    for key in set(theirs) - OUTCOME_KEYS:
        assert ours[key] == theirs[key], key
    with open(os.path.join(run_dir, 'efficiency.json')) as f:
        eff = json.load(f)
    assert ours['mfu'] == eff['mfu'] > 0
    assert ours['flops_per_step'] == eff['programs']['train_step']['flops']
    assert ours['measured_mfu'] == 0.01
    assert 0 < ours['goodput_ratio'] <= 1
    rows = ours['dispatch']
    assert ours['dispatch_fallback'] == sum(
        r['count'] for r in rows if r['outcome'] == 'plain') > 0
    assert ours['dispatch_pallas'] == 0          # no kernel on the CPU


def test_cli_table_and_json(run_dir, capsys):
    assert report.main([run_dir]) == 0
    text = capsys.readouterr().out
    for section in ('-- step timing --', '-- cost / efficiency --',
                    '-- measured attribution (profiler trace) --',
                    '-- kernel dispatch --', '-- capacity / goodput plane --'):
        assert section in text, section
    assert 'train_step:' in text and 'psi1' in text
    assert report.main([run_dir, '--json']) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary['mfu'] == report.summarize(report.load_run(run_dir))['mfu']
    assert report.main([run_dir, run_dir, '--json']) == 0
    assert len(json.loads(capsys.readouterr().out)) == 2
    assert report.main([run_dir + '_missing']) == 2


def test_supervised_dir_reads_its_last_attempt(run_dir, tmp_path):
    root = str(tmp_path / 'sup')
    os.makedirs(root)
    for k in (0, 1):
        shutil.copytree(run_dir, os.path.join(root, f'attempt_{k}'))
    with open(os.path.join(root, 'attempt_0', 'metrics.jsonl'), 'w') as f:
        f.write('{"step": 0, "loss": 9.0}\n')
    with open(os.path.join(root, 'recovery.json'), 'w') as f:
        json.dump({'outcome': 'completed', 'restarts': 1, 'attempts': [
            {'attempt': 0, 'reason': 'crash', 'rc': 137},
            {'attempt': 1, 'reason': 'completed', 'rc': 0}]}, f)
    run = report.load_run(root)
    assert run['attempts'] == 2 and run['path'] == root
    ours = report.summarize(run)
    theirs = _jax_summary(root)
    assert ours['recovery'] == theirs['recovery']
    assert ours['recovery']['restarts'] == 1
    assert ours['last_metrics'] == theirs['last_metrics'] != {'step': 0,
                                                              'loss': 9.0}
    assert 'recovery timeline' in report.render(run)
