"""The PascalPF and DBP15K CLIs on dataset trees in the published raw
layouts, on the CPU at tiny width: ``pascal_pf --data_root`` (the
zero-shot eval of every category's pairs) and ``dbp15k --category
--data_root`` (its batches equal to the JAX CLI's ``load_batches``).
"""

import numpy as np
import pytest
import torch

from dgmc_tpu.experiments import dbp15k as jax_dbp15k
from dgmc_tpu_torch.datasets.fixtures import write_dbp15k, write_pascal_pf
from dgmc_tpu_torch.experiments import dbp15k, pascal_pf


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _accuracy_lines(out, header):
    lines = out.splitlines()
    return [[float(v) for v in lines[i + 1].split()]
            for i, ln in enumerate(lines[:-1]) if ln.startswith(header)]


def test_pascal_pf_cli_evaluates_the_real_pairs(tmp_path, capsys):
    root = write_pascal_pf(str(tmp_path), seed=0, items=3)
    real = []

    def hook(kind, index, out):
        if kind == 'real_eval':
            real.append(int(out['count']))

    pascal_pf.main(['--device', 'cpu', '--f32', '--epochs', '1', '--dim',
                    '16', '--rnd_dim', '8', '--num_steps', '2',
                    '--batch_size', '64', '--data_root', root], hook=hook)
    out = capsys.readouterr().out
    assert 'real-data eval disabled' not in out
    assert len(real) == 20 * 2 and all(n > 0 for n in real)
    accs = _accuracy_lines(out, 'aerop bicyc bird')
    assert len(accs) == 1 and len(accs[0]) == 21


def test_dbp15k_cli_trains_on_a_jape_tree(tmp_path, capsys):
    root = write_dbp15k(str(tmp_path))
    argv = ['--category', 'zh_en', '--data_root', root, '--dim', '8',
            '--rnd_dim', '4', '--num_layers', '1', '--num_steps', '1',
            '--k', '2', '--epochs', '4', '--phase1_epochs', '2']
    jtrain, jtest, jdim = jax_dbp15k.load_batches(
        jax_dbp15k.parse_args(argv + ['--f32']))
    ttrain, ttest, tdim = dbp15k.load_batches(
        dbp15k.parse_args(argv + ['--f32']))
    assert tdim == jdim == 8
    for jb, tb in ((jtrain, ttrain), (jtest, ttest)):
        for side in ('s', 't'):
            jg, tg = getattr(jb, side), getattr(tb, side)
            for k in ('x', 'senders', 'receivers', 'node_mask',
                      'edge_mask'):
                np.testing.assert_array_equal(tg[k],
                                              np.asarray(getattr(jg, k)))
        np.testing.assert_array_equal(tb.y, np.asarray(jb.y))
        np.testing.assert_array_equal(tb.y_mask, np.asarray(jb.y_mask))
    losses = []
    dbp15k.main(argv + ['--device', 'cpu', '--f32'],
                hook=lambda kind, e, out: losses.append(float(out['loss']))
                if kind == 'train' else None)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert 'Refine correspondence matrix...' in capsys.readouterr().out
