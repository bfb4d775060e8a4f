"""The keypoint CLIs on dataset trees in the published raw layouts, on
the CPU at tiny width: ``pascal`` (Cartesian and isotropic) and
``willow`` (its per-run restore of the pretrained snapshot and its
resume over ``runs.json``).
"""

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.datasets.fixtures import write_voc, write_willow
from dgmc_tpu_torch.experiments import pascal, willow

TINY = ['--device', 'cpu', '--f32', '--vgg_weights', 'none', '--dim', '16',
        '--rnd_dim', '8', '--num_layers', '1', '--num_steps', '2']


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp('trees')
    return {'voc': write_voc(str(base / 'voc'), seed=1, train=4, val=2),
            'willow': write_willow(str(base / 'willow'), seed=2, items=21)}


def _accuracy_lines(out, header):
    lines = out.splitlines()
    rows = [lines[i + 1] for i, ln in enumerate(lines[:-1])
            if ln.startswith(header)]
    return [[float(v) for v in r.replace('±', ' ').split()] for r in rows]


@pytest.mark.parametrize('isotropic', [False, True])
def test_pascal_cli_runs(roots, capsys, isotropic, tmp_path):
    losses = []

    def hook(kind, index, out):
        if kind == 'train':
            losses.append(float(out['loss']))

    pascal.main(TINY + ['--data_root', roots['voc'], '--batch_size', '16',
                        '--epochs', '2', '--test_samples', '20',
                        '--metrics_log', str(tmp_path / 'm.jsonl')]
                + (['--isotropic'] if isotropic else []), hook=hook)
    out = capsys.readouterr().out
    assert len(losses) == 2 * 5 and np.isfinite(losses).all()
    accs = _accuracy_lines(out, 'aerop bicyc bird')
    assert len(accs) == 2 and all(len(a) == 21 for a in accs)
    assert np.isfinite(accs).all()
    assert 'Epoch: 02, Loss: ' in out and 'waited' in out
    assert '# graph train_step' in out and '# graph eval_step' in out
    assert len((tmp_path / 'm.jsonl').read_text().splitlines()) == 2


def test_willow_cli_restores_the_snapshot_each_run(roots, capsys):
    """Two runs: each starts from the pretrained snapshot bit for bit with
    Adam's moments and step counts at zero, prints its five accuracies,
    and the end prints the mean ± std table."""
    seen = {}

    def hook(kind, index, payload):
        if kind == 'snapshot':
            seen.update(payload)
        elif kind == 'run_start':
            model, state = seen['model'], seen['state']
            for name, t in model.state_dict().items():
                assert torch.equal(t, seen['params'][name]), name
            assert state.step == 0
            for st in state.optimizer.state.values():
                for v in st.values():
                    assert not torch.as_tensor(v).any()
            seen.setdefault('runs', []).append(index)

    accs = willow.main(TINY + ['--voc_root', roots['voc'], '--willow_root',
                               roots['willow'], '--batch_size', '256',
                               '--pre_epochs', '1', '--epochs', '1',
                               '--runs', '2', '--test_samples', '8'],
                       hook=hook)
    out = capsys.readouterr().out
    assert seen['runs'] == [1, 2]
    assert accs.shape == (2, 5) and np.isfinite(accs).all()
    assert 'Run 01:' in out and 'Run 02:' in out
    table = _accuracy_lines(out, 'face          motorbike')
    assert len(table) == 3 and len(table[-1]) == 10


def test_willow_cli_resumes_after_the_runs_done(roots, tmp_path, capsys):
    """A protocol stopped after run 1, started again over its directory:
    the snapshot is restored, pretraining and run 1 are skipped, run 2
    runs, and the table holds both."""
    argv = TINY + ['--voc_root', roots['voc'], '--willow_root',
                   roots['willow'], '--batch_size', '256', '--pre_epochs',
                   '1', '--epochs', '1', '--test_samples', '8',
                   '--ckpt_dir', str(tmp_path / 'ck')]
    first = willow.main(argv + ['--runs', '1'])
    out = capsys.readouterr().out
    assert 'Pretraining model on PascalVOC...' in out and 'Run 01:' in out
    both = willow.main(argv + ['--runs', '2'])
    out = capsys.readouterr().out
    assert 'Resumed pretrained snapshot' in out
    assert '(1 runs already complete)' in out
    assert 'Pretraining' not in out and 'Run 01:' not in out
    assert 'Run 02:' in out
    assert both.shape == (2, 5)
    np.testing.assert_array_equal(both[0], first[0])
