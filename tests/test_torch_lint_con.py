"""The port's concurrency (CON) tier against the JAX package's.

``dgmc_tpu_torch/analysis/{concurrency,con_rules}.py`` are copies of the
JAX modules: on the same files both tiers must give the same findings,
field for field (rule, severity, where, message, detail, context and
fingerprint), over the JAX package's golden fixtures, the whole
``dgmc_tpu/`` tree and the whole ``dgmc_tpu_torch/`` tree. The JAX side
loads through :func:`tests.torch_jax_worker.jax_worker` (its analysis
leaves import no JAX).
"""

import os

import pytest

from dgmc_tpu_torch.analysis import con_rules
from tests.torch_jax_worker import jax_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES_CON = os.path.join(REPO, 'tests', 'analysis', 'fixtures_con')
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES_CON)
                       if f.endswith('.py') and f != '__init__.py')


def _fields(findings):
    return [(f.rule, f.severity.name, f.where, f.message, f.detail,
             f.context, f.fingerprint) for f in findings]


def _jax(fn_name, *args):
    with jax_worker('dgmc_tpu.analysis.con_rules') as m:
        return _fields(getattr(m['con_rules'], fn_name)(*args))


@pytest.mark.parametrize('name', FIXTURE_FILES)
def test_con_fixture_findings_equal_jax(name):
    path = os.path.join(FIXTURES_CON, name)
    rel = f'fixtures_con/{name}'
    port = _fields(con_rules.lint_concurrency_file(path, rel=rel))
    assert port == _jax('lint_concurrency_file', path, rel)
    if name == 'clean_controls.py':
        assert port == []
    else:
        # con50N_*.py trips CON50N and nothing else.
        assert {f[0] for f in port} == {name[:6].upper()}


@pytest.mark.parametrize('package', ['dgmc_tpu', 'dgmc_tpu_torch'])
def test_con_tree_findings_equal_jax(package):
    root = os.path.join(REPO, package)
    port = _fields(con_rules.lint_concurrency_tree(root))
    assert port == _jax('lint_concurrency_tree', root)
    # The one finding both trees carry: the watchdog's signal-path
    # counter, which the JAX package's baseline holds too.
    assert ('CON501', 'ERROR') in {f[:2] for f in port}
    assert any(f[2].startswith(f'{package}/obs/watchdog.py:')
               and f[5] == 'self.dump_count += 1' for f in port)


def test_con_paths_over_the_smoke_script_equal_jax():
    """The CLI's multi-root form: the package plus ``chip_smoke.py``
    (a bare file reports under its basename)."""
    roots = [os.path.join(REPO, 'dgmc_tpu_torch'),
             os.path.join(REPO, 'chip_smoke.py')]
    port = _fields(con_rules.lint_concurrency_paths(roots))
    assert port == _jax('lint_concurrency_paths', roots)
    assert not [f for f in port if f[2].startswith('chip_smoke.py:')]
