"""The port's lint CLI (``python -m dgmc_tpu_torch.analysis.lint``), its
baseline and fingerprints.

The CLI keeps the JAX package's contract for the tiers it has: flags,
the ``--json`` report, exit statuses (0, 1, 2 for a usage error) under
each ``--fail-on`` policy, and the baseline file, which either
package's loader reads. The port's own tree is clean against the
committed ``lint-baseline-torch.json``.
"""

import json
import os
import textwrap

import pytest

from dgmc_tpu_torch.analysis import findings as findings_mod
from dgmc_tpu_torch.analysis.catalog import RULES
from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              load_baseline, write_baseline)
from dgmc_tpu_torch.analysis.lint import (RULE_CATALOG, _source_roots,
                                          build_parser, main)
from dgmc_tpu_torch.analysis.source_rules import lint_source_tree
from tests.torch_jax_worker import jax_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, 'lint-baseline-torch.json')
FIXTURES_CON = os.path.join(REPO, 'tests', 'analysis', 'fixtures_con')
CON_RULES = 'CON501,CON502,CON503,CON504,CON505'
#: No specimen tier: the trace tier and the mesh specimens' SHD and
#: SCH/MEM tiers.
NO_SPECIMENS = ('--skip-trace', '--skip-sharded', '--skip-sched')

#: One module with an SRC101 (error), SRC102 and SRC103 (warnings).
BAD = textwrap.dedent('''\
    from dgmc_tpu_torch.train.compiled import compiled


    class Hoarder:
        def __init__(self, device):
            self.run = compiled(self.step, device)

        def step(self, x):
            self.last = x
            return x * x.item()


    def build(fns, device):
        out = []
        for f in fns:
            out.append(compiled(f, device))
        return out
''')

RACY = ('import threading\n\n\n'
        'class C:\n'
        '    def __init__(self):\n'
        '        self.n = 0\n'
        '        threading.Thread(target=self._loop).start()\n\n'
        '    def _loop(self):\n'
        '        self.n += 1\n')

#: The JAX fingerprint tests' module, in the port's idiom.
LOOP = textwrap.dedent('''\
    from dgmc_tpu_torch.train.compiled import compiled

    def build(fns, device):
        out = []
        for f in fns:
            out.append(compiled(f, device))
        return out
''')


@pytest.fixture
def bad_tree(tmp_path):
    root = tmp_path / 'pkg'
    root.mkdir()
    (root / 'bad.py').write_text(BAD)
    return str(root)


@pytest.fixture
def race_tree(tmp_path):
    root = tmp_path / 'racepkg'
    root.mkdir()
    (root / 'racy.py').write_text(RACY)
    return str(root)


def _run(args, capsys):
    rc = main(args)
    return rc, capsys.readouterr().out


def _jax_main(args, capsys):
    capsys.readouterr()
    with jax_worker('dgmc_tpu.analysis.lint') as m:
        rc = m['lint'].main(args)
    return rc, capsys.readouterr().out


# -- rules ------------------------------------------------------------------


def test_list_rules_is_the_three_tiers(capsys):
    rc, out = _run(['--list-rules'], capsys)
    assert rc == 0
    listed = [line.split()[0] for line in out.splitlines()]
    assert listed == sorted(RULE_CATALOG) == sorted(RULES)
    assert {r[:3] for r in listed} == {'TRC', 'SRC', 'RCP', 'CON', 'SHD',
                                       'SCH', 'MEM'}
    assert {f'TRC00{i}' for i in range(1, 7)} <= set(listed)
    assert {f'SRC10{i}' for i in range(5)} <= set(listed)


@pytest.mark.parametrize('rule', sorted(RULES))
def test_explain_renders_every_rule(rule, capsys):
    rc, out = _run(['--explain', rule], capsys)
    assert rc == 0 and out.startswith(f'{rule} — ')
    for section in ('What:', 'Why:', 'Fix:'):
        assert section in out


def test_explain_src104_says_why_it_cannot_fire(capsys):
    rc, out = _run(['--explain', 'SRC104,SRC102'], capsys)
    assert rc == 0 and 'SRC102' in out
    assert 'cannot fire on the port' in out
    assert 'compiled(...) takes no static' in out.replace('\n', ' ')
    assert _run(['--explain', 'SHD399'], capsys)[0] == 2


# -- exit statuses ------------------------------------------------------------


@pytest.mark.parametrize('policy,before,after', [
    ('new', 1, 0), ('error', 1, 0), ('any', 1, 1), ('none', 0, 0)])
def test_exit_status_under_each_fail_on(bad_tree, tmp_path, capsys, policy,
                                        before, after):
    """Before a baseline every finding is new; after ``--write-baseline``
    only ``any`` still fails."""
    args = ['--json', *NO_SPECIMENS, '--source-root', bad_tree,
            '--baseline', str(tmp_path / 'bl.json')]
    rc, out = _run(args + ['--fail-on', policy], capsys)
    report = json.loads(out)
    assert rc == before
    assert [(f['rule'], f['severity']) for f in report['findings']] == [
        ('SRC101', 'error'), ('SRC102', 'warning'), ('SRC103', 'warning')]
    assert report['summary']['new'] == 3 and report['baseline'] is None
    assert _run(args + ['--write-baseline'], capsys)[0] == 0
    rc, out = _run(args + ['--fail-on', policy], capsys)
    assert rc == after
    assert json.loads(out)['summary']['suppressed'] == 3


def test_fail_on_error_ignores_new_warnings(bad_tree, tmp_path, capsys):
    args = ['--json', *NO_SPECIMENS, '--source-root', bad_tree,
            '--baseline', str(tmp_path / 'bl.json'), '--fail-on', 'error']
    assert _run(args + ['--select', 'SRC102,SRC103'], capsys)[0] == 0
    assert _run(args + ['--select', 'SRC101'], capsys)[0] == 1
    rc, out = _run(args + ['--ignore', 'SRC101', '--min-severity',
                           'warning'], capsys)
    assert rc == 0
    assert {f['rule'] for f in json.loads(out)['findings']} == {
        'SRC102', 'SRC103'}


@pytest.mark.parametrize('args', [
    ['--select', 'NOPE999'],
    ['--ignore', 'SHD399'],
    ['--min-severity', 'loud'],
    ['--json', '--format', 'github'],
    ['--write-baseline', '--prune-baseline'],
    ['--skip-source', '--obs-dir', 'gone'],
])
def test_usage_errors_exit_2(tmp_path, capsys, args):
    args = [a if a != 'gone' else str(tmp_path / 'gone') for a in args]
    assert main(args + ['--baseline', str(tmp_path / 'bl.json')]) == 2


def test_tiers_run_only_when_selected(race_tree, tmp_path, capsys):
    args = [*NO_SPECIMENS, '--source-root', race_tree, '--baseline',
            str(tmp_path / 'bl.json'), '--fail-on', 'none']
    main(args + ['--select', 'CON501'])
    err = capsys.readouterr().err
    assert 'concurrency tier' in err and 'source tier' not in err
    main(args + ['--select', 'SRC101'])
    err = capsys.readouterr().err
    assert 'source tier' in err and 'concurrency tier' not in err
    rc, out = _run(['--json', '--skip-concurrency'] + args, capsys)
    assert rc == 0 and json.loads(out)['findings'] == []


# -- the JAX package's CLI on the same roots ----------------------------------


@pytest.mark.parametrize('fmt', [['--json'], ['--format', 'github']])
@pytest.mark.parametrize('root', ['fixtures_con', 'race_tree'])
def test_con_report_equals_jax_lint_main(root, fmt, race_tree, tmp_path,
                                         capsys):
    src = FIXTURES_CON if root == 'fixtures_con' else race_tree
    args = fmt + ['--select', CON_RULES, '--source-root', src,
                  '--baseline', str(tmp_path / 'bl.json'),
                  '--fail-on', 'new']
    want = _jax_main(args, capsys)
    got = _run(args, capsys)
    assert got == want
    assert got[0] == 1 and 'CON501' in got[1]


def test_obs_dir_recompile_crosscheck(tmp_path, capsys):
    obs = tmp_path / 'obs'
    obs.mkdir()
    (obs / 'timings.json').write_text(json.dumps({
        'compile': {'events': 46, 'by_kind': {'capture': 40, 'nvcc': 6}},
        'padding_buckets': [
            {'batch': 8, 'nodes': '32x40', 'edges': '64x80', 'count': 2},
            {'batch': 8, 'nodes': '24x40', 'edges': '64x80', 'count': 1}],
    }))
    rc, out = _run(['--json', *NO_SPECIMENS, '--skip-source',
                    '--skip-concurrency', '--obs-dir', str(obs),
                    '--baseline', str(tmp_path / 'bl.json'),
                    '--fail-on', 'none'], capsys)
    assert rc == 0
    found = json.loads(out)['findings']
    assert [f['rule'] for f in found] == ['RCP201', 'RCP202']
    assert '40 compile events' in found[1]['message']


# -- baselines ----------------------------------------------------------------


def test_write_and_prune_baseline_round_trip(bad_tree, race_tree, tmp_path,
                                             capsys):
    """``--prune-baseline`` drops the entry that stopped reproducing,
    keeps the live ones and those of a tier the run skipped, and adds
    nothing new."""
    path = tmp_path / 'bl.json'
    args = [*NO_SPECIMENS, '--source-root', bad_tree, '--baseline',
            str(path)]
    assert _run(args + ['--write-baseline'], capsys)[0] == 0
    entries = json.loads(path.read_text())['findings']
    assert len(entries) == 3
    entries.append({'rule': 'SRC103', 'severity': 'warning',
                    'where': 'pkg/gone.py:1', 'message': 'stale',
                    'fingerprint': 'deadbeefdeadbeef'})
    entries.append({'rule': 'CON501', 'severity': 'error',
                    'where': 'pkg/other.py:1', 'message': 'm',
                    'fingerprint': 'feedfacefeedface'})
    path.write_text(json.dumps({'version': 2, 'tool': 'dgmc-lint',
                                'findings': entries}))
    rc, out = _run(args + ['--skip-concurrency', '--prune-baseline'],
                   capsys)
    assert rc == 0 and 'pruned 1 stale entry' in out
    fps = {e['fingerprint'] for e in json.loads(path.read_text())[
        'findings']}
    assert 'deadbeefdeadbeef' not in fps and 'feedfacefeedface' in fps
    assert len(fps) == 4
    assert _run(['--json'] + args + ['--fail-on', 'new'], capsys)[0] == 0
    # A rewrite that skips the concurrency tier keeps its entries too.
    assert _run(args + ['--skip-concurrency', '--write-baseline'],
                capsys)[0] == 0
    assert 'feedfacefeedface' in {e['fingerprint'] for e in json.loads(
        path.read_text())['findings']}


def test_baselines_load_across_packages(bad_tree, tmp_path, capsys):
    """The JAX package's committed baseline loads in the port's loader;
    a baseline the port writes loads unchanged in the JAX package's."""
    with open(os.path.join(REPO, 'lint-baseline.json')) as f:
        jax_entries = json.load(f)['findings']
    assert load_baseline(os.path.join(REPO, 'lint-baseline.json')) == {
        e['fingerprint']: e for e in jax_entries}
    path = str(tmp_path / 'bl.json')
    assert main([*NO_SPECIMENS, '--source-root', bad_tree, '--baseline',
                 path, '--write-baseline']) == 0
    ours = load_baseline(path)
    assert len(ours) == 3
    with jax_worker('dgmc_tpu.analysis.findings') as m:
        assert m['findings'].load_baseline(path) == ours
        # The same finding fingerprints alike in both packages.
        f = Finding(rule='CON503', severity=Severity.WARNING,
                    where='pkg/a.py:3', message='m', context="open(p, 'w')")
        g = m['findings'].Finding(
            rule='CON503', severity=m['findings'].Severity.WARNING,
            where='pkg/a.py:9', message='m', context="open(p, 'w')")
        assert f.fingerprint == g.fingerprint and f.to_json()['where'] != \
            g.to_json()['where']


def test_default_baseline_is_the_ports_own(tmp_path, monkeypatch):
    """The walk up from the working directory finds
    ``lint-baseline-torch.json``, never the JAX package's
    ``lint-baseline.json`` beside it; outside the repo it falls back to
    the one beside the package."""
    assert findings_mod.DEFAULT_BASELINE_NAME == 'lint-baseline-torch.json'
    monkeypatch.chdir(os.path.join(REPO, 'dgmc_tpu_torch', 'obs'))
    assert findings_mod.default_baseline_path() == BASELINE
    monkeypatch.chdir(tmp_path)
    assert findings_mod.default_baseline_path() == BASELINE


# -- fingerprints (the JAX package's stability cases) ------------------------


def test_fingerprint_ignores_where_line_number():
    a = Finding(rule='SRC103', severity=Severity.WARNING,
                where='dgmc_tpu_torch/train/steps.py:101', message='m',
                context='out.append(compiled(f, device))')
    b = Finding(rule='SRC103', severity=Severity.WARNING,
                where='dgmc_tpu_torch/train/steps.py:202', message='m',
                context='out.append(compiled(f, device))')
    assert a.fingerprint == b.fingerprint
    c = Finding(rule='SRC103', severity=Severity.WARNING,
                where='dgmc_tpu_torch/train/steps.py:101', message='m',
                context='out.append(Compiled(f, device))')
    assert c.fingerprint != a.fingerprint


def _two_trees(tmp_path, a, b):
    roots = []
    for name, text in (('a', a), ('b', b)):
        root = tmp_path / name / 'pkg'
        root.mkdir(parents=True)
        (root / 'mod.py').write_text(text)
        roots.append(str(root))
    return roots


def test_moving_a_finding_keeps_its_fingerprint(tmp_path):
    ra, rb = _two_trees(tmp_path, LOOP, '# a new comment\n# another\n'
                        + LOOP)
    (fa,) = lint_source_tree(ra)
    (fb,) = lint_source_tree(rb)
    assert fa.rule == fb.rule == 'SRC103'
    assert fa.where != fb.where
    assert fa.context == fb.context == 'out.append(compiled(f, device))'
    assert fa.fingerprint == fb.fingerprint


def test_editing_the_flagged_line_releases_the_fingerprint(tmp_path):
    ra, rb = _two_trees(tmp_path, LOOP, LOOP.replace(
        'compiled(f, device))', 'compiled(f, device, prepare=None))'))
    (fa,) = lint_source_tree(ra)
    (fb,) = lint_source_tree(rb)
    assert fa.where == fb.where
    assert fa.fingerprint != fb.fingerprint


def test_baseline_suppresses_across_relocation(tmp_path):
    ra, rb = _two_trees(tmp_path, LOOP, '# moved\n' * 7 + LOOP)
    bl = str(tmp_path / 'bl.json')
    assert main([*NO_SPECIMENS, '--source-root', ra, '--baseline', bl,
                 '--write-baseline']) == 0
    assert main([*NO_SPECIMENS, '--source-root', rb, '--baseline', bl,
                 '--fail-on', 'new']) == 0


def test_identical_duplicates_get_distinct_fingerprints(tmp_path):
    line = '        out.append(compiled(f, device))\n'
    ra, rb = _two_trees(tmp_path, LOOP, LOOP.replace(line, line + line))
    (fa,) = lint_source_tree(ra)
    fb1, fb2 = lint_source_tree(rb)
    assert fb1.fingerprint != fb2.fingerprint
    assert fb2.context.endswith('#2')
    assert fa.fingerprint == fb1.fingerprint
    bl = str(tmp_path / 'bl.json')
    assert main([*NO_SPECIMENS, '--source-root', ra, '--baseline', bl,
                 '--write-baseline']) == 0
    assert main([*NO_SPECIMENS, '--source-root', rb, '--baseline', bl,
                 '--fail-on', 'new']) == 1


def _v1(path, entries=()):
    path.write_text(json.dumps({'version': 1, 'tool': 'dgmc-lint',
                                'findings': list(entries)}))
    return str(path)


def test_v1_baseline_is_a_migration_error(tmp_path, capsys):
    path = _v1(tmp_path / 'bl.json', [
        {'rule': 'SRC103', 'severity': 'warning', 'where': 'pkg/mod.py:6',
         'message': 'm', 'fingerprint': 'deadbeefdeadbeef'}])
    original = open(path).read()
    with pytest.raises(ValueError, match='--write-baseline'):
        load_baseline(path)
    assert load_baseline(path, migrate=True)
    for extra in (['--fail-on', 'new'], ['--prune-baseline']):
        assert main([*NO_SPECIMENS, '--skip-source', '--baseline',
                     path] + extra) == 2
        assert '--write-baseline' in capsys.readouterr().err
    assert open(path).read() == original


def test_write_baseline_migrates_v1_and_warns_on_kept_entries(tmp_path,
                                                              capsys):
    root = tmp_path / 'pkg'
    root.mkdir()
    (root / 'mod.py').write_text(LOOP)
    path = _v1(tmp_path / 'bl.json', [
        {'rule': 'CON501', 'severity': 'error', 'where': 'pkg/x.py:1',
         'message': 'm', 'fingerprint': 'feedfacefeedface'}])
    args = [*NO_SPECIMENS, '--source-root', str(root), '--baseline',
            path, '--skip-concurrency', '--write-baseline']
    assert main(args) == 0
    err = capsys.readouterr().err
    assert 'WARNING' in err and 'legacy fingerprints' in err
    data = json.loads(open(path).read())
    assert data['version'] == 2 and len(data['findings']) == 2
    assert main(args) == 0
    assert 'WARNING' not in capsys.readouterr().err


def test_write_baseline_helper_emits_v2(tmp_path):
    path = str(tmp_path / 'bl.json')
    payload = write_baseline(path, [Finding(
        rule='SRC103', severity=Severity.WARNING, where='a.py:3',
        message='m', context='compiled(f)')])
    assert payload['version'] == 2 and payload['tool'] == 'dgmc-lint'
    assert load_baseline(path)


# -- the port's tree ----------------------------------------------------------


def test_the_cli_imports_no_torch():
    """The lint starts without torch (the package's ``__init__`` imports
    none), so a fresh process on the card's machine pays no torch
    import for it."""
    import subprocess
    import sys
    code = ('import sys\n'
            'from dgmc_tpu_torch.analysis import lint\n'
            'rc = lint.main(["--skip-trace", "--skip-sharded",\n'
            '                "--skip-sched", "--fail-on", "none",\n'
            '                "--baseline", sys.argv[1]])\n'
            'print(rc, "torch" in sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code, BASELINE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.splitlines()[-1] == '0 False', out.stderr[-2000:]


def test_default_roots_are_the_package_and_the_smoke_script():
    roots = _source_roots(build_parser().parse_args([]))
    assert roots == [os.path.join(REPO, 'dgmc_tpu_torch'),
                     os.path.join(REPO, 'chip_smoke.py')]


def test_the_ports_tree_is_clean_against_its_baseline(capsys):
    rc, out = _run(['--json', *NO_SPECIMENS, '--fail-on', 'new',
                    '--baseline', BASELINE], capsys)
    report = json.loads(out)
    assert rc == 0, report['findings']
    assert report['summary']['new'] == 0
    with open(BASELINE) as f:
        entries = [e for e in json.load(f)['findings']
                   if not e['rule'].startswith('TRC')]
    # The one entry the JAX package's baseline holds for the same code:
    # the watchdog's signal path stays lock-free by design.
    assert [(e['rule'], e['where'].rsplit(':', 1)[0], e['context'])
            for e in entries] == [('CON501',
                                   'dgmc_tpu_torch/obs/watchdog.py',
                                   'self.dump_count += 1')]
    assert {f['fingerprint'] for f in report['findings']} == {
        e['fingerprint'] for e in entries}


# -- the mesh specimens' tiers (SHD, SCH/MEM) ---------------------------------

MESH_RULES = ('SHD301', 'SHD302', 'SHD303', 'SHD304', 'SHD305', 'SCH401',
              'SCH402', 'SCH403', 'MEM404', 'MEM405')


def test_catalog_has_jax_shd_sch_mem_rules_and_severities():
    """The ten rules under JAX's ids and severities, read from JAX's
    catalog; each explained in the port's terms."""
    with jax_worker('dgmc_tpu.analysis.catalog') as m:
        jax_rules = {r: d.severity for r, d in m['catalog'].RULES.items()
                     if r[:3] in ('SHD', 'SCH', 'MEM')}
    assert sorted(jax_rules) == sorted(MESH_RULES)
    assert {r: RULES[r].severity for r in MESH_RULES} == jax_rules
    for rule in ('SCH401', 'SHD303'):
        assert 'None is issued today' in RULES[rule].what, rule
    assert 'accumulate in float32 internally' in RULES['SHD305'].what


@pytest.mark.parametrize('flag,gone', [
    ('--skip-sharded', ('SHD',)), ('--skip-sched', ('SCH', 'MEM'))])
def test_skip_flags_drop_the_mesh_tiers(flag, gone):
    from dgmc_tpu_torch.analysis.lint import _rules_analyzed
    every = _rules_analyzed(build_parser().parse_args([]))
    rules = _rules_analyzed(build_parser().parse_args([flag]))
    assert set(MESH_RULES) <= every
    assert {r for r in every - rules} == {r for r in every
                                         if r.startswith(gone)}


def test_comm_budget_bytes_is_shd304s_fallback(tmp_path, capsys):
    """On 4 gloo ranks the CLI analyzes the five mesh specimens (none
    skipped); ``--comm-budget-bytes`` reaches SHD304 only where a
    specimen has no budget of its own (``parallel.sharded_train_step``,
    as in JAX)."""
    args = ['--json', '--device', 'cpu', '--select', 'SHD304',
            '--baseline', str(tmp_path / 'none.json'), '--fail-on', 'any']
    rc, out = _run(args, capsys)
    assert rc == 0 and json.loads(out)['findings'] == []
    rc, out = _run(args + ['--comm-budget-bytes', '64'], capsys)
    assert rc == 1
    assert [(f['rule'], f['where'].split(':')[0])
            for f in json.loads(out)['findings']] == [
        ('SHD304', 'parallel.sharded_train_step')]
    # The text report's progress lines (the ranks' runs are this
    # process's, started once).
    main(args[1:-2] + ['--fail-on', 'none'])
    err = capsys.readouterr().err
    for name in ('sharded_train_step', 'sharded_forward_rows',
                 'sharded_train_step_pairs2', 'streamed_train_step',
                 'sharded_topk_cols'):
        assert f'sharded parallel.{name} on ' in err, err
    assert 'gloo ranks on cpu' in err and 'skip ' not in err
