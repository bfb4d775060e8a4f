"""``dgmc-lint`` for the port: the static-analysis CLI.

Usage::

    python -m dgmc_tpu_torch.analysis.lint [--json] [--fail-on new]
    ... --write-baseline             # record current findings
    ... --json --fail-on new         # CI gate: fail on un-baselined
    ... --obs-dir RUN_DIR            # + recompile telemetry cross-check
    ... --explain SRC102             # one rule's what/why/fix
    ... --select CON501,CON503       # only these rules
    ... --ignore CON503              # drop these rules
    ... --prune-baseline             # drop stale baseline entries
    ... --device cpu                 # the trace tier on the CPU

The port's counterpart of the JAX package's ``python -m
dgmc_tpu.analysis.lint``, with its flags, report format, baseline file
format and exit statuses for JAX's six tiers (each skippable):
``--skip-trace`` (TRC: one recorded run of each registered specimen,
:mod:`~dgmc_tpu_torch.analysis.registry`, on ``--device``: ``cuda`` by
default, where the specimens launch the kernels; ``cpu`` runs their
plain versions), ``--skip-sharded`` (SHD: the collectives of the mesh
specimens' runs), ``--skip-sched`` (SCH/MEM: the schedule model and the
static peak of the same runs), ``--skip-source`` (SRC: ``ast`` lints
over captured code), ``--skip-concurrency`` (CON: thread-entry/lock
rules) and ``--skip-recompile`` (RCP: padding-bucket churn). The mesh
specimens run on 4 local gloo ranks the CLI starts (on ``--device``;
on ``cuda`` the ranks share the card), once for every tier that reads
them, unless the process is in a world of enough ranks
(:mod:`~dgmc_tpu_torch.analysis.ranks`). ``--comm-budget-bytes`` is
SHD304's budget for a specimen without its own. The recompile pass
needs a recorded run's buckets: it runs only when ``--obs-dir`` is given
— padding buckets are a runtime artifact, there is nothing to analyze
statically without one. A tier runs only when a selected rule needs it,
and the CLI imports torch only when a specimen tier runs.

The source and concurrency tiers scan the package plus ``chip_smoke.py``
when it sits beside the package; ``--source-root`` overrides the whole
root set with one tree. The baseline is ``lint-baseline-torch.json``
(the nearest one walking up from the working directory, else the one
beside the package).

Output: human text (default), ``--json`` (machine-readable, stable),
or ``--format github`` (GitHub Actions ``::error file=...``
annotations for NEW findings).

Exit status: 0 clean under the ``--fail-on`` policy, 1 otherwise, 2 on
usage errors. ``--fail-on`` policies: ``new`` (default — findings not in
the baseline), ``error`` (new findings at ERROR), ``any`` (any finding,
baselined or not), ``none`` (always exit 0; report only).
"""

import argparse
import json
import os
import sys

from dgmc_tpu_torch.analysis import findings as findings_mod
from dgmc_tpu_torch.analysis.catalog import RULE_CATALOG, explain_rule
from dgmc_tpu_torch.analysis.findings import (Severity,
                                              default_baseline_path,
                                              load_baseline, sort_findings,
                                              split_by_baseline,
                                              write_baseline)

__all__ = ['RULE_CATALOG', 'build_parser', 'collect_findings', 'main']


def build_parser():
    p = argparse.ArgumentParser(
        prog='dgmc-lint',
        description='Static analysis of the PyTorch/CUDA port: trace '
                    'rules over recorded specimen runs, the mesh '
                    'specimens\' collectives, schedule and peak, source '
                    'ast lints over captured code, concurrency rules, and '
                    'recompile-hazard checks.')
    p.add_argument('--json', action='store_true',
                   help='emit the machine-readable report on stdout '
                        '(alias for --format json; byte-stable)')
    p.add_argument('--format', choices=('text', 'json', 'github'),
                   default=None,
                   help='report format: text (default), json (same '
                        'bytes as --json), or github (GitHub Actions '
                        '::error/::warning annotations for NEW '
                        'findings + a summary line)')
    p.add_argument('--baseline', default=None,
                   help='baseline-suppression file (default: nearest '
                        f'{findings_mod.DEFAULT_BASELINE_NAME} walking '
                        'up from cwd)')
    p.add_argument('--write-baseline', action='store_true',
                   help='record the current findings as the baseline '
                        'and exit 0')
    p.add_argument('--prune-baseline', action='store_true',
                   help='drop baseline entries whose finding no longer '
                        'reproduces (tiers/rules not analyzed in this '
                        'run are preserved) and exit 0')
    p.add_argument('--fail-on', choices=('new', 'error', 'any', 'none'),
                   default='new',
                   help='exit-1 policy (default: new — findings not in '
                        'the baseline)')
    p.add_argument('--min-severity', default='info',
                   help='drop findings below this severity from the '
                        'report and the --fail-on policy '
                        '(info|warning|error); baseline rewrites '
                        '(--write-baseline/--prune-baseline) ignore it '
                        'so a filtered run cannot un-suppress reviewed '
                        'lower-severity entries')
    p.add_argument('--select', '--rules', dest='select', default=None,
                   help='comma-separated rule ids to keep (default all; '
                        'tiers none of whose rules survive the filter '
                        'are skipped entirely; --rules is the legacy '
                        'spelling)')
    p.add_argument('--ignore', default=None,
                   help='comma-separated rule ids to drop')
    p.add_argument('--skip-trace', action='store_true',
                   help='skip the trace tier (recorded specimen runs)')
    p.add_argument('--skip-source', action='store_true',
                   help='skip the source ast tier')
    p.add_argument('--skip-recompile', action='store_true',
                   help='skip the padding-bucket recompile pass')
    p.add_argument('--skip-sharded', action='store_true',
                   help='skip the sharded (SHD) tier')
    p.add_argument('--skip-sched', action='store_true',
                   help='skip the schedule & liveness (SCH/MEM) tier')
    p.add_argument('--skip-concurrency', action='store_true',
                   help='skip the concurrency (CON) tier')
    p.add_argument('--source-root', default=None,
                   help='source tree to lint with the SRC and CON '
                        'tiers (default: the installed dgmc_tpu_torch '
                        'package plus chip_smoke.py when present '
                        'beside it)')
    p.add_argument('--obs-dir', default=None,
                   help='recorded obs run dir: cross-check its padding '
                        'buckets + compile telemetry (RCP202)')
    p.add_argument('--max-const-bytes', type=int, default=None,
                   help='TRC002 threshold in bytes (default 1 MiB)')
    p.add_argument('--comm-budget-bytes', type=int, default=None,
                   help='SHD304 fallback budget for specimens without '
                        'their own comm_budget_bytes (default: only '
                        'per-specimen budgets fire)')
    p.add_argument('--device', default='cuda',
                   help='where the trace tier runs the specimens (default '
                        'cuda: the kernels launch; cpu: their plain '
                        'versions)')
    p.add_argument('--list-rules', action='store_true',
                   help='print the rule catalog and exit')
    p.add_argument('--explain', default=None, metavar='RULE[,RULE...]',
                   help="print the rule's what/why/fix doc and exit")
    return p


def collect_findings(args, progress):
    """``(findings, skipped_specimens)`` for the enabled tiers. A tier
    runs only when it can still produce a selected rule
    (``_rules_analyzed`` — also the baseline writers' preservation set —
    is the single source of that truth)."""
    rules = _rules_analyzed(args)

    def tier_on(prefix):
        return any(r.startswith(prefix) for r in rules)

    out = []
    skipped = []
    if tier_on('SRC'):
        from dgmc_tpu_torch.analysis.source_rules import lint_source_paths
        roots = _source_roots(args)
        progress(f'source tier: {", ".join(roots)}')
        out.extend(lint_source_paths(roots))
    if tier_on('CON'):
        from dgmc_tpu_torch.analysis.con_rules import lint_concurrency_paths
        roots = _source_roots(args)
        progress(f'concurrency tier: {", ".join(roots)}')
        out.extend(lint_concurrency_paths(roots))
    if tier_on('RCP'):
        # _rules_analyzed drops RCP without --obs-dir: padding buckets
        # are a runtime artifact, there is nothing to analyze
        # statically.
        from dgmc_tpu_torch.analysis.recompile import (analyze_buckets,
                                                       load_obs_buckets)
        buckets, events = load_obs_buckets(args.obs_dir)
        progress(f'recompile pass: {len(buckets)} observed bucket(s) '
                 f'from {args.obs_dir}')
        out.extend(analyze_buckets(buckets, specimen='obs',
                                   compile_events=events))
    cache = None
    if any(tier_on(t) for t in ('TRC', 'SHD', 'SCH', 'MEM')):
        from dgmc_tpu_torch.analysis.registry import shared_cache
        cache = shared_cache(args.device)
    if tier_on('TRC'):
        from dgmc_tpu_torch.analysis.registry import run_trace_tier
        out.extend(run_trace_tier(const_bytes=args.max_const_bytes,
                                  on_progress=progress, skipped=skipped,
                                  cache=cache))
    if tier_on('SHD'):
        from dgmc_tpu_torch.analysis.shd_rules import run_sharded_tier
        out.extend(run_sharded_tier(
            cache=cache, comm_budget_bytes=args.comm_budget_bytes,
            on_progress=progress, skipped=skipped))
    if tier_on('SCH') or tier_on('MEM'):
        from dgmc_tpu_torch.analysis.sched_rules import run_sched_tier
        out.extend(run_sched_tier(cache=cache, on_progress=progress,
                                  skipped=skipped))
    return out, skipped


#: Repo-root files linted alongside the package when they exist beside
#: it: the card's smoke script captures steps and runs threads too.
_SCRIPT_ROOTS = ('chip_smoke.py',)


def _source_roots(args):
    """The SRC/CON scan roots: ``--source-root`` verbatim when given,
    else the package plus whichever repo-root scripts exist beside
    it."""
    if args.source_root is not None:
        return [args.source_root]
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [pkg]
    repo = os.path.dirname(pkg)
    for name in _SCRIPT_ROOTS:
        cand = os.path.join(repo, name)
        if os.path.exists(cand):
            roots.append(cand)
    return roots


def _rules_analyzed(args):
    """The rule-id set this run can produce, given tier skips and
    select/ignore filters — everything OUTSIDE it is preserved on
    baseline rewrites."""
    rules = set(RULE_CATALOG)
    if args.skip_trace:
        rules -= {r for r in rules if r.startswith('TRC')}
    if args.skip_source:
        rules -= {r for r in rules if r.startswith('SRC')}
    if args.skip_recompile or not args.obs_dir:
        rules -= {r for r in rules if r.startswith('RCP')}
    if args.skip_sharded:
        rules -= {r for r in rules if r.startswith('SHD')}
    if args.skip_sched:
        rules -= {r for r in rules if r.startswith(('SCH', 'MEM'))}
    if args.skip_concurrency:
        rules -= {r for r in rules if r.startswith('CON')}
    if args.select:
        rules &= _parse_rules(args.select)
    if args.ignore:
        rules -= _parse_rules(args.ignore)
    return rules


def _entries_not_analyzed(prior_baseline, args, skipped_specimens=()):
    """Prior-baseline entries whose producing tier/specimen/rule this
    run did not analyze — preserved verbatim on ``--write-baseline`` /
    ``--prune-baseline`` so a partial refresh (a skipped tier or
    specimen, a --select subset, no --obs-dir) cannot silently
    un-suppress findings a full run will still produce."""
    skipped = set(skipped_specimens)
    analyzed_rules = _rules_analyzed(args)
    return [e for e in prior_baseline.values()
            if e.get('rule', '') not in analyzed_rules
            or e.get('where', '').split(':', 1)[0] in skipped]


def _parse_rules(spec):
    return {r.strip() for r in spec.split(',') if r.strip()}


def render_text(report, stream=None):
    w = (stream or sys.stdout).write
    for f in report['findings']:
        mark = '' if f['fingerprint'] not in report['_suppressed'] else \
            ' [baselined]'
        w(f"{f['severity'].upper():7s} {f['rule']} {f['where']}{mark}\n")
        w(f"        {f['message']}\n")
        if f.get('detail'):
            w(f"        ({f['detail']})\n")
    s = report['summary']
    w(f"dgmc-lint: {s['total']} finding(s) — {s['new']} new, "
      f"{s['suppressed']} baselined "
      f"(errors {s['errors']}, warnings {s['warnings']}, "
      f"infos {s['infos']})\n")


_GH_LEVEL = {'error': 'error', 'warning': 'warning', 'info': 'notice'}


def _gh_escape(s):
    """GitHub workflow-command escaping (%, CR, LF; commas/colons too
    in property values, per the runner's parser)."""
    return (str(s).replace('%', '%25').replace('\r', '%0D')
            .replace('\n', '%0A'))


def _gh_escape_prop(s):
    return _gh_escape(s).replace(':', '%3A').replace(',', '%2C')


def _where_file_line(where):
    """``(file, line)`` parsed out of a finding's where string —
    ``path/file.py:12``; (None, None) for non-file locations (the
    recompile pass's ``obs:...``)."""
    parts = where.split(':')
    for i, part in enumerate(parts):
        if part.endswith('.py'):
            line = None
            if i + 1 < len(parts) and parts[i + 1].isdigit():
                line = parts[i + 1]
            return part, line
    return None, None


def render_github(report, stream=None):
    """GitHub Actions annotations for the NEW findings (baselined ones
    are reviewed debt — annotating them on every PR would be noise),
    plus the same summary line the text renderer ends with."""
    new = set(report['new'])
    w = (stream or sys.stdout).write
    for f in report['findings']:
        if f['fingerprint'] not in new:
            continue
        level = _GH_LEVEL.get(f['severity'], 'warning')
        file, line = _where_file_line(f['where'])
        props = [f'title={_gh_escape_prop("dgmc-lint " + f["rule"])}']
        if file:
            props.insert(0, f'file={_gh_escape_prop(file)}')
            if line:
                props.insert(1, f'line={line}')
        w(f'::{level} {",".join(props)}::'
          f'{_gh_escape(f["rule"] + ": " + f["message"])}\n')
    s = report['summary']
    w(f"dgmc-lint: {s['total']} finding(s) — {s['new']} new, "
      f"{s['suppressed']} baselined "
      f"(errors {s['errors']}, warnings {s['warnings']}, "
      f"infos {s['infos']})\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULE_CATALOG.items()):
            print(f'{rule}  {desc}')
        return 0
    if args.explain:
        rules = sorted(_parse_rules(args.explain))
        unknown = [r for r in rules if r not in RULE_CATALOG]
        if unknown:
            print(f'dgmc-lint: unknown rule id(s): {unknown} '
                  f'(--list-rules prints the catalog)', file=sys.stderr)
            return 2
        print('\n\n'.join(explain_rule(r) for r in rules))
        return 0
    if args.write_baseline and args.prune_baseline:
        print('dgmc-lint: --write-baseline and --prune-baseline are '
              'mutually exclusive (regenerate OR prune)',
              file=sys.stderr)
        return 2

    if args.json and args.format not in (None, 'json'):
        print(f'dgmc-lint: --json conflicts with '
              f'--format {args.format}', file=sys.stderr)
        return 2
    fmt = args.format or ('json' if args.json else 'text')
    quiet = fmt == 'json'

    def progress(msg):
        if not quiet:
            print(f'[dgmc-lint] {msg}', file=sys.stderr)

    try:
        min_sev = Severity.parse(args.min_severity)
    except ValueError as e:
        print(f'dgmc-lint: {e}', file=sys.stderr)
        return 2
    keep_rules = _parse_rules(args.select) if args.select else None
    drop_rules = _parse_rules(args.ignore) if args.ignore else set()
    unknown = ((keep_rules or set()) | drop_rules) - set(RULE_CATALOG)
    if unknown:
        print(f'dgmc-lint: unknown rule id(s): {sorted(unknown)}',
              file=sys.stderr)
        return 2

    if args.obs_dir and not os.path.exists(
            os.path.join(args.obs_dir, 'timings.json')):
        # A vanished obs dir must not silently disable the telemetry
        # cross-check the caller asked for (e.g. the CI gate).
        print(f'dgmc-lint: --obs-dir {args.obs_dir} has no timings.json '
              f'(not an obs run directory?)', file=sys.stderr)
        return 2

    found, skipped_specimens = collect_findings(args, progress)
    if keep_rules is not None:
        found = [f for f in found if f.rule in keep_rules]
    if drop_rules:
        found = [f for f in found if f.rule not in drop_rules]
    found = sort_findings(found)
    # --min-severity filters the REPORT only. Baseline rewrites work on
    # the unfiltered set: `--prune-baseline --min-severity error` must
    # not classify still-reproducing warning/info suppressions as stale
    # (_entries_not_analyzed protects skipped tiers/rules, but severity
    # is a per-finding property it cannot see).
    reported = [f for f in found if f.severity >= min_sev]

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        # migrate=True: rewriting is the one-shot migration path off
        # legacy (version-1, line-hashed) baselines — the old entries
        # are only needed to preserve unanalyzed tiers.
        prior_version = findings_mod.baseline_version(baseline_path)
        preserved = _entries_not_analyzed(
            load_baseline(baseline_path, migrate=True), args,
            skipped_specimens)
        if prior_version == 1 and preserved:
            # Preserved v1 entries keep legacy line-hashed fingerprints
            # that can never match a v2 finding: the tiers this run
            # skipped will report as NEW wherever they do run.
            print(f'dgmc-lint: WARNING: migrated a version-1 baseline '
                  f'while {len(preserved)} entr'
                  f'{"y" if len(preserved) == 1 else "ies"} of '
                  f'unanalyzed tiers had to be preserved with legacy '
                  f'fingerprints that can never match again — re-run '
                  f'--write-baseline with every tier on (and --obs-dir '
                  f'for the recompile pass) or the gate will report '
                  f'those findings as new', file=sys.stderr)
        write_baseline(baseline_path, found, preserved_entries=preserved)
        if not quiet:
            kept = (f' (+ {len(preserved)} preserved from tiers not '
                    f'analyzed here)' if preserved else '')
            print(f'dgmc-lint: wrote {len(found)} finding(s) to '
                  f'{baseline_path}{kept}')
    elif args.prune_baseline:
        # NO migrate here: prune never re-records findings, so against a
        # v1 (line-hashed) ledger every analyzed entry would read as
        # stale and the whole reviewed debt ledger would be deleted in
        # one command. Migration is --write-baseline's job.
        try:
            prior = load_baseline(baseline_path)
        except ValueError as e:
            print(f'dgmc-lint: {e}', file=sys.stderr)
            return 2
        produced = {f.fingerprint for f in found}
        protected = {e['fingerprint'] for e in _entries_not_analyzed(
            prior, args, skipped_specimens)}
        stale = [e for fp, e in prior.items()
                 if fp not in produced and fp not in protected]
        kept = [e for fp, e in prior.items()
                if fp in produced or fp in protected]
        # Prune only: kept entries pass through verbatim, nothing is
        # added — accepting NEW findings stays an explicit
        # --write-baseline review.
        write_baseline(baseline_path, (), preserved_entries=kept)
        if not quiet:
            print(f'dgmc-lint: pruned {len(stale)} stale entr'
                  f'{"y" if len(stale) == 1 else "ies"} from '
                  f'{baseline_path} ({len(kept)} kept)')
            for e in stale:
                print(f'  - {e.get("rule")} {e.get("where")}')
        return 0

    try:
        baseline = load_baseline(baseline_path)
    except ValueError as e:
        # Legacy (line-hashed) or unknown baseline version: checking
        # against it would silently report everything as new — surface
        # the migration instruction as a usage error instead.
        print(f'dgmc-lint: {e}', file=sys.stderr)
        return 2
    new, suppressed = split_by_baseline(reported, baseline)

    report = {
        'tool': 'dgmc-lint',
        'baseline': baseline_path if baseline or args.write_baseline
        else None,
        'findings': [f.to_json() for f in reported],
        'new': [f.fingerprint for f in new],
        'summary': {
            'total': len(reported),
            'new': len(new),
            'suppressed': len(suppressed),
            'errors': sum(f.severity == Severity.ERROR
                          for f in reported),
            'warnings': sum(f.severity == Severity.WARNING
                            for f in reported),
            'infos': sum(f.severity == Severity.INFO for f in reported),
        },
    }
    if fmt == 'json':
        print(json.dumps(report, indent=1, sort_keys=True))
    elif fmt == 'github':
        render_github(report)
    else:
        report['_suppressed'] = {f.fingerprint for f in suppressed}
        render_text(report)
        del report['_suppressed']

    if args.write_baseline or args.fail_on == 'none':
        return 0
    if args.fail_on == 'any':
        return 1 if reported else 0
    if args.fail_on == 'error':
        return 1 if any(f.severity == Severity.ERROR for f in new) else 0
    return 1 if new else 0                                   # 'new'


if __name__ == '__main__':
    try:
        sys.exit(main())
    except BrokenPipeError:   # |head closed the pipe mid-report
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(1)
