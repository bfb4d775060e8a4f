"""Finding/severity model and the baseline-suppression file.

The port's copy of the JAX package's ``dgmc_tpu/analysis/findings.py``:
the same :class:`Finding` records, fingerprints and baseline format (a
baseline either package writes loads in the other's loader). The one
difference is the baseline's name, :data:`DEFAULT_BASELINE_NAME`
(``lint-baseline-torch.json``), so the walk up from the working
directory finds the port's ledger and never the JAX package's.

A :class:`Finding` is one detected hazard: a rule id, a severity, a
``where`` (stable location — ``file:line`` for source findings,
``specimen:label`` for the recompile pass), and a message. Its
:attr:`~Finding.fingerprint` is a stable hash of the identity fields
(never the free-text detail), so a committed baseline keeps suppressing
a finding across unrelated edits but releases it the moment the finding
moves or changes class.

Fingerprints are **line-number independent** (baseline version 2): the
trailing ``:line`` of ``where`` is stripped before hashing, and the
finding's :attr:`~Finding.context` — a normalized snippet of what was
actually flagged (the source line's text) — takes its place as the
within-file discriminator. Pure line relocation (an edit above the
finding) leaves the fingerprint unchanged; the finding moving to
different code (new context) releases it. Version-1 baselines hashed the
raw line number; ``--write-baseline`` is the one-shot migration.

The baseline file is the reviewed debt ledger: ``--write-baseline``
records the current findings; ``--fail-on new`` then fails only on
findings whose fingerprint is not in the ledger. Pure Python (no torch),
so the CLI can report and diff baselines anywhere.
"""

import dataclasses
import enum
import hashlib
import json
import linecache
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple


class Severity(enum.IntEnum):
    """Ordered severity; comparisons follow the int value."""
    INFO = 10
    WARNING = 20
    ERROR = 30

    @classmethod
    def parse(cls, name):
        try:
            return cls[str(name).upper()]
        except KeyError:
            raise ValueError(
                f'unknown severity {name!r}; expected one of '
                f'{[s.name.lower() for s in cls]}') from None


#: Trailing ``:line`` of a ``where`` string — stripped before hashing so
#: pure line relocation never churns the fingerprint.
_WHERE_LINE = re.compile(r':\d+$')


@dataclasses.dataclass(frozen=True)
class Finding:
    """One detected hazard.

    Args:
        rule: stable rule id (``SRC101``, ``CON501``, ``RCP201``...).
        severity: :class:`Severity`.
        where: stable location string; source findings use
            ``relative/file.py:line``, the recompile pass
            ``specimen:label``.
        message: one-line human description (identity-bearing: part of
            the fingerprint, so keep it deterministic).
        detail: free-form extra context (NOT fingerprinted — safe to
            enrich without invalidating baselines).
        context: normalized snippet of what was flagged — the source
            line's stripped text for source-located findings.
            Identity-bearing:
            together with the line-stripped ``where`` it replaces the
            line number in the fingerprint, so relocation keeps the
            suppression but a different flagged construct releases it.
    """
    rule: str
    severity: Severity
    where: str
    message: str
    detail: Optional[str] = None
    context: Optional[str] = None

    @property
    def fingerprint(self) -> str:
        where = _WHERE_LINE.sub('', self.where)
        ident = f'{self.rule}|{where}|{self.message}'
        if self.context:
            ident += f'|{self.context}'
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        out = {
            'rule': self.rule,
            'severity': self.severity.name.lower(),
            'where': self.where,
            'message': self.message,
            'fingerprint': self.fingerprint,
        }
        if self.detail:
            out['detail'] = self.detail
        if self.context:
            out['context'] = self.context
        return out


def disambiguate_contexts(findings: Iterable[Finding]) -> List[Finding]:
    """Suffix an occurrence ordinal onto the context of every
    same-identity duplicate (same rule, line-stripped where, message,
    and context) so two IDENTICAL violating statements in one file keep
    distinct fingerprints — without it, a copy-pasted duplicate of a
    baselined violation would silently ride its suppression. The first
    occurrence keeps the bare context (stable under relocation); every
    producer calls this on its per-program output, so ordering — and
    with it, which occurrence is first — is the program's deterministic
    walk order."""
    seen: Dict[tuple, int] = {}
    out = []
    for f in findings:
        key = (f.rule, _WHERE_LINE.sub('', f.where), f.message,
               f.context)
        n = seen.get(key, 0)
        seen[key] = n + 1
        if n and f.context:
            f = dataclasses.replace(f, context=f'{f.context} #{n + 1}')
        out.append(f)
    return out


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Severity-descending, then stable by (rule, where, message)."""
    return sorted(findings,
                  key=lambda f: (-int(f.severity), f.rule, f.where,
                                 f.message))


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------

#: Version 2 = line-number-independent (context-hash) fingerprints.
#: Version-1 ledgers hold line-hashed fingerprints that can never match
#: a v2 finding — loading one for a CHECK is an error (everything would
#: silently report as new-and-unsuppressed or stale); the one-shot
#: migration is ``dgmc-lint --write-baseline``, which re-records the
#: same reviewed findings under their v2 fingerprints.
BASELINE_VERSION = 2
_MIGRATABLE_VERSIONS = (1,)
DEFAULT_BASELINE_NAME = 'lint-baseline-torch.json'


def read_source_line(rel_path: str, lineno: int) -> Optional[str]:
    """The stripped text of ``rel_path:lineno`` — the normalized context
    snippet line-located findings fingerprint on. ``rel_path`` is the
    repo-relative spelling provenance uses
    (``dgmc_tpu_torch/ops/graph.py``),
    resolved against the tree this package was imported from, then the
    cwd; None when the file or line cannot be read (callers fall back
    to a structural snippet). Reads ride :mod:`linecache`, so N
    findings in one module cost one file read, not N scans."""
    if not rel_path or lineno <= 0:
        return None
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for root in (pkg_parent, os.getcwd()):
        cand = os.path.join(root, rel_path)
        if not os.path.isfile(cand):
            continue
        line = linecache.getline(cand, lineno)
        return line.strip() or None
    return None


def default_baseline_path(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default cwd) looking for an existing
    baseline file; fall back to the repo root guess (the directory
    holding the ``dgmc_tpu_torch`` package), else ``cwd/<name>``."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        cand = os.path.join(d, DEFAULT_BASELINE_NAME)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_guess = os.path.join(os.path.dirname(pkg_root),
                              DEFAULT_BASELINE_NAME)
    if os.path.exists(repo_guess):
        return repo_guess
    return os.path.join(os.path.abspath(start or os.getcwd()),
                        DEFAULT_BASELINE_NAME)


def baseline_version(path: str) -> Optional[int]:
    """The ``version`` field of a baseline file, or None when absent or
    unreadable — the migration-warning probe (lint.py warns when a
    ``--write-baseline`` over a v1 ledger must preserve entries it
    cannot re-fingerprint)."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f).get('version')
    except (OSError, ValueError):
        return None


def load_baseline(path: str, migrate: bool = False) -> Dict[str, dict]:
    """``{fingerprint: recorded entry}`` — empty when the file is absent.

    A version-1 ledger (legacy line-hashed fingerprints) raises unless
    ``migrate`` is set: its fingerprints can never match a v2 finding,
    so checking against one silently un-suppresses everything. The
    baseline *rewriters* (``--write-baseline`` / ``--prune-baseline``)
    pass ``migrate=True`` — they only need the old entries to preserve
    unanalyzed tiers, and re-record everything else under v2
    fingerprints (the one-shot migration).
    """
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    version = data.get('version')
    if version == BASELINE_VERSION:
        return {e['fingerprint']: e for e in data.get('findings', [])}
    if version in _MIGRATABLE_VERSIONS:
        if migrate:
            return {e['fingerprint']: e for e in data.get('findings', [])}
        raise ValueError(
            f'{path}: baseline version {version} carries legacy '
            f'line-number fingerprints; run `dgmc-lint --write-baseline` '
            f'once to migrate it to version {BASELINE_VERSION} '
            f'(line-independent context fingerprints)')
    raise ValueError(
        f'{path}: unsupported baseline version {version!r} '
        f'(this dgmc-lint writes version {BASELINE_VERSION})')


def write_baseline(path: str, findings: Iterable[Finding],
                   preserved_entries: Iterable[dict] = ()) -> dict:
    """Write the suppression ledger (sorted, stable) and return it.

    ``preserved_entries`` are raw prior-baseline entries to carry over
    verbatim — the entries of tiers and rules the writing run did not
    analyze (a skipped tier, a ``--select`` subset, no ``--obs-dir``),
    so a partial refresh cannot silently un-suppress findings that a
    full run will still produce.
    """
    entries = {e['fingerprint']: dict(e) for e in preserved_entries}
    for f in sort_findings(findings):
        entries[f.fingerprint] = f.to_json()
    payload = {
        'version': BASELINE_VERSION,
        'tool': 'dgmc-lint',
        'findings': sorted(entries.values(),
                           key=lambda e: (e['rule'], e['where'],
                                          e['message'])),
    }
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write('\n')
    os.replace(tmp, path)
    return payload


def split_by_baseline(findings: Iterable[Finding],
                      baseline: Dict[str, dict],
                      ) -> Tuple[List[Finding], List[Finding]]:
    """Partition into (new, suppressed) against a loaded baseline."""
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint in baseline else new).append(f)
    return new, suppressed
