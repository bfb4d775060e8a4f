"""Concurrency-tier lints (CON5xx): static race detection over the
threaded serve plane.

The port's copy of the JAX package's ``dgmc_tpu/analysis/con_rules.py``:
the same rules, messages and fingerprints, over the port's source.

Five rules, all reading the per-module model built by
:mod:`dgmc_tpu_torch.analysis.concurrency`:

``CON501`` unlocked-shared-rmw
    A class attribute is read-modify-written (``+=`` / ``self.x =
    self.x + ...``) from a method reachable from a thread entry point
    while NO write site of that attribute in the class holds a lock.
    The serve-counter race as a rule: ``+=`` is read-op-write,
    not atomic, so concurrent handler threads lose increments. Plain
    rebinding (``self.x = value``) is exempt — a single STORE_ATTR is
    atomic under the GIL and the watchdog's cache refreshes rely on
    that.
``CON502`` lock-order-inversion
    Two locks of one class are acquired nested in both orders across
    call paths (lexically, or one ``self.<m>()`` call level deep).
    Deadlock by construction the first time two threads interleave.
``CON503`` non-atomic-artifact-write
    ``open(path, 'w')`` on an artifact path in a function that never
    calls ``os.replace``/``os.rename`` and whose path expression does
    not name a temp file. A concurrent reader (supervisor, scraper) or
    a crash mid-write observes a torn file; the repo's discipline is
    tmp+rename (``utils/io.write_json_atomic``).
``CON504`` unsafe-signal-handler
    A registered ``signal.signal`` handler acquires a lock, performs
    buffered IO (``open``/``print``/logging), or builds allocation-
    heavy formatted output (``json.dumps``, ``str.format``,
    ``traceback.format_*``, ``''.join``) directly in its body. The
    handler interrupts the main thread at an arbitrary point: any lock
    may already be held. The watchdog's lock-free signal path
    (``_on_signal`` -> ``dump(use_locks=False)``) is the positive
    model.
``CON505`` unbounded-shared-growth
    A list/dict/set/deque attribute grows (``.append``/``.add``/keyed
    store) from a thread-entry method and the class shows no cap: no
    ``deque(maxlen=...)``, no ``len()`` check, no eviction, no
    rotation. A long-lived serving process accretes per-query state
    until the OOM killer arrives; the bounded-ring discipline
    (FlightRecorder, qtrace capacity) exists for this.

Like the source tier, the scanner refuses bytecode and attaches the
flagged line's stripped text as the finding context (line-independent
v2 fingerprints).
"""

import ast
import os
from typing import List, Optional, Sequence

from dgmc_tpu_torch.analysis.concurrency import (ModuleModel,
                                           build_module_model,
                                           _mentions_tmp, _self_attr)
from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                        disambiguate_contexts)
from dgmc_tpu_torch.analysis.source_rules import (_refuse_bytecode,
                                            _with_line_context,
                                            iter_source_files)

__all__ = ['lint_concurrency_file', 'lint_concurrency_tree',
           'lint_concurrency_paths']

#: Attribute names on ``self`` whose mutation is synchronization, not
#: shared state (events/flags set from handlers by design).
_SYNC_FACTORY_NAMES = {'Event', 'Barrier'}

_LOGGING_METHODS = {'debug', 'info', 'warning', 'warn', 'error',
                    'exception', 'critical', 'log'}
_HEAVY_FORMATTERS = {'dumps', 'format', 'join'}


def _finding(rule, severity, rel, node, message, detail=None) -> Finding:
    return Finding(rule=rule, severity=severity,
                   where=f'{rel}:{getattr(node, "lineno", 0)}',
                   message=message, detail=detail)


def _sync_attrs(cls) -> set:
    """Attrs assigned ``threading.Event()``-style sync primitives —
    ``.set()`` from a handler thread is their whole point."""
    out = set()
    for m in cls.methods.values():
        for stmt in ast.walk(m):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call):
                f = stmt.value.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if name in _SYNC_FACTORY_NAMES:
                    for t in stmt.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            out.add(attr)
    return out


# ---------------------------------------------------------------------------
# CON501 — unlocked read-modify-write from a thread-entry path
# ---------------------------------------------------------------------------

def _check_unlocked_rmw(model: ModuleModel, rel) -> List[Finding]:
    out = []
    for cls in model.classes:
        if not cls.entry_closure:
            continue
        sync = _sync_attrs(cls)
        for attr, sites in sorted(cls.writes_by_attr().items()):
            if attr in cls.lock_attrs or attr in sync:
                continue
            live = [w for w in sites if not w.in_init]
            if not live:
                continue
            # Any guarded write means the class HAS a locking story for
            # this attribute; mixed-discipline is a different (noisier)
            # analysis, out of scope for a gate.
            if any(w.locks_held for w in live):
                continue
            for w in live:
                if not w.rmw or w.method not in cls.entry_closure:
                    continue
                kind, origin = cls.entry_closure[w.method]
                via = (f'`{cls.name}.{w.method}`' if w.method == origin
                       else f'`{cls.name}.{w.method}` (reached from '
                            f'{kind} entry `{origin}`)')
                out.append(_finding(
                    'CON501', Severity.ERROR, rel, w.node,
                    f'`self.{attr}` read-modify-written from thread '
                    f'entry path {via} with no lock on any write site '
                    f'— concurrent increments are lost',
                    detail=f'entry kind: {kind}; guard every write of '
                           f'`{attr}` with a class lock (the '
                           f'StreamingHistogram.observe pattern) or '
                           f'make it thread-local'))
    return out


# ---------------------------------------------------------------------------
# CON502 — inconsistent nested lock order
# ---------------------------------------------------------------------------

def _check_lock_order(model: ModuleModel, rel) -> List[Finding]:
    out = []
    for cls in model.classes:
        reported = set()
        for (a, b), site in sorted(
                cls.lock_edges.items(),
                key=lambda kv: getattr(kv[1], 'lineno', 0)):
            if (b, a) not in cls.lock_edges:
                continue
            pair = frozenset((a, b))
            if pair in reported:
                continue
            reported.add(pair)
            other = cls.lock_edges[(b, a)]
            # Anchor on the later-in-file site; name both.
            first, second = sorted(
                (site, other), key=lambda n: getattr(n, 'lineno', 0))
            out.append(_finding(
                'CON502', Severity.ERROR, rel, second,
                f'locks `{a}` and `{b}` of `{cls.name}` are acquired '
                f'nested in both orders — deadlock by construction '
                f'when two threads interleave',
                detail=f'opposite-order site: {rel}:'
                       f'{getattr(first, "lineno", 0)}; pick one '
                       f'canonical order, or release the first lock '
                       f'before taking the second'))
    return out


# ---------------------------------------------------------------------------
# CON503 — artifact written in place (no tmp+rename)
# ---------------------------------------------------------------------------

def _open_write_mode(call: ast.Call) -> Optional[str]:
    """The mode string when ``call`` is ``open(..., 'w'/'wb'/...)``
    (truncating write), else None."""
    if not (isinstance(call.func, ast.Name) and call.func.id == 'open'):
        return None
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == 'mode' and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            mode = kw.value.value
    if mode and mode.startswith(('w', 'x')):
        return mode
    return None


def _check_artifact_writes(tree: ast.Module, rel) -> List[Finding]:
    out = []
    # Each def is its own scope; module top level is a pseudo-scope.
    scopes: List[ast.AST] = [tree]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append(node)
    for scope in scopes:
        own = list(_iter_scope(scope))
        renames = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in ('replace', 'rename', 'renames')
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == 'os'
            for n in own)
        if renames:
            continue
        name = getattr(scope, 'name', '<module>')
        for n in own:
            if not isinstance(n, ast.Call):
                continue
            mode = _open_write_mode(n)
            if mode is None or not n.args:
                continue
            if _mentions_tmp(n.args[0]):
                continue
            out.append(_finding(
                'CON503', Severity.WARNING, rel, n,
                f'`open(..., {mode!r})` in `{name}` writes the '
                f'artifact in place — a reader or crash mid-write '
                f'sees a torn file',
                detail='write to a tmp path and os.replace() it into '
                       'place (utils/io.write_json_atomic is the '
                       'repo model), or append instead'))
    return out


def _iter_scope(scope: ast.AST):
    """Nodes belonging to ``scope`` directly — not to a nested def."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# CON504 — unsafe work in a signal handler
# ---------------------------------------------------------------------------

def _check_signal_handlers(model: ModuleModel, rel) -> List[Finding]:
    out = []
    for handler in model.signal_handlers:
        scope = handler.node
        hazards = []
        for n in _iter_scope(scope):
            if isinstance(n, ast.With):
                for item in n.items:
                    if _is_lockish(item.context_expr, handler.lock_names):
                        hazards.append((item.context_expr,
                                        'acquires a lock (`with ...`)'))
            elif isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute):
                    if f.attr == 'acquire':
                        hazards.append((n, 'acquires a lock '
                                           '(`.acquire()`)'))
                    elif f.attr in _LOGGING_METHODS \
                            and isinstance(f.value, ast.Name) \
                            and f.value.id in ('logging', 'logger',
                                               'log'):
                        hazards.append((n, 'calls logging (takes the '
                                           'logging module lock)'))
                    elif f.attr in _HEAVY_FORMATTERS:
                        if f.attr == 'dumps':
                            if isinstance(f.value, ast.Name) \
                                    and f.value.id == 'json':
                                hazards.append(
                                    (n, 'builds json.dumps output '
                                        '(allocation-heavy)'))
                        elif f.attr == 'format' and not isinstance(
                                f.value, ast.Name):
                            hazards.append(
                                (n, 'builds str.format output '
                                    '(allocation-heavy)'))
                        elif f.attr == 'join' and isinstance(
                                f.value, ast.Constant):
                            hazards.append(
                                (n, 'builds a joined string '
                                    '(allocation-heavy)'))
                    elif f.attr.startswith('format') \
                            and isinstance(f.value, ast.Name) \
                            and f.value.id == 'traceback':
                        hazards.append(
                            (n, f'calls traceback.{f.attr} '
                                f'(allocation-heavy formatting)'))
                elif isinstance(f, ast.Name):
                    if f.id == 'open':
                        hazards.append((n, 'opens a file (buffered '
                                           'IO)'))
                    elif f.id == 'print':
                        hazards.append((n, 'calls print() (buffered '
                                           'IO, takes stdout '
                                           'internals)'))
        for node, what in hazards:
            out.append(_finding(
                'CON504', Severity.ERROR, rel, node,
                f'signal handler `{handler.name}` {what} — the '
                f'interrupted thread may already hold the resource',
                detail='set a flag/Event and do the work on a thread, '
                       'or restrict the handler to pre-cached state '
                       'and lock-free writes (the watchdog '
                       '`_on_signal` -> `dump(use_locks=False)` '
                       'model)'))
    return out


def _is_lockish(expr: ast.AST, lock_names) -> bool:
    attr = _self_attr(expr)
    if attr is not None:
        return attr in lock_names
    if isinstance(expr, ast.Name):
        return expr.id in lock_names
    return False


# ---------------------------------------------------------------------------
# CON505 — unbounded shared container growth from a serving thread
# ---------------------------------------------------------------------------

def _check_unbounded_growth(model: ModuleModel, rel) -> List[Finding]:
    out = []
    for cls in model.classes:
        if not cls.entry_closure:
            continue
        seen_attr_method = set()
        for g in cls.growth:
            if g.method not in cls.entry_closure:
                continue
            capped = cls.container_attrs.get(g.attr)
            if capped is None:      # not a container built in __init__
                continue
            if capped or g.attr in cls.bounded_attrs:
                continue
            key = (g.attr, g.method)
            if key in seen_attr_method:
                continue
            seen_attr_method.add(key)
            kind, origin = cls.entry_closure[g.method]
            op = ('keyed store' if g.op == 'setitem'
                  else f'`.{g.op}()`')
            via = (f'`{cls.name}.{g.method}`' if g.method == origin
                   else f'`{cls.name}.{g.method}` (reached from '
                        f'{kind} entry `{origin}`)')
            out.append(_finding(
                'CON505', Severity.WARNING, rel, g.node,
                f'`self.{g.attr}` grows without bound ({op}) from '
                f'thread entry path {via} — no maxlen/len-check/'
                f'eviction anywhere in the class',
                detail=f'entry kind: {kind}; use deque(maxlen=...) or '
                       f'an explicit capacity check with drop '
                       f'accounting (the FlightRecorder ring / qtrace '
                       f'capacity discipline)'))
    return out


# ---------------------------------------------------------------------------
# File / tree walks
# ---------------------------------------------------------------------------

def lint_concurrency_file(path: str,
                          rel: Optional[str] = None) -> List[Finding]:
    """All concurrency rules over one ``.py`` file. ``rel`` overrides
    the location prefix used in findings (defaults to ``path``). A file
    that fails to parse is the source tier's problem (SRC100); this
    tier stays silent on it."""
    _refuse_bytecode(path)
    rel = rel or path
    with open(path, encoding='utf-8') as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return []
    model = build_module_model(tree)
    out = []
    out += _check_unlocked_rmw(model, rel)
    out += _check_lock_order(model, rel)
    out += _check_artifact_writes(tree, rel)
    out += _check_signal_handlers(model, rel)
    out += _check_unbounded_growth(model, rel)
    return disambiguate_contexts(_with_line_context(f, src) for f in out)


def lint_concurrency_tree(root: str,
                          exclude: Sequence[str] = ()) -> List[Finding]:
    """Concurrency rules over every ``.py`` under ``root``
    (recursively), reporting repo-relative locations."""
    root = os.path.abspath(root)
    base = os.path.dirname(root)
    out = []
    for path in iter_source_files(root):
        rel = os.path.relpath(path, base)
        if any(rel.startswith(e) for e in exclude):
            continue
        out.extend(lint_concurrency_file(path, rel=rel))
    return out


def lint_concurrency_paths(paths: Sequence[str]) -> List[Finding]:
    """Concurrency rules over a mix of files and directories — the
    multi-root scan the CLI runs (the package plus ``chip_smoke.py``)."""
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            out.extend(lint_concurrency_tree(p))
        else:
            out.extend(lint_concurrency_file(p, rel=os.path.basename(p)))
    return out
