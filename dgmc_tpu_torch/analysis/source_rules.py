"""Source-tier lints: ``ast`` passes over the port's source.

The port's counterpart of the JAX package's
``dgmc_tpu/analysis/source_rules.py``: the same rule ids, finding
records and fingerprints, with *captured code* in the place of jitted
code. A compiled step (:mod:`~dgmc_tpu_torch.train.compiled`) runs its
function once per input signature under a CUDA graph capture and then
replays the graph: whatever the function does on the host happens at
capture time only, and whatever it reads from the device on the host
breaks the capture. Captured code is

- the body of the def that is the first argument of ``compiled(...)``
  or ``Compiled(...)`` in the same module: a name, ``self.<method>``, a
  conditional expression of those, or a lambda whose body calls one
  (the lambda's own body counts too);
- the body of a ``with torch.cuda.graph(...)`` block.

Defs are matched by name within the module, as the JAX tier matches
``jax.jit(f)``'s ``f``.

``SRC101`` captured-store
    Captured code stores into ``self.<attr>`` or a declared module
    global. A stored tensor is a static buffer that the next replay
    overwrites; any other value is set once, at capture, and never
    again.
``SRC102`` host-sync-in-capture
    ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()``,
    ``float(x)`` / ``int(x)`` / ``bool(x)`` on a non-constant,
    ``np.asarray(x)`` / ``np.array(x)``, or a ``.synchronize()``
    (``torch.cuda.synchronize()``, a stream's, an event's) inside
    captured code. Each reads the device from the host: under the
    capture's ``set_sync_debug_mode('error')`` it raises
    (:func:`~dgmc_tpu_torch.train.compiled.sync_errors`), and only on the
    branch that the warm-up reaches; statically it is flagged on every
    branch.
``SRC103`` capture-in-loop
    ``compiled(...)``, ``Compiled(...)`` or ``torch.cuda.CUDAGraph()``
    built inside a loop body: every iteration throws away the records
    (graphs, static buffers, private memory pools) the previous one
    captured.
``SRC104`` unhashable-static-arg
    Kept for the rule id only: it never fires on the port, since
    ``compiled`` takes no static argument (a Python int input becomes a
    device tensor; anything else is a tensor, a ``Fixed`` input keyed by
    identity, or ``None``). ``--explain SRC104`` says so.

The scanner refuses bytecode: ``__pycache__`` directories are never
descended into, and pointing it at a ``.pyc`` (or anything inside
``__pycache__``) raises rather than silently analyzing stale bytecode.
The kernels' build directory ``_build`` is skipped too.
"""

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              disambiguate_contexts)

__all__ = ['captured_regions', 'iter_source_files', 'lint_source_file',
           'lint_source_paths', 'lint_source_tree']

_CAPTURE_FACTORIES = {'compiled', 'Compiled'}
_NP_MODULES = {'np', 'numpy', 'onp'}
_CONCRETIZERS = {'float', 'int', 'bool'}
_HOST_READS = {'item', 'tolist', 'cpu', 'numpy'}
_SKIP_DIRS = {'__pycache__', '.git', '.pytest_cache', '.hypothesis',
              'build', 'dist', '_build'}


def _call_name(func: ast.AST) -> Optional[str]:
    """Trailing name of a call target: ``m.compiled`` -> compiled."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_cuda(node: ast.AST) -> bool:
    """``torch.cuda`` or a bare ``cuda``."""
    return ((isinstance(node, ast.Attribute) and node.attr == 'cuda')
            or (isinstance(node, ast.Name) and node.id == 'cuda'))


def _is_capture_factory(call: ast.Call) -> bool:
    return _call_name(call.func) in _CAPTURE_FACTORIES


def _is_graph_ctor(call: ast.Call) -> bool:
    """``torch.cuda.CUDAGraph()`` (or ``CUDAGraph()``)."""
    return _call_name(call.func) == 'CUDAGraph'


def _is_graph_block(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` as a ``with`` item."""
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == 'graph' and _is_cuda(expr.func.value))


@dataclasses.dataclass(frozen=True)
class Region:
    """One stretch of captured code: ``name`` names it in messages,
    ``nodes`` are the roots its checks walk."""
    name: str
    nodes: Tuple[ast.AST, ...]


def _callable_names(expr: ast.AST) -> Iterator[str]:
    """The def names a capture factory's first argument resolves to."""
    if isinstance(expr, ast.Name):
        yield expr.id
    elif (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
          and expr.value.id == 'self'):
        yield expr.attr
    elif isinstance(expr, ast.IfExp):
        yield from _callable_names(expr.body)
        yield from _callable_names(expr.orelse)
    elif isinstance(expr, ast.Lambda):
        for node in ast.walk(expr.body):
            if isinstance(node, ast.Call):
                yield from _callable_names(node.func)


def captured_regions(tree: ast.Module) -> List[Region]:
    """Every stretch of captured code in a module (see the module
    docstring), each def once, in source order."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    regions: Dict[int, Region] = {}

    class Visitor(ast.NodeVisitor):
        def __init__(self):
            self.scope = ['<module>']

        def visit_FunctionDef(self, node):
            self.scope.append(node.name)
            self.generic_visit(node)
            self.scope.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            if _is_capture_factory(node) and node.args:
                first = node.args[0]
                if isinstance(first, ast.Lambda):
                    regions.setdefault(id(first), Region(
                        '<lambda>', (first.body,)))
                for name in _callable_names(first):
                    for d in defs.get(name, []):
                        regions.setdefault(id(d), Region(d.name, (d,)))
            self.generic_visit(node)

        def visit_With(self, node):
            if any(_is_graph_block(i.context_expr) for i in node.items):
                regions.setdefault(id(node), Region(
                    f'{self.scope[-1]} (torch.cuda.graph block)',
                    tuple(node.body)))
            self.generic_visit(node)

    Visitor().visit(tree)
    return sorted(regions.values(),
                  key=lambda r: getattr(r.nodes[0], 'lineno', 0))


def _walk(region: Region):
    for root in region.nodes:
        yield from ast.walk(root)


def _finding(rule, severity, rel, node, message, detail=None) -> Finding:
    return Finding(rule=rule, severity=severity,
                   where=f'{rel}:{getattr(node, "lineno", 0)}',
                   message=message, detail=detail)


def _check_captured_stores(regions, rel) -> List[Finding]:
    out = []
    for region in regions:
        globals_declared = set()
        for node in _walk(region):
            if isinstance(node, ast.Global):
                globals_declared.update(node.names)
        for node in _walk(region):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == 'self'):
                    out.append(_finding(
                        'SRC101', Severity.ERROR, rel, node,
                        f'captured `{region.name}` stores on '
                        f'`self.{t.attr}` — a stored tensor is a static '
                        f'buffer the next replay overwrites'))
                elif isinstance(t, ast.Name) and t.id in globals_declared:
                    out.append(_finding(
                        'SRC101', Severity.ERROR, rel, node,
                        f'captured `{region.name}` assigns module global '
                        f'`{t.id}` — set once at capture, never by a '
                        f'replay'))
    return out


def _check_host_syncs(regions, rel) -> List[Finding]:
    out = []
    for region in regions:
        for node in _walk(region):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            what = None
            if (isinstance(f, ast.Name) and f.id in _CONCRETIZERS
                    and node.args
                    and not isinstance(node.args[0], ast.Constant)):
                what = f'`{f.id}(...)` on a non-constant'
            elif isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
                what = f'`.{f.attr}()`'
            elif (isinstance(f, ast.Attribute)
                  and f.attr in ('asarray', 'array')
                  and isinstance(f.value, ast.Name)
                  and f.value.id in _NP_MODULES):
                what = f'`{f.value.id}.{f.attr}(...)`'
            elif isinstance(f, ast.Attribute) and f.attr == 'synchronize':
                what = '`.synchronize()`'
            if what is not None:
                out.append(_finding(
                    'SRC102', Severity.WARNING, rel, node,
                    f'{what} inside captured `{region.name}` — reads the '
                    f'device from the host (the capture raises)'))
    return out


def _check_capture_in_loop(tree, rel) -> List[Finding]:
    out = []

    class LoopVisitor(ast.NodeVisitor):
        def __init__(self):
            self.loop_depth = 0

        def _loop(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        visit_For = visit_While = visit_AsyncFor = _loop

        def visit_FunctionDef(self, node):
            # A def inside a loop resets loop context for its own body
            # (the function runs later, not per-iteration).
            depth, self.loop_depth = self.loop_depth, 0
            self.generic_visit(node)
            self.loop_depth = depth

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            if self.loop_depth and (_is_capture_factory(node)
                                    or _is_graph_ctor(node)):
                out.append(_finding(
                    'SRC103', Severity.WARNING, rel, node,
                    f'`{_call_name(node.func)}(...)` built inside a loop '
                    f'— a fresh record set (graphs, static buffers, '
                    f'memory pools) per iteration'))
            self.generic_visit(node)

    LoopVisitor().visit(tree)
    return out


# ---------------------------------------------------------------------------
# File / tree walks
# ---------------------------------------------------------------------------


def _refuse_bytecode(path: str):
    norm = os.path.normpath(path)
    if norm.endswith(('.pyc', '.pyo')) or '__pycache__' in norm.split(os.sep):
        raise ValueError(
            f'{path}: refusing to scan bytecode — the source tier lints '
            f'.py sources only (and never descends into __pycache__)')


def lint_source_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    """All source rules over one ``.py`` file. ``rel`` overrides the
    location prefix used in findings (defaults to ``path``)."""
    _refuse_bytecode(path)
    rel = rel or path
    with open(path, encoding='utf-8') as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rule='SRC100', severity=Severity.ERROR,
                        where=f'{rel}:{e.lineno or 0}',
                        message=f'syntax error: {e.msg}')]
    regions = captured_regions(tree)
    out = []
    out += _check_captured_stores(regions, rel)
    out += _check_host_syncs(regions, rel)
    out += _check_capture_in_loop(tree, rel)
    return disambiguate_contexts(_with_line_context(f, src) for f in out)


def _with_line_context(finding: Finding, src: str) -> Finding:
    """Attach the flagged line's stripped text as the finding's
    ``context`` — the line-number-independent fingerprint discriminator
    (findings.py): an edit above the line relocates the finding without
    churning the baseline, while a change to the flagged statement
    itself releases the suppression."""
    try:
        lineno = int(finding.where.rsplit(':', 1)[1])
    except (IndexError, ValueError):
        return finding
    lines = src.splitlines()
    if not 1 <= lineno <= len(lines):
        return finding
    text = lines[lineno - 1].strip()
    if not text:
        return finding
    return dataclasses.replace(finding, context=text)


def iter_source_files(root: str) -> Iterator[str]:
    """``.py`` files under ``root``, never entering bytecode, cache or
    build dirs."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith('.py'):
                yield os.path.join(dirpath, fn)


def lint_source_tree(root: str,
                     exclude: Sequence[str] = ()) -> List[Finding]:
    """Source rules over every ``.py`` under ``root`` (recursively),
    reporting repo-relative locations."""
    root = os.path.abspath(root)
    base = os.path.dirname(root)
    out = []
    for path in iter_source_files(root):
        rel = os.path.relpath(path, base)
        if any(rel.startswith(e) for e in exclude):
            continue
        out.extend(lint_source_file(path, rel=rel))
    return out


def lint_source_paths(paths: Sequence[str]) -> List[Finding]:
    """Source rules over a mix of files and directories — the
    multi-root scan the CLI runs (the package plus ``chip_smoke.py``).
    A bare file reports under its basename; a directory reports as
    :func:`lint_source_tree` does."""
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            out.extend(lint_source_tree(p))
        else:
            out.extend(lint_source_file(p, rel=os.path.basename(p)))
    return out
