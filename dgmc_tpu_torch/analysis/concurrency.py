"""Static concurrency model: thread entry points, lock sets, and
per-class attribute access — the substrate the CON rules read.

The port's copy of the JAX package's
``dgmc_tpu/analysis/concurrency.py`` (pure ``ast``; the CPU tests hold
the two tiers' findings equal). The serve plane is a persistent
multithreaded process: ``ThreadingHTTPServer`` handler threads, a
shadow-audit thread, the watchdog daemon and its signal path, all
mutating Python objects the main thread also reads. The race classes
found by hand in the serving code (non-atomic ``+=`` on serve counters
from handler threads; per-class counters needing pre-seeding) become a
model ``con_rules.py`` can lint mechanically.

The model is built per module from the ``ast`` alone:

- **Thread entry points** — functions that run off the main path:
  targets of ``threading.Thread(target=...)`` / ``threading.Timer``,
  ``ThreadPoolExecutor.submit`` callables, ``do_GET``/``do_POST``-style
  HTTP handler methods (``ThreadingHTTPServer`` runs one per request
  thread), ``signal.signal`` handlers and ``atexit.register`` hooks
  (asynchronous entry on the MAIN thread — same discipline applies).
- **Per-class attribute model** — for every class: which attributes
  are lock objects (``threading.Lock/RLock/Condition/Semaphore`` in
  any method), which methods are reachable from an entry point through
  ``self.<m>()`` calls (the *entry closure*), every ``self.<attr>``
  write with the lock set lexically held at the site (``with
  self._lock:`` blocks plus linear ``.acquire()``/``.release()``
  tracking in statement order), whether the write is a read-modify-
  write (``+=`` / ``self.x = self.x + ...``), container growth calls
  (``.append``/``.add``/keyed stores) and the cap evidence that
  bounds them (``deque(maxlen=...)``, ``len()`` checks, eviction).
- **Lock-order edges** — ordered pairs ``(A, B)`` meaning lock B was
  acquired while A was held, collected lexically and one call level
  deep through ``self.<m>()``.

Known limits, by design: the
model is per-module and name-based. Dynamic dispatch (a bound method
stored in a dict and called later — the telemetry route table),
``getattr`` indirection, and cross-class call chains (the service
calling the engine) are invisible; locks passed as arguments or held
in locals are not tracked. The rules therefore under-approximate:
everything they DO flag is structurally evident in one module.
"""

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

__all__ = ['ModuleModel', 'ClassModel', 'AttrWrite', 'GrowthSite',
           'SignalHandler', 'build_module_model', 'LOCK_FACTORIES',
           'HTTP_HANDLER_METHODS']

#: ``threading`` constructors whose result is a lock in the "must be
#: held to touch shared state" sense. Condition counts: ``with
#: self._cond:`` acquires its underlying lock.
LOCK_FACTORIES = {'Lock', 'RLock', 'Condition', 'Semaphore',
                  'BoundedSemaphore'}

#: ``BaseHTTPRequestHandler`` entry methods: under
#: ``ThreadingHTTPServer`` each runs on a fresh per-request thread.
HTTP_HANDLER_METHODS = {'do_GET', 'do_POST', 'do_PUT', 'do_DELETE',
                        'do_PATCH', 'do_HEAD'}

_CONTAINER_CALLS = {'list', 'dict', 'set', 'deque', 'OrderedDict',
                    'defaultdict', 'Counter'}
_GROWTH_METHODS = {'append', 'appendleft', 'extend', 'add', 'insert',
                   'setdefault'}
_EVICT_METHODS = {'pop', 'popleft', 'popitem', 'clear', 'remove',
                  'discard'}


def _call_name(func: ast.AST) -> Optional[str]:
    """Trailing name of a call target: ``threading.Thread`` -> Thread,
    ``Thread`` -> Thread."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``attr`` when node is ``self.<attr>``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == 'self'):
        return node.attr
    return None


def _mentions_tmp(node: ast.AST) -> bool:
    """Whether a path expression names a temp file: a ``tmp`` substring
    in any identifier or string constant under it (the watchdog's
    ``f'{path}.tmp.{pid}'`` and findings.py's ``path + '.tmp'`` both
    read this way)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and 'tmp' in n.id.lower():
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and 'tmp' in n.value.lower():
            return True
        if isinstance(n, ast.Attribute) and 'tmp' in n.attr.lower():
            return True
    return False


@dataclasses.dataclass(frozen=True)
class AttrWrite:
    """One ``self.<attr>`` store site."""
    attr: str
    node: ast.AST
    method: str
    rmw: bool                    # += / self.x = self.x op ...
    locks_held: FrozenSet[str]
    in_init: bool


@dataclasses.dataclass(frozen=True)
class GrowthSite:
    """One container-growth site: ``self.<attr>.append(...)`` or
    ``self.<attr>[k] = v``."""
    attr: str
    node: ast.AST
    method: str
    op: str


@dataclasses.dataclass(frozen=True)
class SignalHandler:
    """One registered ``signal.signal`` handler (function, method, or
    lambda) with the lock names visible at its registration scope."""
    name: str
    node: ast.AST
    lock_names: FrozenSet[str]


@dataclasses.dataclass
class ClassModel:
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: method -> (entry kind, entry method) for every method reachable
    #: from a thread entry point through ``self.<m>()`` calls.
    entry_closure: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    writes: List[AttrWrite] = dataclasses.field(default_factory=list)
    growth: List[GrowthSite] = dataclasses.field(default_factory=list)
    #: container attrs assigned in __init__ -> True when capped at
    #: construction (deque(maxlen=...)).
    container_attrs: Dict[str, bool] = dataclasses.field(
        default_factory=dict)
    #: attrs with cap/eviction evidence anywhere in the class.
    bounded_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: (held, acquired) -> first site node.
    lock_edges: Dict[Tuple[str, str], ast.AST] = dataclasses.field(
        default_factory=dict)

    def writes_by_attr(self) -> Dict[str, List[AttrWrite]]:
        out: Dict[str, List[AttrWrite]] = {}
        for w in self.writes:
            out.setdefault(w.attr, []).append(w)
        return out


@dataclasses.dataclass
class ModuleModel:
    classes: List[ClassModel] = dataclasses.field(default_factory=list)
    signal_handlers: List[SignalHandler] = dataclasses.field(
        default_factory=list)
    module_locks: Set[str] = dataclasses.field(default_factory=set)


# ---------------------------------------------------------------------------
# Entry-point registration
# ---------------------------------------------------------------------------

def _entry_registrations(tree: ast.AST):
    """Yield ``(kind, handler_expr)`` for every thread/async entry
    registration in the (sub)tree: Thread/Timer targets, executor
    submissions, signal handlers, atexit hooks."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name == 'Thread':
            for kw in node.keywords:
                if kw.arg == 'target':
                    yield 'thread', kw.value
        elif name == 'Timer':
            if len(node.args) >= 2:
                yield 'timer', node.args[1]
            for kw in node.keywords:
                if kw.arg == 'function':
                    yield 'timer', kw.value
        elif name == 'submit' and node.args:
            yield 'executor', node.args[0]
        elif name == 'signal' and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == 'signal':
            if len(node.args) >= 2:
                yield 'signal', node.args[1]
        elif name == 'register' and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == 'atexit':
            if node.args:
                yield 'atexit', node.args[0]


def _lock_factory_call(value: ast.AST) -> bool:
    return (isinstance(value, ast.Call)
            and _call_name(value.func) in LOCK_FACTORIES)


def _container_init(value: ast.AST) -> Optional[bool]:
    """``True``/``False`` = container assigned, capped/uncapped;
    ``None`` = not a container constructor."""
    if isinstance(value, (ast.List, ast.Dict, ast.Set)):
        return False
    if isinstance(value, ast.Call):
        name = _call_name(value.func)
        if name in _CONTAINER_CALLS:
            if name == 'deque':
                return any(kw.arg == 'maxlen' and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None)
                    for kw in value.keywords)
            return False
    return None


# ---------------------------------------------------------------------------
# Lock-aware statement walk
# ---------------------------------------------------------------------------

class _FunctionScan:
    """One method/function body walked in statement order with the
    lexically-held lock set: ``with self._lock:`` blocks plus linear
    ``self._lock.acquire()``/``.release()`` tracking (the engine's
    explicit acquire style). Records writes, growth calls, lock-order
    edges, and ``self.<m>()`` call sites with the locks held there."""

    def __init__(self, cls: ClassModel, method: str, lock_attrs):
        self.cls = cls
        self.method = method
        self.lock_attrs = set(lock_attrs)
        self.in_init = method == '__init__'
        #: (held_locks, callee) — for the one-level interprocedural
        #: lock-order pass.
        self.calls_under: List[Tuple[FrozenSet[str], str, ast.AST]] = []
        #: locks this function acquires anywhere (with or .acquire()).
        self.acquires: Set[str] = set()

    # -- helpers -----------------------------------------------------------

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.lock_attrs:
            return attr
        return None

    def _record_stmt(self, stmt: ast.stmt, held: FrozenSet[str]):
        """Record the accesses a single (non-compound) statement makes."""
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    rmw = isinstance(stmt, ast.AugAssign) or (
                        not isinstance(stmt, ast.AugAssign)
                        and stmt.value is not None
                        and any(_self_attr(n) == attr
                                for n in ast.walk(stmt.value)))
                    self.cls.writes.append(AttrWrite(
                        attr=attr, node=stmt, method=self.method,
                        rmw=rmw, locks_held=held, in_init=self.in_init))
                elif isinstance(t, ast.Subscript):
                    base = _self_attr(t.value)
                    if base is not None and not self.in_init:
                        self.cls.growth.append(GrowthSite(
                            attr=base, node=stmt, method=self.method,
                            op='setitem'))
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                base = _self_attr(node.func.value)
                if base is not None:
                    if node.func.attr in _GROWTH_METHODS \
                            and not self.in_init:
                        self.cls.growth.append(GrowthSite(
                            attr=base, node=node, method=self.method,
                            op=node.func.attr))
                    elif node.func.attr in _EVICT_METHODS:
                        self.cls.bounded_attrs.add(base)
                # self.<m>(...) same-class call with held locks.
                if isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == 'self' \
                        and node.func.attr in self.cls.methods:
                    self.calls_under.append(
                        (held, node.func.attr, node))
            # len(self.attr) in a comparison / min / capacity check
            # counts as bound evidence for that attr.
            if isinstance(node.func, ast.Name) and node.func.id == 'len' \
                    and node.args:
                base = _self_attr(node.args[0])
                if base is not None:
                    self.cls.bounded_attrs.add(base)
        for node in ast.walk(stmt):
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    base = _self_attr(
                        t.value if isinstance(t, ast.Subscript) else t)
                    if base is not None:
                        self.cls.bounded_attrs.add(base)

    def _acquire_release_delta(self, stmt: ast.stmt,
                               held: Set[str]) -> Set[str]:
        """Apply explicit ``.acquire()``/``.release()`` calls found
        anywhere in the statement, in source order, to the running
        held-set (the engine.match acquire ... try/finally release
        idiom)."""
        events = []
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ('acquire', 'release'):
                lock = self._lock_of(node.func.value)
                if lock is not None:
                    events.append((node.lineno, node.func.attr, lock,
                                   node))
        for _, op, lock, node in sorted(events, key=lambda e: e[0]):
            if op == 'acquire':
                self.acquires.add(lock)
                for h in held:
                    if h != lock:
                        self.cls.lock_edges.setdefault((h, lock), node)
                held = held | {lock}
            else:
                held = held - {lock}
        return held

    def walk(self, body: List[ast.stmt],
             held: FrozenSet[str] = frozenset()):
        running = set(held)
        for stmt in body:
            self._record_stmt(stmt, frozenset(running))
            if isinstance(stmt, ast.With):
                new = set()
                for item in stmt.items:
                    lock = self._lock_of(item.context_expr)
                    if lock is not None:
                        self.acquires.add(lock)
                        new.add(lock)
                        for h in running:
                            if h != lock:
                                self.cls.lock_edges.setdefault(
                                    (h, lock), item.context_expr)
                self.walk(stmt.body, frozenset(running | new))
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self.walk(stmt.body, frozenset(running))
                self.walk(stmt.orelse, frozenset(running))
            elif isinstance(stmt, ast.If):
                self.walk(stmt.body, frozenset(running))
                self.walk(stmt.orelse, frozenset(running))
            elif isinstance(stmt, ast.Try):
                self.walk(stmt.body, frozenset(running))
                for h in stmt.handlers:
                    self.walk(h.body, frozenset(running))
                self.walk(stmt.orelse, frozenset(running))
                self.walk(stmt.finalbody, frozenset(running))
            # Nested defs run later, on their own; they are scanned as
            # their own methods/functions, never inline.
            running = self._acquire_release_delta(stmt, running)


def _dedupe_recorded(cls: ClassModel):
    """The compound-statement recursion records a nested simple
    statement once per enclosing level; keep the DEEPEST record (the
    one whose held-lock set includes the enclosing ``with`` blocks)."""
    best: Dict[int, AttrWrite] = {}
    for w in cls.writes:
        prev = best.get(id(w.node))
        if prev is None or len(w.locks_held) > len(prev.locks_held):
            best[id(w.node)] = w
    cls.writes = sorted(best.values(),
                        key=lambda w: getattr(w.node, 'lineno', 0))
    seen_growth: Dict[Tuple[int, str], GrowthSite] = {}
    for g in cls.growth:
        seen_growth.setdefault((id(g.node), g.op), g)
    cls.growth = sorted(seen_growth.values(),
                        key=lambda g: getattr(g.node, 'lineno', 0))


# ---------------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------------

def _resolve_entry(cls: ClassModel, handler: ast.AST) -> Optional[str]:
    """Method name when a registration target is ``self.<m>`` of this
    class, else None (lambdas and foreign callables are analyzed where
    they appear, not through the closure)."""
    attr = _self_attr(handler)
    if attr is not None and attr in cls.methods:
        return attr
    return None


def _class_model(node: ast.ClassDef) -> ClassModel:
    cls = ClassModel(name=node.name, node=node)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls.methods[item.name] = item
    # Pass 1: lock attrs + container inits (any method; __init__ is
    # where both live in practice).
    for m in cls.methods.values():
        for stmt in ast.walk(m):
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if _lock_factory_call(stmt.value):
                        cls.lock_attrs.add(attr)
                    capped = _container_init(stmt.value)
                    if capped is not None and m.name == '__init__':
                        cls.container_attrs[attr] = capped
    # Pass 2: entry points.
    entries: Dict[str, str] = {}
    for name in cls.methods:
        if name in HTTP_HANDLER_METHODS:
            entries[name] = 'http-handler'
    for m in cls.methods.values():
        for kind, handler in _entry_registrations(m):
            target = _resolve_entry(cls, handler)
            if target is not None:
                entries.setdefault(target, kind)
    # Pass 3: scan every method with lock tracking.
    scans: Dict[str, _FunctionScan] = {}
    for name, m in cls.methods.items():
        scan = _FunctionScan(cls, name, cls.lock_attrs)
        scan.walk(m.body)
        scans[name] = scan
    _dedupe_recorded(cls)
    # Pass 4: one-level interprocedural lock-order edges — a call made
    # while holding A to a method that acquires B is an (A, B) edge.
    for scan in scans.values():
        for held, callee, site in scan.calls_under:
            callee_scan = scans.get(callee)
            if callee_scan is None:
                continue
            for h in held:
                for acquired in callee_scan.acquires:
                    if acquired != h:
                        cls.lock_edges.setdefault((h, acquired), site)
    # Pass 5: entry closure — fixed point over self-calls.
    closure: Dict[str, Tuple[str, str]] = {
        m: (kind, m) for m, kind in entries.items()}
    frontier = list(closure)
    while frontier:
        cur = frontier.pop()
        kind, origin = closure[cur]
        for held, callee, _site in scans[cur].calls_under:
            if callee not in closure:
                closure[callee] = (kind, origin)
                frontier.append(callee)
    cls.entry_closure = closure
    # Rebinding a container attr outside __init__ is rotation/reset
    # evidence (the attr does not grow monotonically).
    for w in cls.writes:
        if not w.in_init and not w.rmw \
                and w.attr in cls.container_attrs:
            cls.bounded_attrs.add(w.attr)
    return cls


def build_module_model(tree: ast.Module) -> ModuleModel:
    """The whole-module concurrency model the CON rules read."""
    model = ModuleModel()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            model.classes.append(_class_model(node))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if _lock_factory_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        model.module_locks.add(t.id)
    # Signal handlers: resolved to their def (method or module
    # function) or kept as the lambda node.
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    class_locks: Set[str] = set()
    for cls in model.classes:
        class_locks |= cls.lock_attrs
    lock_names = frozenset(model.module_locks | class_locks)
    for kind, handler in _entry_registrations(tree):
        if kind != 'signal':
            continue
        if isinstance(handler, ast.Lambda):
            model.signal_handlers.append(SignalHandler(
                name='<lambda>', node=handler, lock_names=lock_names))
        elif isinstance(handler, ast.Name):
            for d in defs.get(handler.id, []):
                model.signal_handlers.append(SignalHandler(
                    name=handler.id, node=d, lock_names=lock_names))
        else:
            attr = _self_attr(handler)
            if attr is not None:
                for d in defs.get(attr, []):
                    model.signal_handlers.append(SignalHandler(
                        name=attr, node=d, lock_names=lock_names))
    return model
