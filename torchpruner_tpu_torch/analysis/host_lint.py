"""Static analysis pass 6: host-side concurrency & durability lint.
(A copy of ``torchpruner_tpu/analysis/host_lint.py``, imports renamed;
its default scan and waiver file are the port's.)

Passes 1 and 2 check plans and shardings from shapes.  The other half
of the codebase is ordinary threaded, multi-process Python: the serving
engine's background swap threads, the fleet router's health monitor,
the search driver's worker pool, the obs emitters every one of them
writes through.  The recurring bug classes there are mechanically
detectable: shared state mutated without the lock, blocking work
performed while holding a hot lock, and durable artifacts written with
a raw ``open(path, "w")`` instead of the
``resilience.manifest.atomic_write_json`` discipline.

This pass hunts exactly those, from the AST alone — pure stdlib, no
torch import, no tracing; a whole-package scan takes well under a second, so
it runs on every ``--lint`` and in CI.  Checks (stable ids, severity in
parentheses):

``host/unlocked-shared-write`` (error)
    Within a class, any attribute ever touched (read OR written) inside
    a ``with self._lock:`` block is treated as lock-guarded shared
    state: the lock exists precisely because some other thread consults
    it.  A WRITE to the same attribute anywhere else without holding a
    lock is a data race — including from a ``threading.Thread`` target
    (just another method), and including cross-object writes
    (``self.scheduler.closed = True`` from the engine races
    ``Scheduler.submit``'s locked read; receivers are matched to
    scanned classes by name).  ``__init__`` / ``__post_init__`` /
    ``__new__`` are exempt (no peer thread can hold a reference yet).
    Both plain assignment and mutating method calls
    (``self._q.append(...)``, ``self._d.update(...)``) count as writes.

``host/blocking-under-lock`` (warning)
    ``time.sleep``, subprocess spawns/waits, ``urlopen``/socket dials,
    file IO (``open``, ``os.fsync``, ``atomic_write_json``), event
    waits, and thread ``.join()`` while holding a lock: every other
    thread contending on that lock inherits the latency.  Sometimes the
    point (a journal flushed under the lock IS the durability
    contract) — that is what the waiver file is for.

``host/lock-order`` (error)
    A cycle in the per-class lock-acquisition graph (lock B taken while
    holding A in one path, A while holding B in another — including one
    level through same-class method calls) can deadlock.

``host/torn-write`` (error)
    ``open(path, "w")`` / ``json.dump`` / ``Path.write_text`` aimed at
    a durable-artifact path (journal / manifest / ledger / frontier /
    campaign / snapshot / goldens) outside
    ``resilience.manifest.atomic_write_json``: a crash mid-write leaves
    a truncated hybrid that poisons the next resume.  Append-mode
    streams (``"a"`` — the JSONL event/ledger streams, whose readers
    tolerate a torn last line) are exempt.

``host/daemon-leak`` (warning)
    A ``threading.Thread``/``Timer`` constructed with neither
    ``daemon=True`` nor any visible ``.join()``/``.daemon = True`` on
    its binding: process exit blocks on it forever.

``host/wallclock-in-digest`` (error)
    ``time.time()`` / ``random.*`` / ``uuid.uuid4`` feeding a
    digest-carrying determinism path (a function, assignment target, or
    hash call whose name mentions ``digest`` or ``trial_id``): kill -9
    → resume must reproduce identical artifacts, and wall clocks never
    reproduce.

Intentional exceptions live in a committed, reason-carrying waiver file
(``torchpruner_tpu_torch/analysis/host_lint_waivers.json`` by default).
A waiver downgrades its matches to ``info`` (still printed, never
silently gone); a waiver whose file was scanned but which matched
**nothing** is itself an error (``host/stale-waiver``) so waivers cannot
rot, and a waiver without a reason is an error (``host/bad-waiver``).

Entry points: :func:`lint_host` (library), ``runner.lint_config(...,
host=True)`` (pass 6 of ``--lint``), and the standalone ``python -m
torchpruner_tpu_torch lint-host [paths]`` (:func:`host_lint_main`) which
needs no preset so CI can scan the whole package.  The CI drill plants
a synthetic violation via ``TORCHPRUNER_LINT_PLANT=unlocked_write``
(:func:`env_plant`) — the scan must then exit 1 naming
``host/unlocked-shared-write``.
"""

from __future__ import annotations

import ast
import json
import os
import textwrap
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from torchpruner_tpu_torch.analysis.findings import Finding

# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

#: path fragments that mark a durable artifact (the resume/report/CI
#: surface) — a torn write to one of these is never acceptable
DURABLE_KEYWORDS = ("journal", "manifest", "ledger", "frontier",
                    "campaign", "snapshot", "golden")

#: mutating container-method names that count as writes to the receiver
MUTATOR_METHODS = frozenset({
    "append", "extend", "add", "insert", "remove", "discard", "pop",
    "popleft", "appendleft", "clear", "update", "setdefault",
})

#: dotted call names (exact) that block while holding a lock
_BLOCKING_EXACT = frozenset({
    "time.sleep", "sleep", "urlopen", "open", "io.open", "os.fsync",
    "socket.create_connection", "atomic_write_json",
})
#: dotted-name prefixes that block
_BLOCKING_PREFIXES = ("subprocess.", "urllib.request.", "requests.",
                      "shutil.")
#: attribute method names that block (``x.wait(...)``, ``conn.recv()``)
_BLOCKING_METHODS = frozenset({
    "wait", "getresponse", "recv", "sendall", "accept", "urlopen",
    "atomic_write_json", "fsync",
})

#: wall-clock / entropy sources that must not feed determinism paths
_WALLCLOCK_EXACT = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "uuid.uuid4",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
})
_WALLCLOCK_PREFIXES = ("random.",)

#: methods exempt from the unlocked-write check: construction happens
#: before any peer thread can hold a reference
_INIT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

_SEVERITY = {
    "host/unlocked-shared-write": "error",
    "host/blocking-under-lock": "warning",
    "host/lock-order": "error",
    "host/torn-write": "error",
    "host/daemon-leak": "warning",
    "host/wallclock-in-digest": "error",
    "host/stale-waiver": "error",
    "host/bad-waiver": "error",
}

#: the one module allowed to spell the raw write dance (it IS the
#: atomic writer)
_TORN_WRITE_EXEMPT_FILES = ("resilience/manifest.py",)

#: planted-violation sources for the CI drill (consumed via
#: :func:`env_plant` by the lint drivers only)
_PLANTS = {
    "unlocked_write": textwrap.dedent(
        """
        import threading

        class PlantedCounter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def guarded(self):
                with self._lock:
                    self.count += 1

            def racy(self):   # the planted hazard: no lock
                self.count += 1
        """
    ),
    "torn_write": textwrap.dedent(
        """
        import json

        def save(journal_path, obj):
            with open(journal_path, "w") as f:   # planted torn write
                json.dump(obj, f)
        """
    ),
}


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """``"time.sleep"`` for an Attribute chain, ``"sleep"`` for a bare
    Name, ``""`` for anything else (calls, subscripts...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _lock_key(expr: ast.AST) -> Optional[str]:
    """The lock identity a ``with`` context expression acquires, or
    None when it is not a lock.  Anything whose (attribute) name
    contains ``lock`` counts: ``self._lock``, ``self._journal_lock``,
    a module-level ``_lock``."""
    if isinstance(expr, ast.Attribute):
        if "lock" in expr.attr.lower():
            base = _dotted(expr.value) or "<expr>"
            return f"{base}.{expr.attr}"
        return None
    if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
        return expr.id
    return None


def _str_fragments(node: ast.AST) -> List[str]:
    """Every string literal, identifier, and attribute name reachable
    inside an expression — the haystack the durable-path keywords are
    matched against."""
    out: List[str] = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
        elif isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
        elif isinstance(n, ast.keyword) and n.arg:
            out.append(n.arg)
    return out


def _durable_fragment(node: ast.AST) -> Optional[str]:
    for frag in _str_fragments(node):
        low = frag.lower()
        for kw in DURABLE_KEYWORDS:
            if kw in low:
                return frag
    return None


def _self_attr_target(node: ast.AST) -> Optional[str]:
    """The attribute name a store-target writes on ``self`` (plain
    ``self.x`` or item store ``self.x[k]``)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    if isinstance(node, ast.Subscript):
        return _self_attr_target(node.value)
    return None


def _ext_write_target(node: ast.AST) -> Optional[Tuple[str, str]]:
    """``(receiver ident, attr)`` for a store THROUGH another object —
    ``self.scheduler.closed`` -> ("scheduler", "closed"),
    ``sched.closed`` -> ("sched", "closed") — or None for plain
    ``self.x`` / local-name targets."""
    if isinstance(node, ast.Subscript):
        return _ext_write_target(node.value)
    if not isinstance(node, ast.Attribute):
        return None
    base = node.value
    if isinstance(base, ast.Name) and base.id not in ("self", "cls"):
        return (base.id, node.attr)
    if isinstance(base, ast.Attribute) and \
            isinstance(base.value, ast.Name) and \
            base.value.id in ("self", "cls"):
        return (base.attr, node.attr)
    return None


# ---------------------------------------------------------------------------
# per-class / per-module accumulation
# ---------------------------------------------------------------------------


@dataclass
class _Write:
    attr: str
    func: str
    line: int
    locked: bool
    kind: str  # "assign" | "mutate"


@dataclass
class _ThreadSite:
    line: int
    func: str
    ident: Optional[str]  # binding name ("X" of self.X / local x)
    daemon: bool


@dataclass
class _Scope:
    """One lint scope: a class body, or the module's top level."""

    name: str
    writes: List[_Write] = field(default_factory=list)
    guarded_attrs: Set[str] = field(default_factory=set)
    #: attrs READ on self while holding a lock — part of the guarded
    #: invariant too (the lock exists because someone else consults it)
    read_guarded: Set[str] = field(default_factory=set)
    #: cross-object writes: (receiver ident, attr, func, line, locked,
    #: kind) for ``self.scheduler.closed = True`` / ``sched.closed = x``
    ext_writes: List[Tuple[str, str, str, int, bool, str]] = \
        field(default_factory=list)
    blocking: List[Tuple[str, str, str, int]] = field(default_factory=list)
    #: (outer lock, inner lock) -> first line observed
    edges: Dict[Tuple[str, str], int] = field(default_factory=dict)
    #: method name -> locks it acquires directly
    acquires: Dict[str, Set[str]] = field(default_factory=dict)
    #: (held locks, self-method called, line)
    calls_under_lock: List[Tuple[Tuple[str, ...], str, int]] = \
        field(default_factory=list)
    threads: List[_ThreadSite] = field(default_factory=list)
    joined_idents: Set[str] = field(default_factory=set)
    torn: List[Tuple[str, str, str, int]] = field(default_factory=list)
    wallclock: List[Tuple[str, str, str, int]] = field(default_factory=list)


class _ModuleScanner:
    """Walks one module's AST, accumulating per-scope evidence."""

    def __init__(self, tree: ast.Module, relpath: str):
        self.relpath = relpath
        self.scopes: List[_Scope] = []
        module_scope = _Scope("<module>")
        self.scopes.append(module_scope)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                scope = _Scope(node.name)
                self.scopes.append(scope)
                for item in node.body:
                    self._walk_class_item(item, scope)
            else:
                self._walk_stmt(node, module_scope, (), "<module>",
                                in_digest=False)

    # -- statement walking -------------------------------------------------

    def _walk_class_item(self, node: ast.stmt, scope: _Scope) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            digest = self._digesty(node.name)
            # the ``_locked`` suffix is the caller-holds-the-lock
            # convention (``check()`` wraps ``_check_locked()``): the
            # body executes under a lock it does not itself acquire
            held: Tuple[str, ...] = ("<held at entry>",) \
                if node.name.endswith("_locked") else ()
            for stmt in node.body:
                self._walk_stmt(stmt, scope, held, node.name,
                                in_digest=digest)
        else:
            self._walk_stmt(node, scope, (), "<class body>",
                            in_digest=False)

    @staticmethod
    def _digesty(name: str) -> bool:
        low = name.lower()
        return "digest" in low or "trial_id" in low

    def _walk_stmt(self, node: ast.stmt, scope: _Scope,
                   held: Tuple[str, ...], func: str,
                   in_digest: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def is a closure: it runs later (often on another
            # thread), NOT under the enclosing lock
            digest = in_digest or self._digesty(node.name)
            qual = node.name if func == "<module>" \
                else f"{func}.{node.name}"
            for stmt in node.body:
                self._walk_stmt(stmt, scope, (), qual, in_digest=digest)
            return
        if isinstance(node, ast.ClassDef):
            inner = _Scope(f"{scope.name}.{node.name}")
            self.scopes.append(inner)
            for item in node.body:
                self._walk_class_item(item, inner)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in node.items:
                key = _lock_key(item.context_expr)
                if key is not None:
                    for outer in new_held:
                        if outer != key:
                            scope.edges.setdefault(
                                (outer, key), node.lineno)
                    scope.acquires.setdefault(func, set()).add(key)
                    new_held.append(key)
                else:
                    self._walk_expr(item.context_expr, scope, held,
                                    func, in_digest)
            for stmt in node.body:
                self._walk_stmt(stmt, scope, tuple(new_held), func,
                                in_digest)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            digest_target = in_digest
            for t in targets:
                for leaf in self._flat_targets(t):
                    attr = _self_attr_target(leaf)
                    if attr is not None:
                        scope.writes.append(_Write(
                            attr, func, node.lineno, bool(held),
                            "assign"))
                        if held:
                            scope.guarded_attrs.add(attr)
                    else:
                        ext = _ext_write_target(leaf)
                        if ext is not None:
                            scope.ext_writes.append(
                                (ext[0], ext[1], func, node.lineno,
                                 bool(held), "assign"))
                    name = leaf.attr if isinstance(leaf, ast.Attribute) \
                        else leaf.id if isinstance(leaf, ast.Name) else ""
                    if self._digesty(name):
                        digest_target = True
                    # ``x.daemon = True`` on a thread binding
                    if isinstance(leaf, ast.Attribute) and \
                            leaf.attr == "daemon":
                        base = _self_attr_target(leaf.value)
                        if base is None:
                            base = leaf.value.id \
                                if isinstance(leaf.value, ast.Name) \
                                else None
                        if base:
                            scope.joined_idents.add(base)
            value = getattr(node, "value", None)
            if value is not None:
                bound = self._thread_binding(node)
                self._walk_expr(value, scope, held, func,
                                digest_target, thread_bound=bound)
            return
        # generic statement: walk child statements with the same lock
        # context, child expressions through the expression visitor
        for fld, child in ast.iter_fields(node):
            if isinstance(child, list):
                for c in child:
                    if isinstance(c, ast.stmt):
                        self._walk_stmt(c, scope, held, func, in_digest)
                    elif isinstance(c, ast.expr):
                        self._walk_expr(c, scope, held, func, in_digest)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child, scope, held, func, in_digest)
            elif isinstance(child, ast.expr):
                self._walk_expr(child, scope, held, func, in_digest)

    @staticmethod
    def _flat_targets(t: ast.expr) -> List[ast.expr]:
        if isinstance(t, (ast.Tuple, ast.List)):
            out = []
            for e in t.elts:
                out.extend(_ModuleScanner._flat_targets(e))
            return out
        return [t]

    @staticmethod
    def _thread_binding(node: ast.stmt) -> Optional[str]:
        """When an Assign's value is (or contains) a Thread ctor, the
        name it is bound to — ``"X"`` for ``self.X = Thread(...)`` /
        ``x = Thread(...)``."""
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            return None
        t = node.targets[0]
        attr = _self_attr_target(t)
        if attr is not None:
            return attr
        if isinstance(t, ast.Name):
            return t.id
        return None

    # -- expression walking ------------------------------------------------

    def _walk_expr(self, node: ast.expr, scope: _Scope,
                   held: Tuple[str, ...], func: str, in_digest: bool,
                   thread_bound: Optional[str] = None) -> None:
        if held and isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and \
                "lock" not in node.attr.lower():
            # an attribute CONSULTED under the lock is part of the
            # guarded invariant — unlocked writes to it race this read
            scope.read_guarded.add(node.attr)
        if isinstance(node, ast.Lambda):
            self._walk_expr(node.body, scope, (), f"{func}.<lambda>",
                            in_digest)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, scope, held, func, in_digest,
                             thread_bound)
            dig = in_digest or self._is_digest_call(node)
            for a in node.args:
                self._walk_expr(a, scope, held, func, dig)
            for kw in node.keywords:
                self._walk_expr(kw.value, scope, held, func, dig)
            self._walk_expr(node.func, scope, held, func, in_digest)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._walk_expr(child, scope, held, func, in_digest)
            elif isinstance(child, ast.stmt):  # pragma: no cover
                self._walk_stmt(child, scope, held, func, in_digest)

    @staticmethod
    def _is_digest_call(node: ast.Call) -> bool:
        name = _dotted(node.func)
        low = name.lower()
        return "digest" in low or "sha" in low or "hash" in low or \
            "md5" in low or "blake" in low

    def _visit_call(self, node: ast.Call, scope: _Scope,
                    held: Tuple[str, ...], func: str, in_digest: bool,
                    thread_bound: Optional[str]) -> None:
        name = _dotted(node.func)
        line = node.lineno

        # thread construction (daemon-leak bookkeeping)
        if name in ("threading.Thread", "Thread", "threading.Timer",
                    "Timer"):
            daemon = any(
                kw.arg == "daemon" and
                isinstance(kw.value, ast.Constant) and
                bool(kw.value.value)
                for kw in node.keywords
            )
            scope.threads.append(
                _ThreadSite(line, func, thread_bound, daemon))

        # ``x.join()`` — thread join (str.join takes exactly one
        # iterable positional; a thread join takes none, or a numeric /
        # ``timeout=`` argument)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join":
            timeout_kw = any(kw.arg == "timeout" for kw in node.keywords)
            numeric = (
                len(node.args) == 1
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, (int, float))
            )
            if not node.args and not node.keywords or timeout_kw \
                    or numeric:
                base = _self_attr_target(node.func.value)
                if base is None and isinstance(node.func.value, ast.Name):
                    base = node.func.value.id
                if base:
                    scope.joined_idents.add(base)
                if held:
                    scope.blocking.append(
                        (held[-1], f"{base or '?'}.join()", func, line))

        # mutating container methods on self attributes are writes
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            attr = _self_attr_target(node.func.value)
            if attr is not None:
                scope.writes.append(
                    _Write(attr, func, line, bool(held), "mutate"))
                if held:
                    scope.guarded_attrs.add(attr)
            else:
                ext = _ext_write_target(node.func.value)
                if ext is not None:
                    scope.ext_writes.append(
                        (ext[0], ext[1], func, line, bool(held),
                         "mutate"))

        # blocking work under a lock
        if held:
            blocking = (
                name in _BLOCKING_EXACT
                or name.startswith(_BLOCKING_PREFIXES)
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _BLOCKING_METHODS)
            )
            if blocking:
                scope.blocking.append((held[-1], name or
                                       f".{node.func.attr}(...)",
                                       func, line))

        # same-class method call while holding a lock (one-level
        # lock-order closure)
        if held and isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "self":
            scope.calls_under_lock.append((held, node.func.attr, line))

        # torn durable writes
        self._check_torn(node, name, scope, func, line)

        # wall clock / entropy feeding a determinism path
        wallclock = name in _WALLCLOCK_EXACT or \
            name.startswith(_WALLCLOCK_PREFIXES)
        if wallclock and (in_digest or self._digesty(func)):
            scope.wallclock.append((name, func, "", line))

    def _check_torn(self, node: ast.Call, name: str, scope: _Scope,
                    func: str, line: int) -> None:
        if name in ("open", "io.open"):
            mode = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if not (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and "w" in mode.value):
                return
            if not node.args:
                return
            frag = _durable_fragment(node.args[0])
            if frag:
                scope.torn.append(
                    (f"open(..., {mode.value!r})", frag, func, line))
        elif name in ("json.dump",) or name.endswith(".dump"):
            frag = _durable_fragment(node)
            if frag and (name == "json.dump" or name == "dump"):
                scope.torn.append(("json.dump", frag, func, line))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("write_text", "write_bytes"):
            frag = _durable_fragment(node.func.value)
            if frag:
                scope.torn.append(
                    (f".{node.func.attr}()", frag, func, line))


# ---------------------------------------------------------------------------
# findings from scopes
# ---------------------------------------------------------------------------


def _cycle_of(edges: Dict[Tuple[str, str], int]) -> Optional[List[str]]:
    """One lock-order cycle (as a node list) if the digraph has any."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(graph[n]):
            if color[m] == GRAY:
                return stack[stack.index(m):] + [m]
            if color[m] == WHITE:
                cyc = dfs(m)
                if cyc is not None:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(graph):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc is not None:
                return cyc
    return None


def _scope_findings(scope: _Scope, relpath: str) -> List[Finding]:
    out: List[Finding] = []

    def emit(check: str, line: int, where: str, message: str) -> None:
        out.append(Finding(
            _SEVERITY[check], "host", check,
            f"{relpath}:{line} {where}", message,
        ))

    # unlocked writes to lock-guarded attributes
    guarded = scope.guarded_attrs | scope.read_guarded
    for w in scope.writes:
        if w.locked or w.attr not in guarded:
            continue
        if w.func.split(".")[0] in _INIT_METHODS:
            continue
        verb = "mutated" if w.kind == "mutate" else "written"
        emit("host/unlocked-shared-write", w.line,
             f"{scope.name}.{w.func}",
             f"self.{w.attr} is lock-guarded elsewhere in "
             f"{scope.name} but {verb} here without the lock — a "
             f"peer thread can interleave mid-update")

    # blocking work under a lock
    for lock, what, func, line in scope.blocking:
        emit("host/blocking-under-lock", line, f"{scope.name}.{func}",
             f"{what} while holding {lock} — every thread contending "
             f"on the lock inherits this latency")

    # lock-order cycles (direct nesting + one level through same-class
    # method calls)
    edges = dict(scope.edges)
    for held, method, line in scope.calls_under_lock:
        for inner in scope.acquires.get(method, ()):
            for outer in held:
                if outer != inner:
                    edges.setdefault((outer, inner), line)
    cyc = _cycle_of(edges)
    if cyc is not None:
        line = min(edges[(a, b)] for (a, b) in edges
                   if a in cyc and b in cyc)
        emit("host/lock-order", line, scope.name,
             "lock-acquisition cycle " + " -> ".join(cyc) +
             " — two threads entering from opposite ends deadlock")

    # torn durable writes
    for what, frag, func, line in scope.torn:
        emit("host/torn-write", line, f"{scope.name}.{func}",
             f"{what} targets durable artifact path ({frag!r}) without "
             f"resilience.manifest.atomic_write_json — a crash "
             f"mid-write leaves a truncated file that poisons the next "
             f"resume")

    # daemon leaks
    for t in scope.threads:
        if t.daemon:
            continue
        if t.ident and t.ident in scope.joined_idents:
            continue
        bound = f"bound to {t.ident!r}" if t.ident else "unbound"
        emit("host/daemon-leak", t.line, f"{scope.name}.{t.func}",
             f"thread {bound} has neither daemon=True nor a visible "
             f".join()/.daemon on its shutdown path — process exit can "
             f"hang on it")

    # wall clock in digests
    for name, func, _, line in scope.wallclock:
        emit("host/wallclock-in-digest", line, f"{scope.name}.{func}",
             f"{name}() feeds a digest-carrying determinism path — "
             f"kill -9 -> resume cannot reproduce the artifact")

    return out


def _cross_findings(
        scopes: List[Tuple[_Scope, str]]) -> List[Finding]:
    """Cross-object unlocked writes: a write THROUGH a receiver whose
    name matches a scanned class (``self.scheduler.closed = True`` vs
    class ``Scheduler``) to an attribute that class guards under its
    lock.  The receiver-to-class match is by identifier (stripped of
    leading underscores, substring either way, >= 4 chars) — the same
    name discipline the codebase already follows."""
    guarded_by_class: Dict[str, Set[str]] = {}
    for scope, _rel in scopes:
        if scope.name.startswith("<"):
            continue
        g = scope.guarded_attrs | scope.read_guarded
        if g:
            guarded_by_class.setdefault(scope.name, set()).update(g)
    out: List[Finding] = []
    for scope, rel in scopes:
        for recv, attr, func, line, locked, kind in scope.ext_writes:
            if locked:
                continue
            if func.split(".")[0] in _INIT_METHODS:
                continue
            rname = recv.lstrip("_").lower()
            if len(rname) < 4:
                continue
            for cname in sorted(guarded_by_class):
                cl = cname.lower()
                if attr in guarded_by_class[cname] and \
                        (rname in cl or cl in rname):
                    verb = "mutated" if kind == "mutate" else "written"
                    out.append(Finding(
                        _SEVERITY["host/unlocked-shared-write"],
                        "host", "host/unlocked-shared-write",
                        f"{rel}:{line} {scope.name}.{func}",
                        f"{recv}.{attr} is lock-guarded inside class "
                        f"{cname} but {verb} here without that lock — "
                        f"this cross-object write races every locked "
                        f"reader",
                    ))
                    break
    return out


# ---------------------------------------------------------------------------
# scanning
# ---------------------------------------------------------------------------


def _scan_module(
        src: str, relpath: str,
) -> Tuple[List[Tuple[_Scope, str]], List[Finding]]:
    """``(scopes, per-module findings)`` for one module's source; the
    scopes feed the whole-scan cross-object phase."""
    for exempt in _TORN_WRITE_EXEMPT_FILES:
        if relpath.replace(os.sep, "/").endswith(exempt):
            return [], []
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:  # pragma: no cover - committed tree parses
        return [], [Finding("warning", "host", "host/unparsable",
                            f"{relpath}:{e.lineno or 0}",
                            f"could not parse: {e.msg}")]
    scanner = _ModuleScanner(tree, relpath)
    findings: List[Finding] = []
    for scope in scanner.scopes:
        findings += _scope_findings(scope, relpath)
    return [(s, relpath) for s in scanner.scopes], findings


def scan_source(src: str, relpath: str) -> List[Finding]:
    """All pass-6 findings for one module's source text (cross-object
    matching restricted to classes within the module)."""
    scopes, findings = _scan_module(src, relpath)
    return findings + _cross_findings(scopes)


def env_plant() -> Optional[str]:
    """The CI drill's planted-hazard env — read ONLY by the lint
    drivers, never by a training or serving run."""
    return os.environ.get("TORCHPRUNER_LINT_PLANT")


def _package_root() -> str:
    import torchpruner_tpu_torch

    return os.path.dirname(os.path.abspath(torchpruner_tpu_torch.__file__))


def host_lint_default_paths() -> Tuple[str, ...]:
    """The host-side serving-plane directories pass 6 scans by default
    (``fleet/``, ``serve/``, ``search/``, ``obs/``, ``resilience/``) —
    exported so callers (runner, CI, tests) never hardcode the package
    root.  Pass explicit paths (e.g. the whole package) to
    :func:`lint_host` / ``lint-host`` to scan more."""
    root = _package_root()
    return tuple(
        os.path.join(root, d)
        for d in ("fleet", "serve", "search", "obs", "resilience")
    )


def default_waivers_path() -> str:
    """``analysis/host_lint_waivers.json`` inside the port's package (the
    committed, reason-carrying exception list)."""
    return os.path.join(_package_root(), "analysis",
                        "host_lint_waivers.json")


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            files.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(dirpath, fn))
    # stable order, no duplicates
    seen: Set[str] = set()
    out = []
    for f in sorted(files):
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def _relpath(path: str) -> str:
    """Package-anchored display path (``torchpruner_tpu_torch/fleet/...``) so
    findings and waivers are stable across checkouts."""
    path = os.path.abspath(path)
    repo = os.path.dirname(_package_root())
    if path.startswith(repo + os.sep):
        return os.path.relpath(path, repo).replace(os.sep, "/")
    return path.replace(os.sep, "/")


# -- waivers -----------------------------------------------------------------


@dataclass
class Waiver:
    check: str
    file: str
    reason: str
    match: str = ""
    hits: int = 0

    def matches(self, f: Finding) -> bool:
        if f.check != self.check:
            return False
        if self.file and self.file not in f.path:
            return False
        if self.match and self.match not in f.path and \
                self.match not in f.message:
            return False
        return True


def load_waivers(path: str) -> Tuple[List[Waiver], List[Finding]]:
    """``(waivers, findings)`` — malformed entries become
    ``host/bad-waiver`` errors instead of silently vanishing."""
    if not os.path.exists(path):
        return [], []
    with open(path) as f:
        raw = json.load(f)
    entries = raw.get("waivers", raw) if isinstance(raw, dict) else raw
    waivers: List[Waiver] = []
    findings: List[Finding] = []
    for i, e in enumerate(entries):
        check = (e or {}).get("check", "")
        file = (e or {}).get("file", "")
        reason = (e or {}).get("reason", "")
        if not check or not file or not str(reason).strip():
            findings.append(Finding(
                "error", "host", "host/bad-waiver",
                f"{_relpath(path)}[{i}]",
                "waiver entries need non-empty 'check', 'file', and "
                "'reason' fields — an exception without a reason is "
                "not an exception, it is rot",
            ))
            continue
        waivers.append(Waiver(check, file,
                              str(reason).strip(), (e or {}).get(
                                  "match", "")))
    return waivers, findings


def apply_waivers(findings: List[Finding], waivers: List[Waiver],
                  scanned_files: Sequence[str]) -> List[Finding]:
    """Waived findings degrade to ``info`` (annotated with the reason,
    never silently dropped); a waiver whose file WAS scanned but which
    matched nothing becomes a ``host/stale-waiver`` error so the file
    cannot rot."""
    import dataclasses as _dc

    out: List[Finding] = []
    for f in findings:
        waived = None
        for w in waivers:
            if w.matches(f):
                w.hits += 1
                waived = w
                break
        if waived is None:
            out.append(f)
        else:
            out.append(_dc.replace(
                f, severity="info",
                message=f"waived ({waived.reason}): {f.message}"))
    scanned_rel = [_relpath(p) for p in scanned_files]
    for w in waivers:
        if w.hits:
            continue
        covered = any(w.file in rel for rel in scanned_rel)
        if covered:
            out.append(Finding(
                "error", "host", "host/stale-waiver", w.file,
                f"waiver for {w.check} matched no finding — the code "
                f"it excused is gone or fixed; delete the entry "
                f"(reason was: {w.reason})",
            ))
    return out


# -- entry points ------------------------------------------------------------


_scan_cache: Dict[Tuple, Tuple[float, List[Finding], List[str]]] = {}


def lint_host(paths: Optional[Sequence[str]] = None, *,
              waivers_path: Optional[str] = None,
              plant: Optional[str] = None) -> List[Finding]:
    """Pass 6 over ``paths`` (default: :func:`host_lint_default_paths`),
    waivers applied, planted-violation drill honored.  Results are
    cached per (paths, waivers, plant) keyed on file mtimes — the
    preset sweep lints many configs against one unchanged tree."""
    paths = tuple(paths) if paths else host_lint_default_paths()
    wpath = waivers_path if waivers_path is not None \
        else default_waivers_path()
    files = _iter_py_files(paths)
    stamp = max(
        (os.path.getmtime(f) for f in files
         if os.path.exists(f)), default=0.0)
    if os.path.exists(wpath):
        stamp = max(stamp, os.path.getmtime(wpath))
    key = (paths, wpath, plant, len(files))
    cached = _scan_cache.get(key)
    if cached is not None and cached[0] == stamp:
        return list(cached[1])

    findings: List[Finding] = []
    all_scopes: List[Tuple[_Scope, str]] = []
    for f in files:
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
        except OSError:
            continue
        scopes, fs = _scan_module(src, _relpath(f))
        all_scopes += scopes
        findings += fs
    findings += _cross_findings(all_scopes)
    if plant:
        # the TORCHPRUNER_LINT_PLANT namespace is shared with the JAX
        # package's collective drill — a plant this pass doesn't own is
        # someone else's drill, not an error
        src = _PLANTS.get(plant)
        if src is not None:
            findings += scan_source(src, f"<planted:{plant}>")
    waivers, wfindings = load_waivers(wpath)
    findings = apply_waivers(findings, waivers, files) + wfindings
    _scan_cache[key] = (stamp, list(findings), files)
    return findings


def record_gauges(findings: Iterable[Finding]) -> None:
    """``host_lint_findings_total`` (+ an error-count twin) into the
    active obs session so report.json carries the scan and ``obs
    diff`` can gate it (``host_lint_`` rides the dynamic prefixes)."""
    from torchpruner_tpu_torch import obs

    if obs.get() is None:
        return
    fs = list(findings)
    obs.gauge_set("host_lint_findings_total", len(fs),
                  help="host-side concurrency/durability lint findings")
    obs.gauge_set("host_lint_errors_total",
                  sum(1 for f in fs if f.severity == "error"),
                  help="error-severity host lint findings")


def host_lint_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m torchpruner_tpu_torch lint-host [paths...]`` — the
    standalone entry that needs no preset, so CI can scan the whole
    package.  Exits 1 on error-severity findings (after waivers)."""
    import argparse

    from torchpruner_tpu_torch.analysis.findings import merge_reports

    p = argparse.ArgumentParser(
        prog="torchpruner_tpu_torch lint-host",
        description="lint pass 6: host-side concurrency & "
                    "durability lint (AST-only, no torch) — races, "
                    "blocking-under-lock, lock-order cycles, torn "
                    "durable writes, daemon leaks, wall clocks in "
                    "digests",
    )
    p.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: the serving-plane "
             "dirs fleet/ serve/ search/ obs/ resilience/)")
    p.add_argument(
        "--waivers", metavar="PATH", default=None,
        help="waiver file (default the package's "
             "analysis/host_lint_waivers.json); "
             "entries carry check/file/reason and downgrade matches "
             "to info — a waiver matching nothing is an error")
    p.add_argument(
        "--json", metavar="PATH", default=None,
        help="additionally write the findings as JSON (atomic) — the "
             "CI artifact")
    args = p.parse_args(list(argv) if argv is not None else None)

    findings = lint_host(args.paths or None,
                         waivers_path=args.waivers,
                         plant=env_plant())
    name = "host (" + (", ".join(args.paths) if args.paths
                       else "serving plane") + ")"
    report = merge_reports(name, findings)
    print(report.format())
    if args.json:
        from torchpruner_tpu_torch.resilience.manifest import atomic_write_json

        atomic_write_json(args.json, {
            "findings": [vars(f) for f in report.findings],
            "errors": len(report.errors),
            "warnings": len(report.warnings),
        })
    record_gauges(report.findings)
    return 0 if report.ok else 1
