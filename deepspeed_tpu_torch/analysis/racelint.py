"""The race analysis' static half: a lock-discipline lint over the port's
host-side stack — counterpart of ``deepspeed_tpu/analysis/racelint.py``.

The router tick, worker pool, watchdog, telemetry registry, the prefetch
worker and the online controller share mutable host state behind a small
set of locks plus a single-owner tick-thread convention.  Four rules:

- **unguarded-state** — infers which lock guards which attributes from the
  code's own ``with self._lock:`` pattern (an attribute *written* at least
  once under a lock is that lock's state), then flags every write or
  mutation of a guarded attribute made with no lock held.
  ``__init__`` / ``__new__`` (construction happens before publication) and
  ``*_locked`` helpers (the caller holds the lock) are exempt.
- **lock-order** — builds the acquired-while-holding graph (``with``
  nesting, plus one level of same-class calls and constructor-typed
  cross-class calls) and flags cycles; re-acquiring a non-reentrant
  ``Lock`` already held is the one-node cycle.
- **blocking-under-lock** — ``time.sleep``, device syncs (torch's
  ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.synchronize()``, and JAX's names), file / socket I/O and ``close()``
  calls made while holding a lock stall every thread behind it.
- **cross-thread-engine** — bodies reachable from a
  ``threading.Thread(target=self.m)`` must not touch engine state: the
  ``engine``, its KV pool, its captured CUDA graphs (``graphs``,
  ``replay()`` / ``capture()``) or its tick methods (``tick()``,
  ``step()``, ``_decode_burst()``, ...).  These are the port's
  counterparts of JAX's jits and are single-owner by design.

A trailing ``# lint: allow(<rule>)`` comment suppresses that line;
:data:`RACE_BASELINE` grandfathers violations and may only shrink
(``stale_race_baseline``).  ``tests/test_torch_analysis.py`` is the gate.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .astlint import PKG_ROOT, _allowed

# prefixes / files under deepspeed_tpu_torch/ the pass covers (JAX's
# scope): the concurrent host-side serving stack, the state manager whose
# placement paths run under the scheduler's intake lock, and the input
# prefetcher's worker thread
RACE_SCOPE: Tuple[str, ...] = (
    "serving/",
    "inference/scheduler.py",
    "inference/engine_v2.py",
    "inference/ragged.py",
    "telemetry/",
    "runtime/prefetch.py",
    # the online-adaptation controller thread: epoch pacing on a condition,
    # retunes through the scheduler's locked intake surface only
    "autotuning/controller.py",
)

# grandfathered violations, keyed (rule, path, key).  Shrink-only: the
# gate fails on any violation not in this set, and ``stale_race_baseline``
# on any entry that no longer fires.  Empty: the port has none.
RACE_BASELINE: Set[Tuple[str, str, str]] = set()

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
_REENTRANT_FACTORIES = {"RLock", "Semaphore", "BoundedSemaphore"}
# container mutations that count as writes to the attribute they mutate
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "clear", "update", "pop", "popleft", "popitem",
    "setdefault", "sort", "reverse",
}
# calls that block the holding thread: host<->device syncs, sleeps, and
# file/socket I/O.  ``wait`` is excluded (Condition.wait releases the lock
# by contract); ``join`` is excluded (str.join noise).
_BLOCKING_ATTR_CALLS = {
    "sleep", "block_until_ready", "device_get", "item", "tolist", "cpu", "numpy",
    "synchronize", "write", "read", "readline", "readlines", "recv", "recv_into", "send",
    "sendall", "connect", "accept", "close", "flush",
}
_BLOCKING_NAME_CALLS = {"open"}
# attribute / call markers of engine state inside a thread-target body
# (single-owner objects a worker thread must not touch): the engine, its KV
# pool and captured CUDA graphs, and its tick methods
_ENGINE_ATTR_MARKERS = {"engine", "kv", "graphs"}
_ENGINE_ATTR_SUFFIX = "_graph"
_ENGINE_CALL_MARKERS = {"tick", "step", "step_n", "generate", "prefill_entries",
                        "_decode_tick", "_spec_tick", "_decode_burst", "_burst_tick",
                        "_run_packed_prefill", "replay", "capture"}

# pseudo lock id for ``*_locked`` methods: the caller holds an unknown lock
_CALLER_LOCK = ("<caller>", "<caller>")


@dataclass(frozen=True)
class RaceViolation:
    rule: str  # unguarded-state | lock-order | blocking-under-lock | cross-thread-engine
    path: str  # repo-relative file
    line: int
    key: str  # stable id for the shrink-only baseline
    message: str

    def __str__(self) -> str:  # pytest-friendly
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.key)


@dataclass
class _MethodFacts:
    name: str
    lineno: int = 0
    # (attr, method, line, locks-held tuple) for every self.<attr> write
    writes: List[Tuple[str, int, Tuple]] = field(default_factory=list)
    # (lock id, line, locks-held-before tuple, factory kind)
    acquires: List[Tuple[Tuple, int, Tuple]] = field(default_factory=list)
    # (description, line, locks-held tuple)
    blocking: List[Tuple[str, int, Tuple]] = field(default_factory=list)
    # (callee key, line, locks-held tuple); callee key is ("self", name) or
    # (attr-name, name) for one-hop constructor-typed attributes
    calls: List[Tuple[Tuple[str, str], int, Tuple]] = field(default_factory=list)
    # every attribute name read/loaded anywhere in the body (thread pass)
    attr_loads: List[Tuple[str, int]] = field(default_factory=list)
    # every method name invoked anywhere in the body (thread pass)
    call_names: List[Tuple[str, int]] = field(default_factory=list)
    direct_locks: Set[Tuple] = field(default_factory=set)


@dataclass
class _ClassFacts:
    name: str
    path: str
    key: str = ""  # unique display id: name, or name[path] on collision
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> factory
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> class name
    methods: Dict[str, _MethodFacts] = field(default_factory=dict)
    thread_targets: List[Tuple[str, int]] = field(default_factory=list)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_factory_of(value: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' / ... when ``value`` constructs a threading
    primitive (``threading.Lock()`` or bare ``Lock()``), else None."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_FACTORIES:
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id in _LOCK_FACTORIES:
        return fn.id
    return None


class _MethodVisitor(ast.NodeVisitor):
    """Walks one method body tracking the held-lock stack."""

    def __init__(self, cls: _ClassFacts, facts: _MethodFacts):
        self.cls = cls
        self.facts = facts
        self.locks: List[Tuple] = []
        if facts.name.endswith("_locked"):
            # repo convention: the caller holds a lock for the whole body
            self.locks.append(_CALLER_LOCK)

    def _held(self) -> Tuple:
        return tuple(self.locks)

    # -- lock scopes --------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        entered = 0
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.cls.lock_attrs:
                lock_id = (self.cls.name, attr)
                self.facts.acquires.append(
                    (lock_id, item.context_expr.lineno, self._held()))
                self.facts.direct_locks.add(lock_id)
                self.locks.append(lock_id)
                entered += 1
            else:
                # non-lock context manager: still record it as a call site
                self._record_call(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(entered):
            self.locks.pop()

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    # -- writes -------------------------------------------------------------
    def _record_write_target(self, target: ast.AST, line: int) -> None:
        # self.X = / self.X[...] = / del self.X[...] all write self.X
        node = target
        while isinstance(node, ast.Subscript):
            node = node.value
        attr = _self_attr(node)
        if attr is not None and attr not in self.cls.lock_attrs:
            self.facts.writes.append((attr, line, self._held()))
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write_target(elt, line)

    # the assigned value is visited itself (JAX visits only its children,
    # so ``x = y.item()`` under a lock went unseen there)
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_write_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_write_target(t, node.lineno)

    # -- calls --------------------------------------------------------------
    def _record_call(self, node: ast.AST) -> None:
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        held = self._held()
        if isinstance(fn, ast.Attribute):
            self.facts.call_names.append((fn.attr, node.lineno))
            if fn.attr in _BLOCKING_ATTR_CALLS and held:
                self.facts.blocking.append(
                    (f".{fn.attr}()", node.lineno, held))
            # self.m() or self.obj.m() — one hop for the closure passes
            root = _self_attr(fn.value)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                # mutator on self? no — self.m() method call
                self.facts.calls.append((("self", fn.attr), node.lineno, held))
            elif root is not None:
                if fn.attr in _MUTATORS and root not in self.cls.lock_attrs:
                    # container mutation of self.<root> counts as a write
                    self.facts.writes.append((root, node.lineno, held))
                else:
                    self.facts.calls.append(
                        ((root, fn.attr), node.lineno, held))
        elif isinstance(fn, ast.Name):
            self.facts.call_names.append((fn.id, node.lineno))
            if fn.id in _BLOCKING_NAME_CALLS and held:
                self.facts.blocking.append(
                    (f"{fn.id}()", node.lineno, held))

    def visit_Call(self, node: ast.Call) -> None:
        self._record_call(node)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.facts.attr_loads.append((node.attr, node.lineno))
        self.generic_visit(node)

    # nested defs/lambdas: treat as same lock context (closures run where
    # called — conservative, but nested defs in these classes are rare)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]


def _collect_class(node: ast.ClassDef, path: str) -> _ClassFacts:
    cls = _ClassFacts(name=node.name, path=path)
    # pass 1: lock attributes + constructor-typed attributes + Thread targets
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
            attr = _self_attr(sub.targets[0])
            if attr is None:
                continue
            factory = _lock_factory_of(sub.value)
            if factory is not None:
                cls.lock_attrs[attr] = factory
            elif isinstance(sub.value, ast.Call) \
                    and isinstance(sub.value.func, ast.Name):
                cls.attr_types[attr] = sub.value.func.id
        if isinstance(sub, ast.Call):
            fn = sub.func
            is_thread = (isinstance(fn, ast.Attribute) and fn.attr == "Thread") \
                or (isinstance(fn, ast.Name) and fn.id == "Thread")
            if is_thread:
                for kw in sub.keywords:
                    if kw.arg == "target":
                        tgt = _self_attr(kw.value)
                        if tgt is not None:
                            cls.thread_targets.append((tgt, sub.lineno))
    # pass 2: per-method facts
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            facts = _MethodFacts(name=stmt.name, lineno=stmt.lineno)
            v = _MethodVisitor(cls, facts)
            for s in stmt.body:
                v.visit(s)
            cls.methods[stmt.name] = facts
    return cls


def _finalize(classes: Sequence[_ClassFacts]) -> Dict[str, List[_ClassFacts]]:
    """Assign each class a UNIQUE key (bare name, or ``name[path]`` when
    two scoped modules define same-named classes — the facts of both are
    kept and analyzed, never silently dropped) and rewrite the lock ids
    recorded at visit time to use it.  Returns the name -> classes index
    used to resolve constructor-typed cross-class calls (ambiguous names
    resolve to the UNION of candidates — conservative)."""
    by_name: Dict[str, List[_ClassFacts]] = {}
    for c in classes:
        by_name.setdefault(c.name, []).append(c)
    for name, group in by_name.items():
        for c in group:
            c.key = name if len(group) == 1 else f"{name}[{c.path}]"
    for c in classes:
        if c.key == c.name:
            continue  # no collision: visit-time ids already match

        def fix(lid, _c=c):
            return (_c.key, lid[1]) \
                if lid != _CALLER_LOCK and lid[0] == _c.name else lid

        for m in c.methods.values():
            m.direct_locks = {fix(l) for l in m.direct_locks}
            m.acquires = [(fix(l), ln, tuple(fix(h) for h in held))
                          for l, ln, held in m.acquires]
            m.writes = [(a, ln, tuple(fix(h) for h in held))
                        for a, ln, held in m.writes]
            m.blocking = [(d, ln, tuple(fix(h) for h in held))
                          for d, ln, held in m.blocking]
            m.calls = [(k, ln, tuple(fix(h) for h in held))
                       for k, ln, held in m.calls]
    return by_name


def _may_acquire(classes: Sequence[_ClassFacts],
                 by_name: Dict[str, List[_ClassFacts]],
                 ) -> Dict[Tuple[str, str], Set[Tuple]]:
    """Fixpoint: {(class key, method): set of lock ids the call may
    acquire}, through same-class ``self.m()`` calls and constructor-typed
    one-hop ``self.obj.m()`` calls."""
    acq: Dict[Tuple[str, str], Set[Tuple]] = {
        (c.key, m.name): set(m.direct_locks)
        for c in classes for m in c.methods.values()
    }
    changed = True
    while changed:
        changed = False
        for c in classes:
            for m in c.methods.values():
                mine = acq[(c.key, m.name)]
                before = len(mine)
                for (root, callee), _line, _held in m.calls:
                    if root == "self":
                        mine |= acq.get((c.key, callee), set())
                    else:
                        for tc in by_name.get(c.attr_types.get(root), ()):
                            mine |= acq.get((tc.key, callee), set())
                if len(mine) != before:
                    changed = True
    return acq


def _order_edges(classes: Sequence[_ClassFacts],
                 acq: Dict[Tuple[str, str], Set[Tuple]],
                 by_name: Dict[str, List[_ClassFacts]],
                 ) -> Dict[Tuple[Tuple, Tuple], Tuple[str, int]]:
    """{(held, acquired): (path, line)} over every class — direct ``with``
    nesting plus locks reachable through calls made under a lock."""
    edges: Dict[Tuple[Tuple, Tuple], Tuple[str, int]] = {}
    for c in classes:
        for m in c.methods.values():
            for lock_id, line, held in m.acquires:
                for h in held:
                    if h != _CALLER_LOCK:
                        edges.setdefault((h, lock_id), (c.path, line))
            for (root, callee), line, held in m.calls:
                if not held:
                    continue
                if root == "self":
                    reach = acq.get((c.key, callee), set())
                else:
                    reach = set()
                    for tc in by_name.get(c.attr_types.get(root), ()):
                        reach |= acq.get((tc.key, callee), set())
                for h in held:
                    if h == _CALLER_LOCK:
                        continue
                    for l2 in reach:
                        edges.setdefault((h, l2), (c.path, line))
    return edges


def _find_cycles(edges: Dict[Tuple[Tuple, Tuple], Tuple[str, int]],
                 reentrant: Set[Tuple]) -> List[Tuple[Tuple, ...]]:
    """Canonicalized cycles in the acquired-while-holding graph.  A
    self-edge on a non-reentrant lock is the one-node cycle."""
    graph: Dict[Tuple, Set[Tuple]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles: Set[Tuple[Tuple, ...]] = set()
    for (a, b) in edges:
        if a == b:
            if a not in reentrant:
                cycles.add((a,))
            continue
    # DFS from every node, bounded — the graphs here are tiny
    def dfs(start: Tuple, node: Tuple, path: List[Tuple]) -> None:
        for nxt in graph.get(node, ()):
            if nxt == start and len(path) > 1:
                rot = min(range(len(path)),
                          key=lambda i: path[i])  # canonical rotation
                cycles.add(tuple(path[rot:] + path[:rot]))
            elif nxt not in path and len(path) < 8:
                dfs(start, nxt, path + [nxt])

    for n in list(graph):
        dfs(n, n, [n])
    return sorted(cycles)


def _lint_classes(classes: Sequence[_ClassFacts],
                  sources: Dict[str, Sequence[str]]) -> List[RaceViolation]:
    out: List[RaceViolation] = []
    by_name = _finalize(classes)

    def emit(rule: str, path: str, line: int, key: str, msg: str) -> None:
        if not _allowed(sources.get(path, ()), line, rule):
            out.append(RaceViolation(rule, path, line, key, msg))

    # -- unguarded-state ----------------------------------------------------
    for c in classes:
        if not c.lock_attrs:
            continue
        guarded: Dict[str, Set[Tuple]] = {}
        for m in c.methods.values():
            for attr, _line, held in m.writes:
                real = {h for h in held if h != _CALLER_LOCK}
                if real or held:  # _locked methods count as guarded evidence
                    guarded.setdefault(attr, set()).update(real)
        for m in c.methods.values():
            if m.name in ("__init__", "__new__") or m.name.endswith("_locked"):
                continue
            for attr, line, held in m.writes:
                if held or attr not in guarded:
                    continue
                locks = ", ".join(sorted(
                    f"self.{a}" for _cls, a in guarded[attr])) or "a caller-held lock"
                emit(
                    "unguarded-state", c.path, line,
                    f"{c.name}.{attr}:{m.name}",
                    f"{c.name}.{m.name} writes self.{attr} with no lock "
                    f"held, but other writes guard it with {locks} — either "
                    "take the lock here or document the single-owner "
                    "contract with `# lint: allow(unguarded-state)`",
                )

    # -- blocking-under-lock ------------------------------------------------
    for c in classes:
        for m in c.methods.values():
            for desc, line, held in m.blocking:
                names = ", ".join(
                    "caller-held lock" if h == _CALLER_LOCK else f"self.{h[1]}"
                    for h in held)
                emit(
                    "blocking-under-lock", c.path, line,
                    f"{c.name}.{m.name}:{desc}",
                    f"{c.name}.{m.name} calls {desc} while holding "
                    f"{names} — every thread contending that lock stalls "
                    "behind the sleep/sync/I-O; move the blocking call "
                    "outside the critical section",
                )

    # -- lock-order ---------------------------------------------------------
    acq = _may_acquire(classes, by_name)
    edges = _order_edges(classes, acq, by_name)
    reentrant = {
        (c.key, attr) for c in classes
        for attr, kind in c.lock_attrs.items() if kind in _REENTRANT_FACTORIES
    }
    for cycle in _find_cycles(edges, reentrant):
        if len(cycle) == 1:
            path, line = edges[(cycle[0], cycle[0])]
            emit(
                "lock-order", path, line,
                f"{cycle[0][0]}.{cycle[0][1]}->self",
                f"re-acquiring non-reentrant lock self.{cycle[0][1]} "
                f"({cycle[0][0]}) while already holding it — guaranteed "
                "self-deadlock",
            )
            continue
        # report at the first edge of the canonical rotation
        a, b = cycle[0], cycle[1 % len(cycle)]
        path, line = edges.get((a, b)) or next(iter(edges.values()))
        order = " -> ".join(f"{cls}.{attr}" for cls, attr in cycle)
        key = "->".join(sorted(f"{cls}.{attr}" for cls, attr in cycle))
        emit(
            "lock-order", path, line, key,
            f"lock acquisition cycle {order} -> {cycle[0][0]}."
            f"{cycle[0][1]}: two threads taking these locks in opposite "
            "orders deadlock — pick one global order and stick to it",
        )

    # -- cross-thread-engine ------------------------------------------------
    for c in classes:
        for target, _tline in c.thread_targets:
            # closure over same-class callees reachable from the target
            seen: Set[str] = set()
            frontier = [target]
            while frontier:
                name = frontier.pop()
                if name in seen or name not in c.methods:
                    continue
                seen.add(name)
                for (root, callee), _line, _held in c.methods[name].calls:
                    if root == "self":
                        frontier.append(callee)
            for name in sorted(seen):
                m = c.methods[name]
                hits: List[Tuple[str, int]] = []
                for attr, line in m.attr_loads:
                    if attr in _ENGINE_ATTR_MARKERS \
                            or attr.endswith(_ENGINE_ATTR_SUFFIX):
                        hits.append((attr, line))
                for call, line in m.call_names:
                    if call in _ENGINE_CALL_MARKERS:
                        hits.append((f"{call}()", line))
                for marker, line in hits:
                    emit(
                        "cross-thread-engine", c.path, line,
                        f"{c.name}.{name}:{marker}",
                        f"{c.name}.{name} runs on a Thread(target="
                        f"{c.name}.{target}) and touches {marker} — "
                        "engine state (its KV pool, CUDA graphs, ticks) is single-owner; "
                        "marshal the work back to the owner thread "
                        "(queue/flag) instead of calling into them",
                    )
    return out


def lint_race_source(source: str, relpath: str) -> List[RaceViolation]:
    """Lint one module's source as repo-relative ``relpath`` — the
    seeded-regression seam (cross-class call edges resolve within the
    module only)."""
    tree = ast.parse(source)
    classes = [_collect_class(node, relpath) for node in tree.body
               if isinstance(node, ast.ClassDef)]
    return _lint_classes(classes, {relpath: source.splitlines()})


def _scoped_files(root: str, scope: Sequence[str]) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), root)
            rel = rel.replace(os.sep, "/")
            if any(rel == pat or (pat.endswith("/") and rel.startswith(pat))
                   for pat in scope):
                out.append(rel)
    return out


def lint_race_package(root: Optional[str] = None,
                      scope: Sequence[str] = RACE_SCOPE,
                      ) -> List[RaceViolation]:
    """Lint every scoped module under ``deepspeed_tpu_torch/`` (or ``root``).
    Classes are collected package-wide FIRST so constructor-typed
    cross-class call edges (``self.registry = MetricsRegistry(...)``)
    resolve across files.  Same-named classes in different scoped files
    are all kept (disambiguated keys, union call-resolution) — a name
    collision must never silently drop a class from the analysis."""
    root = root or PKG_ROOT
    classes: List[_ClassFacts] = []
    sources: Dict[str, Sequence[str]] = {}
    for rel in _scoped_files(root, scope):
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            src = fh.read()
        sources[rel] = src.splitlines()
        tree = ast.parse(src)
        classes.extend(_collect_class(node, rel) for node in tree.body
                       if isinstance(node, ast.ClassDef))
    return _lint_classes(classes, sources)


def unbaselined(violations: Sequence[RaceViolation]) -> List[RaceViolation]:
    """Violations not grandfathered in :data:`RACE_BASELINE` — the set the
    tier-1 gate requires to be empty."""
    return [v for v in violations if v.baseline_key not in RACE_BASELINE]


def stale_race_baseline(
    violations: Optional[Sequence[RaceViolation]] = None,
    root: Optional[str] = None,
) -> List[Tuple[str, str, str]]:
    """Baseline entries with no live violation — a fixed violation must
    leave the baseline with the fix (shrink-only is enforced, not hoped)."""
    if violations is None:
        violations = lint_race_package(root)
    live = {v.baseline_key for v in violations}
    return sorted(RACE_BASELINE - live)
