"""Engine 2: lock-acquisition-graph self-check (HVD101–HVD103).

Counterpart: ``horovod_tpu/analysis/lock_order.py``, run over the port.
A lightweight static race detector for the port's own threaded modules
(``ops/engine.py``, ``ops/controller.py``, ``optim/overlap.py``'s
dispatch, ``elastic/driver.py`` and ``worker.py``, ``serving/plane.py``,
``stall.py``, the metrics, health and time-series threads, ...).  It recognizes lock attributes from
``self.X = threading.Lock()/RLock()/Condition(...)`` assignments, walks
every method tracking the held-lock set through ``with self.X:`` blocks
and ``acquire()``/``release()`` pairs, propagates acquisitions through
one intra-class call fixpoint, and flags:

* **HVD101** — two locks acquired in opposite orders somewhere in the
  class (a cycle in the acquisition-order graph);
* **HVD102** — ``cv.wait()`` while holding a lock other than the
  condition's own (wait() releases only its own lock, so the notifier
  can never run);
* **HVD103** — re-acquiring a non-reentrant ``threading.Lock`` already
  held on the same path.

``threading.Condition(self._lock)`` aliases the condition to its
underlying lock, so ``with self._cv:`` and ``with self._lock:`` are the
same acquisition — nesting them is HVD103 only when the lock is a plain
``Lock``... which is exactly the real-world bug this catches.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .report import Finding


@dataclasses.dataclass
class _LockDef:
    name: str                 # attribute name, e.g. "_lock"
    kind: str                 # "lock" | "rlock" | "condition"
    underlying: str           # the lock actually acquired (Condition alias)
    line: int = 0


@dataclasses.dataclass
class _MethodSummary:
    name: str
    # (held frozenset of lock names, acquired lock name, line)
    acquisitions: List[Tuple[frozenset, str, int]] = \
        dataclasses.field(default_factory=list)
    # (held frozenset, callee method name, line)
    calls: List[Tuple[frozenset, str, int]] = \
        dataclasses.field(default_factory=list)
    # (held frozenset, condition attr name, line)
    waits: List[Tuple[frozenset, str, int]] = \
        dataclasses.field(default_factory=list)


def _lock_ctor(node: ast.expr) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, condition's-underlying-attr) for threading lock constructors."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else None
    if name == "Lock":
        return ("lock", None)
    if name == "RLock":
        return ("rlock", None)
    if name == "Condition":
        under = None
        if node.args and isinstance(node.args[0], ast.Attribute):
            under = node.args[0].attr
        return ("condition", under)
    return None


def _self_attr(node: ast.expr) -> Optional[str]:
    """'attr' for ``self.attr`` (or ``OBJ.attr`` — locks are matched by
    attribute name, so module-level singletons like ``_STATE._init_lock``
    resolve to the class's lock definition)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class _ClassLockAnalysis:
    def __init__(self, cls: ast.ClassDef, path: str):
        self.cls = cls
        self.path = path
        self.locks: Dict[str, _LockDef] = {}
        self.methods: Dict[str, _MethodSummary] = {}

    # -- discovery -----------------------------------------------------------
    def collect_locks(self):
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            attr = _self_attr(target)
            if attr is None:
                continue
            ctor = _lock_ctor(node.value)
            if ctor is None:
                continue
            kind, under = ctor
            self.locks[attr] = _LockDef(
                name=attr, kind=kind, underlying=under or attr,
                line=node.lineno)

    def _underlying(self, attr: str) -> str:
        d = self.locks.get(attr)
        return d.underlying if d else attr

    def _kind(self, attr: str) -> str:
        d = self.locks.get(attr)
        return d.kind if d else "lock"

    # -- per-method simulation ----------------------------------------------
    def summarize_methods(self, findings: List[Finding]):
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                summary = _MethodSummary(node.name)
                self._walk(node.body, frozenset(), summary, findings)
                self.methods[node.name] = summary

    def _record_acquire(self, attr: str, held: frozenset, line: int,
                        summary: _MethodSummary, findings: List[Finding]):
        lock = self._underlying(attr)
        if lock in held:
            base = self.locks.get(lock)
            if base is not None and base.kind == "lock":
                findings.append(Finding(
                    "HVD103", self.path, line, 0,
                    f"{self.cls.name}.{summary.name} re-acquires "
                    f"non-reentrant lock 'self.{lock}' already held on "
                    f"this path; a plain threading.Lock self-deadlocks"))
            return
        summary.acquisitions.append((held, lock, line))

    def _walk(self, stmts, held: frozenset, summary: _MethodSummary,
              findings: List[Finding]):
        for stmt in stmts:
            held = self._walk_stmt(stmt, held, summary, findings)

    def _walk_stmt(self, stmt: ast.stmt, held: frozenset,
                   summary: _MethodSummary,
                   findings: List[Finding]) -> frozenset:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                ctx = item.context_expr
                attr = _self_attr(ctx) if isinstance(ctx, ast.Attribute) \
                    else None
                if attr is not None and attr in self.locks:
                    self._record_acquire(attr, inner, stmt.lineno,
                                         summary, findings)
                    inner = inner | {self._underlying(attr)}
            self._walk(stmt.body, inner, summary, findings)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs (callbacks) run later, on an unknown thread;
            # analyze them with an empty held set
            nested = _MethodSummary(f"{summary.name}.<{stmt.name}>")
            self._walk(stmt.body, frozenset(), nested, findings)
            self.methods[nested.name] = nested
            return held
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, held, summary, findings)
            for handler in stmt.handlers:
                self._walk(handler.body, held, summary, findings)
            self._walk(stmt.orelse, held, summary, findings)
            self._walk(stmt.finalbody, held, summary, findings)
            return held
        if isinstance(stmt, (ast.If, ast.While, ast.For, ast.AsyncFor)):
            for field in ("body", "orelse"):
                self._walk(getattr(stmt, field, []), held, summary,
                           findings)
            test = getattr(stmt, "test", None) or getattr(stmt, "iter", None)
            if test is not None:
                self._scan_calls(test, held, summary, findings)
            return held
        if isinstance(stmt, ast.Match):
            self._scan_calls(stmt.subject, held, summary, findings)
            for case in stmt.cases:
                self._walk(case.body, held, summary, findings)
            return held
        return self._scan_linear(stmt, held, summary, findings)

    def _scan_linear(self, stmt: ast.stmt, held: frozenset,
                     summary: _MethodSummary,
                     findings: List[Finding]) -> frozenset:
        """Explicit acquire()/release()/wait()/self-calls in a leaf
        statement; returns the updated held set (acquire() holds until a
        matching release() later in the method)."""
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            recv = _self_attr(fn.value)
            if recv is not None and recv in self.locks:
                if fn.attr == "acquire":
                    self._record_acquire(recv, held, node.lineno,
                                         summary, findings)
                    held = held | {self._underlying(recv)}
                elif fn.attr == "release":
                    held = held - {self._underlying(recv)}
                elif fn.attr in ("wait", "wait_for") \
                        and self._kind(recv) == "condition":
                    summary.waits.append((held, recv, node.lineno))
            elif isinstance(fn.value, ast.Name) and fn.value.id == "self":
                held_now = held
                summary.calls.append((held_now, fn.attr, node.lineno))
        return held

    def _scan_calls(self, expr: ast.expr, held: frozenset,
                    summary: _MethodSummary, findings: List[Finding]):
        wrapper = ast.Expr(value=expr)
        ast.copy_location(wrapper, expr)
        self._scan_linear(wrapper, held, summary, findings)

    # -- whole-class verdicts -----------------------------------------------
    def finish(self, findings: List[Finding]):
        # one-level-plus fixpoint: locks a method may acquire, directly or
        # through intra-class calls
        acquires: Dict[str, Set[str]] = {
            m: {lock for _, lock, _ in s.acquisitions}
            for m, s in self.methods.items()}
        changed = True
        while changed:
            changed = False
            for m, s in self.methods.items():
                for _, callee, _ in s.calls:
                    extra = acquires.get(callee, set()) - acquires[m]
                    if extra:
                        acquires[m] |= extra
                        changed = True

        # acquisition-order edges: direct nestings + lock-held calls into
        # methods that acquire
        edges: Dict[Tuple[str, str], int] = {}
        for s in self.methods.values():
            for held, lock, line in s.acquisitions:
                for h in held:
                    edges.setdefault((h, lock), line)
            for held, callee, line in s.calls:
                if not held:
                    continue
                for lock in acquires.get(callee, ()):
                    for h in held:
                        if h != lock:
                            edges.setdefault((h, lock), line)

        reported = set()
        for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
            if (b, a) in edges and frozenset((a, b)) not in reported:
                reported.add(frozenset((a, b)))
                findings.append(Finding(
                    "HVD101", self.path, line, 0,
                    f"{self.cls.name}: locks 'self.{a}' and 'self.{b}' are "
                    f"acquired in both orders (also line "
                    f"{edges[(b, a)]}); two threads taking opposite orders "
                    f"deadlock"))

        # cv waits while holding an unrelated lock
        for s in self.methods.values():
            for held, cv, line in s.waits:
                others = held - {self._underlying(cv)}
                if others:
                    other = ", ".join(f"self.{o}" for o in sorted(others))
                    findings.append(Finding(
                        "HVD102", self.path, line, 0,
                        f"{self.cls.name}.{s.name} waits on "
                        f"'self.{cv}' while holding {other}; wait() only "
                        f"releases the condition's own lock, so the "
                        f"notifying thread blocks on {other} forever"))


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            analysis = _ClassLockAnalysis(node, path)
            analysis.collect_locks()
            if not analysis.locks:
                continue
            analysis.summarize_methods(findings)
            analysis.finish(findings)
    return findings
