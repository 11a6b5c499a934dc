"""Engine 3: guarded-by inference and static race detection (HVD110–115).

Counterpart: ``horovod_tpu/analysis/guarded_by.py``, run over the port.
Eraser-style lock-set analysis, run statically over the port's own
threaded classes (the engine, the controller, the overlap dispatcher,
the elastic driver and worker, the serving plane, the metrics, health
and time-series threads).  For every class that owns a ``threading.Lock`` /
``RLock`` / ``Condition`` (or is reachable from two or more thread entry
points — see ``callgraph.py``), each instance attribute's **candidate
guard** is inferred from the lock held at the majority of its access
sites; the lock held at every *write* site is the fallback when no lock
reaches a majority.  Accesses are tracked through ``with self._lock:``
blocks, ``acquire()``/``release()`` spans, ``Condition(self._lock)``
underlying-lock aliasing, and intra-class calls **to a fixed point**: a
private method only ever called with a lock held analyzes as if it held
that lock (the *ambient* set — the intersection over its call sites,
each call site contributing its syntactic held set plus its own
caller's ambient, iterated until stable), so ``caller must hold
self._lock`` helper chains of any depth do not false-positive.
Non-escaping nested defs (only ever called directly, never passed as a
value) analyze under the locks provably held at BOTH their definition
site and every direct call site, plus the enclosing method's ambient
set — the ``while not changed(): cv.wait()`` wait-predicate idiom
defines and calls its predicate inside ``with self._cond:``, so the
predicate and the private helpers it calls resolve the Condition's
underlying lock any number of call levels deeper, while a def merely
*defined* under a lock but called after its release still analyzes
bare, and a def that ESCAPES as a value (thread target, callback)
runs on an unknown thread: neither the syntactic nor the ambient held
set applies inside it.

Findings:

* **HVD110** — attribute written without its inferred guard on a
  multi-thread-reachable path;
* **HVD111** — non-atomic read-modify-write (``self.x += 1``, swap
  assignments reading the written attribute) outside the guard, or a
  check-then-act whose test runs unguarded while the act takes the lock;
* **HVD112** — a guarded mutable container escapes the lock scope by
  reference (returned bare, or stored into an unguarded attribute);
* **HVD113** — the guard is held for writes but not for reads (torn /
  stale reads; the symmetric case surfaces per-site as HVD110/111);
* **HVD114** — attribute first assigned in ``__init__`` *after* a thread
  that reads it was already started;
* **HVD115** — no majority lock and two locks each guard a large share
  of sites: split-guard ambiguity, nothing is actually protected.

Static under-approximation in the safe direction: attributes with no
guarded sites at all produce **no** findings (there is no inferred guard
to violate — that is the documented Eraser limitation), and accesses the
analysis cannot see (``outer.attr`` closures, cross-module calls) simply
do not count as sites.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from . import callgraph
from .lock_order import _LockDef, _lock_ctor
from .report import Finding

#: Attribute-method calls that mutate the receiver in place.
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "move_to_end", "sort", "reverse", "put", "put_nowait",
})

#: Constructor calls whose result is a mutable container (HVD112 scope).
_CONTAINER_CTORS = frozenset({
    "list", "dict", "set", "deque", "OrderedDict", "defaultdict",
    "Counter", "bytearray",
})

#: Majority threshold for guard inference.
_MAJORITY = 0.5
#: Split-guard share (HVD115): two locks each covering at least this.
_SPLIT_SHARE = 0.3


def _is_container_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        return name in _CONTAINER_CTORS
    return False


def _self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _nested_escapes(root: ast.AST, name: str) -> bool:
    """Does the nested function ``name`` escape its enclosing method as a
    *value* (thread target, callback registration, return, assignment,
    container element)?  Only direct ``name(...)`` calls keep it local to
    the defining scope."""
    direct_callees: Set[int] = set()
    for node in ast.walk(root):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == name:
            direct_callees.add(id(node.func))
    for node in ast.walk(root):
        if isinstance(node, ast.Name) and node.id == name \
                and isinstance(node.ctx, ast.Load) \
                and id(node) not in direct_callees:
            return True
    return False


def _calls_name(root: ast.AST, name: str) -> bool:
    """Does this subtree contain a direct ``name(...)`` call?"""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == name for n in ast.walk(root))


def _reads_attr(node: ast.expr, attr: str) -> bool:
    """Does this expression read ``self.<attr>`` anywhere?"""
    for sub in ast.walk(node):
        if _self_attr(sub) == attr and isinstance(
                getattr(sub, "ctx", None), ast.Load):
            return True
    return False


@dataclasses.dataclass
class _Access:
    attr: str
    kind: str                    # read | write | rmw | escape | cta
    held: FrozenSet[str]         # underlying lock names held at the site
    method: str                  # method name ("m" or "m.<nested>")
    line: int
    in_init: bool
    escape_to: Optional[str] = None   # HVD112: "" = returned, else attr name
    #: may this site inherit the enclosing method's ambient held set?
    #: True for the method body and non-escaping nested defs (they run
    #: on the defining thread, inside the method's dynamic extent);
    #: False inside an escaping nested def — it runs later, on an
    #: unknown thread, where the caller's ambient locks are NOT held.
    ambient_ok: bool = True


@dataclasses.dataclass
class _MergedClass:
    name: str
    node: ast.ClassDef
    path: str
    locks: Dict[str, _LockDef] = dataclasses.field(default_factory=dict)
    #: method name -> (defining class, FunctionDef); nearest override wins
    methods: Dict[str, Tuple[str, ast.AST]] = \
        dataclasses.field(default_factory=dict)
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    #: (caller method, held set, callee method name, line, ambient_ok)
    calls: List[Tuple[str, FrozenSet[str], str, int, bool]] = \
        dataclasses.field(default_factory=list)
    #: attr -> first __init__ assignment line
    init_assign_line: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: attrs whose __init__ value is a mutable container
    container_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: earliest line in __init__ at which a thread is already running
    init_spawn_line: Optional[int] = None
    init_spawn_desc: str = ""


class _MethodWalker:
    """Walk one method body tracking the held-lock set, recording
    attribute access sites and intra-class call sites."""

    def __init__(self, cls: _MergedClass, method: str, in_init: bool,
                 root: Optional[ast.AST] = None,
                 shared: Optional[dict] = None,
                 ambient_ok: bool = True):
        self.cls = cls
        self.method = method
        self.in_init = in_init
        #: the outermost method node — nested walkers share it so escape
        #: analysis for a nested def sees every use site in the method
        self.root = root
        #: False once inside an escaping nested def (and everything
        #: below it): those statements run on an unknown thread, so the
        #: enclosing method's ambient held set must not apply to them
        self.ambient_ok = ambient_ok
        #: method-scope state shared with nested walkers: deferred
        #: non-escaping nested defs ("defs": [(stmt, def_held, label,
        #: ambient_ok)]) and the running INTERSECTION of the held set at
        #: each direct call site of a nested name ("call_held":
        #: name -> fset|None)
        self.shared = shared if shared is not None \
            else {"defs": [], "call_held": {}}

    # -- held-set helpers ----------------------------------------------------
    def _underlying(self, attr: str) -> str:
        d = self.cls.locks.get(attr)
        return d.underlying if d else attr

    # -- access recording ----------------------------------------------------
    def _access(self, attr: str, kind: str, held: FrozenSet[str], line: int,
                escape_to: Optional[str] = None):
        if attr in self.cls.locks:
            return
        self.cls.accesses.append(_Access(
            attr=attr, kind=kind, held=held, method=self.method,
            line=line, in_init=self.in_init, escape_to=escape_to,
            ambient_ok=self.ambient_ok))
        if self.in_init and kind in ("write", "rmw") \
                and attr not in self.cls.init_assign_line:
            self.cls.init_assign_line[attr] = line

    # -- the walk ------------------------------------------------------------
    def walk(self, stmts, held: FrozenSet[str]):
        for stmt in stmts:
            held = self._walk_stmt(stmt, held)
        return held

    def _walk_stmt(self, stmt: ast.stmt, held: FrozenSet[str]
                   ) -> FrozenSet[str]:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in self.cls.locks:
                    inner = inner | {self._underlying(attr)}
                else:
                    self._scan_expr(item.context_expr, held)
            self.walk(stmt.body, inner)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def that never escapes as a value (no thread
            # target, callback registration, return or assignment — only
            # direct ``name()`` calls) runs on the defining thread, so it
            # analyzes under the locks provably held at BOTH its
            # definition site and every direct call site (analysis is
            # deferred to finish(), once every call site's held set has
            # been seen — a def inside ``with lock:`` that is only
            # CALLED after the block must NOT analyze as lock-held).
            # This is what resolves ``Condition(lock)`` aliasing one
            # call level deeper: the ``while not changed(): cv.wait()``
            # predicate idiom defines AND calls ``changed`` inside
            # ``with self._cond:``, and the predicate (plus any private
            # helper it calls) analyzes as holding the condition's
            # underlying lock.  An escaping nested def still analyzes
            # with an empty held set (it runs later, on an unknown
            # thread).
            inherits = (self.root is not None
                        and not stmt.decorator_list
                        and not _nested_escapes(self.root, stmt.name))
            if inherits:
                self.shared["defs"].append(
                    (stmt, held, f"{self.method}.<{stmt.name}>",
                     self.ambient_ok))
                self.shared["call_held"].setdefault(stmt.name, None)
            else:
                nested = _MethodWalker(
                    self.cls, f"{self.method}.<{stmt.name}>",
                    in_init=False, root=self.root, shared=self.shared,
                    ambient_ok=False)
                nested.walk(stmt.body, frozenset())
            return held
        if isinstance(stmt, ast.ClassDef):
            return held          # nested classes are opaque (callgraph.py)
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body, held)
            for handler in stmt.handlers:
                self.walk(handler.body, held)
            self.walk(stmt.orelse, held)
            self.walk(stmt.finalbody, held)
            return held
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, held)
            self._check_then_act(stmt, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            test = getattr(stmt, "test", None) or getattr(stmt, "iter", None)
            if test is not None:
                self._scan_expr(test, held)
            self.walk(stmt.body, held)
            self.walk(getattr(stmt, "orelse", []), held)
            return held
        if isinstance(stmt, ast.Match):
            self._scan_expr(stmt.subject, held)
            for case in stmt.cases:
                self.walk(case.body, held)
            return held
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                attr = _self_attr(stmt.value)
                if attr is not None:
                    self._access(attr, "escape", held, stmt.lineno,
                                 escape_to="")
                else:
                    self._scan_expr(stmt.value, held)
            return held
        return self._scan_leaf(stmt, held)

    def _check_then_act(self, stmt: ast.If, held: FrozenSet[str]):
        """``if self.x ...`` with a write to ``self.x`` in the body: the
        check-then-act pair (recorded as a ``cta`` pseudo-site; flagged
        when the *test* ran without the guard the *act* takes)."""
        read_attrs = {a for sub in ast.walk(stmt.test)
                      if (a := _self_attr(sub)) is not None
                      and a not in self.cls.locks}
        if not read_attrs:
            return
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    a = _self_attr(t)
                    if a in read_attrs:
                        self._access(a, "cta", held, stmt.lineno)

    def _walk_lock_ops(self, stmt: ast.stmt, held: FrozenSet[str]
                       ) -> FrozenSet[str]:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            recv = _self_attr(fn.value)
            if recv is not None and recv in self.cls.locks:
                if fn.attr == "acquire":
                    held = held | {self._underlying(recv)}
                elif fn.attr == "release":
                    held = held - {self._underlying(recv)}
        return held

    def _scan_leaf(self, stmt: ast.stmt, held: FrozenSet[str]
                   ) -> FrozenSet[str]:
        if isinstance(stmt, ast.Assign):
            rmw_attrs = set()
            for t in stmt.targets:
                self._scan_target(t, stmt, held, rmw_attrs)
            self._scan_expr(stmt.value, held, skip_attrs=rmw_attrs)
        elif isinstance(stmt, ast.AugAssign):
            attr = _self_attr(stmt.target)
            if attr is not None:
                self._access(attr, "rmw", held, stmt.lineno)
            elif isinstance(stmt.target, ast.Subscript):
                base = _self_attr(stmt.target.value)
                if base is not None:
                    self._access(base, "rmw", held, stmt.lineno)
                self._scan_expr(stmt.target.slice, held)
            self._scan_expr(stmt.value, held)
        elif isinstance(stmt, (ast.AnnAssign,)):
            attr = _self_attr(stmt.target)
            if attr is not None and stmt.value is not None:
                kind = "rmw" if _reads_attr(stmt.value, attr) else "write"
                self._access(attr, kind, held, stmt.lineno)
            if stmt.value is not None:
                self._scan_expr(stmt.value, held)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                attr = _self_attr(t)
                if attr is not None:
                    self._access(attr, "write", held, stmt.lineno)
                elif isinstance(t, ast.Subscript):
                    base = _self_attr(t.value)
                    if base is not None:
                        self._access(base, "write", held, stmt.lineno)
                    self._scan_expr(t.slice, held)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(child, held)
        return self._walk_lock_ops(stmt, held)

    def _scan_target(self, target: ast.expr, stmt: ast.Assign,
                     held: FrozenSet[str], rmw_attrs: Set[str]):
        attr = _self_attr(target)
        if attr is not None:
            if _reads_attr(stmt.value, attr):
                self._access(attr, "rmw", held, stmt.lineno)
                rmw_attrs.add(attr)
            else:
                self._access(attr, "write", held, stmt.lineno)
            return
        if isinstance(target, ast.Subscript):
            base = _self_attr(target.value)
            if base is not None:
                kind = "rmw" if _reads_attr(stmt.value, base) else "write"
                self._access(base, kind, held, stmt.lineno)
                if kind == "rmw":
                    rmw_attrs.add(base)
                # HVD112: a guarded attr stored by reference into another
                # attribute's container
                stored = _self_attr(stmt.value)
                if stored is not None and stored != base:
                    self._access(stored, "escape", held, stmt.lineno,
                                 escape_to=base)
            else:
                self._scan_expr(target.value, held)
            self._scan_expr(target.slice, held)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._scan_target(elt, stmt, held, rmw_attrs)
            return
        if isinstance(target, ast.Attribute):
            self._scan_expr(target.value, held)

    def finish(self):
        """Analyze the deferred non-escaping nested defs.  Each runs
        under ``def-site held ∩ (∩ call-site helds)`` — never called
        directly means no provable context, so an empty set.  The queue
        drains with a cursor because a nested body may register deeper
        nested defs of its own.

        Order matters: a deferred def called from another deferred
        def's body (``def a(): ...`` / ``def b(): return a()``) must be
        analyzed AFTER its caller, or the call site inside the caller
        has not been recorded yet and the callee falsely analyzes bare.
        At each step, pick a remaining def not called by any other
        remaining def (callers drain first; mutual recursion falls back
        to definition order)."""
        done = 0
        defs = self.shared["defs"]
        while done < len(defs):
            remaining = defs[done:]
            pick = 0
            for j, (stmt_j, _, _, _) in enumerate(remaining):
                if not any(k != j and _calls_name(stmt_k, stmt_j.name)
                           for k, (stmt_k, _, _, _) in enumerate(remaining)):
                    pick = j
                    break
            defs[done], defs[done + pick] = defs[done + pick], defs[done]
            stmt, def_held, label, amb_ok = defs[done]
            done += 1
            call_held = self.shared["call_held"].get(stmt.name)
            effective = def_held & call_held if call_held is not None \
                else frozenset()
            nested = _MethodWalker(self.cls, label, in_init=False,
                                   root=self.root, shared=self.shared,
                                   ambient_ok=amb_ok)
            nested.walk(stmt.body, effective)

    def _scan_expr(self, node: ast.expr, held: FrozenSet[str],
                   skip_attrs: Set[str] = frozenset()):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) \
                    and fn.id in self.shared["call_held"]:
                prev = self.shared["call_held"][fn.id]
                self.shared["call_held"][fn.id] = \
                    held if prev is None else (prev & held)
            handled_fn = False
            if isinstance(fn, ast.Attribute):
                if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                    # self.m(...): intra-class call edge; self._fn(...):
                    # a callable-attribute read
                    handled_fn = True
                    if fn.attr in self.cls.locks:
                        pass
                    elif fn.attr in self.cls.methods:
                        self.cls.calls.append(
                            (self.method, held, fn.attr, node.lineno,
                             self.ambient_ok))
                    else:
                        self._access(fn.attr, "read", held, node.lineno)
                else:
                    # self.X.m(...): lock op on a lock attr; otherwise a
                    # mutator method is a write on X, anything else a read
                    recv = _self_attr(fn.value)
                    if recv is not None:
                        handled_fn = True
                        if recv in self.cls.locks:
                            pass
                        elif fn.attr in MUTATORS:
                            self._access(recv, "write", held, node.lineno)
                        else:
                            self._access(recv, "read", held, node.lineno)
            if not handled_fn:
                self._scan_expr(fn, held, skip_attrs)
            for arg in node.args:
                self._scan_expr(arg, held, skip_attrs)
            for kw in node.keywords:
                self._scan_expr(kw.value, held, skip_attrs)
            return
        attr = _self_attr(node)
        if attr is not None:
            if attr not in skip_attrs:
                kind = "write" if isinstance(node.ctx, ast.Store) else "read"
                self._access(attr, kind, held, node.lineno)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._scan_expr(child, held, skip_attrs)
            elif isinstance(child, ast.keyword):
                self._scan_expr(child.value, held, skip_attrs)
            elif isinstance(child, ast.comprehension):
                self._scan_expr(child.iter, held, skip_attrs)
                for cond in child.ifs:
                    self._scan_expr(cond, held, skip_attrs)


def _merge_class(name: str, graph: callgraph.ModuleCallGraph,
                 path: str) -> _MergedClass:
    """Flatten a class with its same-module bases (nearest override wins)
    so base-class helpers analyze with the subclass's locks."""
    merged = _MergedClass(name=name, node=graph.classes[name], path=path)
    for cls_name in graph.mro_classes(name):
        cls_node = graph.classes[cls_name]
        for stmt in cls_node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name not in merged.methods:
                merged.methods[stmt.name] = (cls_name, stmt)
        for node in ast.walk(cls_node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            ctor = _lock_ctor(node.value)
            if ctor is not None and attr not in merged.locks:
                kind, under = ctor
                merged.locks[attr] = _LockDef(
                    name=attr, kind=kind, underlying=under or attr,
                    line=node.lineno)
    return merged


def _is_thread_ctor(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and (node.func.attr if isinstance(node.func, ast.Attribute)
                 else node.func.id if isinstance(node.func, ast.Name)
                 else None) == "Thread")


def _collect_init_facts(merged: _MergedClass):
    """Container-valued attrs and the earliest thread-spawn line, from
    every ``__init__`` in the merged chain.  Only ``.start()`` on a
    receiver assigned a ``Thread(...)`` counts as a spawn — servers,
    timers and profilers also have ``.start()`` methods."""
    init = merged.methods.get("__init__")
    if init is None:
        return
    _, fn = init
    thread_receivers: Set[str] = set()       # "self.X" or local name
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _self_attr(node.targets[0])
            if attr is not None and _is_container_expr(node.value):
                merged.container_attrs.add(attr)
            if _is_thread_ctor(node.value):
                if attr is not None:
                    thread_receivers.add(f"self.{attr}")
                elif isinstance(node.targets[0], ast.Name):
                    thread_receivers.add(node.targets[0].id)
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "start"):
            continue
        recv = node.func.value
        attr = _self_attr(recv)
        spawns = (
            (attr is not None and f"self.{attr}" in thread_receivers)
            or (isinstance(recv, ast.Name)
                and recv.id in thread_receivers)
            or _is_thread_ctor(recv))        # Thread(...).start() chained
        if spawns and (merged.init_spawn_line is None
                       or node.lineno < merged.init_spawn_line):
            merged.init_spawn_line = node.lineno
            merged.init_spawn_desc = "a thread .start()"


def _ambient_held(merged: _MergedClass, root_methods: Set[str]
                  ) -> Dict[str, FrozenSet[str]]:
    """Locks guaranteed held on entry to each *private* method: the
    intersection over its intra-class call sites, to a fixpoint.  Public
    methods and thread roots are externally callable — ambient empty (a
    thread entry point runs with no lock held no matter who else calls
    it intra-class)."""
    all_locks = frozenset(d.underlying for d in merged.locks.values())
    callers: Dict[str, List[Tuple[Optional[str], FrozenSet[str]]]] = {}
    for caller, held, callee, _line, amb_ok in merged.calls:
        # a call made inside an ESCAPING nested def runs on an unknown
        # thread: the enclosing method's ambient locks are not held
        # there, so that call site contributes only its syntactic held
        # set (caller recorded as None — no ambient lookup)
        base = caller.split(".")[0] if amb_ok else None
        callers.setdefault(callee, []).append((base, held))
    ambient: Dict[str, FrozenSet[str]] = {}
    for m in merged.methods:
        private = m.startswith("_") and not m.startswith("__")
        ambient[m] = all_locks if (private and m in callers
                                   and m not in root_methods) \
            else frozenset()
    for _ in range(len(merged.methods) + 1):
        changed = False
        for m in merged.methods:
            if not ambient[m]:
                continue
            acc = None
            for caller, held in callers.get(m, ()):
                eff = held | (ambient.get(caller, frozenset())
                              if caller is not None else frozenset())
                acc = eff if acc is None else (acc & eff)
            acc = acc if acc is not None else frozenset()
            if acc != ambient[m]:
                ambient[m] = acc
                changed = True
        if not changed:
            break
    return ambient


def _entry_points(graph: callgraph.ModuleCallGraph, cls: str):
    roots = graph.thread_roots(cls)
    reaches = {r.qname: graph.reachable(r.qname) for r in roots}
    public = [q for q, f in graph.functions.items()
              if f.cls in graph.mro_classes(cls)
              and "." not in q.split(".", 1)[1]
              and not q.split(".", 1)[1].startswith("_")]
    main_reach: Set[str] = set()
    for q in public:
        main_reach |= graph.reachable(q)
    return roots, reaches, main_reach


class _ClassCheck:
    def __init__(self, merged: _MergedClass,
                 graph: callgraph.ModuleCallGraph):
        self.m = merged
        self.graph = graph
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        merged, graph = self.m, self.graph
        roots, reaches, main_reach = _entry_points(graph, merged.name)
        if not merged.locks and len(roots) < 2:
            return []
        for mname, (cls_name, fn) in merged.methods.items():
            walker = _MethodWalker(merged, mname,
                                   in_init=(mname == "__init__"), root=fn)
            walker.walk(fn.body, frozenset())
            walker.finish()
        _collect_init_facts(merged)
        # handler-table / executor registrations in __init__ spawn their
        # thread at construction (e.g. an RPC server starting its serve
        # thread inside its own __init__) — a .start() call is not the
        # only way a thread is already running
        init_qnames = {f"{c}.__init__" for c in graph.mro_classes(
            merged.name)}
        for _cls, func, line, via in graph.spawn_sites:
            if func in init_qnames and via in ("handler_table", "executor"):
                if merged.init_spawn_line is None \
                        or line < merged.init_spawn_line:
                    merged.init_spawn_line = line
                    merged.init_spawn_desc = (
                        "a handler-table registration"
                        if via == "handler_table" else "an executor submit")
        root_methods = {r.qname.split(".", 1)[1] for r in roots
                        if r.cls is not None and "." in r.qname}
        ambient = _ambient_held(merged, root_methods)
        # the ambient set applies to the method body AND its
        # non-escaping nested defs (they run inside the method's
        # dynamic extent on the same thread — the second call level of
        # the ``while not pred(): cv.wait()`` idiom, where the
        # predicate lives in a helper whose callers hold the lock);
        # sites inside an ESCAPING nested def run on an unknown thread
        # and stay bare (ambient_ok=False)
        for a in merged.accesses:
            base = a.method.split(".")[0]
            if a.ambient_ok:
                a.held = a.held | ambient.get(base, frozenset())

        by_attr: Dict[str, List[_Access]] = {}
        for a in merged.accesses:
            by_attr.setdefault(a.attr, []).append(a)

        root_reach: Set[str] = set()
        for r in roots:
            root_reach |= reaches[r.qname]

        for attr in sorted(by_attr):
            self._check_attr(attr, by_attr[attr], roots, reaches,
                             main_reach, root_reach)
        return self.findings

    # -- per-attribute verdicts ---------------------------------------------
    def _qname(self, method: str) -> Optional[str]:
        base = method.split(".")[0]
        q = self.graph.resolve_method(self.m.name, base)
        if q is None:
            return None
        if "." in method.replace(base, "", 1):
            # nested context keeps its own identity
            return q + method[len(base):]
        return q

    def _contexts(self, method: str, roots, reaches, main_reach
                  ) -> Set[str]:
        if ".<" in method:
            return {f"nested:{method}"}
        q = self._qname(method)
        ctxs = {r.qname for r in roots
                if q is not None and q in reaches[r.qname]}
        if q is None or q in main_reach or not ctxs:
            ctxs = ctxs | {"main"}
        return ctxs

    def _check_attr(self, attr: str, sites: List[_Access], roots, reaches,
                    main_reach, root_reach: Set[str]):
        live = [s for s in sites if not s.in_init]
        if not live:
            return
        self._check_init_publication(attr, sites, roots, root_reach)

        contexts: Set[str] = set()
        for s in live:
            contexts |= self._contexts(s.method, roots, reaches, main_reach)
        # shared: seen from two thread contexts, or — in a class that
        # owns a lock, the module-visible evidence of concurrency — from
        # two or more sites (any method may run on several threads)
        shared = len(contexts) >= 2 or (bool(self.m.locks)
                                        and len(live) >= 2)
        if not shared:
            return
        if not any(s.kind in ("write", "rmw", "cta") for s in live):
            return          # read-only after __init__: nothing can race

        # lock coverage over the live sites
        cover: Dict[str, int] = {}
        for s in live:
            for lock in s.held:
                cover[lock] = cover.get(lock, 0) + 1
        n = len(live)
        ranked = sorted(cover.items(), key=lambda kv: (-kv[1], kv[0]))
        guard = None
        if ranked and ranked[0][1] / n > _MAJORITY:
            guard = ranked[0][0]
        elif len([1 for _, c in ranked if c / n >= _SPLIT_SHARE]) >= 2:
            a, b = ranked[0], ranked[1]
            self._add("HVD115", live[0].line,
                      f"{self.m.name}: attribute 'self.{attr}' has no "
                      f"majority guard — 'self.{a[0]}' is held at "
                      f"{a[1]}/{n} access sites and 'self.{b[0]}' at "
                      f"{b[1]}/{n}; a split guard protects nothing")
            return
        else:
            # write-lockset fallback: every write under one common lock
            writes = [s for s in live if s.kind in ("write", "rmw")]
            if writes:
                common = frozenset.intersection(
                    *[s.held for s in writes])
                if common:
                    guard = sorted(common)[0]
        if guard is None:
            return

        guarded = sum(1 for s in live if guard in s.held)
        for s in live:
            if guard in s.held:
                continue
            if s.kind == "rmw":
                self._add("HVD111", s.line,
                          f"{self.m.name}.{s.method}: read-modify-write of "
                          f"'self.{attr}' without inferred guard "
                          f"'self.{guard}' (held at {guarded}/{n} access "
                          f"sites); interleaving threads lose an update")
            elif s.kind == "write":
                self._add("HVD110", s.line,
                          f"{self.m.name}.{s.method}: write to "
                          f"'self.{attr}' without inferred guard "
                          f"'self.{guard}' (held at {guarded}/{n} access "
                          f"sites) on a multi-thread-reachable path")
            elif s.kind == "cta":
                # the act is guarded (an unguarded act already reported
                # above); the *check* ran outside the guard
                acts = [t for t in live
                        if t.kind in ("write", "rmw") and guard in t.held]
                if acts:
                    self._add("HVD111", s.line,
                              f"{self.m.name}.{s.method}: check-then-act "
                              f"on 'self.{attr}' — the test runs without "
                              f"inferred guard 'self.{guard}' but the "
                              f"update takes it; the decision can be "
                              f"stale by the time the lock is acquired")

        # HVD112: guarded container escaping by reference
        for s in live:
            if s.kind != "escape" or attr not in self.m.container_attrs:
                continue
            if s.escape_to == "":
                self._add("HVD112", s.line,
                          f"{self.m.name}.{s.method}: returns guarded "
                          f"container 'self.{attr}' by reference; the "
                          f"caller iterates/mutates it after "
                          f"'self.{guard}' is released — return a copy")
            elif s.escape_to is not None:
                dest = s.escape_to
                self._add("HVD112", s.line,
                          f"{self.m.name}.{s.method}: stores guarded "
                          f"container 'self.{attr}' by reference into "
                          f"'self.{dest}', which 'self.{guard}' does not "
                          f"guard — store a copy")

        # HVD113: writes guarded, reads not (the torn-read asymmetry).
        # Bare-return escapes read the attribute too; the container case
        # is HVD112's, reported above.
        writes = [s for s in live if s.kind in ("write", "rmw")]
        reads = [s for s in live
                 if s.kind == "read"
                 or (s.kind == "escape"
                     and attr not in self.m.container_attrs)]
        if writes and reads and all(guard in s.held for s in writes):
            bare = [s for s in reads if guard not in s.held]
            if bare:
                s = min(bare, key=lambda x: x.line)
                self._add("HVD113", s.line,
                          f"{self.m.name}.{s.method}: 'self.{attr}' is "
                          f"written under 'self.{guard}' but read here "
                          f"without it ({len(bare)}/{len(reads)} reads "
                          f"unguarded); the read can observe a torn or "
                          f"stale update")

    def _check_init_publication(self, attr: str, sites: List[_Access],
                                roots, root_reach: Set[str]):
        """HVD114: first assignment after a thread was already started."""
        if not roots or self.m.init_spawn_line is None:
            return
        first = self.m.init_assign_line.get(attr)
        if first is None or first <= self.m.init_spawn_line:
            return
        read_by_thread = any(
            s for s in sites
            if not s.in_init and s.kind in ("read", "rmw", "escape")
            and (q := self._qname(s.method)) is not None
            and q in root_reach)
        if read_by_thread:
            names = ", ".join(sorted(r.qname for r in roots))
            self._add("HVD114", first,
                      f"{self.m.name}.__init__: 'self.{attr}' is first "
                      f"assigned after {self.m.init_spawn_desc} on line "
                      f"{self.m.init_spawn_line} already launched a "
                      f"thread ({names}) that reads it; the thread can "
                      f"observe the attribute missing")

    def _add(self, code: str, line: int, message: str):
        self.findings.append(Finding(code, self.m.path, line, 0, message))


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    graph = callgraph.build_graph(tree)
    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for name in graph.classes:
        merged = _merge_class(name, graph, path)
        for f in _ClassCheck(merged, graph).run():
            key = (f.code, f.line)
            if key in seen:
                continue        # same base-class line via several subclasses
            seen.add(key)
            findings.append(f)
    return findings
