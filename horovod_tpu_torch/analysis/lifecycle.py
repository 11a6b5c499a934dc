"""hvdlint engine 6: concurrency-lifecycle checks (HVD400-HVD407).

Counterpart: ``horovod_tpu/analysis/lifecycle.py``, run over the port.

The framework is a background-thread machine — cycle loop, controller,
RPC pool, lease reaper, sampler/watchdog daemons — and the same defect
classes recur in it: a serving dedup-id set that grows per request
forever, store stamps leaking per sequence number, unbounded per-tensor
tables, dead workers' rotation EWMAs and ghost gauges accreting, mixed
monotonic/wall-clock spans, edge-triggered verdicts that can never
re-arm.  None of engines 1-5 can see them: they are not races or contract drift, they are *lifecycle* bugs —
state and threads that outlive the cycle that created them, or waits
that outlive the shutdown that should end them.

Rules
-----

* **HVD400** — a blocking call (``json_request``, socket ops,
  ``time.sleep``, ``Thread.join``, ``subprocess``, timeout-less
  ``queue.get`` / ``Event.wait``) reached **while a lock is held**,
  propagated interprocedurally: a helper that blocks is convicted when
  any caller (transitively) calls it inside ``with self._lock:``.
  OptiReduce's framing applies — tail latency is the production metric,
  and an RPC under the engine lock is a self-inflicted tail no deadline
  knob can fix.  ``Condition.wait`` is exempt (it *releases* the lock;
  HVD401/HVD102 govern it), as are bounded ``join(timeout)`` /
  ``wait(timeout)`` / ``get(timeout=...)``.  A lock acquired at exactly
  ONE site in the module is also exempt: it is a serialization mutex
  (the controller's ``_round_lock`` pattern) — only identical
  operations queue behind it, and that stall is the design; the hazard
  needs a *second* acquisition site whose (possibly quick) path can
  stall behind the blocking one.
* **HVD401** — ``Condition.wait()`` not wrapped in a ``while``-predicate
  loop: spurious wakeups and stolen notifications make a bare ``wait``
  return with the predicate still false.
* **HVD402** — job-lifetime growth: a container attribute on a class
  that owns a thread root or RPC handler table, grown (``append`` /
  ``add`` / subscript-store / ``setdefault``) on a path reachable from
  that root, with **no** eviction, ``maxlen``, reassignment, or prune
  anywhere in the class.  The exact shape of the five leaks above.
* **HVD403** — a non-daemon thread started but never ``join``-ed by any
  method of the owning class (or, for locals, in the spawning
  function): interpreter shutdown hangs waiting for it.
* **HVD404** — clock-domain mixing: a ``time.time()``-derived value
  compared or subtracted against a ``time.monotonic()``-derived one
  (dataflow over locals and self attributes).  NTP steps make such
  spans jump backwards or by hours (the PR-12 buffer-clock incident).
* **HVD405** — a user callback/hook (``on_*``, ``*_hook``,
  ``*_callback``, handler-dict values) invoked while holding an
  internal lock: user code re-entering the API deadlocks on the very
  lock the framework still holds.
* **HVD406** — a shutdown-flag loop (``while not self._stop: ...``)
  parked on a timeout-less ``Event.wait`` / ``Queue.get`` /
  ``lock.acquire()`` whose stop method flips the flag but never signals
  the primitive: the flag changes, the loop never wakes to see it.
* **HVD407** — edge-trigger state set on fire (``if key not in
  self.X: <action>; self.X.add(key)``) with no clearing store anywhere
  in the class: the trigger can fire once per process lifetime (the
  PR-13 stuck-verdict class) — and the set is a leak besides.  The
  guarded body must contain an *action* (a statement-level call beyond
  the arming store itself); a guard around nothing but the store is
  first-write-wins memoization, not an edge trigger.

Like the guarded-by engine this is deliberately module-local and
under-approximating: a lock we cannot resolve contributes no held set,
a receiver we cannot type produces no blocking site, a class whose
threads are spawned from another module is not "long-lived" here.
Missing a finding is acceptable; crying wolf gets linters deleted.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .callgraph import ModuleCallGraph, build_graph
from .lock_order import _lock_ctor
from .report import Finding

# --------------------------------------------------------------------------
# small shared predicates
# --------------------------------------------------------------------------

#: constructor name -> receiver type tag used by the blocking tables
_CTOR_TYPES = {
    "Thread": "thread",
    "Event": "event",
    "Queue": "queue", "LifoQueue": "queue", "PriorityQueue": "queue",
    "SimpleQueue": "queue", "JoinableQueue": "queue",
    "Condition": "condition",
    "Popen": "popen",
    "socket": "socket", "create_connection": "socket",
}

#: monotonic-domain calls in the ``time`` module
_MONO_FNS = frozenset({"monotonic", "monotonic_ns",
                       "perf_counter", "perf_counter_ns", "thread_time"})
#: wall-clock-domain calls in the ``time`` module
_WALL_FNS = frozenset({"time", "time_ns"})

_SUBPROCESS_BLOCKING = frozenset({"run", "call", "check_call",
                                  "check_output"})
#: attribute calls that are sockets blocking regardless of receiver —
#: these names are specific enough that a false receiver is unlikely
_SOCKET_BLOCKING = frozenset({"accept", "recv", "recvfrom", "recv_into"})

#: method-name fragments that mark a method as being on a shutdown path
_SHUTDOWN_FRAGMENTS = ("close", "stop", "shutdown", "join", "term",
                       "finali", "abort", "quit", "__exit__", "__del__")

_GROW_LIST = frozenset({"append", "appendleft", "extend", "insert"})
_GROW_SET = frozenset({"add"})
_GROW_DICT = frozenset({"setdefault"})
_GROW_ALL = _GROW_LIST | _GROW_SET | _GROW_DICT
_SHRINK = frozenset({"pop", "popleft", "popitem", "clear", "remove",
                     "discard"})


def _self_attr(node: ast.expr) -> Optional[str]:
    """'attr' for a literal ``self.attr`` expression."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _call_name(fn: ast.expr) -> Optional[str]:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _has_timeout(call: ast.Call) -> bool:
    """Any positional arg or a timeout= kwarg bounds the wait."""
    if call.args:
        return True
    return any(kw.arg in ("timeout", "deadline") for kw in call.keywords)


def _hookish(name: str) -> bool:
    """Does this name look like a user-supplied callback slot?"""
    return name.startswith("on_") or \
        name.endswith(("_hook", "_callback", "_cb"))


def _tableish(name: str) -> bool:
    """Does this attribute look like a table of user callbacks?"""
    low = name.lower()
    return "hook" in low or "callback" in low or "listener" in low


def _iter_own(node: ast.AST):
    """``ast.walk`` that does not descend into nested function/class
    bodies — facts inside a nested def belong to that def's own walk."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


def _ctor_type(expr: ast.expr) -> Optional[str]:
    """Receiver type tag for ``x = Ctor(...)`` style assignments."""
    if not isinstance(expr, ast.Call):
        return None
    name = _call_name(expr.func)
    return _CTOR_TYPES.get(name or "")


def _container_kind(expr: ast.expr) -> Optional[str]:
    """'list' / 'dict' / 'set' / 'deque' for an unbounded container
    initializer; None for anything bounded or unrecognized."""
    if isinstance(expr, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(expr, ast.Call):
        name = _call_name(expr.func)
        if name in ("dict", "OrderedDict", "defaultdict", "Counter"):
            return "dict"
        if name == "list":
            return "list"
        if name == "set":
            return "set"
        if name == "deque":
            bounded = any(kw.arg == "maxlen" for kw in expr.keywords) \
                or len(expr.args) > 1
            return None if bounded else "deque"
    return None


# --------------------------------------------------------------------------
# per-class facts (pass 1)
# --------------------------------------------------------------------------

class _ClassFacts:
    """Everything HVD402/403/406/407 need to know about one class."""

    def __init__(self, cls: ast.ClassDef):
        self.name = cls.name
        #: lock attr -> canonical label (conditions resolve to their
        #: underlying lock so ``with self._cond`` == ``with self._lock``)
        self.locks: Dict[str, str] = {}
        self.attr_types: Dict[str, str] = {}       # attr -> type tag
        self.attr_domains: Dict[str, Optional[str]] = {}  # clock domains
        self.containers: Dict[str, str] = {}       # attr -> kind
        #: attr -> (daemonized, ctor line)
        self.threads: Dict[str, Tuple[bool, int]] = {}
        self.started: Set[str] = set()             # thread attrs .start()ed
        self.joined: Set[str] = set()              # thread attrs .join()ed
        #: container growth: attr -> [(method, line, col, guarded)]
        self.grow_sites: Dict[str, List[Tuple[str, int, int, bool]]] = {}
        self.shrunk: Set[str] = set()              # attrs with eviction
        self.reassigned: Set[str] = set()          # reassigned outside init
        #: method -> flag attrs it writes (assign / .set() / .clear())
        self.flag_writes: Dict[str, Set[str]] = {}
        #: method -> attrs it signals (.set() / .put*() / .release() /
        #: .notify*())
        self.signals: Dict[str, Set[str]] = {}
        self._collect(cls)

    # -- collection ----------------------------------------------------------
    def _collect(self, cls: ast.ClassDef):
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for m in methods:
            self._collect_assigns(m)
        for m in methods:
            self._collect_mutations(m)

    def _collect_assigns(self, method: ast.AST):
        in_init = getattr(method, "name", "") == "__init__"
        for node in ast.walk(method):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            attr = _self_attr(target)
            if attr is None:
                # thread daemonization after construction:
                # ``self._t.daemon = True``
                if isinstance(target, ast.Attribute) and \
                        target.attr == "daemon" and \
                        _self_attr(target.value) in self.threads and \
                        isinstance(node.value, ast.Constant) and \
                        node.value.value is True:
                    t = _self_attr(target.value)
                    self.threads[t] = (True, self.threads[t][1])
                continue
            lock = _lock_ctor(node.value)
            if lock is not None:
                kind, under = lock
                self.locks[attr] = under or attr
                if kind == "condition":
                    self.attr_types[attr] = "condition"
                continue
            ctype = _ctor_type(node.value)
            if ctype is not None:
                self.attr_types.setdefault(attr, ctype)
                if ctype == "thread" and attr not in self.threads:
                    daemon = any(
                        kw.arg == "daemon" and
                        isinstance(kw.value, ast.Constant) and
                        kw.value.value is True
                        for kw in node.value.keywords)
                    self.threads[attr] = (daemon, node.lineno)
            ckind = _container_kind(node.value)
            if ckind is not None:
                if in_init:
                    self.containers.setdefault(attr, ckind)
                else:
                    # reassignment outside __init__ is a reset — the
                    # container's lifetime is bounded by whatever calls it
                    self.reassigned.add(attr)
            elif not in_init and attr in self.containers:
                self.reassigned.add(attr)
            dom = _expr_domain(node.value, {}, {})
            if dom in ("wall", "mono"):
                prev = self.attr_domains.get(attr, dom)
                self.attr_domains[attr] = dom if prev == dom else None
            # flag writes: ``self._stop = True/False``
            if isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, (bool, type(None))):
                mname = getattr(method, "name", "")
                self.flag_writes.setdefault(mname, set()).add(attr)

    def _collect_mutations(self, method: ast.AST):
        mname = getattr(method, "name", "")
        in_init = mname == "__init__"
        guarded = self._membership_guarded_lines(method)
        for node in ast.walk(method):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                attr = _self_attr(node.func.value)
                verb = node.func.attr
                if attr is None:
                    continue
                if verb in _SHRINK:
                    self.shrunk.add(attr)
                elif verb in _GROW_ALL and not in_init:
                    self.grow_sites.setdefault(attr, []).append(
                        (mname, node.lineno, node.col_offset,
                         node.lineno in guarded.get(attr, set())))
                if verb == "start" and attr in self.threads:
                    self.started.add(attr)
                elif verb == "join" and attr in self.threads:
                    self.joined.add(attr)
                if verb in ("set", "clear") and not node.args:
                    self.flag_writes.setdefault(mname, set()).add(attr)
                if verb in ("set", "put", "put_nowait", "release",
                            "notify", "notify_all"):
                    self.signals.setdefault(mname, set()).add(attr)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Subscript):
                attr = _self_attr(node.targets[0].value)
                if attr is not None and not in_init:
                    self.grow_sites.setdefault(attr, []).append(
                        (mname, node.lineno, node.col_offset,
                         node.lineno in guarded.get(attr, set())))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                    else:
                        attr = _self_attr(t)
                    if attr is not None:
                        self.shrunk.add(attr)

    def _membership_guarded_lines(self, method: ast.AST) \
            -> Dict[str, Set[int]]:
        """attr -> line numbers inside ``if key not in self.attr:``
        bodies — the edge-trigger shape HVD407 convicts (and HVD402
        then leaves to it).

        The body must contain an *action*: a statement-level call other
        than the arming store on the guarded attribute itself.  Without
        one the guard is plain first-write-wins memoization (``if k not
        in self.cache: self.cache[k] = build()``) — idempotent, not an
        edge trigger."""
        out: Dict[str, Set[int]] = {}
        for node in ast.walk(method):
            if not isinstance(node, ast.If):
                continue
            for cmp_node in ast.walk(node.test):
                if not isinstance(cmp_node, ast.Compare) or \
                        len(cmp_node.ops) != 1 or \
                        not isinstance(cmp_node.ops[0], ast.NotIn):
                    continue
                attr = _self_attr(cmp_node.comparators[0])
                if attr is None:
                    continue
                if not self._has_action(node.body, attr):
                    continue
                lines = out.setdefault(attr, set())
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if hasattr(sub, "lineno"):
                            lines.add(sub.lineno)
        return out

    @staticmethod
    def _has_action(body, attr: str) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if not (isinstance(sub, ast.Expr) and
                        isinstance(sub.value, ast.Call)):
                    continue
                fn = sub.value.func
                if isinstance(fn, ast.Attribute) and \
                        _self_attr(fn.value) == attr and \
                        fn.attr in _GROW_ALL:
                    continue            # the arming store itself
                return True
        return False


# --------------------------------------------------------------------------
# clock-domain evaluation (HVD404)
# --------------------------------------------------------------------------

def _call_domain(call: ast.Call, time_imports: Dict[str, str]) \
        -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "time":
        if fn.attr in _WALL_FNS:
            return "wall"
        if fn.attr in _MONO_FNS:
            return "mono"
    if isinstance(fn, ast.Name):
        return time_imports.get(fn.id)
    return None


def _expr_domain(expr: ast.expr, env: Dict[str, Optional[str]],
                 attr_domains: Dict[str, Optional[str]],
                 time_imports: Optional[Dict[str, str]] = None,
                 violations: Optional[List[ast.AST]] = None) \
        -> Optional[str]:
    """'wall' / 'mono' / None for an expression; mixing inside a BinOp
    is appended to ``violations``."""
    time_imports = time_imports or {}
    if isinstance(expr, ast.Call):
        return _call_domain(expr, time_imports)
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    attr = _self_attr(expr)
    if attr is not None:
        return attr_domains.get(attr)
    if isinstance(expr, ast.BinOp) and \
            isinstance(expr.op, (ast.Add, ast.Sub)):
        d1 = _expr_domain(expr.left, env, attr_domains, time_imports,
                         violations)
        d2 = _expr_domain(expr.right, env, attr_domains, time_imports,
                         violations)
        if {d1, d2} == {"wall", "mono"}:
            if violations is not None:
                violations.append(expr)
            return None
        if isinstance(expr.op, ast.Sub) and d1 == d2 and d1 is not None:
            return None        # t1 - t0: a duration, domain-free
        return d1 or d2        # deadline arithmetic: t0 + 5 stays t0's
    return None


def _check_clocks(func: ast.AST, qname: str, path: str,
                  attr_domains: Dict[str, Optional[str]],
                  time_imports: Dict[str, str]) -> List[Finding]:
    """Flow-insensitive per-function pass: type the locals from their
    assignments (conflicts degrade to None), then convict any BinOp or
    Compare that puts a wall value against a monotonic one."""
    env: Dict[str, Optional[str]] = {}
    # the env pass is flow-insensitive, so derived assignments
    # (``deadline = t0 + 5``) may be visited before their sources —
    # iterate to the (tiny) fixpoint instead of relying on visit order
    changed = True
    while changed:
        changed = False
        for node in _iter_own(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                dom = _expr_domain(node.value, env, attr_domains,
                                   time_imports)
                name = node.targets[0].id
                if dom is not None:
                    new = dom if env.get(name, dom) == dom else None
                    if env.get(name, "?") != new:
                        env[name] = new
                        changed = True
    findings: List[Finding] = []
    seen: Set[int] = set()

    def convict(node: ast.AST, d1: str, d2: str):
        if node.lineno in seen:
            return
        seen.add(node.lineno)
        findings.append(Finding(
            "HVD404", path, node.lineno, node.col_offset,
            f"{qname}: {d1}-clock value mixed with {d2}-clock value — "
            f"time.time() can step under NTP; derive both sides from "
            f"the same clock (time.monotonic() for spans)"))

    for node in _iter_own(func):
        violations: List[ast.AST] = []
        if isinstance(node, ast.Compare):
            doms = [_expr_domain(e, env, attr_domains, time_imports,
                                 violations)
                    for e in [node.left] + node.comparators]
            for a, b in zip(doms, doms[1:]):
                if {a, b} == {"wall", "mono"}:
                    convict(node, a, b)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            _expr_domain(node, env, attr_domains, time_imports, violations)
        for v in violations:
            convict(v, "wall", "mono")
    return findings


# --------------------------------------------------------------------------
# per-function walker with syntactic held sets (pass 2)
# --------------------------------------------------------------------------

class _FuncWalker:
    """Walk one function's statements tracking which locks are held,
    recording blocking sites, call edges, hook invocations, condition
    waits, and shutdown-flag parks.  Nested defs are walked as their
    own graph entries; their direct call sites carry the caller's held
    set into the interprocedural fixpoint, so a nested def handed to a
    ``Thread`` (no call edge) correctly starts bare."""

    def __init__(self, mod: "_Module", qname: str, func: ast.AST,
                 cls: Optional[str]):
        self.mod = mod
        self.qname = qname
        self.func = func
        self.cls = cls
        self.facts = mod.class_facts.get(cls) if cls else None
        self.local_types: Dict[str, str] = {}
        self.hook_aliases: Set[str] = set()
        self.while_depth = 0
        #: flag attrs of every enclosing shutdown-flag while loop
        self.flag_stack: List[FrozenSet[str]] = []
        self._pretype()

    # -- typing --------------------------------------------------------------
    def _pretype(self):
        for node in _iter_own(self.func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = _ctor_type(node.value)
                if t is not None:
                    self.local_types[node.targets[0].id] = t
                src = _self_attr(node.value)
                if src is not None and _hookish(src) and self.facts and \
                        src not in self.mod.defined_methods.get(
                            self.cls or "", set()):
                    self.hook_aliases.add(node.targets[0].id)

    def _recv_type(self, recv: ast.expr) -> Optional[str]:
        attr = _self_attr(recv)
        if attr is not None and self.facts:
            return self.facts.attr_types.get(attr)
        if isinstance(recv, ast.Name):
            t = self.local_types.get(recv.id)
            if t is not None:
                return t
            return self.mod.module_types.get(recv.id)
        return None

    # -- lock labels ---------------------------------------------------------
    def _lock_label(self, expr: ast.expr) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and self.facts and attr in self.facts.locks:
            return f"self.{self.facts.locks[attr]}"
        if isinstance(expr, ast.Name) and expr.id in self.mod.module_locks:
            return expr.id
        return None

    # -- statement walk ------------------------------------------------------
    def walk(self):
        body = getattr(self.func, "body", [])
        self._walk_block(body, frozenset())

    def _walk_block(self, stmts, held: FrozenSet[str]):
        for stmt in stmts:
            held = self._walk_stmt(stmt, held)

    def _walk_stmt(self, stmt: ast.stmt, held: FrozenSet[str]) \
            -> FrozenSet[str]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return held                      # walked as its own entry
        if isinstance(stmt, ast.With):
            acquired = set()
            for item in stmt.items:
                lbl = self._lock_label(item.context_expr)
                if lbl is not None:
                    acquired.add(lbl)
                    self.mod.lock_sites[lbl] = \
                        self.mod.lock_sites.get(lbl, 0) + 1
                self._scan_expr(item.context_expr, held)
            self._walk_block(stmt.body, held | acquired)
            return held
        if isinstance(stmt, (ast.If,)):
            self._scan_expr(stmt.test, held)
            self._walk_block(stmt.body, held)
            self._walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, held)
            flags = self._flag_attrs(stmt.test)
            self.while_depth += 1
            self.flag_stack.append(frozenset(flags))
            self._walk_block(stmt.body, held)
            self.flag_stack.pop()
            self.while_depth -= 1
            self._walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, held)
            self._mark_hook_loop_var(stmt)
            self._walk_block(stmt.body, held)
            self._walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.Try):
            self._walk_block(stmt.body, held)
            for handler in stmt.handlers:
                self._walk_block(handler.body, held)
            self._walk_block(stmt.orelse, held)
            self._walk_block(stmt.finalbody, held)
            return held
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            lbl = self._acq_rel(stmt.value)
            if lbl is not None:
                verb, label = lbl
                if verb == "acquire":
                    self.mod.lock_sites[label] = \
                        self.mod.lock_sites.get(label, 0) + 1
                self._scan_expr(stmt.value, held, skip_block=True)
                return held | {label} if verb == "acquire" \
                    else held - {label}
        for field in ast.iter_child_nodes(stmt):
            if isinstance(field, ast.expr):
                self._scan_expr(field, held)
        return held

    def _acq_rel(self, call: ast.Call) -> Optional[Tuple[str, str]]:
        fn = call.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in ("acquire", "release"):
            lbl = self._lock_label(fn.value)
            if lbl is not None:
                return fn.attr, lbl
        return None

    def _flag_attrs(self, test: ast.expr) -> Set[str]:
        """Self attrs read by a while test — candidate shutdown flags.
        ``self._stop.is_set()`` counts as reading ``_stop``."""
        flags: Set[str] = set()
        for node in ast.walk(test):
            attr = _self_attr(node)
            if attr is not None:
                flags.add(attr)
        return flags

    def _mark_hook_loop_var(self, stmt: ast.For):
        """``for cb in self._hooks...: cb(...)`` — the loop var is a
        user callback."""
        if not isinstance(stmt.target, ast.Name):
            return
        for node in ast.walk(stmt.iter):
            attr = _self_attr(node)
            if attr is not None and _tableish(attr):
                self.hook_aliases.add(stmt.target.id)
                return

    # -- expression scan -----------------------------------------------------
    def _scan_expr(self, expr: ast.expr, held: FrozenSet[str],
                   skip_block: bool = False):
        for node in _iter_own(expr):
            if isinstance(node, ast.Call):
                self._on_call(node, held, skip_block=skip_block)

    def _on_call(self, call: ast.Call, held: FrozenSet[str],
                 skip_block: bool = False):
        fn = call.func
        # call edges into the module graph, with the syntactic held set
        callee = None
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                and self.cls is not None:
            callee = self.mod.graph.resolve_method(self.cls, fn.attr)
        elif isinstance(fn, ast.Name):
            nested = f"{self.qname}.<{fn.id}>"
            if nested in self.mod.graph.functions:
                callee = nested
            elif fn.id in self.mod.graph.functions:
                callee = fn.id
        if callee is not None:
            self.mod.call_edges.append(
                (self.qname, callee, held, call.lineno))
        if not skip_block:
            blk = self._blocking(call)
            if blk is not None:
                self.mod.block_sites.append(
                    (self.qname, held, call.lineno, call.col_offset, blk))
        self._on_cond_wait(call)
        self._on_hook_call(call, held)
        self._on_park(call)

    # -- HVD400 recognizers --------------------------------------------------
    def _blocking(self, call: ast.Call) -> Optional[str]:
        fn = call.func
        name = _call_name(fn)
        if name == "json_request":
            return "json_request() RPC"
        if name == "urlopen":
            return "urlopen()"
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id == "time" and \
                    fn.attr == "sleep":
                return "time.sleep()"
            if isinstance(recv, ast.Name) and recv.id == "subprocess" and \
                    fn.attr in _SUBPROCESS_BLOCKING:
                return f"subprocess.{fn.attr}()"
            if fn.attr == "communicate":
                return "Popen.communicate()"
            if fn.attr in _SOCKET_BLOCKING:
                return f"socket .{fn.attr}()"
            rtype = self._recv_type(recv)
            if fn.attr == "join" and rtype == "thread" and \
                    not _has_timeout(call):
                return "Thread.join()"
            if fn.attr == "wait":
                if rtype == "event" and not _has_timeout(call):
                    return "Event.wait()"
                if rtype == "popen":
                    return "Popen.wait()"
            if fn.attr == "get" and rtype == "queue" and \
                    not _has_timeout(call):
                return "queue.get()"
            if fn.attr in ("connect", "sendall") and rtype == "socket":
                return f"socket .{fn.attr}()"
        elif isinstance(fn, ast.Name):
            if fn.id == "sleep" and \
                    self.mod.time_imports.get("sleep") == "sleep":
                return "time.sleep()"
        return None

    # -- HVD401 --------------------------------------------------------------
    def _on_cond_wait(self, call: ast.Call):
        fn = call.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "wait"):
            return
        if self._recv_type(fn.value) != "condition":
            return
        if _has_timeout(call):
            return               # a bounded wait is an interruptible sleep
        if self.while_depth == 0:
            self.mod.bare_waits.append(
                (self.qname, call.lineno, call.col_offset))

    # -- HVD405 --------------------------------------------------------------
    def _on_hook_call(self, call: ast.Call, held: FrozenSet[str]):
        fn = call.func
        label = None
        attr = _self_attr(fn)
        if attr is not None and _hookish(attr) and \
                attr not in self.mod.defined_methods.get(self.cls or "",
                                                         set()):
            label = f"self.{attr}"
        elif isinstance(fn, ast.Subscript):
            table = _self_attr(fn.value)
            if table is not None and _tableish(table):
                label = f"self.{table}[...]"
        elif isinstance(fn, ast.Name) and fn.id in self.hook_aliases:
            label = fn.id
        if label is not None:
            self.mod.hook_calls.append(
                (self.qname, held, call.lineno, call.col_offset, label))

    # -- HVD406 --------------------------------------------------------------
    def _on_park(self, call: ast.Call):
        if not self.flag_stack or not self.flag_stack[-1]:
            return
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return
        attr = _self_attr(fn.value)
        if attr is None:
            return
        rtype = self.facts.attr_types.get(attr) if self.facts else None
        kind = None
        if fn.attr == "wait" and rtype == "event" and not _has_timeout(call):
            kind = "Event.wait()"
        elif fn.attr == "get" and rtype == "queue" and \
                not _has_timeout(call):
            kind = "Queue.get()"
        elif fn.attr == "acquire" and attr in (self.facts.locks
                                               if self.facts else {}) \
                and not call.args and not call.keywords:
            kind = "lock.acquire()"
        if kind is not None:
            flags = frozenset().union(*self.flag_stack)
            self.mod.parks.append(
                (self.qname, self.cls, call.lineno, call.col_offset,
                 kind, attr, flags))


# --------------------------------------------------------------------------
# module orchestration
# --------------------------------------------------------------------------

class _Module:
    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.graph: ModuleCallGraph = build_graph(tree)
        self.class_facts: Dict[str, _ClassFacts] = {
            name: _ClassFacts(node)
            for name, node in self.graph.classes.items()}
        self.defined_methods: Dict[str, Set[str]] = {
            name: {f.qname.split(".", 1)[1]
                   for f in self.graph.functions.values()
                   if f.cls == name and "." not in f.qname.split(".", 1)[1]}
            for name in self.graph.classes}
        self.module_locks: Set[str] = set()
        self.module_types: Dict[str, str] = {}
        self.time_imports: Dict[str, str] = {}
        self._collect_module_scope(tree)
        # walker output
        self.block_sites: List[Tuple[str, FrozenSet[str], int, int,
                                     str]] = []
        #: lock label -> acquisition-site count (With items + acquire())
        self.lock_sites: Dict[str, int] = {}
        self.call_edges: List[Tuple[str, str, FrozenSet[str], int]] = []
        self.bare_waits: List[Tuple[str, int, int]] = []
        self.hook_calls: List[Tuple[str, FrozenSet[str], int, int,
                                    str]] = []
        self.parks: List[Tuple[str, Optional[str], int, int, str, str,
                               FrozenSet[str]]] = []

    def _collect_module_scope(self, tree: ast.Module):
        for stmt in tree.body:
            if isinstance(stmt, ast.ImportFrom) and stmt.module == "time":
                for alias in stmt.names:
                    name = alias.asname or alias.name
                    if alias.name in _WALL_FNS:
                        self.time_imports[name] = "wall"
                    elif alias.name in _MONO_FNS:
                        self.time_imports[name] = "mono"
                    elif alias.name == "sleep":
                        self.time_imports[name] = "sleep"
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                if _lock_ctor(stmt.value) is not None:
                    self.module_locks.add(stmt.targets[0].id)
                t = _ctor_type(stmt.value)
                if t is not None:
                    self.module_types[stmt.targets[0].id] = t

    # -- interprocedural may-hold fixpoint (HVD400/405) ----------------------
    def entry_held(self) -> Tuple[Dict[str, FrozenSet[str]],
                                  Dict[Tuple[str, str], Tuple[str, int]]]:
        """For each function, the union of lock sets its callers hold at
        their call sites (transitively).  This is a *may*-hold union —
        one locked path to a blocking helper is a hazard even if other
        paths are bare — dual to guarded_by's must-hold intersection."""
        entry: Dict[str, FrozenSet[str]] = {}
        witness: Dict[Tuple[str, str], Tuple[str, int]] = {}
        changed = True
        while changed:
            changed = False
            for caller, callee, held, line in self.call_edges:
                eff = held | entry.get(caller, frozenset())
                cur = entry.get(callee, frozenset())
                if not eff <= cur:
                    entry[callee] = cur | eff
                    for lock in eff - cur:
                        witness.setdefault((callee, lock), (caller, line))
                    changed = True
        return entry, witness


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    mod = _Module(tree, path)
    for qname, info in mod.graph.functions.items():
        _FuncWalker(mod, qname, info.node, info.cls).walk()
    entry, witness = mod.entry_held()
    findings: List[Finding] = []
    findings += _verdict_400(mod, entry, witness)
    findings += _verdict_401(mod)
    edge_attrs = _verdict_407(mod, findings)
    findings += _verdict_402(mod, edge_attrs)
    findings += _verdict_403(mod)
    findings += _verdict_404(mod)
    findings += _verdict_405(mod, entry)
    findings += _verdict_406(mod)
    findings.sort(key=lambda f: (f.line, f.col, f.code))
    return findings


# --------------------------------------------------------------------------
# verdicts
# --------------------------------------------------------------------------

def _fmt_locks(locks) -> str:
    return ", ".join(f"'{x}'" for x in sorted(locks))


def _verdict_400(mod, entry, witness) -> List[Finding]:
    out = []
    for qname, held, line, col, desc in mod.block_sites:
        ambient = entry.get(qname, frozenset())
        # a lock with a single acquisition site is a serialization
        # mutex: only identical operations queue behind it, and that
        # stall is the design (controller._round_lock) — the tail
        # hazard needs a second site that can stall behind this one
        eff = {lk for lk in held | ambient
               if mod.lock_sites.get(lk, 0) >= 2}
        if not eff:
            continue
        via = ""
        for lock in sorted(eff - held):
            w = witness.get((qname, lock))
            if w is not None:
                via = f" (reached from {w[0]}:{w[1]}, which holds it)"
                break
        out.append(Finding(
            "HVD400", mod.path, line, col,
            f"{qname}: blocking {desc} while holding "
            f"{_fmt_locks(eff)}{via} — every other thread needing the "
            f"lock stalls for the full wait; move the call outside the "
            f"critical section"))
    return out


def _verdict_401(mod) -> List[Finding]:
    return [Finding(
        "HVD401", mod.path, line, col,
        f"{qname}: Condition.wait() outside a while-predicate loop — "
        f"spurious wakeups and stolen notifications return with the "
        f"predicate still false; use `while not pred(): cv.wait()`")
        for qname, line, col in mod.bare_waits]


def _verdict_402(mod, edge_attrs: Set[Tuple[str, str]]) -> List[Finding]:
    out = []
    for cls, facts in mod.class_facts.items():
        roots = mod.graph.thread_roots(cls)
        if not roots:
            continue          # not provably long-lived in this module
        reach: Set[str] = set()
        for r in roots:
            reach |= mod.graph.reachable(r.qname)
        for attr, kind in facts.containers.items():
            if attr in facts.shrunk or attr in facts.reassigned:
                continue
            if (cls, attr) in edge_attrs:
                continue      # HVD407 already owns this attribute
            for method, line, col, _guarded in facts.grow_sites.get(
                    attr, []):
                q = f"{cls}.{method}"
                if q not in reach and not any(
                        r.qname == q for r in roots):
                    continue
                out.append(Finding(
                    "HVD402", mod.path, line, col,
                    f"{cls}.{method}: grows job-lifetime {kind} "
                    f"'self.{attr}' on a thread-root path with no "
                    f"eviction/maxlen/prune anywhere in {cls} — this "
                    f"is unbounded for the life of the job; add an LRU "
                    f"bound, a maxlen, or a prune pass"))
                break         # one finding per attribute is enough
    return out


def _verdict_403(mod) -> List[Finding]:
    out = []
    for cls, facts in mod.class_facts.items():
        for attr, (daemon, line) in facts.threads.items():
            if daemon or attr not in facts.started:
                continue
            if attr in facts.joined:
                continue
            out.append(Finding(
                "HVD403", mod.path, line, 0,
                f"{cls}: non-daemon thread 'self.{attr}' is started but "
                f"no method of {cls} ever joins it — interpreter "
                f"shutdown blocks on it forever; join it on the "
                f"close/stop path or mark it daemon=True"))
    # local fire-and-forget: threading.Thread(...).start() inline with
    # no daemon=True — never joinable at all
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "start" and \
                isinstance(node.func.value, ast.Call) and \
                _call_name(node.func.value.func) == "Thread":
            ctor = node.func.value
            daemon = any(kw.arg == "daemon" and
                         isinstance(kw.value, ast.Constant) and
                         kw.value.value is True for kw in ctor.keywords)
            if not daemon:
                out.append(Finding(
                    "HVD403", mod.path, node.lineno, node.col_offset,
                    "fire-and-forget non-daemon thread: "
                    "Thread(...).start() inline keeps no handle, so "
                    "nothing can ever join it and shutdown hangs on "
                    "it; keep the handle and join, or pass daemon=True"))
    return out


def _verdict_404(mod) -> List[Finding]:
    out = []
    for qname, info in mod.graph.functions.items():
        attr_domains = mod.class_facts[info.cls].attr_domains \
            if info.cls in mod.class_facts else {}
        out += _check_clocks(info.node, qname, mod.path, attr_domains,
                             mod.time_imports)
    return out


def _verdict_405(mod, entry) -> List[Finding]:
    out = []
    for qname, held, line, col, label in mod.hook_calls:
        eff = held | entry.get(qname, frozenset())
        if not eff:
            continue
        out.append(Finding(
            "HVD405", mod.path, line, col,
            f"{qname}: user callback {label} invoked while holding "
            f"{_fmt_locks(eff)} — a callback that re-enters the API "
            f"deadlocks on the lock the framework still holds; snapshot "
            f"under the lock, invoke after releasing it"))
    return out


def _verdict_406(mod) -> List[Finding]:
    out = []
    for qname, cls, line, col, kind, attr, flags in mod.parks:
        facts = mod.class_facts.get(cls or "")
        if facts is None:
            continue
        # is the park parked *on* the flag itself?  then flipping the
        # flag (Event.set) IS the wakeup — nothing to convict.
        if attr in flags:
            continue
        writers = [m for m, written in facts.flag_writes.items()
                   if written & flags and m != "__init__"]
        if not writers:
            continue          # flag not stop-controlled in this module
        if any(attr in facts.signals.get(m, set()) for m in writers):
            continue          # stop path signals the parked primitive
        out.append(Finding(
            "HVD406", mod.path, line, col,
            f"{qname}: {kind} on 'self.{attr}' parks a loop that "
            f"'{_fmt_locks(flags)}' is supposed to stop, but "
            f"{', '.join(sorted(set(writers)))} only flips the flag — "
            f"the loop never wakes to see it; signal the primitive "
            f"(put a sentinel / set the event) or wait with a timeout"))
    return out


def _verdict_407(mod, findings: List[Finding]) -> Set[Tuple[str, str]]:
    """Returns the (cls, attr) pairs convicted, so HVD402 skips them."""
    owned: Set[Tuple[str, str]] = set()
    for cls, facts in mod.class_facts.items():
        for attr, sites in facts.grow_sites.items():
            guarded = [s for s in sites if s[3]]
            if not guarded:
                continue
            if attr in facts.shrunk or attr in facts.reassigned:
                continue
            owned.add((cls, attr))
            method, line, col, _ = guarded[0]
            findings.append(Finding(
                "HVD407", mod.path, line, col,
                f"{cls}.{method}: edge-trigger state 'self.{attr}' is "
                f"set on fire (membership-guarded add) but no path in "
                f"{cls} ever clears it — the trigger fires at most once "
                f"per process and the set leaks besides; clear the key "
                f"when the condition recovers, or bound it with an LRU"))
    return owned
