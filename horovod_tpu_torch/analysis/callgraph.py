"""Intra-module call graph with thread-entry-point detection.

Counterpart: ``horovod_tpu/analysis/callgraph.py``.

The guarded-by engine (``guarded_by.py``) and the one-level helper
expansion in the user rules both need the same structural facts about a
module: which functions exist (module functions, methods, nested defs),
who calls whom, and which functions are **thread roots** — entry points
that run on a thread other than the one that constructed the object.

Thread roots recognized (the framework's own idioms, all of which appear
in ``ops/engine.py`` / ``elastic/driver.py`` / ``runner/rpc.py``):

* ``threading.Thread(target=X)`` — the classic background loop;
* ``<executor>.submit(X, ...)`` — concurrent.futures style submission;
* **handler tables** — a dict literal mapping names to bound methods
  passed into a constructor-like call (``JsonRpcServer({"result":
  self._handle_result})``): each value runs on an RPC server thread.
  Keyword dict arguments (``get_routes={...}``) count too.

Resolution is deliberately module-local and name-based: ``self.m()``
resolves within the enclosing class (and its same-module bases),
``f()`` resolves to a module-level function, nested defs resolve within
their enclosing function.  Anything else (imported callables, attribute
chains on non-self objects) is outside the graph — a *static under-*
approximation, which is the safe direction for the race detector: a
method we cannot prove thread-reachable produces no finding.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

#: Attribute-call names that submit work to another thread.
_SUBMIT_NAMES = frozenset({"submit"})


@dataclasses.dataclass
class FuncInfo:
    """One function/method/nested-def node in the graph."""
    qname: str                      # "f", "Cls.m", "Cls.m.<nested>"
    node: ast.AST
    cls: Optional[str] = None       # owning class name, if a method
    calls: Set[str] = dataclasses.field(default_factory=set)
    #: how this function became a thread root ("" = not a root)
    entry_via: str = ""
    entry_line: int = 0


class ModuleCallGraph:
    """Call graph of one module's AST (build with :func:`build_graph`)."""

    def __init__(self):
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        #: class name -> same-module base class names, nearest first
        self.bases: Dict[str, List[str]] = {}
        #: (cls, line) of each thread-spawning call found in a method —
        #: used by guarded_by's HVD114 (publication before spawn)
        self.spawn_sites: List[Tuple[Optional[str], str, int, str]] = []

    # -- queries -------------------------------------------------------------
    def mro_classes(self, cls: str) -> List[str]:
        """``cls`` plus its same-module ancestors, nearest first."""
        out, queue = [], [cls]
        while queue:
            c = queue.pop(0)
            if c in out or c not in self.classes:
                continue
            out.append(c)
            queue.extend(self.bases.get(c, []))
        return out

    def resolve_method(self, cls: str, name: str) -> Optional[str]:
        """Qualified name of ``self.<name>`` seen from class ``cls``."""
        for c in self.mro_classes(cls):
            q = f"{c}.{name}"
            if q in self.functions:
                return q
        return None

    def thread_roots(self, cls: Optional[str] = None) -> List[FuncInfo]:
        """All thread entry points, optionally restricted to methods of
        ``cls`` (including same-module bases)."""
        roots = [f for f in self.functions.values() if f.entry_via]
        if cls is not None:
            wanted = set(self.mro_classes(cls))
            roots = [f for f in roots if f.cls in wanted]
        return roots

    def reachable(self, qname: str) -> Set[str]:
        """Qualified names reachable from ``qname`` (inclusive)."""
        seen: Set[str] = set()
        queue = [qname]
        while queue:
            q = queue.pop()
            if q in seen or q not in self.functions:
                continue
            seen.add(q)
            queue.extend(self.functions[q].calls)
        return seen


def _func_ref(node: ast.expr, cls: Optional[str], enclosing: str,
              graph: ModuleCallGraph) -> Optional[str]:
    """Resolve an expression used as a callable *value* (thread target,
    submit arg, handler-table value) to a graph qname."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self" and cls is not None:
        return graph.resolve_method(cls, node.attr)
    if isinstance(node, ast.Name):
        # nested def in the enclosing function shadows a module function
        if enclosing:
            nested = f"{enclosing}.<{node.id}>"
            if nested in graph.functions:
                return nested
        if node.id in graph.functions:
            return node.id
    return None


def _callee_name(fn: ast.expr) -> Optional[str]:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


class _ScopedVisitor(ast.NodeVisitor):
    """Shared scope bookkeeping for both passes: one qname scheme
    (module ``f``, method ``Cls.m``, nested ``outer.<inner>``), one
    top-level-class-only rule.  Subclasses hook ``on_class`` /
    ``on_func`` — keeping registration (pass 1) and edge resolution
    (pass 2) on exactly the same naming."""

    def __init__(self, graph: ModuleCallGraph):
        self.graph = graph
        self._cls: Optional[str] = None
        self._func: str = ""

    def on_class(self, node: ast.ClassDef):
        pass

    def on_func(self, node, qname: str):
        pass

    def visit_ClassDef(self, node: ast.ClassDef):
        if self._cls is None and not self._func:
            self.on_class(node)
            prev, self._cls = self._cls, node.name
            for stmt in node.body:
                self.visit(stmt)
            self._cls = prev
        # nested classes: opaque to the graph (rare, and under-approx is safe)

    def _enter(self, node):
        if self._func:
            qname = f"{self._func}.<{node.name}>"
        elif self._cls:
            qname = f"{self._cls}.{node.name}"
        else:
            qname = node.name
        self.on_func(node, qname)
        prev, self._func = self._func, qname
        for stmt in node.body:
            self.visit(stmt)
        self._func = prev

    def visit_FunctionDef(self, node):
        self._enter(node)

    def visit_AsyncFunctionDef(self, node):
        self._enter(node)


class _Collector(_ScopedVisitor):
    """Pass 1: register every class and function/method/nested def."""

    def on_class(self, node: ast.ClassDef):
        self.graph.classes[node.name] = node
        self.graph.bases[node.name] = [
            b.id for b in node.bases if isinstance(b, ast.Name)]

    def on_func(self, node, qname: str):
        self.graph.functions[qname] = FuncInfo(
            qname=qname, node=node, cls=self._cls)


class _EdgeVisitor(_ScopedVisitor):
    """Pass 2: call edges + thread-entry registration."""

    def _mark_entry(self, target: ast.expr, via: str, line: int):
        q = _func_ref(target, self._cls, self._func, self.graph)
        if q is not None:
            info = self.graph.functions[q]
            if not info.entry_via:
                info.entry_via, info.entry_line = via, line
            self.graph.spawn_sites.append((self._cls, self._func, line, via))

    def visit_Call(self, node: ast.Call):
        callee = _callee_name(node.func)
        # threading.Thread(target=X) / Thread(target=X)
        if callee == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._mark_entry(kw.value, "thread", node.lineno)
        # <executor>.submit(X, ...)
        elif callee in _SUBMIT_NAMES and isinstance(node.func, ast.Attribute) \
                and node.args:
            self._mark_entry(node.args[0], "executor", node.lineno)
        # handler tables: dict literals with function-ref values passed
        # into any call (JsonRpcServer({...}, get_routes={...}))
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Dict):
                for v in arg.values:
                    if v is not None and _func_ref(
                            v, self._cls, self._func, self.graph):
                        self._mark_entry(v, "handler_table", node.lineno)
        # plain call edges
        if self._func:
            src = self.graph.functions[self._func]
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "self" and self._cls is not None:
                q = self.graph.resolve_method(self._cls, fn.attr)
                if q is not None:
                    src.calls.add(q)
            elif isinstance(fn, ast.Name):
                q = _func_ref(fn, self._cls, self._func, self.graph)
                if q is not None:
                    src.calls.add(q)
        self.generic_visit(node)


def build_graph(tree: ast.Module) -> ModuleCallGraph:
    """Two-pass construction: collect every def, then resolve edges and
    thread entry points (a target can be defined after its spawn site)."""
    graph = ModuleCallGraph()
    collector = _Collector(graph)
    for stmt in tree.body:
        collector.visit(stmt)
    edges = _EdgeVisitor(graph)
    for stmt in tree.body:
        edges.visit(stmt)
    return graph
