"""Engine 1: AST rules over user training scripts (HVD001–HVD006).

Counterpart: ``horovod_tpu/analysis/user_rules.py``, pointed at the port.
The hazard taxonomy is the classic Horovod one (deadlock from
rank-conditional collectives, divergence from a missing initial
broadcast, order divergence from unordered submission).  Every check is
syntactic and conservative: we only flag a call when the receiver
provably resolves to a horovod module alias (``import horovod_tpu_torch
as hvd``, ``from horovod_tpu_torch import ...``), so ``"".join(...)`` or
``thread.join()`` can never trip the ``join`` rule.

HVD006 keeps its meaning (the eager engine API under a trace): the
port's tracing entry points, ``torch.compile``, ``torch.jit.script`` /
``trace`` / ``trace_module``, ``torch.cuda.make_graphed_callables`` and
the body of a ``with torch.cuda.graph(...)`` capture, take the place of
the JAX package's ``jit`` / ``pmap`` / ``shard_map``.  Each counts only
when its name resolves to an alias of ``torch`` (``@numba.jit`` or a
foreign ``compile`` never matches), as the JAX rule is gated on ``jax``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .report import Finding

# Names that submit (or gate on) a negotiated collective.  synchronize()
# is deliberately absent: it blocks locally on an already-submitted
# handle, which is rank-conditionally safe (it is still HVD006 in jit).
COLLECTIVES: Dict[str, str] = {}
for _base in ("allreduce", "allgather", "broadcast", "alltoall",
              "reducescatter"):
    for _variant in ("{b}", "{b}_", "{b}_async", "{b}_async_",
                     "grouped_{b}", "grouped_{b}_",
                     "grouped_{b}_async", "grouped_{b}_async_"):
        COLLECTIVES[_variant.format(b=_base)] = _base
COLLECTIVES.update({
    "allgather_object": "allgather",
    "broadcast_object": "broadcast",
    "broadcast_parameters": "broadcast",
    "broadcast_variables": "broadcast",
    "broadcast_optimizer_state": "broadcast",
    "barrier": "barrier",
    "join": "join",
})

GROUPED = frozenset(n for n in COLLECTIVES if n.startswith("grouped_"))
RANK_FNS = frozenset({"rank", "local_rank", "cross_rank"})
# Calls that establish the initial-state sync HVD002 looks for.
SYNC_MARKERS = frozenset({
    "broadcast_parameters", "broadcast_variables",
    "broadcast_optimizer_state", "broadcast_object", "broadcast",
    "broadcast_async", "BroadcastGlobalVariablesCallback",
    # elastic state objects restore/sync on commit — an elastic script
    # has its initial-state story covered by the State machinery
    "ArrayState", "TorchState", "TFState", "State",
})
DIST_WRAPPERS = frozenset({"DistributedOptimizer", "DistributedGradientTape"})
# torch tracing entry points (dotted, alias-resolved): the eager engine
# API must not run under these
TRACE_WRAPPERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.jit.trace_module", "torch.cuda.make_graphed_callables",
})
# context managers whose body is captured into a graph, not run
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})
# Blocking handle operations (local, but fatal under tracing).
HANDLE_SYNC = frozenset({"synchronize", "wait"})


@dataclasses.dataclass
class _Ctx:
    """Lexical context threaded through the statement walk."""
    rank_line: Optional[int] = None      # innermost rank-conditional branch
    except_line: Optional[int] = None    # innermost except handler
    in_jit: bool = False                 # under a torch trace/capture
    func: Optional[dict] = None          # per-function mutable state

    def replace(self, **kw) -> "_Ctx":
        return dataclasses.replace(self, **kw)


class UserScriptChecker:
    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.findings: List[Finding] = []
        self.hvd_aliases: Set[str] = set()
        self.bare_collectives: Dict[str, str] = {}  # local name -> attr
        self.bare_rank_fns: Set[str] = set()
        self.bare_init_fns: Set[str] = set()
        # names bound to torch (or its submodules), by the dotted module
        # they stand for: trace detection is gated on them so
        # @numba.jit / @tf.function never match
        self.torch_aliases: Dict[str, str] = {}
        self.bare_jit_fns: Set[str] = set()
        self.bare_capture_fns: Set[str] = set()
        self.rank_vars: Set[str] = set()
        self.jit_wrapped_funcs: Set[str] = set()
        # HVD005 bookkeeping: name literal -> (base_op, op_repr, line)
        self._name_sigs: Dict[str, Tuple[str, Optional[str], int]] = {}
        # HVD002 bookkeeping
        self._init_call: Optional[ast.Call] = None
        self._dist_opt_call: Optional[ast.Call] = None
        self._has_sync_marker = False
        # relative imports only count as horovod-ish when analyzing the
        # package itself; user scripts' own relative modules stay inert
        self._trust_relative = "horovod_tpu" in path.replace("\\", "/")
        # one-level interprocedural view: module-level helpers that
        # directly submit a collective.  name -> (base op, def line)
        self.helper_collectives: Dict[str, Tuple[str, int]] = {}

    # -- pre-passes ----------------------------------------------------------
    def _collect_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    top = a.name.split(".")[0]
                    if top.startswith("horovod"):
                        self.hvd_aliases.add(a.asname or top)
                    elif top == "torch":
                        # ``import torch.jit`` binds ``torch``;
                        # ``import torch.jit as tj`` binds the submodule
                        if a.asname:
                            self.torch_aliases[a.asname] = a.name
                        else:
                            self.torch_aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "torch" or mod.startswith("torch."):
                    for a in node.names:
                        bound = a.asname or a.name
                        dotted = f"{mod}.{a.name}"
                        if dotted in TRACE_WRAPPERS:
                            self.bare_jit_fns.add(bound)
                        elif dotted in CAPTURE_CONTEXTS:
                            self.bare_capture_fns.add(bound)
                        else:
                            self.torch_aliases[bound] = dotted
                    continue
                hvdish = (mod.startswith("horovod")
                          or (node.level > 0 and self._trust_relative))
                if not hvdish:
                    continue
                for a in node.names:
                    bound = a.asname or a.name
                    if a.name in COLLECTIVES:
                        self.bare_collectives[bound] = a.name
                    elif a.name in RANK_FNS:
                        self.bare_rank_fns.add(bound)
                    elif a.name == "init":
                        self.bare_init_fns.add(bound)
                    else:
                        # submodule / helper object (hvd.torch, runtime,
                        # api, ...): treat as a module alias so
                        # ``runtime.rank()`` and ``api.barrier()`` resolve
                        self.hvd_aliases.add(bound)

    def _collect_rank_vars(self):
        # Simple flow: ``r = hvd.rank()`` (and zipped tuple assignments)
        # makes ``r`` rank-dependent for the whole module.  Scope-blind,
        # which is fine for a linter: a shadowed ``r`` merely over-warns.
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if (isinstance(target, ast.Tuple)
                        and isinstance(node.value, ast.Tuple)
                        and len(target.elts) == len(node.value.elts)):
                    for t, v in zip(target.elts, node.value.elts):
                        if isinstance(t, ast.Name) and self._is_rank_expr(v):
                            self.rank_vars.add(t.id)
                elif isinstance(target, ast.Name) \
                        and self._is_rank_expr(node.value):
                    self.rank_vars.add(target.id)

    def _collect_helpers(self):
        """Module-level functions that directly submit a collective —
        HVD001/003/006 see through ONE level of these: calling such a
        helper inside a rank branch / except handler / jit trace is the
        same hazard as calling the collective there directly.  Nested
        defs/lambdas are skipped: a factory that merely *defines* a
        collective-bearing closure submits nothing when called."""
        def own_calls(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    yield child
                yield from own_calls(child)

        for node in self.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in own_calls(node):
                coll = self._collective_name(call)
                if coll is not None:
                    self.helper_collectives[node.name] = (
                        COLLECTIVES[coll], node.lineno)
                    break

    def _collect_jit_wrapped(self):
        # functions passed positionally into torch.compile(f) /
        # torch.jit.trace(f, ...)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self._is_jit_wrapper(node.func):
                for a in node.args[:1]:
                    if isinstance(a, ast.Name):
                        self.jit_wrapped_funcs.add(a.id)

    # -- predicates ----------------------------------------------------------
    def _is_hvd(self, node: ast.expr) -> bool:
        return isinstance(node, ast.Name) and node.id in self.hvd_aliases

    def _hvd_rooted(self, fn: ast.expr) -> bool:
        """Does this call target provably live in the horovod package?
        (``hvd.x``, ``hvd.elastic.x``, or a name imported from it.)"""
        if isinstance(fn, ast.Attribute):
            root = fn.value
            while isinstance(root, ast.Attribute):
                root = root.value
            return isinstance(root, ast.Name) \
                and root.id in self.hvd_aliases
        if isinstance(fn, ast.Name):
            return (fn.id in self.hvd_aliases
                    or fn.id in self.bare_collectives
                    or fn.id in self.bare_init_fns)
        return False

    def _collective_name(self, call: ast.Call) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in COLLECTIVES \
                and self._is_hvd(fn.value):
            return fn.attr
        if isinstance(fn, ast.Name) and fn.id in self.bare_collectives:
            return self.bare_collectives[fn.id]
        return None

    def _is_rank_expr(self, node: ast.expr) -> bool:
        """True when the expression's value depends on this process's rank."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = sub.func
                if isinstance(fn, ast.Attribute) and fn.attr in RANK_FNS \
                        and self._is_hvd(fn.value):
                    return True
                if isinstance(fn, ast.Name) and fn.id in self.bare_rank_fns:
                    return True
            elif isinstance(sub, ast.Name) and sub.id in self.rank_vars:
                return True
        return False

    def _torch_dotted(self, fn: ast.expr) -> Optional[str]:
        """``a.b.c`` resolved through the torch alias map (None when its
        root is not bound to torch)."""
        parts: List[str] = []
        while isinstance(fn, ast.Attribute):
            parts.append(fn.attr)
            fn = fn.value
        if not isinstance(fn, ast.Name) or fn.id not in self.torch_aliases:
            return None
        return ".".join([self.torch_aliases[fn.id]] + parts[::-1])

    def _is_jit_wrapper(self, fn: ast.expr) -> bool:
        # only torch tracing counts: numba.jit / tf.function compile the
        # python body, where the eager engine API works fine
        if isinstance(fn, ast.Attribute):
            return self._torch_dotted(fn) in TRACE_WRAPPERS
        if isinstance(fn, ast.Name):
            return fn.id in self.bare_jit_fns
        return False

    def _is_capture(self, expr: ast.expr) -> bool:
        """``torch.cuda.graph(g)`` (or its bare import) as a ``with``
        item: its body is captured, not run."""
        if not isinstance(expr, ast.Call):
            return False
        fn = expr.func
        if isinstance(fn, ast.Attribute):
            return self._torch_dotted(fn) in CAPTURE_CONTEXTS
        return isinstance(fn, ast.Name) and fn.id in self.bare_capture_fns

    def _is_jit_decorator(self, dec: ast.expr) -> bool:
        # @torch.compile / @compile / @partial(torch.compile, ...) /
        # @torch.compile(...)
        if self._is_jit_wrapper(dec):
            return True
        if isinstance(dec, ast.Call):
            if self._is_jit_wrapper(dec.func):
                return True
            fn = dec.func
            partial = (isinstance(fn, ast.Name) and fn.id == "partial") or \
                (isinstance(fn, ast.Attribute) and fn.attr == "partial")
            if partial and dec.args \
                    and self._is_jit_wrapper(dec.args[0]):
                return True
        return False

    def _is_unordered(self, node: ast.expr) -> bool:
        """Does iterating this expression yield a cross-process-unstable
        order?  (set/frozenset literals, comprehensions over them, ...)"""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self._is_unordered(node.generators[0].iter)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                if fn.id in ("set", "frozenset"):
                    return True
                if fn.id == "sorted":
                    return False  # sorted() restores a total order
                if fn.id in ("list", "tuple", "reversed"):
                    return bool(node.args) and self._is_unordered(node.args[0])
        return False

    # -- the walk ------------------------------------------------------------
    def run(self) -> List[Finding]:
        self._collect_imports()
        self._collect_helpers()
        self._collect_rank_vars()
        self._collect_jit_wrapped()
        self._walk_stmts(self.tree.body, _Ctx(func={"divergent": None}))
        self._check_hvd002()
        return self.findings

    def _add(self, code: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            code=code, path=self.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message))

    def _walk_stmts(self, stmts, ctx: _Ctx):
        for stmt in stmts:
            self._walk_stmt(stmt, ctx)

    def _walk_stmt(self, stmt: ast.stmt, ctx: _Ctx):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            jit = (ctx.in_jit
                   or stmt.name in self.jit_wrapped_funcs
                   or any(self._is_jit_decorator(d)
                          for d in stmt.decorator_list))
            for d in stmt.decorator_list:
                self._scan_expr(d, ctx)
            self._walk_stmts(stmt.body, ctx.replace(
                in_jit=jit, func={"divergent": None}))
            return
        if isinstance(stmt, ast.ClassDef):
            self._walk_stmts(stmt.body, ctx)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(stmt.test, ctx)
            rank = self._is_rank_expr(stmt.test)
            sub = ctx.replace(rank_line=stmt.lineno) if rank else ctx
            loop = isinstance(stmt, ast.While)
            saved_loop_exit = (ctx.func.get("divergent_loop")
                               if loop and ctx.func is not None else None)
            self._walk_stmts(stmt.body, sub)
            self._walk_stmts(stmt.orelse, sub)
            if loop and ctx.func is not None:
                # break/continue inside this while exit THIS loop only:
                # code after it is reached by every rank
                ctx.func["divergent_loop"] = saved_loop_exit
            if rank and ctx.func is not None \
                    and ctx.func["divergent"] is None:
                # a rank-conditional branch that can leave the function
                # makes everything after it rank-divergent (HVD003); one
                # that can only leave the LOOP ITERATION (break/continue)
                # taints the rest of the enclosing loop body, never the
                # code after the loop
                if any(isinstance(s, (ast.Return, ast.Raise))
                       for s in stmt.body + stmt.orelse):
                    ctx.func["divergent"] = stmt.lineno
                elif not loop and ctx.func.get("divergent_loop") is None \
                        and any(isinstance(s, (ast.Break, ast.Continue))
                                for s in stmt.body + stmt.orelse):
                    ctx.func["divergent_loop"] = stmt.lineno
            return
        if isinstance(stmt, ast.Try):
            self._walk_stmts(stmt.body, ctx)
            for handler in stmt.handlers:
                self._walk_stmts(handler.body,
                                 ctx.replace(except_line=handler.lineno))
            self._walk_stmts(stmt.orelse, ctx)
            self._walk_stmts(stmt.finalbody, ctx)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, ctx)
            saved_loop_exit = (ctx.func.get("divergent_loop")
                               if ctx.func is not None else None)
            self._walk_stmts(stmt.body, ctx)
            self._walk_stmts(stmt.orelse, ctx)
            if ctx.func is not None:
                ctx.func["divergent_loop"] = saved_loop_exit
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr, ctx)
            if any(self._is_capture(item.context_expr)
                   for item in stmt.items):
                ctx = ctx.replace(in_jit=True)
            self._walk_stmts(stmt.body, ctx)
            return
        if isinstance(stmt, ast.Match):
            # match on a rank-dependent subject is a rank-conditional
            # branch, same as `if` on one
            self._scan_expr(stmt.subject, ctx)
            rank = self._is_rank_expr(stmt.subject)
            sub = ctx.replace(rank_line=stmt.lineno) if rank else ctx
            for case in stmt.cases:
                if case.guard is not None:
                    self._scan_expr(case.guard, sub)
                body_ctx = sub
                if not rank and case.guard is not None \
                        and self._is_rank_expr(case.guard):
                    body_ctx = ctx.replace(rank_line=case.pattern.lineno)
                self._walk_stmts(case.body, body_ctx)
            return
        # leaf statements: scan the contained expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan_expr(child, ctx)

    def _scan_expr(self, node: ast.expr, ctx: _Ctx):
        if isinstance(node, ast.IfExp):
            self._scan_expr(node.test, ctx)
            sub = (ctx.replace(rank_line=node.lineno)
                   if self._is_rank_expr(node.test) else ctx)
            self._scan_expr(node.body, sub)
            self._scan_expr(node.orelse, sub)
            return
        if isinstance(node, ast.Call):
            self._check_call(node, ctx)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword, ast.comprehension)):
                if isinstance(child, ast.keyword):
                    self._scan_expr(child.value, ctx)
                elif isinstance(child, ast.comprehension):
                    self._scan_expr(child.iter, ctx)
                    for cond in child.ifs:
                        self._scan_expr(cond, ctx)
                else:
                    self._scan_expr(child, ctx)

    # -- per-call rules ------------------------------------------------------
    def _check_call(self, call: ast.Call, ctx: _Ctx):
        fn = call.func
        callname = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)

        # HVD002 state only moves on provably-horovod calls: an
        # unrelated udp_sock.broadcast() or foreign State() must neither
        # satisfy nor trigger the rule
        if callname in DIST_WRAPPERS and self._dist_opt_call is None \
                and self._hvd_rooted(fn):
            self._dist_opt_call = call
        if callname in SYNC_MARKERS and self._hvd_rooted(fn):
            self._has_sync_marker = True
        if self._init_call is None and callname == "init" and (
                (isinstance(fn, ast.Attribute) and self._is_hvd(fn.value))
                or (isinstance(fn, ast.Name)
                    and fn.id in self.bare_init_fns)):
            self._init_call = call

        # generic .wait()/.synchronize() receivers can't be proven to be
        # horovod handles, so this only applies in modules that import
        # horovod at all — never to unrelated torch code
        if ctx.in_jit and callname in HANDLE_SYNC \
                and isinstance(fn, ast.Attribute) \
                and (self.hvd_aliases or self.bare_collectives):
            self._add("HVD006", call,
                      f"blocking .{callname}() inside a torch-traced (compiled "
                      f"or graph-captured) function; the trace cannot await "
                      f"a host-side handle")

        coll = self._collective_name(call)
        if coll is None:
            if isinstance(fn, ast.Name) and fn.id in self.helper_collectives:
                self._check_helper_call(call, fn.id, ctx)
            return

        if ctx.rank_line is not None:
            self._add("HVD001", call,
                      f"collective '{coll}' submitted inside a branch "
                      f"conditioned on the process rank (branch at line "
                      f"{ctx.rank_line}); ranks skipping the branch never "
                      f"submit it and the others deadlock")
        if ctx.except_line is not None:
            self._add("HVD003", call,
                      f"collective '{coll}' inside an except handler "
                      f"(line {ctx.except_line}); an exception raised on a "
                      f"subset of ranks strands the rest")
        elif ctx.func is not None and self._divergent_line(ctx) is not None:
            self._add("HVD003", call,
                      f"collective '{coll}' after a rank-conditional "
                      f"early exit (line {self._divergent_line(ctx)}); only "
                      f"the ranks that did not exit reach this call")
        if ctx.in_jit:
            self._add("HVD006", call,
                      f"eager collective '{coll}' inside a torch-traced "
                      f"(compiled or graph-captured) function; it blocks on "
                      f"the background engine under tracing — use the "
                      f"in-step form (hvd.{COLLECTIVES[coll]}_p)")
        if coll in GROUPED and call.args \
                and self._is_unordered(call.args[0]):
            self._add("HVD004", call,
                      f"grouped collective '{coll}' fed from an "
                      f"unordered set iteration; member order can differ "
                      f"across processes, diverging the fusion plan")
        self._check_hvd005(call, COLLECTIVES[coll])

    @staticmethod
    def _divergent_line(ctx: _Ctx):
        """Line of the rank-divergent exit governing this point: a
        function-leaving one (return/raise — taints the rest of the
        function), else a loop-iteration-leaving one (break/continue —
        taints only the rest of the enclosing loop body)."""
        if ctx.func is None:
            return None
        if ctx.func["divergent"] is not None:
            return ctx.func["divergent"]
        return ctx.func.get("divergent_loop")

    def _check_helper_call(self, call: ast.Call, name: str, ctx: _Ctx):
        """HVD001/003/006 through one helper level: ``name`` is a
        module-level function that directly submits a collective."""
        base_op, def_line = self.helper_collectives[name]
        via = (f"via helper '{name}' (line {def_line}), which submits "
               f"'{base_op}'")
        if ctx.rank_line is not None:
            self._add("HVD001", call,
                      f"collective submitted {via}, inside a branch "
                      f"conditioned on the process rank (branch at line "
                      f"{ctx.rank_line}); ranks skipping the branch never "
                      f"submit it and the others deadlock")
        if ctx.except_line is not None:
            self._add("HVD003", call,
                      f"collective submitted {via}, inside an except "
                      f"handler (line {ctx.except_line}); an exception "
                      f"raised on a subset of ranks strands the rest")
        elif ctx.func is not None and self._divergent_line(ctx) is not None:
            self._add("HVD003", call,
                      f"collective submitted {via}, after a "
                      f"rank-conditional early exit (line "
                      f"{self._divergent_line(ctx)}); only the ranks that "
                      f"did not exit reach this call")
        if ctx.in_jit:
            self._add("HVD006", call,
                      f"eager collective submitted {via}, inside a "
                      f"torch-traced function; it blocks on the background "
                      f"engine under tracing — use the in-step form "
                      f"(hvd.{base_op}_p)")

    def _check_hvd005(self, call: ast.Call, base_op: str):
        name = None
        op_repr: Optional[str] = None
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                name = kw.value.value
            elif kw.arg == "op":
                op_repr = ast.unparse(kw.value)
            elif kw.arg == "average":
                op_repr = f"average={ast.unparse(kw.value)}"
        if name is None:
            return
        sig = (base_op, op_repr)
        prev = self._name_sigs.get(name)
        if prev is None:
            self._name_sigs[name] = (base_op, op_repr, call.lineno)
        elif (prev[0], prev[1]) != sig:
            self._add("HVD005", call,
                      f"tensor name '{name}' reused with a different "
                      f"signature: {prev[0]}/op={prev[1]} at line {prev[2]} "
                      f"vs {base_op}/op={op_repr} here; negotiation matches "
                      f"by name and would pair incompatible requests")

    def _check_hvd002(self):
        if self._init_call is None or self._dist_opt_call is None:
            return
        if self._has_sync_marker:
            return
        self._add("HVD002", self._dist_opt_call,
                  "DistributedOptimizer is used but no initial-state "
                  "broadcast (broadcast_parameters / broadcast_object / "
                  "elastic State) follows hvd.init(); differently-seeded "
                  "workers silently train diverging replicas")


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    return UserScriptChecker(tree, path).run()
