"""Engine 4: interprocedural SPMD divergence dataflow (HVD200–HVD205).

Counterpart: ``horovod_tpu/analysis/divergence.py``; the rank sources are
the port's (``hvd.rank()`` and ``torch.distributed.get_rank()`` where the
JAX package reads ``jax.process_index()``).

Every rank of an SPMD job must submit the same collectives, in the same
order, with the same shapes and parameters.  Anything a process can
observe that its peers cannot — its rank, its environment, its clock,
its hostname, an unseeded RNG draw — is a **rank-divergent source**, and
letting such a value steer collective submission is the root cause of
the classic distributed-training deadlock/divergence families.  This
engine tracks divergent values through real dataflow, to a fixed point
over the module call graph (``callgraph.py``), generalizing the
one-helper-level syntactic checks HVD001/003/006 into:

* **HVD200** — a collective (direct, or via any helper chain that
  transitively submits one) under control flow conditioned on a
  divergent value;
* **HVD201** — a collective operand whose *shape* derives from a
  divergent value (``x[:rank]``, ``np.zeros(rank)``): reductions
  require identical shapes on every rank (allgather/alltoall legally
  carry ragged leading dimensions and are exempt);
* **HVD202** — a collective reached only by ranks that did not take an
  earlier divergent early-return/raise;
* **HVD203** — a divergent value published under a *shared* (non-
  rank-qualified) control-plane key: last-writer-wins state the ranks
  do not agree on.  A divergent *key* is the per-rank-namespace idiom
  and stays silent;
* **HVD204** — a divergent collective *parameter* (``name=``,
  ``root_rank=``, ``op=``, ``process_set=``): negotiation matches
  requests by these fields;
* **HVD205** — a collective inside a loop whose trip count is divergent
  (``for _ in range(rank())``): different submission counts per rank.

Dataflow facts per function, iterated to a fixed point:

* ``submits`` — does calling this function (transitively) submit a
  collective, and which base op;
* ``returns_divergent`` — is the return value divergent when called
  with non-divergent arguments (sources inside the body, or calls to
  other divergent-returning functions; a ``return`` *inside* a
  divergent branch is itself divergent — implicit flow).

**Sanitizers:** the result of any recognized collective call is, by
construction, agreed on by every rank — ``broadcast_object(rank())``,
``allreduce(local_stat)`` and friends clear both taints.  Reassignment
from a clean value clears a local's taint.

Static under-approximations, all in the quiet direction: taint does not
flow through object attributes, through function *parameters* at call
sites, or into closures; accesses the analysis cannot resolve are
clean.  The engine shares alias resolution with the user rules, so only
provably-horovod collectives and provably-divergent sources count.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import callgraph
from .report import Finding
from .user_rules import COLLECTIVES, RANK_FNS, UserScriptChecker

#: (module, dotted call) -> human label.  ``*`` matches any attr.
_SOURCE_CALLS: Dict[Tuple[str, str], str] = {}
for _mod, _names, _label in (
        ("os", ("getenv", "getpid"), "an environment/process read"),
        ("os.environ", ("get", "__getitem__", "setdefault"),
         "an environment variable"),
        ("time", ("time", "time_ns", "monotonic", "monotonic_ns",
                  "perf_counter", "perf_counter_ns"), "the wall clock"),
        ("datetime.datetime", ("now", "utcnow", "today"), "the wall clock"),
        ("socket", ("gethostname", "getfqdn"), "the hostname"),
        ("platform", ("node",), "the hostname"),
        ("os", ("uname",), "the hostname"),
        ("random", ("random", "randint", "randrange", "uniform", "choice",
                    "choices", "sample", "shuffle", "getrandbits",
                    "randbytes", "gauss"), "unseeded RNG"),
        ("numpy.random", ("rand", "randn", "randint", "random",
                          "random_sample", "choice", "permutation",
                          "normal", "uniform", "standard_normal"),
         "unseeded RNG"),
        ("uuid", ("uuid1", "uuid4"), "a fresh uuid"),
        ("secrets", ("token_hex", "token_bytes", "token_urlsafe",
                     "randbelow", "choice"), "unseeded RNG"),
):
    for _n in _names:
        _SOURCE_CALLS[(_mod, _n)] = _label

#: torch's own rank reads (the port's counterpart of jax.process_index)
_TORCH_RANK_FNS = frozenset({"torch.distributed.get_rank",
                             "torch.distributed.distributed_c10d.get_rank"})

#: numpy module spellings the alias pre-pass normalizes to "numpy".
_NUMPY_NAMES = {"numpy", "np", "jnp"}  # jnp has no .random module; harmless

#: Ops whose operands must have identical shapes on every rank.
#: allgather/alltoall legally carry ragged leading dims (the eager API
#: pads/exchanges sizes), so shape divergence is only fatal for these.
_SHAPE_STRICT = frozenset({"allreduce", "reducescatter", "broadcast"})

#: Collective kwargs that negotiation matches requests by (HVD204).
_MATCHED_KWARGS = ("name", "root_rank", "op", "process_set", "average")

#: Array constructors whose every positional argument is a dimension.
_SHAPE_ALL_ARGS = frozenset({
    "zeros", "ones", "empty", "arange", "linspace", "eye", "randperm",
})
#: data-first constructors: shape arguments start at position 1.
_SHAPE_TAIL_ARGS = frozenset({
    "tile", "repeat", "reshape", "broadcast_to", "resize", "split",
    "array_split",
})
#: Methods (receiver is the data) whose positional args are dimensions.
_SHAPE_METHODS = frozenset({"reshape", "repeat", "resize", "split",
                            "expand", "view"})
#: Methods that collapse an array to a rank-invariant scalar/shape.
_SHAPE_REDUCERS = frozenset({
    "sum", "mean", "max", "min", "prod", "all", "any", "item", "size",
    "numel", "dim",
})
#: Builtins that produce a scalar: shape taint dies here (the VALUE may
#: still be divergent — ``len()`` of a rank-sharded array is).
_SCALAR_FNS = frozenset({"len", "int", "float", "bool", "str", "max",
                         "min", "sum", "abs", "round"})

#: Control-plane publish sinks: f(key, value) by name, or ``recv.set/put
#: (key, value)`` where the receiver smells like a KV/store client.
_PUBLISH_FNS = frozenset({"key_value_set", "kv_set", "_kv_set"})
_PUBLISH_METHODS = frozenset({"set", "put"})
_PUBLISH_RECV = re.compile(r"kv|store|coord", re.IGNORECASE)


@dataclasses.dataclass
class _Summary:
    """Fixed-point facts for one call-graph function."""
    submits: Optional[str] = None        # base collective op, or None
    submits_via: str = ""                # "" = direct, else callee qname
    returns_divergent: Optional[str] = None   # label, or None


class _Ctx:
    """Mutable per-function walk context (shared down the statement
    walk on purpose: a divergent early exit taints the REST of the
    function, not a lexical subtree)."""

    def __init__(self):
        self.branch: Optional[Tuple[str, int]] = None   # (label, line)
        self.loop: Optional[Tuple[str, int]] = None
        self.exit: Optional[Tuple[str, int]] = None
        #: a divergent break/continue: taints only the rest of the
        #: enclosing LOOP BODY (restored at the loop boundary), never
        #: the code after the loop
        self.loop_exit: Optional[Tuple[str, int]] = None


class DivergenceChecker:
    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.findings: List[Finding] = []
        # alias resolution shared with the user rules: hvd modules,
        # bare collective imports, bare rank fns, module rank vars
        self.usr = UserScriptChecker(tree, path)
        self.usr._collect_imports()
        self.usr._collect_rank_vars()
        self.graph = callgraph.build_graph(tree)
        self.summaries: Dict[str, _Summary] = {
            q: _Summary() for q in self.graph.functions}
        #: import alias -> dotted real module ("np" -> "numpy",
        #: "environ" -> "os.environ", "time" -> "time.time" for
        #: ``from time import time``)
        self.mod_alias: Dict[str, str] = {}
        #: module-level divergent names -> label
        self.module_env: Dict[str, str] = {}
        self._collect_module_aliases()

    # -- import pre-pass -----------------------------------------------------
    def _collect_module_aliases(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.name
                    top = name.split(".")[0]
                    if top in _NUMPY_NAMES:
                        name = "numpy" + name[len(top):]
                    self.mod_alias[a.asname or top] = \
                        name if a.asname else name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                mod = node.module
                top = mod.split(".")[0]
                if top in _NUMPY_NAMES:
                    mod = "numpy" + mod[len(top):]
                for a in node.names:
                    self.mod_alias[a.asname or a.name] = f"{mod}.{a.name}"

    def _dotted(self, node: ast.expr) -> Optional[str]:
        """Resolve ``a.b.c`` through the import alias map to a real
        dotted module path; None when the root is not an import."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.mod_alias.get(node.id)
        if root is None:
            return None
        parts.append(root)
        return ".".join(reversed(parts))

    # -- divergent-source predicates -----------------------------------------
    def _source_label(self, call: ast.Call) -> Optional[str]:
        """Label when ``call`` is a direct divergent source."""
        fn = call.func
        # hvd rank functions (alias-resolved, same as the user rules)
        if isinstance(fn, ast.Attribute) and fn.attr in RANK_FNS \
                and self.usr._is_hvd(fn.value):
            return "the process rank"
        if isinstance(fn, ast.Name) and fn.id in self.usr.bare_rank_fns:
            return "the process rank"
        # torch.distributed.get_rank() (the port's jax.process_index())
        if isinstance(fn, ast.Attribute) and fn.attr == "get_rank" \
                and self.usr._torch_dotted(fn) in _TORCH_RANK_FNS:
            return "the process rank"
        # stdlib/numpy sources through the alias map
        dotted = self._dotted(fn)
        if dotted is not None and "." in dotted:
            mod, attr = dotted.rsplit(".", 1)
            label = _SOURCE_CALLS.get((mod, attr))
            if label is not None:
                return label
            # numpy.random.default_rng() is only divergent UNSEEDED
            if mod == "numpy.random" and attr == "default_rng" \
                    and not call.args and not call.keywords:
                return "unseeded RNG"
        return None

    def _is_environ_read(self, node: ast.Subscript) -> bool:
        return self._dotted(node.value) == "os.environ"

    def _is_sanitizer(self, call: ast.Call) -> bool:
        """Collective results are agreed on by every rank."""
        return self.usr._collective_name(call) is not None

    # -- expression taint ----------------------------------------------------
    def _div(self, node: ast.expr, env: Dict[str, str],
             shape_env: Optional[Dict[str, str]] = None) -> Optional[str]:
        """Label when the expression's VALUE can differ across ranks."""
        shape_env = shape_env if shape_env is not None else {}
        if isinstance(node, ast.Name):
            # NOT the user rules' scope-blind rank_vars: this engine's
            # own env is sanitizer-aware (broadcast_object(rank()) is
            # clean), and falling back would resurrect the taint
            if node.id in env:
                return env[node.id]
            return self.module_env.get(node.id)
        if isinstance(node, ast.Lambda):
            return None              # a value, not an evaluation
        if isinstance(node, ast.Attribute):
            # x.shape / x.ndim of a rank-sharded array is a divergent value
            if node.attr in ("shape", "ndim", "nbytes"):
                label = self._sdiv(node.value, env, shape_env)
                if label:
                    return label
            return self._div(node.value, env, shape_env)
        if isinstance(node, ast.Subscript):
            if self._is_environ_read(node):
                return "an environment variable"
            for child in (node.value, node.slice):
                label = self._div(child, env, shape_env)
                if label:
                    return label
            return None
        if isinstance(node, ast.Call):
            if self._is_sanitizer(node):
                return None          # broadcast/allreduce agree everywhere
            label = self._source_label(node)
            if label:
                return label
            fn = node.func
            # len()/size measurements of a rank-sharded array diverge
            if isinstance(fn, ast.Name) and fn.id == "len" and node.args:
                label = self._sdiv(node.args[0], env, shape_env)
                if label:
                    return label
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in _SHAPE_REDUCERS \
                    and fn.attr in ("size", "numel"):
                label = self._sdiv(fn.value, env, shape_env)
                if label:
                    return label
            callee = self._resolve_callee(node)
            if callee is not None:
                ret = self.summaries[callee].returns_divergent
                if ret:
                    return (f"helper '{_short(callee)}()' "
                            f"(returns {ret})")
            # taint propagates through arguments and the receiver
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.keyword):
                    child = child.value
                if isinstance(child, ast.expr):
                    label = self._div(child, env, shape_env)
                    if label:
                        return label
            return None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.keyword):
                child = child.value
            if isinstance(child, (ast.expr, ast.comprehension)):
                if isinstance(child, ast.comprehension):
                    label = self._div(child.iter, env, shape_env)
                else:
                    label = self._div(child, env, shape_env)
                if label:
                    return label
        return None

    def _sdiv(self, node: ast.expr, env: Dict[str, str],
              shape_env: Dict[str, str]) -> Optional[str]:
        """Label when the expression's SHAPE can differ across ranks.

        Propagation is structural, not blanket: scalar producers
        (``len``, ``float``, reductions) KILL shape taint — the value
        they yield may still diverge, which :meth:`_div` models — and a
        plain (non-slice) subscript follows the index's shape, not the
        receiver's."""
        if isinstance(node, ast.Name):
            return shape_env.get(node.id)
        if isinstance(node, ast.Lambda):
            return None
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Slice):
                # x[a:b:c] with a divergent bound changes the extent.
                # The batch-windowing idiom x[i:i+k] has extent k no
                # matter what i is: when the upper bound is literally
                # ``lower + k``, only k (and the step) can diverge it.
                bounds = [sl.lower, sl.upper, sl.step]
                if sl.lower is not None \
                        and isinstance(sl.upper, ast.BinOp) \
                        and isinstance(sl.upper.op, ast.Add):
                    low = ast.dump(sl.lower)
                    if ast.dump(sl.upper.left) == low:
                        bounds = [sl.upper.right, sl.step]
                    elif ast.dump(sl.upper.right) == low:
                        bounds = [sl.upper.left, sl.step]
                for bound in bounds:
                    if bound is not None:
                        label = self._div(bound, env, shape_env)
                        if label:
                            return label
                if sl.upper is not None:
                    # clean explicit upper bound: the extent is the
                    # bound, not the receiver's (divergent) length —
                    # x[i:i+batch] of a rank-sharded array is batch-sized
                    return None
                # open-ended (x[a:], x[:]) inherits the receiver's extent
                return self._sdiv(node.value, env, shape_env)
            # plain / advanced index: the result's shape follows the
            # INDEX (x[idx] has idx's extent), not the receiver's
            return self._sdiv(sl, env, shape_env)
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name in _SCALAR_FNS and isinstance(fn, ast.Name):
                return None          # scalar: no shape to diverge
            args = list(node.args)
            kwvals = [kw.value for kw in node.keywords
                      if kw.arg in ("shape", "size", "num", "reps",
                                    "repeats", "newshape")]
            shape_args: List[ast.expr] = list(kwvals)
            is_method = isinstance(fn, ast.Attribute) \
                and self._dotted(fn) is None
            if is_method:
                if name in _SHAPE_REDUCERS:
                    return None      # collapses to a rank-invariant shape
                if name in _SHAPE_METHODS:
                    shape_args += args
            elif name in _SHAPE_ALL_ARGS:
                shape_args += args
            elif name == "full":
                shape_args += args[:1]      # args[1] is the fill value
            elif name in _SHAPE_TAIL_ARGS:
                shape_args += args[1:]
            for child in shape_args:
                label = self._div(child, env, shape_env)
                if label:
                    return label
            if is_method:
                # method on a shape-divergent receiver propagates
                label = self._sdiv(fn.value, env, shape_env)
                if label:
                    return label
            for child in args:
                label = self._sdiv(child, env, shape_env)
                if label:
                    return label
            return None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                label = self._sdiv(child, env, shape_env)
                if label:
                    return label
        return None

    # -- call resolution -----------------------------------------------------
    def _resolve_callee(self, call: ast.Call,
                        cls: Optional[str] = None) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in self.graph.functions:
            return fn.id
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "self" and cls is not None:
            return self.graph.resolve_method(cls, fn.attr)
        return None

    # -- fixed point ---------------------------------------------------------
    def _direct_submits(self, qname: str) -> Optional[Tuple[str, int]]:
        """(base op, line) when the function body directly submits a
        collective (nested defs excluded — defining a closure submits
        nothing)."""
        node = self.graph.functions[qname].node

        def own_calls(n):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.Call):
                    yield child
                yield from own_calls(child)

        for call in own_calls(node):
            coll = self.usr._collective_name(call)
            if coll is not None:
                return COLLECTIVES[coll], call.lineno
        return None

    def _fixed_point(self):
        for qname in self.graph.functions:
            direct = self._direct_submits(qname)
            if direct is not None:
                self.summaries[qname].submits = direct[0]
        for _ in range(len(self.graph.functions) + 1):
            changed = False
            for qname, info in self.graph.functions.items():
                s = self.summaries[qname]
                if s.submits is None:
                    for callee in sorted(info.calls):
                        cs = self.summaries.get(callee)
                        if cs is not None and cs.submits is not None:
                            s.submits = cs.submits
                            s.submits_via = callee
                            changed = True
                            break
                if s.returns_divergent is None:
                    label = self._returns_divergent(qname)
                    if label:
                        s.returns_divergent = label
                        changed = True
            if not changed:
                break

    def _returns_divergent(self, qname: str) -> Optional[str]:
        info = self.graph.functions[qname]
        walker = _FnWalker(self, info, emit=False)
        walker.run()
        return walker.returns_divergent

    # -- driver --------------------------------------------------------------
    def _module_env_pass(self):
        """Module-level divergent names: scope-blind, like the user
        rules' rank_vars.  Run once before the fixed point (sources
        assigned at module scope seed the function walks) and once after
        (module assigns from divergent-returning helpers resolve)."""
        mod_walker = _FnWalker(self, None, emit=False)
        mod_walker.walk(self.tree.body)
        self.module_env = dict(mod_walker.env)

    def run(self) -> List[Finding]:
        self._module_env_pass()
        self._fixed_point()
        self._module_env_pass()
        # reporting pass: module level first, then every function
        _FnWalker(self, None, emit=True).walk(self.tree.body)
        for qname, info in self.graph.functions.items():
            _FnWalker(self, info, emit=True).run()
        self.findings.sort(key=lambda f: (f.line, f.col, f.code))
        return self.findings

    def _add(self, code: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            code=code, path=self.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message))


def _short(qname: str) -> str:
    return qname.split(".")[-1].strip("<>")


def _terminal_kind(stmts: Sequence[ast.stmt]) -> Optional[str]:
    """``"func"`` when the branch can leave the function (return/raise),
    ``"loop"`` when it can only leave the current loop iteration
    (break/continue), else None.  The distinction matters: a divergent
    ``continue`` makes some ranks skip the REST OF THE LOOP BODY, but
    every rank still reaches the code after the loop — conflating the
    two falsely convicts post-loop collectives (noise, which this
    engine must never produce)."""
    if any(isinstance(s, (ast.Return, ast.Raise)) for s in stmts):
        return "func"
    if any(isinstance(s, (ast.Break, ast.Continue)) for s in stmts):
        return "loop"
    return None


class _FnWalker:
    """One linear walk over a function (or the module body): tracks the
    local taint environments and the divergence context, and — in emit
    mode — reports HVD200–HVD205 at collective/publish call sites."""

    def __init__(self, checker: DivergenceChecker,
                 info: Optional[callgraph.FuncInfo], emit: bool):
        self.c = checker
        self.info = info
        self.cls = info.cls if info is not None else None
        self.emit = emit
        self.env: Dict[str, str] = {}
        self.shape_env: Dict[str, str] = {}
        self.ctx = _Ctx()
        self.returns_divergent: Optional[str] = None

    def run(self):
        assert self.info is not None
        body = getattr(self.info.node, "body", [])
        self.walk(body)

    # -- statements ----------------------------------------------------------
    def walk(self, stmts: Sequence[ast.stmt]):
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt):
        c = self.c
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return            # walked as its own call-graph function
        if isinstance(stmt, ast.ClassDef):
            return            # methods are their own graph functions
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._assign(stmt)
            return
        if isinstance(stmt, ast.If):
            self._scan(stmt.test)
            label = c._div(stmt.test, self.env, self.shape_env)
            saved = self.ctx.branch
            if label:
                self.ctx.branch = (label, stmt.lineno)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            self.ctx.branch = saved
            if label:
                kind = _terminal_kind(stmt.body + stmt.orelse)
                if kind == "func" and self.ctx.exit is None:
                    self.ctx.exit = (label, stmt.lineno)
                elif kind == "loop" and self.ctx.loop_exit is None:
                    self.ctx.loop_exit = (label, stmt.lineno)
            return
        if isinstance(stmt, ast.While):
            self._scan(stmt.test)
            label = c._div(stmt.test, self.env, self.shape_env)
            saved = self.ctx.loop
            saved_exit = self.ctx.loop_exit
            if label:
                self.ctx.loop = (label, stmt.lineno)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            self.ctx.loop = saved
            self.ctx.loop_exit = saved_exit
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan(stmt.iter)
            label = c._div(stmt.iter, self.env, self.shape_env)
            if label and isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = label
            saved = self.ctx.loop
            saved_exit = self.ctx.loop_exit
            if label:
                self.ctx.loop = (label, stmt.lineno)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            self.ctx.loop = saved
            self.ctx.loop_exit = saved_exit
            return
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body)
            for handler in stmt.handlers:
                self.walk(handler.body)
            self.walk(stmt.orelse)
            self.walk(stmt.finalbody)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan(item.context_expr)
            self.walk(stmt.body)
            return
        if isinstance(stmt, ast.Match):
            self._scan(stmt.subject)
            label = c._div(stmt.subject, self.env, self.shape_env)
            saved = self.ctx.branch
            if label:
                self.ctx.branch = (label, stmt.lineno)
            for case in stmt.cases:
                if case.guard is not None:
                    self._scan(case.guard)
                self.walk(case.body)
            self.ctx.branch = saved
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._scan(stmt.value)
                label = c._div(stmt.value, self.env, self.shape_env)
                if label and self.returns_divergent is None:
                    self.returns_divergent = label
            if self.ctx.branch and self.returns_divergent is None:
                # implicit flow: WHICH return runs depends on the branch
                self.returns_divergent = self.ctx.branch[0]
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan(child)

    def _assign(self, stmt):
        c = self.c
        value = stmt.value
        if value is not None:
            self._scan(value)
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        # zipped tuple assignment taints element-wise: in
        # ``r, n = rank(), size()`` only r is divergent
        if isinstance(stmt, ast.Assign) and len(targets) == 1 \
                and isinstance(targets[0], ast.Tuple) \
                and isinstance(value, ast.Tuple) \
                and len(targets[0].elts) == len(value.elts):
            for t, v in zip(targets[0].elts, value.elts):
                self._assign_one([t], v)
            return
        self._assign_one(targets, value, stmt)

    def _assign_one(self, targets, value, stmt=None):
        c = self.c
        label = c._div(value, self.env, self.shape_env) if value is not None else None
        slabel = (c._sdiv(value, self.env, self.shape_env)
                  if value is not None else None)
        if label is None and self.ctx.branch is not None \
                and value is not None:
            # implicit flow: WHICH value lands here depends on the branch
            label = self.ctx.branch[0]
        if isinstance(stmt, ast.AugAssign):
            t = stmt.target
            if isinstance(t, ast.Name):
                if label:
                    self.env[t.id] = label
                if slabel:
                    self.shape_env[t.id] = slabel
            return
        for t in targets:
            for name_node in self._target_names(t):
                if label:
                    self.env[name_node] = label
                else:
                    self.env.pop(name_node, None)
                if slabel:
                    self.shape_env[name_node] = slabel
                else:
                    self.shape_env.pop(name_node, None)

    @staticmethod
    def _target_names(target: ast.expr) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out = []
            for elt in target.elts:
                out.extend(_FnWalker._target_names(elt))
            return out
        return []

    # -- expressions / call sites --------------------------------------------
    def _scan(self, node: ast.expr):
        if isinstance(node, ast.Call):
            if self.emit:
                self._check_call(node)
        if isinstance(node, ast.Lambda):
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.keyword):
                self._scan(child.value)
            elif isinstance(child, ast.comprehension):
                self._scan(child.iter)
                for cond in child.ifs:
                    self._scan(cond)
            elif isinstance(child, ast.expr):
                self._scan(child)

    def _check_call(self, call: ast.Call):
        c = self.c
        coll = c.usr._collective_name(call)
        via = ""
        base_op = None
        if coll is not None:
            base_op = COLLECTIVES[coll]
        else:
            callee = c._resolve_callee(call, self.cls)
            if callee is not None:
                s = c.summaries[callee]
                if s.submits is not None:
                    base_op = s.submits
                    via = (f" via helper '{_short(callee)}' (line "
                           f"{c.graph.functions[callee].node.lineno}), "
                           f"which transitively submits it,")
        if base_op is not None:
            self._check_collective(call, base_op, via)
            return
        self._check_publish(call)

    def _check_collective(self, call: ast.Call, base_op: str, via: str):
        c = self.c
        if self.ctx.branch is not None:
            label, line = self.ctx.branch
            c._add("HVD200", call,
                   f"collective '{base_op}' submitted{via} inside a "
                   f"branch conditioned on {label} (branch at line "
                   f"{line}); ranks evaluating the condition differently "
                   f"never submit it and the rest deadlock")
        elif self.ctx.exit is not None:
            label, line = self.ctx.exit
            c._add("HVD202", call,
                   f"collective '{base_op}' submitted{via} after an "
                   f"early exit conditioned on {label} (line {line}); "
                   f"ranks that exited never reach this call and the "
                   f"rest block forever")
        elif self.ctx.loop_exit is not None:
            label, line = self.ctx.loop_exit
            c._add("HVD202", call,
                   f"collective '{base_op}' submitted{via} after a "
                   f"break/continue conditioned on {label} (line {line}); "
                   f"ranks that left the iteration submit fewer "
                   f"collectives than their peers expect")
        if self.ctx.loop is not None:
            label, line = self.ctx.loop
            c._add("HVD205", call,
                   f"collective '{base_op}' submitted{via} inside a loop "
                   f"whose trip count depends on {label} (loop at line "
                   f"{line}); ranks iterating fewer times submit fewer "
                   f"collectives than their peers expect")
        # HVD201: shape-divergent operands (direct submissions only —
        # helper operands were shaped at the helper's own site)
        if not via and base_op in _SHAPE_STRICT:
            for arg in call.args:
                slabel = c._sdiv(arg, self.env, self.shape_env)
                if slabel:
                    c._add("HVD201", call,
                           f"operand of '{base_op}' has a shape derived "
                           f"from {slabel}; reductions require "
                           f"identically-shaped operands on every rank, "
                           f"and a mismatched shape diverges the fused "
                           f"buffer layout")
                    break
        # HVD204: divergent matched parameters
        if not via:
            for kw in call.keywords:
                if kw.arg in _MATCHED_KWARGS:
                    label = c._div(kw.value, self.env, self.shape_env)
                    if label:
                        c._add("HVD204", call,
                               f"collective parameter '{kw.arg}=' "
                               f"depends on {label}; negotiation "
                               f"matches requests by this field, so "
                               f"per-rank values pair incompatible "
                               f"submissions")
            if base_op == "broadcast" and len(call.args) >= 2:
                label = c._div(call.args[1], self.env, self.shape_env)
                if label:
                    c._add("HVD204", call,
                           f"broadcast root_rank depends on {label}; "
                           f"every rank must name the SAME root, or N "
                           f"different one-to-all broadcasts are "
                           f"submitted at once")

    def _check_publish(self, call: ast.Call):
        c = self.c
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        is_sink = name in _PUBLISH_FNS
        if not is_sink and name in _PUBLISH_METHODS \
                and isinstance(fn, ast.Attribute):
            recv = fn.value
            recv_name = recv.attr if isinstance(recv, ast.Attribute) \
                else recv.id if isinstance(recv, ast.Name) else ""
            is_sink = bool(_PUBLISH_RECV.search(recv_name))
        if not is_sink or len(call.args) < 2:
            return
        key_expr, val_expr = call.args[0], call.args[1]
        val_label = c._div(val_expr, self.env, self.shape_env)
        if val_label is None:
            return
        if c._div(key_expr, self.env, self.shape_env) is not None:
            return    # rank-qualified key: the per-rank-namespace idiom
        c._add("HVD203", call,
               f"value published under shared control-plane key depends "
               f"on {val_label}; every rank writes its own value to ONE "
               f"key and the survivors read last-writer-wins state they "
               f"do not agree on — qualify the key by rank or broadcast "
               f"the value first")


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    return DivergenceChecker(tree, path).run()
