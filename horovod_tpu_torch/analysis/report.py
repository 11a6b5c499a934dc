"""Finding type, rule catalog, and suppression-comment handling.

Counterpart: ``horovod_tpu/analysis/report.py``.  The rule IDs, titles,
suppression syntax and the Finding layout are the JAX package's; the
fix-its name the port's own tracing entry points and CLIs.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Set, Tuple

#: Analyzer-generation token.  Bump on ANY rule-engine change that can
#: alter what a given source revision produces (new rules, changed
#: inference, changed messages): the AST/finding cache and the baseline
#: fingerprints are keyed on it, so a stale cache entry or an outdated
#: baseline can never silently mask (or resurrect) findings across an
#: analyzer upgrade.  v3 = schedule extractor + divergence dataflow
#: engine (HVD200–HVD215) + nested-def held-set inheritance.  v4 =
#: cross-artifact contract engine (HVD300–HVD307, contracts.py).  v5 =
#: concurrency-lifecycle engine (HVD400–HVD407, lifecycle.py) + ambient
#: held sets reaching nested defs in guarded_by.
ANALYZER_VERSION = 5

# code -> (title, default fix-it).  The fix-it is the actionable half of
# every message: what to change so the job cannot deadlock/diverge.
RULES: Dict[str, Tuple[str, str]] = {
    "HVD000": (
        "file could not be parsed",
        "fix the syntax error so the analyzer (and Python) can read it"),
    "HVD001": (
        "collective inside a rank-conditional branch",
        "hoist the collective out of the `if hvd.rank()` branch — every "
        "process must submit the same collectives in the same order, or "
        "the other ranks deadlock waiting for this one"),
    "HVD002": (
        "DistributedOptimizer without an initial-state broadcast",
        "call hvd.broadcast_parameters(...) (or broadcast_object / an "
        "elastic State) after hvd.init() so every worker starts from "
        "rank 0's weights; without it the replicas silently diverge"),
    "HVD003": (
        "collective on a path not executed by all ranks",
        "move the collective out of the except/early-return path — an "
        "exception or early exit taken on a subset of ranks leaves the "
        "others blocked in the collective"),
    "HVD004": (
        "grouped collective fed from an unordered iteration",
        "sort the tensors (e.g. sorted(names)) before the grouped call — "
        "set/dict iteration order can differ across processes, and the "
        "fusion planner requires an identical submission order everywhere"),
    "HVD005": (
        "tensor name reused with a different op/reduction",
        "give each distinct collective its own name= — the negotiation "
        "matches tensors by name, and one name with two signatures "
        "diverges the ranks"),
    "HVD006": (
        "blocking collective/sync inside a jit-traced function",
        "keep the eager API out of torch.compile / torch.jit / CUDA-graph "
        "capture (call it between compiled regions, or use the in-step "
        "forms hvd.allreduce_p etc. over a mesh axis) — the eager API "
        "blocks on the background engine, which deadlocks under tracing; "
        "handles cannot be awaited in-graph"),
    "HVD101": (
        "inconsistent lock acquisition order",
        "acquire these locks in one global order everywhere (document it "
        "next to the lock definitions) — opposite nestings on two threads "
        "deadlock"),
    "HVD102": (
        "condition wait while holding another lock",
        "release the outer lock before cv.wait() — wait() only releases "
        "the condition's own lock, so the notifier blocks on the outer "
        "lock and neither thread proceeds"),
    "HVD103": (
        "re-acquiring a non-reentrant lock already held",
        "use threading.RLock, or restructure so the inner path does not "
        "re-enter — a plain Lock self-deadlocks on re-acquisition"),
    "HVD110": (
        "shared attribute written without its inferred guard",
        "hold the lock that guards this attribute's other access sites "
        "around the write, or suppress with an inline justification if "
        "the write provably cannot race (e.g. before any thread starts)"),
    "HVD111": (
        "non-atomic read-modify-write outside the inferred guard",
        "wrap the increment / swap / check-then-act in 'with <guard>:' — "
        "two threads interleaving between the read and the write lose an "
        "update (or act on a stale decision)"),
    "HVD112": (
        "guarded container escapes its lock scope by reference",
        "return or store a copy (list(x), dict(x)) — handing out the raw "
        "container lets callers iterate/mutate it after the guard is "
        "released"),
    "HVD113": (
        "guard held for writes but not for reads",
        "take the same lock on the read side — an unguarded read can "
        "observe a torn or stale update; if the racy read is intentional, "
        "add an inline disable comment stating why it is safe"),
    "HVD114": (
        "attribute published after a thread already started in __init__",
        "assign every attribute the thread reads BEFORE Thread.start() / "
        "server construction — the new thread can run before __init__ "
        "finishes and observe the attribute missing"),
    "HVD115": (
        "split guard: no lock protects a majority of access sites",
        "pick ONE lock to guard this attribute and hold it at every "
        "access site; two locks each covering part of the accesses "
        "exclude nothing"),
    "HVD200": (
        "collective guarded by rank-divergent control flow",
        "hoist the collective out of the branch — the condition "
        "(rank, env var, clock, hostname, unseeded RNG) can evaluate "
        "differently per process, so some ranks never submit it and the "
        "rest deadlock; if every rank must agree, broadcast the decision "
        "from rank 0 first"),
    "HVD201": (
        "collective operand whose shape can diverge across ranks",
        "make the operand shape rank-invariant (pad to a fixed size, or "
        "broadcast the size from rank 0) — reductions require "
        "identically-shaped operands on every rank, and a shape built "
        "from rank/env/RNG mismatches the fused buffer layout"),
    "HVD202": (
        "collective after a rank-divergent early exit",
        "move the divergent return/raise below the collective (or make "
        "every rank take the same path) — ranks that exited early never "
        "submit the collective and the rest block forever"),
    "HVD203": (
        "rank-divergent value published under a shared control-plane key",
        "publish per-rank values under rank-qualified keys, or broadcast "
        "the value from rank 0 before publishing — a shared key written "
        "with different values per rank leaves the control plane in a "
        "last-writer-wins state the ranks don't agree on"),
    "HVD204": (
        "rank-divergent collective parameter",
        "pass the same name/root_rank/op/process_set on every rank — "
        "negotiation matches collectives by these fields, and a "
        "per-rank value (e.g. root_rank=hvd.rank()) pairs incompatible "
        "requests or broadcasts from N different roots"),
    "HVD205": (
        "collective inside a loop with a rank-divergent trip count",
        "make the loop bound identical on every rank (broadcast it from "
        "rank 0) — a rank iterating fewer times submits fewer "
        "collectives, and the peers deadlock on the missing ones"),
    "HVD210": (
        "collective schedule differs across configurations",
        "make the step function's collective sequence independent of "
        "rank and mesh size — every replica must issue the same "
        "collectives in the same order, or the compiled programs "
        "deadlock against each other (see python -m "
        "horovod_tpu_torch.analysis.schedule --consistency)"),
    "HVD211": (
        "collective schedule drifted from its committed snapshot",
        "if the change is intentional, re-record the JAX package's "
        "snapshot and review the diff (the port only reads "
        "tests/schedules/); otherwise the "
        "fusion plan changed by accident and multi-host jobs may "
        "diverge"),
    "HVD300": (
        "env var read with no validated config row or docs entry",
        "add the knob to config.py's from_env() (validated) or at least "
        "a docs/env.md row — an operator cannot discover or trust a knob "
        "that exists only as a raw os.environ read"),
    "HVD301": (
        "config.py row and docs/env.md table drifted apart",
        "add the missing docs/env.md row (or delete the dead one) — the "
        "env table is the operator contract, and a knob that parses but "
        "isn't documented (or vice versa) WILL be set wrong"),
    "HVD302": (
        "metric family and docs/metrics.md table drifted apart",
        "add the family to the docs/metrics.md table (or drop the stale "
        "row) — dashboards and the job-level merge are built from that "
        "table"),
    "HVD303": (
        "histogram family declared with two different bucket edges",
        "use one (lo, hi) for every declaration of the family — the "
        "driver's job-level merge sums buckets edge-wise and raises on "
        "mismatched edges, so this is a guaranteed runtime ValueError"),
    "HVD304": (
        "RPC method with no handler, or handler no client calls",
        "register the method in a JsonRpcServer({...})/add_handlers "
        "table (or delete the dead handler) — an unregistered method is "
        "a guaranteed 'unknown method' error on first use"),
    "HVD305": (
        "chaos site drift between code, docs and fault seeds",
        "fire the site, fix the seed's site/action string, or update "
        "docs/env.md's site list — an inert seed turns its chaos "
        "regression test into a silent no-op"),
    "HVD306": (
        "negotiation-token / EntrySig field schema drift",
        "keep entry_token's sig row, every token_fields consumer, "
        "EntrySig and native parse_sig in lockstep (append-only fields) "
        "— a consumer indexing past the producer's arity is an "
        "IndexError at negotiation time"),
    "HVD307": (
        "metric call-site labels outside the family's declared labels",
        "pass only the labels the family declared (or extend the "
        "declaration) — the registry silently drops unknown labels, so "
        "the series you meant to split never materializes"),
    "HVD400": (
        "blocking call reached while a lock is held",
        "move the RPC/sleep/join/get outside the critical section "
        "(snapshot what you need under the lock, block after releasing "
        "it) — every other thread needing the lock stalls for the full "
        "wait, a self-inflicted tail no deadline knob can fix"),
    "HVD401": (
        "Condition.wait() outside a while-predicate loop",
        "wrap the wait in `while not predicate(): cv.wait()` — spurious "
        "wakeups and stolen notifications make a bare wait return with "
        "the predicate still false"),
    "HVD402": (
        "job-lifetime container grows with no eviction or bound",
        "add a maxlen/LRU bound or a prune pass keyed on what retires "
        "the entries (request done, worker dead, epoch rolled) — a "
        "per-request append into a long-lived container is a leak that "
        "kills the job at day, not minute, timescales"),
    "HVD403": (
        "non-daemon thread started but never joined",
        "join the thread on the close/stop/__exit__ path (or pass "
        "daemon=True if it holds no state worth flushing) — interpreter "
        "shutdown blocks on every live non-daemon thread"),
    "HVD404": (
        "wall-clock value mixed with monotonic-clock value",
        "derive both sides of the comparison/subtraction from the same "
        "clock — time.time() steps under NTP, so a span against "
        "time.monotonic() can go negative or jump by hours; use "
        "monotonic for durations, wall time for display only"),
    "HVD405": (
        "user callback invoked while holding an internal lock",
        "snapshot the callback list under the lock, call it after "
        "releasing — user code that re-enters the API deadlocks on the "
        "very lock the framework still holds"),
    "HVD406": (
        "shutdown flag cannot wake the loop it stops",
        "make the stop path signal the primitive the loop parks on "
        "(put a sentinel, set the event, or wait with a timeout) — "
        "flipping the flag alone leaves the loop parked forever"),
    "HVD407": (
        "edge-trigger state set on fire but never cleared",
        "clear the key when the condition recovers (or bound the set "
        "with an LRU) — a once-set membership test fires at most once "
        "per process lifetime and the set leaks besides"),
}


@dataclasses.dataclass
class Finding:
    code: str
    path: str
    line: int
    col: int
    message: str

    @property
    def fixit(self) -> str:
        return RULES.get(self.code, ("", ""))[1]

    def format_text(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"{self.message}\n    fix: {self.fixit}")

    def as_dict(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fixit": self.fixit}


_DISABLE_RE = re.compile(r"#\s*hvdlint:\s*disable=([A-Za-z0-9,\s]+)")
_SKIP_FILE_RE = re.compile(r"#\s*hvdlint:\s*skip-file\b")


def _comments(source: str):
    """Yield ``(lineno, text, own_line)`` for every REAL comment token.

    Tokenizing (instead of regexing raw source) keeps markers quoted in
    docstrings or string literals inert — otherwise a file merely
    *documenting* ``# hvdlint: skip-file`` would disable its own
    analysis.  Tokenization errors (bad encoding, unterminated strings)
    yield whatever comments were seen before the error; the parse error
    itself is reported separately as HVD000.
    """
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                line_prefix = tok.line[:tok.start[1]]
                yield tok.start[0], tok.string, line_prefix.strip() == ""
    except (tokenize.TokenError, IndentationError, SyntaxError,
            ValueError):
        return


def file_skipped(source: str) -> bool:
    """True when the file opts out wholesale (``# hvdlint: skip-file``)."""
    return any(_SKIP_FILE_RE.search(text) for _, text, _ in _comments(source))


def iter_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number -> suppressed codes for that line.

    ``# hvdlint: disable=HVD001`` at the end of a line suppresses that
    line; on a line of its own it suppresses the next line (matching the
    ``# noqa`` idiom users already know).  ``disable=all`` suppresses
    every rule.
    """
    out: Dict[int, Set[str]] = {}
    for lineno, text, own_line in _comments(source):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        codes = {c.strip().upper() for c in m.group(1).split(",")
                 if c.strip()}
        out.setdefault(lineno + 1 if own_line else lineno,
                       set()).update(codes)
    return out


def apply_suppressions(findings: Iterable[Finding],
                       suppressions: Dict[int, Set[str]]) -> List[Finding]:
    kept = []
    for f in findings:
        codes = suppressions.get(f.line, set())
        if "ALL" in codes or f.code.upper() in codes:
            continue
        kept.append(f)
    return kept
