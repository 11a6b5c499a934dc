"""hvdlint over the port, and the port's collective-schedule recorder.

Counterpart: ``horovod_tpu/analysis/``, copied and pointed at
``horovod_tpu_torch/`` (importing the JAX package would import jax).
Every data-plane collective of the port must be issued by every rank in
the same order: NCCL deadlocks otherwise.  This package checks that
invariant twice:

* **statically**, with the JAX package's six hvdlint engines, rule IDs
  HVD000–HVD407, messages, JSON/SARIF output and suppression syntax:

  - **user-script rules** (``user_rules.py``): HVD001–HVD006 over
    training scripts, with ``torch.compile`` / ``torch.jit`` / CUDA-graph
    capture as HVD006's tracing entry points;
  - **lock-order self-check** (``lock_order.py``): HVD101–HVD103;
  - **guarded-by self-check** (``guarded_by.py`` over ``callgraph.py``):
    HVD110–HVD115, Eraser-style lock-set race detection;
  - **SPMD divergence dataflow** (``divergence.py``): HVD200–HVD205;
  - **cross-artifact contracts** (``contracts.py``): HVD300–HVD307 over
    the port's package and tests, each contract whose artifact the port
    lacks skipped by name;
  - **concurrency lifecycle** (``lifecycle.py``): HVD400–HVD407;

* **at run time**, with ``schedule.py``: the eager port has no jaxpr, so
  every ``torch.distributed`` collective of the data plane reports to the
  recorder (``recorder.py``) at its call site, and the recorded
  schedules of the JAX package's 11 builtin entry points are held
  against their pinned snapshots (``tests/schedules/*.json``, HVD211) and
  across world sizes and ranks (HVD210).

CLI::

    python -m horovod_tpu_torch.analysis [paths]      # default: the port
    python -m horovod_tpu_torch.analysis.schedule --check --consistency

Suppress a finding with ``# hvdlint: disable=HVD001`` on (or directly
above) the flagged line, or skip a whole file with
``# hvdlint: skip-file``.  The port's accepted findings live in
``baseline.json`` beside this file, each with its reason.

The analysis modules import only the standard library (the recorder
reads tensors' shapes when armed); importing this package does not
import the engines until one is used.
"""

from .report import Finding, RULES, iter_suppressions  # noqa: F401

__all__ = [
    "Finding", "RULES", "analyze_paths", "analyze_source", "main",
    "iter_suppressions",
]


def __getattr__(name):
    # the engines load on first use: the data plane imports the recorder
    # beside them on every hvd import
    if name in ("analyze_paths", "analyze_source", "main"):
        from . import cli
        return getattr(cli, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
