"""The port's hvdlint engines (``horovod_tpu_torch.analysis``) against the
JAX package's.

* Lint parity: every snippet case of ``tests/test_analysis.py`` and
  ``tests/test_analysis_guards.py`` (read, not edited) goes through both
  packages' ``analyze_source``: the JAX snippet as written, the port's
  with ``horovod_tpu`` imports pointed at ``horovod_tpu_torch`` and JAX's
  tracing constructs written as their torch counterparts (HVD006:
  ``jax.jit`` → ``torch.compile``, ``jax.pmap`` → ``torch.jit.script``,
  ``shard_map`` → ``torch.jit.trace``; ``jax.process_index()`` →
  ``torch.distributed.get_rank()``).  Both give the same ``(code,
  line)`` findings.
* HVD006 on the port's own tracing constructs (CUDA-graph capture,
  ``torch.jit.trace``), gated on a ``torch`` alias.
* The port's tree lints clean against its baseline, within the 25 CPU
  seconds the JAX package's CI gives hvdlint; every baseline entry
  carries its reason; the CLI's defaults and exit codes.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu.analysis import analyze_source as jax_analyze
from horovod_tpu_torch.analysis import analyze_source
from horovod_tpu_torch.analysis import baseline as baseline_mod
from horovod_tpu_torch.analysis import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("tests/test_analysis.py", "tests/test_analysis_guards.py")

#: line-preserving rewrites of a JAX snippet into the port's
_REWRITES = (
    (re.compile(r"\bhorovod_tpu\b(?!_torch)"), "horovod_tpu_torch"),
    (re.compile(r"^(\s*)from jax import jit\b", re.M),
     r"\1from torch import compile as jit"),
    (re.compile(r"^(\s*)from jax\.experimental\.shard_map import shard_map\b",
                re.M), r"\1from torch.jit import trace as shard_map"),
    (re.compile(r"\bjax\.jit\b"), "torch.compile"),
    (re.compile(r"\bjax\.pmap\b"), "torch.jit.script"),
    (re.compile(r"\bjax\.process_index\b"), "torch.distributed.get_rank"),
    (re.compile(r"^(\s*)import jax\s*$", re.M), r"\1import torch"),
)


def port_source(src: str) -> str:
    for pat, rep in _REWRITES:
        src = pat.sub(rep, src)
    return src


def _snippets():
    """Every multi-line string literal of the two JAX test files that
    parses as a module: the snippet cases (docstrings are prose)."""
    out = []
    for rel in SOURCES:
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        seen = set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str) and "\n" in node.value):
                continue
            src = textwrap.dedent(node.value)
            if src in seen or not src.strip():
                continue
            try:
                body = ast.parse(src).body
            except SyntaxError:
                continue
            if all(isinstance(s, ast.Expr) for s in body):
                continue        # prose that happens to parse
            seen.add(src)
            out.append(pytest.param(
                src, id=f"{os.path.basename(rel)}:{node.lineno}"))
    return out


SNIPPETS = _snippets()


def _found(analyze, src):
    return [(f.code, f.line) for f in analyze(src, "fixture.py")]


def test_the_jax_test_files_hold_snippet_cases():
    assert len(SNIPPETS) >= 80
    assert any("jax.jit" in p.values[0] for p in SNIPPETS)


@pytest.mark.parametrize("src", SNIPPETS)
def test_lint_parity_with_the_jax_engines(src):
    """The same (code, line) findings from both packages' engines."""
    assert _found(analyze_source, port_source(src)) == \
        _found(jax_analyze, src)


# -- HVD006 on the port's own tracing constructs --------------------------------

@pytest.mark.parametrize("src, want", [
    pytest.param("""
import torch
import horovod_tpu_torch as hvd
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    y = hvd.allreduce(x)
""", [("HVD006", 6)], id="cuda_graph_capture"),
    pytest.param("""
from torch.cuda import graph
import horovod_tpu_torch as hvd
with graph(g):
    h = hvd.allreduce_async(x)
    h.synchronize()
""", [("HVD006", 5), ("HVD006", 6)], id="bare_capture_and_handle"),
    pytest.param("""
import torch.jit as tj
import horovod_tpu_torch as hvd
def step(x):
    return hvd.allreduce(x)
traced = tj.trace(step, (x,))
""", [("HVD006", 5)], id="jit_trace_submodule_alias"),
    pytest.param("""
import torch
import horovod_tpu_torch as hvd
def step(x):
    return hvd.allreduce(torch.trace(x))
""", [], id="matrix_trace_is_no_trace"),
    pytest.param("""
import torch
import horovod_tpu_torch as hvd
@torch.compile
def step(x):
    return hvd.allreduce_p(x, "dp")
""", [], id="in_step_form_under_compile"),
    pytest.param("""
import torch.distributed as dist
import horovod_tpu_torch as hvd
if dist.get_rank() == 0:
    hvd.allreduce(x)
""", [("HVD200", 5)], id="torch_rank_is_a_divergent_source"),
])
def test_hvd006_and_rank_sources_on_torch_constructs(src, want):
    assert _found(analyze_source, src) == want


# -- the port's tree, its baseline and the CLI ------------------------------------

def test_the_ports_tree_lints_clean_against_its_baseline(capsys):
    """``python -m horovod_tpu_torch.analysis`` (default target: the port,
    default baseline: the port's) exits 0, within the 25 s hvdlint has
    in the JAX package's CI (CPU seconds: the run is single-threaded)."""
    t0 = time.process_time()
    rc = cli.main([])
    cpu_s = time.process_time() - t0
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean" in out and "baselined" in out
    assert cpu_s < 25.0, cpu_s


def test_every_baseline_entry_carries_a_reason():
    with open(baseline_mod.DEFAULT, encoding="utf-8") as f:
        data = json.load(f)
    assert data["findings"]
    for e in data["findings"]:
        assert len(e.get("reason", "").strip()) > 40, e
        assert e["path"].startswith("horovod_tpu_torch/"), e


def test_update_baseline_keeps_the_reasons(tmp_path):
    path = tmp_path / "b.json"
    src = tmp_path / "script.py"
    src.write_text("import horovod_tpu_torch as hvd\n"
                   "if hvd.rank() == 0:\n    hvd.allreduce(x)\n")
    assert cli.main([str(src), "--baseline", str(path),
                     "--update-baseline"]) == 0
    data = json.loads(path.read_text())
    mine = [e for e in data["findings"] if e["path"].endswith("script.py")]
    assert [e["code"] for e in mine] == ["HVD001"]
    assert all(e["reason"] == "" for e in data["findings"])
    for e in data["findings"]:
        e["reason"] = f"accepted: {e['code']}"
    path.write_text(json.dumps(data))
    assert cli.main([str(src), "--baseline", str(path),
                     "--update-baseline"]) == 0
    assert all(e["reason"] == f"accepted: {e['code']}"
               for e in json.loads(path.read_text())["findings"])
    assert cli.main([str(src), "--baseline", str(path)]) == 0
    assert cli.main([str(src), "--no-baseline"]) == 1


def test_cli_json_output_names_the_port(tmp_path):
    src = tmp_path / "script.py"
    src.write_text("import horovod_tpu_torch as hvd\nhvd.init()\n"
                   "opt = hvd.DistributedOptimizer(base)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", str(src),
         "--format=json"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert [f["code"] for f in payload["findings"]] == ["HVD002"]
    usage = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120).stdout
    assert "python -m horovod_tpu_torch.analysis" in usage


def test_contracts_name_the_skipped_artifacts():
    from horovod_tpu_torch.analysis import contracts
    repo = contracts.build_repo([(os.path.join(
        REPO, "horovod_tpu_torch", "__init__.py"), "", None)])
    assert repo.root == REPO
    reg = contracts.registries(repo)
    assert set(reg["skipped"]) == set(contracts.SKIPPED)
    # the scan set is the port's package and tests, not the JAX tree
    assert all("horovod_tpu_torch" in p or "test_torch_" in p
               or os.path.basename(p).startswith("torch_")
               for p in repo.modules)
    assert "collective.corrupt" in reg["chaos"]["sites"]


def test_contracts_hold_entry_sig_against_the_native_core():
    """HVD306's native half runs: ``EntrySig``'s fields against the port's
    own ``native/core.cpp`` ``parse_sig``, clean on the tree, and a field
    either side drops is a finding naming it."""
    import dataclasses

    from horovod_tpu_torch.analysis import contracts
    from horovod_tpu_torch.ops.fusion import EntrySig
    repo = contracts.build_repo([(os.path.join(
        REPO, "horovod_tpu_torch", "__init__.py"), "", None)])
    assert "HVD306-native" not in contracts.SKIPPED
    assert repo.cpp_path == os.path.join(
        REPO, "horovod_tpu_torch", "native", "core.cpp")
    fields = {f.name for f in dataclasses.fields(EntrySig)}
    assert {n for n, _ in repo.cpp_sig_attrs} == fields
    assert not [f for f in contracts._check_token(repo)
                if f.code == "HVD306"]
    repo.cpp_sig_attrs = [(n, line) for n, line in repo.cpp_sig_attrs
                          if n != "spec"] + [("colour", 1)]
    msgs = [f.message for f in contracts._check_token(repo)
            if f.code == "HVD306"]
    assert any("'spec' is not parsed" in m for m in msgs), msgs
    assert any("'colour' which EntrySig" in m for m in msgs), msgs
