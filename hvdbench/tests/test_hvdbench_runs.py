"""Whole runs of tiny cells on the CPU: the port against the reference, the
lower-precision control, planted faults, a cell and a metric added as new
files, and the modules a run loads."""

from __future__ import annotations

import json
import textwrap

import pytest

from hvdbench.tests.fixtures import card, run_in, tiny_root  # noqa: F401

SEED = 2 ** 33 + 7


def _run(root, cell, *extra, trace=0, seconds=1.0):
    done = run_in(root, ["hvdbench/tests/cpu_rank.py", "--workload", cell,
                         "--seed", str(SEED), "--seconds", str(seconds),
                         "--trace", str(trace), *extra])
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    return line, done.stderr


@pytest.mark.parametrize("cell", ["tiny-llama.tiny-lm", "tiny-bert.tiny-cls"])
def test_tiny_cell_is_correct_and_traced(tiny_root, cell):
    line, err = _run(tiny_root, cell, trace=1)
    assert line["correct"] is True, err[-2000:]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check failed_steps")
    assert {"mfu", "engine.host_ms"} <= set(line["metrics"])
    assert line["device"]["count"] == 1 and line["attempted"] >= 3
    assert line["breakdown"]["idle_gaps"]


def test_untraced_line_holds_the_end_to_end_metrics(tiny_root):
    line, _ = _run(tiny_root, "tiny-llama.tiny-lm")
    assert set(line["metrics"]) == {"tokens_per_s_per_chip", "step_ms_p90",
                                    "peak_mem_gib", "setup_s"}
    assert all(v["value"] >= 0 for v in line["metrics"].values())


@pytest.mark.parametrize("fault,cell", [
    ("state_unchanged", "tiny-llama.tiny-lm"),
    ("state_unchanged", "tiny-bert.tiny-cls"),
    ("half_batch", "tiny-llama.tiny-lm"),
    ("half_batch", "tiny-bert.tiny-cls"),
    ("no_exchange", "tiny-llama.tiny-lm-dp2"),
])
def test_a_planted_fault_is_not_correct(tiny_root, fault, cell):
    line, err = _run(tiny_root, cell, "--fault", fault)
    assert line["correct"] is False, err[-2000:]


def test_two_ranks_through_the_launcher_are_correct(tiny_root):
    line, err = _run(tiny_root, "tiny-llama.tiny-lm-dp2")
    assert line["correct"] is True, err[-2000:]
    assert line["device"]["count"] == 2


def test_lower_precision_control_reads_over_the_program(tiny_root):
    done = run_in(tiny_root, ["-m", "hvdbench.control", "--workload",
                              "tiny-llama.tiny-lm", "--seeds", "5,6",
                              "--device", "cpu"])
    assert done.returncode == 0, done.stderr[-3000:]
    seeds = [json.loads(x) for x in done.stdout.strip().splitlines()]
    control = [s["control"]["grad_gap"]["value"] for s in seeds]
    assert all(s["half_batch"]["correct"] is False for s in seeds)
    assert all(set(s["control"]["checks"]) == {"loss_gap", "grad_gap",
                                               "change_gap", "failed_steps"}
               for s in seeds)
    line, _ = _run(tiny_root, "tiny-llama.tiny-lm")
    program = line["checks"]["grad_gap"]["value"]
    assert min(control) > 3 * program


def test_new_cell_and_metric_are_files_alone(tiny_root, tmp_path):
    import shutil
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-bert.tiny-cls-b2",
                               "config": "tiny-bert",
                               "traffic": "tiny-cls-b2", "chips": 1,
                               "why": "a cell added as files"})
    bench["per_layer"].append({"name": "tiny.steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["tiny-bert.tiny-cls-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "hvdbench/traffic/tiny-cls.json")
                         .read_text())
    (root / "hvdbench/traffic/tiny-cls-b2.json").write_text(
        json.dumps(dict(traffic, batch=2)))
    shutil.copy(root / "hvdbench/limits/tiny-bert.tiny-cls.json",
                root / "hvdbench/limits/tiny-bert.tiny-cls-b2.json")
    (root / "hvdbench/metrics/tiny.steps_traced.py").write_text(
        textwrap.dedent('''
            def read(ctx):
                return ctx["trace"]["steps"]
        '''))
    line, err = _run(root, "tiny-bert.tiny-cls-b2", trace=1)
    assert line["correct"] is True, err[-2000:]
    assert line["metrics"]["tiny.steps_traced"]["value"] >= 3


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port(tiny_root):
    probe = textwrap.dedent('''
        import json, sys
        import hvdbench.reference.decoder, hvdbench.reference.bert
        import hvdbench.reference.optim, hvdbench.check
        ref = sorted({m.split(".")[0] for m in sys.modules})
        from hvdbench import cells, run
        for w in cells.benchmark()["workloads"]:
            cell = cells.load(w["name"])
            cell.family.make_step
        import torch
        import horovod_tpu_torch
        from horovod_tpu_torch import training
        from horovod_tpu_torch.models import bert, llama
        from horovod_tpu_torch.optim import precision
        from horovod_tpu_torch.ops import flash_attention, fused_xent, _build
        print(json.dumps({"reference": ref,
                          "run": run.forbidden_modules()}))
    ''')
    done = run_in(tiny_root, ["-c", probe])
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["run"] == []
    assert "horovod_tpu_torch" not in out["reference"]
    assert not {"jax", "jaxlib", "horovod_tpu"} & set(out["reference"])


def test_a_cell_that_asks_for_chips_without_a_card_prints_nothing(tiny_root):
    done = run_in(tiny_root, ["-m", "hvdbench.run", "--workload",
                              "tiny-llama.tiny-lm", "--seed", "1",
                              "--seconds", "1", "--trace", "0"])
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.gpu
def test_tiny_cell_on_the_card(tiny_root, card):
    done = run_in(tiny_root, ["-m", "hvdbench.run", "--workload",
                              "tiny-llama.tiny-lm", "--seed", str(SEED),
                              "--seconds", "2", "--trace", "1"])
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
