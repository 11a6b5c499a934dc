"""The benchmark's files: every cell, configuration, traffic mix, limit
and metric is found by name, and ``BENCHMARK.json`` keeps to its form."""

from __future__ import annotations

import json
import re

import pytest

from hvdbench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FAMILY_API = ("n_layers", "layout", "batches", "tokens_per_batch",
              "model_flops", "make_step", "grad_from_state",
              "reference_loss")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = cells.load(name)
    assert cell.chips in (1, 4) and "ranks" not in cell.traffic
    assert cell.limits and set(cell.limits) <= {
        "loss_gap", "loss_gap_first", "grad_gap", "change_gap",
        "grad_gap_median", "change_gap_median"}
    assert all(0 < v < 1 for v in cell.limits.values())
    for fn in FAMILY_API:
        assert callable(getattr(cell.family, fn)), fn
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.metric_reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_is_the_named_one(config):
    body = json.loads((cells.ROOT / config["file"]).read_text())
    assert body["reduced"] == config["reduced"]
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    users = [w for w in BENCH["workloads"] if w["config"] == config["name"]]
    assert users, "every configuration is used by a cell"


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    every = [x["name"] for x in metrics + BENCH["workloads"]
             + BENCH["configs"]]
    assert len(every) == len(set(every))
    assert all(NAME.match(n) for n in every)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert layers.setdefault(m["name"], m["layer"]) == m["layer"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_seeds_past_32_bits_give_distinct_generators():
    big = 2 ** 31 + 12345
    assert cells.seed_for(big, "w") != cells.seed_for(big + 1, "w")
    assert cells.seed_for(big, "w") == cells.seed_for(big, "w")
    assert 0 <= cells.seed_for(2 ** 40, "batch", 3, 1) < 2 ** 63
