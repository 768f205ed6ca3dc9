"""run.py end to end on the CPU: the rehearsal prints the contract's line
with every metric null, and the measured path refuses to run without a
CUDA device; a process that holds JAX prints no result."""

import json
import sys
import types

import pytest
import torch

import registry
import run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

@pytest.mark.parametrize("workload,trace", [
    ("unet512_bf16.serve_b8", 1), ("unet512_bf16.serve_b64", 0),
    ("unet512_int8.serve_b64", 1),
    ("unet512_bf16.train_b128", 1)])
def test_rehearsal_prints_the_line(workload, trace, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 5),
                   "--seconds", "0.3", "--trace", str(trace), "--rehearse"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] and all(m["value"] is None
                                   for m in line["metrics"].values())
    cell = registry.Cell(workload)
    names = [n for n, _, _ in (cell.per_layer if trace else cell.end_to_end)]
    assert list(line["metrics"]) == names
    assert line["attempted"] > 0
    for name, c in line["checks"].items():
        assert f"check {name}: " in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_per_layer_cells_report_the_metric_they_move():
    """Each per-layer metric's cells are cells of BENCHMARK.json that report
    the end-to-end metric it moves, read from the data alone."""
    with open(registry.HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    names = registry.metric_names()
    for m in bench["per_layer"]:
        for workload in m.get("workloads", ()):
            assert m["moves"] in names[workload], (m["name"], workload)
            assert m["name"] in names[workload], (m["name"], workload)


def test_a_process_holding_jax_prints_nothing(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "unet512_int8.serve_b64", "--seed", "7",
                   "--seconds", "0.2", "--trace", "0", "--rehearse"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "jax" in err.strip().splitlines()[-1]


def test_measured_path_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "unet512_bf16.serve_b64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
