"""The n_kernels 64 train cell on the CPU: run.py's rehearsal prints the
contract's line for ``unet512_n64_bf16.train_b128``, traced and untraced,
with the metrics registry.Cell gives it, and the cell's files resolve."""

import json

import pytest

import registry
import run

CELL = "unet512_n64_bf16.train_b128"


def test_the_cell_is_the_paper_widths():
    cell = registry.Cell(CELL)
    assert cell.cfg["n_kernels"] == 64 and cell.cfg["reduced"] == []
    assert cell.mix["mode"] == "train" and cell.mix["batch"] == 128
    assert set(cell.limits) == {"grad1_gap", "delta_gap"}
    assert "packed512_roofline.train" in [n for n, _, _ in cell.per_layer]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_the_line(trace, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2**31 + 17),
                   "--seconds", "0.3", "--trace", str(trace), "--rehearse"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device",
            "checks"} <= set(line)
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    cell = registry.Cell(CELL)
    names = [n for n, _, _ in (cell.per_layer if trace else cell.end_to_end)]
    assert list(line["metrics"]) == names
    assert all(m["value"] is None for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    for name in line["checks"]:
        assert f"check {name}: " in err
