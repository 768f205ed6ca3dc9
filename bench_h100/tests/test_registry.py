"""The harness finds a cell's configuration, mix, limits and metric
readers by name from files alone, and imports neither JAX nor the JAX
package."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import registry

HARNESS = Path(__file__).resolve().parents[1]
ROOT = HARNESS.parent


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      _bench()["workloads"]])
def test_every_cell_resolves_from_its_files(workload):
    cell = registry.Cell(workload)
    config, traffic = workload.split(".")
    assert cell.cfg["name"] == config
    assert cell.mix["mode"] in ("train", "serve")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = registry.metric_names()[workload]
    assert [n for n, _, _ in cell.end_to_end + cell.per_layer] == names
    assert "setup_s" in names


def test_every_metric_has_a_reader_file():
    bench = _bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_a_new_mix_is_found_without_editing_a_file(tmp_path):
    """A throwaway mix, its limits and its cell, added as files and an
    entry in a copy of the checkout, run through the rehearsal."""
    shutil.copytree(HARNESS, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_h100").rglob("*")
              if p.is_file()}
    bench = _bench()
    bench["workloads"].append({
        "name": "unet512_bf16.serve_b2_open", "config": "unet512_bf16",
        "traffic": "serve_b2_open", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "serve_p99_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["unet512_bf16.serve_b2_open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mixes = tmp_path / "bench_h100" / "mixes"
    (mixes / "serve_b2_open.json").write_text(json.dumps({
        "mode": "serve", "batch": 2, "pool": 2, "arrivals": "uniform",
        "rate": 40, "in_flight": 1, "sample": 2, "trace_seconds": 0.2}))
    limits = tmp_path / "bench_h100" / "limits"
    (limits / "unet512_bf16.serve_b2_open.json").write_text(
        '{"mask_gap": 1.0}')
    (tmp_path / "bench_h100" / "metrics" / "serve_p99_ms.py").write_text(
        "import readings\n\n\ndef read(rec):\n"
        "    return readings.latency_ms(rec, 99)\n")
    cell = registry.Cell("unet512_bf16.serve_b2_open",
                         root=tmp_path / "bench_h100")
    assert cell.mix["arrivals"] == "uniform"
    assert [n for n, _, _ in cell.end_to_end] == ["setup_s", "serve_p99_ms"]
    assert cell.end_to_end[1][2]({"window": {"latency_s": [0.001] * 9
                                             + [0.002]}}) == 2.0
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, str(tmp_path / "bench_h100" / "run.py"),
         "--workload", "unet512_bf16.serve_b2_open", "--seed", "3",
         "--seconds", "0.5", "--rehearse"], capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"setup_s", "serve_p99_ms"}
    assert line["attempted"] > 0 and line["device"]["platform"] == "cpu"
    after = {p: p.read_bytes() for p in (tmp_path / "bench_h100").rglob("*")
             if p.is_file() and p in before}
    assert after == before


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in HARNESS.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "segmentation_tpu"), (
                f"{path.name} imports {name}")


def test_the_reference_imports_nothing_of_the_program():
    names = set(_imports(HARNESS / "reference.py"))
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch", "torch.nn.functional"}
    program = [p.name for p in HARNESS.glob("*.py")
               if any(n.startswith("segmentation_tpu_torch")
                      for n in _imports(p))]
    assert program == ["systems.py"]


def test_nothing_reads_the_jax_benchmark_folder():
    modules = list(HARNESS.glob("*.py")) + list(HARNESS.glob("metrics/*.py"))
    for path in modules:
        assert "benchmarks" not in path.read_text(), path.name


def test_without_the_program_it_fails_and_prints_nothing(tmp_path):
    """A checkout holding only BENCHMARK.json and the harness."""
    shutil.copytree(HARNESS, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "unet512_bf16.serve_b64", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
