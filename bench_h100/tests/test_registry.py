"""The harness finds a cell's configuration, mix, limits, metric readers,
mode and route by name from files alone, and imports neither JAX nor the
JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import registry
import work

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
    mode = registry.mode(cell.mix["mode"])
    for name in ("run", "least_seconds", "unit_compute_seconds",
                 "control_row"):
        assert callable(getattr(mode, name))
    if "route" in cell.cfg:
        route = registry.route(cell.cfg["route"]["kind"])
        assert callable(route.build) and callable(route.calibration)
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


ECHO_MODE = '''"""A toy mode: the route's server echoes each input; the
number compared is the largest gap between an answer and its input."""

import time

import drive
import systems


def run(cell, seed, seconds, trace, device, plain):
    cfg, mix = cell.cfg, cell.mix
    calib = systems.calibration(cfg, seed, device)
    server = systems.server(cfg, {}, calib, plain)
    pool = drive.serve_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    rec = {"set_up_at": time.perf_counter()}
    t0, n, gap = time.perf_counter(), 0, 0.0
    while time.perf_counter() < t0 + seconds:
        x = pool[n % len(pool)]
        gap = max(gap, float((server(x).float() - x.float()).abs().max()))
        n += 1
    rec["window"] = {"requests": n, "window_s": time.perf_counter() - t0}
    rec["attempted"], rec["failed"] = n, 0
    rec["memory_peak_bytes"] = drive.memory_peak(device)
    return rec, {"echo_gap": gap}


def least_seconds(cfg, batch):
    return 1e-3 * batch


def unit_compute_seconds(cfg, batch):
    return 1e-3 * batch


def control_row(cell, seed, rec, n, control_seeds, device):
    return {}
'''

ECHO_ROUTE = '''"""A toy route: the server returns its input."""


def calibration(cfg, seed, device):
    return []


def build(cfg, params, calib, plain=False):
    return lambda x: x
'''


def test_a_new_mode_is_found_without_editing_a_file(tmp_path):
    """A toy mode and route, with a configuration, a mix, limits, a metric
    and a cell, added as files and entries in a copy of the checkout and
    run through run.py's rehearsal: no file that was there changes."""
    shutil.copytree(HARNESS, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "bench_h100"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = _bench()
    bench["configs"].append({
        "name": "echo", "source": "a test", "file": "bench_h100/configs/"
        "echo.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": "echo.echo_b2", "config": "echo", "traffic": "echo_b2",
        "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "echo_per_s", "unit": "req/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": ["echo.echo_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "configs" / "echo.json").write_text(json.dumps({
        "name": "echo", "input_dims": [8, 8], "input_channel": 3,
        "route": {"kind": "echo"}}))
    (here / "mixes" / "echo_b2.json").write_text(json.dumps({
        "mode": "echo", "batch": 2, "pool": 2}))
    (here / "limits" / "echo.echo_b2.json").write_text('{"echo_gap": 0.5}')
    (here / "metrics" / "echo_per_s.py").write_text(
        "import readings\n\n\ndef read(rec):\n"
        "    return readings.window_rate(rec, \"requests\")\n")
    (here / "modes" / "echo.py").write_text(ECHO_MODE)
    (here / "routes" / "echo.py").write_text(ECHO_ROUTE)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, str(here / "run.py"), "--workload", "echo.echo_b2",
         "--seed", str(2**31 + 3), "--seconds", "0.3", "--rehearse"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "echo_per_s"}
    assert line["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.5}}
    after = {p: p.read_bytes() for p in here.rglob("*")
             if p.is_file() and p in before}
    assert after == before


def test_a_missing_mode_or_route_names_its_file():
    for find, folder in ((registry.mode, "modes"),
                         (registry.route, "routes")):
        with pytest.raises(FileNotFoundError,
                           match=str(HARNESS / folder / "nowhere.py")):
            find("nowhere")


# each cell's least time and compute bound of one request or step, as
# work.py counted them before the counts moved into the modes
WORK_S = {
    "unet512_bf16.train_b128": (0.02181949719555106, 0.02181949719555106),
    "unet512_bf16.serve_b8": (0.0004557847296258847,
                              0.0004557847296258847),
    "unet512_int8.serve_b64": (0.001873183931410692, 0.001873183931410692),
    "unet512_bf16.serve_b64": (0.0036462778370070776,
                               0.0036462778370070776),
    "unet512_n64_bf16.train_b128": (0.08703487513781193,
                                    0.08703487513781193),
}


@pytest.mark.parametrize("workload", sorted(WORK_S))
def test_each_cells_work_count_is_pinned(workload):
    cell = registry.Cell(workload)
    mode, batch = cell.mix["mode"], cell.mix["batch"]
    assert (work.least_seconds(cell.cfg, mode, batch),
            work.unit_compute_seconds(cell.cfg, mode, batch)) == \
        WORK_S[workload]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(HARNESS.rglob("*.py"))
    assert {"modes", "routes", "metrics"} <= {p.parent.name for p in paths}
    for path in paths:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "segmentation_tpu"), (
                f"{path.name} imports {name}")


def test_the_reference_imports_nothing_of_the_program():
    references = sorted(HARNESS.glob("reference*.py"))
    assert HARNESS / "reference.py" in references
    for path in references:
        names = set(_imports(path))
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "numpy", "torch", "torch.nn.functional",
                         "reference"}, path.name
    program = {str(p.relative_to(HARNESS)) for p in HARNESS.rglob("*.py")
               if any(n.split(".")[0] == "segmentation_tpu_torch"
                      for n in _imports(p))}
    routes = {f"routes/{p.name}" for p in HARNESS.glob("routes/*.py")}
    assert routes and program == {"systems.py"} | routes


def test_nothing_reads_the_jax_benchmark_folder():
    modules = [p for p in HARNESS.rglob("*.py") if p.parent.name != "tests"]
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
