"""Run one cell of the port's benchmark once, on one NVIDIA GPU.

    python3 bench_h100/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Runs the cell through its mode (``modes/<mode>.py``, found by registry.py
from the mix): it builds the system under test from the cell's files with
weights and inputs drawn on the device from ``--seed``, warms up every
shape the window uses (set-up, timed from the process's start as
``setup_s``), drives the window for ``--seconds`` (drive.py), then holds
what the window produced against the plain reference (check.py).
``--trace 1`` also traces a short window after the timed one
(devtrace.py), then builds a served cell's server a second time under a
profiler of the host alone for the program's set-up spans, and reports
the cell's per-layer metrics instead of its end-to-end ones. The last line
of standard output is the result as one JSON object; the compared numbers
and their limits are the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result; where the process holds JAX or the JAX
package once the windows have closed, with code 3. ``--rehearse`` runs the same path on
the CPU at a tiny size on the kernels' plain versions, to check paths,
arguments and the line's keys; it measures nothing, and every metric
reads null.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import check  # noqa: E402
import registry  # noqa: E402

# the CPU rehearsal's tiny model and traffic
REHEARSAL = {"input_dims": [188, 188], "n_kernels": 8}
REHEARSAL_MIX = {"batch": 2, "pool": 4, "sample": 2, "reference_block": 2,
                 "rate": 20}
# top-level modules the measured process may not hold: the JAX reference
# package and what it runs on
JAX_MODULES = {"jax", "jaxlib", "flax", "segmentation_tpu"}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def _line(cell, rec, values, trace, device, rehearse):
    correct, checks = check.verdict(values, cell.limits)
    metrics = {}
    for name, unit, read in (cell.per_layer if trace else cell.end_to_end):
        value = read(rec)
        if rehearse:
            metrics[name] = {"value": None, "unit": unit,
                             "note": "not measured: CPU rehearsal"}
        elif value is not None:
            metrics[name] = {"value": value, "unit": unit}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips,
               "memory_peak_bytes": rec["memory_peak_bytes"]}
    else:
        dev = {"platform": "cpu", "kind": platform.processor() or "cpu",
               "count": 0, "memory_peak_bytes": None}
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"],
            "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        t = rec["trace"]
        if not rehearse:
            dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
            line["breakdown"] = {"device_ops": t["device_ops"],
                                 "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    return correct, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, tiny size, plain versions; measures nothing")
    args = ap.parse_args(argv)
    cell = registry.Cell(args.workload)
    if args.rehearse:
        device = torch.device("cpu")
        cell.cfg.update(REHEARSAL)
        cell.mix.update({k: v for k, v in REHEARSAL_MIX.items()
                         if k in cell.mix})
    else:
        if not torch.cuda.is_available():
            print("run.py: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"run.py: {cell.name} needs {cell.chips} devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        print(f"card: {_card()}; torch {torch.__version__}",
              file=sys.stderr)
    mode = registry.mode(cell.mix["mode"])
    rec, values = mode.run(cell, args.seed, args.seconds, args.trace, device,
                           args.rehearse)
    rec["setup_s"] = rec.pop("set_up_at") - T_START
    batch = cell.mix["batch"]
    rec["cfg"], rec["batch"] = cell.cfg, batch
    rec["least_s"] = mode.least_seconds(cell.cfg, batch)
    rec["compute_s"] = mode.unit_compute_seconds(cell.cfg, batch)
    correct, line = _line(cell, rec, values, args.trace, device,
                          args.rehearse)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & JAX_MODULES)
    if loaded:
        print(f"run.py: the process holds {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
