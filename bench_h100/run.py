"""Run one cell of the port's benchmark once, on one NVIDIA GPU.

    python3 bench_h100/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Builds the system under test from the cell's files (registry.py) with
weights and inputs drawn on the device from ``--seed``, warms up every
shape the window uses (set-up, timed as ``setup_s``), drives the window
for ``--seconds`` (drive.py), then holds a sample of what the window
produced against the plain reference (check.py). ``--trace 1`` also
traces a short window after the timed one (devtrace.py), then builds a
served cell's server a second time under a profiler of the host alone for
the program's set-up spans, and reports the cell's per-layer metrics
instead of its end-to-end ones. The last line of standard output is the
result as one JSON object; the compared numbers and their limits are the
last lines of standard error.

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
import math  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import check  # noqa: E402
import devtrace  # noqa: E402
import drive  # noqa: E402
import reference  # noqa: E402
import registry  # noqa: E402
import systems  # noqa: E402
import work  # noqa: E402

CALIB_STREAM = 4
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


def _memory_peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def serve(cell, seed, seconds, trace, device, plain):
    cfg, mix = cell.cfg, cell.mix
    params = reference.make_params(cfg, seed, device)
    route = cfg["route"]
    calib = []
    if route["kind"] == "int8":
        calib = drive.serve_inputs(cfg, route["calib_batch"],
                                   route["calib_batches"], seed, device,
                                   stream=CALIB_STREAM)
    server = systems.server(cfg, params, calib, plain)
    pool = drive.serve_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    for x in pool:
        server(x).cpu()
    rec = {"setup_s": time.perf_counter() - T_START}
    rec["window"] = drive.serve_window(server, pool, mix, seconds, seed,
                                       mix["sample"])
    rec["attempted"] = rec["window"]["requests"]
    if trace:
        win, red = devtrace.traced(lambda: drive.serve_window(
            server, pool, mix, mix["trace_seconds"], seed),
            device.type == "cuda")
        rec["trace"] = {**red, "units": win["requests"],
                        "window_s": win["window_s"]}
    rec["memory_peak_bytes"] = _memory_peak(device)
    del server
    _free(device)
    rec["stats"] = check.sample_stats(cfg, params, pool,
                                      rec["window"]["sample"],
                                      "gap_ratio" in cell.limits)
    rec["failed"] = check.failed_requests(rec["stats"], cell.limits)
    if trace:
        # after the windows: a profiler session, even of the host alone,
        # slowed B = 8's launches in every window after it in the process
        rec["trace"]["setup_s_by_span"] = devtrace.setup_spans(
            lambda: systems.server(cfg, params, calib, plain))
    return rec, check.worst(rec["stats"])


def train(cell, seed, seconds, trace, device, plain):
    cfg, mix = cell.cfg, cell.mix
    params = reference.make_params(cfg, seed, device)
    trainer = systems.Trainer(cfg, {k: v.clone() for k, v in params.items()},
                              plain)
    pool = drive.train_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    checked, got = mix["checked_steps"], {"losses": []}
    if not checked <= mix["setup_steps"] <= len(pool):
        raise ValueError("the checked steps run in set-up, one pool batch "
                         "each")
    for i in range(mix["setup_steps"]):
        loss = trainer.step(pool[i % len(pool)])["seg_loss"]
        if i < checked:
            got["losses"].append(loss)
        if i == 0:
            b1 = cfg["train"]["beta1"]
            got["grad1"] = {k: v / (1 - b1) for k, v in
                            check.norms(trainer.first_moments()).items()}
        if i == checked - 1:
            got["delta"] = check.norms(
                {k: v - params[k] for k, v in trainer.params().items()})
    rec = {"setup_s": time.perf_counter() - T_START}
    first = mix["setup_steps"] % len(pool)
    rec["window"] = drive.train_window(trainer.step, pool, seconds, first)
    w = rec["window"]
    w["images"] = w["steps"] * mix["batch"]
    rec["attempted"] = w["steps"]
    rec["failed"] = sum(not math.isfinite(v) for v in w["losses"])
    if trace:
        win, red = devtrace.traced(lambda: drive.train_window(
            trainer.step, pool, mix["trace_seconds"], first),
            device.type == "cuda")
        rec["trace"] = {**red, "units": win["steps"],
                        "window_s": win["window_s"]}
    rec["memory_peak_bytes"] = _memory_peak(device)
    trainer.close()
    del trainer
    _free(device)
    want = check.reference_train(cfg, params, pool[:checked],
                                 block=mix["reference_block"])
    rec["reference"], rec["readings"] = want, got
    return rec, check.train_numbers(got, want)


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
    mode = cell.mix["mode"]
    rec, values = (train if mode == "train" else serve)(
        cell, args.seed, args.seconds, args.trace, device, args.rehearse)
    batch = cell.mix["batch"]
    rec["cfg"], rec["batch"] = cell.cfg, batch
    rec["least_s"] = work.least_seconds(cell.cfg, mode, batch)
    rec["compute_s"] = work.unit_compute_seconds(cell.cfg, mode, batch)
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
